"""Shared comparison for the ``test_torch_*`` parity tests."""

import numpy as np
import pytest
import torch


def assert_topk_match(got_s, got_i, want_s, want_i, rtol=1e-5):
    """Row-wise top-k parity: scores within ``rtol``; ids equal except
    across exact ties. Ids whose score lies strictly above a row's last
    score must match as sets (equal scores may come back in any order, and
    the last place may go to any doc of a tie)."""
    got_s, want_s = np.asarray(got_s), np.asarray(want_s)
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    assert got_s.shape == want_s.shape and got_i.shape == want_i.shape
    np.testing.assert_allclose(got_s, want_s, rtol=rtol, atol=0)
    for s, gi, wi in zip(want_s, got_i, want_i):
        live = wi >= 0
        assert ((gi >= 0) == live).all()
        if not live.any():
            continue
        cut = s[live].min() * (1 + rtol)
        assert set(gi[live & (s > cut)]) == set(wi[live & (s > cut)])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's torch ops on one thread. The suite runs several
    pytest workers on one host; torch's default of one OpenMP thread per
    core in each of them oversubscribes the cores several times over."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
