"""``ircl_tpu_torch/tools/sharded_scale.py`` against
``scripts/sharded_scale.py``.

The script's ``main()`` runs in this process on the 8 virtual CPU devices
(``sys.argv`` patched, its module-level ``print`` a recorder), at ``--docs
2000 --batch 16`` with ``--ref scipy``, with ``--ref hybrid`` and with
``--stats-only``. The port's ``main()`` runs the same arguments on 8 gloo
CPU ranks (``--device cpu``), its two rank launches on a thread beside the
reference. Checks: the printed JSON lines agree on ``docs``, ``parity``
(16/16), ``per_shard`` and the 5.4M extrapolation, and the port's adds
only ``backend`` and ``ranks``; each query's top-5 scores of the sharded
engines agree at rtol 1e-4, with the ids equal up to exact ties (tf-idf
scores tie exactly, and the two merges may keep other docs of a tie); the
``--stats-only`` line (``light_postings_host`` included) is the script's;
``shard_budget`` gives the script's numbers on one split; the arguments
default to the script's.
"""

import argparse
import concurrent.futures
import json
import os
import sys

import numpy as np
import pytest

from _torch_parity import assert_topk_match
from _torch_tools import load_script, reference_argv
from ircl_tpu.parallel import sharded_hybrid as j_sharded_hybrid
from ircl_tpu_torch.index.split import split_index
from ircl_tpu_torch.tools import sharded_scale as tool
from ircl_tpu_torch.tools.scale_index import synth_index

ARGV = ["--docs", "2000", "--batch", "16"]
REFS = ("scipy", "hybrid")


def _recorder(lines):
    def record(*a, **kw):
        if kw.get("file") is None:
            lines.append(json.loads(a[0]))

    return record


@pytest.fixture(scope="module")
def runs():
    j_lines, t_lines, j_topk, t_topk = [], [], [], []

    def j_record(self, *a, **kw):
        s, i = j_topk_fn(self, *a, **kw)
        j_topk.append((np.asarray(s), np.asarray(i)))
        return s, i

    def t_record(*a, **kw):
        out = t_sharded_topk(*a, **kw)
        t_topk.append(out[:2])
        return out

    def port_runs():
        return [tool.main([*ARGV, "--ref", ref, "--device", "cpu"]) for ref in REFS]

    j_topk_fn, t_sharded_topk = j_sharded_hybrid.ShardedHybridIndex.topk, tool.sharded_topk
    with pytest.MonkeyPatch.context() as mp:
        # the script sets these at its top level; they are put back after
        for var in ("XLA_FLAGS", "JAX_PLATFORMS"):
            mp.setenv(var, os.environ.get(var, ""))
        mp.setattr(sys, "path", list(sys.path))
        ref = load_script("sharded_scale")
        mp.setattr(ref, "print", _recorder(j_lines), raising=False)
        mp.setattr(tool, "print", _recorder(t_lines), raising=False)
        mp.setattr(j_sharded_hybrid.ShardedHybridIndex, "topk", j_record)
        mp.setattr(tool, "sharded_topk", t_record)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            port = pool.submit(port_runs)
            for extra in (["--ref", "scipy"], ["--ref", "hybrid"], ["--stats-only"]):
                with reference_argv(mp, [*ARGV, *extra]):
                    ref.main()
            returned = port.result()
        returned.append(tool.main([*ARGV, "--stats-only", "--device", "cpu"]))
    return dict(ref=ref, j_lines=j_lines, t_lines=t_lines, returned=returned,
                j_topk=j_topk, t_topk=t_topk)


@pytest.mark.parametrize("which", REFS)
def test_sharded_run_line_matches_reference(runs, which):
    k = REFS.index(which)
    got, want = runs["t_lines"][k], runs["j_lines"][k]
    assert got == runs["returned"][k]
    assert want["parity"] == got["parity"] == "16/16"
    assert set(got) - set(want) == {"backend", "ranks"}
    assert {key: got[key] for key in want} == want
    assert (got["backend"], got["ranks"]) == ("gloo", 8)


@pytest.mark.parametrize("which", REFS)
def test_sharded_top5_matches_reference(runs, which):
    """The sharded engines' top-5 of each query: scores at rtol 1e-4, ids
    equal but across exact ties."""
    k = REFS.index(which)
    (got_s, got_i), (want_s, want_i) = runs["t_topk"][k], runs["j_topk"][k]
    assert got_s.shape[1] == want_s.shape[1] == 5
    assert_topk_match(got_s[:16], got_i[:16], want_s[:16], want_i[:16], rtol=1e-4)
    assert (got_i[:16] >= 0).all()


def test_stats_only_line_matches_reference(runs):
    got, want = runs["t_lines"][2], runs["j_lines"][2]
    assert got == want == runs["returned"][2]
    assert got["per_shard"]["light_postings_host"] > 0


@pytest.mark.parametrize("n_shards, batch", [(8, 1024), (8, 16), (3, 64)])
def test_shard_budget_matches_reference(runs, n_shards, batch):
    split = split_index(synth_index(3000, 16, 5000, 1 << 20), df_threshold=32)
    assert tool.shard_budget(split, n_shards, batch) == runs["ref"].shard_budget(
        split, n_shards, batch)


def test_defaults_match_the_script(runs, monkeypatch):
    """The script's ``argparse`` defaults, read by stopping its ``main()``
    at ``parse_args``: the port's are the same, less ``--slab-impl`` and
    plus ``--device``."""

    class Parsed(Exception):
        pass

    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise Parsed(vars(parse(self, [])))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(Parsed) as e:
        runs["ref"].main()
    monkeypatch.undo()
    want = dict(e.value.args[0])
    assert want.pop("slab_impl") is None
    got = vars(tool.parse_args([]))
    assert got.pop("device") is None
    assert got == want == dict(docs=40_000, terms=96, vocab=400_000, batch=64,
                               df_threshold=64, stats_only=False, ref="scipy")
