"""The port's native build (``ircl_tpu_torch/utils/native_build.py``) under
concurrent builds and loads.

Test workers on a fresh checkout build ``native/libircl_native.so`` on
demand, several at once. g++ writes into a temporary file beside the
library, renamed onto it when complete, so a process never opens a
half-written library (``corpus/hashing.py::_load_native`` would otherwise
remember the failed load for the rest of its process). These tests point
``build_native`` at a tiny C++ source in a temporary directory.
"""

import ctypes
import os
import shutil
import threading

import pytest

from ircl_tpu_torch.utils import native_build as nb

SOURCE = 'extern "C" int ircl_toy_answer() { return 42; }\n'


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A repository root holding one native source; the library's path."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is needed to build the native host library")
    (tmp_path / "native" / "src").mkdir(parents=True)
    (tmp_path / "native" / "src" / "toy.cpp").write_text(SOURCE)
    monkeypatch.setattr(nb, "_LIBS", {"toy": ("toy.cpp", "libtoy.so", [])})
    monkeypatch.setattr(nb, "repo_root", lambda: str(tmp_path))
    return tmp_path / "native" / "libtoy.so"


def _leftovers(lib_path):
    return sorted(p for p in os.listdir(lib_path.parent) if p != "src" and
                  p != lib_path.name)


def _in_threads(n, fn):
    out = [None] * n
    start = threading.Barrier(n)

    def run(i):
        start.wait()
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_concurrent_forced_builds_each_return_a_loadable_library(toy):
    paths = _in_threads(6, lambda: nb.build_native(force=True, lib="toy"))
    assert paths == [str(toy)] * 6
    for p in paths:
        assert ctypes.CDLL(p).ircl_toy_answer() == 42
    assert _leftovers(toy) == []


def test_a_loader_never_opens_a_half_written_library(toy, tmp_path):
    """While six threads rebuild the library, whatever stands at its path
    loads. Each look is copied to a name of its own first, because the
    dynamic loader returns a library it has loaded by name without reading
    the file again."""
    done = threading.Event()
    failures, loads = [], [0]

    def watch():
        while not done.is_set() and loads[0] + len(failures) < 200:
            try:
                seen = shutil.copy(toy, tmp_path / f"seen{loads[0] + len(failures)}.so")
            except FileNotFoundError:
                continue
            try:
                ctypes.CDLL(seen)
                loads[0] += 1
            except OSError as e:
                failures.append(str(e))

    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        for _ in range(2):
            _in_threads(6, lambda: nb.build_native(force=True, lib="toy"))
    finally:
        done.set()
        watcher.join()
    assert failures == [] and loads[0] > 0
    assert _leftovers(toy) == []


def test_a_failed_build_returns_none_and_leaves_nothing(toy):
    (toy.parent / "src" / "toy.cpp").write_text("this is not C++\n")
    assert nb.build_native(force=True, lib="toy") is None
    assert not toy.exists() and _leftovers(toy) == []


def test_a_library_newer_than_its_source_is_not_rebuilt(toy):
    first = nb.build_native(lib="toy")
    stamp = os.stat(first).st_mtime_ns
    assert nb.build_native(lib="toy") == first
    assert os.stat(first).st_mtime_ns == stamp


def test_the_loader_rebuilds_a_library_older_than_its_source(toy, monkeypatch):
    """``models/wordpiece.py::_native_encoder`` builds a library that is
    older than its source before it loads it, so a checkout that holds a
    library built before new entry points were added does not load it as it
    is (a stale one here lacks the encoder's symbols and would load as None)."""
    from ircl_tpu_torch.models import wordpiece as wp

    src = toy.parent / "src" / "toy.cpp"
    monkeypatch.setattr(nb, "_PORT_LIBS", {"wordpiece": ("native/src/toy.cpp",
                                                         "native/libtoy.so", [])})
    assert nb.build_native(lib="wordpiece") == str(toy)
    src.write_text(SOURCE + "".join(
        f'extern "C" void {name}() {{}}\n' for name in
        ("ircl_wordpiece_vocab_new", "ircl_wordpiece_vocab_free",
         "ircl_wordpiece_encode_pairs")))
    past = os.stat(src).st_mtime - 60
    os.utime(toy, (past, past))
    lib = wp._native_encoder.__wrapped__()
    assert lib is not None and lib.ircl_toy_answer() == 42
    assert os.stat(toy).st_mtime > past
