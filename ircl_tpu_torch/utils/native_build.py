"""Build helper for the native C++ host libraries (ctypes-loaded).

Counterpart of ``ircl_tpu/utils/native_build.py``, carried over line for line apart from
imports, the atomic write and the port's own library below: the port keeps its
own copy of every module it needs and imports nothing of the JAX package.

Compiles each source in ``native/src/`` into its shared object with g++ if
the .so is missing or stale:

- ``ircl_native.cpp`` -> ``native/libircl_native.so`` (host hot paths:
  hashing, tokenization, split fill, pool gather)
- ``ircl_http.cpp`` -> ``native/libircl_http.so`` (epoll HTTP front for the
  serving layer; needs -pthread)

The port adds one library of its own, from a source it owns (``_PORT_LIBS``):

- ``ircl_tpu_torch/csrc/wordpiece.cpp`` ->
  ``ircl_tpu_torch/_build/libircl_wordpiece.so`` (the WordPiece pair
  encoder of ``models/wordpiece.py``)

Build is best-effort: every caller has a pure-Python fallback, so failure
here degrades performance only.

Unlike the original, g++ writes into a temporary file beside the library,
which is then renamed onto it (``os.replace``, atomic within a directory):
processes that build and load at the same time, as a test run's workers do
on a fresh checkout, never open a half-written library. The original lets
g++ write the final path, and a loader that opens it mid-write fails for
the rest of its process (``corpus/hashing.py::_load_native``).
"""

from __future__ import annotations

import os
import subprocess
import threading

_LIBS = {
    "native": ("ircl_native.cpp", "libircl_native.so", []),
    "http": ("ircl_http.cpp", "libircl_http.so", ["-pthread"]),
}
# lib -> (source, library, extra flags), the paths from the repository root
_PORT_LIBS = {
    "wordpiece": ("ircl_tpu_torch/csrc/wordpiece.cpp",
                  "ircl_tpu_torch/_build/libircl_wordpiece.so", []),
}


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_native(force: bool = False, lib: str = "native") -> str | None:
    root = repo_root()
    if lib in _PORT_LIBS:
        src_name, out_name, extra = _PORT_LIBS[lib]
        src, out = os.path.join(root, src_name), os.path.join(root, out_name)
    else:
        src_name, out_name, extra = _LIBS[lib]
        src = os.path.join(root, "native", "src", src_name)
        out = os.path.join(root, "native", out_name)
    if not os.path.exists(src):
        return None
    if not force and os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    # one name per process and thread, in the library's own directory
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-std=c++17",
        *extra,
        "-o",
        tmp,
        src,
    ]
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except Exception:
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


if __name__ == "__main__":
    for lib in (*_LIBS, *_PORT_LIBS):
        path = build_native(force=True, lib=lib)
        print(f"{lib}: {path or 'build failed'}")
