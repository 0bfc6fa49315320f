"""Build helper for the native C++ host libraries (ctypes-loaded).

Counterpart of ``ircl_tpu/utils/native_build.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

Compiles each source in ``native/src/`` into its shared object with g++ if
the .so is missing or stale:

- ``ircl_native.cpp`` -> ``native/libircl_native.so`` (host hot paths:
  hashing, tokenization, split fill, pool gather)
- ``ircl_http.cpp`` -> ``native/libircl_http.so`` (epoll HTTP front for the
  serving layer; needs -pthread)

Build is best-effort: every caller has a pure-Python fallback, so failure
here degrades performance only.
"""

from __future__ import annotations

import os
import subprocess

_LIBS = {
    "native": ("ircl_native.cpp", "libircl_native.so", []),
    "http": ("ircl_http.cpp", "libircl_http.so", ["-pthread"]),
}


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_native(force: bool = False, lib: str = "native") -> str | None:
    src_name, out_name, extra = _LIBS[lib]
    root = repo_root()
    src = os.path.join(root, "native", "src", src_name)
    out = os.path.join(root, "native", out_name)
    if not os.path.exists(src):
        return None
    if not force and os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-std=c++17",
        *extra,
        "-o",
        out,
        src,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception:
        return None
    return out if os.path.exists(out) else None


if __name__ == "__main__":
    for lib in _LIBS:
        path = build_native(force=True, lib=lib)
        print(f"{lib}: {path or 'build failed'}")
