"""MurmurHash3 (x86 32-bit) feature hashing.

Counterpart of ``ircl_tpu/corpus/hashing.py``, carried over line for line apart from
imports: the port keeps its own copy of every module it needs and imports
nothing of the JAX package.

Hash identity is a correctness requirement: index-side and query-side ngram
hashing must agree bit-for-bit, and we additionally target bit-exactness with
the reference's hasher (sklearn ``murmurhash3_32`` with ``positive=True``,
seed 0 — see reference ``preprocessing/drqa/retriever/utils.py:44-46``) so
recall numbers are directly comparable.

Implementation strategy:

- a native C++ batch hasher (``native/src/ircl_native.cpp``) loaded via ctypes
  for the index-build hot path (millions of ngrams);
- a pure-Python scalar implementation used as fallback and as an independent
  cross-check in tests.

Both implement MurmurHash3 x86_32 over the UTF-8 encoding of the token.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

_MASK32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK32


def murmurhash3_32(key: str | bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 of a string/bytes key, returned as unsigned 32-bit.

    Pure-Python reference implementation (scalar). Equivalent to
    ``sklearn.utils.murmurhash3_32(key, positive=True)`` for ``seed=0``.
    """
    data = key.encode("utf-8") if isinstance(key, str) else key
    n = len(data)
    nblocks = n // 4

    h1 = seed & _MASK32
    c1 = 0xCC9E2D51
    c2 = 0x1B873593

    for i in range(nblocks):
        k1 = int.from_bytes(data[4 * i : 4 * i + 4], "little")
        k1 = (k1 * c1) & _MASK32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _MASK32
        h1 ^= k1
        h1 = _rotl32(h1, 13)
        h1 = (h1 * 5 + 0xE6546B64) & _MASK32

    # tail
    tail = data[nblocks * 4 :]
    k1 = 0
    if len(tail) >= 3:
        k1 ^= tail[2] << 16
    if len(tail) >= 2:
        k1 ^= tail[1] << 8
    if len(tail) >= 1:
        k1 ^= tail[0]
        k1 = (k1 * c1) & _MASK32
        k1 = _rotl32(k1, 15)
        k1 = (k1 * c2) & _MASK32
        h1 ^= k1

    # finalization
    h1 ^= n
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _MASK32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _MASK32
    h1 ^= h1 >> 16
    return h1


# ---------------------------------------------------------------------------
# Native batch hasher (ctypes).
# ---------------------------------------------------------------------------

_NATIVE_LIB = None
_NATIVE_TRIED = False


def _native_lib_path() -> str:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "native", "libircl_native.so")


def _load_native():
    global _NATIVE_LIB, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE_LIB
    _NATIVE_TRIED = True
    path = _native_lib_path()
    if not os.path.exists(path):
        # Attempt an on-demand build if a toolchain is present.
        try:
            from ircl_tpu_torch.utils.native_build import build_native

            built = build_native()
            if built:
                path = built
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
        lib.ircl_murmur3_batch.argtypes = [
            ctypes.c_char_p,  # packed utf-8 bytes
            ctypes.POINTER(ctypes.c_int64),  # offsets, len n+1
            ctypes.c_int64,  # n strings
            ctypes.c_uint32,  # seed
            ctypes.POINTER(ctypes.c_uint32),  # out hashes
        ]
        lib.ircl_murmur3_batch.restype = None
        _NATIVE_LIB = lib
    except OSError:
        _NATIVE_LIB = None
    return _NATIVE_LIB


_SIG_CONFIGURED: set = set()


def get_native(symbol: str, argtypes, restype):
    """Load the native runtime and configure ``symbol``'s ctypes signature
    once. Returns the CDLL (or None when the library or symbol is absent).

    The ONE copy of the load-probe-configure boilerplate every native entry
    point needs — callers chain one call per symbol instead of keeping a
    per-module _CONFIGURED flag in sync with ircl_native.cpp by hand.
    """
    lib = _load_native()
    if lib is None or not hasattr(lib, symbol):
        return None
    if symbol not in _SIG_CONFIGURED:
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _SIG_CONFIGURED.add(symbol)
    return lib


def hash_token(token: str, num_buckets: int) -> int:
    """Feature-hash one token: unsigned murmur3 mod num_buckets.

    Matches reference ``utils.hash`` (``drqa/retriever/utils.py:44-46``).
    """
    return murmurhash3_32(token) % num_buckets


def hash_tokens(tokens: Sequence[str], num_buckets: int) -> np.ndarray:
    """Vectorized feature hashing of many tokens -> int64 bucket ids.

    Uses the native batch hasher when available; falls back to pure Python.
    """
    if len(tokens) == 0:
        return np.empty((0,), dtype=np.int64)
    lib = _load_native()
    if lib is not None:
        encoded = [t.encode("utf-8") for t in tokens]
        offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        packed = b"".join(encoded)
        out = np.empty(len(encoded), dtype=np.uint32)
        lib.ircl_murmur3_batch(
            packed,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(encoded),
            0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return (out.astype(np.int64)) % num_buckets
    return np.array(
        [murmurhash3_32(t) % num_buckets for t in tokens], dtype=np.int64
    )


def native_available() -> bool:
    return _load_native() is not None
