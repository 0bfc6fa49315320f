"""Build and load the port's CUDA kernels (``ircl_tpu_torch/csrc/*.cu``).

Counterpart of ``ircl_tpu/utils/native_build.py``, which builds the C++
host library with g++. Here nvcc compiles every ``csrc/*.cu`` for Hopper,
one process per source, all started together, and links the objects into
one shared library with a plain C interface, at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v -c -o <source>.o csrc/<source>.cu
    nvcc -shared -o libircl_kernels.so *.o

The library lands in ``ircl_tpu_torch/_build/<hash>/``, keyed by a hash of
the sources, the headers they share (``csrc/*.cuh``) and the flags, so an edited kernel rebuilds and an unchanged one
loads at once. It is loaded with ``ctypes``; PyTorch's extension builder
is not used, because a source that includes PyTorch's headers takes
minutes to compile. Every pointer and the stream cross as ``c_void_p``,
every size as ``c_int64`` and a scale as ``c_float``. Each C entry point returns ``cudaGetLastError()``
and ``check`` turns a non-zero code into an exception.

Nothing here runs at import: the CPU tests import every module, on hosts
without nvcc. A failed build raises with nvcc's output; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills per kernel
)
LINK_FLAGS = ("-shared",)
LIB_NAME = "libircl_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    # name: (argtypes, restype)
    "ircl_membership_slab": ([_P, _I, _P, _P, _I, _I, _P, _I, _I, _P], ctypes.c_int),
    "ircl_light_add_topk": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
                            ctypes.c_int),
    "ircl_dense_cmax": ([_P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P],
                        ctypes.c_int),
    "ircl_dense_cmax_presplit": ([_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P],
                                 ctypes.c_int),
    "ircl_dense_cmax_mma": ([_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
                            ctypes.c_int),
    "ircl_fused_hybrid": ([_P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                           _P, _P, _P], ctypes.c_int),
    "ircl_fused_dot_light": ([_P, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                              _P, _P, _P], ctypes.c_int),
    "ircl_flash_attention": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              ctypes.c_float, _P, _P], ctypes.c_int),
    "ircl_flash_attention_stats": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    ctypes.c_float, _P, _P, _P, _P], ctypes.c_int),
    "ircl_flash_attention_bwd_dkv": ([_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, ctypes.c_float,
                                      _P, _P, _P], ctypes.c_int),
    "ircl_flash_attention_bwd_dq": ([_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, ctypes.c_float,
                                     _P, _P], ctypes.c_int),
    "ircl_moe_grouped_gemm": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P], ctypes.c_int),
    "ircl_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sources() -> list:
    return sorted(glob.glob(os.path.join(package_root(), "csrc", "*.cu")))


def headers() -> list:
    """The ``csrc/*.cuh`` files that the sources include."""
    return sorted(glob.glob(os.path.join(package_root(), "csrc", "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels cannot be built"
    )


def _source_key(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in [*srcs, *headers()]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when a built library was found
    build_log: str  # nvcc's output (ptxas resource lines), "" when found

    def check(self, code: int, what: str) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if code:
            name = self.lib.ircl_cuda_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({name})")


def build(srcs=None) -> tuple:
    """Compile the sources into the keyed build directory, unless that
    library exists. Returns (path, seconds, nvcc output)."""
    srcs = list(srcs or sources())
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {package_root()}/csrc")
    out_dir = os.path.join(package_root(), "_build", _source_key(srcs))
    out = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(out):
        return out, 0.0, ""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{out}.tmp{os.getpid()}"
    objs = [
        os.path.join(out_dir, f"{os.path.basename(p)}.{os.getpid()}.o")
        for p in srcs
    ]
    t0 = time.perf_counter()
    # one nvcc per source, all started together; then one link
    compiles = [
        [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(srcs, objs)
    ]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in compiles
    ]
    outputs = [p.communicate()[0] for p in procs]
    log = "".join(outputs)
    try:
        for cmd, p, text in zip(compiles, procs, outputs):
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{text}"
                )
        link = [nvcc, *LINK_FLAGS, "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(link)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    seconds = time.perf_counter() - t0
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, seconds, log + proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_kernels() -> KernelLibrary:
    """The built kernel library, built on the first call of the process."""
    path, seconds, log = build()
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds, build_log=log)


if __name__ == "__main__":
    k = load_kernels()
    print(f"{k.path} ({k.build_seconds:.1f} s)\n{k.build_log}")
