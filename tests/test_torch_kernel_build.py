"""The CUDA kernel build helper, as far as a host without nvcc can check it.

Building needs nvcc and running needs a GPU; ``chip_smoke.py`` does both on
the card. Here: the sources are found, the build key follows their content,
a missing toolchain raises (no fallback), and importing the kernels'
modules builds nothing.
"""

import ctypes
import os
import shutil

import pytest

from ircl_tpu_torch.utils import kernel_build as kb


def test_sources_are_the_package_csrc():
    names = sorted(os.path.basename(p) for p in kb.sources())
    assert names == ["dense_cmax.cu", "flash_attention.cu", "flash_attention_bwd.cu",
                     "fused_dot_light.cu", "fused_hybrid.cu", "light_add_topk.cu",
                     "membership_slab.cu", "moe_grouped_gemm.cu"]
    for path in kb.sources():
        text = open(path, encoding="utf-8").read()
        assert 'extern "C"' in text and "cudaGetLastError()" in text
        assert "Replaces" in text or "replaces" in text


def test_every_entry_point_has_a_signature():
    text = "".join(open(p, encoding="utf-8").read() for p in kb.sources())
    for name, (argtypes, restype) in kb._SIGNATURES.items():
        assert f"{name}(" in text
        assert restype is not None
    # pointers and the stream cross as c_void_p, never as a 32-bit int
    assert ctypes.c_int not in kb._SIGNATURES["ircl_membership_slab"][0]
    # the slab entry (both slab wrappers' one kernel) writes into a column
    # range of a buffer: out, its leading dimension and the column offset,
    # then the stream
    for name in ("ircl_membership_slab",):
        assert kb._SIGNATURES[name][0] == [ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int64, ctypes.c_int64,
                                           ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_int64, ctypes.c_void_p]
    assert ctypes.c_int not in kb._SIGNATURES["ircl_light_add_topk"][0]
    assert ctypes.c_int not in kb._SIGNATURES["ircl_dense_cmax"][0]
    assert ctypes.c_int not in kb._SIGNATURES["ircl_flash_attention"][0]
    for name in ("ircl_dense_cmax_presplit", "ircl_fused_hybrid", "ircl_fused_dot_light",
                 "ircl_moe_grouped_gemm"):
        assert ctypes.c_int not in kb._SIGNATURES[name][0]
    # the pre-split entry swaps the mode for a second corpus pointer
    assert len(kb._SIGNATURES["ircl_dense_cmax_presplit"][0]) == len(
        kb._SIGNATURES["ircl_dense_cmax"][0])
    assert kb._SIGNATURES["ircl_dense_cmax_presplit"][0][4] is ctypes.c_void_p
    # the fused kernels end in light_add_topk_t's outputs and stream
    for name in ("ircl_fused_hybrid", "ircl_fused_dot_light"):
        assert kb._SIGNATURES[name][0][-3:] == kb._SIGNATURES["ircl_light_add_topk"][0][-3:]
    for name in ("ircl_flash_attention_stats", "ircl_flash_attention_bwd_dkv",
                 "ircl_flash_attention_bwd_dq"):
        assert ctypes.c_int not in kb._SIGNATURES[name][0]
        # the stats entry adds l and m to the forward's arguments; the two
        # backward entries differ by dK/dV's second output
    assert len(kb._SIGNATURES["ircl_flash_attention_stats"][0]) == len(
        kb._SIGNATURES["ircl_flash_attention"][0]) + 2
    assert len(kb._SIGNATURES["ircl_flash_attention_bwd_dkv"][0]) == len(
        kb._SIGNATURES["ircl_flash_attention_bwd_dq"][0]) + 1


def test_every_c_entry_point_is_listed():
    """Each ``extern "C"`` function of the sources has a ctypes signature,
    and the list names no function the sources lack."""
    import re

    text = "".join(open(p, encoding="utf-8").read() for p in kb.sources())
    found = set(re.findall(r'extern "C" [\w\s*]+?\b(ircl_\w+)\(', text))
    assert found == set(kb._SIGNATURES)
    assert {"ircl_membership_slab", "ircl_fused_hybrid"} <= found
    assert "ircl_membership_slab_windowed" not in found  # one slab kernel


def test_shared_headers_are_part_of_the_build_key(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` rebuilds the sources that include it."""
    names = [os.path.basename(p) for p in kb.headers()]
    assert names == ["flash_attention_common.cuh", "mma_tf32.cuh", "topk_columns.cuh",
                     "topk_registers.cuh", "wgmma_tma.cuh"]
    users = {
        "flash_attention_common.cuh": ["flash_attention.cu", "flash_attention_bwd.cu"],
        "mma_tf32.cuh": ["flash_attention.cu", "flash_attention_bwd.cu"],
        "topk_columns.cuh": ["fused_dot_light.cu", "fused_hybrid.cu",
                             "light_add_topk.cu"],
        "topk_registers.cuh": ["fused_dot_light.cu", "light_add_topk.cu"],
        "wgmma_tma.cuh": ["fused_dot_light.cu", "moe_grouped_gemm.cu"],
    }
    for name in names:
        included = [p for p in kb.sources()
                    if f'#include "{name}"' in open(p, encoding="utf-8").read()]
        assert sorted(os.path.basename(p) for p in included) == users[name]
    a = tmp_path / "a.cu"
    a.write_text("int x;\n")
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(kb, "headers", lambda: [str(header)])
    k1 = kb._source_key([str(a)])
    header.write_text("// two\n")
    assert kb._source_key([str(a)]) != k1


@pytest.mark.parametrize("source,needs", [
    # the fused dot: TMA tiles into an mbarrier ring, warpgroup products on
    # MN-major operands (both transpose bits set), a producer warpgroup that
    # hands its registers over
    ("fused_dot_light.cu", ["cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity",
                            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16",
                            "wgmma_m64n256k16<true>(", "p, 1, 1, %131, %131;",
                            "setmaxnreg.dec", "setmaxnreg.inc",
                            "cuTensorMapEncodeTiled", "CU_TENSOR_MAP_SWIZZLE_128B"]),
    # the grouped expert GEMM: the same ring and products on K-major operands,
    # one persistent block an SM walking the tiles, 16-byte stores
    ("moe_grouped_gemm.cu", ["cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity",
                             "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16",
                             "wgmma_m64n256k16<false>(", "setmaxnreg.dec",
                             "setmaxnreg.inc", "cudaDevAttrMultiProcessorCount",
                             "t += gridDim.x", "quad_transpose",
                             "CU_TENSOR_MAP_SWIZZLE_128B"]),
    # the light add: row groups streamed through bulk-copy rings, register
    # lists, and the column kernel for k above the list
    ("light_add_topk.cu", ["cp.async.bulk.shared::cluster.global",
                           "mbarrier.try_wait.parity", "RegisterTopK", "lower_bounds",
                           "ColumnTopK", "k <= kList"]),
])
def test_kernels_take_their_hopper_design(source, needs):
    text = open(os.path.join(kb.package_root(), "csrc", source), encoding="utf-8").read()
    text += "".join(open(p, encoding="utf-8").read() for p in kb.headers()  # and its headers
                    if f'#include "{os.path.basename(p)}"' in text)
    for word in needs:
        assert word in text, word
    # the tensor-map encoder is looked up through the runtime: the library
    # links without -lcuda
    assert "-lcuda" not in kb.LINK_FLAGS


def test_source_key_follows_content(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("int x;\n")
    k1 = kb._source_key([str(a)])
    assert kb._source_key([str(a)]) == k1
    a.write_text("int y;\n")
    assert kb._source_key([str(a)]) != k1


def test_flags_target_hopper():
    flags = " ".join(kb.NVCC_FLAGS + kb.LINK_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    if shutil.which("nvcc"):
        pytest.skip("this host has nvcc")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    a = tmp_path / "k.cu"
    a.write_text("int x;\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kb._nvcc()
    monkeypatch.setattr(kb, "package_root", lambda: str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kb.build([str(a)])


def test_failed_launch_code_raises():
    class _Lib:
        @staticmethod
        def ircl_cuda_error_string(code):
            return b"invalid configuration argument"

    lib = kb.KernelLibrary(lib=_Lib(), path="x", build_seconds=0.0, build_log="")
    lib.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        lib.check(9, "a launch")
