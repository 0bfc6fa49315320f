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
                     "membership_slab.cu"]
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
    assert ctypes.c_int not in kb._SIGNATURES["ircl_light_add_topk"][0]
    assert ctypes.c_int not in kb._SIGNATURES["ircl_dense_cmax"][0]
    assert ctypes.c_int not in kb._SIGNATURES["ircl_flash_attention"][0]
    for name in ("ircl_dense_cmax_presplit", "ircl_fused_hybrid", "ircl_fused_dot_light"):
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


def test_shared_headers_are_part_of_the_build_key(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` rebuilds the sources that include it."""
    names = [os.path.basename(p) for p in kb.headers()]
    assert names == ["flash_attention_common.cuh", "topk_columns.cuh"]
    users = {
        "flash_attention_common.cuh": ["flash_attention.cu", "flash_attention_bwd.cu"],
        "topk_columns.cuh": ["fused_dot_light.cu", "fused_hybrid.cu",
                             "light_add_topk.cu"],
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
