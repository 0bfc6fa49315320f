"""The grouped expert GEMM (``csrc/moe_grouped_gemm.cu``), every MoE layer
of a batch: the routed rows' two products (gate and up, ``2 * hidden * 2 *
width`` operations a row; down, ``2 * width * hidden``) at the bf16 rate, or
the experts' weights read once (``3 * width * hidden`` bf16 values an
expert), whichever takes longer."""

from benchmark.rooflines import moonlight_model
from benchmark.rooflines.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def match(name: str) -> bool:
    return "moe_grouped_gemm_kernel" in name


def seconds(w: dict) -> float:
    h, ie = w["hidden"], w["expert_width"]
    ops = moonlight_model.routed_rows(w) * 2.0 * 3 * h * ie
    nbytes = 2.0 * w["experts"] * 3 * ie * h
    return moonlight_model.moe_layers(w) * max(ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
