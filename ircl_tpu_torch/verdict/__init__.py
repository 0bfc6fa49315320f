"""Claim-verdict classification (extrinsic evaluation of retrieval).

Counterpart of ``ircl_tpu/verdict/``: the model, its optimizer and train
step (``model``), dataset prep (``data``), the training loop (``train``),
the classification report (``evaluate``) and pinned-shape inference with
its checkpoint files (``infer``).
"""

from ircl_tpu_torch.verdict.evaluate import classification_report
from ircl_tpu_torch.verdict.model import VerdictConfig, init_verdict_params, verdict_apply

__all__ = [
    "VerdictConfig",
    "init_verdict_params",
    "verdict_apply",
    "classification_report",
]
