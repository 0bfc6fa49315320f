"""Claim-verdict classification, the served half.

Counterpart of ``ircl_tpu/verdict/``: the model's forward (``model``) and
pinned-shape inference with its checkpoint files (``infer``). Verdict
training (``data``, ``train``, ``evaluate``, the train step) waits for
ROADMAP.md queue 1 item 11.
"""

from ircl_tpu_torch.verdict.model import VerdictConfig, init_verdict_params, verdict_apply

__all__ = [
    "VerdictConfig",
    "init_verdict_params",
    "verdict_apply",
]
