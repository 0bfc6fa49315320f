"""Multi-layer bidirectional LSTM on tensors.

Counterpart of ``ircl_tpu/ops/bilstm.py`` (``lax.scan`` there), which
replaces the reference's cuDNN ``nn.LSTM`` encoder head
(``src/model.py:16-22``). Same layout and numerics:

- per layer and direction ``w_ih [4H, I]``, ``w_hh [4H, H]`` and one
  folded bias ``b [4H]`` (torch gate order i, f, g, o);
- the input projection ``x @ w_ih^T + b`` for the whole sequence is one
  matrix product per layer and direction, hoisted out of the recurrence;
- the recurrence is a Python loop over time in which both directions of a
  layer step together as one batched product (the reverse direction walks
  the sequence backwards);
- init as the reference (``src/model.py:29-36``): Xavier-uniform ``w_ih``,
  orthogonal ``[4H, H]`` ``w_hh``, zero bias, drawn from an explicit
  ``torch.Generator``.

cuDNN's LSTM is not used, so no TF32 switch applies to the recurrence; the
products run in full fp32 under ``utils.precision.float32_precision`` at the
callers (``contrastive.train``). Autograd runs through the loop: each step's
``h`` is kept and the outputs are stacked once.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ircl_tpu_torch.utils.device import resolve_device


def _xavier_uniform(gen: torch.Generator, shape) -> torch.Tensor:
    fan_out, fan_in = shape[0], shape[1]
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * limit


def _orthogonal(gen: torch.Generator, shape) -> torch.Tensor:
    a = torch.randn(shape, generator=gen)
    tall = shape[0] >= shape[1]
    q, r = torch.linalg.qr(a if tall else a.T)
    q = q * torch.sign(torch.diagonal(r))
    return q if tall else q.T


def init_bilstm_params(
    gen: torch.Generator,
    input_size: int,
    hidden_size: int,
    num_layers: int,
    bidirectional: bool = True,
    device=None,
) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Per-layer params ``{'fwd': {...}, 'bwd': {...}}`` (no ``bwd`` when
    unidirectional), drawn on the CPU from ``gen`` and moved to ``device``
    (by default the card), so one seed gives the same weights on every
    device."""
    device = resolve_device(device)
    dirs = 2 if bidirectional else 1
    layers = []
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else hidden_size * dirs
        layer_params = {}
        for d in range(dirs):
            # orthogonal init over the whole [4H, H] gate stack, as the
            # reference's init_weights does over the named parameters
            w_ih = _xavier_uniform(gen, (4 * hidden_size, in_size))
            w_hh = _orthogonal(gen, (4 * hidden_size, hidden_size))
            layer_params["bwd" if d else "fwd"] = {
                "w_ih": w_ih.to(device),
                "w_hh": w_hh.to(device),
                "b": torch.zeros(4 * hidden_size, device=device),
            }
        layers.append(layer_params)
    return layers


def _bilstm_layer(dirs: List[Dict[str, torch.Tensor]], x: torch.Tensor):
    """One layer, its directions stepping together. x: [B, L, I] ->
    [B, L, H * len(dirs)] in x's dtype; dirs[1], when present, runs
    backwards. In bfloat16, as the reference with ``preferred_element_type
    =f32``: ``h`` is carried in bf16, ``c`` and the gates in f32, and every
    product takes bf16 operands in f32 (exact there) with an f32 result;
    PyTorch's own bf16 product would round its result to bf16. In float32
    every cast below is the identity."""
    B, L, _ = x.shape
    H = dirs[0]["w_hh"].shape[1]
    n = len(dirs)
    dtype = x.dtype
    f32 = lambda t: t.to(dtype).float()  # noqa: E731  the operand rounded to dtype
    # hoisted input projections, each direction in its own step order:
    # [n, B, L, 4H]
    xf = x.float()
    proj = [xf @ f32(p["w_ih"]).T + p["b"] for p in dirs]
    xs = torch.stack([t.flip(1) if d else t for d, t in enumerate(proj)])
    w_hh_t = torch.stack([f32(p["w_hh"]).T for p in dirs])  # [n, H, 4H]
    h = x.new_zeros((n, B, H))
    c = xs.new_zeros((n, B, H))
    hs = []
    for s in range(L):
        gates = xs[:, :, s] + torch.bmm(h.float(), w_hh_t)  # [n, B, 4H]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(dtype)
        hs.append(h)
    out = torch.stack(hs, dim=2)  # [n, B, L, H], step order
    return torch.cat([o.flip(1) if d else o for d, o in enumerate(out)], dim=-1)


def bilstm_apply(layers, x: torch.Tensor) -> torch.Tensor:
    """Full stack. x: [B, L, I] -> [B, L, H * dirs]."""
    out = x
    for layer_params in layers:
        dirs = [layer_params["fwd"]]
        if "bwd" in layer_params:
            dirs.append(layer_params["bwd"])
        out = _bilstm_layer(dirs, out)
    return out
