"""Int8 gradient compression with error feedback.

Counterpart of ``repro/optim/compression.py``: the wire format of a
compressed gradient all-reduce (f32 -> int8 payload + one float32 scale
per tensor, 4x fewer bytes), with the quantization residual carried into
the next step's gradient (1-bit-Adam lineage), so the sum over steps stays
exact in expectation. On one card there is no collective: the numerics are
exercised end to end and tested for bounded error.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch


def compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 tensor -> (int8 payload, float32 scale): ``scale =
    max(max|x| / 127, 1e-12)``, ``q = clip(round(x / scale), -127, 127)``,
    rounding half to even."""
    scale = torch.clamp(torch.max(torch.abs(x)) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_gradients(grads: Mapping[str, Optional[torch.Tensor]],
                         error_state: Optional[Mapping] = None):
    """Quantize a dictionary of gradients with error feedback -> (the
    dequantized gradients in their own dtypes, the new error state: each
    leaf's float32 residual). Non-floating and None leaves pass through,
    with a None residual."""
    def is_float(x):
        return x is not None and x.dtype.is_floating_point

    if error_state is None:
        error_state = {k: torch.zeros_like(g, dtype=torch.float32)
                       if is_float(g) else None for k, g in grads.items()}
    new_g: Dict = {}
    new_e: Dict = {}
    for k, g in grads.items():
        if not is_float(g):
            new_g[k], new_e[k] = g, None
            continue
        e = error_state.get(k)
        corrected = g.to(torch.float32) + (0.0 if e is None else e)
        deq = decompress(*compress(corrected))
        new_g[k], new_e[k] = deq.to(g.dtype), corrected - deq
    return new_g, new_e
