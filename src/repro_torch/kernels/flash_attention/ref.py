"""Plain oracle for grouped-query attention with cache masking.

Counterpart of ``repro/kernels/flash_attention/ref.py``: softmax in
float32, the weights cast to v's dtype before P·V (so it equals the flash
kernel's function only in float32)."""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, T, K, D) with H % K == 0.

    ``q_offset`` shifts query positions (decode against a cache);
    ``kv_valid_len`` masks cache slots >= that length."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    logits = logits / math.sqrt(d)
    kpos = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + q_offset
        ok = qpos >= kpos
    if kv_valid_len is not None:
        ok = ok & (kpos < kv_valid_len)
    logits = torch.where(ok, logits, torch.full((), -1e30, device=q.device))
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, d)
