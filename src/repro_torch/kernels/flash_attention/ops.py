"""Grouped-query flash attention (forward).

Counterpart of ``repro/kernels/flash_attention/ops.py``. On a CUDA tensor
:func:`flash_attention` launches one of the three Hopper kernels of
``repro_torch/csrc/flash_attention.cu``, chosen by :func:`variant` from the
call's dtype and shape alone; on a CPU tensor it runs
:func:`flash_attention_plain`, the function's definition in torch ops. All
compute what the reference's ``_flash_kernel`` computes:

* q (B, S, H, D) and k/v (B, T, K, D), H % K == 0, one floating dtype
  (the kernels take float32, bfloat16 and float16, D a multiple of 8 up to
  256; the plain version any);
* scores ``q·kᵀ·(1/√D)`` in float32, set to -1e30 where
  ``q_offset + i < kpos`` (causal) or ``kpos >= kv_valid_len``;
* an online softmax in float32, and P·V summed in float32;
* output ``acc / max(l, 1e-30)`` in q's dtype.

What each variant does with P:

* ``"dec"`` (any of the three dtypes with at most ``DEC_MAX_ROWS``
  (query, head) rows per kv head: a decode step, short calls): every
  element upcast to float32 as it is read, P never rounded; the keys split
  across blocks (:func:`dec_splits`) and across the warps of a block, each
  part's online softmax state merged by ``e^(m_part - M)``;
* ``"scalar"`` (the rest: float32 and float16 calls of more than 16 rows
  per kv head, bfloat16 ones of 17 to 63 rows or with a D the tc kernel
  does not take): every element upcast to float32, P never rounded;
* ``"tc"`` (bfloat16 prefill, on the tensor cores): Q, K and V exact (they
  are bfloat16 already), P carried as ``P_hi + P_lo``, two bfloat16 terms
  (``P_hi = bf16(P)``, ``P_lo = bf16(P - P_hi)``), relative error at most
  about 2^-16 per element; every sum in float32.

``q_offset`` and ``kv_valid_len`` are runtime arguments of the kernels, so
a decode step against a cache of T slots neither recompiles nor reads the
slots past ``kv_valid_len``. Every row has at least one valid key (key 0):
``q_offset >= 0`` and ``kv_valid_len >= 1`` are required.

No backward: the training slice adds it as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, dispatch

NEG_INF = -1e30
MAX_HEAD_DIM = 256
ROWS_PER_BLOCK = 32      # (query, head) rows of one block of the scalar
KEY_TILE = 32            # kernel, and the keys it stages per tile
TC_MAX_HEAD_DIM = 128    # the tc kernel: D % 16 == 0 up to this,
TC_MIN_ROWS = 64         # and at least one warpgroup of (query, head) rows
DEC_MAX_ROWS = 16        # the dec kernel: every (query, head) row of a kv
                         # group in one block
DEC_KEY_GRANULE = 64     # its splits are whole multiples of this many keys
                         # (each of its tile sizes divides it)
DEC_BLOCKS_PER_SM = 4    # its split count aims at this many blocks an SM
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
           kv_valid_len: Optional[int]) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name}: expected 4 dims, got shape "
                             f"{tuple(t.shape)}")
        if not t.dtype.is_floating_point:
            raise TypeError(f"{name}: expected a floating dtype, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shapes do not fit: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k.shape[2]} "
                         "kv heads")
    if d < 1:
        raise ValueError(f"head_dim {d}: expected at least 1")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if kv_valid_len is not None and kv_valid_len < 1:
        raise ValueError(f"kv_valid_len {kv_valid_len} < 1: every query "
                         "needs a valid key")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          kv_valid_len: Optional[int] = None
                          ) -> torch.Tensor:
    """The kernel's function in torch ops, in float32, with its -1e30 mask
    and 1e-30 denominator guards. Materialises the (B, K, g, S, T) scores."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    qf = q.to(torch.float32).reshape(b, s, kh, g, d).permute(0, 2, 3, 1, 4)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]  # (B,K,1,T,D)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    kpos = torch.arange(t, device=q.device)
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + q_offset
        ok = qpos >= kpos[None, :]
    if kv_valid_len is not None:
        ok = ok & (kpos < kv_valid_len)[None, :]
    scores = torch.where(ok, scores, torch.full((), NEG_INF,
                                                device=q.device))
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    out = torch.matmul(p, vf) / torch.clamp(l, min=1e-30)   # (B,K,g,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def variant(dtype: torch.dtype, s: int, g: int, d: int) -> str:
    """Which kernel a CUDA call runs, from its dtype, query length ``s``,
    group size ``g = H / K`` and head width ``d``: ``"tc"`` (tensor cores)
    for bfloat16 with ``d % 16 == 0``, ``d <= 128`` and ``s * g >= 64`` (at
    least one warpgroup of rows); ``"dec"`` for any of the three dtypes with
    ``d`` a multiple of 8 up to 256 and ``s * g <= DEC_MAX_ROWS`` (a decode
    step: the rows of a group fit one block); else ``"scalar"``."""
    if (dtype == torch.bfloat16 and d % 16 == 0 and d <= TC_MAX_HEAD_DIM
            and s * g >= TC_MIN_ROWS):
        return "tc"
    if (dtype in _DTYPE_CODES and d % 8 == 0 and d <= MAX_HEAD_DIM
            and s * g <= DEC_MAX_ROWS):
        return "dec"
    return "scalar"


def kv_splits(b: int, s: int, h: int, kh: int, kv_len: int,
              n_sms: int) -> int:
    """How many blocks the scalar kernel runs along the keys of one (row
    block, kv head, sequence): 1 when that grid fills a wave of the card's
    ``n_sms`` SMs, else enough to give about two blocks per SM, with at
    least 4 key tiles per block (a decode step: B * K blocks otherwise)."""
    blocks = -(-s * (h // kh) // ROWS_PER_BLOCK) * kh * b
    if blocks >= n_sms:
        return 1
    return max(1, min(-(-2 * n_sms // blocks),
                      -(-kv_len // (4 * KEY_TILE))))


def dec_splits(b: int, kh: int, kv_len: int, n_sms: int) -> tuple:
    """``(splits, chunk)`` of the dec kernel: each of the ``b * kh``
    (sequence, kv head) pairs runs ``splits`` blocks along its ``kv_len``
    keys, block ``i`` keys ``[i * chunk, min((i + 1) * chunk, kv_len))``.
    ``chunk`` is a whole number of ``DEC_KEY_GRANULE`` keys, so every split
    boundary falls on a tile of the kernel; the count aims at
    ``DEC_BLOCKS_PER_SM`` blocks on each of the card's ``n_sms`` SMs, at
    most one split per granule, and no split is empty."""
    granules = -(-kv_len // DEC_KEY_GRANULE)
    want = -(-DEC_BLOCKS_PER_SM * n_sms // (b * kh))
    chunk = -(-granules // min(want, granules)) * DEC_KEY_GRANULE
    return -(-kv_len // chunk), chunk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, T, K, D) -> (B, S, H, D) in q's dtype.
    Replaces ``flash_attention_fwd``."""
    q_offset = int(q_offset)
    kv_valid_len = None if kv_valid_len is None else int(kv_valid_len)
    _check(q, k, v, q_offset, kv_valid_len)
    t = dispatch.tier(q)
    dispatch.note_tier("flash_attention.fwd", t)
    if t == "torch":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset,
                                     kv_valid_len=kv_valid_len)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{q.dtype}: the CUDA kernels take float32, "
                        "bfloat16 and float16")
    d = q.shape[3]
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the CUDA kernels take a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte rows; the "
                             "tensor's storage is not 16-byte aligned")
    b, s, h, d = q.shape
    tk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if not (q.numel() and tk):
        return out
    valid = -1 if kv_valid_len is None else kv_valid_len
    var = variant(q.dtype, s, h // kh, d)
    if var == "tc":
        _build.launch("flash_attention_fwd", "rt_flash_attention_tc",
                      q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, s, tk, h, kh, d, int(causal),
                      q_offset, valid, variant=var)
        return out
    kv_len = tk if kv_valid_len is None else min(kv_valid_len, tk)
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    if var == "dec":
        if causal:              # no key past the last row's horizon
            kv_len = min(kv_len, q_offset + s)
        splits, chunk = dec_splits(b, kh, kv_len, n_sms)
        entry, split_args = "rt_flash_attention_dec", (splits, chunk)
    else:
        splits = kv_splits(b, s, h, kh, kv_len, n_sms)
        entry, split_args = "rt_flash_attention_fwd", (splits,)
    scratch = None
    if splits > 1:          # per split: acc (D), row max and row sum per row
        scratch = torch.empty(b * kh * splits * s * (h // kh) * (d + 2),
                              dtype=torch.float32, device=q.device)
    _build.launch("flash_attention_fwd", entry, q.device, q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, tk, h,
                  kh, d, int(causal), q_offset, valid,
                  _DTYPE_CODES[q.dtype], *split_args,
                  None if scratch is None else scratch.data_ptr(),
                  variant=var)
    return out
