"""Grouped-query flash attention, forward and backward.

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

The backward. :func:`flash_attention` goes through ``_FlashAttention``, a
``torch.autograd.Function``, when grad is enabled and q, k or v requires
it; otherwise it runs the forward alone, as serving does. The Function's
forward is the one above and saves q, k, v and o, as the reference's
``_fwd`` does; its backward, :func:`flash_attention_bwd`, launches the
three kernels of ``repro_torch/csrc/flash_attention_bwd.cu`` on a CUDA
tensor (row statistics, dQ, dK and dV) and runs
:func:`flash_attention_bwd_plain`, the reference's ``_bwd`` in torch ops,
on a CPU tensor. Both recompute the softmax in float32 from q and k:
``P = exp(s - m) / max(l, 1e-30)``, ``D = rowsum(dO∘O)``, ``dS = P∘(dO·Vᵀ -
D)``, ``dQ = dS·K·scale``, ``dK = dSᵀ·Q·scale`` and ``dV = Pᵀ·dO``, dK and
dV summed over the GQA group, every output in the inputs' dtype. The three
kernels come in two designs, chosen by :func:`bwd_variant` from the call's
dtype and shape alone: ``"tc"`` (bfloat16 on the tensor cores, the
forward's tc rule; Q, K, V, O and dO exact, P and dS carried as two
bfloat16 terms in the products that take them, every sum in float32) and
``"scalar"`` (the rest: every element upcast to float32, P and dS never
rounded).
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


def _check_cuda(*named) -> None:
    """The limits every CUDA kernel of this op shares: float32, bfloat16 or
    float16, D a multiple of 8 up to ``MAX_HEAD_DIM``, 16-byte aligned
    storage."""
    q = named[0][1]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{q.dtype}: the CUDA kernels take float32, "
                        "bfloat16 and float16")
    d = q.shape[3]
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the CUDA kernels take a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}")
    for name, x in named:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte rows; the "
                             "tensor's storage is not 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, T, K, D) -> (B, S, H, D) in q's dtype.
    Replaces ``flash_attention_fwd``; differentiable (through
    ``_FlashAttention``) when grad is enabled and q, k or v requires it."""
    q_offset = int(q_offset)
    kv_valid_len = None if kv_valid_len is None else int(kv_valid_len)
    _check(q, k, v, q_offset, kv_valid_len)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_offset,
                                     kv_valid_len)
    return _forward(q, k, v, causal, q_offset, kv_valid_len)


class _FlashAttention(torch.autograd.Function):
    """The forward saves q, k, v and o; the backward is
    :func:`flash_attention_bwd` (the reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_valid_len):
        o = _forward(q, k, v, causal, q_offset, kv_valid_len)
        ctx.save_for_backward(q, k, v, o)
        ctx.args = (causal, q_offset, kv_valid_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        causal, q_offset, kv_valid_len = ctx.args
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, do.contiguous(), causal=causal, q_offset=q_offset,
            kv_valid_len=kv_valid_len)
        return dq, dk, dv, None, None, None


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, q_offset: int,
             kv_valid_len: Optional[int]) -> torch.Tensor:
    """The forward of a checked call: a kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    t = dispatch.tier(q)
    dispatch.note_tier("flash_attention.fwd", t)
    if t == "torch":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset,
                                     kv_valid_len=kv_valid_len)
    _check_cuda(("q", q), ("k", k), ("v", v))
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


# --------------------------------------------------------------------------- #
# backward
# --------------------------------------------------------------------------- #

BWD_CHUNK = 128          # queries a chunk of the plain backward


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *, causal: bool = True,
                              q_offset: int = 0,
                              kv_valid_len: Optional[int] = None):
    """The reference's ``_bwd`` in torch ops: chunks of ``BWD_CHUNK``
    queries, each recomputing its masked float32 scores (-1e30 where
    masked), ``p = exp(s - max) / max(sum, 1e-30)``, ``D = rowsum(dO∘O)``,
    ``dS = p∘(dO·Vᵀ - D)``; dq in q's dtype, dk and dv summed over the GQA
    group in k's and v's. Materialises (B, K, g, 128, T) scores a chunk."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    kf = k.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]  # (B,K,1,T,D)
    vf = v.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    dk = torch.zeros((b, kh, t, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    kpos = torch.arange(t, device=q.device)

    def rows(x, lo, hi):                               # -> (B, K, g, c, D)
        return x[:, lo:hi].to(torch.float32).reshape(
            b, hi - lo, kh, g, d).permute(0, 2, 3, 1, 4)

    for lo in range(0, s, BWD_CHUNK):
        hi = min(lo + BWD_CHUNK, s)
        qc, doc, oc = rows(q, lo, hi), rows(do, lo, hi), rows(o, lo, hi)
        drow = (doc * oc).sum(-1, keepdim=True)        # (B, K, g, c, 1)
        scores = torch.matmul(qc, kf.transpose(-1, -2)) * scale
        ok = torch.ones((hi - lo, t), dtype=torch.bool, device=q.device)
        if causal:
            qpos = torch.arange(lo, hi, device=q.device)[:, None] + q_offset
            ok = qpos >= kpos[None, :]
        if kv_valid_len is not None:
            ok = ok & (kpos < kv_valid_len)[None, :]
        scores = torch.where(ok, scores, torch.full((), NEG_INF,
                                                    device=q.device))
        p = torch.exp(scores - scores.amax(-1, keepdim=True))
        p = p / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
        dp = torch.matmul(doc, vf.transpose(-1, -2))
        ds = p * (dp - drow)
        dq[:, lo:hi] = (torch.matmul(ds, kf) * scale).permute(
            0, 3, 1, 2, 4).reshape(b, hi - lo, h, d)
        dk += torch.matmul(ds.transpose(-1, -2), qc).sum(2) * scale
        dv += torch.matmul(p.transpose(-1, -2), doc).sum(2)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_bwd_stats_plain(q: torch.Tensor, k: torch.Tensor,
                                    o: torch.Tensor, do: torch.Tensor, *,
                                    causal: bool = True, q_offset: int = 0,
                                    kv_valid_len: Optional[int] = None):
    """What ``flash_bwd_pre_kernel`` writes, in torch ops: (m, l, D), each
    float32 (B, K, S, g) (row ``(i, head)`` at ``[b, head // g, i, head %
    g]``), the row max and the row sum of ``exp(s - m)`` of the masked
    float32 scores, and ``rowsum(dO∘O)``; in chunks of ``BWD_CHUNK``
    queries."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    kf = k.to(torch.float32).permute(0, 2, 1, 3)[:, :, None]
    kpos = torch.arange(t, device=q.device)
    m = torch.empty((b, kh, g, s), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    for lo in range(0, s, BWD_CHUNK):
        hi = min(lo + BWD_CHUNK, s)
        qc = q[:, lo:hi].to(torch.float32).reshape(
            b, hi - lo, kh, g, d).permute(0, 2, 3, 1, 4)
        scores = torch.matmul(qc, kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
        ok = torch.ones((hi - lo, t), dtype=torch.bool, device=q.device)
        if causal:
            qpos = torch.arange(lo, hi, device=q.device)[:, None] + q_offset
            ok = qpos >= kpos[None, :]
        if kv_valid_len is not None:
            ok = ok & (kpos < kv_valid_len)[None, :]
        scores = torch.where(ok, scores, torch.full((), NEG_INF,
                                                    device=q.device))
        m[..., lo:hi] = scores.amax(-1)
        l[..., lo:hi] = torch.exp(scores - m[..., lo:hi, None]).sum(-1)
    dsum = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)  # (B, S, H)
    return (m.permute(0, 1, 3, 2), l.permute(0, 1, 3, 2),
            dsum.reshape(b, s, kh, g).permute(0, 2, 1, 3))


BWD_KERNELS = ("flash_attention_bwd_pre", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
BWD_VARIANTS = ("tc", "scalar")
# the C entry point of each backward kernel on each route
_BWD_ENTRIES = {
    "scalar": ("rt_flash_attention_bwd_pre", "rt_flash_attention_bwd_dq",
               "rt_flash_attention_bwd_dkv"),
    "tc": ("rt_flash_attention_bwd_tc_pre", "rt_flash_attention_bwd_tc_dq",
           "rt_flash_attention_bwd_tc_dkv"),
}


def bwd_variant(dtype: torch.dtype, s: int, g: int, d: int) -> str:
    """Which design of the three backward kernels a CUDA call runs, from
    its dtype, query length ``s``, group size ``g = H / K`` and head width
    ``d``: ``"tc"`` (tensor cores) where the forward runs its tc kernel
    (:func:`variant`: bfloat16 with ``d % 16 == 0``, ``d <= 128`` and ``s
    * g >= 64``), else ``"scalar"``."""
    return "tc" if variant(dtype, s, g, d) == "tc" else "scalar"


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, q_offset: int = 0,
                        kv_valid_len: Optional[int] = None):
    """(dq, dk, dv) of :func:`flash_attention` at (q, k, v), from its
    output ``o`` and the output's gradient ``do`` (B, S, H, D), each in the
    inputs' dtype. Replaces the reference's ``_bwd``. On a CUDA tensor
    three kernels of the route :func:`bwd_variant` picks run in turn: pre
    (each row's max, sum and ``D`` into a float32 scratch), dq and dkv; on
    a CPU tensor, :func:`flash_attention_bwd_plain`."""
    q_offset = int(q_offset)
    kv_valid_len = None if kv_valid_len is None else int(kv_valid_len)
    _check(q, k, v, q_offset, kv_valid_len)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name}: expected q's shape, dtype and device "
                             f"{tuple(q.shape)}, {q.dtype}, {q.device}; got "
                             f"{tuple(x.shape)}, {x.dtype}, {x.device}")
    t = dispatch.tier(q)
    dispatch.note_tier("flash_attention.bwd", t)
    if t == "torch":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         q_offset=q_offset,
                                         kv_valid_len=kv_valid_len)
    for name, x in (("o", o), ("do", do)):
        if not x.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    _check_cuda(("q", q), ("k", k), ("v", v), ("o", o), ("do", do))
    b, s, h, d = q.shape
    tk, kh = k.shape[1], k.shape[2]
    if not (q.numel() and tk):
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    out = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
           torch.empty(3 * b * s * h, dtype=torch.float32, device=q.device))
    _bwd_kernels(BWD_KERNELS, (q, k, v, o, do), out, causal, q_offset,
                 kv_valid_len)
    return out[:3]


def _bwd_kernels(which, inputs, outputs, causal: bool, q_offset: int,
                 kv_valid_len: Optional[int],
                 route: Optional[str] = None) -> None:
    """Launch the backward kernels named in ``which`` (of
    :data:`BWD_KERNELS`, in that order), of ``route`` (default: the one
    :func:`bwd_variant` picks; another only to compare the two), on
    checked CUDA ``inputs`` (q, k, v, o, dO) into ``outputs`` (dq, dk, dv
    and the float32 scratch of 3 * B * S * H row statistics: m, l, D, each
    (B, K, S, g)); each launch counted under its kernel and
    ``<kernel>.<route>``."""
    q, k, v, o, do = inputs
    dq, dk, dv, stats = outputs
    b, s, h, d = q.shape
    tk, kh = k.shape[1], k.shape[2]
    var = route or bwd_variant(q.dtype, s, h // kh, d)
    tail = (b, s, tk, h, kh, d, int(causal), q_offset,
            -1 if kv_valid_len is None else kv_valid_len,
            _DTYPE_CODES[q.dtype])
    pre, dq_k, dkv = BWD_KERNELS
    e_pre, e_dq, e_dkv = _BWD_ENTRIES[var]
    if pre in which:
        _build.launch(pre, e_pre, q.device, q.data_ptr(), k.data_ptr(),
                      o.data_ptr(), do.data_ptr(), stats.data_ptr(), *tail,
                      variant=var)
    if dq_k in which:
        _build.launch(dq_k, e_dq, q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), do.data_ptr(), stats.data_ptr(),
                      dq.data_ptr(), *tail, variant=var)
    if dkv in which:
        _build.launch(dkv, e_dkv, q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), do.data_ptr(), stats.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), *tail, variant=var)
