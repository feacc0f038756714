"""Roofline terms for one NVIDIA H100, and the cost of every hand-written
kernel route.

Counterpart of ``repro/launch/roofline.py``, which models a TPU v5e. Here
the rates are the H100 SXM data sheet's (dense, no sparsity), each a
named constant, and an operation count is kept by the pipe that runs it:

    t_compute    = sum over pipes of device_ops[pipe] / rate[pipe]
    t_memory     = device_bytes / 3.35 TB/s
    t_collective = 0 (one card: nothing crosses a link)

:func:`model_flops` is the reference's formula unchanged (6·N·D to train,
2·N·D otherwise, N = ``cfg.n_active_params()``), and
:attr:`Roofline.roofline_fraction` divides by the bf16 peak, as the
reference divides by its bf16 peak.

The kernel costs: one function per hand-written kernel route, from the
call's shapes to a :class:`KernelCost` (the bytes the function must move,
each input read once and each output written once, and its operations by
pipe, a multiply-add counted as two). A cost is the same count whatever
implements the call, the kernel or its plain version.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch

from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
BF16_TC_OPS_PER_S = 989e12       # dense bf16/f16 tensor-core rate
TF32_TC_OPS_PER_S = 495e12       # dense TF32 tensor-core rate
FP32_OPS_PER_S = 67e12           # float32 outside the tensor cores
FP64_TC_OPS_PER_S = 67e12        # float64 tensor-core rate
PEAK_FLOPS = BF16_TC_OPS_PER_S
H100_MEMORY_BYTES = 80e9         # the data sheet's 80 GB of HBM
# pipe -> operations a second; "popc" has no fixed rate (its callers
# measure the card's clock)
RATES = {"bf16": BF16_TC_OPS_PER_S, "tf32": TF32_TC_OPS_PER_S,
         "fp32": FP32_OPS_PER_S, "fp64": FP64_TC_OPS_PER_S}
RATE_NAMES = {"bf16": "989 TFLOP/s bf16", "tf32": "495 TFLOP/s TF32",
              "fp32": "67 TFLOP/s float32", "fp64": "67 TFLOP/s float64"}


def product_pipe(dtype: torch.dtype, allow_tf32: Optional[bool] = None
                 ) -> str:
    """The pipe a matrix product of ``dtype`` runs on: the tensor cores
    for bf16 and f16, TF32 ones for float32 where
    ``torch.backends.cuda.matmul.allow_tf32`` allows it, float32 outside
    them otherwise, float64 tensor cores for float64."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float64:
        return "fp64"
    if allow_tf32 is None:
        allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    return "tf32" if allow_tf32 else "fp32"


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Bytes and operations by pipe of one call."""
    bytes: int
    ops: Mapping[str, int]

    @property
    def n_ops(self) -> int:
        return sum(self.ops.values())

    def bytes_seconds(self) -> float:
        return self.bytes / HBM_BYTES_PER_S

    def ops_seconds(self, rates: Optional[Mapping[str, float]] = None
                    ) -> float:
        """Each pipe's operations over its rate, the times added (one
        tensor core runs every pipe it has)."""
        rates = RATES if rates is None else rates
        return sum(n / rates[pipe] for pipe, n in self.ops.items())

    def bound_seconds(self, rates=None) -> float:
        return max(self.bytes_seconds(), self.ops_seconds(rates))

    def bound_by(self, rates=None) -> str:
        return ("bytes" if self.bytes_seconds() >= self.ops_seconds(rates)
                else "operations")

    def rate_note(self) -> str:
        return " plus ".join(f"{pipe} operations / {RATE_NAMES[pipe]}"
                             for pipe in self.ops)


def merged(*costs: KernelCost, n_bytes: Optional[int] = None) -> KernelCost:
    """The operations of ``costs`` added by pipe; their bytes added, or
    ``n_bytes``."""
    ops: Dict[str, int] = {}
    for c in costs:
        for pipe, n in c.ops.items():
            ops[pipe] = ops.get(pipe, 0) + n
    return KernelCost(sum(c.bytes for c in costs) if n_bytes is None
                      else n_bytes, ops)


# --------------------------------------------------------------------------- #
# kernel costs
# --------------------------------------------------------------------------- #

def jaccard_cost(q: int, k: int, w: int) -> KernelCost:
    """Bytes (each word read once, each output written once) and popcounts
    (popc(a & b) per pair and word, and each row's count once)."""
    return KernelCost(4 * (q + k) * w + 4 * q * k,
                      {"popc": q * k * w + (q + k) * w})


def flash_keys(s: int, t: int, causal: bool, q_offset: int = 0,
               kv_valid_len: Optional[int] = None) -> int:
    """Keys a flash call reads: none past ``kv_valid_len`` nor, causal,
    past the last query's horizon ``q_offset + s``."""
    keys = t if kv_valid_len is None else min(t, kv_valid_len)
    return min(keys, q_offset + s) if causal else keys


def flash_pairs(s: int, t: int, causal: bool, q_offset: int = 0,
                kv_valid_len: Optional[int] = None) -> int:
    """Valid (query, key) pairs of one (sequence, head): query ``i`` sees
    the keys below ``kv_valid_len`` and, causal, up to ``q_offset + i``."""
    keys = t if kv_valid_len is None else min(t, kv_valid_len)
    if not causal:
        return s * keys
    n1 = min(max(keys - q_offset, 0), s)      # rows short of every key
    return n1 * q_offset + n1 * (n1 + 1) // 2 + (s - n1) * keys


def flash_fwd_cost(b: int, s: int, t: int, h: int, kh: int, d: int,
                   dtype: torch.dtype, causal: bool = True,
                   q_offset: int = 0, kv_valid_len: Optional[int] = None
                   ) -> KernelCost:
    """Every route of the forward: q read and o written, the keys and
    values it reads once each; 4·D operations a valid pair (q·k and p·v),
    on the tensor cores for bf16 and f16, float32 ones otherwise."""
    el = dtype.itemsize
    keys = flash_keys(s, t, causal, q_offset, kv_valid_len)
    pairs = b * h * flash_pairs(s, t, causal, q_offset, kv_valid_len)
    return KernelCost(el * (2 * b * s * h * d + 2 * b * keys * kh * d),
                      {_flash_pipe(dtype): 4 * d * pairs})


def _flash_pipe(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "fp32"


# operations a valid (query, head, key) pair, each backward kernel (pre,
# dq, dkv): its part of the function (pre the scores; dq the scores,
# dO·Vᵀ and dS·K; dkv the scores, dO·Vᵀ, Pᵀ·dO and dSᵀ·Q), and each
# route's own count (the recomputed products, and on tc the second bf16
# term of P and dS); times D
FLASH_BWD_OPS = {"function": (2, 6, 8), "tc": (2, 8, 12),
                 "scalar": (2, 6, 8)}
FLASH_BWD_KERNELS = ("flash_attention_bwd_pre", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv")


def flash_bwd_cost(b: int, s: int, t: int, h: int, kh: int, d: int,
                   dtype: torch.dtype, causal: bool = True,
                   q_offset: int = 0, kv_valid_len: Optional[int] = None
                   ) -> KernelCost:
    """Every route of the backward, the function: q, o, dO, k and v read,
    dq, dk and dv written; 10·D operations a valid pair (the scores, dO·Vᵀ,
    dS·K, Pᵀ·dO, dSᵀ·Q)."""
    el = dtype.itemsize
    keys = flash_keys(s, t, causal, q_offset, kv_valid_len)
    pairs = b * h * flash_pairs(s, t, causal, q_offset, kv_valid_len)
    qo, kvb = b * s * h * d * el, b * keys * kh * d * el
    return KernelCost(4 * qo + 4 * kvb, {_flash_pipe(dtype): 10 * d * pairs})


def flash_bwd_kernel_costs(b: int, s: int, t: int, h: int, kh: int, d: int,
                           dtype: torch.dtype, causal: bool = True,
                           q_offset: int = 0,
                           kv_valid_len: Optional[int] = None
                           ) -> Dict[str, KernelCost]:
    """The backward by kernel: the bytes each kernel's own function reads
    and writes (pre: q, o, dO, k and the float32 row statistics; dq: q,
    dO, dq, k, v and the statistics; dkv: q, dO, k, v, dk, dv and the
    statistics) and its part of the function's operations."""
    el = dtype.itemsize
    keys = flash_keys(s, t, causal, q_offset, kv_valid_len)
    pairs = b * h * flash_pairs(s, t, causal, q_offset, kv_valid_len)
    qo, kvb = b * s * h * d * el, b * keys * kh * d * el
    row_stats = 3 * 4 * b * s * h
    n_bytes = (3 * qo + kvb + row_stats, 3 * qo + 2 * kvb + row_stats,
               2 * qo + 4 * kvb + row_stats)
    pipe = _flash_pipe(dtype)
    return {name: KernelCost(nb, {pipe: per * d * pairs})
            for name, nb, per in zip(FLASH_BWD_KERNELS, n_bytes,
                                     FLASH_BWD_OPS["function"])}


def wkv_rec_cost(b: int, s: int, h: int, hd: int) -> KernelCost:
    """The rec and dec routes, and the function: bytes (r, k, v, w read
    and y written once each, u, s0 read and the state written once) and
    the fewest operations the function needs: per (b, t, h), sum_i r_i
    S_ij (2 hd^2) and the state update w_i S_ij + k_i v_j (3 hd^2), plus
    the bonus v_j sum_i r_i u_i k_i (5 hd), so 5 hd^2 + 5 hd, float32."""
    return KernelCost(4 * (5 * b * s * h * hd + h * hd + 2 * b * h * hd * hd),
                      {"fp32": b * s * h * (5 * hd * hd + 5 * hd)})


def wkv_tc_cost(b: int, s: int, h: int, hd: int, chunk: int = 64,
                sub: int = 16) -> KernelCost:
    """The tc route: the function's bytes; its matrix products as three
    TF32 products each, per (b, h) and chunk of L steps: (r o P_ex) S and
    (k o Q)^T V (2 L hd^2 each), A V over the pairs j <= t (hd L (L + 1)),
    A's blocks across sub-chunks (2 hd per pair); and, in float32, the
    running products of A's diagonal 16 x 16 blocks (2 hd per pair j < t
    of a sub-chunk, 3 hd per bonus)."""
    tensor = scalar = 0
    for t0 in range(0, s, chunk):
        ln = min(chunk, s - t0)
        subs = [min(sub, ln - o) for o in range(0, ln, sub)]
        inside = sum(m * (m - 1) // 2 for m in subs)
        across = ln * (ln - 1) // 2 - inside
        tensor += b * h * (4 * ln * hd * hd + hd * ln * (ln + 1)
                           + 2 * hd * across)
        scalar += b * h * (2 * hd * inside + 3 * hd * ln)
    return KernelCost(wkv_rec_cost(b, s, h, hd).bytes,
                      {"tf32": 3 * tensor, "fp32": scalar})


def ssd_rec_cost(b: int, s: int, h: int, hd: int, n: int) -> KernelCost:
    """The rec route, and the function: bytes (x, b, c, dt, a, d and s0
    read, y and the state written, once each) and the recurrence's
    operations: per (b, t, h) the state update e^{dt a} S + b (dt x) (3 N
    hd, and hd for dt x) and y = c·S + d x (2 N hd + 2 hd), so 5 N hd + 3
    hd, float32."""
    return KernelCost(4 * (2 * b * s * h * hd + 2 * b * s * n + b * s * h
                           + 2 * h + 2 * b * h * n * hd),
                      {"fp32": b * s * h * (5 * n * hd + 3 * hd)})


def ssd_tc_cost(b: int, s: int, h: int, hd: int, n: int,
                chunk: int = 64) -> KernelCost:
    """The tc route: the function's bytes; tensor-core operations of the
    chunked form, three TF32 products per product: per (b, h) and chunk of
    L steps, M X over the pairs j <= t (hd L (L + 1)), C S and Bᵀ (w ∘ X)
    (2 L N hd each); G = C Bᵀ on and under the diagonal (N L (L + 1)) once
    per (b, chunk), the same for every head."""
    total = 0
    for t0 in range(0, s, chunk):
        ln = min(chunk, s - t0)
        total += b * (h * (hd * ln * (ln + 1) + 4 * ln * n * hd)
                      + n * ln * (ln + 1))
    return KernelCost(ssd_rec_cost(b, s, h, hd, n).bytes, {"tf32": 3 * total})


def wkv_bwd_rec_cost(b: int, s: int, h: int, hd: int) -> KernelCost:
    """The rec route of the WKV backward, and the function: bytes (r, k,
    v, w, dy read and dr, dk, dv, dw written, u, s0, ds read and du, ds0
    written, once each) and the fewest operations the function needs: per
    state element and step, the state once (w S + k v) and the reverse's
    five multiply-adds (G, dr, dk, dv, dw), 12 in all, float32."""
    return KernelCost(4 * (9 * b * s * h * hd + 2 * h * hd
                           + 3 * b * h * hd * hd),
                      {"fp32": 12 * b * s * h * hd * hd})


def wkv_bwd_rec_kernel_costs(b: int, s: int, h: int, hd: int
                             ) -> Dict[str, KernelCost]:
    """The rec route by kernel: the reverse sweep (the function) and the
    sum of du's parts over b (an add a part)."""
    return {"rwkv6_wkv_bwd": wkv_bwd_rec_cost(b, s, h, hd),
            "rwkv6_wkv_bwd_sum": KernelCost(4 * (b * h * hd + h * hd),
                                            {"fp32": b * h * hd})}


def wkv_bwd_tc_kernel_costs(b: int, s: int, h: int, hd: int, sub: int = 16
                            ) -> Dict[str, KernelCost]:
    """The tc route of the WKV backward by kernel: bytes (each tensor a
    kernel reads or writes, once) and operations, TF32 tensor-core
    products as three TF32 products, scalar float32 work apart. Per (b, h)
    and chunk of L steps in m sub-chunks: (a) (k ∘ P⁺)ᵀ V and (r ∘ P⁻)ᵀ dY
    (L hd^2 each); (c) dY S_inᵀ, V G_outᵀ and (k ∘ P⁺) G_out (L hd^2
    each), D's and Aᵀ dY's blocks on and under the diagonal (256 hd a
    block each), the products across sub-chunks (Y's, X's and A's, 256 hd
    a pair of sub-chunks each), and in float32 the running products of
    each sub-chunk of n steps and row: dw's pairs, dr's and dk's inner
    sums (9 operations a pair), A's diagonal blocks (4 a pair), and a
    step's own terms (about 24). The passes: a multiply-add an element and
    chunk of each of the two scratches; the sum: an add a part."""
    chunk = wkv_ops.BWD_TC_CHUNK[hd]
    chunks = -(-s // chunk)
    states = grad32 = scalar = 0
    for t0 in range(0, s, chunk):
        ln = min(chunk, s - t0)
        subs = [min(sub, ln - o) for o in range(0, ln, sub)]
        m = len(subs)
        pairs = m * (m - 1) // 2
        states += b * h * 2 * ln * hd * hd
        grad32 += b * h * (3 * ln * hd * hd + 256 * hd * (m * (m + 1)
                                                          + 3 * pairs))
        scalar += b * h * hd * sum(13 * n * (n - 1) // 2 + 24 * n
                                   for n in subs)
    xs, sts = b * s * h * hd, b * h * chunks * hd * hd
    parts = b * chunks * h * hd
    return {
        "rwkv6_wkv_bwd_states": KernelCost(
            4 * (5 * xs + 2 * sts + b * h * chunks * hd),
            {"tf32": 6 * states}),
        "rwkv6_wkv_bwd_pass": KernelCost(
            4 * (4 * sts + b * h * chunks * hd + 3 * b * h * hd * hd),
            {"fp32": 4 * sts}),
        "rwkv6_wkv_bwd": KernelCost(
            4 * (9 * xs + 2 * sts + h * hd + parts),
            {"tf32": 6 * grad32, "fp32": scalar}),
        "rwkv6_wkv_bwd_sum": KernelCost(4 * (parts + h * hd),
                                        {"fp32": parts}),
    }


def wkv_bwd_tc_cost(b: int, s: int, h: int, hd: int) -> KernelCost:
    """The tc route as one call: the function's bytes, its four kernels'
    operations."""
    return merged(*wkv_bwd_tc_kernel_costs(b, s, h, hd).values(),
                  n_bytes=wkv_bwd_rec_cost(b, s, h, hd).bytes)


def ssd_bwd_rec_cost(b: int, s: int, h: int, hd: int, n: int) -> KernelCost:
    """The rec route of the SSD backward, and the function: bytes (x, dy,
    b, c, dt read and dx, db, dc, ddt written, a, d, s0, ds read and da,
    dd, ds0 written) and the fewest operations: per state element and step
    the state once (2), G += c dy, dc, db's sum, sum_n G b and <S, G> (a
    multiply-add each) and G *= alpha (1), 13 in all, float32."""
    return KernelCost(4 * (3 * b * s * h * hd + 4 * b * s * n + 2 * b * s * h
                           + 4 * h + 3 * b * h * n * hd),
                      {"fp32": 13 * b * s * h * n * hd})


def ssd_bwd_rec_kernel_costs(b: int, s: int, h: int, hd: int, n: int
                             ) -> Dict[str, KernelCost]:
    """The rec route by kernel: the reverse sweep (the function) and the
    sums of db's, dc's, da's and dd's parts over heads and the batch."""
    return {"mamba2_ssd_bwd": ssd_bwd_rec_cost(b, s, h, hd, n),
            "mamba2_ssd_bwd_sum": KernelCost(
                4 * (2 * b * s * h * n + 2 * b * s * n + 2 * b * h + 2 * h),
                {"fp32": 2 * b * s * h * n})}


def ssd_bwd_tc_kernel_costs(b: int, s: int, h: int, hd: int, n: int,
                            chunk: int = 64, heads: int = 16
                            ) -> Dict[str, KernelCost]:
    """The tc route of the SSD backward by kernel: bytes (each tensor a
    kernel reads or writes, once) and operations: float64 tensor-core
    products, TF32 ones as three TF32 products (Z's two: V is exact). Per
    (b, h) and chunk of L steps: float64 Bᵀ (w ∘ X), Cᵀ (e^{cum} ∘ dY),
    dY S_inᵀ and X dS_outᵀ (L N hd each); TF32 dM = dY Xᵀ and Mᵀ dY (hd L
    (L + 1) / 2 each), B dS_out (L N hd), dG B and dGᵀ C (N L (L + 1) / 2
    each), Z over the rectangles (L (L + 1) (L + 2) / 6); G = C Bᵀ once
    per (b, chunk, group of heads) (N L (L + 1) / 2). The passes: a
    multiply-add an element and chunk, the sums an add an element and
    group, float32."""
    chunks, groups = -(-s // chunk), -(-h // heads)
    states = grad64 = grad32 = z = 0
    for t0 in range(0, s, chunk):
        ln = min(chunk, s - t0)
        tri = ln * (ln + 1) // 2
        states += b * h * 2 * ln * n * hd
        grad64 += b * h * 2 * ln * n * hd
        grad32 += b * (h * (2 * hd * tri + ln * n * hd + 2 * n * tri)
                       + groups * n * tri)
        z += b * h * ln * (ln + 1) * (ln + 2) // 6
    xs, bs, sts = b * s * h * hd, b * s * n, b * h * chunks * n * hd
    return {
        "mamba2_ssd_bwd_states": KernelCost(
            4 * (2 * xs + 2 * bs + b * s * h + 2 * sts + b * h * chunks),
            {"fp64": 2 * states}),
        "mamba2_ssd_bwd_pass": KernelCost(
            4 * (4 * sts + 2 * b * h * chunks + 3 * b * h * n * hd),
            {"fp32": 4 * sts}),
        "mamba2_ssd_bwd": KernelCost(
            4 * (3 * xs + 2 * bs + 2 * b * s * h + 2 * h + 2 * sts
                 + 2 * groups * bs + 2 * b * chunks * h),
            {"fp64": 2 * grad64, "tf32": 6 * grad32 + 4 * z}),
        "mamba2_ssd_bwd_sum": KernelCost(
            4 * (2 * groups * bs + 2 * bs + 2 * b * chunks * h + 2 * h),
            {"fp32": 2 * groups * bs + 2 * b * chunks * h}),
    }


# the tc route's kernels whose operations bound it as one call: the
# tensor-core ones (the passes and sums add well under 1%)
SSD_BWD_TC_BOUND_KERNELS = ("mamba2_ssd_bwd_states", "mamba2_ssd_bwd")


def ssd_bwd_tc_cost(b: int, s: int, h: int, hd: int, n: int) -> KernelCost:
    """The tc route as one call: the function's bytes, the operations of
    its tensor-core kernels (:data:`SSD_BWD_TC_BOUND_KERNELS`)."""
    per = ssd_bwd_tc_kernel_costs(b, s, h, hd, n)
    return merged(*(per[k] for k in SSD_BWD_TC_BOUND_KERNELS),
                  n_bytes=ssd_bwd_rec_cost(b, s, h, hd, n).bytes)


# --------------------------------------------------------------------------- #
# the step's roofline
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class Roofline:
    t_compute: float
    t_memory: float
    t_collective: float
    device_flops: float
    device_bytes: float
    device_coll_bytes: float
    model_flops_total: float      # 6*N*D (train) / 2*N*D (inference)
    hlo_flops_total: float        # device_flops * n_chips
    n_chips: int
    t_eager: float = 0.0          # the sum of every op's own bound

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / device FLOPs: how much counted compute is
        useful."""
        if self.hlo_flops_total <= 0:
            return 0.0
        return self.model_flops_total / self.hlo_flops_total

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved if the step runs at
        the bound: (useful flop time at the bf16 peak) / (bound time)."""
        ideal = self.model_flops_total / (self.n_chips * PEAK_FLOPS)
        if self.bound_time <= 0:
            return 0.0
        return ideal / self.bound_time

    def to_dict(self) -> Dict:
        return dict(
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, dominant=self.dominant,
            device_flops=self.device_flops, device_bytes=self.device_bytes,
            device_coll_bytes=self.device_coll_bytes,
            model_flops_total=self.model_flops_total,
            hlo_flops_total=self.hlo_flops_total,
            useful_flops_ratio=self.useful_flops_ratio,
            roofline_fraction=self.roofline_fraction,
            n_chips=self.n_chips, t_eager=self.t_eager)


def model_flops(cfg, shape_name: str, n_tokens: int, kind: str) -> float:
    """6*N*D for training, 2*N*D for inference (N = active params)."""
    n = cfg.n_active_params()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * n_tokens


def build(cost: Dict, coll: Dict, n_chips: int,
          model_flops_total: float) -> Roofline:
    """``cost``: ``flops`` and ``bytes accessed``, and where given ``flops
    by pipe`` (t_compute over each pipe's rate; else every flop at the
    bf16 peak) and ``eager seconds`` (the sum of per-op bounds). One card
    moves nothing over a link: t_collective is 0."""
    dev_flops = float(cost.get("flops", 0.0))
    dev_bytes = float(cost.get("bytes accessed", 0.0))
    dev_coll = float(coll.get("total_bytes", 0))
    by_pipe = cost.get("flops by pipe")
    t_compute = (KernelCost(0, by_pipe).ops_seconds() if by_pipe is not None
                 else dev_flops / PEAK_FLOPS)
    return Roofline(
        t_compute=t_compute, t_memory=dev_bytes / HBM_BYTES_PER_S,
        t_collective=0.0,
        device_flops=dev_flops, device_bytes=dev_bytes,
        device_coll_bytes=dev_coll,
        model_flops_total=model_flops_total,
        hlo_flops_total=dev_flops * n_chips, n_chips=n_chips,
        t_eager=float(cost.get("eager seconds", 0.0)))
