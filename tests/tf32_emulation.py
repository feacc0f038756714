"""Float32 products as the tc kernels take them on Hopper's TF32 tensor
cores, emulated in torch on the CPU: operands rounded to TF32 as
``cvt.rna.tf32.f32`` rounds them, the products of two TF32 values exact in
float32, the sums in float32. Shared by the tests that emulate the SSD tc
kernels' arithmetic (``test_torch_ssd.py``, ``test_torch_ssd_bwd_tc.py``)."""
import torch


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as cvt.rna.tf32.f32: add 0x1000 to the bits, clear the low 13."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b on the tensor cores' TF32: one term hi·hi, or three, hi·hi +
    hi·lo + lo·hi with hi = tf32(v), lo = tf32(v - hi). A product of two
    TF32 values is exact in float32; the sums are float32."""
    ahi, bhi = tf32(a), tf32(b)
    if terms == 1:
        return ahi @ bhi
    alo, blo = tf32(a - ahi), tf32(b - bhi)
    return alo @ bhi + ahi @ blo + ahi @ bhi
