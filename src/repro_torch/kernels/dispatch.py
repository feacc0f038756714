"""Kernel dispatch policy for ``repro_torch.kernels``.

Counterpart of ``repro/kernels/dispatch.py``. There the question was three
ways (compiled Pallas kernel, ``interpret=True`` kernel, or jnp oracle) and
was answered by a size floor plus per-op scaling envelopes. Here the
tensor's device answers it alone:

* a CUDA tensor goes through the hand-written Hopper kernel, always — a
  launch that fails raises, nothing falls back;
* a CPU tensor goes through the op's plain PyTorch version, which repeats
  the kernel's arithmetic (tests, and callers that ask for the CPU).

The reference's envelopes are gone because the TPU limits they encoded do
not exist on Hopper: the size floor (``dispatch.py:120``) and the probe and
expand work caps existed because the TPU probe and expand are O(n*m)
broadcast compares — the CUDA kernels search in O(n log m); the gather
VMEM-residency cap existed because the TPU gather kept the whole table in
one VMEM panel — the CUDA gather reads device memory; the int32 envelope existed because the TPU has no int64 — the CUDA
kernels carry int64 keys and indices natively.

:func:`note_tier` keeps the reference's counter names,
``kernels.dispatch.<op>.<tier>[.<reason>]``, with tiers ``cuda`` and
``torch``.
"""
from __future__ import annotations

import torch


def on_cuda() -> bool:
    """Is a CUDA device present?"""
    return torch.cuda.is_available()


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: expected cuda "
                         "or cpu")
    return dev


def tier(t: torch.Tensor) -> str:
    """The path a tensor takes: ``"cuda"`` (the kernel) or ``"torch"``
    (the plain version, CPU tensors only)."""
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "torch"
    raise ValueError(f"unsupported device {t.device}: expected cuda or cpu")


def note_tier(op: str, tier: str, reason: str = "") -> None:
    """Record one dispatch decision in the ambient ``repro_torch.obs``
    metrics registry (the owning ``KGService``'s): counter
    ``kernels.dispatch.<op>.<tier>`` and, when given, a companion
    ``...<tier>.<reason>``. No-op when no registry is installed; called once
    per op dispatch, never per row."""
    from repro_torch.obs import metrics as obs_metrics
    m = obs_metrics.ambient()
    if m is None:
        return
    m.counter(f"kernels.dispatch.{op}.{tier}").inc()
    if reason:
        m.counter(f"kernels.dispatch.{op}.{tier}.{reason}").inc()

