"""Kernel dispatch policy for ``repro_torch.kernels``.

Counterpart of ``repro/kernels/dispatch.py``. There the question was three
ways (compiled Pallas kernel, ``interpret=True`` kernel, or jnp oracle) and
was answered by a size floor plus per-op scaling envelopes. Here the
tensor's device answers it alone:

* a CUDA tensor goes through the hand-written Hopper kernel, always — a
  launch that fails raises, nothing falls back;
* a CPU tensor goes through the op's plain PyTorch version, which repeats
  the kernel's arithmetic (tests, and callers that ask for the CPU);
* a meta tensor (``torch.device("meta")``, asked for by the dry run alone,
  ``launch/dryrun.py``; no entry point defaults to it) takes the ops an
  LM step reaches (flash attention, WKV and SSD, forward and backward)
  down their CUDA path with nothing launched: each returns empty outputs
  of its contract's shapes and dtypes and allocates the scratch its route
  allocates. Meta computes no value, so it is no fallback: it reckons
  shapes, bytes and operations. The other ops refuse a meta tensor.

The reference's envelopes are gone because the TPU limits they encoded do
not exist on Hopper: the size floor (``dispatch.py:120``) and the probe and
expand work caps existed because the TPU probe and expand are O(n*m)
broadcast compares — the CUDA kernels search in O(n log m); the gather
VMEM-residency cap existed because the TPU gather kept the whole table in
one VMEM panel — the CUDA gather reads device memory; the int32 envelope existed because the TPU has no int64 — the CUDA
kernels carry int64 keys and indices natively.

:func:`note_tier` keeps the reference's counter names,
``kernels.dispatch.<op>.<tier>[.<reason>]``, with tiers ``cuda``,
``torch`` and ``meta``. :func:`kernel_op` marks each LM kernel op, so that
an accounting the dry run installs (:func:`set_units`) counts the op as
one unit, on every tier, and not the torch ops inside it.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch


def on_cuda() -> bool:
    """Is a CUDA device present?"""
    return torch.cuda.is_available()


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present (the port never moves to the CPU on its own).
    ``meta`` is taken only where a caller names it (the dry run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}: expected cuda, "
                         "cpu or meta")
    return dev


def tier(t: torch.Tensor, *, meta: bool = False) -> str:
    """The path a tensor takes: ``"cuda"`` (the kernel), ``"torch"`` (the
    plain version, CPU tensors only) or, for an op that has one
    (``meta=True``), ``"meta"`` (the CUDA path with nothing launched)."""
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "torch"
    if t.device.type == "meta" and meta:
        return "meta"
    raise ValueError(f"unsupported device {t.device}: expected cuda or cpu"
                     + (" or meta" if meta else ""))


H100_SMS = 132                   # SMs of the H100 SXM part


def n_sms(device: torch.device) -> int:
    """The card's SM count; on the meta tier, the H100 SXM's."""
    if device.type == "meta":
        return H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


# the accounting the dry run installs: ``units(op, route, args, kwargs)``
# -> a context manager around one kernel op; None when nothing counts
_units: Optional[Callable] = None


def set_units(units: Optional[Callable]) -> Optional[Callable]:
    """Install ``units`` (None: none); returns the one it replaces."""
    global _units
    old, _units = _units, units
    return old


def kernel_op(op: str, route_of: Callable) -> Callable:
    """Decorate the function that runs kernel op ``op`` on every tier:
    under an installed accounting it runs inside ``units(op, route, args,
    kwargs)``, ``route = route_of(*args, **kwargs)`` the route the card
    takes at those shapes; otherwise it runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if _units is None:
                return fn(*args, **kwargs)
            with _units(op, route_of(*args, **kwargs), args, kwargs):
                return fn(*args, **kwargs)
        return run
    return wrap


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

