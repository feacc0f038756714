"""AdamW with cosine schedule and global-norm clipping.

Counterpart of ``repro/optim/adamw.py``, in the reference's own formulas
rather than ``torch.optim.AdamW`` (which orders the weight decay and the
bias correction otherwise): the schedule at ``step`` counted from 1, the
global norm over the floating gradients, ``scale = min(1, clip /
max(gnorm, 1e-9))``, and per leaf, in float32,

    mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g²,   g = grad · scale
    p  = p - lr (mu / (1 - b1^step) / (sqrt(nu / (1 - b2^step)) + eps)
                 + wd p)

with ``b1^step`` and ``b2^step`` taken in float32. Parameters, gradients
and moments are dictionaries of tensors keyed alike (the port keys them by
the model's parameter names). Only floating leaves are trained; an integer
leaf (the MoE slot map ``inv_perm``) is a buffer of the model and never
reaches the optimizer. The update is made IN PLACE: the parameter tensors
and the state's ``mu``, ``nu`` and ``step`` are overwritten and returned
(the reference returns new arrays). Every value stays on the parameters'
device; nothing is read back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32: linear warm-up to
    ``peak_lr``, then a cosine down to ``min_lr_ratio * peak_lr``."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32) * frac))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict:
    """Zero float32 moments for every floating leaf, and step 0 (int32),
    on the parameters' device."""
    mu = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for k, p in params.items() if p.dtype.is_floating_point}
    dev = next(iter(params.values())).device if params else None
    return {"mu": mu, "nu": {k: torch.zeros_like(z) for k, z in mu.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def sum_in_order(values):
    """The sum of ``values``, added one by one in their order: the same
    bits wherever the same values come in the same order."""
    total = values[0]
    for v in values[1:]:
        total = total + v
    return total


def sum_of_squares(tree: Mapping[str, Optional[torch.Tensor]]
                   ) -> Optional[torch.Tensor]:
    """The sum of squares of every floating leaf, float32, in the tree's
    order (None for a tree without one)."""
    sq = [torch.sum(torch.square(g.to(torch.float32)))
          for g in tree.values()
          if g is not None and g.dtype.is_floating_point]
    return sum_in_order(sq) if sq else None


def global_norm(tree: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every floating leaf, float32 (0 for
    a tree without one)."""
    total = sum_of_squares(tree)
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Tree, grads: Mapping[str, Optional[torch.Tensor]],
                 state: Dict, cfg: AdamWConfig,
                 grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Tree, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, IN PLACE on ``params`` and ``state``; returns them
    with the metrics ``lr`` and ``grad_norm`` (float32 tensors). A leaf
    whose gradient is None (no path from the loss) is updated as with a
    zero gradient, as the reference's dense gradient tree has it. The
    clip scale is that of ``grad_norm``, the global norm of a gradient
    tree split across ranks where the caller gives it (every rank then
    scales alike), else :func:`global_norm` of ``grads``."""
    state["step"] += 1
    step = state["step"]
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    for key, mu in state["mu"].items():
        p, nu, g = params[key], state["nu"][key], grads.get(key)
        if g is None:
            g = torch.zeros_like(mu)
        g = g.to(torch.float32) * scale
        mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        nu.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
        delta = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (delta + cfg.weight_decay * pf))
    return params, state, {"lr": lr, "grad_norm": gnorm}
