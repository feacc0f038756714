"""Fault tolerance and straggler mitigation for long-running training.

Counterpart of ``repro/runtime/resilience.py`` on the port's checkpoint
manager. A device error surfaces as an exception from the step function;
the recovery policy is the standard one:

  checkpoint every K steps (async)  ->  on failure: restore the latest
  checkpoint onto the device        ->  resume from the restored step.

The port's step updates the model and optimizer state in place, so a step
that fails partway leaves a mix of updated and old leaves: with no
checkpoint to restore, the failure is raised (the reference, whose state is
immutable, would go on from the last good state).

``TrainSupervisor.run`` drives that loop; failures are injectable for tests.
``StragglerMonitor`` keeps an EWMA of step times and flags outliers. On one
card there is no mesh to rebuild over surviving hosts: the restore puts
each leaf back on ``device``.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional


from repro_torch.checkpoint import manager as ckpt


@dataclasses.dataclass
class StragglerConfig:
    ewma_alpha: float = 0.1
    flag_factor: float = 2.5
    warmup_steps: int = 3


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig | None = None):
        self.cfg = cfg or StragglerConfig()
        self.ewma: Optional[float] = None
        self.n = 0
        self.flagged: List[Dict] = []

    def record(self, step: int, seconds: float,
               host_times: Optional[Dict[int, float]] = None) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        is_straggler = False
        if self.ewma is not None and self.n > self.cfg.warmup_steps:
            if seconds > self.cfg.flag_factor * self.ewma:
                is_straggler = True
                slowest = None
                if host_times:
                    slowest = max(host_times, key=host_times.get)
                self.flagged.append(dict(step=step, seconds=seconds,
                                         ewma=self.ewma, host=slowest))
        a = self.cfg.ewma_alpha
        self.ewma = seconds if self.ewma is None else \
            (1 - a) * self.ewma + a * seconds
        return is_straggler


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 20
    keep_last: int = 3
    max_failures: int = 5


class TrainSupervisor:
    """Checkpoint/restart loop around a step function.

    step_fn(state, step) -> state           (may raise on injected failure)
    save_tree(state) / load_tree(tree, state) adapt state <-> checkpointable
    tree (params + opt state), restored onto ``device`` (each leaf's own
    device when None).
    """

    def __init__(self, cfg: SupervisorConfig, step_fn: Callable,
                 state_to_tree: Callable, tree_to_state: Callable,
                 device=None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state_to_tree = state_to_tree
        self.tree_to_state = tree_to_state
        self.device = device
        self.checkpointer = ckpt.AsyncCheckpointer(cfg.ckpt_dir,
                                                   cfg.keep_last)
        self.monitor = StragglerMonitor()
        self.failures = 0
        self.restores = 0

    def _restore(self, state, failed_step: int, exc: Exception):
        step = ckpt.latest_step(self.cfg.ckpt_dir)
        if step is None:
            raise RuntimeError(
                f"step {failed_step} failed before the first checkpoint: the "
                f"step updates the state in place, so no valid state is "
                f"left to resume from") from exc
        tree = self.state_to_tree(state)
        restored = ckpt.restore(self.cfg.ckpt_dir, step, tree,
                                device=self.device)
        self.restores += 1
        return step + 1, self.tree_to_state(restored, state)

    def run(self, state, n_steps: int, *, start_step: int = 0,
            on_metrics: Optional[Callable] = None):
        step = start_step
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                state = self.step_fn(state, step)
                dt = time.perf_counter() - t0
                self.monitor.record(step, dt)
                if on_metrics:
                    on_metrics(step, state, dt)
                if (step + 1) % self.cfg.ckpt_every == 0:
                    self.checkpointer.save(step, self.state_to_tree(state))
                step += 1
            except Exception as exc:  # noqa: BLE001 — any step failure
                self.failures += 1
                if self.failures > self.cfg.max_failures:
                    raise
                self.checkpointer.wait()
                step, state = self._restore(state, step, exc)
        self.checkpointer.wait()
        return state
