"""End-to-end trainer.

Counterpart of ``repro/launch/train.py``. Wires together: config ->
random weights as a trainable model (float32 parameters and AdamW state)
-> data pipeline (prefetch) -> ``models.lm.train_step`` (flash attention's
hand-written forward and backward kernels under ``--use-flash``) ->
supervisor (async checkpoint / restore-on-failure / straggler monitor).
Runs on the card unless ``--device cpu`` is given (``cuda`` without a
card raises). ``build`` with ``data_parallel`` or ``model_parallel``
other than 1 trains on every rank of a mesh over the process group the
caller has initialised (``models.moe.ShardCtx``: MoE layers expert-parallel
over ``model``, the batch over ``data``); ``main`` trains on one rank, as
the reference's does.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --steps 50 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --use-flash --steps 8 --batch 4 --seq 4096 --ckpt-every 0
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import tempfile
import time
from typing import Any, Dict, Mapping, Optional

import torch

import repro_torch.configs as configs
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_stream
from repro_torch.kernels import dispatch
from repro_torch.launch.mesh import dp_axes, make_host_mesh
from repro_torch.models import lm
from repro_torch.models.moe import ShardCtx
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.resilience import SupervisorConfig, TrainSupervisor


@dataclasses.dataclass
class TrainState:
    model: Any
    opt_state: Any
    metrics: Dict[str, float]


def build(arch: str, *, reduced: bool, batch: int, seq: int, steps: int,
          seed: int = 0, data_parallel: int = 1, model_parallel: int = 1,
          use_flash: bool = False, device="cuda",
          overrides: Optional[Mapping[str, Any]] = None):
    """-> (cfg, model, opt_state, stream, step_fn): the config, its random
    weights (seed ``seed``) as a trainable model on ``device`` with zero
    AdamW state, the data stream, and ``step_fn(model, opt_state, batch)
    -> (model, opt_state, metrics)``. With ``data_parallel`` or
    ``model_parallel`` other than 1, on this rank of a (data, model) mesh
    (``launch.mesh.make_host_mesh``) over the initialised process group,
    which raises without one: the model holds this rank's expert slots of
    the one-device draw, every rank reads the same global batch from the
    stream, and ``step_fn`` takes the ``ShardCtx`` (``step_fn.keywords``).
    ``overrides``: config fields to replace (a depth cut, the dispatch
    mode)."""
    dev = dispatch.resolve_device(device)
    ctx = None
    if data_parallel != 1 or model_parallel != 1:
        mesh = make_host_mesh(data_parallel, model_parallel,
                              device_type=dev.type)
        ctx = ShardCtx(mesh, dp_axes(mesh))
    cfg = configs.get(arch)
    if reduced:
        cfg = cfg.reduced()
    if use_flash:
        cfg = dataclasses.replace(cfg, use_flash=True)
    cfg = dataclasses.replace(cfg, **(overrides or {}))
    opt_cfg = AdamWConfig(total_steps=steps, warmup_steps=max(steps // 20, 5))
    model, opt_state = lm.init_all(cfg, seed=seed, device=dev, ctx=ctx)
    stream = make_stream(cfg, DataConfig(seed=seed, global_batch=batch,
                                         seq_len=seq))
    step_fn = functools.partial(lm.train_step, cfg=cfg, opt_cfg=opt_cfg,
                                ctx=ctx)
    return cfg, model, opt_state, stream, step_fn


def to_device(batch_np: Dict, device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy) on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}


def state_tree(state: TrainState) -> Dict:
    """What a checkpoint holds: the trained tensors (``lm.trainable``) and
    the optimizer state."""
    return {"params": lm.trainable(state.model), "opt": state.opt_state}


@torch.no_grad()
def load_state(tree: Dict, state: TrainState) -> TrainState:
    """Copy a restored ``state_tree`` into the state's model and optimizer
    state (in place) and return it."""
    for name, t in lm.trainable(state.model).items():
        t.copy_(tree["params"][name])
    params = dict(state.model.named_parameters())
    for name, master in (getattr(state.model, "master", None) or {}).items():
        params[name].copy_(master)
    for key in ("mu", "nu"):
        for name, t in state.opt_state[key].items():
            t.copy_(tree["opt"][key][name])
    state.opt_state["step"].copy_(tree["opt"]["step"])
    return state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--use-flash", action="store_true",
                    help="attention through the flash kernels")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (0: none)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="simulate a node failure at this step (test)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (cuda without a card "
                         "raises)")
    args = ap.parse_args()

    cfg, model, opt_state, stream, step_fn = build(
        args.arch, reduced=args.reduced, batch=args.batch, seq=args.seq,
        steps=args.steps, seed=args.seed, use_flash=args.use_flash,
        device=args.device)
    dev = model.device
    prefetch = Prefetcher(stream)
    losses = []
    failed = []

    def one_step(state: TrainState, step: int) -> TrainState:
        if step == args.inject_failure_at and not failed:
            failed.append(step)
            raise RuntimeError("injected node failure")
        _, batch_np = next(prefetch)
        model, opt, metrics = step_fn(state.model, state.opt_state,
                                      to_device(batch_np, dev))
        return TrainState(model, opt,
                          {k: float(v) for k, v in metrics.items()})

    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every or args.steps + 1),
        one_step, state_to_tree=state_tree, tree_to_state=load_state,
        device=dev)

    def on_metrics(step, state, dt):
        losses.append(state.metrics.get("loss", float("nan")))
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {state.metrics['loss']:.4f} "
                  f"lr {state.metrics['lr']:.2e} {dt*1e3:.0f} ms")

    t0 = time.time()
    state = sup.run(TrainState(model, opt_state, {}), args.steps,
                    on_metrics=on_metrics)
    prefetch.close()
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s | "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} | "
          f"failures={sup.failures} restores={sup.restores} "
          f"stragglers={len(sup.monitor.flagged)} | device={dev}")


if __name__ == "__main__":
    main()
