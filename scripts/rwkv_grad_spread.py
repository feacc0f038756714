"""How far rwkv6-3b's float32 gradients move under a change in the order
of sums alone, at full width on one CUDA card, against how far the WKV
kernels move them.

    python3 scripts/rwkv_grad_spread.py [--seeds 12 13 14] [--layers 4]

For each seed: random weights drawn on the card, 1 x 1024 tokens, float32
compute, TF32 off, ``remat="full"``; the gradients of ``lm.loss_and_grads``
three ways: with the kernels (the WKV tc forward and the backward kernels),
with autograd through ``wkv_plain`` on the card, and on the CPU (the plain
versions, the CPU's GEMMs). Prints, for each pair, the largest leaf's
max |difference| over its largest magnitude and the four largest leaves.
``chip_smoke.py`` phase 18's check (f2) holds rwkv6-3b against the plain
card run's distance from the CPU measured this way in the same run.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import lm, transformer  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[12, 13, 14])
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    print(chip_smoke.card())
    cfg = dataclasses.replace(configs.get("rwkv6-3b"), n_layers=args.layers,
                              compute_dtype="float32")
    for seed in args.seeds:
        flat = lm.init_flat(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(seed))
        tokens = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (1, 1024)).astype(np.int32))
        grads = {}
        for run, device in (("kernels", "cuda"), ("plain", "cuda"),
                            ("cpu", "cpu")):
            f = {k: v.to(device) for k, v in flat.items()}
            model = lm.make_trainable(transformer.Transformer(cfg, f), cfg,
                                      f)
            t = time.perf_counter()
            with (chip_smoke._plain_ssm_ops() if run == "plain"
                  else contextlib.nullcontext()):
                _, met, g = lm.loss_and_grads(
                    model, {"tokens": tokens.to(device)}, cfg)
            grads[run] = {k: v.cpu() for k, v in g.items()}
            print(f"seed {seed} {run}: loss {float(met['loss']):.9f}, "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
            del model, f, g
        for a, b in (("kernels", "plain"), ("plain", "cpu"),
                     ("kernels", "cpu")):
            r = chip_smoke._leaf_ratios(grads[a], grads[b])
            top = sorted(r.items(), key=lambda kv: -kv[1])[:4]
            print(f"seed {seed} {a} vs {b}: largest leaf ratio "
                  f"{max(r.values()):.3e}; "
                  + ", ".join(f"{k} {v:.2e}" for k, v in top), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
