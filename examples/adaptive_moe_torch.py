"""AWAPart in the LM framework, on the PyTorch port: workload-aware MoE
expert placement.

Routes a request workload with topical structure through an MoE layer,
observes expert co-activation, and migrates experts between
expert-parallel ranks the way the paper migrates triples between shards,
cutting all-to-all dispatch bytes (the "distributed joins"). Each round's
Jaccard matrix runs on the card (the Jaccard kernel) unless ``--device
cpu``; the migrated layer must compute the same function as before.

    PYTHONPATH=src python examples/adaptive_moe_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import placement
from repro_torch.kernels import dispatch
from repro_torch.models import lm, moe

E, RANKS, TOPK = 64, 16, 8   # olmoe-1b-7b geometry


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the layer and the Jaccard matrix run (cuda "
                         "raises without a card)")
    args = ap.parse_args()
    dev = dispatch.resolve_device(args.device)
    cfg = ArchConfig(arch_id="olmoe-demo", family="moe", n_layers=1,
                     d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                     vocab_size=256, n_experts=E, top_k=TOPK,
                     moe_dispatch="rank", param_dtype="float32",
                     compute_dtype="float32")

    def layer():
        gen = torch.Generator(device=dev).manual_seed(0)
        return lm.init_params(cfg, device=dev, generator=gen).blocks[0].moe

    params = layer()
    rng = np.random.default_rng(0)

    # a workload with topical structure: each request activates experts
    # from one of 8 latent topics (plus noise) — the LM analogue of query
    # feature sets
    topics = rng.permutation(E).reshape(8, 8)

    def sample_routing(n_requests, noise=0.1):
        out = np.empty((n_requests, TOPK), np.int64)
        for i in range(n_requests):
            t = topics[rng.integers(8)]
            picks = list(rng.permutation(t)[:TOPK])
            for j in range(TOPK):
                if rng.random() < noise:
                    picks[j] = int(rng.integers(E))
            out[i] = picks
        return out

    expert_to_rank = np.repeat(np.arange(RANKS), E // RANKS).astype(np.int32)
    print(f"serving with identity placement on {dev}...")
    for round_i in range(3):
        routing = sample_routing(1024)
        new_map, report = placement.plan_expert_placement(
            routing, E, RANKS, old_expert_to_rank=expert_to_rank,
            expert_bytes=3 * cfg.d_model * cfg.d_ff * 4, device=dev)
        if report.accepted:
            params.load_state_dict(placement.apply_expert_placement(
                params.state_dict(), new_map))
            expert_to_rank = new_map
        print(f"round {round_i}: ranks/token {report.ranks_before:.2f} -> "
              f"{report.ranks_after:.2f} "
              f"(all-to-all bytes {report.bytes_saved_frac*100:+.0f}%), "
              f"migrated {report.moved_experts} experts "
              f"({report.migration_bytes/1e6:.1f} MB), "
              f"accepted={report.accepted}")

    # the placed layer computes the identical function (single-copy
    # migration, like triple swaps): check against a fresh, unpermuted one
    x = torch.randn((4, 8, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    y_ref, _ = moe.moe_apply(layer(), x, cfg)
    y_new, _ = moe.moe_apply(params, x, cfg)
    print(f"\nfunction preserved after migrations: "
          f"max diff = {float((y_ref - y_new).abs().max()):.2e}")


if __name__ == "__main__":
    main()
