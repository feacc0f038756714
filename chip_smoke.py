"""Smoke run of repro_torch on one CUDA card: build the kernels, hold each
against its plain PyTorch version, drive the AWAPart serving loop and the
LM serving paths (MoE with AWAPart expert placement among them) end to
end on the card, and report.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a nonzero exit):

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (``nvcc`` over ``src/repro_torch/csrc/``, into ``build/repro_torch/``;
   ``-Xptxas -v`` per kernel; ``cuobjdump -sass``'s HGMMA count of each
   tensor-core flash kernel);
2. the main path: ``repro_torch.api.KGService.from_dataset(lubm.load(10),
   n_shards=8)`` on the card — ``bootstrap``, three windows of the
   extended workload (the first executes, the repeats are result-cache
   hits), ``adapt(EQ1..EQ10)``, then windows served while the accepted
   migration drains under a 4 MiB per-window budget. Every window is held
   against the port's ``NumpyExecutor`` on the same facade and epoch
   (bindings and every ``ExecStats.COMPARABLE`` field). Kernel launch
   counts are reset just before and read just after; all five kernels must
   have launched. The run records what the main path hands the join
   kernels: the largest join (most pairs), the join with the largest probe
   side, the largest two-column key, and the largest federation
   ``expand_segment_ids`` call (``query/exec.py`` ``_federation_bincounts``);
3. a profile: the window executed again at the final layout, once under
   ``cProfile`` (host functions by self time) and once under
   ``torch.profiler`` (wall time, the card's busy time and idle share, the
   top device operations, and always the device time and launches of
   the five join and Jaccard kernels by name);
4. the kernels: each against its plain PyTorch version on the card, at the
   largest shapes the main path gave it and at edge cases, exactly (the
   Jaccard kernel bitwise, both its variants, "row" and "tile", through
   ``ops._run`` and the routed op at 12 edges, and a row of the kernels'
   line per variant), with the device time per call (profiler) of
   the kernel, the plain version and, where one exists, the PyTorch
   library call computing the same function, beside the bound from bytes
   and operations, and the per-call time with launch overhead (CUDA
   events); pack also at every alignment of its two columns (odd N, a
   view at an odd word offset, N = 1, 2, 3, values at 2^31 - 1), and timed
   in turns with ``torch.add`` at the main path's N and at N - 1; the
   launch floor (the device time of a one-element ``fill_``); probe at the
   largest join and the largest probe side, at every group size of its
   k-ary search (each held to the plain version) and in turns at the
   group ``probe_group`` gives against one lane a key, and at every group
   size over probe sides from 203 to 135,168 keys (the rule's thresholds);
   expand at the largest join, the largest probe side's join and the
   largest federation call, each beside ``repeat_interleave`` and its
   bound;
5. a small input: the LUBM(1) drain loop on the card and on the CPU must
   give byte-identical traces, windows and layouts;
6. the paper's experiments (``repro_torch.launch.serve``): experiment 1
   (workload composition change, LUBM(10) on 8 shards, AWAPart, 4 MiB
   budget) and, on a fresh system, experiment 2 (``Q1`` hot at share 0.5)
   on the torch executor, each against the same experiment on the numpy
   executor with the Jaccard matrix on the CPU: every modeled time, the
   accept decision, the plan's summary, the final layout and the printed
   lines equal; launch counts reset just before each torch run and read
   just after (all five KG kernels must launch); then the CLI
   (``python -m repro_torch.launch.serve --experiment 1
   --show-federated``) in a subprocess, its ``[exp1]`` lines against the
   in-process run's;
7. a WatDiv drift scenario: ``watdiv.load(640)`` (about 10 M triples) on
   8 shards, AWAPart, 4 MiB budget; ``scenario.flash_crowd`` through
   ``run_scenario`` adaptive and frozen on the torch executor, each against
   the numpy executor's run (every ``WindowRecord``, the recoveries and
   ``reactivity`` equal), launch counts reset just before each torch run
   and read just after; ``stream_schedule`` against the synchronous
   replay; generation, bootstrap and window wall times, one window again
   under ``cProfile`` and ``torch.profiler`` (idle share, top device
   operations), peak device memory beside the store's size;
8. HAC and Jaccard at the new shapes: ``core.hac.hac_torch`` on the card
   against ``hac_numpy`` (Z columns 0, 1 and 3 exactly, distances within
   1e-5) at every Jaccard matrix of phases 6 and 7 and a seeded 512 x 512
   matrix, for the three linkages, with its device time per call; both
   Jaccard variants bitwise against the plain version at the largest
   bitmaps of phases 6 and 7, timed beside the launch floor and the bound
   (bytes over 3.35 TB/s, popcounts over 16 a clock an SM x 132 SMs x
   the maximum SM clock); then the sweep: Q in 6, 24, 64, 128, 512, 1024
   (a = b) and (40, 300) at W in 1, 2, 3, 8, 16, 32, 64, 65, 256, both
   variants bitwise and timed in turns (row, tile, tile, row), whether
   ``ops.variant`` picks the faster within the spread, the crossover of
   each W;
9. LM serving, the port's second path: qwen3-0.6b at full width and depth
   (random weights from a seeded generator, bf16 compute, flash attention)
   serves 4 prompts of 2048 tokens with one ``lm.prefill_step`` and 32
   greedy ``lm.decode_step``s against a 2080-slot cache. Launch counts are
   reset just before and read just after; the flash kernel must launch
   once per layer in the prefill, all on its tensor-core variant ("tc"),
   and in every decode step, all on its decode variant ("dec"). Then:
   wall times, tokens/s, peak memory, the card's idle share over a decode
   step and a prefill (``torch.profiler``), and checks (b) the plain
   attention path's logits, (c) teacher-forced decode against the uncached
   forward, (d) the reduced config in float32 on the card against the CPU
   (each call on the variant its shape gives);
10. the flash kernel against its plain version at the prefill and decode
   shapes of phase 9 and at edge cases, each edge through the variant it
   must take, timed as in phase 4 beside ``scaled_dot_product_attention``
   and its bound (the larger of its bytes over 3.35 TB/s and its
   operations over 989 TFLOP/s bf16), and the decode call again over five
   input sets in turn, L2-cold as a decode step finds its cache; the
   scalar kernel, which decode steps ran before the dec kernel, timed at
   the decode shape beside it, warm and L2-cold, through its own launcher,
   and the dec kernel at other split counts than its rule gives;
11. rwkv6-3b serving, the port's third path: full width and depth (random
   weights from a seeded generator, bf16 compute, the time mix in float32)
   serves 4 prompts of 2048 tokens with one ``lm.prefill_step`` and 32
   greedy ``lm.decode_step``s. Launch counts are reset just before and read
   just after; the WKV kernel must launch once per layer in the prefill,
   all on its tensor-core variant ("tc"), and in every decode step, all on
   its decode variant ("dec"). Then: wall times, tokens/s, peak and resident
   memory, the idle share over a decode step and a prefill and the WKV
   kernel's share of the prefill's device time (``torch.profiler``), and
   checks (e) prefill(S) plus one decode step against prefill(S + 1) in
   bf16, (c) 64 positions decoded one at a time from the zero state against
   the uncached forward, at full width in float32 (the bf16 numbers and the
   bf16-vs-float32 forward are printed beside it), (d) the reduced config in
   float32 on the card against the CPU;
12. the WKV kernel against its plain version at edge cases, each through
   the variant it must take (s0 never written; a misaligned s0 refused by
   "dec" before any launch), and a 2048-step call with w within 1e-6 of 1
   through "tc" against a float64 recurrence; then timed as in phase 4:
   "tc" at the prefill shape of phase 11 beside its bound (bytes over 3.35
   TB/s, its three TF32 products over 495 TFLOP/s) and the "rec" kernel at
   the same shape beside the same bytes bound (its operations over 67
   TFLOP/s float32); "dec" at the decode shape over 32 input sets in turn
   (L2-cold, as a decode step finds each layer's state) beside its bytes
   bound, and in turns dec and "rec" (through ``ops._run``), each warm
   and L2-cold;
13. zamba2-7b serving, the port's fourth path: 81 Mamba2 layers at full
   width with the shared attention + MLP block before every sixth
   (random weights from a seeded generator with ``mamba2_init``'s
   constants, bf16 compute, flash attention) serves 4 prompts of 2048
   tokens with one ``lm.prefill_step`` and 32 greedy ``lm.decode_step``s.
   Launch counts are reset just before and read just after; the SSD kernel
   must launch once per layer and the flash kernel once per application
   of the shared block, in the prefill (both "tc") and in every decode step
   (SSD "rec", flash "dec"); the float32 checks run each flash call on the
   variant its shape gives ("scalar" for a float32 prefill). Then:
   wall times, tokens/s, memory, the idle share and top device operations
   over a decode step and a prefill (``torch.profiler``), and checks (e)
   prefill(S) plus one decode step against prefill(S + 1) in bf16, (b)
   flash against plain attention and (c) teacher-forced decode against
   the forward, both in float32 at full width and depth, (d) the reduced
   config in float32 on the card against the CPU;
14. the SSD kernel against its plain version at edge cases, each through
   the variant it must take, and a long tiny-dt call through "tc" against
   a float64 recurrence; then timed as in phase 4: "tc" at the prefill
   shape of phase 13 beside its bound (bytes over 3.35 TB/s, its three
   TF32 products over 495 TFLOP/s) and the "rec" kernel at the same shape
   beside its scalar floor, "rec" at the decode shape (operations over 67
   TFLOP/s float32) over eight input sets in turn, so that each call finds
   its state outside the card's L2, as a decode step does; then the flash
   kernel at zamba2-7b's prefill and decode shapes, as in phase 10;
15. MoE serving, the port's fifth path: olmoe-1b-7b at full width and
   depth (16 layers, 64 experts top-8; float32 parameters, bf16 compute,
   flash attention, random weights from a seeded generator) serves 4
   prompts of 2048 tokens with one ``lm.prefill_step`` and 32 greedy
   ``lm.decode_step``s. Launch counts are reset just before and read just
   after: flash once per layer in the prefill, all "tc", and in every
   decode step, all "dec". Then: wall times, tokens/s, peak memory, the
   idle share, device operations a layer and the top device operations
   over a decode step and a prefill; check (p): one
   ``core.placement.plan_expert_placement`` a layer on topical routing
   (as ``examples/adaptive_moe.py`` draws it), its Jaccard matrix on the
   card (one launch a layer), map and report equal to the same plan on
   the CPU, each accepted map applied with ``apply_expert_placement``,
   and the same requests served again bit for bit; checks (b) flash
   against plain attention and (c) teacher-forced decode against the
   forward, in float32 at full width and depth, and (d) the reduced
   config card against CPU, each comparing every layer's routes (top-k
   sets) token by token: a differing route passes where the oracle's gap
   between its k-th and (k+1)-th router logits is under 2^-10, and the
   rows whose routes agree are held to the limits; then the flash kernel
   at the prefill and decode shapes and both Jaccard variants at the
   placement shape against their plain versions, timed as in phase 10;
16. the same for qwen3-moe-30b-a3b (48 layers, 128 experts top-8, GQA
   32/4) in bfloat16 parameters (61 GB), its float32 checks (b) and (c)
   at full width and 12 of the 48 layers;
17. training, the port's sixth path (``[train]`` lines): (k) the three
   flash backward kernels (``csrc/flash_attention_bwd.cu``) of each route
   (``ops.bwd_variant``: "tc", bf16 on the tensor cores; "scalar", the
   rest) against ``flash_attention_bwd_plain`` (and the pre kernel's row
   statistics against ``flash_attention_bwd_stats_plain``) at edge cases,
   the scalar route's in every dtype and the tc route's in bf16, each call
   on its route's kernels alone, each element within 2^-7 (bf16) or
   2^-10 (f16) of itself plus 2^-14 of its output's largest magnitude
   (float32: the latter alone), two tc calls bit for bit, and five
   planted faults failing that check at the timed shapes; (f)
   float32 gradients of qwen3-0.6b at full width and 4 of its 28 layers
   (1 x 1024 tokens, TF32 off) with ``use_flash`` (the scalar forward
   and the scalar backward kernels) against autograd through the
   plain attention, every leaf within 1e-4 of its largest, loss and
   grad_norm within 1e-5; (r) ``train_step`` on the card against the CPU
   for four reduced configs (three float32 steps, AdamW eps 1e-3), then
   the supervisor on the card with an async checkpoint and an injected
   failure, the restored state bit for bit the checkpoint's; (t) the main
   path: qwen3-0.6b at full width and depth through
   ``launch.train.build`` and ``TrainSupervisor``, float32 parameters and
   AdamW state, bf16 compute, ``remat="full"``, flash attention, a global
   batch of 4 x 4096 tokens, 8 steps on the pipeline's first batch:
   launch counts reset just before and read just after (flash tc 56 a
   step, each backward kernel 28 on tc), step walls, tokens/s, peak
   memory, a profiled step's idle share and top device operations; every
   loss finite, the first within 0.5 of a random model's ln V + 1/2, the
   last below the first; then the backward kernels at the main path's
   and hubert-xlarge's shapes (tc, beside the scalar route on the same
   call) and a float32 shape (scalar), timed per kernel and summed beside
   the plain version, the SDPA backward and the bounds.

The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import cProfile
import collections
import contextlib
import dataclasses
import functools
import hashlib
import io
import itertools
import json
import math
import os
import pathlib
import pstats
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
TENSOR_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
TF32_OPS_PER_S = 495e12          # H100 SXM dense TF32 tensor-core rate
# 32-bit population counts a clock an SM at compute capability 9.0 (CUDA C++
# Programming Guide, "Arithmetic Instructions" throughput table); times the
# card's SM count and its maximum SM clock (nvidia-smi) for the rate
POPC_PER_CLOCK_SM = 16
MIGRATION_BUDGET = 4 << 20       # bytes per window: LUBM(10)/8 drains in 4
# windows served before the adaptation round: the guard amortizes the
# migration over the observed TM window, and one window of LUBM(10)/8 is
# too few to pay for this round's 11.9 MB plan
WARM_WINDOWS = 3
PROFILE_TRIES = 12               # profiles of a call before its trace counts
                                 # as empty (see device_ms)


def log(*args) -> None:
    print(*args, flush=True)


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def popc_rate() -> tuple:
    """The card's popcount rate (per second) and how it was formed: 16 a
    clock an SM x the SM count x the maximum SM clock."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = POPC_PER_CLOCK_SM * n_sms * mhz * 1e6
    return rate, (f"{rate / 1e12:.3f} Tpopc/s = {POPC_PER_CLOCK_SM} a clock "
                  f"an SM (CUDA C++ Programming Guide, cc 9.0) x {n_sms} SMs "
                  f"x {mhz:.0f} MHz")


def call_ms(fn, reps: int = 20, runs: int = 7) -> float:
    """Median over ``runs`` of the mean CUDA-event time of ``reps`` back to
    back calls, after a warm-up call: what a caller pays per call, host
    launch overhead included when it exceeds the device work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 20, tries: int = PROFILE_TRIES) -> float:
    """Device time per call: the summed durations of every CUDA kernel and
    memory operation ``fn`` puts on the card, from a ``torch.profiler``
    trace of ``reps`` calls after a warm-up call. Excludes host launch
    overhead and the idle gaps between launches; 0 for a call that puts no
    work on the card (the plain one-column pack returns its input). On the
    H100 machines the profiler now and then returns an empty trace for
    calls that do launch kernels (taken again, up to ``tries`` times: a
    run has seen hundreds of empty traces and four in a row), or
    leaves some operations out of a trace (16 of 20 launches of the flash
    kernel at zamba2-7b's prefill shape once): so each operation name
    counts ``round(n / reps)`` times per call, at least once, at the mean
    duration of its ``n`` recorded operations."""
    fn()
    torch.cuda.synchronize()
    prof = torch.profiler
    for attempt in range(tries):
        with prof.profile(activities=[prof.ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = collections.defaultdict(list)
        for e in p.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name].append(e.device_time_total)
        if by_name:
            break
        log(f"[profile] empty device trace (attempt {attempt + 1})")
    per_call = {name: max(1, round(len(us) / reps))
                for name, us in by_name.items()}
    missing = sum(reps * n - len(by_name[name])
                  for name, n in per_call.items())
    if missing > 0:
        log(f"[profile] the trace lacks {missing} of "
            f"{reps * sum(per_call.values())} device operations; each "
            "counts at the mean duration of its name")
    return sum(n * statistics.fmean(by_name[name])
               for name, n in per_call.items()) / 1e3


def canon(bindings) -> np.ndarray:
    """Bindings as one row-sorted (rows, vars) array, vars in key order."""
    if not bindings:
        return np.empty((0, 0), np.int64)
    cols = np.stack([np.asarray(bindings[k], np.int64)
                     for k in sorted(bindings)], axis=1)
    return cols[np.lexsort(cols.T[::-1])] if len(cols) else cols


def check_window(results, kg, window, qexec) -> float:
    """The card's results for ``window`` against the port's numpy executor
    on the same facade and epoch; returns the numpy executor's wall time."""
    t = time.perf_counter()
    want = qexec.NumpyExecutor(kg.max_join_rows).run_batch(
        [kg.plan(q) for q in window], kg)
    numpy_s = time.perf_counter() - t
    for q, (b, s), (rb, rs) in zip(window, results, want):
        assert sorted(b) == sorted(rb), q.name
        assert np.array_equal(canon(b), canon(rb)), q.name
        for f in qexec.ExecStats.COMPARABLE:
            assert getattr(s, f) == getattr(rs, f), (q.name, f)
    return numpy_s


# --------------------------------------------------------------------------- #
# phase 2: the main path
# --------------------------------------------------------------------------- #

def main_path(rec):
    from repro_torch.api import KGService
    from repro_torch.graph import lubm
    from repro_torch.kernels import _build
    from repro_torch.kernels.join import ops as join_ops
    from repro_torch.query import exec as qexec

    t0 = time.perf_counter()
    ds = lubm.load(10, seed=0)
    log(f"[main] LUBM(10): {ds.store.n_triples} triples, generated in "
        f"{time.perf_counter() - t0:.2f} s")
    _build.reset_launches()
    with join_ops.track_transfers() as ts:
        t0 = time.perf_counter()
        svc = KGService.from_dataset(ds, n_shards=8,
                                     migration_budget=MIGRATION_BUDGET)
        kg = svc.bootstrap(ds.base_workload())
        log(f"[main] device={svc.device} executor={svc.executor.name} "
            f"bootstrap {time.perf_counter() - t0:.3f} s")
        window = ds.extended_workload()
        wall = []

        def serve():
            t = time.perf_counter()
            res = svc.query_batch(window)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t)
            numpy_s = check_window(res, kg, window, qexec)
            log(f"[main] window {len(wall)}: {len(window)} queries, epoch "
                f"{kg.epoch}, wall {wall[-1] * 1e3:.1f} ms, rows "
                f"{sum(s.rows for _, s in res)}, matches the numpy "
                f"executor (its wall {numpy_s * 1e3:.1f} ms)")

        for _ in range(WARM_WINDOWS):      # the TM observes a few windows
            serve()
        t = time.perf_counter()
        report = svc.adapt(ds.workload([f"EQ{i}" for i in range(1, 11)]))
        adapt_s = time.perf_counter() - t
        log(f"[main] adapt {adapt_s:.3f} s: accepted={report.accepted} "
            f"reason={report.reason} moves={report.plan.n_moves} "
            f"bytes={report.plan.bytes} cut={report.chosen_cut} "
            f"clusters={report.n_clusters} t_base={report.t_base:.6f} "
            f"t_new={report.t_new:.6f}")
        assert report.accepted and svc.session is not None
        n_chunks = svc.session.n_chunks
        while svc.session is not None:
            serve()
    launches = dict(_build.launches)
    drain_windows = len(wall) - WARM_WINDOWS
    log(f"[main] drained {n_chunks} chunks over {drain_windows} windows; "
        f"window wall ms {[round(w * 1e3, 1) for w in wall]}")
    log(f"[main] join pipeline's host<->device crossings: {ts.h2d} h2d, "
        f"{ts.d2h} d2h")
    log(f"[main] kernel launches: {launches}")
    assert drain_windows >= 3, drain_windows
    for k in ("pack", "probe", "expand", "gather", "jaccard"):
        assert launches.get(k, 0) > 0, f"kernel {k} never launched"
    return launches, svc, window


# the join and Jaccard kernels, by the names the profiler gives them
JOIN_KERNELS = ("pack2_kernel", "probe_kernel", "expand_kernel",
                "gather_kernel", "jaccard_kernel", "jaccard_tile_kernel")


def profile_window(svc, window, tag="profile") -> None:
    """The window executed again by the torch executor at the final layout:
    once under ``cProfile`` (host functions by self time), once under
    ``torch.profiler`` (wall time, the card's busy time and idle share,
    device time by kernel). Not part of the counted main-path run."""
    kg = svc.kg
    plans = [kg.plan(q) for q in window]
    torch.cuda.synchronize()
    host = cProfile.Profile()               # where the host's time goes
    t = time.perf_counter()
    host.runcall(svc.executor.run_batch, plans, kg)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    log(f"[{tag}] host profile (cProfile, {host_ms:.1f} ms wall with its "
        "overhead), functions by self time:")
    rows = sorted(pstats.Stats(host).stats.items(),
                  key=lambda kv: -kv[1][2])[:12]
    for (path, line, func), (_, ncalls, self_s, cum_s, _) in rows:
        where = f"{pathlib.Path(path).name}:{line}({func})"
        log(f"[{tag}]   self {self_s * 1e3:8.1f} ms  cum {cum_s * 1e3:8.1f}"
            f" ms  {ncalls:6d}x  {where[:80]}")
    prof = torch.profiler
    acts = [prof.ProfilerActivity.CPU, prof.ProfilerActivity.CUDA]
    with prof.profile(activities=acts) as p:
        t = time.perf_counter()
        svc.executor.run_batch(plans, kg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev = [e for e in p.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in dev) / 1e6
    by_name = {}
    for e in dev:
        n, t_us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t_us + e.device_time_total)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    log(f"[{tag}] window at the final layout: wall {wall * 1e3:.1f} ms, "
        f"device busy {busy * 1e3:.3f} ms, idle share "
        f"{1 - busy / wall:.4f}, {len(dev)} device operations")
    for name, (n, t_us) in top:
        log(f"[{tag}]   {t_us / 1e3:9.3f} ms  {n:5d}x  {name[:90]}")
    for kernel in JOIN_KERNELS:
        us = sorted((e.device_time_total for e in dev
                     if f"::{kernel}" in e.name), reverse=True)
        # a kernel compiled in several forms (probe_kernel<G>) by form
        forms = collections.Counter()
        for e in dev:
            if f"::{kernel}" in e.name:
                forms[e.name.split("::")[-1].split("(")[0]] += \
                    e.device_time_total
        log(f"[{tag}]   {kernel}: {sum(us) / 1e3:.4f} ms over {len(us)} "
            f"launches ({sum(us) / max(len(us), 1) / 1e3:.5f} ms a launch; "
            f"longest {', '.join(f'{u / 1e3:.4f}' for u in us[:5])}); "
            + "".join(f"{f} {t / 1e3:.4f} ms, "
                      for f, t in sorted(forms.items()) if len(forms) > 1)
            + card())


# --------------------------------------------------------------------------- #
# phase 4: each kernel against its plain version
# --------------------------------------------------------------------------- #

def _int_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(_int_err(g, w) for g, w in zip(got, want))
    assert got.shape == want.shape and got.dtype == want.dtype
    return int((got - want).abs().max()) if got.numel() else 0


def _exact(name, got, want) -> int:
    err = _int_err(got, want)
    assert err == 0, f"{name}: kernel disagrees with its plain version"
    return err


def kernel_row(rows, launches, name, source, replaces, err, fn, plain,
               library, n_bytes, n_ops, note, *,
               ops_per_s=SCALAR_OPS_PER_S, ops_rate="67 TOP/s",
               plain_reps=20, variant=None):
    """Time ``fn`` (the kernel's wrapper), ``plain`` (``plain_reps`` calls
    per measurement, fewer where it is slow) and ``library`` on the card,
    log them beside the bound from ``n_bytes`` and ``n_ops``, and append the
    kernel's row to ``rows``: its main-path ``launches``, those of
    ``variant`` where the kernel has more than one design (the row's
    ``variant``, else null)."""
    ms, plain_ms = device_ms(fn), device_ms(plain, reps=plain_reps)
    assert ms > 0, f"{name}: the profiler recorded no kernel time"
    library_ms = None if library is None else device_ms(library)
    calls = [call_ms(fn),
             call_ms(plain, reps=plain_reps, runs=min(7, plain_reps))]
    bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s) * 1e3
    bound_by = ("bytes" if n_bytes / HBM_BYTES_PER_S >= n_ops / ops_per_s
                else "operations")
    n_launch = launches.get(name if variant is None else
                            f"{name}.{variant}", 0)
    rows.append(dict(name=name, route="cuda", source=source,
                     replaces=replaces, variant=variant, launches=n_launch,
                     max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=library_ms))
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"[kernels] {name} ({note}): device time per call: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}; per "
        f"call with launch overhead: kernel {calls[0]:.4f} ms, plain "
        f"{calls[1]:.4f} ms; bound {bound_ms:.6f} ms "
        f"({bound_by}: {n_bytes} B / 3.35 TB/s, {n_ops} ops / "
        f"{ops_rate}), main-path launches {n_launch}, "
        f"max_abs_err {err}; {card()}")


def kernels(rec, launches):
    from repro_torch.kernels.join import ops as J

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)

    # edge cases first: duplicates, misses, empty sides, zero-count and
    # trailing-zero segments, out-of-range gather indices
    build = t(np.sort(rng.integers(0, 50, 3000)))
    for probe in (t(rng.integers(-5, 60, 4000)), t([]), t([0, 49, 50])):
        _exact("probe edge", J.probe_sorted(build, probe),
               J.probe_sorted_plain(build, probe))
    _exact("probe empty build", J.probe_sorted(t([]), t([1, 2])),
           J.probe_sorted_plain(t([]), t([1, 2])))
    for counts in ([0, 0, 3, 0, 1, 0, 0], [5], [0, 0], []):
        c = t(counts)
        lo = t(rng.integers(0, 100, len(counts)))
        starts = torch.cumsum(c, 0) - c
        _exact("expand edge", J.expand_pairs(lo, c),
               J.expand_pairs_plain(starts, lo, int(c.sum())))
    # the k-ary probe at every group size: fewer build keys than lanes,
    # keys near +-2^62, a run of equal keys across every splitter
    run = t(np.r_[np.ones(10), np.full(1000, 5), np.full(10, 9)])
    wide = t([-2**62 - 5, -2**62, -1, 0, 2**62, 2**62, 2**62 + 9])
    for grp in (1, 2, 4, 8, 16, 32):
        for b_, p_ in ((t([-4, 2, 2, 9, 11]), t([-5, -4, 2, 3, 11, 12])),
                       (wide, t([-2**63, -2**62, 0, 2**62 + 9, 2**63 - 1])),
                       (run, t([0, 1, 4, 5, 6, 9, 10]))):
            _exact(f"probe edge, {grp} lanes a key", J._probe(b_, p_, grp),
                   J.probe_sorted_plain(b_, p_))
    # the merge-path expansion: a million empty segments, one segment over
    # many tiles, a total off the tile size
    million = np.zeros(1_000_000, np.int64)
    million[[0, 499_999, 999_999]] = [3, 2 * J.EXPAND_TILE, 1]
    many = np.zeros(7, np.int64)
    many[3] = 9 * J.EXPAND_TILE + 5
    for counts in (million, many, np.r_[2, np.ones(J.EXPAND_TILE + 2)]):
        c = t(counts)
        lo = t(rng.integers(-2**40, 2**40, len(counts)))
        starts = torch.cumsum(c, 0) - c
        _exact("expand edge", J.expand_pairs(lo, c),
               J.expand_pairs_plain(starts, lo, int(c.sum())))
    vals = t(rng.integers(0, 2**40, 500))
    idx = t(rng.integers(-50, 550, 2000))
    _exact("gather edge", J.gather_rows(vals, idx, fill=-1),
           J.gather_rows_plain(vals, idx, -1))
    _exact("gather empty table", J.gather_rows(t([]), idx, fill=7),
           J.gather_rows_plain(t([]), idx, 7))
    for k in (1, 2):
        cols = t(rng.integers(0, 2**31, (k, 1000)))
        _exact("pack edge", J.pack_keys(cols), J.pack_keys_plain(cols))
    # pack at every (c0, c1) alignment: odd N puts c1 8 bytes off a 16-byte
    # boundary, a view one word into its storage moves c0 there; N = 1, 2,
    # 3 and values at 2^31 - 1
    for pn_ in (1, 2, 3, 4, 1000, 1001):
        for offset in (0, 1):
            vals = rng.integers(0, 2**31, 2 * pn_ + offset)
            vals[offset::5] = 2**31 - 1
            cols = t(vals)[offset:].view(2, pn_)
            assert cols.data_ptr() % 16 == 8 * offset
            _exact(f"pack edge N={pn_}, offset {offset}", J.pack_keys(cols),
                   J.pack_keys_plain(cols))
    jaccard_edges(rng)
    torch.cuda.synchronize()
    log("[kernels] edge cases: all five kernels match their plain versions")

    rows = []

    def report(name, source, replaces, err, fn, plain, library,
               n_bytes, n_ops, note):
        kernel_row(rows, launches, name, source, replaces, err, fn, plain,
                   library, n_bytes, n_ops, note)

    join_src = "src/repro_torch/csrc/join.cu"
    join_ref = "src/repro/kernels/join/kernel.py"

    # pack, at the main path's largest two-column key (a single column is
    # its own key and launches nothing)
    pk = t(np.stack(rec["pack"]))
    pn = pk.shape[1]
    log(f"[kernels] largest main-path two-column key: {pn} rows")
    err = _exact("pack", J.pack_keys(pk), J.pack_keys_plain(pk))
    _exact("pack library", torch.add(pk[1], pk[0], alpha=1 << 31),
           J.pack_keys(pk))
    report("pack", join_src, f"{join_ref}:80", err,
           lambda: J.pack_keys(pk),
           lambda: J.pack_keys_plain(pk),
           lambda: torch.add(pk[1], pk[0], alpha=1 << 31),
           24 * pn, 2 * pn, f"K=2, N={pn}; library = torch.add(c1, c0, "
           "alpha=2^31)")
    # the spread of kernel against library in turns (kernel, library,
    # library, kernel, twice), at N and at N - 1 (the other parity: at odd
    # N c1 starts 8 bytes off a 16-byte boundary and torch.add runs its
    # unrolled 8-byte kernel, at even N its vectorized one)
    for n_ in (pn, pn - 1):
        cols = pk if n_ == pn else t(np.stack(rec["pack"])[:, :n_])
        _exact("pack, other parity", J.pack_keys(cols),
               J.pack_keys_plain(cols))
        fns = {"kernel": lambda: J.pack_keys(cols),
               "library": lambda: torch.add(cols[1], cols[0], alpha=1 << 31)}
        got = collections.defaultdict(list)
        for who in ("kernel", "library", "library", "kernel") * 2:
            got[who].append(device_ms(fns[who]))
        how = ("torch.add unvectorized" if n_ % 2 else
               "torch.add vectorized")
        ks, ls = (", ".join(f"{x:.5f}" for x in got[who])
                  for who in ("kernel", "library"))
        log(f"[kernels] pack N={n_} ({how}), device ms per call in turns: "
            f"kernel {ks}; library {ls} (torch.add(c1, c0, alpha=2^31)); "
            f"{card()}")

    # the floor any launch pays: the device time of a one-element fill_
    one = torch.empty(1, dtype=torch.int64, device=dev)
    floor_ms = device_ms(lambda: one.fill_(1))
    log(f"[kernels] launch floor: a one-element fill_ takes {floor_ms:.5f} "
        f"ms of device time; {card()}")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def probe_inputs(lcs, rcs):
        lk = J.pack_keys(t(np.stack(lcs)))
        rk_sorted, order = torch.sort(J.pack_keys(t(np.stack(rcs))),
                                      stable=True)
        return lk, rk_sorted, order

    def probe_cost(n, m):
        # two binary searches per probe key read at most ``steps`` build
        # keys each key, and never more than the whole build side
        steps = 2 * math.ceil(math.log2(m + 1))
        return min(8 * m, 8 * n * steps) + 8 * n + 16 * n, 2 * steps * n

    def probe_shape(what, rk_sorted, lk):
        """Probe at one recorded shape: at every group size, each held to
        the plain version, then the formula's group in turns with one
        lane a key, beside searchsorted and the bound."""
        n, m = lk.shape[0], rk_sorted.shape[0]
        want = J.probe_sorted_plain(rk_sorted, lk)
        g = J.probe_group(n, m, n_sms)
        at = {}
        for grp in (1, 2, 4, 8, 16, 32):
            _exact(f"probe, {grp} lanes a key", J._probe(rk_sorted, lk, grp),
                   want)
            at[grp] = device_ms(lambda: J._probe(rk_sorted, lk, grp))
        lib = device_ms(lambda: (torch.searchsorted(rk_sorted, lk),
                                 torch.searchsorted(rk_sorted, lk,
                                                    right=True)))
        n_bytes, n_ops = probe_cost(n, m)
        bound = max(n_bytes / HBM_BYTES_PER_S, n_ops / SCALAR_OPS_PER_S) * 1e3
        # in turns with one lane a key, or with 32 where the rule gives 1
        other = 1 if g != 1 else 32
        turns = collections.defaultdict(list)
        for grp in (g, other, other, g) * 2:
            turns[grp].append(device_ms(lambda: J._probe(rk_sorted, lk, grp)))
        log(f"[kernels] probe at the {what} (M={m}, N={n}; probe_group "
            f"gives {g}): device ms per call by lanes a key "
            + ", ".join(f"{k}: {v:.5f}" for k, v in at.items())
            + f"; in turns {g} lanes "
            + ", ".join(f"{x:.5f}" for x in turns[g]) + f"; {other} lanes "
            + ", ".join(f"{x:.5f}" for x in turns[other])
            + f"; library (searchsorted left + right) {lib:.5f}; bound "
            f"{bound:.6f} ms; launch floor {floor_ms:.5f}; {card()}")

    def expand_shape(what, lo, counts, starts, total):
        """Expand at one recorded shape against its plain version, timed
        beside repeat_interleave and the bound."""
        s_ = counts.shape[0]
        _exact(f"expand at the {what}",
               J.expand_pairs(lo, counts, starts=starts, total=total),
               J.expand_pairs_plain(starts, lo, total))
        seg = torch.arange(s_, device=dev)
        ms = device_ms(lambda: J.expand_pairs(lo, counts, starts=starts,
                                              total=total))
        lib = device_ms(lambda: torch.repeat_interleave(seg, counts,
                                                        output_size=total))
        bound = 16 * (s_ + total) / HBM_BYTES_PER_S * 1e3
        log(f"[kernels] expand at the {what} (segments={s_}, total={total},"
            f" {J.expand_tiles(total, s_)} tiles of {J.EXPAND_TILE}): device"
            f" ms per call {ms:.5f}, library (repeat_interleave, li only) "
            f"{lib:.5f}, bound {bound:.6f} ms (bytes), launch floor "
            f"{floor_ms:.5f}; {card()}")

    lk, rk_sorted, order = probe_inputs(*rec["join"])
    n, m = lk.shape[0], rk_sorted.shape[0]
    log(f"[kernels] largest main-path join: probe side {n} rows, build "
        f"side {m} rows, {len(rec['join'][0])} key column(s), "
        f"{rec['join_total']} pairs")

    # probe, over the stably sorted packed build side
    lo, counts = J.probe_sorted(rk_sorted, lk)
    err = _exact("probe", (lo, counts), J.probe_sorted_plain(rk_sorted, lk))
    report("probe", join_src, f"{join_ref}:127", err,
           lambda: J.probe_sorted(rk_sorted, lk),
           lambda: J.probe_sorted_plain(rk_sorted, lk),
           lambda: (torch.searchsorted(rk_sorted, lk),
                    torch.searchsorted(rk_sorted, lk, right=True)),
           *probe_cost(n, m),
           f"M={m}, N={n}, {J.probe_group(n, m, n_sms)} lanes a key; "
           "library = searchsorted left + right")
    probe_shape("largest join", rk_sorted, lk)
    # the group rule against the card: every group size at probe sides
    # from the main path's smallest to past the rule's last threshold, keys
    # drawn from the largest join's build side (half of them one above a
    # build key)
    for n_ in (203, 2112, 4224, 8448, 16896, 33792, 135168):
        keys = rk_sorted[t(rng.integers(0, m, n_))] + t(rng.integers(0, 2, n_))
        g = J.probe_group(n_, m, n_sms)
        _exact("probe sweep", J.probe_sorted(rk_sorted, keys),
               J.probe_sorted_plain(rk_sorted, keys))
        at = {grp: device_ms(lambda: J._probe(rk_sorted, keys, grp))
              for grp in (1, 4, 8, 16, 32)}
        log(f"[kernels] probe sweep M={m}, N={n_}: device ms per call by "
            "lanes a key " + ", ".join(f"{k}: {v:.5f}" for k, v in at.items())
            + f"; probe_group gives {g}, the fastest was "
            f"{min(at, key=at.get)}; {card()}")
    plk, prk_sorted, _ = probe_inputs(*rec["probe"])
    log(f"[kernels] the main path's largest probe side: {plk.shape[0]} "
        f"rows, build side {prk_sorted.shape[0]} rows, "
        f"{len(rec['probe'][0])} key column(s)")
    probe_shape("largest probe side", prk_sorted, plk)
    plo, pcounts = J.probe_sorted(prk_sorted, plk)
    expand_shape("largest probe side", plo, pcounts,
                 torch.cumsum(pcounts, 0) - pcounts, int(pcounts.sum()))

    # expand, of the probe's match runs: one search a tile, no output
    # searches, so about two operations an output
    starts = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    assert total == rec["join_total"]
    li, pos = J.expand_pairs(lo, counts, starts=starts, total=total)
    err = _exact("expand", (li, pos),
                 J.expand_pairs_plain(starts, lo, total))
    seg = torch.arange(n, device=dev)
    report("expand", join_src, f"{join_ref}:188", err,
           lambda: J.expand_pairs(lo, counts, starts=starts, total=total),
           lambda: J.expand_pairs_plain(starts, lo, total),
           lambda: torch.repeat_interleave(seg, counts, output_size=total),
           16 * n + 16 * total, 2 * total,
           f"segments={n}, total={total}; library = repeat_interleave "
           "(li only)")
    expand_shape("largest join", lo, counts, starts, total)
    fed = rec["fed"]
    fed_starts = torch.cumsum(fed, 0) - fed
    expand_shape("largest federation call", torch.zeros_like(fed), fed,
                 fed_starts, rec["fed_total"])

    # gather: ri = order[pos]
    err = _exact("gather", J.gather_rows(order, pos),
                 J.gather_rows_plain(order, pos))
    report("gather", join_src, f"{join_ref}:234", err,
           lambda: J.gather_rows(order, pos),
           lambda: J.gather_rows_plain(order, pos),
           lambda: order[pos],
           8 * min(m, total) + 16 * total, 2 * total,
           f"M={m}, N={total}; library = order[pos]")

    # jaccard, on the adaptation round's workload bitmaps, per variant
    a = torch.from_numpy(np.ascontiguousarray(rec["bitmaps"], np.uint32)
                         .view(np.int32)).to(dev)
    jaccard_rows(rows, launches, a, "the main path's adaptation round",
                 floor_ms)
    return rows


# --------------------------------------------------------------------------- #
# phase 5: a small input, card against CPU
# --------------------------------------------------------------------------- #

def small_input() -> None:
    from repro_torch.api import KGService
    from repro_torch.graph import lubm

    ds = lubm.load(1, seed=0)
    runs = {}
    for device in ("cuda", "cpu"):
        svc = KGService.from_dataset(ds, n_shards=4, migration_budget=120_000,
                                     trace=True, device=device)
        svc.bootstrap(ds.base_workload())
        window = ds.extended_workload()
        out = [svc.query_batch(window)]
        svc.adapt(ds.workload([f"EQ{i}" for i in range(1, 11)]))
        while svc.session is not None:
            out.append(svc.query_batch(window))
        runs[device] = (svc, out)
    (gpu, gpu_out), (cpu, cpu_out) = runs["cuda"], runs["cpu"]
    assert gpu.tracer().to_json() == cpu.tracer().to_json()
    assert np.array_equal(gpu.kg.state.feature_to_shard,
                          cpu.kg.state.feature_to_shard)
    assert len(gpu_out) == len(cpu_out) >= 4
    for gw, cw in zip(gpu_out, cpu_out):
        for (b, s), (rb, rs) in zip(gw, cw):
            assert np.array_equal(canon(b), canon(rb))
            assert np.isfinite(s.modeled_time())
    log(f"[small] LUBM(1)/4 drain loop: card and CPU give identical traces, "
        f"{len(gpu_out)} windows and final layouts")


# --------------------------------------------------------------------------- #
# phase 6: the paper's experiments, held against the numpy executor
# --------------------------------------------------------------------------- #

KG_KERNELS = ("pack", "probe", "expand", "gather", "jaccard")


def _timed_adapt(svc, walls):
    """Wrap ``svc.adapt`` so each round's wall time lands in ``walls``."""
    adapt = svc.adapt

    def timed(*args, **kwargs):
        t = time.perf_counter()
        report = adapt(*args, **kwargs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        return report
    svc.adapt = timed


def _experiment(serve, exp, executor, device):
    """One ``serve.experiment1|2`` on a fresh LUBM(10)/8 system; returns the
    result, its captured ``[exp]``/``[migrate]`` lines, the experiment's
    wall time and its adaptation rounds' wall times."""
    ds, svc = serve.build_system(10, 8, executor=executor, device=device,
                                 migration_budget=MIGRATION_BUDGET)
    rounds = []
    _timed_adapt(svc, rounds)
    run = serve.experiment1 if exp == 1 else serve.experiment2
    buf = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = run(ds, svc)
    torch.cuda.synchronize()
    return out, buf.getvalue().splitlines(), time.perf_counter() - t, rounds


def _same_experiment(exp, got, want) -> None:
    keys = (("initial", "adaptive") if exp == 1
            else ("t_initial", "t_adaptive"))
    for k in keys:
        assert got[k] == want[k], (exp, k)
    assert got["report"].accepted == want["report"].accepted, exp
    assert got["report"].plan.summary() == want["report"].plan.summary()
    assert np.array_equal(got["state"].feature_to_shard,
                          want["state"].feature_to_shard), exp


def paper_experiments(bitmaps) -> None:
    """``launch/serve.py``'s experiments 1 and 2 at LUBM(10)/8 on the card
    (torch executor), each against the same experiment on the numpy
    executor with the adaptation's Jaccard matrix on the CPU, then the CLI
    in a subprocess against the in-process run. ``bitmaps`` collects the
    workload bitmaps the rounds hand the Jaccard kernel (phase 8)."""
    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    for exp in (1, 2):
        tag = f"exp{exp}"
        bitmaps.phase = f"6/{tag}"
        _build.reset_launches()
        got, lines, wall, rounds = _experiment(serve, exp, "torch", "cuda")
        launches = dict(_build.launches)
        bitmaps.phase = None
        bitmaps.launches["6"].update(launches)
        want, want_lines, want_wall, want_rounds = _experiment(
            serve, exp, "numpy", "cpu")
        _same_experiment(exp, got, want)
        assert lines == want_lines, (lines, want_lines)
        for line in lines:
            log(f"[paper] {line}")
        times = got["initial"] if exp == 1 else {"biased": got["t_initial"]}
        log(f"[paper] {tag}: torch executor on the card: wall {wall:.3f} s,"
            f" adaptation rounds {[round(r, 3) for r in rounds]} s; numpy "
            f"executor: wall {want_wall:.3f} s, rounds "
            f"{[round(r, 3) for r in want_rounds]} s; {len(times)} modeled "
            "times, accept decision, plan and final layout equal; "
            f"{card()}")
        log(f"[paper] {tag} kernel launches: {launches}")
        for k in KG_KERNELS:
            assert launches.get(k, 0) > 0, f"{tag}: kernel {k} never launched"
        if exp == 1:
            exp1_lines = [ln for ln in lines if ln.startswith("[exp1]")]
        del got, want
    t = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--universities",
         "10", "--shards", "8", "--experiment", "1", "--executor", "torch",
         "--migration-budget", str(MIGRATION_BUDGET), "--show-federated"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert cli.returncode == 0, cli.stderr[-4000:]
    cli_lines = [ln for ln in cli.stdout.splitlines()
                 if ln.startswith("[exp1]")]
    assert cli_lines == exp1_lines and len(cli_lines) >= 4, cli.stdout
    log(f"[paper] CLI: {cli.stdout.splitlines()[0]}")
    fed = cli.stdout.split("Federated rewrite of Q9")[1].strip().splitlines()
    for line in fed[1:]:
        log(f"[paper] CLI rewrite: {line}")
    log(f"[paper] CLI (python -m repro_torch.launch.serve --experiment 1) "
        f"exit 0 in {time.perf_counter() - t:.1f} s, its [exp1] lines equal "
        f"the in-process run's; phase wall {time.perf_counter() - t_phase:.1f}"
        " s")


# --------------------------------------------------------------------------- #
# phase 7: a WatDiv drift scenario, held against the numpy executor
# --------------------------------------------------------------------------- #

# WatDiv at scale 640: about 10.0 M triples at the generator's 15.7 k
# triples a unit, the size of WatDiv's smallest published dataset (scale
# factor 100, 10 M triples), on 8 shards
WATDIV_SCALE = 640


def watdiv_drift(bitmaps) -> None:
    """``scenario.flash_crowd`` over WatDiv on 8 shards (AWAPart, 4 MiB
    migration budget): adaptive and frozen on the torch executor, each
    record for record against the numpy executor (Jaccard on the CPU); the
    streamed schedule against the synchronous replay; one window again
    under ``torch.profiler``."""
    from repro_torch import scenario as drift
    from repro_torch.api import KGService
    from repro_torch.graph import watdiv
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ds = watdiv.load(WATDIV_SCALE, seed=0)
    log(f"[watdiv] WatDiv({WATDIV_SCALE}): {ds.store.n_triples} triples, "
        f"{len(ds.queries)} templates, generated in "
        f"{time.perf_counter() - t:.2f} s")
    scn = drift.flash_crowd(ds)
    windows = scn.schedule(ds)

    def service(executor, device, walls=None, digests=None):
        t = time.perf_counter()
        svc = KGService.from_dataset(ds, 8, executor=executor, device=device,
                                     migration_budget=MIGRATION_BUDGET)
        svc.bootstrap(scn.bootstrap_workload(ds))
        torch.cuda.synchronize()
        boot = time.perf_counter() - t
        if walls is not None:
            batch = svc.query_batch

            def timed(queries):
                t = time.perf_counter()
                res = batch(queries)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
                if digests is not None:
                    digests.extend(_digest(b) for b, _ in res)
                return res
            svc.query_batch = timed
        return svc, boot

    runs = {}
    for adapt in (True, False):
        mode = "adaptive" if adapt else "frozen"
        walls, rounds, digests = [], [], []
        bitmaps.phase = f"7/{mode}"
        svc, boot = service("torch", "cuda", walls,
                            None if adapt else digests)
        _timed_adapt(svc, rounds)
        _build.reset_launches()
        t = time.perf_counter()
        rep = drift.run_scenario(svc, scn, ds, adapt=adapt, mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(_build.launches)
        bitmaps.phase = None
        bitmaps.launches["7"].update(launches)
        nsvc, _ = service("numpy", "cpu")
        t = time.perf_counter()
        want = drift.run_scenario(nsvc, scn, ds, adapt=adapt, mode=mode)
        numpy_wall = time.perf_counter() - t
        assert [dataclasses.astuple(w) for w in rep.windows] \
            == [dataclasses.astuple(w) for w in want.windows], mode
        assert [dataclasses.astuple(r) for r in rep.recoveries] \
            == [dataclasses.astuple(r) for r in want.recoveries], mode
        assert [dataclasses.astuple(r) for r in drift.reactivity(rep.windows)] \
            == [dataclasses.astuple(r)
                for r in drift.reactivity(want.windows)], mode
        assert np.array_equal(svc.kg.state.feature_to_shard,
                              nsvc.kg.state.feature_to_shard), mode
        log(f"[watdiv] flash_crowd {mode}: bootstrap {boot:.3f} s, "
            f"{len(rep.windows)} windows of {scn.queries_per_window} in "
            f"{wall:.3f} s on the card (numpy executor {numpy_wall:.3f} s), "
            "every WindowRecord and reactivity equal; window walls ms "
            f"{[round(w * 1e3, 1) for w in walls]}; adaptation rounds "
            f"{[round(r, 3) for r in rounds]} s; {card()}")
        counters = svc.metrics.snapshot()["counters"]
        log(f"[watdiv] {mode}: summary {rep.summary()}; adapted windows "
            f"{[w.index for w in rep.windows if w.adapted]}; epochs "
            f"{[w.epoch for w in rep.windows]}; window_ms "
            f"{[round(w.window_ms, 1) for w in rep.windows]}; executed "
            f"{counters.get('executor.queries', 0)} queries in "
            f"{counters.get('executor.batches', 0)} batches, "
            f"{counters.get('cache.result_hits', 0)} result-cache hits")
        log(f"[watdiv] {mode} kernel launches: {launches}")
        for k in KG_KERNELS if adapt else KG_KERNELS[:4]:
            assert launches.get(k, 0) > 0, f"{mode}: kernel {k} never launched"
        runs[mode] = (svc, digests)
        del nsvc, want
    # the streamed schedule against the synchronous (frozen) replay
    ssvc, _ = service("torch", "cuda")
    t = time.perf_counter()
    _, results = drift.stream_schedule(ssvc, windows,
                                       max_window=scn.queries_per_window)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t
    sync = runs["frozen"][1]
    assert [_digest(r.bindings) for r in results] == sync
    log(f"[watdiv] stream_schedule: {len(results)} queries in "
        f"{stream_s:.3f} s, bindings equal to the synchronous replay's")
    del ssvc, results
    svc = runs["adaptive"][0]
    profile_window(svc, windows[len(windows) // 2].queries, tag="watdiv")
    peak = torch.cuda.max_memory_allocated()
    store_b = ds.store.triples.nbytes
    log(f"[watdiv] peak device memory {peak / 2**30:.3f} GiB; the store, "
        f"{ds.store.n_triples} triples x 3 int32 = {store_b / 2**20:.1f} MiB,"
        " stays on the host: the card holds each window's matched columns "
        f"and join tensors; phase wall {time.perf_counter() - t_phase:.1f} "
        f"s; {card()}")
    del runs, svc


def _digest(bindings) -> tuple:
    c = canon(bindings)
    return c.shape, hashlib.sha256(c.tobytes()).hexdigest()


# --------------------------------------------------------------------------- #
# phase 8: HAC on the card, and Jaccard at the new paths' shapes
# --------------------------------------------------------------------------- #

def hac_and_jaccard(rows, bitmaps) -> None:
    """``hac_torch`` on the card against ``hac_numpy`` at the Jaccard
    distances of phases 6 and 7 and at a seeded 512 x 512 matrix, for
    every linkage; both Jaccard variants bitwise against the plain version
    at the largest bitmaps phases 6 and 7 gave it, each a row of ``rows``
    timed beside the launch floor and its bound; then the sweep."""
    from repro_torch.core import hac
    from repro_torch.kernels.jaccard import ops as jac

    dev = torch.device("cuda")
    mats = {}
    for phase, bm in bitmaps.calls:
        words = torch.from_numpy(np.ascontiguousarray(bm, np.uint32)
                                 .view(np.int32)).to(dev)
        key = (phase.split("/")[0], bm.shape, hashlib.sha256(
            np.ascontiguousarray(bm).tobytes()).hexdigest())
        mats.setdefault(key, (phase, words))
    rng = np.random.default_rng(0)
    rand = rng.random((512, 512)).astype(np.float32)
    rand = (rand + rand.T) / 2
    np.fill_diagonal(rand, 0)
    cases = [(f"Jaccard {phase} {tuple(w.shape)}",
              jac.distance(w, w).cpu().numpy())
             for phase, w in mats.values()]
    cases.append(("random 512 x 512 (seed 0)", rand))
    assert any(c.startswith("Jaccard 6/") for c, _ in cases)
    assert any(c.startswith("Jaccard 7/") for c, _ in cases)
    for what, d in cases:
        for linkage in ("single", "complete", "average"):
            z = hac.hac_torch(d, linkage, device=dev)
            assert z.device.type == "cuda"
            z = z.cpu().numpy()
            want = hac.hac_numpy(d.astype(np.float64), linkage)
            assert np.array_equal(z[:, [0, 1, 3]], want[:, [0, 1, 3]]), \
                (what, linkage)
            err = float(np.abs(z[:, 2] - want[:, 2]).max()) if len(z) else 0
            assert err <= 1e-5, (what, linkage, err)
            ms = device_ms(lambda: hac.hac_torch(d, linkage, device=dev),
                           reps=2)
            torch.cuda.synchronize()
            t = time.perf_counter()
            hac.hac_torch(d, linkage, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            log(f"[hac] {what}, {linkage}: Z columns 0, 1, 3 equal to "
                f"hac_numpy, distances within {err:.2e} (limit 1e-5); "
                f"device time per call {ms:.4f} ms over {len(z)} merges, "
                f"wall {wall * 1e3:.1f} ms; {card()}")
    one = torch.empty(1, dtype=torch.int64, device=dev)
    floor_ms = device_ms(lambda: one.fill_(1))
    for tag in ("6", "7"):
        phase, a = max(((p, w) for (t, _, _), (p, w) in mats.items()
                        if t == tag), key=lambda pw: pw[1].numel())
        jaccard_rows(rows, bitmaps.launches[tag], a,
                     f"largest bitmaps of phase {phase}", floor_ms)
    jaccard_sweep(floor_ms)


# the Jaccard kernel's two variants, and the sweep that sets the rule
JACCARD_SRC = "src/repro_torch/csrc/jaccard.cu"
JACCARD_REPLACES = "src/repro/kernels/jaccard/kernel.py:45"
JACCARD_VARIANTS = ("row", "tile")
# edges: (Q, K, W, a view's offset in words); Q off the tile, K != Q, W
# around the 64-word chunk and off a multiple of 4, an operand whose rows
# are not 16-byte aligned though W is a multiple of 4
JACCARD_EDGES = [(1, 1, 1, 0), (13, 13, 1, 0), (130, 130, 7, 0),
                 (33, 33, 64, 0), (9, 17, 2, 0), (21, 37, 3, 0),
                 (17, 5, 63, 0), (24, 24, 65, 0), (130, 9, 129, 0),
                 (64, 64, 64, 1), (40, 33, 8, 3), (5, 7, 0, 0)]
JACCARD_SWEEP_Q = (6, 24, 64, 128, 512, 1024)
JACCARD_SWEEP_W = (1, 2, 3, 8, 16, 32, 64, 65, 256)
JACCARD_RECT = (40, 300)        # the rectangular point at every W


def _bitmap_words(gen, q, w, offset=0):
    """(q, w) int32 bitmap words on the card (half the bits set), every
    fifth row empty and row 1 all ones, as a view ``offset`` words into its
    storage."""
    base = torch.randint(-2**31, 2**31, (q * w + offset,), dtype=torch.int32,
                         device="cuda", generator=gen)
    a = base[offset:].view(q, w)
    a[::5] = 0
    if q > 1:
        a[1] = -1
    return a


def _jaccard_bitwise(what, got, want) -> None:
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        f"jaccard {what}: kernel not bitwise equal to its plain version"


def jaccard_edges(rng) -> None:
    """Both Jaccard variants (through ``ops._run``) and the routed op,
    bitwise against the plain version at the edges, each launch counted
    under its variant."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.jaccard import ops as jac

    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(99)))
    for q, k, w, off in JACCARD_EDGES:
        a = _bitmap_words(gen, q, w, off)
        b = a if k == q else _bitmap_words(gen, k, w)
        assert a.data_ptr() % 16 == 4 * (off % 4)
        want = jac.distance_plain(a, b)
        for var in JACCARD_VARIANTS + (None,):
            before = dict(_build.launches)
            got = (jac.distance(a, b) if var is None
                   else jac._run(var, a, b))
            _jaccard_bitwise(f"{var or 'routed'} at {(q, k, w, off)}", got,
                             want)
            ran = var or jac.variant(q, k, w)
            assert _build.launches[f"jaccard.{ran}"] == \
                before.get(f"jaccard.{ran}", 0) + 1, (q, k, w, var)
    torch.cuda.synchronize()
    log(f"[kernels] Jaccard edges: row, tile and the routed op bitwise equal "
        f"to the plain version at {len(JACCARD_EDGES)} edges (Q, K, W, view "
        f"offset) {JACCARD_EDGES}")


def jaccard_cost(q, k, w):
    """Bytes (each word read once, each output written once) and popcounts
    (popc(a & b) per pair and word, and each row's count once)."""
    return 4 * (q + k) * w + 4 * q * k, q * k * w + (q + k) * w


def jaccard_rows(rows, launches, a, what, floor_ms) -> None:
    """Both Jaccard variants at the bitmaps ``a`` (against themselves, as
    every caller does) bitwise against the plain version, each timed as in
    phase 4 (``kernel_row``, its ``launches`` those of the run that met the
    shape) beside the launch floor and the bound from bytes and the
    card's popcount rate."""
    from repro_torch.kernels.jaccard import ops as jac

    q, w = a.shape
    want = jac.distance_plain(a, a)
    rate, rate_note = popc_rate()
    for var in JACCARD_VARIANTS:
        got = jac._run(var, a, a)
        _jaccard_bitwise(f"{var} at {what}", got, want)
        kernel_row(rows, launches, "jaccard", JACCARD_SRC, JACCARD_REPLACES,
                   float((got - want).abs().max()),
                   lambda: jac._run(var, a, a),
                   lambda: jac.distance_plain(a, a), None,
                   *jaccard_cost(q, q, w),
                   f"{var}, {what}, Q={q}, W={w}; the rule gives "
                   f"{jac.variant(q, q, w)}", ops_per_s=rate,
                   ops_rate=rate_note, variant=var)
        log(f"[jaccard] {var} at {what} (Q={q}, W={w}): {rows[-1]['ms']:.5f}"
            f" ms, {rows[-1]['ms'] / floor_ms:.2f} launch floors of "
            f"{floor_ms:.5f} ms (a one-element fill_); {card()}")


def jaccard_sweep(floor_ms) -> None:
    """Both variants at Q in ``JACCARD_SWEEP_Q`` (a = b) and at
    ``JACCARD_RECT`` for every W in ``JACCARD_SWEEP_W``, each bitwise
    against the plain version and timed in turns (row, tile, tile, row);
    whether ``ops.variant`` picks the faster within the spread of the two
    runs, and, for each W, the crossover."""
    from repro_torch.kernels.jaccard import ops as jac

    gen = torch.Generator(device="cuda").manual_seed(8)
    rate, rate_note = popc_rate()
    t0 = time.perf_counter()
    misses = []
    for w in JACCARD_SWEEP_W:
        faster = {}
        for q, k in [(q, q) for q in JACCARD_SWEEP_Q] + [JACCARD_RECT]:
            a = _bitmap_words(gen, q, w)
            b = a if k == q else _bitmap_words(gen, k, w)
            want = jac.distance_plain(a, b)
            for var in JACCARD_VARIANTS:
                _jaccard_bitwise(f"{var} at {(q, k, w)}", jac._run(var, a, b),
                                 want)
            del want
            got = collections.defaultdict(list)
            for var in ("row", "tile", "tile", "row"):
                got[var].append(device_ms(lambda: jac._run(var, a, b)))
                assert got[var][-1] > 0, (var, (q, k, w), "no device time")
            pick = jac.variant(q, k, w)
            other = "tile" if pick == "row" else "row"
            ok = min(got[pick]) <= max(got[other])
            best = min(JACCARD_VARIANTS, key=lambda v: min(got[v]))
            faster[(q, k)] = best
            if not ok:
                misses.append((q, k, w))
            n_bytes, n_popc = jaccard_cost(q, k, w)
            bound = max(n_bytes / HBM_BYTES_PER_S, n_popc / rate) * 1e3
            log(f"[jaccard-sweep] Q={q} K={k} W={w}: device ms per call in "
                "turns row " + ", ".join(f"{x:.5f}" for x in got["row"])
                + "; tile " + ", ".join(f"{x:.5f}" for x in got["tile"])
                + f"; the rule gives {pick}, the faster is {best}"
                f"{'' if ok else ' (MISS: beyond the spread)'}; bound "
                f"{bound:.6f} ms ({n_bytes} B / 3.35 TB/s, {n_popc} popc), "
                f"tile at {bound / min(got['tile']):.3f} of it; launch floor "
                f"{floor_ms:.5f}; {card()}")
        tiles = [q for (q, k), v in faster.items() if v == "tile" and q == k]
        log(f"[jaccard-sweep] W={w}: tile faster at Q in {tiles} (a = b), "
            f"at the rectangular {JACCARD_RECT}: {faster[JACCARD_RECT]}")
    log(f"[jaccard-sweep] {len(JACCARD_SWEEP_W) * (len(JACCARD_SWEEP_Q) + 1)}"
        f" points bitwise equal in both variants; the rule picks beyond the "
        f"spread at {misses or 'none'}; popcount rate {rate_note}; "
        f"{time.perf_counter() - t0:.1f} s; {card()}")


class BitmapLog:
    """The workload bitmaps each Jaccard call is handed while ``phase`` is
    set (the torch runs of phases 6 and 7)."""

    def __init__(self):
        self.phase = None
        self.calls = []
        # phase ("6", "7") -> the kernel launches of its torch runs
        self.launches = collections.defaultdict(collections.Counter)

    def install(self, jac_ops):
        jaccard = jac_ops.jaccard_distance

        def recording(bitmaps, **kw):
            if self.phase is not None:
                self.calls.append((self.phase, np.asarray(bitmaps)))
            return jaccard(bitmaps, **kw)
        jac_ops.jaccard_distance = recording
        return jaccard


# --------------------------------------------------------------------------- #
# phase 9: LM serving, qwen3-0.6b at full width and depth
# --------------------------------------------------------------------------- #

# 4 requests of 2048 prompt tokens, then 32 greedy decode steps against a
# 2080-slot cache. Cut from the repo's prefill_32k (32 x 32768) and
# decode_32k shapes: their KV cache, 112 KiB per token at qwen3-0.6b
# (28 layers x k and v x 8 heads x 128 x 2 B), would need about 120 GB
# for 32 x 32768 tokens, more than one card holds.
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
LM_CACHE = LM_PROMPT + LM_NEW
LM_TEACHER = 8          # teacher-forced positions of check (c)
# bf16 paths agree within this share of the larger logit magnitude: the
# flash path keeps scores and probabilities in float32, the plain path
# rounds both to bf16 (2^-9 relative each) in every one of 28 layers, and
# both round every activation and the head's inputs to bf16, so a logit of
# magnitude |z| carries a few bf16 steps (2^-8 |z| each) of difference
LM_BF16_REL = 2.0 ** -4
FLASH = "flash_attention_fwd"
FLASH_VARIANTS = ("tc", "scalar", "dec")
SSD = "mamba2_ssd"
WKV = "rwkv6_wkv"
# each kernel with more than one design: its variants (its ops.variant)
VARIANTS = {FLASH: FLASH_VARIANTS, SSD: ("tc", "rec"),
            WKV: ("tc", "rec", "dec")}


def variants(kernel, since=None) -> dict:
    """Launches of ``kernel`` by variant so far, or since the counts
    ``since``."""
    from repro_torch.kernels import _build

    now = {v: _build.launches[f"{kernel}.{v}"] for v in VARIANTS[kernel]}
    return now if since is None else {v: now[v] - since[v] for v in now}


def flash_variants(since=None) -> dict:
    return variants(FLASH, since)


def _distinct(counts) -> list:
    """The distinct dicts of a list of them, in first-seen order."""
    return [dict(c) for c in dict.fromkeys(tuple(c.items()) for c in counts)]


def _mem(tag, prefix="lm") -> None:
    log(f"[{prefix}] {tag}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
        f"memory_allocated {torch.cuda.memory_allocated() / 2**30:.3f} GiB")


def _close_bf16(what, got, want, prefix="lm") -> float:
    """max |got - want| <= LM_BF16_REL * max |want|; returns the error."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"[{prefix}] check {what}: max abs diff {err:.4f}, max |logit| "
        f"{scale:.4f}, ratio {err / scale:.5f} (limit {LM_BF16_REL})")
    assert torch.isfinite(got).all() and err <= LM_BF16_REL * scale, what
    return err


def _profile_idle(label, run, ref_wall, prefix, share_of=None) -> None:
    """The card's busy time and idle share over one call of ``run``
    (``torch.profiler``), against the unprofiled ``ref_wall`` too; with
    ``share_of``, the share of device time of the kernels whose name holds
    it. Returns the number of device operations."""
    prof = torch.profiler
    acts = [prof.ProfilerActivity.CPU, prof.ProfilerActivity.CUDA]
    for attempt in range(PROFILE_TRIES):   # an empty trace is taken again
        torch.cuda.synchronize()
        with prof.profile(activities=acts) as p:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        dev_ev = [e for e in p.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev_ev:
            break
        log(f"[profile] empty device trace (attempt {attempt + 1})")
    assert dev_ev, f"{label}: the profiler recorded no device work"
    busy = sum(e.device_time_total for e in dev_ev) / 1e6
    by_name = {}
    for e in dev_ev:
        n, t_us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t_us + e.device_time_total)
    log(f"[{prefix}] profile {label}: wall {wall * 1e3:.3f} ms under the "
        f"profiler, device busy {busy * 1e3:.3f} ms, idle share "
        f"{1 - busy / wall:.4f}; against the unprofiled wall "
        f"{ref_wall * 1e3:.3f} ms: idle share {1 - busy / ref_wall:.4f}; "
        f"{len(dev_ev)} device operations")
    for name, (n, t_us) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][1])[:8]:
        log(f"[{prefix}]   {t_us / 1e3:9.3f} ms  {n:5d}x  {name[:90]}")
    if share_of is not None:
        mine = sum(t_us for name, (_, t_us) in by_name.items()
                   if share_of in name) / 1e6
        log(f"[{prefix}] {label}: kernels named '{share_of}' take "
            f"{mine * 1e3:.3f} ms, {mine / busy:.4f} of the device time")
    return len(dev_ev)


def _copy_caches(pre, big, n):
    """Prefill caches (k/v sized n) into decode caches: the states as they
    are, the first n K/V slots."""
    for key in big:
        if key in "kv":
            big[key][:, :, :n] = pre[key]
        else:
            big[key].copy_(pre[key])
    return big


def _fill_cache(cfg, caches, n, dev, transformer):
    return _copy_caches(caches, transformer.init_decode_caches(
        cfg, LM_BATCH, LM_CACHE, device=dev), n)


def lm_serving():
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import lm, transformer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("qwen3-0.6b"), use_flash=True)
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = lm.init_params(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[lm] {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model},"
        f" {cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, "
        f"ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n_params} parameters in "
        f"{cfg.compute_dtype}, random (seed 0), built in "
        f"{time.perf_counter() - t:.2f} s")
    _mem("weights")
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    lm.prefill_step(model, batch, cfg)      # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    # the main path: one prefill, 32 greedy decode steps
    _build.reset_launches()
    t = time.perf_counter()
    logits, caches = lm.prefill_step(model, batch, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    n_prefill = _build.launches[FLASH]
    prefill_var = flash_variants()
    _mem("prefill")
    prefill_logits = logits
    caches = _fill_cache(cfg, caches, LM_PROMPT, dev, transformer)
    torch.cuda.synchronize()
    tok = logits.argmax(-1)
    first_tok, per_step, step_var, out = tok, [], [], []
    t = time.perf_counter()
    for i in range(LM_NEW):
        before, before_var = _build.launches[FLASH], flash_variants()
        last_tok = tok
        logits, caches = lm.decode_step(
            model, caches, {"token": tok, "pos": LM_PROMPT + i}, cfg)
        per_step.append(_build.launches[FLASH] - before)
        step_var.append(flash_variants(before_var))
        if i == 0:
            first_logits = logits
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    launches = dict(_build.launches)
    _mem("decode")
    generated = torch.stack(out, 1)
    assert generated.shape == (LM_BATCH, LM_NEW)
    assert torch.isfinite(logits).all()
    tokens = LM_BATCH * LM_PROMPT
    log(f"[lm] prefill {LM_BATCH} x {LM_PROMPT} tokens: wall "
        f"{prefill_s * 1e3:.1f} ms, {tokens / prefill_s:.0f} tokens/s; "
        f"{card()}")
    log(f"[lm] decode {LM_NEW} steps x {LM_BATCH} sequences: wall "
        f"{decode_s * 1e3:.1f} ms, {decode_s / LM_NEW * 1e3:.3f} ms per "
        f"step, {LM_BATCH * LM_NEW / decode_s:.1f} tokens/s; {card()}")
    log(f"[lm] flash launches: prefill {n_prefill}, per decode step "
        f"{sorted(set(per_step))}, total {launches.get(FLASH, 0)}")
    log(f"[lm] flash variants: prefill {prefill_var}, decode steps "
        f"{_distinct(step_var)}")
    # (a) one flash launch per layer per step: the prefill's on the tensor
    # cores, each decode step's on the dec kernel
    assert n_prefill == cfg.n_layers, n_prefill
    assert per_step == [cfg.n_layers] * LM_NEW, per_step
    assert prefill_var == dict(tc=cfg.n_layers, scalar=0, dec=0), \
        prefill_var
    assert step_var == [dict(tc=0, scalar=0, dec=cfg.n_layers)] * LM_NEW, \
        step_var

    # the card's busy and idle share over one decode step (the last step
    # again: it rewrites slot 2079 with the same token's k/v) and a prefill
    _profile_idle("decode step", lambda: lm.decode_step(
        model, caches, {"token": last_tok, "pos": LM_CACHE - 1}, cfg),
        decode_s / LM_NEW, "lm")
    _profile_idle("prefill", lambda: lm.prefill_step(model, batch, cfg),
                  prefill_s, "lm")

    # (b) the plain attention path on the same requests
    plain_logits, plain_caches = lm.prefill_step(model, batch, plain_cfg)
    _close_bf16("(b) prefill, flash vs plain", prefill_logits, plain_logits)
    plain_caches = _fill_cache(plain_cfg, plain_caches, LM_PROMPT, dev,
                               transformer)
    plain_first, _ = lm.decode_step(model, plain_caches,
                                    {"token": first_tok, "pos": LM_PROMPT},
                                    plain_cfg)
    _close_bf16("(b) first decode step, flash vs plain", first_logits,
                plain_first)
    del plain_caches
    _mem("check (b)")

    # (c) teacher-forced decode of the last 8 prompt positions after
    # prefilling the rest, against the uncached forward at those positions
    cut = LM_PROMPT - LM_TEACHER
    x, _ = transformer.hidden(model, prompts, cfg)
    want = transformer.lm_head(model, x[:, cut:], cfg)
    del x
    _, tf_caches = lm.prefill_step(model, {"tokens": prompts[:, :cut]}, cfg)
    tf_caches = _fill_cache(cfg, tf_caches, cut, dev, transformer)
    got = []
    for pos in range(cut, LM_PROMPT):
        lg, tf_caches = lm.decode_step(
            model, tf_caches, {"token": prompts[:, pos], "pos": pos}, cfg)
        got.append(lg)
    _close_bf16("(c) teacher-forced decode vs forward",
                torch.stack(got, 1), want)
    del tf_caches
    _mem("check (c)")

    # (d) the reduced config in float32, on the card and on the CPU
    small = dataclasses.replace(configs.get("qwen3-0.6b").reduced(),
                                use_flash=True)
    res = {}
    before_var = flash_variants()
    for device in ("cuda", "cpu"):
        m = lm.init_params(small, device="cpu").to(device)
        toks = prompts[:, :24].remainder(small.vocab_size).to(device)
        lg, c = lm.prefill_step(m, {"tokens": toks[:, :16]}, small)
        big = transformer.init_decode_caches(small, LM_BATCH, 24,
                                             device=device)
        for key in "kv":
            big[key][:, :, :16] = c[key]
        seq = [lg]
        for pos in range(16, 24):
            lg, big = lm.decode_step(m, big, {"token": toks[:, pos],
                                              "pos": pos}, small)
            seq.append(lg)
        res[device] = torch.stack(seq).cpu()
    err_d = float((res["cuda"] - res["cpu"]).abs().max())
    d_var = flash_variants(before_var)
    log(f"[lm] check (d) reduced qwen3-0.6b in float32, prefill + 8 decode "
        f"steps, card vs CPU: max abs diff {err_d:.3e} (limit 1e-4); flash "
        f"variants {d_var}")
    assert err_d <= 1e-4
    # the prefill's layers on the variant its 16 rows a kv head give, each
    # decode step's on "dec"
    want = collections.Counter({v_: 0 for v_ in FLASH_VARIANTS})
    g, hd = small.n_heads // small.n_kv_heads, small.resolved_head_dim
    want[FA.variant(torch.float32, 16, g, hd)] += small.n_layers
    want[FA.variant(torch.float32, 1, g, hd)] += 8 * small.n_layers
    assert d_var == dict(want), (d_var, want)
    return launches


# --------------------------------------------------------------------------- #
# phase 10: the flash kernel against its plain version
# --------------------------------------------------------------------------- #

# (B, S, T, H, K, D, causal, q_offset, kv_valid_len, dtype, variant): S and
# T off the 32- and 64-key tiles, g = 1, 2, 3, 5, non-causal,
# kv_valid_len < T, q_offset > 0 with S < T, D = 32, 64, 80, 112, 128,
# 256, S * g at 16, 17, 63, 64 and just over, float32 inputs, grids of
# fewer blocks than SMs (the scalar kernel then splits the keys), and the
# variant each must run
BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16
FLASH_EDGES = [
    (2, 77, 77, 16, 8, 128, True, 0, None, BF16, "tc"),
    (1, 130, 130, 4, 4, 64, True, 0, None, BF16, "tc"),
    (2, 33, 45, 6, 2, 112, False, 0, None, BF16, "tc"),
    (2, 100, 300, 15, 5, 64, True, 200, None, BF16, "tc"),
    (1, 33, 70, 4, 2, 64, True, 37, None, BF16, "tc"),
    (2, 65, 130, 10, 2, 80, True, 65, None, BF16, "tc"),
    (1, 200, 333, 6, 2, 128, True, 100, 290, BF16, "tc"),
    (2, 100, 100, 8, 8, 112, True, 0, None, BF16, "tc"),
    (1, 300, 300, 4, 2, 32, False, 0, 257, BF16, "tc"),
    (1, 256, 256, 2, 1, 128, True, 0, None, BF16, "tc"),
    (2, 2100, 2100, 4, 4, 112, True, 0, 2050, BF16, "tc"),
    (1, 64, 64, 1, 1, 64, True, 0, None, BF16, "tc"),
    (1, 63, 63, 1, 1, 64, True, 0, None, BF16, "scalar"),
    (2, 1, 200, 4, 2, 128, True, 150, 151, BF16, "dec"),
    (1, 5, 97, 5, 5, 80, True, 60, 65, F32, "dec"),
    (1, 40, 40, 2, 1, 256, True, 0, 23, F32, "scalar"),
    (3, 64, 64, 16, 8, 128, False, 0, 50, F32, "scalar"),
    (2, 3, 1000, 4, 2, 64, True, 990, 993, BF16, "dec"),
    (1, 2, 700, 2, 2, 80, False, 0, 650, F32, "dec"),
    (2, 77, 77, 4, 2, 128, True, 0, None, F16, "scalar"),
    (1, 17, 100, 1, 1, 64, True, 83, None, BF16, "scalar"),
    (1, 1, 300, 17, 1, 64, True, 299, 300, F16, "scalar"),
]
# (B, S, T, H, K, D, causal, q_offset, kv_valid_len) through "dec", each in
# all three dtypes: kv_valid_len = 1 (every other key, warp and split of
# the row sees no valid key), a split all masked for row 0 (query 63
# against keys 64 to 78), kv_len one key past two tiles and a split,
# qwen3-0.6b's decode shape, g = 1, 2, 3, 5, 8, 12, S * g from 1 to 16
# with S up to 16 under causal masks with q_offset > 0, D = 8, 32, 64, 80,
# 96, 112, 128 and 256, non-causal with kv_valid_len < T
FLASH_DEC_EDGES = [
    (2, 1, 300, 4, 2, 64, True, 299, 1),
    (1, 16, 200, 1, 1, 64, True, 63, None),
    (1, 1, 129, 2, 2, 128, True, 128, 129),
    (4, 1, 2080, 16, 8, 128, True, 2079, 2080),
    (2, 1, 2080, 8, 8, 112, True, 2079, 2080),
    (1, 1, 400, 12, 1, 128, True, 399, 400),
    (1, 2, 300, 16, 2, 64, True, 250, 252),
    (2, 16, 90, 2, 2, 32, True, 70, 86),
    (1, 8, 333, 4, 2, 256, True, 300, 308),
    (3, 1, 2080, 4, 4, 8, True, 2079, 2080),
    (2, 5, 150, 3, 1, 80, False, 0, 140),
    (1, 1, 1000, 5, 1, 128, True, 999, 1000),
    (1, 3, 65, 6, 2, 96, True, 62, None),
    (1, 4, 2000, 4, 4, 256, True, 1500, 1504),
]
FLASH_EDGES += [e + (dt, "dec") for e in FLASH_DEC_EDGES
                for dt in (F32, BF16, F16)]
FLASH_SRC = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:83"


def _flash_err(got, want) -> float:
    """Kernel against plain version, both in the inputs' dtype: 1e-5
    absolute (the same float32 sums in another order), plus for bf16 one
    bf16 step, 2^-7 relative, and for float16 one float16 step, 2^-10
    relative, where the two float32 results fall on either side of a
    rounding boundary. Returns the max abs difference."""
    assert got.dtype == want.dtype and got.shape == want.shape
    step = {torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}.get(got.dtype, 0.0)
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    assert bool((diff <= 1e-5 + step * want.abs()).all()), float(diff.max())
    return float(diff.max())


def _flash_rand(gen):
    def rand(shape, dt=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dt)
    return rand


def flash_prefill_row(rows, launches, rand, what, b, s, h, kh, d):
    """The flash kernel at a bf16 causal prefill shape against its plain
    version, timed beside ``scaled_dot_product_attention``; one row of
    ``rows`` with the main path's launches of the variant it runs."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as FA

    q, k, v = rand((b, s, h, d)), rand((b, s, kh, d)), rand((b, s, kh, d))
    var = FA.variant(q.dtype, s, h // kh, d)
    before = flash_variants()
    got = FA.flash_attention(q, k, v)
    assert flash_variants(before)[var] == 1 and var == "tc", var
    err = _flash_err(got, FA.flash_attention_plain(q, k, v))
    lib = lambda: F.scaled_dot_product_attention(    # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    lib_err = float((lib().transpose(1, 2).float() - got.float()).abs().max())
    pairs = s * (s + 1) // 2                 # valid (query, key) pairs
    kernel_row(rows, launches, FLASH, FLASH_SRC, FLASH_REPLACES, err,
               lambda: FA.flash_attention(q, k, v),
               lambda: FA.flash_attention_plain(q, k, v), lib,
               2 * (2 * q.numel() + 2 * k.numel()), 4 * b * h * d * pairs,
               f"{what} prefill B={b}, S=T={s}, H={h}, K={kh}, D={d}, bf16, "
               f"causal, kernel {var}; library = scaled_dot_product_"
               f"attention(enable_gqa), max diff to it {lib_err:.4f}",
               ops_per_s=TENSOR_OPS_PER_S, ops_rate="989 TFLOP/s bf16",
               variant=var)


def flash_kernel(rows, launches):
    from repro_torch.kernels.flash_attention import ops as FA

    rand = _flash_rand(torch.Generator(device="cuda").manual_seed(2))
    for b, s, t, h, kh, d, causal, off, valid, dt, var in FLASH_EDGES:
        q, k, v = rand((b, s, h, d), dt), rand((b, t, kh, d), dt), \
            rand((b, t, kh, d), dt)
        kw = dict(causal=causal, q_offset=off, kv_valid_len=valid)
        before = flash_variants()
        got = FA.flash_attention(q, k, v, **kw)
        ran = flash_variants(before)
        assert ran == {v_: int(v_ == var) for v_ in FLASH_VARIANTS}, \
            ((b, s, t, h, kh, d), var, ran)
        assert got.dtype == dt and got.shape == q.shape
        _flash_err(got, FA.flash_attention_plain(q, k, v, **kw))
    torch.cuda.synchronize()
    n_var = {v_: sum(e[-1] == v_ for e in FLASH_EDGES)
             for v_ in FLASH_VARIANTS}
    n_f16 = sum(e[-2] == F16 for e in FLASH_EDGES)
    log(f"[kernels] flash edge cases: {len(FLASH_EDGES)} shapes match the "
        f"plain version, each through its variant ({n_var}, {n_f16} of "
        "them float16)")

    b, s, h, kh, d = LM_BATCH, LM_PROMPT, 16, 8, 128
    flash_prefill_row(rows, launches, rand, "qwen3-0.6b", b, s, h, kh, d)
    flash_decode_row(rows, launches, rand, "qwen3-0.6b", b, h, kh, d,
                     LM_CACHE)


def flash_decode_row(rows, launches, rand, what, b, h, kh, d, valid):
    """The flash kernel at a bf16 decode step against ``valid`` cache slots,
    against its plain version, timed beside ``scaled_dot_product_attention``
    warm and L2-cold; one row of ``rows`` with the main path's launches of
    the variant it runs."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as FA

    qd, kd, vd = rand((b, 1, h, d)), rand((b, valid, kh, d)), \
        rand((b, valid, kh, d))
    kw = dict(causal=True, q_offset=valid - 1, kv_valid_len=valid)
    var = FA.variant(qd.dtype, 1, h // kh, d)
    got = FA.flash_attention(qd, kd, vd, **kw)
    err = _flash_err(got, FA.flash_attention_plain(qd, kd, vd, **kw))

    def lib_of(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True)

    lib_err = float((lib_of(qd, kd, vd).transpose(1, 2).float()
                     - got.float()).abs().max())
    kernel_row(rows, launches, FLASH, FLASH_SRC, FLASH_REPLACES, err,
               lambda: FA.flash_attention(qd, kd, vd, **kw),
               lambda: FA.flash_attention_plain(qd, kd, vd, **kw),
               lambda: lib_of(qd, kd, vd),
               2 * (2 * qd.numel() + 2 * kd.numel()),
               4 * b * h * d * valid,
               f"{what} decode B={b}, S=1, H={h}, K={kh}, D={d}, T={valid}, "
               f"q_offset={valid - 1}, "
               f"kv_valid_len={valid}, bf16, kernel {var}; library = "
               f"scaled_dot_product_attention(enable_gqa), max diff to it "
               f"{lib_err:.4f}",
               ops_per_s=TENSOR_OPS_PER_S, ops_rate="989 TFLOP/s bf16",
               variant=var)
    # the same decode call L2-cold, as a decode step finds its layer's
    # cache (the other layers' caches pass between two reads): five input
    # sets in turn, 170 MB (qwen3-0.6b) or 300 MB (zamba2-7b) against the
    # card's 50 MB L2
    sets = [(qd, kd, vd)] + [(rand((b, 1, h, d)), rand((b, valid, kh, d)),
                              rand((b, valid, kh, d))) for _ in range(4)]
    turn = itertools.cycle(sets)
    cold = device_ms(lambda: FA.flash_attention(*next(turn), **kw))
    cold_lib = device_ms(lambda: lib_of(*next(turn)))
    log(f"[kernels] {FLASH} {what} decode B={b}, S=1, H={h}, K={kh}, "
        f"D={d}, T={valid}, kernel {var}, "
        f"{len(sets)} input sets in turn (L2-cold): device time per call: "
        f"kernel {cold:.4f} ms, library {cold_lib:.4f} ms "
        f"(scaled_dot_product_attention(enable_gqa)); {card()}")
    # the scalar kernel, which ran the decode steps before "dec", at the
    # same shape through its own launcher (the keys split as it split
    # them), warm and L2-cold
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    scalar = functools.partial(
        _flash_split, "scalar",
        splits=FA.kv_splits(b, 1, h, kh, valid, n_sms), **kw)
    err_s = _flash_err(scalar(qd, kd, vd),
                       FA.flash_attention_plain(qd, kd, vd, **kw))
    warm_s = device_ms(lambda: scalar(qd, kd, vd))
    cold_s = device_ms(lambda: scalar(*next(turn)))
    log(f"[kernels] {FLASH} {what} decode, the scalar kernel through "
        f"rt_flash_attention_fwd at the same shape: device time per call "
        f"{warm_s:.4f} ms warm, {cold_s:.4f} ms L2-cold (dec: "
        f"{rows[-1]['ms']:.4f} warm, {cold:.4f} L2-cold), max_abs_err "
        f"{err_s}; {card()}")
    # the dec kernel at other split counts than ops.dec_splits gives, each
    # held to the plain version (readings: the count stays a rule of shape)
    formula = FA.dec_splits(b, kh, valid, n_sms)
    sweep = []
    for chunk in (64, 128, 256, 448, 704, 1088, -(-valid // 64) * 64):
        splits = -(-valid // chunk)
        dec = functools.partial(_flash_split, "dec", splits=splits,
                                chunk=chunk, **kw)
        _flash_err(dec(qd, kd, vd),
                   FA.flash_attention_plain(qd, kd, vd, **kw))
        sweep.append(f"{splits} x {chunk} keys ({b * kh * splits} blocks) "
                     f"{device_ms(lambda: dec(qd, kd, vd)):.4f}")
    log(f"[kernels] {FLASH} {what} decode, dec at other split counts "
        f"(warm device ms per call, kernel and merge; ops.dec_splits gives "
        f"{formula[0]} x {formula[1]}): {'; '.join(sweep)}; {card()}")


def _flash_split(var, q, k, v, splits, chunk=None, *, causal, q_offset,
                 kv_valid_len):
    """The scalar (``rt_flash_attention_fwd``) or dec
    (``rt_flash_attention_dec``, ``chunk`` keys a split) flash kernel with
    ``splits`` blocks along each (sequence, kv head), whatever
    ``flash_attention`` would route the call to or split it into."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as FA

    b, s, h, d = q.shape
    tk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    scratch = (torch.empty(b * kh * splits * s * (h // kh) * (d + 2),
                           dtype=torch.float32, device=q.device)
               if splits > 1 else None)
    entry, split_args = (("rt_flash_attention_fwd", (splits,))
                         if var == "scalar" else
                         ("rt_flash_attention_dec", (splits, chunk)))
    _build.launch(FLASH, entry, q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, s, tk, h, kh, d,
                  int(causal), q_offset, kv_valid_len,
                  FA._DTYPE_CODES[q.dtype], *split_args,
                  None if scratch is None else scratch.data_ptr(),
                  variant=var)
    return out


# --------------------------------------------------------------------------- #
# phase 11: rwkv6-3b serving at full width and depth
# --------------------------------------------------------------------------- #

# 4 requests of 2048 prompt tokens, then 32 greedy decode steps. Cut from
# the repo's prefill_32k shape (32 x 32768): at rwkv6-3b one layer's float32
# time mix over 2^20 tokens holds a dozen (2^20, 2560) activations of
# 10.7 GB and the (2^20, 5, 2560) ddlerp mix of 54 GB at once, more than
# the card's 80 GB (the prefill is not chunked, as the reference's is not),
# and its matrix products are about 2 PFLOP of float32. The states do not
# grow with the sequence: 0.66 MB of WKV state per sequence and layer.
RWKV_BATCH, RWKV_PROMPT, RWKV_NEW = 4, 2048, 32
RWKV_TEACHER = 64       # positions of check (c), decoded from the zero state
# check (c) in float32: decode and forward sum the same float32 products in
# other orders (cuBLAS picks other kernels for 4 rows than for 256), about
# 2^-18 relative over 2560 to 8960 terms; the random stack amplifies a
# relative change of its activations by up to about 2^9 at its first
# positions (bf16 rounding, 2^-9, moves them by up to about 0.8 of the
# largest logit, which this phase prints), so about 2^-9 of the largest
# logit, and the limit leaves a factor 8 above that. Not in bf16: at 32
# layers bf16 rounding alone takes the reference's own teacher-forced
# decode past 2^-4 of its forward (tests/test_torch_rwkv_bf16.py)
RWKV_F32_REL = 2.0 ** -6


def _teacher_forced(model, cfg, prompts, transformer, lm):
    """(forward logits, decode logits) of the first RWKV_TEACHER prompt
    positions: the uncached forward, and one decode step per position from
    the zero state with the prompt's own tokens."""
    x, _ = transformer.hidden(model, prompts[:, :RWKV_TEACHER], cfg)
    want = transformer.lm_head(model, x, cfg)
    del x
    caches = transformer.init_decode_caches(cfg, RWKV_BATCH, 0,
                                            device=prompts.device)
    got = []
    for pos in range(RWKV_TEACHER):
        lg, caches = lm.decode_step(model, caches, {"token": prompts[:, pos],
                                                    "pos": pos}, cfg)
        got.append(lg)
    return want, torch.stack(got, 1)


def _rel_by_position(got, want) -> str:
    """max |got - want| over the largest |want|, overall and at positions
    0, 1, 7 and the last."""
    scale = float(want.abs().max())
    by_pos = (got - want).abs().amax(dim=(0, 2)) / scale
    picks = ", ".join(f"{i}: {float(by_pos[i]):.4f}"
                      for i in (0, 1, 7, len(by_pos) - 1))
    return f"ratio {float(by_pos.max()):.4f} (by position {picks})"


def rwkv_serving():
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import lm, transformer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # the time mix is float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("rwkv6-3b"), use_flash=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = lm.init_params(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    by_dtype = {}
    for prm in model.parameters():
        by_dtype[str(prm.dtype)] = by_dtype.get(str(prm.dtype), 0) \
            + prm.numel()
    log(f"[rwkv] {cfg.arch_id}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} heads x "
        f"{cfg.rwkv_head_dim}, ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{sum(by_dtype.values())} parameters counted from the tensors "
        f"({by_dtype}; the time mix float32, the rest {cfg.compute_dtype}), "
        f"random (seed 0), built in {time.perf_counter() - t:.2f} s")
    _mem("weights", "rwkv")
    prompts = torch.randint(0, cfg.vocab_size, (RWKV_BATCH, RWKV_PROMPT),
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    lm.prefill_step(model, batch, cfg)      # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    # the main path: one prefill, 32 greedy decode steps
    _build.reset_launches()
    t = time.perf_counter()
    logits, caches = lm.prefill_step(model, batch, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    n_prefill = _build.launches[WKV]
    prefill_vars = variants(WKV)
    _mem("prefill", "rwkv")
    tok = logits.argmax(-1)
    first_tok, per_step, step_vars, out = tok, [], [], []
    t = time.perf_counter()
    for i in range(RWKV_NEW):
        before, before_vars = _build.launches[WKV], variants(WKV)
        logits, caches = lm.decode_step(
            model, caches, {"token": tok, "pos": RWKV_PROMPT + i}, cfg)
        per_step.append(_build.launches[WKV] - before)
        step_vars.append(variants(WKV, before_vars))
        if i == 0:
            first_logits = logits
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    launches = dict(_build.launches)
    _mem("decode", "rwkv")
    generated = torch.stack(out, 1)
    assert generated.shape == (RWKV_BATCH, RWKV_NEW)
    assert torch.isfinite(logits).all()
    assert all(bool(torch.isfinite(c).all()) for c in caches.values())
    tokens = RWKV_BATCH * RWKV_PROMPT
    log(f"[rwkv] prefill {RWKV_BATCH} x {RWKV_PROMPT} tokens: wall "
        f"{prefill_s * 1e3:.1f} ms, {tokens / prefill_s:.0f} tokens/s; "
        f"{card()}")
    log(f"[rwkv] decode {RWKV_NEW} steps x {RWKV_BATCH} sequences: wall "
        f"{decode_s * 1e3:.1f} ms, {decode_s / RWKV_NEW * 1e3:.3f} ms per "
        f"step, {RWKV_BATCH * RWKV_NEW / decode_s:.1f} tokens/s; {card()}")
    log(f"[rwkv] WKV launches: prefill {n_prefill}, per decode step "
        f"{sorted(set(per_step))}, total {launches.get(WKV, 0)}; by "
        f"variant: prefill {prefill_vars}, decode steps "
        f"{_distinct(step_vars)}")
    # (a) one WKV launch per layer in the prefill, all "tc", and in every
    # decode step, all "dec"
    assert n_prefill == cfg.n_layers, n_prefill
    assert per_step == [cfg.n_layers] * RWKV_NEW, per_step
    assert prefill_vars == dict(tc=cfg.n_layers, rec=0, dec=0), prefill_vars
    assert step_vars == [dict(tc=0, rec=0, dec=cfg.n_layers)] * RWKV_NEW, \
        _distinct(step_vars)

    # the card's busy and idle share over one decode step (one more step of
    # the last token) and one prefill, and the WKV kernel's share of it
    _profile_idle("decode step", lambda: lm.decode_step(
        model, caches, {"token": tok, "pos": RWKV_PROMPT + RWKV_NEW}, cfg),
        decode_s / RWKV_NEW, "rwkv", share_of="wkv")
    _profile_idle("prefill", lambda: lm.prefill_step(model, batch, cfg),
                  prefill_s, "rwkv", share_of="wkv")
    del caches

    # (e) state handoff: the prefill's states plus one decode step give the
    # logits of a prefill one token longer (2049 tokens: a ragged chunk)
    longer = torch.cat([prompts, first_tok[:, None].to(prompts.dtype)], 1)
    want, _ = lm.prefill_step(model, {"tokens": longer}, cfg)
    _close_bf16("(e) prefill(S) + one decode step vs prefill(S + 1)",
                first_logits, want, "rwkv")
    _mem("check (e)", "rwkv")

    # (c) teacher-forced decode of the first 64 prompt tokens from the zero
    # state against the uncached forward at every position, in float32 at
    # full width and depth (the same weights). In bf16 the random stack
    # answers rounding alone with differences beyond any bf16 limit at its
    # first positions; both bf16 numbers are printed, neither is a check.
    fwd16, dec16 = _teacher_forced(model, cfg, prompts, transformer, lm)
    log(f"[rwkv] bf16 teacher-forced decode of {RWKV_TEACHER} positions vs "
        f"forward: {_rel_by_position(dec16, fwd16)} (not a check)")
    del model, dec16
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = lm.init_params(cfg32, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    fwd32, dec32 = _teacher_forced(model, cfg32, prompts, transformer, lm)
    log(f"[rwkv] bf16 forward vs float32 forward, the stack's answer to "
        f"bf16 rounding: {_rel_by_position(fwd16, fwd32)} (not a check)")
    err = float((dec32 - fwd32).abs().max())
    scale = float(fwd32.abs().max())
    log(f"[rwkv] check (c) float32 teacher-forced decode of {RWKV_TEACHER} "
        f"positions vs forward: max abs diff {err:.6f}, max |logit| "
        f"{scale:.4f}, ratio {err / scale:.6f} (limit {RWKV_F32_REL}); by "
        f"position {_rel_by_position(dec32, fwd32)}")
    assert torch.isfinite(dec32).all() and err <= RWKV_F32_REL * scale
    del model, fwd16, fwd32, dec32
    torch.cuda.empty_cache()
    _mem("check (c)", "rwkv")

    # (d) the reduced config in float32, on the card and on the CPU:
    # logits of a prefill and 8 decode steps, and the final states
    small = dataclasses.replace(configs.get("rwkv6-3b").reduced(),
                                use_flash=True)
    res = {}
    for device in ("cuda", "cpu"):
        m = lm.init_params(small, device="cpu").to(device)
        toks = prompts[:, :24].remainder(small.vocab_size).to(device)
        lg, c = lm.prefill_step(m, {"tokens": toks[:, :16]}, small)
        seq = [lg]
        for pos in range(16, 24):
            lg, c = lm.decode_step(m, c, {"token": toks[:, pos],
                                          "pos": pos}, small)
            seq.append(lg)
        res[device] = [torch.stack(seq).cpu()] + [c[k].cpu()
                                                  for k in sorted(c)]
    err_d = max(float((g - w).abs().max())
                for g, w in zip(res["cuda"], res["cpu"]))
    log(f"[rwkv] check (d) reduced rwkv6-3b in float32, prefill + 8 decode "
        f"steps (logits and states), card vs CPU: max abs diff {err_d:.3e} "
        f"(limit 1e-4)")
    assert err_d <= 1e-4
    return launches


# --------------------------------------------------------------------------- #
# phase 12: the WKV kernel against its plain version
# --------------------------------------------------------------------------- #

# (B, S, H, hd, decay, s0 scale, variant): S = 2 and 63 (the recurrence),
# 64, 65, 100, 300 and 2049 (one chunk of the tc kernel, one and a step,
# ragged ones, 32 chunks and one of a step), hd 16, 32 and 128 on both
# sides of 64 steps, strong decay (w about 0.03) and w = 0 every third
# step, nonzero s0, grids under one wave of the card (B * H under 132) and
# a full wave of whole heads at hd 128; S = 1 through "dec" at
# rwkv6-3b's decode shape and every hd, one warp in all, grids under a
# wave (24 warps) and over one (1056 and 5120 warps), w = 0 (every step
# of one), strong decay, s0 zero and random; and the variant each must
# run (ops.variant: "dec" for one step, "tc" from 64 steps up)
WKV_EDGES = [
    (4, 1, 40, 64, "model", 0.5, "dec"),
    (2, 1, 3, 16, "model", 0.5, "dec"),
    (2, 1, 3, 32, "model", 0.5, "dec"),
    (1, 1, 3, 128, "model", 0.5, "dec"),
    (1, 1, 1, 16, "model", 1.0, "dec"),
    (33, 1, 4, 128, "model", 0.5, "dec"),
    (32, 1, 40, 64, "model", 0.5, "dec"),
    (2, 1, 4, 64, "zero", 0.5, "dec"),
    (2, 1, 4, 64, "strong", 0.5, "dec"),
    (3, 1, 5, 64, "model", 0.0, "dec"),
    (2, 2, 8, 64, "model", 0.5, "rec"),
    (2, 63, 8, 64, "model", 0.0, "rec"),
    (2, 65, 8, 64, "model", 0.5, "tc"),
    (1, 100, 3, 64, "model", 0.5, "tc"),
    (3, 50, 4, 16, "model", 0.5, "rec"),
    (2, 100, 3, 16, "model", 0.5, "tc"),
    (2, 130, 3, 32, "model", 0.5, "tc"),
    (2, 40, 4, 128, "model", 0.5, "rec"),
    (1, 200, 3, 128, "zero", 0.5, "tc"),
    (2, 64, 4, 64, "strong", 0.0, "tc"),
    (2, 64, 4, 64, "zero", 0.5, "tc"),
    (1, 300, 2, 64, "model", 0.5, "tc"),
    (1, 2049, 3, 64, "zero", 0.5, "tc"),
    (33, 30, 4, 128, "model", 0.5, "rec"),
]
WKV_SRC = "src/repro_torch/csrc/rwkv6_wkv.cu"
# input sets a decode-shape timing takes in turn: 32 states of 2.6 MB, as
# a decode step walks rwkv6-3b's 32 layers, 84 MB against the 50 MB L2
WKV_COLD_SETS = 32
WKV_REPLACES = "src/repro/kernels/rwkv6_wkv/kernel.py:79"


def _wkv_inputs(case, gen):
    """r, k, v ~ N(0, 1), w = exp(-exp(0.5 N(0, 1) - 2)) as the random
    model's decays (w0 = -2), or about 0.03 (strong), or with every third
    step 0, or within 1e-6 of 1 (near1); u = 0.1 N(0, 1) as
    ``rwkv6_init`` draws it."""
    b, s, h, hd, decay, s0_scale = case[:6]
    dev = torch.device("cuda")
    r, k, v, z = (torch.randn((b, s, h, hd), generator=gen, device=dev)
                  for _ in range(4))
    if decay == "near1":
        w = 1.0 - 1e-6 * torch.rand((b, s, h, hd), generator=gen, device=dev)
    else:
        w = torch.exp(-torch.exp(0.5 * z + (1.25 if decay == "strong"
                                            else -2.0)))
    if decay == "zero":
        w[:, ::3] = 0.0
    u = 0.1 * torch.randn((h, hd), generator=gen, device=dev)
    s0 = s0_scale * torch.randn((b, h, hd, hd), generator=gen, device=dev)
    return r, k, v, w, u, s0


def _wkv_err(got, want):
    """Kernel against a reference: within 1e-5 of the largest magnitude
    of y (of the state, for the state): the float32 recurrence, the sum
    over i taken in another order (rec) or as the chunk's products (tc).
    Returns the max abs difference and the larger of the two relative
    ones."""
    errs, rels = [], []
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        errs.append(float((g - w).abs().max()))
        rels.append(errs[-1] / max(float(w.abs().max()), 1e-30))
        assert rels[-1] <= 1e-5, rels
    return max(errs), max(rels)


def _wkv_cost(b, s, h, hd):
    """Bytes (r, k, v, w read and y written once each, u, s0 read and the
    state written once) and the fewest operations the function needs, a
    multiply-add counted as two: per (b, t, h), sum_i r_i S_ij (2 hd^2)
    and the state update w_i S_ij + k_i v_j (3 hd^2), plus the bonus
    v_j sum_i r_i u_i k_i (5 hd), so 5 hd^2 + 5 hd."""
    return (4 * (5 * b * s * h * hd + h * hd + 2 * b * h * hd * hd),
            b * s * h * (5 * hd * hd + 5 * hd))


def _wkv_tc_ops(b, s, h, hd, chunk=64, sub=16):
    """Operations of the tc kernel, a multiply-add counted as two: its
    matrix products as three TF32 products each, per (b, h) and chunk of L
    steps: (r o P_ex) S and (k o Q)^T V (2 L hd^2 each), A V over the pairs
    j <= t (hd L (L + 1)), A's blocks across sub-chunks (2 hd per pair);
    and, apart, the scalar running products of A's diagonal 16 x 16 blocks
    (2 hd per pair j < t of a sub-chunk, 3 hd per bonus)."""
    tensor = scalar = 0
    for t0 in range(0, s, chunk):
        ln = min(chunk, s - t0)
        subs = [min(sub, ln - o) for o in range(0, ln, sub)]
        inside = sum(m * (m - 1) // 2 for m in subs)
        across = ln * (ln - 1) // 2 - inside
        tensor += b * h * (4 * ln * hd * hd + hd * ln * (ln + 1)
                           + 2 * hd * across)
        scalar += b * h * (2 * hd * inside + 3 * hd * ln)
    return 3 * tensor, scalar


def _wkv_float64(args):
    """The recurrence in float64 on the card."""
    r, k, v, w, u, st = (t.double() for t in args)
    y = torch.empty_like(r)
    for t in range(r.shape[1]):
        vt = v[:, t, :, None, :]
        y[:, t] = torch.einsum("bhi,bhij->bhj", r[:, t],
                               (u * k[:, t])[:, :, :, None] * vt + st)
        st = w[:, t, :, :, None] * st + k[:, t, :, :, None] * vt
    return y, st


def wkv_kernel(rows, launches):
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_wkv import ops as W

    gen = torch.Generator(device="cuda").manual_seed(3)
    for case in WKV_EDGES:
        args = _wkv_inputs(case, gen)
        var = case[-1]
        assert W.variant(case[1], case[3]) == var, case
        before = variants(WKV)
        s0 = args[-1].clone()
        got = W.wkv(*args)
        torch.cuda.synchronize()
        ran = variants(WKV, before)
        assert ran == {v: int(v == var) for v in VARIANTS[WKV]}, (case, ran)
        assert torch.equal(args[-1], s0), f"{case}: s0 was written"
        _, rel = _wkv_err(got, W.wkv_plain(*args))
        if var == "dec" and case[4] == "zero":     # w = 0: s0 forgotten
            kv = args[1][:, 0, :, :, None] * args[2][:, 0, :, None, :]
            assert torch.equal(got[1], kv), case
        ms = device_ms(lambda: W.wkv(*args), reps=5)
        plain_ms = device_ms(lambda: W.wkv_plain(*args), reps=1)
        n_bytes, n_ops = _wkv_cost(*case[:4])
        bound_ms = max(n_bytes / HBM_BYTES_PER_S,
                       n_ops / SCALAR_OPS_PER_S) * 1e3
        log(f"[kernels] {WKV} edge B, S, H, hd, decay, s0, variant = {case}:"
            f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms, max rel err {rel:.2e}")
    log(f"[kernels] {WKV} edge cases: {len(WKV_EDGES)} shapes match the "
        "plain version, each through its variant")
    # dec reads s0 in 16-byte groups: a state one float into its storage
    # is refused before any launch
    args = _wkv_inputs((2, 1, 3, 64, "model", 0.5), gen)
    buf = torch.empty(args[-1].numel() + 1, device="cuda")
    bad = buf[1:].view(args[-1].shape)
    bad.copy_(args[-1])
    before = dict(_build.launches)
    try:
        W.wkv(*args[:-1], bad)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("dec took a misaligned s0")
    assert dict(_build.launches) == before and refused.startswith("s0")
    log(f"[kernels] {WKV} dec refuses a misaligned s0: {refused}")
    # a long call with w near 1: the float32 recurrence itself drifts some
    # 4e-6 to 7e-6 from a float64 one there (tests/test_torch_wkv.py), so
    # the tc kernel is held to float64
    case = (1, RWKV_PROMPT, 4, 64, "near1", 1.0)
    args = _wkv_inputs(case, gen)
    before = variants(WKV)
    got = W.wkv(*args)
    assert variants(WKV, before) == dict(tc=1, rec=0, dec=0)
    want64 = _wkv_float64(args)
    _, rel = _wkv_err(got, want64)
    rel_plain = max(float((p.double() - w).abs().max() / w.abs().max())
                    for p, w in zip(W.wkv_plain(*args), want64))
    log(f"[kernels] {WKV} tc B, S, H, hd = {case[:4]}, w within 1e-6 of 1, "
        f"s0 random against the recurrence in float64: max rel err "
        f"{rel:.2e} (limit 1e-5; the float32 plain version {rel_plain:.2e})")

    h, hd = 40, 64
    # the prefill: tc, its row; the rec kernel at the same shape, against
    # the same bytes bound and its operations over the scalar rate (outside
    # the main path)
    shape = (RWKV_BATCH, RWKV_PROMPT, h, hd)
    args = _wkv_inputs(shape + ("model", 0.0), gen)
    assert W.variant(RWKV_PROMPT, hd) == "tc"
    err, rel = _wkv_err(W.wkv(*args), W.wkv_plain(*args))
    n_bytes, n_ops = _wkv_cost(*shape)
    _, rec_rel = _wkv_err(W._run("rec", *args), W.wkv_plain(*args))
    rec_ms = device_ms(lambda: W._run("rec", *args), reps=5)
    log(f"[kernels] {WKV} rec at the prefill shape B={RWKV_BATCH}, "
        f"S={RWKV_PROMPT}, H={h}, hd={hd}: device time per call "
        f"{rec_ms:.4f} ms, bound {n_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms "
        f"({n_bytes} B / 3.35 TB/s; its {n_ops} ops / 67 TFLOP/s "
        f"{n_ops / SCALAR_OPS_PER_S * 1e3:.6f} ms), max rel err "
        f"{rec_rel:.2e}; {card()}")
    tc_ops, scalar_ops = _wkv_tc_ops(*shape)
    log(f"[kernels] {WKV} tc at the prefill shape: {tc_ops} TF32 "
        f"tensor-core operations, {tc_ops / TF32_OPS_PER_S * 1e3:.6f} ms at "
        f"495 TFLOP/s; {scalar_ops} scalar ones (A's diagonal blocks), "
        f"{scalar_ops / SCALAR_OPS_PER_S * 1e3:.6f} ms at 67 TFLOP/s; "
        f"{card()}")
    kernel_row(rows, launches, WKV, WKV_SRC, WKV_REPLACES, err,
               lambda: W.wkv(*args), lambda: W.wkv_plain(*args), None,
               n_bytes, tc_ops,
               f"prefill B={RWKV_BATCH}, S={RWKV_PROMPT}, H={h}, hd={hd}, "
               f"float32, kernel tc, max rel err {rel:.2e}; no single "
               "library call computes it", plain_reps=2, variant="tc",
               ops_per_s=TF32_OPS_PER_S, ops_rate="495 TFLOP/s TF32")
    del args

    # the decode step: dec, its row L2-cold (WKV_COLD_SETS input sets in
    # turn, as a decode step finds each layer's state), and warm; the rec
    # kernel, which ran the decode steps before dec, at the same shape
    # through W._run, warm and L2-cold, in turns with dec
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape = (RWKV_BATCH, 1, h, hd)
    sets = [_wkv_inputs(shape + ("model", 0.5), gen)
            for _ in range(WKV_COLD_SETS)]
    assert W.variant(1, hd) == "dec"
    err, rel = _wkv_err(W.wkv(*sets[0]), W.wkv_plain(*sets[0]))
    _, rec_rel = _wkv_err(W._run("rec", *sets[0]), W.wkv_plain(*sets[0]))
    n_bytes, n_ops = _wkv_cost(*shape)
    turn = itertools.cycle(sets)
    kernel_row(rows, launches, WKV, WKV_SRC, WKV_REPLACES, err,
               lambda: W.wkv(*next(turn)), lambda: W.wkv_plain(*next(turn)),
               None, n_bytes, n_ops,
               f"decode B={RWKV_BATCH}, S=1, H={h}, hd={hd}, float32, kernel "
               f"dec, {WKV_COLD_SETS} input sets in turn (L2-cold), max rel "
               f"err {rel:.2e}; no single library call computes it",
               variant="dec")
    timed = {
        "dec warm": lambda: W.wkv(*sets[0]),
        "rec warm": lambda: W._run("rec", *sets[0]),
        "rec L2-cold": lambda: W._run("rec", *next(turn)),
        "dec L2-cold": lambda: W.wkv(*next(turn)),
    }
    got = collections.defaultdict(list)
    for _ in range(2):
        for who in timed:
            got[who].append(device_ms(timed[who]))
    log(f"[kernels] {WKV} decode B={RWKV_BATCH}, S=1, H={h}, hd={hd}, in "
        f"turns (device ms per call; L2-cold over {WKV_COLD_SETS} input "
        "sets): " + "; ".join(
            f"{who} {', '.join(f'{x:.5f}' for x in xs)}"
            for who, xs in got.items())
        + f"; bound {rows[-1]['bound_ms']:.6f} ms (bytes); rec max rel err "
        f"{rec_rel:.2e}; dec {W.dec_warps(RWKV_BATCH, h, hd, n_sms)} warps "
        f"a block on {n_sms} SMs; {card()}")


# --------------------------------------------------------------------------- #
# phase 13: zamba2-7b serving at full width and depth
# --------------------------------------------------------------------------- #

# 4 requests of 2048 prompt tokens, then 32 greedy decode steps against a
# 2080-slot cache for the shared block. Cut from the repo's prefill_32k
# shape (32 x 32768): the Mamba2 states do not grow with the prompt (1.9 MB
# per sequence and layer), but the 14 applications of the shared block
# keep 14 x 2 x 32 x 112 x 2 B = 196 KiB of K/V per token, about 210 GB
# for 32 x 32768 tokens, and the prefill's bf16 projections of 2^20 tokens
# (14,576 wide) alone would take 30 GB per layer.
ZAMBA_BATCH, ZAMBA_PROMPT, ZAMBA_NEW = 4, 2048, 32
ZAMBA_CACHE = ZAMBA_PROMPT + ZAMBA_NEW
ZAMBA_TEACHER = 8       # teacher-forced positions of check (c)
# checks (b) and (c) in float32 at full width and depth: flash and plain
# attention, and decode and forward, sum the same float32 products in
# other orders (cuBLAS picks other kernels for one row than for 2048), a
# few 2^-20 relative per layer through 81 layers and 14 attention blocks;
# 2^-12 of the largest logit leaves a factor of about 8 above the
# readings on the H100 (2.4e-5 to 3.0e-5). Not in bf16: bf16 rounding
# alone moves the reference's own 81-layer stack by more than 2^-4 of its
# largest logit from its float32 forward (tests/test_torch_zamba_bf16.py),
# so no bf16 limit could hold there; this phase prints the bf16 gap as a
# reading
ZAMBA_F32_REL = 2.0 ** -12


def _rel_check(what, got, want, limit) -> float:
    """max |got - want| <= limit * max |want|, printed beside its limit."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"[zamba] check {what}: max abs diff {err:.6g}, max |logit| "
        f"{scale:.4f}, ratio {err / scale:.6g} (limit {limit:.6g})")
    assert torch.isfinite(got).all() and err <= limit * scale, what
    return err / scale


def zamba_serving():
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import lm, transformer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get("zamba2-7b"), use_flash=True)
    # the port's Mamba2 prefill keeps the reference's S % ssm_chunk check;
    # its scan takes any S, so the checks that prefill 2049 or 2040 tokens
    # lift the gate with chunk 1 (the function is the same)
    any_len = dataclasses.replace(cfg, ssm_chunk=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = lm.init_params(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    by_dtype = {}
    for prm in model.parameters():
        by_dtype[str(prm.dtype)] = by_dtype.get(str(prm.dtype), 0) \
            + prm.numel()
    napps = transformer.n_shared_apps(cfg)
    nh = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    log(f"[zamba] {cfg.arch_id}: {cfg.n_layers} Mamba2 layers (d_model "
        f"{cfg.d_model}, d_in {cfg.ssm_expand * cfg.d_model}, {nh} SSM "
        f"heads x {cfg.ssm_head_dim}, state {cfg.ssm_state}, conv "
        f"{cfg.ssm_conv}), one shared attention block ({cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, ff {cfg.d_ff}) "
        f"applied {napps} times, vocab {cfg.vocab_size}, "
        f"{sum(by_dtype.values())} parameters counted from the tensors "
        f"({by_dtype}), random (seed 0), built in "
        f"{time.perf_counter() - t:.2f} s")
    _mem("weights", "zamba")
    prompts = torch.randint(0, cfg.vocab_size, (ZAMBA_BATCH, ZAMBA_PROMPT),
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    lm.prefill_step(model, batch, cfg)      # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    # the main path: one prefill, 32 greedy decode steps
    _build.reset_launches()
    t = time.perf_counter()
    logits, pre = lm.prefill_step(model, batch, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    n_prefill = (_build.launches[SSD], _build.launches[FLASH])
    prefill_var = flash_variants()
    prefill_ssd = variants(SSD)
    _mem("prefill", "zamba")
    caches = _copy_caches(pre, transformer.init_decode_caches(
        cfg, ZAMBA_BATCH, ZAMBA_CACHE, device=dev), ZAMBA_PROMPT)
    del pre
    torch.cuda.synchronize()
    tok = logits.argmax(-1)
    first_tok, per_step, step_var, step_ssd, out = tok, [], [], [], []
    t = time.perf_counter()
    for i in range(ZAMBA_NEW):
        before = (_build.launches[SSD], _build.launches[FLASH])
        before_var = flash_variants()
        before_ssd = variants(SSD)
        last_tok = tok
        logits, caches = lm.decode_step(
            model, caches, {"token": tok, "pos": ZAMBA_PROMPT + i}, cfg)
        per_step.append((_build.launches[SSD] - before[0],
                         _build.launches[FLASH] - before[1]))
        step_var.append(flash_variants(before_var))
        step_ssd.append(variants(SSD, before_ssd))
        if i == 0:
            first_logits = logits
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    launches = dict(_build.launches)
    _mem("decode", "zamba")
    generated = torch.stack(out, 1)
    assert generated.shape == (ZAMBA_BATCH, ZAMBA_NEW)
    assert torch.isfinite(logits).all()
    assert all(bool(torch.isfinite(c).all()) for c in caches.values())
    tokens = ZAMBA_BATCH * ZAMBA_PROMPT
    log(f"[zamba] prefill {ZAMBA_BATCH} x {ZAMBA_PROMPT} tokens: wall "
        f"{prefill_s * 1e3:.1f} ms, {tokens / prefill_s:.0f} tokens/s; "
        f"{card()}")
    log(f"[zamba] decode {ZAMBA_NEW} steps x {ZAMBA_BATCH} sequences: wall "
        f"{decode_s * 1e3:.1f} ms, {decode_s / ZAMBA_NEW * 1e3:.3f} ms per "
        f"step, {ZAMBA_BATCH * ZAMBA_NEW / decode_s:.1f} tokens/s; {card()}")
    log(f"[zamba] launches: prefill (SSD, flash) {n_prefill}, per decode "
        f"step {sorted(set(per_step))}, total SSD {launches.get(SSD, 0)}, "
        f"flash {launches.get(FLASH, 0)}")
    log(f"[zamba] flash variants: prefill {prefill_var}, decode steps "
        f"{_distinct(step_var)}")
    log(f"[zamba] SSD variants: prefill {prefill_ssd}, decode steps "
        f"{_distinct(step_ssd)}")
    # (a) one SSD launch per layer and one flash launch per application of
    # the shared block, in the prefill (both on the tensor cores) and in
    # every decode step (the SSD recurrence and the dec flash kernel)
    assert n_prefill == (cfg.n_layers, napps), n_prefill
    assert per_step == [(cfg.n_layers, napps)] * ZAMBA_NEW, per_step
    assert prefill_var == dict(tc=napps, scalar=0, dec=0), prefill_var
    assert step_var == [dict(tc=0, scalar=0, dec=napps)] * ZAMBA_NEW, \
        step_var
    assert prefill_ssd == dict(tc=cfg.n_layers, rec=0), prefill_ssd
    assert step_ssd == [dict(tc=0, rec=cfg.n_layers)] * ZAMBA_NEW, step_ssd

    # the card's busy and idle share over one decode step (the last step
    # again: it rewrites slot 2079 with the same token's k/v and moves the
    # states one step on) and a prefill, and the SSD kernel's share
    _profile_idle("decode step", lambda: lm.decode_step(
        model, caches, {"token": last_tok, "pos": ZAMBA_CACHE - 1}, cfg),
        decode_s / ZAMBA_NEW, "zamba", share_of="ssd")
    _profile_idle("prefill", lambda: lm.prefill_step(model, batch, cfg),
                  prefill_s, "zamba", share_of="ssd")
    del caches

    # (e) state handoff in bf16: the prefill's caches plus one decode step
    # give the logits of a prefill one token longer (2049 tokens)
    longer = torch.cat([prompts, first_tok[:, None].to(prompts.dtype)], 1)
    want, _ = lm.prefill_step(model, {"tokens": longer}, any_len)
    _close_bf16("(e) prefill(S) + one decode step vs prefill(S + 1)",
                first_logits, want, "zamba")
    del want
    # the bf16 forward of one prompt at its last positions, for the bf16
    # against float32 reading below
    one = prompts[:1]
    cut = ZAMBA_PROMPT - ZAMBA_TEACHER
    x, _ = transformer.hidden(model, one, cfg)
    fwd16 = transformer.lm_head(model, x[:, cut:], cfg)
    del model, x
    torch.cuda.empty_cache()
    _mem("check (e)", "zamba")

    # (b) and (c) in float32 at full width and depth, one prompt, the same
    # weights drawn again from the same seed
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = lm.init_params(cfg32, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    _mem("float32 weights", "zamba")
    plain32 = dataclasses.replace(cfg32, use_flash=False)

    def prefill_and_step(c, tok):
        """The prefill's logits, then one decode step of ``tok`` (the flash
        prefill's greedy token) on its caches."""
        lg, pre = lm.prefill_step(model, {"tokens": one}, c)
        big = _copy_caches(pre, transformer.init_decode_caches(
            c, 1, ZAMBA_PROMPT + 1, device=dev), ZAMBA_PROMPT)
        del pre
        tok = lg.argmax(-1) if tok is None else tok
        return lg, lm.decode_step(model, big, {"token": tok,
                                               "pos": ZAMBA_PROMPT}, c)[0], tok

    before_var = flash_variants()
    flash_lg, flash_step, tok1 = prefill_and_step(cfg32, None)
    plain_lg, plain_step, _ = prefill_and_step(plain32, tok1)
    _rel_check("(b) prefill, flash vs plain attention, float32", flash_lg,
               plain_lg, ZAMBA_F32_REL)
    _rel_check("(b) first decode step, flash vs plain attention, float32",
               flash_step, plain_step, ZAMBA_F32_REL)

    # (c) teacher-forced decode of the last 8 prompt positions after
    # prefilling the rest, against the uncached forward at those positions
    x, _ = transformer.hidden(model, one, cfg32)
    fwd32 = transformer.lm_head(model, x[:, cut:], cfg32)
    del x
    _, pre = lm.prefill_step(model, {"tokens": one[:, :cut]},
                             dataclasses.replace(cfg32, ssm_chunk=1))
    big = _copy_caches(pre, transformer.init_decode_caches(
        cfg32, 1, ZAMBA_PROMPT, device=dev), cut)
    del pre
    got = []
    for pos in range(cut, ZAMBA_PROMPT):
        lg, big = lm.decode_step(model, big, {"token": one[:, pos],
                                              "pos": pos}, cfg32)
        got.append(lg)
    del big
    _rel_check(f"(c) teacher-forced decode of {ZAMBA_TEACHER} positions vs "
               "forward, float32", torch.stack(got, 1), fwd32,
               ZAMBA_F32_REL)
    gap = float((fwd16 - fwd32).abs().max() / fwd32.abs().max())
    log(f"[zamba] bf16 forward vs float32 forward of the same weights at "
        f"the last {ZAMBA_TEACHER} prompt positions, the stack's answer to "
        f"bf16 rounding: ratio {gap:.5f} (a reading, not a check; "
        "tests/test_torch_zamba_bf16.py shows the reference's own 81-layer "
        "stack moving past 2^-4)")
    del model, fwd16, fwd32, got
    torch.cuda.empty_cache()
    _mem("checks (b), (c)", "zamba")

    # (d) the reduced config in float32, on the card and on the CPU:
    # logits of a prefill and 8 decode steps, and all four caches
    small = dataclasses.replace(configs.get("zamba2-7b").reduced(),
                                use_flash=True)
    res = {}
    for device in ("cuda", "cpu"):
        m = lm.init_params(small, device="cpu").to(device)
        toks = prompts[:, :24].remainder(small.vocab_size).to(device)
        lg, pre = lm.prefill_step(m, {"tokens": toks[:, :16]}, small)
        c = _copy_caches(pre, transformer.init_decode_caches(
            small, ZAMBA_BATCH, 24, device=device), 16)
        seq = [lg]
        for pos in range(16, 24):
            lg, c = lm.decode_step(m, c, {"token": toks[:, pos],
                                          "pos": pos}, small)
            seq.append(lg)
        res[device] = [torch.stack(seq).cpu()] + [c[k].cpu()
                                                  for k in sorted(c)]
    err_d = max(float((g - w).abs().max())
                for g, w in zip(res["cuda"], res["cpu"]))
    log(f"[zamba] check (d) reduced zamba2-7b in float32, prefill + 8 "
        f"decode steps (logits and the conv, ssm, k, v caches), card vs "
        f"CPU: max abs diff {err_d:.3e} (limit 1e-4)")
    assert err_d <= 1e-4
    f32_var = flash_variants(before_var)
    log(f"[zamba] flash variants of the float32 checks (b), (c), (d): "
        f"{f32_var}")
    # each call on the variant its shape gives: (b)'s prefill and (c)'s
    # forward over the prompt, (c)'s prefill of the rest, (b)'s decode step
    # and (c)'s eight, then (d)'s reduced prefill of 16 and eight steps
    want = collections.Counter({v_: 0 for v_ in FLASH_VARIANTS})
    g, hd = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    want[FA.variant(torch.float32, ZAMBA_PROMPT, g, hd)] += 2 * napps
    want[FA.variant(torch.float32, cut, g, hd)] += napps
    want[FA.variant(torch.float32, 1, g, hd)] += 9 * napps
    s_apps = transformer.n_shared_apps(small)
    g, hd = small.n_heads // small.n_kv_heads, small.resolved_head_dim
    want[FA.variant(torch.float32, 16, g, hd)] += s_apps
    want[FA.variant(torch.float32, 1, g, hd)] += 8 * s_apps
    assert f32_var == dict(want), (f32_var, want)
    return launches


# --------------------------------------------------------------------------- #
# phase 14: the SSD kernel against its plain version
# --------------------------------------------------------------------------- #

# (B, S, H, hd, N, dt, s0, strided, variant): the decode shape (S = 1), S =
# 0, 63, 64 and 2049, odd H with hd = N = 16, mixed hd and N on both sides
# of one chunk, dt tiny (the state barely moves), huge (the decay
# underflows to 0) and 0, s0 zero, a batch stride that is not contiguous,
# and the variant each must run (ops.variant: "tc" from 64 steps up)
SSD_EDGES = [
    (4, 1, 112, 64, 64, "model", "random", False, "rec"),
    (2, 0, 3, 64, 64, "model", "random", False, "rec"),
    (2, 63, 5, 64, 64, "model", "random", False, "rec"),
    (2, 64, 5, 64, 64, "model", "random", False, "tc"),
    (1, 2049, 8, 64, 64, "model", "random", False, "tc"),
    (2, 65, 5, 16, 16, "model", "random", False, "tc"),
    (2, 40, 3, 32, 128, "model", "random", False, "rec"),
    (2, 100, 3, 32, 128, "model", "random", False, "tc"),
    (1, 127, 3, 128, 16, "model", "random", False, "tc"),
    (2, 100, 4, 64, 64, "tiny", "random", False, "tc"),
    (2, 100, 4, 64, 64, "huge", "random", False, "tc"),
    (2, 100, 4, 64, 64, "zero", "random", False, "tc"),
    (1, 300, 2, 64, 64, "model", "zero", False, "tc"),
    (3, 40, 7, 64, 64, "model", "random", True, "rec"),
    (3, 96, 7, 64, 64, "model", "random", True, "tc"),
]
SSD_SRC = "src/repro_torch/csrc/mamba2_ssd.cu"
SSD_REPLACES = "src/repro/kernels/mamba2_ssd/kernel.py:72"


def _ssd_inputs(case, gen):
    """x, b, c ~ N(0, 1); dt log-uniform in [1e-3, 1e-1] as ``mamba2_init``
    sets it, about 1e-6 (tiny), 5 to 20 (huge) or 0; a = -linspace(1, 16,
    H); d ~ N(0, 1); s0 N(0, 1) or zero; with ``strided``, x, b, c and dt
    are every other sequence of a batch twice as large."""
    b, s, h, hd, n, dt, s0, strided = case[:8]
    dev = torch.device("cuda")
    bb = 2 * b if strided else b

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x, bm, cm = randn(bb, s, h, hd), randn(bb, s, n), randn(bb, s, n)
    u = torch.rand((bb, s, h), generator=gen, device=dev)
    if dt == "model":
        dtv = torch.exp(math.log(1e-3) + u * math.log(100.0))
    elif dt == "tiny":
        dtv = 1e-6 * (0.5 + u)
    elif dt == "zero":
        dtv = torch.zeros_like(u)
    else:
        dtv = 5.0 + 15.0 * u
    if strided:
        x, bm, cm, dtv = x[::2], bm[::2], cm[::2], dtv[::2]
    a = -torch.linspace(1.0, 16.0, h, device=dev)
    st = randn(b, h, n, hd) if s0 == "random" else torch.zeros(
        (b, h, n, hd), device=dev)
    return x, bm, cm, dtv, a, randn(h), st


def _ssd_err(got, want):
    """Kernel against a reference: within 1e-5 of the largest magnitude of
    y (of the state, for the state); the plain version is the float32
    recurrence, the sum over N (rec) or the chunk's products (tc) in
    another order. Returns the max abs difference and the larger relative
    one."""
    errs, rels = [], []
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        if not g.numel():
            continue
        errs.append(float((g - w).abs().max()))
        rels.append(errs[-1] / max(float(w.abs().max()), 1e-30))
        assert rels[-1] <= 1e-5, rels
    return max(errs), max(rels)


def _ssd_cost(b, s, h, hd, n):
    """Bytes (x, b, c, dt, a, d and s0 read, y and the state written, once
    each) and the recurrence's operations, a multiply-add counted as two:
    per (b, t, h) the state update e^{dt a} S + b (dt x) (3 N hd, and hd
    for dt x) and y = c·S + d x (2 N hd + 2 hd), so 5 N hd + 3 hd."""
    return (4 * (2 * b * s * h * hd + 2 * b * s * n + b * s * h + 2 * h
                 + 2 * b * h * n * hd),
            b * s * h * (5 * n * hd + 3 * hd))


def _ssd_tc_ops(b, s, h, hd, n, chunk=64):
    """Tensor-core operations of the chunked form, three TF32 products per
    product: per (b, h) and chunk of L steps, M X over the pairs j <= t
    (hd L (L + 1)), C S and Bᵀ (w ∘ X) (2 L N hd each); G = C Bᵀ on and
    under the diagonal (N L (L + 1)) once per (b, chunk), the same for
    every head."""
    total = 0
    for t0 in range(0, s, chunk):
        ln = min(chunk, s - t0)
        total += b * (h * (hd * ln * (ln + 1) + 4 * ln * n * hd)
                      + n * ln * (ln + 1))
    return 3 * total


def _ssd_float64(args):
    """The recurrence in float64 on the card."""
    x, bm, cm, dtv, a, d, st = (t.double() for t in args)
    y = torch.empty_like(x)
    for t in range(x.shape[1]):
        st = (torch.exp(dtv[:, t] * a)[:, :, None, None] * st
              + bm[:, t, None, :, None]
              * (dtv[:, t, :, None] * x[:, t])[:, :, None, :])
        y[:, t] = (torch.einsum("bn,bhnp->bhp", cm[:, t], st)
                   + d[:, None] * x[:, t])
    return y, st


def ssd_kernel(rows, launches):
    from repro_torch.kernels.mamba2_ssd import ops as M

    gen = torch.Generator(device="cuda").manual_seed(4)
    for case in SSD_EDGES:
        args = _ssd_inputs(case, gen)
        var = case[-1]
        assert M.variant(case[1], case[3], case[4]) == var, case
        before = variants(SSD)
        got = M.ssd(*args)
        torch.cuda.synchronize()
        ran = variants(SSD, before)
        want_ran = {v: int(v == var) for v in VARIANTS[SSD]}
        assert ran == want_ran, (case, ran)
        if case[1] == 0:
            assert got[0].shape[1] == 0 and torch.equal(got[1], args[-1])
            log(f"[kernels] {SSD} edge {case}: no steps, the state is s0")
            continue
        _, rel = _ssd_err(got, M.ssd_plain(*args))
        if case[5] == "zero":          # e^0 = 1 and no input: s0 exactly
            assert torch.equal(got[1], args[-1]), case
        log(f"[kernels] {SSD} edge B, S, H, hd, N, dt, s0, strided, variant "
            f"= {case}: max rel err {rel:.2e}")
    log(f"[kernels] {SSD} edge cases: {len(SSD_EDGES)} shapes match the "
        "plain version, each through its variant")
    # a long tiny-dt call: the float32 recurrence itself drifts some 3e-5
    # from a float64 one there (2048 roundings of e^{dt a} near 1), so the
    # tc kernel is held to float64
    case = (1, ZAMBA_PROMPT, 4, 64, 64, "tiny", "random", False)
    args = _ssd_inputs(case, gen)
    before = variants(SSD)
    got = M.ssd(*args)
    assert variants(SSD, before) == dict(tc=1, rec=0)
    want64 = _ssd_float64(args)
    _, rel = _ssd_err(got, want64)
    rel_plain = max(float((p.double() - w).abs().max() / w.abs().max())
                    for p, w in zip(M.ssd_plain(*args), want64))
    log(f"[kernels] {SSD} tc B, S, H, hd, N = {case[:5]}, dt tiny, s0 random "
        f"against the recurrence in float64: max rel err {rel:.2e} (limit "
        f"1e-5; the float32 plain version {rel_plain:.2e})")

    h, hd, n = 112, 64, 64
    # a decode step finds each layer's 7.3 MB state cold (81 layers of it
    # pass between two reads), so the decode row takes 8 input sets in
    # turn, 120 MB against the card's 50 MB L2; the prefill's 492 MB
    # cannot stay in L2 anyway
    for s, reps, sets, what in ((ZAMBA_PROMPT, 2, 1, "prefill"),
                                (1, 20, 8, "decode")):
        case = (ZAMBA_BATCH, s, h, hd, n, "model",
                "zero" if s > 1 else "random", False)
        inputs = [_ssd_inputs(case, gen) for _ in range(sets)]
        var = M.variant(s, hd, n)
        err, rel = _ssd_err(M.ssd(*inputs[0]), M.ssd_plain(*inputs[0]))
        turn = itertools.cycle(inputs)
        n_bytes, n_ops = _ssd_cost(*case[:5])
        rate = dict(ops_per_s=SCALAR_OPS_PER_S, ops_rate="67 TOP/s")
        if var == "tc":
            # the recurrence's operations over the scalar rate: the floor
            # the rec kernel's form cannot pass; and the rec kernel itself
            # at this shape, for comparison (outside the main path)
            s_out = torch.empty_like(inputs[0][-1])
            rec_ms = device_ms(lambda: M._run("rec", *inputs[0], s_out))
            rec_y = M._run("rec", *inputs[0], s_out)
            _ssd_err((rec_y, s_out), M.ssd_plain(*inputs[0]))
            log(f"[kernels] {SSD} rec at the {what} shape: device time per "
                f"call {rec_ms:.4f} ms, its scalar floor "
                f"{n_ops / SCALAR_OPS_PER_S * 1e3:.6f} ms ({n_ops} ops / "
                f"67 TOP/s); {card()}")
            n_ops = _ssd_tc_ops(*case[:5])
            rate = dict(ops_per_s=TF32_OPS_PER_S,
                        ops_rate="495 TFLOP/s TF32")
        kernel_row(rows, launches, SSD, SSD_SRC, SSD_REPLACES, err,
                   lambda: M.ssd(*next(turn)),
                   lambda: M.ssd_plain(*next(turn)), None, n_bytes, n_ops,
                   f"{what} B={ZAMBA_BATCH}, S={s}, H={h}, hd={hd}, N={n}, "
                   f"float32, kernel {var}, {sets} input set(s) in turn, "
                   f"max rel err {rel:.2e}; no single library call "
                   "computes it", plain_reps=reps, variant=var, **rate)


# --------------------------------------------------------------------------- #
# phases 15 and 16: mixture-of-experts serving with AWAPart expert placement
# --------------------------------------------------------------------------- #

# (config, log prefix, parameter dtype, layers of the float32 checks (b)
# and (c), None for all). Both serve phase 9's requests: 4 prompts of 2048
# tokens, then 32 greedy decode steps against a 2080-slot cache (cut from
# prefill_32k and decode_32k as there). olmoe-1b-7b keeps its config's
# float32 parameters (27.7 GB, and a 13.8 GB bf16 copy for the bf16
# compute); qwen3-moe-30b-a3b serves in bfloat16 parameters, the published
# checkpoint's dtype: in float32 its 30.5 B parameters, 122 GB, do not fit
# the card. Its float32 checks run at full width and 12 of its 48 layers
# (about 32 GB of float32 weights).
MOE_PHASES = (("olmoe-1b-7b", "olmoe", "float32", None),
              ("qwen3-moe-30b-a3b", "qmoe", "bfloat16", 12))
# checks (b) and (c) in float32, as zamba2-7b's: the same float32 sums in
# other orders through 12 or 16 layers, held within this share of the
# largest logit on the rows whose routes agree
MOE_F32_REL = 2.0 ** -12
# a route that differs between two float32 runs (its top-k set, in one
# layer, at one token) passes where the oracle's gap between its k-th and
# (k+1)-th router logits is under this: the two runs' hidden states differ
# by float32 rounding (about 1e-6 relative, more in the layers after
# another token's route differed), so router logits of order 1 differ by
# about 1e-5 at most; the limit leaves a factor 100
MOE_ROUTE_GAP = 2.0 ** -10
# check (p): each layer's routing drawn as examples/adaptive_moe.py draws
# it: every request takes the k experts of one topic (topics of k experts:
# 8 at 64 experts, 16 at 128), each pick replaced by a random expert with
# probability 0.1; 2048 requests a layer, 16 expert-parallel ranks
MOE_PLACE_REQUESTS, MOE_PLACE_RANKS, MOE_PLACE_NOISE = 2048, 16, 0.1


def topical_routing(rng, n_requests, n_experts, k, noise=MOE_PLACE_NOISE):
    """(n_requests, k) expert ids with topical structure (check (p))."""
    topics = rng.permutation(n_experts).reshape(-1, k)
    out = np.empty((n_requests, k), np.int64)
    for i in range(n_requests):
        t = topics[rng.integers(len(topics))]
        picks = list(rng.permutation(t)[:k])
        for j in range(k):
            if rng.random() < noise:
                picks[j] = int(rng.integers(n_experts))
        out[i] = picks
    return out


class RouteLog:
    """Each ``models.moe._router`` call while watching: its top-k sets
    (sorted expert ids, (T, k)) and the gap between its k-th and (k+1)-th
    router logits (T,), both on the host."""

    def __init__(self):
        self.calls = []

    @contextlib.contextmanager
    def watching(self):
        from repro_torch.models import moe

        router = moe._router

        def recording(p, x2d, cfg):
            out = router(p, x2d, cfg)
            top = torch.topk(x2d.float() @ p.wr.float(), cfg.top_k + 1,
                             dim=-1).values
            self.calls.append((torch.sort(out[1], -1).values.cpu(),
                               (top[:, -2] - top[:, -1]).cpu()))
            return out
        moe._router = recording
        try:
            yield self
        finally:
            moe._router = router

    def routes(self, n_layers, batch, lengths):
        """(L, B, P, k) ids and (L, B, P) gaps over the positions of calls
        made segment by segment (a prefill of ``n`` positions, a decode
        step of one), each segment's layers in order."""
        ids, gaps = [], []
        it = iter(self.calls)
        for n in lengths:
            seg = [next(it) for _ in range(n_layers)]
            ids.append(torch.stack([c[0].reshape(batch, n, -1)
                                    for c in seg]))
            gaps.append(torch.stack([c[1].reshape(batch, n) for c in seg]))
        assert next(it, None) is None, "more router calls than segments"
        return torch.cat(ids, 2), torch.cat(gaps, 2)


def _route_check(prefix, what, got, want):
    """The routes of a run, ``got``, against the oracle's, ``want`` ((ids,
    gaps) from ``RouteLog.routes``). A differing route is a root where no
    route of its sequence differs in an earlier layer at its position or
    before: only rounding explains a root, and its oracle gap must be
    under ``MOE_ROUTE_GAP``. The others follow from a root (the token's
    own hidden state, or through attention later tokens', moved with the
    root's experts) and are printed. Returns the (B, P) mask of the rows
    at or after a differing route of their sequence."""
    diff = (got[0] != want[0]).any(-1)                 # (L, B, P)
    seen = torch.zeros_like(diff[0])
    roots = torch.zeros_like(diff)
    for layer in range(diff.shape[0]):
        roots[layer] = diff[layer] & ~seen
        seen |= diff[layer].cumsum(-1) > 0
    spans = []
    for mask in (roots, diff & ~roots):
        gaps = want[1][mask]
        spans.append(f"{int(mask.sum())}, oracle gaps "
                     f"{float(gaps.min()):.3e} to {float(gaps.max()):.3e}"
                     if bool(mask.any()) else "0")
    log(f"[{prefix}] routes {what}: {int(diff.sum())} of {diff.numel()} "
        f"(layer, token) top-{got[0].shape[-1]} sets differ; roots "
        f"{spans[0]} (limit {MOE_ROUTE_GAP:.3e}); following a root "
        f"{spans[1]}; rows at or after one: "
        f"{int((diff.any(0).cumsum(-1) > 0).sum())} of {diff[0].numel()}")
    gaps = want[1][roots]
    assert not bool(roots.any()) or float(gaps.max()) < MOE_ROUTE_GAP, what
    return diff.any(0).cumsum(-1) > 0


def _rows_check(prefix, what, chunks, limit) -> float:
    """max |got - want| over the rows whose routes agree, within ``limit``
    of the largest |want|; ``chunks``: (got, want, flipped) triples of
    (rows..., V) logits and their rows' masks. The other rows' difference
    is printed beside it."""
    err = scale = off = 0.0
    kept = rows = 0
    for got, want, flipped in chunks:
        keep = ~flipped.to(got.device)
        assert bool(torch.isfinite(got).all()), what
        scale = max(scale, float(want.abs().max()))
        if bool(keep.any()):
            err = max(err, float((got[keep] - want[keep]).abs().max()))
        if not bool(keep.all()):
            off = max(off, float((got[~keep] - want[~keep]).abs().max()))
        kept, rows = kept + int(keep.sum()), rows + keep.numel()
    assert kept, f"{what}: every row's routes differ"
    log(f"[{prefix}] check {what}: {kept} of {rows} rows with equal "
        f"routes: max abs diff {err:.6g}, max |logit| {scale:.4f}, ratio "
        f"{err / scale:.6g} (limit {limit:.6g}); the other rows' max abs "
        f"diff {off:.6g}")
    assert err <= limit * scale, what
    return err / scale


def _serve(model, cfg, prompts, dev, transformer, lm):
    """One prefill and LM_NEW greedy decode steps: the prefill logits, the
    decode steps' logits and tokens, the last step's input token and the
    caches, and the walls and flash launches and variants of each."""
    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, pre = lm.prefill_step(model, {"tokens": prompts}, cfg)
    torch.cuda.synchronize()
    st = dict(prefill_s=time.perf_counter() - t,
              n_prefill=_build.launches[FLASH], prefill_var=flash_variants(),
              per_step=[], step_var=[])
    caches = _fill_cache(cfg, pre, LM_PROMPT, dev, transformer)
    del pre
    torch.cuda.synchronize()
    tok, first, steps, out = logits.argmax(-1), logits, [], []
    t = time.perf_counter()
    for i in range(LM_NEW):
        before, before_var = _build.launches[FLASH], flash_variants()
        last_tok = tok
        logits, caches = lm.decode_step(
            model, caches, {"token": tok, "pos": LM_PROMPT + i}, cfg)
        st["per_step"].append(_build.launches[FLASH] - before)
        st["step_var"].append(flash_variants(before_var))
        steps.append(logits)
        tok = logits.argmax(-1)
        out.append(tok)
    torch.cuda.synchronize()
    st["decode_s"] = time.perf_counter() - t
    return (first, torch.stack(steps, 1), torch.stack(out, 1), last_tok,
            caches, st)


def _placement_round(model, cfg, prefix, dev, placement):
    """Check (p)'s round: one ``plan_expert_placement`` a layer on the
    card, equal to the same plan on the CPU, each accepted map applied.
    Returns the round's kernel launches."""
    from repro_torch.kernels import _build

    rng = np.random.default_rng(0)
    nbytes = 3 * cfg.d_model * cfg.d_ff * (4 if cfg.param_dtype == "float32"
                                           else 2)
    _build.reset_launches()
    reports, plan_s = [], 0.0
    for i, blk in enumerate(model.blocks):
        routing = topical_routing(rng, MOE_PLACE_REQUESTS, cfg.n_experts,
                                  cfg.top_k)
        before = _build.launches["jaccard"]
        t = time.perf_counter()
        e2r, rep = placement.plan_expert_placement(
            routing, cfg.n_experts, MOE_PLACE_RANKS, None, nbytes,
            device=dev)
        plan_s += time.perf_counter() - t
        assert _build.launches["jaccard"] == before + 1, i
        want = placement.plan_expert_placement(
            routing, cfg.n_experts, MOE_PLACE_RANKS, None, nbytes,
            device="cpu")
        assert np.array_equal(e2r, want[0]) and rep == want[1], i
        reports.append(rep)
        if rep.accepted:
            blk.moe.load_state_dict(placement.apply_expert_placement(
                blk.moe.state_dict(), e2r))
    torch.cuda.synchronize()
    acc = [r for r in reports if r.accepted]
    log(f"[{prefix}] (p) placement: {len(acc)} of {len(reports)} layers "
        f"accepted; distinct ranks a token (mean) "
        f"{statistics.fmean(r.ranks_before for r in reports):.4f} -> "
        f"{statistics.fmean(r.ranks_after for r in reports):.4f}; "
        f"{sum(r.moved_experts for r in acc)} experts moved, "
        f"{sum(r.migration_bytes for r in acc)} B; plan wall {plan_s:.2f} s; "
        f"every layer's map and report equal to the CPU plan's; launches "
        f"{dict(_build.launches)}")
    assert acc, "no layer's placement was accepted"
    return dict(_build.launches)


def moe_serving(arch, prefix, param_dtype, f32_layers):
    """Phase 15 (olmoe-1b-7b) or 16 (qwen3-moe-30b-a3b): serving at full
    width and depth, check (p), then checks (b) and (c) in float32 at
    ``f32_layers`` layers (all when None) and (d). Returns the serving
    run's launches and check (p)'s round's."""
    from repro_torch import configs
    from repro_torch.core import placement
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import lm, transformer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(configs.get(arch), use_flash=True,
                              param_dtype=param_dtype)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = lm.init_params(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    torch.cuda.synchronize()
    # (a comprehension: a loop variable would keep one layer's view, and
    # with it the whole stacked leaf, alive after the model is freed)
    by_dtype = collections.Counter()
    for dt, numel in [(str(t.dtype), t.numel()) for t in model.parameters()]:
        by_dtype[dt] += numel
    experts = 3 * cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff
    log(f"[{prefix}] {cfg.arch_id}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, {cfg.n_experts} experts top-"
        f"{cfg.top_k}, expert ff {cfg.d_ff}, vocab {cfg.vocab_size}; "
        f"{sum(by_dtype.values())} parameters held ({dict(by_dtype)}; "
        f"{experts} in experts), drawn in {cfg.param_dtype}, compute "
        f"{cfg.compute_dtype}, random (seed 0), built in "
        f"{time.perf_counter() - t:.2f} s")
    _mem("weights (the peak is the draw's)", prefix)
    prompts = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                            generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev, dtype=torch.int32)
    lm.prefill_step(model, {"tokens": prompts}, cfg)   # warm-up
    torch.cuda.synchronize()

    # the main path: one prefill, 32 greedy decode steps
    _build.reset_launches()
    first, steps, generated, last_tok, caches, st = _serve(
        model, cfg, prompts, dev, transformer, lm)
    launches = dict(_build.launches)
    _mem("prefill + decode", prefix)
    assert generated.shape == (LM_BATCH, LM_NEW)
    assert torch.isfinite(steps).all()
    tokens = LM_BATCH * LM_PROMPT
    log(f"[{prefix}] prefill {LM_BATCH} x {LM_PROMPT} tokens: wall "
        f"{st['prefill_s'] * 1e3:.1f} ms, {tokens / st['prefill_s']:.0f} "
        f"tokens/s; {card()}")
    log(f"[{prefix}] decode {LM_NEW} steps x {LM_BATCH} sequences: wall "
        f"{st['decode_s'] * 1e3:.1f} ms, {st['decode_s'] / LM_NEW * 1e3:.3f}"
        f" ms per step, {LM_BATCH * LM_NEW / st['decode_s']:.1f} tokens/s; "
        f"{card()}")
    log(f"[{prefix}] flash launches: prefill {st['n_prefill']}, per decode "
        f"step {sorted(set(st['per_step']))}, total "
        f"{launches.get(FLASH, 0)}; variants: prefill {st['prefill_var']}, "
        f"decode steps {_distinct(st['step_var'])}")
    # (a) one flash launch per layer: the prefill's on the tensor cores,
    # each decode step's on the dec kernel
    n = cfg.n_layers
    assert st["n_prefill"] == n, st["n_prefill"]
    assert st["per_step"] == [n] * LM_NEW, st["per_step"]
    assert st["prefill_var"] == dict(tc=n, scalar=0, dec=0)
    assert st["step_var"] == [dict(tc=0, scalar=0, dec=n)] * LM_NEW
    # the card's busy and idle share over one decode step (the last step
    # again) and a prefill; device operations a layer; flash's share
    n_ops = _profile_idle("decode step", lambda: lm.decode_step(
        model, caches, {"token": last_tok, "pos": LM_CACHE - 1}, cfg),
        st["decode_s"] / LM_NEW, prefix, share_of="flash")
    log(f"[{prefix}] decode step: {n_ops / n:.1f} device operations a "
        "layer (each expert the layer's 4 tokens routed to: a gather, "
        "three GEMMs, silu, two products, an index_add)")
    n_ops = _profile_idle(
        "prefill", lambda: lm.prefill_step(model, {"tokens": prompts}, cfg),
        st["prefill_s"], prefix, share_of="flash")
    log(f"[{prefix}] prefill: {n_ops / n:.1f} device operations a layer")
    del caches

    # (p) AWAPart expert placement, then the same requests again: logits
    # and tokens equal to the unplaced run's bit for bit
    place_launches = _placement_round(model, cfg, prefix, dev, placement)
    again = _serve(model, cfg, prompts, dev, transformer, lm)
    same = (torch.equal(again[0], first), torch.equal(again[1], steps),
            torch.equal(again[2], generated))
    log(f"[{prefix}] (p) after placement: the prefill's logits, the {LM_NEW}"
        f" decode steps' logits and tokens equal to the unplaced run's bit "
        f"for bit: {same}")
    assert all(same), same
    del model, again
    torch.cuda.empty_cache()

    # (b) and (c) in float32 at full width, weights drawn again from the
    # same seed
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                param_dtype="float32",
                                n_layers=f32_layers or cfg.n_layers)
    torch.cuda.reset_peak_memory_stats()
    model = lm.init_params(cfg32, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    _mem(f"float32 weights, {cfg32.n_layers} layers", prefix)
    n32 = cfg32.n_layers
    plain32 = dataclasses.replace(cfg32, use_flash=False)
    before_var = flash_variants()

    # (b) the forward through flash and through plain attention, logits at
    # every position; then one decode step from the plain forward's caches
    # through each
    flash_log, plain_log = RouteLog(), RouteLog()
    with flash_log.watching():
        xf, pre_f = transformer.hidden(model, prompts, cfg32,
                                       collect_cache=True)
    with plain_log.watching():
        xp, pre_p = transformer.hidden(model, prompts, plain32,
                                       collect_cache=True)
    fwd = flash_log.routes(n32, LM_BATCH, (LM_PROMPT,))
    flipped = _route_check(prefix, "(b) forward, flash vs plain attention, "
                           "float32", fwd,
                           plain_log.routes(n32, LM_BATCH, (LM_PROMPT,)))
    span = 256
    _rows_check(prefix, "(b) forward logits at every position, flash vs "
                "plain attention, float32",
                ((transformer.lm_head(model, xf[:, i:i + span], cfg32),
                  transformer.lm_head(model, xp[:, i:i + span], cfg32),
                  flipped[:, i:i + span])
                 for i in range(0, LM_PROMPT, span)), MOE_F32_REL)
    tok = transformer.lm_head(model, xp[:, -1:], cfg32)[:, 0].argmax(-1)
    del xp
    step, logs = {}, {}
    for c in (cfg32, plain32):
        big = _copy_caches(pre_p, transformer.init_decode_caches(
            c, LM_BATCH, LM_PROMPT + 1, device=dev), LM_PROMPT)
        logs[c.use_flash] = RouteLog()
        with logs[c.use_flash].watching():
            step[c.use_flash] = lm.decode_step(
                model, big, {"token": tok, "pos": LM_PROMPT}, c)[0]
        del big
    del pre_p
    flipped = _route_check(prefix, "(b) decode step from the same caches, "
                           "flash vs plain attention, float32",
                           logs[True].routes(n32, LM_BATCH, (1,)),
                           logs[False].routes(n32, LM_BATCH, (1,)))
    _rows_check(prefix, "(b) decode step, flash vs plain attention, "
                "float32", [(step[True], step[False], flipped[:, 0])],
                MOE_F32_REL)

    # (c) teacher-forced decode of the last 8 prompt positions against the
    # flash forward at those positions, from the forward's caches (their
    # slots from the first decoded position on are rewritten as the steps
    # go): the rows compared depend on the decode steps' routes alone
    cut = LM_PROMPT - LM_TEACHER
    want = transformer.lm_head(model, xf[:, cut:], cfg32)
    del xf
    big = _copy_caches(pre_f, transformer.init_decode_caches(
        cfg32, LM_BATCH, LM_PROMPT, device=dev), LM_PROMPT)
    del pre_f
    tf_log, got = RouteLog(), []
    with tf_log.watching():
        for pos in range(cut, LM_PROMPT):
            lg, big = lm.decode_step(model, big, {"token": prompts[:, pos],
                                                  "pos": pos}, cfg32)
            got.append(lg)
    del big
    flipped = _route_check(
        prefix, f"(c) {LM_TEACHER} teacher-forced decode steps vs the "
        "forward, float32",
        tf_log.routes(n32, LM_BATCH, (1,) * LM_TEACHER),
        (fwd[0][:, :, cut:], fwd[1][:, :, cut:]))
    _rows_check(prefix, f"(c) teacher-forced decode of {LM_TEACHER} "
                "positions vs forward, float32",
                [(torch.stack(got, 1), want, flipped)], MOE_F32_REL)
    del model, want, got
    torch.cuda.empty_cache()
    _mem("checks (b), (c)", prefix)

    # (d) the reduced config in float32, on the card and on the CPU
    small = dataclasses.replace(configs.get(arch).reduced(), use_flash=True)
    res, logs = {}, {}
    for device in ("cuda", "cpu"):
        m = lm.init_params(small, device="cpu").to(device)
        toks = prompts[:, :24].remainder(small.vocab_size).to(device)
        logs[device] = RouteLog()
        with logs[device].watching():
            lg, c = lm.prefill_step(m, {"tokens": toks[:, :16]}, small)
            big = _copy_caches(c, transformer.init_decode_caches(
                small, LM_BATCH, 24, device=device), 16)
            seq = [lg]
            for pos in range(16, 24):
                lg, big = lm.decode_step(m, big, {"token": toks[:, pos],
                                                  "pos": pos}, small)
                seq.append(lg)
        res[device] = torch.stack(seq, 1).cpu()
    segs = (small.n_layers, LM_BATCH, (16,) + (1,) * 8)
    flipped = _route_check(prefix, f"(d) reduced {arch} in float32, card vs "
                           "CPU", logs["cuda"].routes(*segs),
                           logs["cpu"].routes(*segs))
    keep = ~flipped[:, 15:]
    assert bool(keep.any()), "(d): every row's routes differ"
    err_d = float((res["cuda"][keep] - res["cpu"][keep]).abs().max())
    log(f"[{prefix}] check (d) reduced {arch} in float32, prefill + 8 "
        f"decode steps, card vs CPU: max abs diff {err_d:.3e} over "
        f"{int(keep.sum())} of {keep.numel()} rows with equal routes "
        "(limit 1e-4)")
    assert err_d <= 1e-4
    f32_var = flash_variants(before_var)
    log(f"[{prefix}] flash variants of the float32 checks (b), (c), (d): "
        f"{f32_var}")
    # each call on the variant its shape gives: (b)'s flash forward over
    # the prompt, (b)'s flash decode step and (c)'s eight, then (d)'s
    # prefill of 16 and 8 steps
    want_var = collections.Counter({v_: 0 for v_ in FLASH_VARIANTS})
    g, hd = cfg.n_heads // cfg.n_kv_heads, cfg.resolved_head_dim
    want_var[FA.variant(torch.float32, LM_PROMPT, g, hd)] += n32
    want_var[FA.variant(torch.float32, 1, g, hd)] += (1 + LM_TEACHER) * n32
    g, hd = small.n_heads // small.n_kv_heads, small.resolved_head_dim
    want_var[FA.variant(torch.float32, 16, g, hd)] += small.n_layers
    want_var[FA.variant(torch.float32, 1, g, hd)] += 8 * small.n_layers
    assert f32_var == dict(want_var), (f32_var, want_var)
    return launches, place_launches


def moe_kernel_rows(rows, arch, launches, place_launches):
    """The flash kernel at the config's prefill and decode shapes, and the
    Jaccard kernel at its placement shape (experts x 2048 requests), each
    against its plain version, timed as in phase 4."""
    from repro_torch import configs
    from repro_torch.core import placement

    cfg = configs.get(arch)
    rand = _flash_rand(torch.Generator(device="cuda").manual_seed(6))
    shape = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
    flash_prefill_row(rows, launches, rand, arch, LM_BATCH, LM_PROMPT,
                      *shape)
    flash_decode_row(rows, launches, rand, arch, LM_BATCH, *shape, LM_CACHE)
    routing = topical_routing(np.random.default_rng(0), MOE_PLACE_REQUESTS,
                              cfg.n_experts, cfg.top_k)
    bm = placement.coactivation_bitmaps(routing, cfg.n_experts,
                                        MOE_PLACE_REQUESTS)
    a = torch.from_numpy(bm.view(np.int32)).to("cuda")
    one = torch.empty(1, dtype=torch.int64, device="cuda")
    floor_ms = device_ms(lambda: one.fill_(1))
    jaccard_rows(rows, place_launches, a,
                 f"{arch} placement ({a.shape[0]} experts, words of "
                 f"{MOE_PLACE_REQUESTS} requests)", floor_ms)


# --------------------------------------------------------------------------- #
# phase 17: LM training, qwen3-0.6b at full width and depth
# --------------------------------------------------------------------------- #

TRAIN_ARCH = "qwen3-0.6b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 8   # cut from train_4k's 256
TRAIN_F32_LAYERS, TRAIN_F32_SEQ = 4, 1024          # check (f)
TRAIN_REDUCED = ("qwen3-0.6b", "smollm-360m", "hubert-xlarge",
                 "olmoe-1b-7b")                    # check (r)
TRAIN_REDUCED_EPS = 1e-3    # AdamW eps of (r): see tests/test_torch_train.py
FLASH_BWD_SRC = "src/repro_torch/csrc/flash_attention_bwd.cu"
FLASH_BWD_REPLACES = "src/repro/kernels/flash_attention/ops.py:48"
# each element of dq, dk, dv within FLASH_BWD_REL of itself plus
# FLASH_BWD_ABS of its output's largest magnitude: both sides sum in
# float32 from the same inputs, in another order (2^-14 of the largest),
# and round each element to the dtype (one bf16 or f16 step)
FLASH_BWD_REL = {F32: 0.0, BF16: 2.0 ** -7, F16: 2.0 ** -10}
FLASH_BWD_ABS = 2.0 ** -14
# (B, S, T, H, K, D, causal, q_offset, kv_valid_len): GQA g = 1 to 8, D 8
# and 256, S = 1, q_offset > 0, kv_valid_len < T, non-causal, S and T off
# the 32-row tiles; each in all three dtypes
FLASH_BWD_EDGES = [
    (2, 77, 77, 16, 8, 128, True, 0, None),
    (1, 33, 70, 4, 4, 64, True, 37, None),
    (2, 45, 45, 8, 1, 8, False, 0, 40),
    (1, 1, 50, 6, 2, 256, True, 49, 50),
    (1, 130, 200, 5, 1, 80, False, 0, 150),
    (2, 64, 100, 4, 2, 32, True, 36, 90),
    (1, 100, 100, 7, 1, 40, True, 0, None),
    (1, 40, 40, 2, 1, 256, True, 0, 23),
]
# bf16 edges the tc route takes (bwd_variant: D % 16 == 0 up to 128,
# S * g >= 64): GQA g = 1, 2, 8 and 64, D 16 to 128 (80 and 112 off the
# 64-column boxes), S * g = 64, S = 1, T = 3, q_offset > 0, kv_valid_len < T
# (inside a 64-key warpgroup, and leaving the second warpgroup of a 128-key
# dkv block without keys), non-causal, S and T off the 64- and 128-row
# tiles; in bf16 alone (the edges above keep the scalar route in float32
# and float16)
FLASH_BWD_TC_EDGES = [
    (2, 77, 77, 16, 8, 128, True, 0, None),
    (1, 32, 32, 4, 2, 64, True, 0, None),
    (1, 1, 40, 64, 1, 16, True, 39, None),
    (2, 65, 3, 4, 4, 32, False, 0, None),
    (1, 130, 200, 5, 1, 80, False, 0, 150),
    (2, 100, 170, 16, 2, 112, True, 70, 160),
    (1, 300, 300, 8, 1, 48, True, 0, 60),
    (1, 129, 257, 4, 2, 96, True, 128, None),
    (2, 64, 100, 4, 2, 32, True, 36, 90),
]
# each route's kernels by the names the profiler gives them
FLASH_BWD_PARTS = {
    "tc": ("flash_bwd_tc_pre_kernel", "flash_bwd_tc_dq_kernel",
           "flash_bwd_tc_dkv_kernel"),
    "scalar": ("flash_bwd_pre_kernel", "flash_bwd_dq_kernel",
               "flash_bwd_dkv_kernel"),
}
# operations a valid (query, head, key) pair, each kernel: its part of the
# function (pre the scores; dq the scores, dO.V^T and dS.K; dkv the scores,
# dO.V^T, P^T.dO and dS^T.Q), and each route's own count (the recomputed
# products, and on tc the second bf16 term of P and dS)
FLASH_BWD_OPS = {"function": (2, 6, 8), "tc": (2, 8, 12),
                 "scalar": (2, 6, 8)}
# (what, B, S, H, K, D, dtype, causal) of the timed rows: the main path's
# shape first (the kernels line's tc rows), hubert-xlarge's encoder,
# float32 (the kernels line's scalar rows)
FLASH_BWD_SHAPES = [
    ("qwen3-0.6b training", TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128, BF16, True),
    ("hubert-xlarge", TRAIN_BATCH, TRAIN_SEQ, 16, 16, 80, BF16, False),
    ("float32", 2, 1024, 16, 8, 128, F32, True),
]


def _bwd_err(got, want, what) -> tuple:
    """dq, dk and dv each within its limit at every element; returns the
    largest abs difference and the largest share of an element's limit
    that its difference takes."""
    errs, uses = [], []
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        y32 = y.float()
        diff = (x.float() - y32).abs()
        limit = (FLASH_BWD_REL[y.dtype] * y32.abs()
                 + FLASH_BWD_ABS * float(y32.abs().max()))
        use = float(torch.where(diff == 0, 0.0, diff / limit).max())
        assert use <= 1.0, (what, name, float(diff.max()), use)
        errs.append(float(diff.max()))
        uses.append(use)
    return max(errs), max(uses)


def _bwd_limit_text(dt) -> str:
    rel = FLASH_BWD_REL[dt]
    return ((f"2^{math.log2(rel):.0f}·|want| + " if rel else "")
            + "2^-14·max|want| an element")


def _bwd_faults_caught(FA, q, k, v, o, do, kw, got, want, what) -> int:
    """The check's power at ``what``: five planted faults in the kernels'
    outputs, each of which must fail :func:`_bwd_err` — dv, or dk, zeroed
    for the keys past T/2; dq zeroed for the rows past S/2; dv off by
    2^-5 past T/2; and D = rowsum(dO∘O) left out of dS (the kernels run
    with o = 0). Returns how many were caught."""
    dq, dk, dv = got

    def past(x, f):
        y = x.clone()
        y[:, x.shape[1] // 2:] = f(y[:, x.shape[1] // 2:])
        return y
    faults = {
        "dv zeroed past T/2": (dq, dk, past(dv, torch.zeros_like)),
        "dk zeroed past T/2": (dq, past(dk, torch.zeros_like), dv),
        "dq zeroed past S/2": (past(dq, torch.zeros_like), dk, dv),
        "dv x (1 + 2^-5) past T/2": (dq, dk,
                                     past(dv, lambda z: z * (1 + 2 ** -5))),
        "D left out of dS": FA.flash_attention_bwd(
            q, k, v, torch.zeros_like(o), do, **kw),
    }
    for name, bad in faults.items():
        try:
            _bwd_err(bad, want, what)
        except AssertionError:
            continue
        raise AssertionError(f"check (k) at {what} passes a planted fault: "
                             f"{name}")
    return len(faults)


def _stats_err(got, want, what) -> float:
    """The pre kernel's m, l, D within 2^-14 of each one's largest."""
    errs = []
    for name, x, y in zip("mlD", got, want):
        err = float((x - y).abs().max())
        assert err <= 2.0 ** -14 * float(y.abs().max()), (what, name, err)
        errs.append(err)
    return max(errs)


def _bwd_case(gen, b, s, t, h, kh, d, dt, causal, q_offset, kv_valid_len):
    """Random q, k, v and dO, the flash forward's o, and the call's
    keyword arguments."""
    from repro_torch.kernels.flash_attention import ops as FA

    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((b, s, h, d), (b, t, kh, d), (b, t, kh, d),
                                 (b, s, h, d)))
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len)
    return q, k, v, FA.flash_attention(q, k, v, **kw), do, kw


def _bwd_pre(FA, q, k, v, o, do, kw):
    """The pre kernel alone -> its statistics as (m, l, D), (B, K, S, g)."""
    b, s, h, _ = q.shape
    kh = k.shape[2]
    out = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
           torch.empty(3 * b * s * h, dtype=torch.float32, device="cuda"))
    FA._bwd_kernels(FA.BWD_KERNELS[:1], (q, k, v, o, do), out,
                    kw["causal"], kw["q_offset"], kw["kv_valid_len"])
    return out[3].view(3, b, kh, s, h // kh)


def _bwd_route_counts(FA, route, n=1) -> dict:
    """The launch counts ``n`` backward calls on ``route`` add: each kernel
    and its ``<kernel>.<route>`` n times, the other route's none."""
    want = {k: n for k in FA.BWD_KERNELS}
    for var in FA.BWD_VARIANTS:
        want.update({f"{k}.{var}": n * (var == route)
                     for k in FA.BWD_KERNELS})
    return want


def flash_bwd_edges() -> None:
    """(k) at the edges: each kernel of the call's route once, every
    output and the pre kernel's statistics against their plain versions;
    on the tc route two calls give equal bits."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as FA

    gen = torch.Generator(device="cuda").manual_seed(17)
    worst = collections.defaultdict(lambda: (0.0, 0.0))
    calls = collections.Counter()
    for case, dts in ([(c, (F32, BF16, F16)) for c in FLASH_BWD_EDGES]
                      + [(c, (BF16,)) for c in FLASH_BWD_TC_EDGES]):
        for dt in dts:
            q, k, v, o, do, kw = _bwd_case(gen, *case[:6], dt, *case[6:])
            route = FA.bwd_variant(dt, case[1], case[3] // case[4], case[5])
            want_ran = _bwd_route_counts(FA, route)
            before = {n: _build.launches[n] for n in want_ran}
            got = FA.flash_attention_bwd(q, k, v, o, do, **kw)
            ran = {n: _build.launches[n] - before[n] for n in want_ran}
            assert ran == want_ran, (case, dt, ran)
            want = FA.flash_attention_bwd_plain(q, k, v, o, do, **kw)
            err, use = _bwd_err(got, want, (case, dt))
            key = (str(dt)[6:], route)
            worst[key] = (max(worst[key][0], err), max(worst[key][1], use))
            calls[key] += 1
            if route == "tc":
                again = FA.flash_attention_bwd(q, k, v, o, do, **kw)
                assert all(torch.equal(x, y) for x, y in zip(got, again)), \
                    (case, "two calls differ")
            _stats_err(_bwd_pre(FA, q, k, v, o, do, kw),
                       FA.flash_attention_bwd_stats_plain(q, k, o, do, **kw),
                       (case, dt))
    torch.cuda.synchronize()
    log(f"[train] check (k): the backward kernels match the plain version "
        f"at {len(FLASH_BWD_EDGES)} edges x 3 dtypes and "
        f"{len(FLASH_BWD_TC_EDGES)} bf16 tc edges, each call on its route's "
        "kernels alone ("
        + ", ".join(f"{dt} on {route} ({calls[(dt, route)]} calls): largest "
                    f"abs diff {e:.3e}, worst element at {u:.3f} of its "
                    f"limit {_bwd_limit_text(getattr(torch, dt))}"
                    for (dt, route), (e, u) in sorted(worst.items()))
        + "), the pre kernel's statistics within 2^-14; on tc two calls "
        "give equal bits")


def device_ms_parts(fn, parts, reps: int = 5) -> dict:
    """As :func:`device_ms`, split by operation name: the device time per
    call of the operations whose names hold each of ``parts``, and
    ``"total"``, every operation's."""
    fn()
    torch.cuda.synchronize()
    prof = torch.profiler
    for attempt in range(PROFILE_TRIES):
        with prof.profile(activities=[prof.ProfilerActivity.CUDA]) as p:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = collections.defaultdict(list)
        for e in p.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_name[e.name].append(e.device_time_total)
        if by_name:
            break
        log(f"[profile] empty device trace (attempt {attempt + 1})")
    assert by_name, "the profiler recorded no device work"
    per = {name: max(1, round(len(us) / reps)) * statistics.fmean(us) / 1e3
           for name, us in by_name.items()}
    out = {part: sum(ms for name, ms in per.items() if part in name)
           for part in parts}
    out["total"] = sum(per.values())
    return out


def flash_bwd_rows(rows, launches, f32_launches) -> None:
    """(k) timed: the backward kernels of each shape's route at each of
    FLASH_BWD_SHAPES (device time per call from the profiler and per call
    with launch overhead from CUDA events), their sum, at the bf16 shapes
    the scalar route's beside them, the plain version (the pre kernel
    beside ``flash_attention_bwd_stats_plain``, dq and dkv beside the
    whole plain backward), the backward of
    ``scaled_dot_product_attention`` (``enable_gqa``) and the bounds. The
    main path's shape gives the kernels line's tc rows with the main
    path's ``launches``, the float32 shape its scalar rows with the
    launches of check (f)'s float32 training (``f32_launches``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as FA

    gen = torch.Generator(device="cuda").manual_seed(18)
    for i, (what, b, s, h, kh, d, dt, causal) in enumerate(FLASH_BWD_SHAPES):
        q, k, v, o, do, kw = _bwd_case(gen, b, s, s, h, kh, d, dt, causal,
                                       0, None)
        route = FA.bwd_variant(dt, s, h // kh, d)
        parts = FLASH_BWD_PARTS[route]
        got = FA.flash_attention_bwd(q, k, v, o, do, **kw)
        again = FA.flash_attention_bwd(q, k, v, o, do, **kw)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        assert same, (what, "two calls differ")
        del again
        want = FA.flash_attention_bwd_plain(q, k, v, o, do, **kw)
        err, use = _bwd_err(got, want, what)
        caught = _bwd_faults_caught(FA, q, k, v, o, do, kw, got, want, what)
        log(f"[train] (k) check at {what} on {route}: largest abs diff "
            f"{err:.3e}, worst element at {use:.3f} of its limit "
            f"{_bwd_limit_text(dt)}; {caught} of {caught} planted faults "
            f"fail it; two calls give equal bits")
        del got, want
        stats_want = FA.flash_attention_bwd_stats_plain(q, k, o, do, **kw)
        stats_err = _stats_err(_bwd_pre(FA, q, k, v, o, do, kw), stats_want,
                               what)
        del stats_want
        out = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
               torch.empty(3 * b * s * h, dtype=torch.float32,
                           device="cuda"))
        ins = (q, k, v, o, do)

        def on(names, route_=None):
            return lambda: FA._bwd_kernels(names, ins, out, kw["causal"],
                                           kw["q_offset"],
                                           kw["kv_valid_len"], route_)
        full = lambda: FA.flash_attention_bwd(q, k, v, o, do, **kw)  # noqa
        dev = device_ms_parts(full, parts)
        assert all(dev[p_] > 0 for p_ in parts), (what, dev)
        events = {n: call_ms(on((n,)), reps=3, runs=3)
                  for n in FA.BWD_KERNELS}
        events["sum"] = call_ms(full, reps=3, runs=3)
        scalar = None
        if route != "scalar":       # the same call on the earlier design
            scalar = device_ms_parts(on(FA.BWD_KERNELS, "scalar"),
                                     FLASH_BWD_PARTS["scalar"], reps=2)
        plain = lambda: FA.flash_attention_bwd_plain(q, k, v, o, do, **kw)  # noqa
        stats_plain = lambda: FA.flash_attention_bwd_stats_plain(  # noqa
            q, k, o, do, **kw)
        plain_ms = device_ms(plain, reps=3)
        stats_plain_ms = device_ms(stats_plain, reps=3)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal,
                                                 enable_gqa=True)
        dot = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (qt, kt, vt), dot, retain_graph=True)
        lib_ms = device_ms(lib, reps=5)
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        el = q.element_size()
        qo = q.numel() * el                      # q, o, dO, dq: each
        kvb = k.numel() * el                     # k, v, dk, dv: each
        row_stats = 3 * 4 * b * s * h
        # bytes read and written by each kernel's own function
        n_bytes = (3 * qo + kvb + row_stats, 3 * qo + 2 * kvb + row_stats,
                   2 * qo + 4 * kvb + row_stats)
        rate = TENSOR_OPS_PER_S if dt != F32 else SCALAR_OPS_PER_S
        rate_name = ("989 TFLOP/s bf16" if dt != F32
                     else "67 TFLOP/s float32")
        for j, (n, part) in enumerate(zip(FA.BWD_KERNELS, parts)):
            ops_pp, own_pp = FLASH_BWD_OPS["function"][j] * d, \
                FLASH_BWD_OPS[route][j] * d
            bound = max(n_bytes[j] / HBM_BYTES_PER_S, ops_pp * pairs / rate)
            bound_by = ("bytes" if n_bytes[j] / HBM_BYTES_PER_S >=
                        ops_pp * pairs / rate else "operations")
            row_plain = stats_plain_ms if j == 0 else plain_ms
            row_err = stats_err if j == 0 else err
            run = "main path" if i == 0 else "check (f)" if dt == F32 else "-"
            main = {"main path": launches, "check (f)": f32_launches}.get(
                run, {})
            n_launch = main.get(f"{n}.{route}", 0)
            earlier = ("" if scalar is None else
                       f"; the scalar route at this shape "
                       f"{scalar[FLASH_BWD_PARTS['scalar'][j]]:.4f} ms")
            log(f"[train] (k) {n} on {route} at {what} (B={b}, S=T={s}, "
                f"H={h}, K={kh}, D={d}, {str(dt)[6:]}, "
                f"{'causal' if causal else 'non-causal'}): device time per "
                f"call {dev[part]:.4f} ms (profiler), {events[n]:.4f} ms "
                f"with launch overhead (CUDA events){earlier}; plain "
                f"{row_plain:.4f} ms ("
                f"{'row statistics' if j == 0 else 'the whole backward'}); "
                f"SDPA backward {lib_ms:.4f} ms; bound {bound * 1e3:.4f} ms "
                f"({bound_by}: {ops_pp} operations a pair x {pairs} pairs / "
                f"{rate_name}, {n_bytes[j]} B / 3.35 TB/s); the route's own "
                f"{own_pp} operations a pair take "
                f"{own_pp * pairs / rate * 1e3:.4f} ms at that rate; "
                f"launches {n_launch} ({run}); max_abs_err {row_err:.3e}; "
                f"{card()}")
            if i == 0 or dt == F32:
                rows.append(dict(
                    name=n, route="cuda", source=FLASH_BWD_SRC,
                    replaces=FLASH_BWD_REPLACES, variant=route,
                    launches=n_launch, max_abs_err=row_err,
                    ms=dev[part], plain_ms=row_plain,
                    bound_ms=bound * 1e3, bound_by=bound_by,
                    library_ms=lib_ms))
        all_bytes = 4 * qo + 4 * kvb
        bound = max(all_bytes / HBM_BYTES_PER_S, 10 * d * pairs / rate)
        own = sum(FLASH_BWD_OPS[route]) * d * pairs / rate
        earlier = ("" if scalar is None else
                   f"; the scalar route {scalar['total']:.4f} ms ("
                   + " + ".join(f"{scalar[p_]:.4f}"
                                for p_ in FLASH_BWD_PARTS["scalar"])
                   + f"), {scalar['total'] / dev['total']:.1f}x")
        log(f"[train] (k) the backward at {what} on {route}: three kernels "
            f"{dev['total']:.4f} ms device time a call "
            f"({' + '.join(f'{dev[p_]:.4f}' for p_ in parts)}), "
            f"{events['sum']:.4f} ms with launch overhead{earlier}; plain "
            f"{plain_ms:.4f} ms; SDPA backward {lib_ms:.4f} ms; bound "
            f"{bound * 1e3:.4f} ms (10·B·H·D = {10 * d * pairs} operations "
            f"over {rate_name}, or {all_bytes} B of q, k, v, o, dO, dq, dk, "
            f"dv over 3.35 TB/s), the route's own "
            f"{sum(FLASH_BWD_OPS[route])}·D a pair {own * 1e3:.4f} ms; "
            f"kernels / bound {dev['total'] / (bound * 1e3):.1f}, kernels / "
            f"SDPA {dev['total'] / lib_ms:.1f}; {card()}")
        del q, k, v, o, do, out, qt, kt, vt, lib_out
        torch.cuda.empty_cache()


def _train_close(what, got, want, tol) -> float:
    """Trees keyed alike, each leaf within ``tol`` of its own largest
    magnitude; returns the largest such ratio."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    worst = 0.0
    for key in want:
        g = torch.as_tensor(got[key]).double().cpu()
        w = torch.as_tensor(want[key]).double().cpu()
        assert g.shape == w.shape, (what, key)
        ratio = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        assert ratio <= tol, (what, key, ratio)
        worst = max(worst, ratio)
    return worst


def train_f32_grads() -> dict:
    """(f) qwen3-0.6b at full width, TRAIN_F32_LAYERS layers, float32: the
    gradients with flash attention (the scalar forward, the scalar
    backward kernels) against autograd through the plain attention.
    Returns the flash run's kernel launches."""
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import lm, transformer
    from repro_torch.optim import global_norm

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    base = dataclasses.replace(configs.get(TRAIN_ARCH),
                               n_layers=TRAIN_F32_LAYERS,
                               compute_dtype="float32")
    flat = lm.init_flat(base, device=dev, generator=torch.Generator(
        device=dev).manual_seed(11))
    tokens = torch.from_numpy(np.random.default_rng(11).integers(
        0, base.vocab_size, (1, TRAIN_F32_SEQ)).astype(np.int32)).to(dev)
    res = {}
    for flash in (True, False):
        cfg = dataclasses.replace(base, use_flash=flash)
        model = lm.make_trainable(transformer.Transformer(cfg, flat), cfg,
                                  flat)
        _build.reset_launches()
        _, met, grads = lm.loss_and_grads(model, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        res[flash] = (float(met["loss"]), float(global_norm(grads)), grads,
                      dict(_build.launches))
        del model
    (loss_f, gn_f, g_f, ran), (loss_p, gn_p, g_p, ran_p) = res[True], res[False]
    var = FA.variant(F32, TRAIN_F32_SEQ, 2, 128)
    n = TRAIN_F32_LAYERS
    assert ran.get(f"flash_attention_fwd.{var}") == 2 * n, ran   # + remat
    assert all(ran.get(k, 0) == c for k, c in _bwd_route_counts(
        FA, "scalar", n).items()), ran
    assert not any(k.startswith("flash") for k in ran_p), ran_p
    worst = _train_close("(f) gradients", g_f, g_p, 1e-4)
    rel_loss = abs(loss_f - loss_p) / abs(loss_p)
    rel_gn = abs(gn_f - gn_p) / gn_p
    log(f"[train] check (f) {TRAIN_ARCH} at full width, {n} of 28 layers, "
        f"1 x {TRAIN_F32_SEQ} tokens, float32, TF32 off, remat full: flash "
        f"({2 * n} forward launches on '{var}', {n} of each backward kernel "
        f"on scalar) "
        f"against autograd through the plain attention: every gradient leaf "
        f"within {worst:.3e} of its largest (limit 1e-4), loss {loss_f:.6f} "
        f"vs {loss_p:.6f} (rel {rel_loss:.2e}), grad_norm {gn_f:.6f} vs "
        f"{gn_p:.6f} (rel {rel_gn:.2e}; limits 1e-5)")
    assert rel_loss <= 1e-5 and rel_gn <= 1e-5
    del g_f, g_p, res, flat
    torch.cuda.empty_cache()
    return ran


def _spread_zeros(flat, seed):
    """Every all-zero floating leaf drawn from 0.1 * N(0, 1) instead: a
    leaf that starts at zero is all update after a step, and relative
    comparisons would compare Adam's normalised steps alone."""
    gen = torch.Generator().manual_seed(seed)
    for key, t in flat.items():
        if t.dtype.is_floating_point and not bool(t.any()):
            flat[key] = 0.1 * torch.randn(t.shape, generator=gen)
    return flat


def train_reduced() -> None:
    """(r) train_step on the card against the CPU for TRAIN_REDUCED, three
    float32 steps from the same weights; then the supervisor on the card
    with an async checkpoint and an injected failure."""
    import tempfile

    from repro_torch import configs, interop
    from repro_torch.data.pipeline import DataConfig, make_stream
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import train
    from repro_torch.models import lm, transformer
    from repro_torch.optim import AdamWConfig, adamw_init

    opt_cfg = AdamWConfig(total_steps=10, warmup_steps=2,
                          eps=TRAIN_REDUCED_EPS)
    for arch in TRAIN_REDUCED:
        cfg = dataclasses.replace(configs.get(arch).reduced(), use_flash=True)
        flat = _spread_zeros(lm.init_flat(cfg, device="cpu"), 3)
        stream = make_stream(cfg, DataConfig(seed=3, global_batch=2,
                                             seq_len=32))
        # hubert-xlarge's key bias has a zero gradient in exact arithmetic
        # (no RoPE, no qk-norm: a row's softmax ignores the shift q.bk)
        skip = ("attn/bk" if cfg.qkv_bias and not (cfg.rope or cfg.qk_norm)
                else None)
        out = {}
        for device in ("cuda", "cpu"):
            f = {k: v.to(device) for k, v in flat.items()}
            model = lm.make_trainable(transformer.Transformer(cfg, f), cfg, f)
            opt = adamw_init(lm.trainable(model))
            mets = []
            for step in range(3):
                batch = train.to_device(stream.host_batch(step), device)
                model, opt, met = lm.train_step(model, opt, batch, cfg,
                                                opt_cfg)
                mets.append({k: float(v) for k, v in met.items()})
            out[device] = (mets, interop.lm_tree(model, cfg),
                           interop.adamw_tree(opt, cfg))
        (m_c, p_c, o_c), (m_h, p_h, o_h) = out["cuda"], out["cpu"]
        for a, b_ in zip(m_c, m_h):
            for key in ("loss", "grad_norm", "aux"):
                assert abs(a[key] - b_[key]) <= 1e-4 * max(abs(b_[key]),
                                                           1e-6), (arch, key)
        keep = lambda t: {k: v for k, v in t.items()  # noqa: E731
                          if skip is None or not k.endswith(skip)}
        worst = max(_train_close(f"(r) {arch} {name}", keep(g), keep(w),
                                 1e-4)
                    for name, g, w in (("params", p_c, p_h),
                                       ("mu", o_c["mu"], o_h["mu"]),
                                       ("nu", o_c["nu"], o_h["nu"])))
        inv = [k for k in p_h if k.endswith("inv_perm")]
        for k in inv:
            assert np.array_equal(p_c[k], flat[k].numpy()), (arch, k)
        log(f"[train] check (r) reduced {arch}, 3 float32 steps (flash "
            f"forward and backward kernels on the card), card vs CPU: loss "
            f"{m_c[-1]['loss']:.6f} vs {m_h[-1]['loss']:.6f}, grad_norm "
            f"{m_c[-1]['grad_norm']:.6f} vs {m_h[-1]['grad_norm']:.6f}; "
            f"params, mu, nu within {worst:.3e} of each leaf's largest "
            f"(limit 1e-4{'; ' + skip + ' left out, a zero gradient' if skip else ''})"
            f"{'; inv_perm untouched' if inv else ''}")

    # the supervisor on the card: checkpoint after step 2 (async), a failure
    # at step 4, a restore, steps 3 to 5 again
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.runtime.resilience import (SupervisorConfig,
                                                TrainSupervisor)

    cfg, model, opt, stream, step_fn = train.build(
        TRAIN_ARCH, reduced=True, batch=2, seq=32, steps=6, use_flash=True)
    failed, after = [], []

    def one_step(state, step):
        if step == 4 and not failed:
            failed.append(step)
            raise RuntimeError("injected node failure")
        m, o, met = step_fn(state.model, state.opt_state,
                            train.to_device(stream.host_batch(step), "cuda"))
        return train.TrainState(m, o, {k: float(v) for k, v in met.items()})

    def load(tree, state):
        state = train.load_state(tree, state)
        after.append({k: v.clone() for k, v in ckpt._flatten(
            train.state_tree(state)).items()})
        return state

    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainSupervisor(SupervisorConfig(ckpt_dir=tmp, ckpt_every=3),
                              one_step, train.state_tree, load,
                              device=torch.device("cuda"))
        state = sup.run(train.TrainState(model, opt, {}), 6)
        disk = ckpt._flatten(ckpt.restore(tmp, 2, train.state_tree(state)))
        (back,) = after
        assert sup.failures == sup.restores == 1
        assert int(state.opt_state["step"]) == 6 and int(back["opt__step"]) == 3
        assert set(back) == set(disk)
        for key in disk:
            assert back[key].device.type == "cuda", key
            assert torch.equal(back[key], disk[key]), key
    log(f"[train] supervisor on the card (reduced {TRAIN_ARCH}, async "
        f"checkpoint every 3 steps, a failure injected at step 4): "
        f"failures {sup.failures}, restores {sup.restores}, the restored "
        f"state ({len(disk)} leaves) bit for bit the checkpoint of step 2, "
        f"6 optimizer steps in all")


def training_run():
    """(t) the main path: qwen3-0.6b at full width and depth trained for
    TRAIN_STEPS steps through ``launch.train.build`` and
    ``TrainSupervisor``. Returns the run's kernel launches."""
    import tempfile

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import train
    from repro_torch.runtime.resilience import (SupervisorConfig,
                                                TrainSupervisor)

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, opt, stream, step_fn = train.build(
        TRAIN_ARCH, reduced=False, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, use_flash=True)
    assert (cfg.remat, cfg.param_dtype, cfg.compute_dtype, cfg.use_flash) \
        == ("full", "float32", "bfloat16", True)
    n_params = sum(p.numel() for p in model.parameters())
    first = train.to_device(stream.host_batch(0), dev)
    torch.cuda.synchronize()
    log(f"[train] (t) {TRAIN_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.resolved_head_dim}, "
        f"vocab {cfg.vocab_size}, {n_params} parameters (float32 masters, "
        f"bf16 compute, AdamW float32), remat full, flash; global batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}; built in "
        f"{time.perf_counter() - t0:.2f} s; every step takes the pipeline's "
        "first batch again, so that the loss on one batch must fall")
    _mem("(t) after the build", "train")
    walls, losses = [], []

    def one_step(state, step):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m, o, met = step_fn(state.model, state.opt_state, first)
        metrics = {k: float(v) for k, v in met.items()}   # synchronizes
        walls.append(time.perf_counter() - t)
        return train.TrainState(m, o, metrics)

    def on_metrics(step, state, dt):
        losses.append(state.metrics["loss"])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        log(f"[train] (t) step {step}: loss {state.metrics['loss']:.5f}, "
            f"grad_norm {state.metrics['grad_norm']:.4f}, lr "
            f"{state.metrics['lr']:.3e}, wall {walls[-1] * 1e3:.1f} ms, "
            f"{tokens / walls[-1]:.1f} tokens/s")

    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainSupervisor(
            SupervisorConfig(ckpt_dir=tmp, ckpt_every=TRAIN_STEPS + 1),
            one_step, train.state_tree, train.load_state, device=dev)
        _build.reset_launches()
        state = sup.run(train.TrainState(model, opt, {}), TRAIN_STEPS,
                        on_metrics=on_metrics)
        launches = dict(_build.launches)
    assert sup.failures == 0
    _mem("(t) 8 steps", "train")
    per_step = {k: v / TRAIN_STEPS for k, v in launches.items()}
    log(f"[train] (t) launches a step: {per_step}")
    n = cfg.n_layers
    assert launches.get("flash_attention_fwd.tc") == 2 * n * TRAIN_STEPS
    assert launches.get("flash_attention_fwd") == 2 * n * TRAIN_STEPS
    for k, c in _bwd_route_counts(FA, "tc", n * TRAIN_STEPS).items():
        assert launches.get(k, 0) == c, (k, launches)
    steady = statistics.median(walls[1:])
    log(f"[train] (t) step wall (backward kernels on tc): first "
        f"{walls[0] * 1e3:.1f} ms, median of "
        f"steps 2-{TRAIN_STEPS} {steady * 1e3:.1f} ms "
        f"(min {min(walls[1:]) * 1e3:.1f}, max {max(walls[1:]) * 1e3:.1f}), "
        f"{TRAIN_BATCH * TRAIN_SEQ / steady:.1f} tokens/s; {card()}")
    random_loss = math.log(cfg.vocab_size) + 0.5
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(losses[0] - random_loss) <= 0.5, losses[0]
    assert losses[-1] < losses[0], losses
    log(f"[train] (t) check: every loss finite; step-1 loss {losses[0]:.4f} "
        f"within 0.5 of a random model's ln V + 1/2 = {random_loss:.4f} "
        f"(ln V = {math.log(cfg.vocab_size):.4f}; unit-RMS hidden states "
        f"against N(0, 1/d) head columns give logits of variance 1); loss "
        f"falls over the {TRAIN_STEPS} steps on one batch: "
        + " -> ".join(f"{x:.4f}" for x in losses))
    _profile_idle("one training step (forward, remat recompute, backward, "
                  "AdamW)", lambda: step_fn(state.model, state.opt_state,
                                           first), steady, "train",
                  share_of="flash_bwd")
    _mem("(t) after the profiled step", "train")
    del state, model, opt, first, sup
    torch.cuda.empty_cache()
    return launches


def training(rows) -> None:
    """Phase 17: (k) at the edges, (f), (r), the main path (t), then (k)
    timed at the main path's shapes."""
    t0 = time.perf_counter()
    flash_bwd_edges()
    f32_launches = train_f32_grads()
    train_reduced()
    launches = training_run()
    flash_bwd_rows(rows, launches, f32_launches)
    log(f"[train] phase wall {time.perf_counter() - t0:.1f} s")


def tensor_core_kernels(lib) -> None:
    """``cuobjdump -sass`` of the built library: the HGMMA (wgmma)
    instructions of each tensor-core flash kernel, forward and backward;
    fails when a tc kernel of the backward has none."""
    from repro_torch.kernels import _build

    tool = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, name = collections.Counter(), None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
        elif name and "HGMMA" in line:
            counts[name] += 1
    for kernel in ("flash_tc_kernel", "flash_bwd_tc_pre_kernel",
                   "flash_bwd_tc_dq_kernel", "flash_bwd_tc_dkv_kernel"):
        # template instances by the head size's k-steps, D / 16 = 1 to 8
        found = {int(n.split(kernel + "ILi")[1].split("E")[0]): c
                 for n, c in counts.items() if kernel + "ILi" in n}
        assert len(found) == 8 and all(found.values()), (kernel, found)
        log(f"[build] cuobjdump -sass: {kernel} HGMMA instructions by D/16 "
            f"(1 to 8): {[found[ks] for ks in sorted(found)]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels.jaccard import ops as jac_ops
    from repro_torch.kernels.join import ops as join_ops

    t_start = time.perf_counter()
    log(f"[card] {card()}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"[build] {lib.relative_to(ROOT) if lib.is_relative_to(ROOT) else lib}"
        f" in {time.perf_counter() - t0:.2f} s")
    log((lib.parent / "build.log").read_text().strip())
    tensor_core_kernels(lib)
    _build.library()

    # record what the main path hands the kernels (the largest join's key
    # columns, those of the join with the largest probe side, the largest
    # two-column key, the largest federation segment expansion's counts,
    # the adaptation round's bitmaps)
    # for the kernel phase: references only, nothing is copied or computed
    # inside the timed windows
    rec = {"join_total": -1, "pack_n": -1, "probe_n": -1, "fed_total": -1}
    pipeline, jaccard = join_ops.hash_join_pipeline, jac_ops.jaccard_distance
    segment_ids = join_ops.expand_segment_ids

    def recording_pipeline(lcs, rcs, **kw):
        out = pipeline(lcs, rcs, **kw)
        if out[2] > rec["join_total"]:
            rec.update(join=(lcs, rcs), join_total=out[2])
        if len(lcs) == 2 and len(lcs[0]) > rec["pack_n"]:
            rec.update(pack=lcs, pack_n=len(lcs[0]))
        if len(rcs[0]) and len(lcs[0]) > rec["probe_n"]:
            rec.update(probe=(lcs, rcs), probe_n=len(lcs[0]))
        return out

    def recording_segment_ids(counts):
        out = segment_ids(counts)
        if out.shape[0] > rec["fed_total"]:
            rec.update(fed=counts, fed_total=out.shape[0])
        return out

    def recording_jaccard(bitmaps, **kw):
        if len(bitmaps) >= len(rec.get("bitmaps", ())):
            rec["bitmaps"] = bitmaps
        return jaccard(bitmaps, **kw)

    join_ops.hash_join_pipeline = recording_pipeline
    join_ops.expand_segment_ids = recording_segment_ids
    jac_ops.jaccard_distance = recording_jaccard
    launches, svc, window = main_path(rec)
    join_ops.hash_join_pipeline = pipeline
    join_ops.expand_segment_ids = segment_ids
    jac_ops.jaccard_distance = jaccard
    profile_window(svc, window)

    rows = kernels(rec, launches)
    small_input()
    bitmaps = BitmapLog()
    jaccard = bitmaps.install(jac_ops)
    paper_experiments(bitmaps)
    watdiv_drift(bitmaps)
    jac_ops.jaccard_distance = jaccard
    hac_and_jaccard(rows, bitmaps)
    del svc, window, bitmaps
    torch.cuda.empty_cache()       # the KG phases' services are gone
    lm_launches = lm_serving()
    flash_kernel(rows, lm_launches)
    torch.cuda.empty_cache()       # the qwen3 model and caches are gone
    rwkv_launches = rwkv_serving()
    wkv_kernel(rows, rwkv_launches)
    torch.cuda.empty_cache()       # the rwkv6-3b model and states are gone
    zamba_launches = zamba_serving()
    ssd_kernel(rows, zamba_launches)
    zcfg = configs.get("zamba2-7b")
    rand = _flash_rand(torch.Generator(device="cuda").manual_seed(5))
    zshape = (zcfg.n_heads, zcfg.n_kv_heads, zcfg.resolved_head_dim)
    flash_prefill_row(rows, zamba_launches, rand, "zamba2-7b", ZAMBA_BATCH,
                      ZAMBA_PROMPT, *zshape)
    flash_decode_row(rows, zamba_launches, rand, "zamba2-7b", ZAMBA_BATCH,
                     *zshape, ZAMBA_CACHE)
    for arch, prefix, param_dtype, f32_layers in MOE_PHASES:
        torch.cuda.empty_cache()   # the earlier phases' models are gone
        moe_launches, place_launches = moe_serving(arch, prefix, param_dtype,
                                                   f32_layers)
        moe_kernel_rows(rows, arch, moe_launches, place_launches)
    torch.cuda.empty_cache()       # the MoE phases' models are gone
    training(rows)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
