"""Smoke run of repro_torch on one CUDA card: build the kernels, hold each
against its plain PyTorch version, drive the AWAPart serving loop end to
end on the card, and report.

    python3 chip_smoke.py

Phases (any failure raises and ends the run with a nonzero exit):

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (``nvcc`` over ``src/repro_torch/csrc/``, into ``build/repro_torch/``);
2. the main path: ``repro_torch.api.KGService.from_dataset(lubm.load(10),
   n_shards=8)`` on the card — ``bootstrap``, three windows of the
   extended workload (the first executes, the repeats are result-cache
   hits), ``adapt(EQ1..EQ10)``, then windows served while the accepted
   migration drains under a 4 MiB per-window budget. Every window is held
   against the port's ``NumpyExecutor`` on the same facade and epoch
   (bindings and every ``ExecStats.COMPARABLE`` field). Kernel launch
   counts are reset just before and read just after; all five kernels must
   have launched;
3. a profile: the window executed again at the final layout, once under
   ``cProfile`` (host functions by self time) and once under
   ``torch.profiler`` (wall time, the card's busy time and idle share);
4. the kernels: each against its plain PyTorch version on the card, at the
   largest shapes the main path gave it and at edge cases, exactly (the
   Jaccard kernel bitwise), with the device time per call (profiler) of
   the kernel, the plain version and, where one exists, the PyTorch
   library call computing the same function, beside the bound from bytes
   and operations, and the per-call time with launch overhead (CUDA
   events);
5. a small input: the LUBM(1) drain loop on the card and on the CPU must
   give byte-identical traces, windows and layouts.

The line before the last is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import cProfile
import json
import math
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
MIGRATION_BUDGET = 4 << 20       # bytes per window: LUBM(10)/8 drains in 4
# windows served before the adaptation round: the guard amortizes the
# migration over the observed TM window, and one window of LUBM(10)/8 is
# too few to pay for this round's 11.9 MB plan
WARM_WINDOWS = 3


def log(*args) -> None:
    print(*args, flush=True)


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


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call: the summed durations of every CUDA kernel and
    memory operation ``fn`` puts on the card, from a ``torch.profiler``
    trace of ``reps`` calls after a warm-up call. Excludes host launch
    overhead and the idle gaps between launches; 0 for a call that puts no
    work on the card (the plain one-column pack returns its input)."""
    fn()
    torch.cuda.synchronize()
    prof = torch.profiler
    with prof.profile(activities=[prof.ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in p.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / reps


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


def profile_window(svc, window) -> None:
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
    log(f"[profile] host profile (cProfile, {host_ms:.1f} ms wall with its "
        "overhead), functions by self time:")
    rows = sorted(pstats.Stats(host).stats.items(),
                  key=lambda kv: -kv[1][2])[:12]
    for (path, line, func), (_, ncalls, self_s, cum_s, _) in rows:
        where = f"{pathlib.Path(path).name}:{line}({func})"
        log(f"[profile]   self {self_s * 1e3:8.1f} ms  cum {cum_s * 1e3:8.1f}"
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
    log(f"[profile] window at the final layout: wall {wall * 1e3:.1f} ms, "
        f"device busy {busy * 1e3:.3f} ms, idle share "
        f"{1 - busy / wall:.4f}, {len(dev)} device operations")
    for name, (n, t_us) in top:
        log(f"[profile]   {t_us / 1e3:9.3f} ms  {n:5d}x  {name[:90]}")


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


def kernels(rec, launches):
    from repro_torch.kernels.jaccard import ops as jac
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
    vals = t(rng.integers(0, 2**40, 500))
    idx = t(rng.integers(-50, 550, 2000))
    _exact("gather edge", J.gather_rows(vals, idx, fill=-1),
           J.gather_rows_plain(vals, idx, -1))
    _exact("gather empty table", J.gather_rows(t([]), idx, fill=7),
           J.gather_rows_plain(t([]), idx, 7))
    for k in (1, 2):
        cols = t(rng.integers(0, 2**31, (k, 1000)))
        _exact("pack edge", J.pack_keys(cols), J.pack_keys_plain(cols))
    for q, w in ((1, 1), (13, 1), (130, 7), (33, 64)):
        a = torch.from_numpy(rng.integers(-2**31, 2**31, (q, w))
                             .astype(np.int32)).to(dev)
        a[::4] = 0                                  # empty sets
        got, want = jac.distance(a, a), jac.distance_plain(a, a)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.cuda.synchronize()
    log("[kernels] edge cases: all five kernels match their plain versions")

    rows = []

    def report(name, source, replaces, err, fn, plain, library,
               n_bytes, n_ops, note):
        ms, plain_ms = device_ms(fn), device_ms(plain)
        assert ms > 0, f"{name}: the profiler recorded no kernel time"
        library_ms = None if library is None else device_ms(library)
        calls = [call_ms(f) for f in (fn, plain)]
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / SCALAR_OPS_PER_S) \
            * 1e3
        bound_by = ("bytes" if n_bytes / HBM_BYTES_PER_S
                    >= n_ops / SCALAR_OPS_PER_S else "operations")
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches.get(name, 0),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"[kernels] {name} ({note}): device time per call: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}; per "
            f"call with launch overhead: kernel {calls[0]:.4f} ms, plain "
            f"{calls[1]:.4f} ms; bound {bound_ms:.6f} ms "
            f"({bound_by}: {n_bytes} B / 3.35 TB/s, {n_ops} ops / "
            f"67 TOP/s), main-path launches {launches.get(name, 0)}, "
            f"max_abs_err {err}")

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

    lcs, rcs = rec["join"]
    lk_cols = t(np.stack(lcs))
    rk_cols = t(np.stack(rcs))
    k, n = lk_cols.shape
    m = rk_cols.shape[1]
    log(f"[kernels] largest main-path join: probe side {n} rows, build "
        f"side {m} rows, {k} key column(s), {rec['join_total']} pairs")

    # probe, over the stably sorted packed build side
    lk = J.pack_keys(lk_cols)
    rk_sorted, order = torch.sort(J.pack_keys(rk_cols), stable=True)
    lo, counts = J.probe_sorted(rk_sorted, lk)
    err = _exact("probe", (lo, counts), J.probe_sorted_plain(rk_sorted, lk))
    # two binary searches per probe key read at most ``steps`` build keys
    # each key, and never more than the whole build side
    steps = 2 * math.ceil(math.log2(m + 1))
    report("probe", join_src, f"{join_ref}:127", err,
           lambda: J.probe_sorted(rk_sorted, lk),
           lambda: J.probe_sorted_plain(rk_sorted, lk),
           lambda: (torch.searchsorted(rk_sorted, lk),
                    torch.searchsorted(rk_sorted, lk, right=True)),
           min(8 * m, 8 * n * steps) + 8 * n + 16 * n, 2 * steps * n,
           f"M={m}, N={n}; library = searchsorted left + right")

    # expand, of the probe's match runs
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
           16 * n + 16 * total, 2 * math.ceil(math.log2(n + 1)) * total,
           f"segments={n}, total={total}; library = repeat_interleave "
           "(li only)")

    # gather: ri = order[pos]
    err = _exact("gather", J.gather_rows(order, pos),
                 J.gather_rows_plain(order, pos))
    report("gather", join_src, f"{join_ref}:234", err,
           lambda: J.gather_rows(order, pos),
           lambda: J.gather_rows_plain(order, pos),
           lambda: order[pos],
           8 * min(m, total) + 16 * total, 2 * total,
           f"M={m}, N={total}; library = order[pos]")

    # jaccard, on the adaptation round's workload bitmaps
    bm = rec["bitmaps"]
    a = torch.from_numpy(np.ascontiguousarray(bm, np.uint32)
                         .view(np.int32)).to(dev)
    q, w = a.shape
    got, want = jac.distance(a, a), jac.distance_plain(a, a)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        "jaccard: kernel not bitwise equal to its plain version"
    report("jaccard", "src/repro_torch/csrc/jaccard.cu",
           "src/repro/kernels/jaccard/kernel.py:45",
           float((got - want).abs().max()),
           lambda: jac.distance(a, a),
           lambda: jac.distance_plain(a, a), None,
           4 * 2 * q * w + 4 * q * q, 4 * q * q * w + 2 * q * q,
           f"Q={q}, W={w}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.jaccard import ops as jac_ops
    from repro_torch.kernels.join import ops as join_ops

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"[card] {smi[0]}; {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"[build] {lib.relative_to(ROOT) if lib.is_relative_to(ROOT) else lib}"
        f" in {time.perf_counter() - t0:.2f} s")
    log((lib.parent / "build.log").read_text().strip())
    _build.library()

    # record what the main path hands the kernels (the largest join's key
    # columns, the largest two-column key, the adaptation round's bitmaps)
    # for the kernel phase: references only, nothing is copied or computed
    # inside the timed windows
    rec = {"join_total": -1, "pack_n": -1}
    pipeline, jaccard = join_ops.hash_join_pipeline, jac_ops.jaccard_distance

    def recording_pipeline(lcs, rcs, **kw):
        out = pipeline(lcs, rcs, **kw)
        if out[2] > rec["join_total"]:
            rec.update(join=(lcs, rcs), join_total=out[2])
        if len(lcs) == 2 and len(lcs[0]) > rec["pack_n"]:
            rec.update(pack=lcs, pack_n=len(lcs[0]))
        return out

    def recording_jaccard(bitmaps, **kw):
        if len(bitmaps) >= len(rec.get("bitmaps", ())):
            rec["bitmaps"] = bitmaps
        return jaccard(bitmaps, **kw)

    join_ops.hash_join_pipeline = recording_pipeline
    jac_ops.jaccard_distance = recording_jaccard
    launches, svc, window = main_path(rec)
    join_ops.hash_join_pipeline = pipeline
    jac_ops.jaccard_distance = jaccard
    profile_window(svc, window)

    rows = kernels(rec, launches)
    small_input()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(smi[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
