"""One-card dry run: the FLOPs, bytes and peak memory of every (arch ×
shape) cell on one H100, reckoned on the meta device.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles every
cell on 256- and 512-chip TPU meshes. Here each cell runs through the
port's own entry points (``lm.train_step`` with AdamW, ``lm.prefill_step``,
``lm.decode_step`` against its caches) at full width and depth on
``torch.device("meta")``: nothing is allocated, drawn or computed, so the
sweep is a reckoning, the same on any host, and needs no card. A
:class:`Reckoner` (a ``TorchDispatchMode``) counts as the ops run:

* each torch op's FLOPs (``torch.utils.flop_counter``'s formulas: the
  products), on the pipe its dtype and
  ``torch.backends.cuda.matmul.allow_tf32`` select
  (``roofline.product_pipe``), and its bytes: its tensor inputs and
  outputs, each at most its storage (a view moves none, an empty
  allocation none; ``copy_``, ``fill_`` and ``zero_`` do not read what
  they overwrite; a gather reads and writes the rows it moves, a scatter
  reads them, reads and writes the rows it adds into). Eager PyTorch fuses
  nothing, so this is the HBM traffic, L2 aside;
* each kernel op (flash attention, WKV and SSD, forward and backward:
  ``kernels.dispatch.kernel_op``) as one unit with ``launch.roofline``'s
  cost for the route the card takes at its shapes; the torch ops inside
  it are not counted again;
* the peak of live bytes: from the weights, float32 masters, AdamW state,
  batch and caches that exist before the step, each storage the step
  allocates is added once (a view adds nothing) and subtracted when it is
  freed. Autograd's saved tensors live until the backward frees them, so
  the peak depends on ``remat``.

Each op's own bound is max(its operations over its pipe's rate, its bytes
over 3.35 TB/s); the record gives their sum (the bound of an eager step,
``roofline.t_eager``) beside the reference's max of the totals (with
``dominant``).

Deliberate deviations from the reference: every layer is counted, where
the reference extrapolates from 1- and 2-layer unrolled compiles (its
``extrapolated_costs``) only because XLA counts a loop body once; no mesh
(``launch/mesh.py`` and ``sharding.py`` place tensors across chips, and on
one card every spec is replicated) and no collectives (``hlo_analysis.py``
parses XLA's HLO, and one card moves no byte over a link); on meta the MoE
routes are balanced (``models.moe.meta_routes``) and the record says
``routes: balanced``. A decode cell reads its whole cache (``pos`` is its
last slot).

Usage (the card is not needed):
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out results/dryrun_torch]
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
      --set use_flash=True --fit batch
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ArchConfig, shape_supported
from repro_torch.kernels import dispatch
from repro_torch.launch import roofline
from repro_torch.models import lm, transformer
from repro_torch.optim import AdamWConfig, adamw_init

# a view the schema does not mark as one
_VIEWS = frozenset(("_unsafe_view",))
_NO_WRITE = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                       "new_empty_strided"))
_OVERWRITE = frozenset(("copy_", "fill_", "zero_"))
_GATHER = frozenset(("index_select", "gather", "index", "embedding"))
_SCATTER = frozenset(("index_add_", "scatter_add_", "scatter_", "index_put_",
                      "index_copy_"))
_aten = torch.ops.aten
COLLECTIVE_KINDS = ("all_gather", "all_reduce", "reduce_scatter",
                    "all_to_all", "collective_permute")
TOP_OPS = 10


def _nbytes(t: torch.Tensor) -> int:
    """The bytes an op moves for ``t``: its elements, at most its
    storage (a broadcast view is read once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _op_tensors(args, kwargs) -> List[torch.Tensor]:
    """The tensors among an op's arguments (an op's lists nest once)."""
    out = []
    for x in (*args, *kwargs.values()):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _product_flops(func, args) -> Optional[int]:
    """2·m·k·n of ``mm``, ``addmm`` and ``bmm`` from their shapes (the
    flop counter's formulas, without its tree walks); None for other
    ops."""
    if func is _aten.mm.default:
        (m, k), n = args[0].shape, args[1].shape[1]
        return 2 * m * k * n
    if func is _aten.addmm.default:
        (m, k), n = args[1].shape, args[2].shape[1]
        return 2 * m * k * n
    if func is _aten.bmm.default:
        (b, m, k), n = args[0].shape, args[1].shape[2]
        return 2 * b * m * k * n
    return None


@dataclasses.dataclass
class OpRecord:
    name: str
    ops: Dict[str, int]           # pipe -> operations
    bytes: int

    def bound_seconds(self) -> float:
        return roofline.KernelCost(self.bytes, self.ops).bound_seconds()


def unit_cost(op: str, route: str, args, kwargs) -> roofline.KernelCost:
    """``launch.roofline``'s cost of one kernel op call on ``route``."""
    if op.startswith("flash_attention"):
        q, k = args[0], args[1]
        if op == "flash_attention.fwd":
            causal, q_offset, kv_valid_len = args[3:6]
        else:
            causal, q_offset, kv_valid_len = (
                kwargs["causal"], kwargs["q_offset"], kwargs["kv_valid_len"])
        b, s, h, d = q.shape
        fn = (roofline.flash_fwd_cost if op == "flash_attention.fwd"
              else roofline.flash_bwd_cost)
        return fn(b, s, k.shape[1], h, k.shape[2], d, q.dtype, causal,
                  q_offset, kv_valid_len)
    shape = tuple(args[0].shape)
    if op.startswith("mamba2_ssd"):
        shape += (args[1].shape[-1],)          # the state size N
    return _SCAN_COSTS[op, route == "tc"](*shape)


# the cost of each WKV and SSD op by (op, on the tc route); the rec and
# dec routes compute the function as the recurrence does
_SCAN_COSTS = {
    ("wkv", True): roofline.wkv_tc_cost,
    ("wkv", False): roofline.wkv_rec_cost,
    ("wkv.bwd", True): roofline.wkv_bwd_tc_cost,
    ("wkv.bwd", False): roofline.wkv_bwd_rec_cost,
    ("mamba2_ssd", True): roofline.ssd_tc_cost,
    ("mamba2_ssd", False): roofline.ssd_rec_cost,
    ("mamba2_ssd.bwd", True): roofline.ssd_bwd_tc_cost,
    ("mamba2_ssd.bwd", False): roofline.ssd_bwd_rec_cost,
}


class Reckoner(TorchDispatchMode):
    """Counts every op's FLOPs and bytes and the peak of live bytes while
    it is entered (see the module docstring); kernel ops as units."""

    def __init__(self):
        super().__init__()
        self.records: List[OpRecord] = []
        self.live = self.peak = 0
        self._held: Dict[int, tuple] = {}
        self._depth = 0
        self._flops = FlopCounterMode(display=False).flop_registry
        self._kind: Dict = {}
        self._old_units = None

    # ---- memory -------------------------------------------------------- #
    def hold(self, tensors) -> int:
        """Count ``tensors``' storages live (each once); returns the bytes
        this adds."""
        added = 0
        for t in _tensors(tensors):
            added += self._track(t)
        return added

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return 0
        n = st.nbytes()
        self._held[key] = (weakref.ref(st, lambda _, k=key: self._free(k)),
                           n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def _free(self, key: int) -> None:
        _, n = self._held.pop(key)
        self.live -= n

    # ---- ops ----------------------------------------------------------- #
    def __enter__(self):
        self._old_units = dispatch.set_units(self.unit)
        return super().__enter__()

    def __exit__(self, *exc):
        dispatch.set_units(self._old_units)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def unit(self, op: str, route: str, args, kwargs):
        """One kernel op: its cost from ``launch.roofline``, not the torch
        ops it runs (their storages still count live)."""
        if self._depth:
            yield
            return
        cost = unit_cost(op, route, args, kwargs)
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
        self.records.append(OpRecord(f"{op}[{route}]", dict(cost.ops),
                                     cost.bytes))

    def _op_kind(self, func) -> str:
        kind = self._kind.get(func)
        if kind is None:
            name = func.overloadpacket.__name__
            sc = func._schema
            if (not sc.is_mutable and sc.returns and all(
                    r.alias_info is not None for r in sc.returns)) \
                    or torch.Tag.inplace_view in func.tags \
                    or name in _VIEWS:
                kind = "view"
            elif name in _NO_WRITE:
                kind = "alloc"
            elif name in _OVERWRITE:
                kind = "overwrite"
            elif name in _GATHER:
                kind = "gather"
            elif name in _SCATTER:
                kind = "scatter"
            else:
                kind = "op"
            self._kind[func] = kind
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = ([out] if isinstance(out, torch.Tensor) else
                _tensors(out))
        for t in outs:
            self._track(t)
        if self._depth:
            return out
        kind = self._op_kind(func)
        if kind in ("view", "alloc"):
            return out
        ins = _op_tensors(args, kwargs)
        if kind == "gather":
            n_bytes = (sum(_nbytes(t) for t in ins[1:])
                       + 2 * sum(_nbytes(t) for t in outs))
        elif kind == "scatter":
            n_bytes = (sum(_nbytes(t) for t in ins[1:])
                       + 2 * _nbytes(ins[-1]))
        else:
            if kind == "overwrite":
                ins = ins[1:]
            n_bytes = (sum(_nbytes(t) for t in ins)
                       + sum(_nbytes(t) for t in outs))
        ops = {}
        packet = func.overloadpacket
        flops = _product_flops(func, args)
        if flops is None and packet in self._flops:
            flops = int(self._flops[packet](*args, **kwargs, out_val=out))
        if flops:
            ops[roofline.product_pipe(ins[0].dtype)] = flops
        self.records.append(OpRecord(f"aten.{packet.__name__}", ops,
                                     n_bytes))
        return out

    # ---- totals -------------------------------------------------------- #
    def totals(self) -> dict:
        by_pipe: Dict[str, int] = collections.Counter()
        n_bytes = 0
        eager = 0.0
        for r in self.records:
            by_pipe.update(r.ops)
            n_bytes += r.bytes
            eager += r.bound_seconds()
        return {"flops": float(sum(by_pipe.values())),
                "bytes accessed": float(n_bytes),
                "flops by pipe": dict(by_pipe), "eager seconds": eager}

    def per_op(self, top: int = TOP_OPS) -> list:
        """The ``top`` costliest ops by the sum of their calls' bounds."""
        agg: Dict[str, dict] = {}
        for r in self.records:
            a = agg.setdefault(r.name, {"name": r.name, "calls": 0,
                                        "flops": 0, "bytes": 0,
                                        "bound_s": 0.0})
            a["calls"] += 1
            a["flops"] += sum(r.ops.values())
            a["bytes"] += r.bytes
            a["bound_s"] += r.bound_seconds()
        return sorted(agg.values(), key=lambda a: -a["bound_s"])[:top]


@dataclasses.dataclass
class Reckoning:
    """One step of one cell on meta: the reckoner and what existed before
    the step, by part."""
    reckoner: Reckoner
    held: Dict[str, int]
    n_params_counted: int
    grads_bytes: int


def reckon(cfg: ArchConfig, shape_name: str,
           batch_override: Optional[int] = None,
           device="meta") -> Reckoning:
    """Run one step of the cell ``(cfg, shape_name)`` (``batch_override``
    sequences where given) under a :class:`Reckoner`, through
    ``lm.train_step`` with AdamW, ``lm.prefill_step`` or ``lm.decode_step``
    as its kind says. On ``device="meta"`` (the dry run) the weights come
    from ``lm.meta_flat`` and the inputs from ``lm.input_specs`` and
    ``lm.cache_specs``; on another device (a test's check of the
    accounting) real weights are drawn (``lm.init_flat``, seed 0) and
    inputs made (``lm.make_batch``, seed 0)."""
    info = SHAPES[shape_name]
    kind = info["kind"]
    s = info["seq_len"]
    dev = dispatch.resolve_device(device)
    if dev.type == "meta":
        flat = lm.meta_flat(cfg)
        batch = lm.input_specs(cfg, shape_name, batch_override)
        caches = (lm.cache_specs(cfg, shape_name, batch_override)
                  if kind == "decode" else None)
    else:
        import numpy as np
        flat = lm.init_flat(cfg, device=dev)
        batch = lm.make_batch(cfg, shape_name, np.random.default_rng(0),
                              batch_override, device=dev)
        caches = (transformer.init_decode_caches(
            cfg, batch["token"].shape[0], s, device=dev)
            if kind == "decode" else None)
    if kind == "decode":
        batch = dict(batch, pos=s - 1)
    model = transformer.Transformer(cfg, flat)
    opt_state = None
    if kind == "train":
        lm.make_trainable(model, cfg, flat)
        opt_state = adamw_init(lm.trainable(model))
    del flat              # what the model keeps of it stays alive there
    weights = list(model.parameters()) + list(model.buffers())
    masters = list((getattr(model, "master", None) or {}).values())
    grads = sum(p.numel() * p.element_size() for p in model.parameters()
                if p.requires_grad)
    rk = Reckoner()
    held = {"weights": rk.hold(weights), "masters": rk.hold(masters),
            "adamw": rk.hold(opt_state), "inputs": rk.hold((batch, caches))}
    n_params = sum(p.numel() for p in model.parameters())
    with rk:
        if kind == "train":
            lm.train_step(model, opt_state, batch, cfg, AdamWConfig())
        elif kind == "prefill":
            lm.prefill_step(model, batch, cfg)
        else:
            lm.decode_step(model, caches, batch, cfg)
    return Reckoning(rk, held, n_params, grads)


def _cell_tokens(shape_name: str, batch: int) -> int:
    info = SHAPES[shape_name]
    return batch * info["seq_len"] if info["kind"] != "decode" else batch


def _config(arch: str, overrides: Optional[dict] = None) -> ArchConfig:
    cfg = configs.get(arch)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _batch(shape_name: str, batch_override: Optional[int]) -> int:
    return batch_override or SHAPES[shape_name]["global_batch"]


def _record(cfg: ArchConfig, shape_name: str,
            batch_override: Optional[int] = None) -> dict:
    """:func:`analyze_cell`'s record without its batch-1 figures."""
    kind = SHAPES[shape_name]["kind"]
    batch = _batch(shape_name, batch_override)
    rec = reckon(cfg, shape_name, batch_override)
    rk = rec.reckoner
    cost = rk.totals()
    n_tokens = _cell_tokens(shape_name, batch)
    mf = roofline.model_flops(cfg, shape_name, n_tokens, kind)
    rf = roofline.build(cost, {"total_bytes": 0}, 1, mf)
    memory = dict(peak_bytes=rk.peak, start_bytes=sum(rec.held.values()),
                  weights_bytes=rec.held["weights"],
                  masters_bytes=rec.held["masters"],
                  grads_bytes=rec.grads_bytes if kind == "train" else 0,
                  adamw_bytes=rec.held["adamw"],
                  inputs_bytes=rec.held["inputs"],
                  capacity_bytes=roofline.H100_MEMORY_BYTES)
    coll = {f"{k}_{what}": 0 for k in COLLECTIVE_KINDS
            for what in ("bytes", "count")}
    coll.update(total_bytes=0, total_count=0)
    out = dict(
        arch=cfg.arch_id, shape=shape_name, kind=kind, n_chips=1,
        batch=batch, n_tokens=n_tokens, n_params=cfg.n_params(),
        n_active_params=cfg.n_active_params(),
        n_params_counted=rec.n_params_counted,
        remat=cfg.remat if kind == "train" else None,
        use_flash=cfg.use_flash,
        cost={k: cost[k] for k in ("flops", "bytes accessed",
                                   "flops by pipe")},
        memory=memory, collectives=coll, roofline=rf.to_dict(),
        per_op=rk.per_op(), n_ops=len(rk.records))
    if cfg.is_moe:
        out["routes"] = "balanced"
    return out


def _with_batch_1(rec: dict, peak_batch_1: int) -> dict:
    cap = roofline.H100_MEMORY_BYTES
    rec["memory"]["peak_bytes_batch_1"] = peak_batch_1
    rec["fits_one_h100"] = {"batch": rec["memory"]["peak_bytes"] <= cap,
                            "batch_1": peak_batch_1 <= cap}
    return rec


def _peak(cfg: ArchConfig, shape_name: str, batch: int) -> int:
    """The reckoned peak of one cell's step at ``batch`` sequences."""
    return reckon(cfg, shape_name, batch).reckoner.peak


def analyze_cell(cfg: ArchConfig, shape_name: str,
                 batch_override: Optional[int] = None) -> dict:
    """The record of one cell: the reference's keys (``n_chips`` 1,
    collectives 0), ``n_params_counted``, ``fits_one_h100`` at the cell's
    batch and at batch 1, and ``per_op``, the ten costliest ops."""
    rec = _record(cfg, shape_name, batch_override)
    peak1 = (rec["memory"]["peak_bytes"] if rec["batch"] == 1
             else _peak(cfg, shape_name, 1))
    return _with_batch_1(rec, peak1)


def _line(name: str, rec: dict) -> str:
    if rec.get("skipped"):
        return f"[skip] {name}: {rec['reason']}"
    if "error" in rec:
        return f"[FAIL] {name}: {rec['error'][:200]}"
    r, m = rec["roofline"], rec["memory"]
    return (f"[ok]   {name}: {rec['reckon_s']}s batch {rec['batch']} peak "
            f"{m['peak_bytes'] / 2**30:.2f} GiB (fits "
            f"{rec['fits_one_h100']['batch']}; at batch 1 "
            f"{m['peak_bytes_batch_1'] / 2**30:.2f} GiB) "
            f"dominant={r['dominant']} t=(c {r['t_compute'] * 1e3:.2f} | m "
            f"{r['t_memory'] * 1e3:.2f}) ms eager {r['t_eager'] * 1e3:.2f} "
            f"ms frac={r['roofline_fraction']:.3f} (reckoned on meta)")


def _cell_job(arch: str, shape_name: str, overrides: Optional[dict],
              batch_override: Optional[int], what: str):
    """One job of the sweep: the cell's record (``"cell"``, without its
    batch-1 figures), its step's peak at batch 1 (``"batch_1"``), or the
    skip reason; an error is recorded, and the sweep goes on."""
    cfg = _config(arch, overrides)
    ok, reason = shape_supported(cfg, shape_name)
    if not ok:
        return dict(arch=arch, shape=shape_name, skipped=True, reason=reason)
    t0 = time.time()
    try:
        if what == "batch_1":
            return _peak(cfg, shape_name, 1)
        rec = _record(cfg, shape_name, batch_override)
        rec.update(skipped=False, reckon_s=round(time.time() - t0, 2))
        return rec
    except Exception as e:  # noqa: BLE001 — record it, keep sweeping
        return dict(arch=arch, shape=shape_name, skipped=False,
                    error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:],
                    reckon_s=round(time.time() - t0, 2))


def _cost_guess(arch: str, shape_name: str) -> int:
    cfg = configs.get(arch)
    train = SHAPES[shape_name]["kind"] == "train"
    return cfg.n_layers * max(cfg.n_experts, 1) * (3 if train else 1)


def sweep(archs, shapes, out_dir: Optional[Path],
          overrides: Optional[dict] = None, tag: str = "",
          batch_override: Optional[int] = None, workers: int = 1) -> list:
    """Every (arch, shape) cell's record (or the reference's skip reason,
    or the error), each written to ``out_dir`` where given and a line
    printed, in order; ``workers`` processes (spawned) share the steps,
    the costliest first, each cell's batch-1 step apart."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    cells = [(a, s) for a in archs for s in shapes]
    jobs = [(c, "cell") for c in cells] + [
        (c, "batch_1") for c in cells
        if shape_supported(_config(c[0], overrides), c[1])[0]
        and _batch(c[1], batch_override) != 1]
    out = []
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = {(c, what): ex.submit(_cell_job, *c, overrides,
                                     batch_override, what)
                for c, what in sorted(jobs, key=lambda j: -_cost_guess(
                    *j[0]))}
        for a, s in cells:
            rec = futs[(a, s), "cell"].result()
            if not rec.get("skipped") and "error" not in rec:
                p1 = (rec["memory"]["peak_bytes"] if rec["batch"] == 1
                      else futs[(a, s), "batch_1"].result())
                if isinstance(p1, dict):            # its batch-1 step failed
                    rec = p1
                else:
                    _with_batch_1(rec, p1)
            name = f"{a}__{s}" + (f"__{tag}" if tag else "")
            print(_line(name, rec), flush=True)
            if out_dir is not None:
                (out_dir / f"{name}.json").write_text(
                    json.dumps(rec, indent=1))
            out.append(rec)
    return out


def largest_fitting(cfg: ArchConfig, shape_name: str, field: str,
                    hi: int, batch_override: Optional[int] = None) -> int:
    """The largest ``field`` (``batch``, or ``n_layers`` at
    ``batch_override`` sequences or the shape's) in [1, ``hi``] whose
    step's reckoned peak fits 80 GB (0 if none does), by bisection."""
    def fits(n: int) -> bool:
        if field == "batch":
            peak = _peak(cfg, shape_name, n)
        else:
            peak = _peak(dataclasses.replace(cfg, n_layers=n), shape_name,
                         _batch(shape_name, batch_override))
        return peak <= roofline.H100_MEMORY_BYTES
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def parse_overrides(pairs) -> dict:
    """``--set k=v`` pairs as the reference parses them."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            v = v == "True"
        elif v.isdigit():
            v = int(v)
        else:
            try:
                v = float(v)
            except ValueError:
                pass
        overrides[k] = v
    return overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences a step, in place of the shape's")
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides, e.g. --set remat=dots")
    ap.add_argument("--workers", type=int, default=4,
                    help="processes that share the cells' steps")
    ap.add_argument("--fit", choices=["batch", "n_layers"], default=None,
                    help="bisect for the largest batch (up to the shape's) "
                         "or depth (up to the config's) whose reckoned "
                         "peak fits 80 GB")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    archs = configs.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    t0 = time.time()
    if args.fit:
        for arch in archs:
            cfg = _config(arch, overrides)
            for shape_name in shapes:
                if not shape_supported(cfg, shape_name)[0]:
                    continue
                hi = (SHAPES[shape_name]["global_batch"]
                      if args.fit == "batch" else cfg.n_layers)
                best = largest_fitting(cfg, shape_name, args.fit, hi,
                                       args.batch)
                at = ("" if args.fit == "batch" else
                      f" at batch {_batch(shape_name, args.batch)}")
                print(f"[fit] {arch} {shape_name} {overrides or ''}: the "
                      f"largest {args.fit}{at} up to {hi} whose reckoned peak "
                      f"fits {roofline.H100_MEMORY_BYTES / 1e9:.0f} GB: "
                      f"{best} (reckoned on meta)", flush=True)
    else:
        out_dir = Path(args.out)
        out_dir.mkdir(parents=True, exist_ok=True)
        sweep(archs, shapes, out_dir, overrides or None, args.tag,
              args.batch, args.workers)
    print(f"[dryrun] {len(archs) * len(shapes)} cells in "
          f"{time.time() - t0:.1f} s (host clock, {args.workers} "
          f"workers)")


if __name__ == "__main__":
    main()
