"""The one-card dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.launch.roofline``) on the CPU.

* For every config and shape cell, the port's ``shape_supported``,
  ``lm.input_specs`` (names, shapes, dtypes), ``lm.cache_specs`` (leaf for
  leaf) and ``roofline.model_flops`` equal the reference's, whose specs
  come from ``jax.eval_shape``; ``lm.param_shapes``' total equals the size
  of ``jax.eval_shape(transformer.init_params)`` for each full config.
* The accounting: on reduced configs (2 layers, d 64) at a tiny shape of
  each kind, the step's record on the meta device equals the record of
  the same step run on the CPU with real tensors, op for op, in FLOPs and
  bytes (flash on and off, every remat). For the MoE configs the meta
  routes are balanced: with the CPU run's own routes put in their place
  the two agree op for op (the CPU's reading of the routes aside); with
  the balanced ones the FLOPs agree, and a serving step's bytes differ by
  the weights of the experts that got no token on the CPU, no more.
* The reckoned bytes of weights, float32 masters and AdamW state equal the
  real tensors' ``nbytes``; the reckoned peak orders remat ``none`` >=
  ``dots`` >= ``full`` on a full-size training cell.
* The kernel costs moved from ``chip_smoke.py`` return the bounds
  ``PERF.md`` records at the shapes it gives.
* The CLI writes a record with the reference's keys (``n_chips`` 1, no
  collective byte) and the reference's skip reason, and loads neither
  ``jax`` nor ``repro``.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.configs.base import shape_supported as r_shape_supported
from repro.launch import roofline as rroofline
from repro.models import lm as rlm
from repro.models import transformer as rtr
import repro_torch.configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.jaccard import ops as JAC
from repro_torch.launch import dryrun, roofline
from repro_torch.models import lm as tlm
from repro_torch.models import moe
from repro_torch.obs import metrics as obs_metrics

REPO = Path(__file__).resolve().parent.parent
ARCHS = tconfigs.ARCH_IDS
SHAPES = list(tbase.SHAPES)
# tiny cells of each kind for the reduced configs
TINY = {"tiny_train": dict(seq_len=64, global_batch=2, kind="train"),
        "tiny_prefill": dict(seq_len=64, global_batch=2, kind="prefill"),
        "tiny_decode": dict(seq_len=64, global_batch=2, kind="decode")}
MOE = ("olmoe-1b-7b", "qwen3-moe-30b-a3b")
# the CPU's reading of the routes (``moe_apply``): meta cannot read them
ROUTING_READ = ("aten.bincount", "aten._to_copy", "aten.cat")


@pytest.fixture
def tiny_shapes(monkeypatch):
    for name, info in TINY.items():
        monkeypatch.setitem(tbase.SHAPES, name, info)


def _spec(x) -> tuple:
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    name = (str(x.dtype).removeprefix("torch.")
            if isinstance(x.dtype, torch.dtype) else np.dtype(x.dtype).name)
    return tuple(x.shape), name


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_specs_and_model_flops_match_the_reference(arch):
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    for shape in SHAPES:
        assert tbase.shape_supported(tcfg, shape) == \
            r_shape_supported(rcfg, shape), (arch, shape)
        want = rlm.input_specs(rcfg, shape)
        got = tlm.input_specs(tcfg, shape)
        assert set(got) == set(want), (arch, shape)
        for k in want:
            assert got[k].device.type == "meta"
            assert _spec(got[k]) == _spec(want[k]), (arch, shape, k)
        info = tbase.SHAPES[shape]
        n_tokens = (info["global_batch"] * info["seq_len"]
                    if info["kind"] != "decode" else info["global_batch"])
        assert roofline.model_flops(tcfg, shape, n_tokens, info["kind"]) \
            == rroofline.model_flops(rcfg, shape, n_tokens, info["kind"])
        if info["kind"] != "decode" or not tcfg.has_decode:
            continue
        want = rlm.cache_specs(rcfg, shape)
        got = tlm.cache_specs(tcfg, shape)
        assert set(got) == set(want), (arch, shape)
        for k in want:
            assert got[k].device.type == "meta"
            assert _spec(got[k]) == _spec(want[k]), (arch, shape, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_total_equals_the_reference_init(arch):
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    tree = jax.eval_shape(
        lambda: rtr.init_params(jax.random.PRNGKey(0), rcfg)[0])
    leaves = jax.tree_util.tree_leaves(tree)
    want = sum(int(np.prod(x.shape)) for x in leaves)
    shapes = tlm.param_shapes(tcfg)
    assert sum(int(np.prod(s)) for s in shapes.values()) == want
    assert len(shapes) == len(leaves)
    flat = tlm.meta_flat(tcfg)
    assert {k: tuple(v.shape) for k, v in flat.items()} == shapes
    assert all(v.device.type == "meta" for v in flat.values())


def _records(rk):
    return [(r.name, dict(r.ops), r.bytes) for r in rk.records]


def _reduced(arch, flash, remat="none"):
    cfg = tconfigs.get(arch).reduced()
    return dataclasses.replace(cfg, use_flash=flash and bool(cfg.n_heads),
                               remat=remat)


DENSE_CASES = [(a, f) for a in ARCHS if a not in MOE
               for f in ((True, False) if tconfigs.get(a).n_heads
                         else (False,))]


@pytest.mark.parametrize("arch, flash", DENSE_CASES,
                         ids=[f"{a}-flash{int(f)}" for a, f in DENSE_CASES])
def test_meta_record_equals_the_cpu_record_op_for_op(arch, flash,
                                                     tiny_shapes):
    for shape in TINY:
        cfg = _reduced(arch, flash)
        if shape == "tiny_decode" and not cfg.has_decode:
            continue
        meta = dryrun.reckon(cfg, shape).reckoner
        cpu = dryrun.reckon(cfg, shape, device="cpu").reckoner
        assert _records(meta) == _records(cpu), (arch, shape)
        assert any(r.ops for r in meta.records), (arch, shape)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b", "rwkv6-3b",
                                  "hubert-xlarge"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_meta_record_equals_the_cpu_record_under_remat(arch, remat,
                                                       tiny_shapes):
    cfg = _reduced(arch, True, remat)
    meta = dryrun.reckon(cfg, "tiny_train").reckoner
    cpu = dryrun.reckon(cfg, "tiny_train", device="cpu").reckoner
    assert _records(meta) == _records(cpu)


def _cpu_with_routes(cfg, shape, monkeypatch):
    """The CPU record, its routing read dropped, and each MoE call's
    group sizes."""
    seen = []
    real = torch.bincount

    def recording(x, *args, **kwargs):
        out = real(x, *args, **kwargs)
        seen.append(out.tolist())
        return out
    with monkeypatch.context() as m:
        m.setattr(torch, "bincount", recording)
        rk = dryrun.reckon(cfg, shape, device="cpu").reckoner
    recs, out, i = _records(rk), [], 0
    while i < len(recs):
        if recs[i][0] == ROUTING_READ[0]:
            assert tuple(r[0] for r in recs[i:i + 3]) == ROUTING_READ
            i += 3
            continue
        out.append(recs[i])
        i += 1
    return rk, out, seen


@pytest.mark.parametrize("arch", MOE)
def test_moe_meta_record_with_the_cpu_routes_and_balanced(arch, tiny_shapes,
                                                          monkeypatch):
    cfg = _reduced(arch, True)
    per_expert = 3 * cfg.d_model * cfg.d_ff * 4       # wg, wi, wo float32
    for shape in TINY:
        cpu, cpu_recs, seen = _cpu_with_routes(cfg, shape, monkeypatch)
        assert len(seen) == cfg.n_layers
        counts = iter(seen)
        with monkeypatch.context() as m:
            m.setattr(moe, "meta_routes", lambda n, e: next(counts))
            routed = dryrun.reckon(cfg, shape).reckoner
        assert _records(routed) == cpu_recs, (arch, shape)
        balanced = dryrun.reckon(cfg, shape).reckoner
        assert balanced.totals()["flops"] == cpu.totals()["flops"]
        pairs = sum(seen[0])
        ran = sum(c > 0 for c in moe.meta_routes(pairs, cfg.n_experts))
        extra = sum(ran - sum(c > 0 for c in layer) for layer in seen)
        diff = (balanced.totals()["bytes accessed"]
                - routed.totals()["bytes accessed"])
        if TINY[shape]["kind"] == "train":
            assert extra == 0 and diff == 0, (shape, seen)
        else:
            assert diff == extra * per_expert, (shape, extra, diff)
    assert any(0 in layer for layer in seen)      # the decode skipped some


def test_meta_routes_are_balanced():
    assert moe.meta_routes(10, 4) == [3, 3, 2, 2]
    assert moe.meta_routes(3, 8) == [1, 1, 1, 0, 0, 0, 0, 0]
    assert sum(moe.meta_routes(4096 * 8, 128)) == 4096 * 8


def test_reckoned_state_equals_the_real_tensors_nbytes(tiny_shapes):
    cfg = dataclasses.replace(tconfigs.get("zamba2-7b").reduced(),
                              compute_dtype="bfloat16", use_flash=True)
    rec = dryrun.reckon(cfg, "tiny_train")
    model, opt = tlm.init_all(cfg, device="cpu")
    weights = sum(t.nbytes for t in (*model.parameters(), *model.buffers()))
    masters = sum(t.nbytes for t in model.master.values())
    adamw = sum(t.nbytes for tree in (opt["mu"], opt["nu"])
                for t in tree.values()) + opt["step"].nbytes
    assert masters > 0
    assert rec.held["weights"] == weights
    assert rec.held["masters"] == masters
    assert rec.held["adamw"] == adamw
    assert rec.n_params_counted == sum(p.numel() for p in
                                       model.parameters())


def test_reckoned_peak_orders_the_remat_settings():
    base = dataclasses.replace(tconfigs.get("qwen3-0.6b"), use_flash=True)
    peak = {r: dryrun.reckon(dataclasses.replace(base, remat=r), "train_4k",
                             1).reckoner.peak for r in ("none", "dots", "full")}
    assert peak["none"] > peak["dots"] > peak["full"], peak


def test_analyze_cell_takes_a_batch_and_reckons_batch_1():
    cfg = tconfigs.get("smollm-360m")
    rec = dryrun.analyze_cell(cfg, "decode_32k", batch_override=2)
    one = dryrun.analyze_cell(cfg, "decode_32k", batch_override=1)
    assert (rec["batch"], rec["n_tokens"], one["batch"]) == (2, 2, 1)
    assert rec["memory"]["peak_bytes_batch_1"] == \
        one["memory"]["peak_bytes"] == one["memory"]["peak_bytes_batch_1"]
    assert rec["memory"]["peak_bytes"] > one["memory"]["peak_bytes"]
    assert rec["fits_one_h100"] == {"batch": True, "batch_1": True}
    assert rec["roofline"]["model_flops_total"] == 2 * 2 * \
        cfg.n_active_params()


def test_kernel_costs_give_the_recorded_bounds():
    bf16 = torch.bfloat16
    wkv_bwd = roofline.wkv_bwd_tc_cost(4, 4096, 40, 64)
    assert f"{wkv_bwd.bound_seconds() * 1e3:.4f}" == "0.4531"
    assert wkv_bwd.bound_by() == "bytes"
    ssd_bwd = roofline.ssd_bwd_tc_cost(4, 4096, 112, 64, 64)
    assert f"{ssd_bwd.bound_seconds() * 1e3:.4f}" == "1.1871"
    assert ssd_bwd.bound_by() == "operations"
    flash_bwd = roofline.flash_bwd_cost(4, 4096, 4096, 16, 8, 128, bf16)
    assert f"{flash_bwd.bound_seconds() * 1e3:.3f}" == "0.695"
    wkv_tc = roofline.wkv_tc_cost(4, 2048, 40, 64)
    assert f"{wkv_tc.bound_seconds() * 1e3:.3f}" == "0.127"
    # the backward's kernels add up to the function's operations
    per = roofline.flash_bwd_kernel_costs(4, 4096, 4096, 16, 8, 128, bf16)
    assert sum(c.n_ops for c in per.values()) == 16 * flash_bwd.n_ops // 10
    # a decode step reads its valid keys once: S = 1 against 2080 slots
    dec = roofline.flash_fwd_cost(4, 1, 2080, 16, 8, 128, bf16,
                                  q_offset=2079, kv_valid_len=2080)
    assert dec.n_ops == 4 * 4 * 16 * 128 * 2080
    assert dec.bytes == 2 * (2 * 4 * 16 * 128 + 2 * 4 * 2080 * 8 * 128)


@pytest.mark.parametrize("s, t, causal, off, valid", [
    (7, 7, True, 0, None), (5, 9, True, 4, None), (3, 10, True, 0, 6),
    (4, 12, False, 0, 5), (1, 8, True, 7, 8), (6, 6, False, 0, None)])
def test_flash_pairs_count_the_mask(s, t, causal, off, valid):
    kpos = np.arange(t)
    ok = np.ones((s, t), bool) if valid is None else \
        np.broadcast_to(kpos < valid, (s, t)).copy()
    if causal:
        ok &= (np.arange(s)[:, None] + off) >= kpos[None, :]
    assert roofline.flash_pairs(s, t, causal, off, valid) == ok.sum()


def test_meta_tier_returns_the_contract_and_counts_meta():
    q = torch.empty((2, 64, 4, 16), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 64, 2, 16), dtype=torch.bfloat16, device="meta")
    reg, old = obs_metrics.MetricsRegistry(), obs_metrics.ambient()
    obs_metrics.set_ambient(reg)
    try:
        o = FA.flash_attention(q, k, k)
        dq, dk, dv = FA.flash_attention_bwd(q, k, k, o, o)
    finally:
        obs_metrics.set_ambient(old)
    assert (o.shape, o.dtype, o.device.type) == (q.shape, q.dtype, "meta")
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    snap = reg.snapshot()["counters"]
    assert snap["kernels.dispatch.flash_attention.fwd.meta"] == 1
    assert snap["kernels.dispatch.flash_attention.bwd.meta"] == 1
    assert dispatch.resolve_device("meta").type == "meta"
    with pytest.raises(ValueError, match="meta"):
        dispatch.tier(q)                    # an op without a meta tier
    bitmaps = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        JAC.distance(bitmaps, bitmaps)


def test_cli_writes_the_reference_keys_and_loads_no_jax(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.launch import dryrun\n"
        f"dryrun.main(['--arch', 'smollm-360m', '--out', r'{tmp_path}',\n"
        "             '--workers', '2'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[dryrun] 4 cells" in out.stdout
    ref_keys = {"arch", "shape", "kind", "n_chips", "n_tokens", "n_params",
                "n_active_params", "cost", "memory", "collectives",
                "roofline"}
    roof_keys = set(rroofline.Roofline(0, 0, 0, 0, 0, 0, 0, 0, 1).to_dict())
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        rec = json.loads((tmp_path / f"smollm-360m__{shape}.json")
                         .read_text())
        assert ref_keys <= set(rec), shape
        assert rec["n_chips"] == 1 and not rec["skipped"]
        assert set(rec["collectives"].values()) == {0}
        assert {"flops", "bytes accessed"} <= set(rec["cost"])
        assert roof_keys <= set(rec["roofline"])
        assert rec["roofline"]["t_collective"] == 0
        assert {"n_params_counted", "fits_one_h100", "per_op"} <= set(rec)
        assert set(rec["fits_one_h100"]) == {"batch", "batch_1"}
        assert len(rec["per_op"]) == dryrun.TOP_OPS
    skip = json.loads((tmp_path / "smollm-360m__long_500k.json").read_text())
    assert skip["skipped"] and skip["reason"] == r_shape_supported(
        rconfigs.get("smollm-360m"), "long_500k")[1]
