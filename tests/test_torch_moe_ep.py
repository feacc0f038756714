"""repro_torch's expert-parallel MoE against the reference's, on the CPU.

The port runs on four ``gloo`` processes (``torch.multiprocessing`` with
``spawn``, a ``file://`` rendezvous under ``tmp_path``), each holding its
expert slots of a small layer (d 32, f 64, 8 experts top-2); the
reference's sharded ``moe_apply`` runs jitted in one subprocess over four
host devices. Both get the same weights and inputs from numpy. On meshes
(1, 4) and (2, 2), in both dispatch modes, at a capacity factor that drops
nothing (8.0: equal to the one-device layer too) and at one that drops
pairs (0.5, asserted), before and after an expert placement, at a prefill
shape (4 x 64 tokens, the sequence split over tp) and at S = 1 (64
tokens, replicated over tp):

(a) every rank's output and the aux loss within 1e-5 of the reference's;
(b) the distributed layer bit for bit the plain twin
    ``moe_apply_ranks_plain`` (every rank's block in one process);
(c) the migration across ranks bit for bit the one-device
    ``apply_expert_placement`` (``migrate_experts``), its bytes those of
    the experts that change rank;
(d) reduced olmoe-1b-7b (2 layers, 8 experts top-2, capacity 8.0) through
    ``lm.prefill_step`` and 4 ``decode_step``s with a ``ShardCtx`` against
    the reference's steps with its ``ShardCtx`` (its decode with
    ``use_flash=False``: its flash decode raises) and the port's one-device
    run, logits within 1e-5 and every rank's routes (top-k sets, token by
    token) those of the one-device run;
(e) a (1, 1) mesh is the one-device function, and experts that do not
    divide over tp raise.

A ``ShardCtx`` with ``seq_shard_moe=False`` (tokens split by batch only
and replicated over tp, at the prefill shape too) matches the reference's
at the factor that drops pairs, and its dispatch stats reach the
context's ``dispatch_log``.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro_torch import interop
import repro_torch.configs as tconfigs
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from test_torch_lm import _random_tree

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
D, F, E, K = 32, 64, 8, 2
MESHES = [(1, 4), (2, 2)]
MODES = ["expert", "rank"]
FACTORS = [8.0, 0.5]                   # nothing dropped; pairs dropped
XSHAPES = {"prefill": (4, 64), "decode": (64, 1)}
PATH_B, PATH_S, PATH_STEPS = 4, 16, 4
TOL = 1e-5


def _layer_cfg(mode, cf, n_experts=E):
    return ArchConfig(arch_id="t", family="moe", n_layers=1, d_model=D,
                      n_heads=2, n_kv_heads=2, d_ff=F, vocab_size=64,
                      n_experts=n_experts, top_k=K, capacity_factor=cf,
                      moe_dispatch=mode, param_dtype="float32",
                      compute_dtype="float32")


# the reference, jitted over 4 host devices
_REFERENCE = r'''
import contextlib, dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[3])
from repro import compat
import repro.configs as rconfigs
from repro.configs.base import ArchConfig
from repro.core import placement
from repro.models import lm, moe, transformer
from test_torch_lm import _shapes, _tree
inp = dict(np.load(sys.argv[1]))
w = {k: jnp.asarray(inp[k]) for k in ("wr", "wg", "wi", "wo", "inv_perm")}
out = {}
for ms in ((1, 4), (2, 2)):
    mesh = compat.make_mesh(ms, ("data", "model"))
    ctx = moe.ShardCtx(mesh=mesh, dp_axes=("data",))
    bctx = moe.ShardCtx(mesh=mesh, dp_axes=("data",), seq_shard_moe=False)
    placed = placement.apply_expert_placement(w, inp[f"e2r{ms[1]}"])
    for mode in ("expert", "rank"):
        for cf in (8.0, 0.5):
            cfg = ArchConfig(arch_id="t", family="moe", n_layers=1,
                             d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                             vocab_size=64, n_experts=8, top_k=2,
                             capacity_factor=cf, moe_dispatch=mode,
                             param_dtype="float32", compute_dtype="float32")
            f = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg, ctx))
            for lay, p in (("unplaced", w), ("placed", placed)):
                for sh in ("prefill", "decode"):
                    with compat.set_mesh(mesh):
                        y, aux = f(p, jnp.asarray(inp["x_" + sh]))
                    key = f"{ms[0]}x{ms[1]}/{mode}/{cf}/{lay}/{sh}"
                    out[key + "/y"] = np.asarray(y)
                    out[key + "/aux"] = np.asarray(aux)
                    if ms == (1, 4):
                        out[f"dense/{lay}/{sh}"] = np.asarray(
                            moe.moe_apply_dense(p, jnp.asarray(
                                inp["x_" + sh]), cfg)[0])
            if cf == 0.5:       # split by batch only, replicated over tp
                g = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg, bctx))
                with compat.set_mesh(mesh):
                    y, aux = g(w, jnp.asarray(inp["x_prefill"]))
                key = f"{ms[0]}x{ms[1]}/{mode}/batch_only"
                out[key + "/y"] = np.asarray(y)
                out[key + "/aux"] = np.asarray(aux)
rcfg = dataclasses.replace(rconfigs.get("olmoe-1b-7b").reduced(),
                           capacity_factor=8.0)
tree = _tree(_shapes(rcfg), {k[5:]: v for k, v in inp.items()
                             if k.startswith("tree/")})
toks = inp["tokens"]
s = toks.shape[1] - int(inp["steps"])
for ms in ((1, 4), (2, 2)):
    mesh = compat.make_mesh(ms, ("data", "model"))
    ctx = moe.ShardCtx(mesh=mesh, dp_axes=("data",))
    for mode in ("expert", "rank"):
        cfg = dataclasses.replace(rcfg, moe_dispatch=mode)
        dcfg = dataclasses.replace(cfg, use_flash=False)
        pre = jax.jit(lambda p, b: lm.prefill_step(p, b, cfg, ctx))
        dec = jax.jit(lambda p, c, b: lm.decode_step(p, c, b, dcfg, ctx))
        with compat.set_mesh(mesh):
            lg, c = pre(tree, {"tokens": jnp.asarray(toks[:, :s])})
            big = transformer.init_decode_caches(cfg, toks.shape[0],
                                                 toks.shape[1])
            big = {k: big[k].at[:, :, :s].set(c[k]) for k in "kv"}
            seq = [lg]
            for pos in range(s, toks.shape[1]):
                lg, big = dec(tree, big, {
                    "token": jnp.asarray(toks[:, pos]),
                    "pos": jnp.asarray(pos, jnp.int32)})
                seq.append(lg)
        out[f"path/{ms[0]}x{ms[1]}/{mode}"] = np.stack(
            [np.asarray(x) for x in seq])
np.savez(sys.argv[2], **out)
'''

# the port, on ``world`` gloo processes over the CPU
_PORT = r'''
import dataclasses, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _routes(moe, calls):
    router = moe._router

    def recording(p, x2d, cfg):
        out = router(p, x2d, cfg)
        calls.append(torch.sort(out[1], -1).values)
        return out
    return router, recording


def _serve(lm, moe, model, cfg, toks, steps, ctx):
    """Prefill and teacher-forced decode steps: stacked logits, routes."""
    from repro_torch.models import transformer
    calls = []
    router, moe._router = _routes(moe, calls)
    try:
        s = toks.shape[1] - steps
        lg, c = lm.prefill_step(model, {"tokens": toks[:, :s]}, cfg, ctx)
        big = transformer.init_decode_caches(
            cfg, c["k"].shape[1], toks.shape[1], device="cpu")
        for key in "kv":
            big[key][:, :, :s] = c[key]
        seq = [lg]
        for pos in range(s, toks.shape[1]):
            lg, big = lm.decode_step(model, big, {"token": toks[:, pos],
                                                  "pos": pos}, cfg, ctx)
            seq.append(lg)
    finally:
        moe._router = router
    return torch.stack(seq), calls


def work(rank, world, pg, inp_path, out_dir):
    torch.set_num_threads(1)        # four ranks share the host's cores
    dist.init_process_group("gloo", init_method="file://" + pg, rank=rank,
                            world_size=world)
    from repro_torch import configs, interop
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core import placement
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import lm, moe
    inp = dict(np.load(inp_path))
    full = {k: torch.from_numpy(inp[k])
            for k in ("wr", "wg", "wi", "wo", "inv_perm")}
    tree = {k[5:]: v for k, v in inp.items() if k.startswith("tree/")}
    toks = torch.from_numpy(inp["tokens"])
    steps = int(inp["steps"])
    out = {}
    base = dataclasses.replace(configs.get("olmoe-1b-7b").reduced(),
                               capacity_factor=8.0)
    if world == 1:                          # (e): a mesh of one rank
        mesh = meshes.make_host_mesh(1, 1, device_type="cpu")
        ctx = moe.ShardCtx(mesh, meshes.dp_axes(mesh))
        cfg = ArchConfig(arch_id="t", family="moe", n_layers=1, d_model=32,
                         n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                         n_experts=8, top_k=2, capacity_factor=0.5,
                         moe_dispatch="rank", param_dtype="float32",
                         compute_dtype="float32")
        layer = moe.MoE(cfg, full)
        x = torch.from_numpy(inp["x_prefill"])
        y1, a1 = moe.moe_apply(layer, x, cfg, ctx)
        y0, a0 = moe.moe_apply(layer, x, cfg)
        out["one/layer"] = np.array(torch.equal(y1, y0) and torch.equal(a1,
                                                                        a0))
        model = interop.lm_params(tree, base, device="cpu", ctx=ctx)
        g1, _ = _serve(lm, moe, model, base, toks, steps, ctx)
        g0, _ = _serve(lm, moe, model, base, toks, steps, None)
        out["one/path"] = np.array(torch.equal(g1, g0))
        np.savez(os.path.join(out_dir, "one.npz"), **out)
        dist.destroy_process_group()
        return
    for data, model_ in ((1, 4), (2, 2)):
        tag = f"{data}x{model_}"
        mesh = meshes.make_host_mesh(data, model_, device_type="cpu")
        ctx = moe.ShardCtx(mesh, meshes.dp_axes(mesh))
        layer_cfg = ArchConfig(arch_id="t", family="moe", n_layers=1,
                               d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                               vocab_size=64, n_experts=8, top_k=2,
                               param_dtype="float32", compute_dtype="float32")
        sl = moe.expert_slice(layer_cfg, ctx)
        mine = {k: (v[sl] if k in ("wg", "wi", "wo") else v)
                for k, v in full.items()}
        e2r = inp[f"e2r{model_}"]
        one = placement.apply_expert_placement(full, e2r)
        moved, nbytes = placement.migrate_experts(mine, e2r, ctx)
        out[f"{tag}/migration"] = np.array(all(
            torch.equal(moved[k], one[k][sl]) for k in ("wg", "wi", "wo"))
            and torch.equal(moved["inv_perm"], one["inv_perm"]))
        out[f"{tag}/migration_bytes"] = np.array(nbytes)
        xp = torch.from_numpy(inp["x_prefill"])
        b = xp.shape[0] // ctx.dp
        xp = xp[ctx.dp_rank * b:(ctx.dp_rank + 1) * b]
        for mode in ("expert", "rank"):
            # split by batch only, replicated over tp; the stats through
            # the context's log
            cfg = dataclasses.replace(layer_cfg, capacity_factor=0.5,
                                      moe_dispatch=mode)
            bctx = moe.ShardCtx(mesh, meshes.dp_axes(mesh),
                                seq_shard_moe=False, dispatch_log=[])
            y, aux = moe.moe_apply(moe.MoE(cfg, mine), xp, cfg, bctx)
            key = f"{tag}/{mode}/batch_only"
            out[key + "/y"] = y.numpy()
            out[key + "/aux"] = aux.numpy()
            out[key + "/tokens"] = np.array(
                [st.tokens for st in bctx.dispatch_log])
            out[key + "/dropped"] = np.array(
                sum(int(st.dropped) for st in bctx.dispatch_log))
            for cf in (8.0, 0.5):
                cfg = dataclasses.replace(layer_cfg, capacity_factor=cf,
                                          moe_dispatch=mode)
                for lay, ws, whole in (("unplaced", mine, full),
                                       ("placed", moved, one)):
                    layer = moe.MoE(cfg, ws)
                    for sh in ("prefill", "decode"):
                        x = torch.from_numpy(inp["x_" + sh])
                        b = x.shape[0] // ctx.dp
                        xl = x[ctx.dp_rank * b:(ctx.dp_rank + 1) * b]
                        y, aux, st = moe.moe_dispatch(layer, xl, cfg, ctx)
                        yp, auxp, _ = moe.moe_apply_ranks_plain(
                            moe.MoE(cfg, whole), x, cfg, (data, model_))
                        key = f"{tag}/{mode}/{cf}/{lay}/{sh}"
                        out[key + "/y"] = y.numpy()
                        out[key + "/aux"] = aux.numpy()
                        out[key + "/plain"] = np.array(
                            torch.equal(y, yp[ctx.dp_rank * b:
                                              (ctx.dp_rank + 1) * b])
                            and torch.equal(aux, auxp))
                        out[key + "/dropped"] = st.dropped.numpy()
        for mode in ("expert", "rank"):
            cfg = dataclasses.replace(base, moe_dispatch=mode)
            model = interop.lm_params(tree, cfg, device="cpu", ctx=ctx)
            got, routes = _serve(lm, moe, model, cfg, toks, steps, ctx)
            want, want_routes = _serve(lm, moe, interop.lm_params(
                tree, cfg, device="cpu"), cfg, toks, steps, None)
            # this rank's tokens of each router call, in the one-device run
            b = toks.shape[0] // ctx.dp
            rows = slice(ctx.dp_rank * b, (ctx.dp_rank + 1) * b)
            same = len(routes) == len(want_routes)
            for i, (g, w) in enumerate(zip(routes, want_routes)):
                w = w.reshape(toks.shape[0], -1, w.shape[-1])[rows]
                if i < cfg.n_layers:        # the prefill: a sequence slice
                    n = w.shape[1] // ctx.tp
                    w = w[:, ctx.tp_rank * n:(ctx.tp_rank + 1) * n]
                same = same and torch.equal(g, w.reshape(g.shape))
            out[f"path/{tag}/{mode}"] = got.numpy()
            out[f"path/{tag}/{mode}/one_device"] = want.numpy()
            out[f"path/{tag}/{mode}/routes"] = np.array(same)
    np.savez(os.path.join(out_dir, f"port{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    world = int(sys.argv[1])
    mp.spawn(work, args=(world, sys.argv[2], sys.argv[3], sys.argv[4]),
             nprocs=world, join=True)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' outputs: ``ref`` (the reference's arrays), ``ports``
    (each rank's arrays), ``one`` (the (1, 1) mesh's)."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.default_rng(0)
    inp = {"wr": rng.normal(size=(D, E)) / np.sqrt(D),
           "wg": rng.normal(size=(E, D, F)) / np.sqrt(D),
           "wi": rng.normal(size=(E, D, F)) / np.sqrt(D),
           "wo": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    inp = {k: v.astype(np.float32) for k, v in inp.items()}
    inp["inv_perm"] = np.arange(E, dtype=np.int32)
    for tp in (4, 2):
        inp[f"e2r{tp}"] = rng.permutation(np.repeat(np.arange(tp), E // tp))
    for sh, (b, s) in XSHAPES.items():
        inp["x_" + sh] = rng.normal(size=(b, s, D)).astype(np.float32)
    flat, _ = _random_tree(rconfigs.get("olmoe-1b-7b").reduced(), 3)
    inp.update({"tree/" + k: v for k, v in flat.items()})
    inp["tokens"] = rng.integers(0, 128, (PATH_B, PATH_S + PATH_STEPS)
                                 ).astype(np.int32)
    inp["steps"] = np.array(PATH_STEPS)
    np.savez(tmp / "in.npz", **inp)
    (tmp / "reference.py").write_text(_REFERENCE)
    (tmp / "port.py").write_text(_PORT)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, str(tmp / "reference.py"),
                            str(tmp / "in.npz"), str(tmp / "ref.npz"),
                            TESTS], env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        for world, pg in ((4, "pg4"), (1, "pg1")):
            res = subprocess.run(
                [sys.executable, str(tmp / "port.py"), str(world),
                 str(tmp / pg), str(tmp / "in.npz"), str(tmp)],
                env=env, capture_output=True, text=True, timeout=600)
            assert res.returncode == 0, res.stderr[-4000:]
        _, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-4000:]
    return {"ref": dict(np.load(tmp / "ref.npz")),
            "ports": [dict(np.load(tmp / f"port{r}.npz")) for r in range(4)],
            "one": dict(np.load(tmp / "one.npz")), "inp": inp}


def _rank_rows(ms, rank, n):
    """The batch rows rank ``rank`` of mesh ``ms`` holds of ``n``."""
    data, model = ms
    b = n // data
    dp = rank // model
    return slice(dp * b, (dp + 1) * b)


CASES = [(ms, mode, cf, lay, sh) for ms in MESHES for mode in MODES
         for cf in FACTORS for lay in ("unplaced", "placed")
         for sh in XSHAPES]


def _key(ms, mode, cf, lay, sh):
    return f"{ms[0]}x{ms[1]}/{mode}/{cf}/{lay}/{sh}"


@pytest.mark.parametrize("ms, mode, cf, lay, sh", CASES, ids=str)
def test_sharded_layer_matches_reference(runs, ms, mode, cf, lay, sh):
    key = _key(ms, mode, cf, lay, sh)
    want, want_aux = runs["ref"][key + "/y"], runs["ref"][key + "/aux"]
    scale = max(1.0, float(np.abs(want).max()))
    for rank, port in enumerate(runs["ports"]):
        got = port[key + "/y"]
        rows = want[_rank_rows(ms, rank, want.shape[0])]
        assert got.shape == rows.shape
        assert float(np.abs(got - rows).max()) <= TOL * scale, rank
        assert abs(float(port[key + "/aux"]) - float(want_aux)) <= TOL, rank
    dense = runs["ref"][f"dense/{lay}/{sh}"]
    dropped = sum(int(p[key + "/dropped"]) for p in runs["ports"])
    if cf == 8.0:       # nothing dropped: the one-device layer
        assert dropped == 0
        assert float(np.abs(want - dense).max()) <= TOL * scale
    else:               # the reference drops pairs here, and so does the port
        assert dropped > 0
        assert float(np.abs(want - dense).max()) > 1e-2


@pytest.mark.parametrize("ms, mode, cf, lay, sh", CASES, ids=str)
def test_sharded_layer_equals_plain_twin_bit_for_bit(runs, ms, mode, cf, lay,
                                                     sh):
    key = _key(ms, mode, cf, lay, sh)
    assert all(bool(p[key + "/plain"]) for p in runs["ports"])


@pytest.mark.parametrize("ms", MESHES, ids=str)
def test_migration_across_ranks_equals_one_device_apply(runs, ms):
    tag = f"{ms[0]}x{ms[1]}"
    assert all(bool(p[f"{tag}/migration"]) for p in runs["ports"])
    # the bytes: every expert that changes rank, its three leaves, once
    e2r = runs["inp"][f"e2r{ms[1]}"]
    old = np.repeat(np.arange(ms[1]), E // ms[1])
    expert = (2 * D * F + F * D) * 4
    # each tp group migrates once: count one group's ranks
    sent = sum(int(p[f"{tag}/migration_bytes"])
               for p in runs["ports"][:ms[1]])
    assert sent == int((e2r != old).sum()) * expert


@pytest.mark.parametrize("ms", MESHES, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_whole_path_matches_reference_and_one_device(runs, ms, mode):
    tag = f"path/{ms[0]}x{ms[1]}/{mode}"
    want = runs["ref"][tag]
    scale = max(1.0, float(np.abs(want).max()))
    for port in runs["ports"]:
        got = port[tag]
        assert got.shape == (PATH_STEPS + 1, PATH_B, 128)
        assert float(np.abs(got - want).max()) <= TOL * scale
        assert float(np.abs(got - port[tag + "/one_device"]).max()) \
            <= TOL * scale
        assert bool(port[tag + "/routes"])


@pytest.mark.parametrize("ms", MESHES, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_batch_only_layout_matches_reference(runs, ms, mode):
    key = f"{ms[0]}x{ms[1]}/{mode}/batch_only"
    want, want_aux = runs["ref"][key + "/y"], runs["ref"][key + "/aux"]
    seq = runs["ref"][_key(ms, mode, 0.5, "unplaced", "prefill") + "/y"]
    scale = max(1.0, float(np.abs(want).max()))
    b, s = XSHAPES["prefill"]
    for rank, port in enumerate(runs["ports"]):
        got = port[key + "/y"]
        rows = want[_rank_rows(ms, rank, want.shape[0])]
        assert got.shape == rows.shape
        assert float(np.abs(got - rows).max()) <= TOL * scale, rank
        assert abs(float(port[key + "/aux"]) - float(want_aux)) <= TOL, rank
        # one dispatch logged, of the rank's whole batch slice
        assert port[key + "/tokens"].tolist() == [b // ms[0] * s]
    assert sum(int(p[key + "/dropped"]) for p in runs["ports"]) > 0
    # the layout decides which pairs drop: not the sequence split's output
    assert float(np.abs(want - seq).max()) > 1e-2


def test_one_rank_mesh_is_the_one_device_function(runs):
    assert bool(runs["one"]["one/layer"])
    assert bool(runs["one"]["one/path"])


def _fake_ctx(tp, rank=0, dp=1):
    """A ShardCtx over a stand-in mesh (shape and names only): enough for
    what is decided before any collective."""
    mesh = types.SimpleNamespace(
        shape=(dp, tp), mesh_dim_names=("data", "model"),
        get_local_rank=lambda axis: rank if axis == "model" else 0)
    return tmoe.ShardCtx(mesh, ("data",))


def test_experts_that_do_not_divide_over_tp_raise():
    cfg = _layer_cfg("rank", 8.0, n_experts=6)
    rng = np.random.default_rng(1)
    w = {"wr": rng.normal(size=(D, 6)), "wg": rng.normal(size=(6, D, F)),
         "wi": rng.normal(size=(6, D, F)), "wo": rng.normal(size=(6, F, D))}
    w = {k: torch.from_numpy(v.astype(np.float32)) for k, v in w.items()}
    w["inv_perm"] = torch.arange(6, dtype=torch.int32)
    layer = tmoe.MoE(cfg, w)
    x = torch.zeros(4, 8, D)
    with pytest.raises(ValueError, match="do not divide"):
        tmoe.moe_apply(layer, x, cfg, _fake_ctx(4))
    with pytest.raises(ValueError, match="do not divide"):
        tmoe.moe_apply_ranks_plain(layer, x, cfg, (1, 4))
    big = dataclasses.replace(tconfigs.get("olmoe-1b-7b").reduced(),
                              n_experts=6)
    with pytest.raises(ValueError, match="do not divide"):
        tmoe.expert_slice(big, _fake_ctx(4))
    with pytest.raises(ValueError, match="do not divide"):
        tlm.init_flat(big, device="cpu", ctx=_fake_ctx(4))


@pytest.mark.parametrize("rank", range(4))
def test_init_draws_the_slots_of_the_one_device_draw(rank):
    cfg = tconfigs.get("olmoe-1b-7b").reduced()
    whole = tlm.init_flat(cfg, device="cpu")
    mine = tlm.init_flat(cfg, device="cpu", ctx=_fake_ctx(4, rank))
    el = cfg.n_experts // 4
    for path, t in whole.items():
        want = (t[:, rank * el:(rank + 1) * el]
                if path in tlm.MOE_EXPERT_LEAVES else t)
        assert torch.equal(mine[path], want), path
    flat, _ = _random_tree(rconfigs.get("olmoe-1b-7b").reduced(), 4)
    model = interop.lm_params(flat, cfg, device="cpu",
                              ctx=_fake_ctx(4, rank))
    assert torch.equal(model.blocks[1].moe.wo,
                       torch.from_numpy(flat["blocks/moe/wo"][1][
                           rank * el:(rank + 1) * el]))


def test_plain_twin_at_one_rank_is_the_one_device_layer():
    cfg = _layer_cfg("expert", 8.0)
    rng = np.random.default_rng(2)
    w = {"wr": rng.normal(size=(D, E)) / np.sqrt(D),
         "wg": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wi": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wo": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    w = {k: torch.from_numpy(v.astype(np.float32)) for k, v in w.items()}
    w["inv_perm"] = torch.from_numpy(rng.permutation(E).astype(np.int32))
    layer = tmoe.MoE(cfg, w)
    x = torch.from_numpy(rng.normal(size=(2, 16, D)).astype(np.float32))
    y, aux, stats = tmoe.moe_apply_ranks_plain(layer, x, cfg, (1, 1))
    want, want_aux = tmoe.moe_apply(layer, x, cfg)
    assert float((y - want).abs().max()) <= TOL
    assert torch.equal(aux, want_aux)
    assert [s.wire_bytes for s in stats] == [0]     # one rank ships nothing


def test_mesh_needs_an_initialised_group():
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh.make_host_mesh(1, 4, device_type="cpu")
    assert mesh.host_shape(2, 2) == {"data": 2, "model": 2}
    assert mesh.production_shape(multi_pod=True) == {"pod": 2, "data": 16,
                                                     "model": 16}
