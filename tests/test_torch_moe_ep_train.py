"""repro_torch's expert-parallel MoE training against the reference's, on
the CPU.

The port runs on four ``gloo`` processes (``torch.multiprocessing`` with
``spawn``, a ``file://`` rendezvous under ``tmp_path``), each holding its
expert slots; the reference's ``lm.train_step`` with its ``ShardCtx`` runs
jitted over four host devices, one subprocess a mesh, both beside the
port. Both get the same weights and batches from numpy: reduced
olmoe-1b-7b (2 layers, d 64, 8 experts top-2), batches of 4 x 16 tokens
(the sequence split over tp in the dispatch), AdamW at eps 1e-3 as
``tests/test_torch_train.py`` has it (its docstring says why). On meshes
(1, 4) and (2, 2), in both dispatch modes, at a capacity factor that drops
nothing (8.0) and at one that drops pairs (0.5, asserted):

(a) after 1 and 3 ``train_step``s, every rank's ``loss``, ``aux``,
    ``total``, ``grad_norm`` and ``lr`` within 1e-5 of the reference's
    (aux and total are the reference's per-shard pmean, not the one-device
    value), and every parameter leaf and both AdamW moments within 1e-5 of
    the leaf's largest magnitude, the expert slots gathered over tp;
(b) one MoE layer (d 32, f 64, 8 experts top-2) under a random cotangent
    on its output and aux: the gradients of the tokens, the router and
    every expert slot through ``moe_dispatch`` bit for bit those through
    ``moe_apply_ranks_plain`` (plain autograd), at a prefill shape (the
    sequence split over tp) and at S = 1 (the tokens replicated over tp);
(c) every whole leaf (embedding, attention, norms, router, head) and
    ``grad_norm`` bit for bit the same on every rank;
(d) one step in the batch-only layout (``seq_shard_moe=False``) against
    the reference's at 8.0, and at 0.5 (drops asserted) in expert mode;
    at 0.5 in rank mode, where the reference's tp devices hold different
    copies of an output its ``out_specs`` call replicated (the witness:
    one MoE layer's copies), the port's metrics within the pinned gap
    ``RANK_DROPS_GAP`` of the reference's, one value on every rank;
(e) ``remat="full"`` giving ``"none"``'s gradients bit for bit across the
    ranks, and the recompute logging no second dispatch;
(f) a (1, 1) mesh giving the one-device ``train_step`` bit for bit;

a dense model (reduced qwen3-0.6b, and hubert-xlarge's masked CE) on each
mesh giving the one-device loss and gradients within 1e-5; and
``launch.train.build`` on each mesh: the model holds this rank's slots
of the one-device draw, and a step trains.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.configs as rconfigs
from test_torch_lm import _random_tree

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))
MESHES = [(1, 4), (2, 2)]
MODES = ["expert", "rank"]
FACTORS = [8.0, 0.5]                    # nothing dropped; pairs dropped
SHAPES = ["prefill", "decode"]
B, S, STEPS = 4, 16, 3
TOL = 1e-5
METRICS = ("loss", "aux", "total", "grad_norm", "lr")
# the batch-only layout with rank-mode drops: the largest absolute gap
# allowed between the port's first step's metrics and the reference's,
# about 1.5 times the gaps on either mesh (loss 9.7e-4, aux 1.04e-2,
# total 8.6e-4, grad_norm 0.528; lr equal), so that the deviation cannot
# grow unnoticed (ROADMAP Queue 3, PR 36 deviations)
RANK_DROPS_GAP = {"loss": 1.5e-3, "aux": 1.5e-2, "total": 1.5e-3,
                  "grad_norm": 0.75, "lr": 0.0}

# the reference, jitted over 4 host devices, on one mesh
_REFERENCE = r'''
import dataclasses, functools, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
sys.path.insert(0, sys.argv[3])
from repro import compat
import repro.configs as rconfigs
from repro.models import lm, moe
from repro.optim import AdamWConfig, adamw_init
from test_torch_lm import _shapes, _tree

inp = dict(np.load(sys.argv[1]))
ms = tuple(int(n) for n in sys.argv[4].split("x"))
base = rconfigs.get("olmoe-1b-7b").reduced()
shapes = _shapes(base)
flat = {k[5:]: v for k, v in inp.items() if k.startswith("tree/")}
opt_cfg = AdamWConfig(total_steps=10, warmup_steps=2, eps=1e-3)
mesh = compat.make_mesh(ms, ("data", "model"))
out = {}


def leaves(tree):
    return {"/".join(p.key for p in path): np.asarray(x) for path, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def run(tag, cfg, ctx, steps, keep):
    step = jax.jit(functools.partial(lm.train_step, cfg=cfg, ctx=ctx,
                                     opt_cfg=opt_cfg))
    params = _tree(shapes, flat)
    opt = adamw_init(params)
    with compat.set_mesh(mesh):
        for i in range(steps):
            params, opt, met = step(params, opt, {"tokens": jnp.asarray(
                inp["tokens"][i])})
            for k, v in met.items():
                out[f"{tag}/{i + 1}/{k}"] = np.asarray(v)
            if i + 1 in keep:
                for name, tree in (("params", params), ("mu", opt["mu"]),
                                   ("nu", opt["nu"])):
                    for path, a in leaves(tree).items():
                        out[f"{tag}/{i + 1}/{name}/{path}"] = a


for mode in ("expert", "rank"):
    ctx = moe.ShardCtx(mesh=mesh, dp_axes=("data",))
    for cf in (8.0, 0.5):
        cfg = dataclasses.replace(base, moe_dispatch=mode,
                                  capacity_factor=cf)
        run(f"{mode}/{cf}", cfg, ctx, 3, (1, 3))
    bctx = moe.ShardCtx(mesh=mesh, dp_axes=("data",), seq_shard_moe=False)
    cfg = dataclasses.replace(base, moe_dispatch=mode, capacity_factor=8.0)
    run(f"{mode}/batch_only", cfg, bctx, 1, (1,))
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    run(f"{mode}/batch_only_drops", cfg, bctx, 1, (1,))
    # the tp devices' copies of layer 0's MoE output, which out_specs
    # declare replicated over tp: their largest difference
    p0 = {k: jnp.asarray(flat["blocks/moe/" + k][0])
          for k in ("wr", "wg", "wi", "wo", "inv_perm")}
    with compat.set_mesh(mesh):
        y, _ = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg, bctx))(
            p0, jnp.asarray(inp["x_witness"]))
    copies = {}
    for sh in y.addressable_shards:
        copies.setdefault(str(sh.index), []).append(np.asarray(sh.data))
    out[f"{mode}/batch_only_drops/copies"] = np.array(max(
        float(np.abs(c - cs[0]).max()) for cs in copies.values()
        for c in cs))
np.savez(sys.argv[2], **out)
'''

# the port, on ``world`` gloo processes over the CPU
_PORT = r'''
import dataclasses, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def work(rank, world, pg, inp_path, out_dir):
    torch.set_num_threads(1)        # four ranks share the host's cores
    torch.exp(torch.zeros(1))       # see tests/test_torch_train.py
    dist.init_process_group("gloo", init_method="file://" + pg, rank=rank,
                            world_size=world)
    from repro_torch import configs, interop
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import train
    from repro_torch.models import lm, moe
    from repro_torch.optim import AdamWConfig, adamw_init
    inp = dict(np.load(inp_path))
    tree = {k[5:]: v for k, v in inp.items() if k.startswith("tree/")}
    base = configs.get("olmoe-1b-7b").reduced()
    opt_cfg = AdamWConfig(total_steps=10, warmup_steps=2, eps=1e-3)
    batches = [{"tokens": torch.from_numpy(t)} for t in inp["tokens"]]
    out = {}

    def model_of(cfg, ctx):
        model = lm.make_trainable(interop.lm_params(tree, cfg, device="cpu",
                                                    ctx=ctx), cfg)
        return model, adamw_init(lm.trainable(model))

    def steps(tag, cfg, ctx, n, keep):
        ctx = dataclasses.replace(ctx, dispatch_log=[]) if ctx else None
        model, opt = model_of(cfg, ctx)
        for i in range(n):
            model, opt, met = lm.train_step(model, opt, batches[i], cfg,
                                            opt_cfg, ctx=ctx)
            for k, v in met.items():
                out[f"{tag}/{i + 1}/{k}"] = v.numpy()
            if i + 1 in keep:
                st = interop.adamw_tree(opt, cfg, ctx)
                trees = (("params", interop.lm_tree(model, cfg, ctx)),
                         ("mu", st["mu"]), ("nu", st["nu"]))
                for name, t in trees:
                    for path, a in t.items():
                        out[f"{tag}/{i + 1}/{name}/{path}"] = a
        if ctx is not None:
            out[f"{tag}/dropped"] = np.array(
                sum(int(s.dropped) for s in ctx.dispatch_log))

    if world == 1:                  # (f): a mesh of one rank
        mesh = meshes.make_host_mesh(1, 1, device_type="cpu")
        ctx = moe.ShardCtx(mesh, meshes.dp_axes(mesh))
        cfg = dataclasses.replace(base, capacity_factor=0.5)
        steps("mesh", cfg, ctx, 3, (3,))
        steps("none", cfg, None, 3, (3,))
        out["same"] = np.array(all(
            np.array_equal(out[k], out["none" + k[4:]])
            for k in list(out)
            if k.startswith("mesh/") and not k.endswith("/dropped")))
        np.savez(os.path.join(out_dir, "one.npz"), **out)
        dist.destroy_process_group()
        return

    # (b): one layer's gradients, distributed against the plain twin
    lw = {k[6:]: torch.from_numpy(v) for k, v in inp.items()
          if k.startswith("layer/")}
    lcfg = ArchConfig(arch_id="t", family="moe", n_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                      n_experts=8, top_k=2, param_dtype="float32",
                      compute_dtype="float32")
    for data, model_ in ((1, 4), (2, 2)):
        tag = f"{data}x{model_}"
        mesh = meshes.make_host_mesh(data, model_, device_type="cpu")
        ctx = moe.ShardCtx(mesh, meshes.dp_axes(mesh))
        sl = moe.expert_slice(lcfg, ctx)
        for mode in ("expert", "rank"):
            for cf in (8.0, 0.5):
                cfg = dataclasses.replace(lcfg, moe_dispatch=mode,
                                          capacity_factor=cf)
                for sh in ("prefill", "decode"):
                    x, cy = (torch.from_numpy(inp[f"{k}_{sh}"])
                             for k in ("x", "cy"))
                    ca = float(inp["ca"])
                    b = x.shape[0] // ctx.dp
                    rows = slice(ctx.dp_rank * b, (ctx.dp_rank + 1) * b)
                    mine = moe.MoE(cfg, {k: (v[sl] if k in ("wg", "wi", "wo")
                                             else v) for k, v in lw.items()})
                    full = moe.MoE(cfg, lw)
                    for m in (mine, full):
                        for p in m.parameters():
                            p.requires_grad_(True)
                    xl = x[rows].clone().requires_grad_(True)
                    y, aux, _ = moe.moe_dispatch(mine, xl, cfg, ctx)
                    ((y * cy[rows]).sum() + ca * aux).backward()
                    xg = x.clone().requires_grad_(True)
                    yp, auxp, _ = moe.moe_apply_ranks_plain(full, xg, cfg,
                                                            (data, model_))
                    ((yp * cy).sum() + ca * auxp).backward()
                    got = {n: p.grad for n, p in mine.named_parameters()}
                    lm.reduce_grads(got, ctx)
                    same = (torch.equal(y, yp[rows])
                            and torch.equal(xl.grad, xg.grad[rows])
                            and torch.equal(got["wr"], full.wr.grad)
                            and all(torch.equal(got[n], getattr(
                                full, n).grad[sl]) for n in ("wg", "wi",
                                                             "wo")))
                    out[f"{tag}/{mode}/{cf}/{sh}/plain"] = np.array(same)

        for mode in ("expert", "rank"):
            for cf in (8.0, 0.5):       # (a) and (c)
                cfg = dataclasses.replace(base, moe_dispatch=mode,
                                          capacity_factor=cf)
                steps(f"{tag}/{mode}/{cf}", cfg, ctx, 3, (1, 3))
            # (d): split by batch only, replicated over tp
            cfg = dataclasses.replace(base, moe_dispatch=mode,
                                      capacity_factor=8.0)
            bctx = dataclasses.replace(ctx, seq_shard_moe=False)
            steps(f"{tag}/{mode}/batch_only", cfg, bctx, 1, (1,))
            steps(f"{tag}/{mode}/batch_only_drops", dataclasses.replace(
                cfg, capacity_factor=0.5), bctx, 1, (1,))
            # (e): remat full against none, and the dispatch log
            cfg = dataclasses.replace(base, moe_dispatch=mode,
                                      capacity_factor=0.5)
            grads = {}
            for remat in ("full", "none"):
                c = dataclasses.replace(cfg, remat=remat)
                lctx = dataclasses.replace(ctx, dispatch_log=[])
                model, _ = model_of(c, lctx)
                total, _, g = lm.loss_and_grads(model, batches[0], c, lctx)
                grads[remat] = (total, g, len(lctx.dispatch_log))
            (tf, gf, nf), (tn, gn, nn) = grads["full"], grads["none"]
            out[f"{tag}/{mode}/remat"] = np.array(
                torch.equal(tf, tn) and set(gf) == set(gn)
                and all(torch.equal(gf[k], gn[k]) for k in gf))
            out[f"{tag}/{mode}/remat_logs"] = np.array([nf, nn])

        # a dense model on the mesh (data parallel, tp replicating it): the
        # one-device loss and gradients, next-token CE and masked CE
        for arch, batch in (("qwen3-0.6b", batches[0]), ("hubert-xlarge", {
                k: torch.from_numpy(inp["hubert/" + k])
                for k in ("embeddings", "labels", "mask")})):
            cfg = configs.get(arch).reduced()
            model, _ = lm.init_all(cfg, device="cpu", ctx=ctx)
            total, met, got = lm.loss_and_grads(model, batch, cfg, ctx)
            lm.reduce_grads(got, ctx)
            model, _ = lm.init_all(cfg, device="cpu")
            total1, met1, want = lm.loss_and_grads(model, batch, cfg)
            errs = [abs(float(met["loss"]) - float(met1["loss"]))
                    / float(met1["loss"])]
            errs += [float((got[k] - want[k]).abs().max()
                           / want[k].abs().max().clamp(min=1e-30))
                     for k in want]
            out[f"{tag}/dense/{arch}"] = np.array(max(errs))

        # launch.train.build on the mesh: this rank's slots of the draw
        _, b, s = inp["tokens"].shape
        cfg_b, model, opt, stream, step_fn = train.build(
            "olmoe-1b-7b", reduced=True, batch=b, seq=s, steps=4,
            data_parallel=data, model_parallel=model_, device="cpu")
        bctx = step_fn.keywords["ctx"]
        want = lm.init_flat(cfg_b, device="cpu")
        have = interop.lm_tree(model, cfg_b, bctx)
        flat_ok = all(np.array_equal(have[k], want[k].numpy())
                      for k in want)
        batch = train.to_device(stream.host_batch(0), "cpu")
        model, opt, met = step_fn(model, opt, batch)
        out[f"{tag}/build"] = np.array(
            flat_ok and model.blocks[0].moe.wg.shape[0] == 8 // model_
            and bool(np.isfinite(float(met["loss"]))))
        out[f"{tag}/build/grad_norm"] = met["grad_norm"].numpy()
        out[f"{tag}/build/tokens"] = batch["tokens"].numpy()
    np.savez(os.path.join(out_dir, f"port{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    world = int(sys.argv[1])
    mp.spawn(work, args=(world, sys.argv[2], sys.argv[3], sys.argv[4]),
             nprocs=world, join=True)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' outputs: ``ref`` (the reference's arrays, by mesh),
    ``ports`` (each rank's arrays), ``one`` (the (1, 1) mesh's)."""
    tmp = tmp_path_factory.mktemp("moe_ep_train")
    rng = np.random.default_rng(0)
    flat, _ = _random_tree(rconfigs.get("olmoe-1b-7b").reduced(), 5)
    inp = {"tree/" + k: v for k, v in flat.items()}
    inp["tokens"] = rng.integers(0, 128, (STEPS, B, S)).astype(np.int32)
    d, f, e = 32, 64, 8
    layer = {"wr": rng.normal(size=(d, e)) / np.sqrt(d),
             "wg": rng.normal(size=(e, d, f)) / np.sqrt(d),
             "wi": rng.normal(size=(e, d, f)) / np.sqrt(d),
             "wo": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    inp.update({"layer/" + k: v.astype(np.float32) for k, v in layer.items()})
    inp["layer/inv_perm"] = np.arange(e, dtype=np.int32)
    for sh, (b, s) in (("prefill", (4, 64)), ("decode", (64, 1))):
        inp["x_" + sh] = rng.normal(size=(b, s, d)).astype(np.float32)
        inp["cy_" + sh] = rng.normal(size=(b, s, d)).astype(np.float32)
    inp["ca"] = np.float32(rng.normal())
    inp["x_witness"] = rng.normal(size=(B, S, 64)).astype(np.float32)
    inp["hubert/embeddings"] = rng.normal(size=(B, S, 64)).astype(np.float32)
    inp["hubert/labels"] = rng.integers(0, 128, (B, S)).astype(np.int32)
    inp["hubert/mask"] = rng.random((B, S)) < 0.3
    np.savez(tmp / "in.npz", **inp)
    (tmp / "reference.py").write_text(_REFERENCE)
    (tmp / "port.py").write_text(_PORT)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    refs = {f"{a}x{b}": subprocess.Popen(
        [sys.executable, str(tmp / "reference.py"), str(tmp / "in.npz"),
         str(tmp / f"ref{a}x{b}.npz"), TESTS, f"{a}x{b}"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for a, b in MESHES}
    try:
        for world, pg in ((4, "pg4"), (1, "pg1")):
            res = subprocess.run(
                [sys.executable, str(tmp / "port.py"), str(world),
                 str(tmp / pg), str(tmp / "in.npz"), str(tmp)],
                env=env, capture_output=True, text=True, timeout=600)
            assert res.returncode == 0, res.stderr[-4000:]
        for tag, ref in refs.items():
            _, err = ref.communicate(timeout=600)
            assert ref.returncode == 0, (tag, err[-4000:])
    finally:
        for ref in refs.values():
            ref.kill()
    return {"ref": {tag: dict(np.load(tmp / f"ref{tag}.npz"))
                    for tag in refs},
            "ports": [dict(np.load(tmp / f"port{r}.npz")) for r in range(4)],
            "one": dict(np.load(tmp / "one.npz"))}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _check_step(port, ref, tag, step, trees):
    for k in METRICS:
        want, got = float(ref[f"{tag}/{step}/{k}"]), float(
            port[f"{tag}/{step}/{k}"])
        assert abs(got - want) <= TOL * max(abs(want), 1e-6), \
            (tag, step, k, got, want)
    if not trees:
        return
    for name in ("params", "mu", "nu"):
        prefix = f"{tag}/{step}/{name}/"
        want = {k[len(prefix):]: v for k, v in ref.items()
                if k.startswith(prefix)}
        got = {k[len(prefix):]: v for k, v in port.items()
               if k.startswith(prefix)}
        assert set(got) == set(want), (prefix, set(got) ^ set(want))
        for path in want:
            assert got[path].shape == want[path].shape, (prefix, path)
            err = _rel(got[path], want[path])
            assert err <= TOL, (prefix, path, err)


def _same_on_every_rank(ports, tag):
    first = ports[0]
    keys = [k for k in first if k.startswith(tag + "/")
            and not k.endswith("/dropped")
            and "/moe/w" not in k.replace("/moe/wr", "")]
    assert any(k.endswith("/grad_norm") for k in keys)
    for port in ports[1:]:
        for k in keys:
            assert np.array_equal(port[k], first[k]), k
    return keys


TRAIN_CASES = [(ms, mode, cf) for ms in MESHES for mode in MODES
               for cf in FACTORS]


@pytest.mark.parametrize("ms, mode, cf", TRAIN_CASES, ids=str)
def test_sharded_train_step_matches_reference(runs, ms, mode, cf):
    tag = f"{ms[0]}x{ms[1]}"
    ref = runs["ref"][tag]
    for rank, port in enumerate(runs["ports"]):
        for step in range(1, STEPS + 1):
            _check_step({k[len(tag) + 1:]: v for k, v in port.items()
                         if k.startswith(tag + "/")}, ref, f"{mode}/{cf}",
                        step, step in (1, STEPS))
    dropped = sum(int(p[f"{tag}/{mode}/{cf}/dropped"])
                  for p in runs["ports"])
    assert (dropped == 0) if cf == 8.0 else (dropped > 0), dropped


@pytest.mark.parametrize("ms, mode, cf", TRAIN_CASES, ids=str)
def test_whole_leaves_and_norm_identical_on_every_rank(runs, ms, mode, cf):
    keys = _same_on_every_rank(runs["ports"], f"{ms[0]}x{ms[1]}/{mode}/{cf}")
    assert any(k.endswith("params/embed") for k in keys)


@pytest.mark.parametrize("ms", MESHES, ids=str)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("sh", SHAPES)
def test_dispatch_gradients_equal_plain_twin_bit_for_bit(runs, ms, mode, cf,
                                                         sh):
    key = f"{ms[0]}x{ms[1]}/{mode}/{cf}/{sh}/plain"
    assert all(bool(p[key]) for p in runs["ports"])


@pytest.mark.parametrize("ms", MESHES, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_batch_only_step_matches_reference(runs, ms, mode):
    tag = f"{ms[0]}x{ms[1]}"
    for port in runs["ports"]:
        _check_step({k[len(tag) + 1:]: v for k, v in port.items()
                     if k.startswith(tag + "/")}, runs["ref"][tag],
                    f"{mode}/batch_only", 1, True)


@pytest.mark.parametrize("ms", MESHES, ids=str)
def test_batch_only_layout_with_expert_mode_drops_matches_reference(runs,
                                                                   ms):
    """Expert mode's capacity is each source's own: every tp device of the
    reference holds the same copy, and the port is held to it."""
    tag = f"{ms[0]}x{ms[1]}"
    ref = runs["ref"][tag]
    assert float(ref["expert/batch_only_drops/copies"]) == 0.0
    for port in runs["ports"]:
        _check_step({k[len(tag) + 1:]: v for k, v in port.items()
                     if k.startswith(tag + "/")}, ref,
                    "expert/batch_only_drops", 1, True)
    _same_on_every_rank(runs["ports"], f"{tag}/expert/batch_only_drops")
    assert sum(int(p[f"{tag}/expert/batch_only_drops/dropped"])
               for p in runs["ports"]) > 0


@pytest.mark.parametrize("ms", MESHES, ids=str)
def test_batch_only_layout_with_rank_mode_drops_keeps_its_pinned_gap(runs,
                                                                     ms):
    """Rank mode shares an expert's capacity among the sources, first come
    first kept, so with replicated tokens the reference's tp devices get
    different results back and go on from their own copies, which its
    ``out_specs`` declare replicated: its step has no single answer. The
    port keeps tp rank 0's result on every rank (one value everywhere);
    its metrics stay within ``RANK_DROPS_GAP`` of the reference's."""
    tag = f"{ms[0]}x{ms[1]}"
    ref = runs["ref"][tag]
    assert float(ref["rank/batch_only_drops/copies"]) > 0.0
    for port in runs["ports"]:
        for k in METRICS:
            got = float(port[f"{tag}/rank/batch_only_drops/1/{k}"])
            want = float(ref[f"rank/batch_only_drops/1/{k}"])
            assert abs(got - want) <= RANK_DROPS_GAP[k], (k, got, want)
    _same_on_every_rank(runs["ports"], f"{tag}/rank/batch_only_drops")
    assert sum(int(p[f"{tag}/rank/batch_only_drops/dropped"])
               for p in runs["ports"]) > 0


@pytest.mark.parametrize("ms", MESHES, ids=str)
@pytest.mark.parametrize("mode", MODES)
def test_remat_full_equals_none_across_ranks(runs, ms, mode):
    tag = f"{ms[0]}x{ms[1]}/{mode}"
    for port in runs["ports"]:
        assert bool(port[tag + "/remat"])
        # one dispatch logged a layer, the recompute's not among them
        assert port[tag + "/remat_logs"].tolist() == [2, 2]


@pytest.mark.parametrize("ms", MESHES, ids=str)
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "hubert-xlarge"])
def test_dense_model_on_a_mesh_is_the_one_device_gradient(runs, ms, arch):
    """No MoE layer: every rank computes its dp slice, tp replicates it;
    the loss (next-token CE; HuBERT's masked CE, a ratio of global sums)
    and the gradients summed over dp are the one-device ones."""
    for port in runs["ports"]:
        assert float(port[f"{ms[0]}x{ms[1]}/dense/{arch}"]) <= TOL


def test_one_rank_mesh_is_the_one_device_step(runs):
    assert bool(runs["one"]["same"])


@pytest.mark.parametrize("ms", MESHES, ids=str)
def test_build_trains_on_a_mesh(runs, ms):
    tag = f"{ms[0]}x{ms[1]}/build"
    ports = runs["ports"]
    assert all(bool(p[tag]) for p in ports)
    for p in ports[1:]:             # one global batch; one norm everywhere
        assert np.array_equal(p[tag + "/tokens"], ports[0][tag + "/tokens"])
        assert np.array_equal(p[tag + "/grad_norm"],
                              ports[0][tag + "/grad_norm"])
