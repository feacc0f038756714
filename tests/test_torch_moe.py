"""repro_torch's mixture-of-experts layer and MoE serving against the
reference on the CPU.

The layer: the port's one-device ``moe_apply`` computes the reference's
``moe_apply_dense`` on the routed tokens only, expert by expert in
increasing id; ``_router`` within 1e-6 (weights, aux) with the same ids,
``moe_apply`` within 1e-5 with the same routes (float32). The slice:
reduced olmoe-1b-7b and qwen3-moe-30b-a3b (2 layers, d_model 64, 8
experts top-2) carried into the port by ``interop.lm_params``, a prefill
and 8 decode steps against the reference's prefill and its
``use_flash=False`` decode (its flash decode raises) within 1e-4, with
every layer's routes (the top-k sets, token by token) equal. The
reference runs with ``scan_layers=False``, so its layers run one after
another in Python and its ``_router`` can be watched.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.core import placement as rplacement
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models import transformer as rtr
import repro_torch.configs as tconfigs
from repro_torch import interop
from repro_torch.core import placement
from repro_torch.kernels import _build
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from test_torch_lm import _path, _random_tree, _shapes, _tree

MOE_ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]
B, S, STEPS = 2, 16, 8
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


def _cfgs(arch, **kw):
    r = dataclasses.replace(rconfigs.get(arch).reduced(), scan_layers=False,
                            **kw)
    t = dataclasses.replace(tconfigs.get(arch).reduced(), **kw)
    return r, t


# the layer configs: both reduced configs, and one with 16 experts top-8
LAYER_CFGS = [("olmoe-1b-7b", {}), ("qwen3-moe-30b-a3b", {}),
              ("olmoe-1b-7b", {"n_experts": 16, "top_k": 8})]


def _layer(rcfg, tcfg, seed):
    """One MoE layer from numpy: the reference's dict and the port's
    ``MoE``."""
    flat, _ = _random_tree(rcfg, seed)
    w = {k[11:]: v[0] for k, v in flat.items()
         if k.startswith("blocks/moe/")}
    return ({k: jnp.asarray(v) for k, v in w.items()},
            tmoe.MoE(tcfg, {k: torch.tensor(v) for k, v in w.items()}))


@contextlib.contextmanager
def _routes(module):
    """Every call of ``module._router`` while the block runs: its top-k
    sets, (T, k) sorted ids, one array per call (a layer of a step)."""
    calls = []
    router = module._router

    def recording(p, x2d, cfg):
        out = router(p, x2d, cfg)
        calls.append(np.sort(np.asarray(out[1]), -1))
        return out
    module._router = recording
    try:
        yield calls
    finally:
        module._router = router


def _same_routes(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), (i, int((g != w).any(-1).sum()))


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


# --------------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch, kw", LAYER_CFGS, ids=str)
def test_router_matches_reference(arch, kw):
    rcfg, tcfg = _cfgs(arch, **kw)
    rp, tp = _layer(rcfg, tcfg, 1)
    x = np.random.default_rng(2).normal(size=(24, 64)).astype(np.float32)
    w, i, aux = tmoe._router(tp, torch.from_numpy(x), tcfg)
    rw, ri, raux = rmoe._router(rp, jnp.asarray(x), rcfg)
    assert i.shape == (24, tcfg.top_k)
    assert np.array_equal(i.numpy(), np.asarray(ri))
    assert _err(w, rw) <= 1e-6
    assert abs(float(aux) - float(raux)) <= 1e-6


@pytest.mark.parametrize("arch, kw", LAYER_CFGS, ids=str)
def test_moe_apply_matches_dense_reference(arch, kw):
    rcfg, tcfg = _cfgs(arch, **kw)
    rp, tp = _layer(rcfg, tcfg, 3)
    x = np.random.default_rng(4).normal(size=(2, 12, 64)).astype(np.float32)
    with _routes(tmoe) as got_routes:
        y, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    with _routes(rmoe) as want_routes:
        ry, raux = rmoe.moe_apply_dense(rp, jnp.asarray(x), rcfg)
    _same_routes(got_routes, want_routes)
    assert y.shape == x.shape and y.dtype == torch.float32
    assert _err(y, ry) <= 1e-5
    assert abs(float(aux) - float(raux)) <= 1e-6


@pytest.mark.parametrize("arch, kw", LAYER_CFGS, ids=str)
def test_placement_leaves_the_layer_unchanged_bit_for_bit(arch, kw):
    """Two accepted migrations: the output and aux stay equal bit for bit,
    and the placed layer still matches the reference's dense layer on its
    own placed weights."""
    rcfg, tcfg = _cfgs(arch, **kw)
    rp, tp = _layer(rcfg, tcfg, 5)
    e = tcfg.n_experts
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 10, 64))
                         .astype(np.float32))
    y0, aux0 = tmoe.moe_apply(tp, x, tcfg)
    rng = np.random.default_rng(7)
    moved = 0
    old = None
    while moved < 2:
        topics = rng.permutation(e).reshape(-1, 2)
        routing = np.stack([topics[rng.integers(len(topics))]
                            for _ in range(64)])
        e2r, rep = placement.plan_expert_placement(
            routing, e, 2, old, device="cpu")
        if not rep.accepted:
            continue
        moved += 1
        old = e2r
        tp.load_state_dict(placement.apply_expert_placement(
            tp.state_dict(), e2r))
        rp = rplacement.apply_expert_placement(rp, e2r)
        y, aux = tmoe.moe_apply(tp, x, tcfg)
        assert torch.equal(y, y0) and torch.equal(aux, aux0)
    assert not torch.equal(tp.inv_perm, torch.arange(e, dtype=torch.int32))
    ry, _ = rmoe.moe_apply_dense(rp, jnp.asarray(x.numpy()), rcfg)
    assert _err(y0, ry) <= 1e-5


# --------------------------------------------------------------------------- #
# the slice: parameters, prefill and decode
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_param_shapes_are_the_reference_tree(arch):
    rcfg, tcfg = _cfgs(arch)
    want = {_path(p): tuple(sd.shape) for p, sd in
            jax.tree_util.tree_flatten_with_path(_shapes(rcfg))[0]}
    assert tlm.param_shapes(tcfg) == want
    assert "blocks/moe/inv_perm" in want
    assert not any(k.startswith("blocks/mlp/") for k in want)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_params_follows_moe_init(param_dtype):
    """``moe_init``'s leaves: the router float32 whatever the parameter
    dtype, wg/wi over sqrt(d) and wo over sqrt(f) (not over sqrt(E)),
    the slot map the identity as int32; the same seed draws the same
    weights."""
    _, cfg = _cfgs("olmoe-1b-7b", n_experts=64, d_ff=256,
                   param_dtype=param_dtype, compute_dtype=param_dtype)
    model = tlm.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    again = tlm.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    layer = model.blocks[1].moe
    assert layer.wr.dtype == torch.float32
    assert layer.wg.dtype == getattr(torch, param_dtype)
    assert torch.equal(layer.inv_perm, torch.arange(64, dtype=torch.int32))
    for w, fan_in in ((layer.wr, 64), (layer.wg, 64), (layer.wi, 64),
                      (layer.wo, 256)):
        assert abs(float(w.float().std()) * np.sqrt(fan_in) - 1) < 0.02
    assert model.blocks[0].mlp is None


def _prefill_and_decode(rcfg, tcfg, flat, tree, seed):
    """Prefill of B x S tokens and ``STEPS`` teacher-forced decode steps
    in both packages: the logits of each and the routes of each call."""
    model = interop.lm_params(flat, tcfg, device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, tcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    with _routes(rmoe) as rroutes:
        rlogits, rcaches = rlm.prefill_step(
            tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg, None)
        big = rtr.init_decode_caches(rcfg, B, S + STEPS)
        big = {k: big[k].at[:, :, :S].set(rcaches[k]) for k in "kv"}
        rdec = dataclasses.replace(rcfg, use_flash=False)
        want = [rlogits]
        for pos in range(S, S + STEPS):
            lg, big = rlm.decode_step(
                tree, big, {"token": jnp.asarray(toks[:, pos]),
                            "pos": jnp.asarray(pos, jnp.int32)}, rdec, None)
            want.append(lg)
    _build.reset_launches()
    with _routes(tmoe) as troutes:
        logits, caches = tlm.prefill_step(
            model, {"tokens": torch.from_numpy(toks[:, :S])}, tcfg)
        tbig = ttr.init_decode_caches(tcfg, B, S + STEPS, device="cpu")
        for key in "kv":
            tbig[key][:, :, :S] = caches[key]
        got = [logits]
        for pos in range(S, S + STEPS):
            lg, tbig = tlm.decode_step(
                model, tbig, {"token": torch.from_numpy(toks[:, pos]),
                              "pos": pos}, tcfg)
            got.append(lg)
    assert not _build.launches            # the CPU runs the plain version
    return (torch.stack(got).numpy(), troutes,
            np.stack([np.asarray(w) for w in want]), rroutes)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference(arch):
    rcfg, tcfg = _cfgs(arch, use_flash=True)
    flat, tree = _random_tree(rcfg)
    got, troutes, want, rroutes = _prefill_and_decode(
        rcfg, tcfg, flat, tree, 7)
    assert len(troutes) == tcfg.n_layers * (1 + STEPS)
    assert troutes[0].shape == (B * S, tcfg.top_k)
    _same_routes(troutes, rroutes)
    errs = [_err(g, w) for g, w in zip(got, want)]
    print(arch, [f"{e:.2e}" for e in errs])
    assert max(errs) <= 1e-4, errs


def test_forward_aux_matches_reference():
    rcfg, tcfg = _cfgs("qwen3-moe-30b-a3b")
    flat, tree = _random_tree(rcfg, seed=8)
    model = interop.lm_params(flat, tcfg, device="cpu")
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size,
                                             (B, S)).astype(np.int32)
    logits, aux, _ = ttr.forward(model, torch.from_numpy(toks), tcfg)
    rlogits, raux, _ = rtr.forward(tree, jnp.asarray(toks), rcfg, None)
    assert _err(logits, rlogits) <= 1e-4
    assert abs(float(aux) - float(raux)) <= 1e-6 * tcfg.n_layers


def test_placed_tree_carries_across_and_serves_the_same():
    """The reference's tree after two placements on every layer, carried
    by ``interop.lm_params`` (``inv_perm`` as int32): the port matches the
    reference on it, and equals the port on the unplaced tree bit for
    bit."""
    rcfg, tcfg = _cfgs("olmoe-1b-7b", use_flash=True)
    flat, tree = _random_tree(rcfg, seed=10)
    base, base_routes, _, _ = _prefill_and_decode(rcfg, tcfg, flat, tree, 11)
    rng = np.random.default_rng(12)
    e = tcfg.n_experts
    placed = dict(flat)
    for name in ("wg", "wi", "wo", "inv_perm"):
        placed[f"blocks/moe/{name}"] = flat[f"blocks/moe/{name}"].copy()
    for layer in range(tcfg.n_layers):
        p = {name: placed[f"blocks/moe/{name}"][layer]
             for name in ("wg", "wi", "wo", "inv_perm")}
        for _ in range(2):
            p = rplacement.apply_expert_placement(
                p, rng.permutation(np.repeat(np.arange(4), e // 4)))
        for name, v in p.items():
            placed[f"blocks/moe/{name}"][layer] = np.asarray(v)
    assert placed["blocks/moe/inv_perm"].dtype == np.int32
    assert not np.array_equal(placed["blocks/moe/inv_perm"],
                              flat["blocks/moe/inv_perm"])
    got, troutes, want, rroutes = _prefill_and_decode(
        rcfg, tcfg, placed, _tree(_shapes(rcfg), placed), 11)
    model = interop.lm_params(placed, tcfg, device="cpu")
    assert model.blocks[0].moe.inv_perm.dtype == torch.int32
    _same_routes(troutes, rroutes)
    _same_routes(troutes, base_routes)
    assert max(_err(g, w) for g, w in zip(got, want)) <= 1e-4
    assert np.array_equal(got, base)


_LOOP = """
import json, sys
import numpy as np, torch
import repro_torch
from repro_torch import configs
from repro_torch.core import placement
from repro_torch.models import lm, transformer
cfg = configs.get("qwen3-moe-30b-a3b").reduced()
model = lm.init_params(cfg, device="cpu")
toks = torch.randint(0, cfg.vocab_size, (2, 8), dtype=torch.int32,
                     generator=torch.Generator().manual_seed(0))
logits, c = lm.prefill_step(model, {"tokens": toks}, cfg)
big = transformer.init_decode_caches(cfg, 2, 10, device="cpu")
for key in "kv":
    big[key][:, :, :8] = c[key]
for pos in (8, 9):
    logits, big = lm.decode_step(
        model, big, {"token": logits.argmax(-1), "pos": pos}, cfg)
rng = np.random.default_rng(0)
topics = rng.permutation(8).reshape(4, 2)
routing = np.stack([topics[rng.integers(4)] for _ in range(64)])
e2r, rep = placement.plan_expert_placement(routing, 8, 4, device="cpu")
layer = model.blocks[0].moe
layer.load_state_dict(placement.apply_expert_placement(
    layer.state_dict(), e2r))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"bad": bad, "logits": list(logits.shape),
                  "accepted": rep.accepted}))
"""


def test_moe_serving_loads_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _LOOP], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "logits": [2, 128], "accepted": True}
