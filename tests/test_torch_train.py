"""repro_torch's training step against the reference on the CPU.

The reference's own random weights for each reduced config
(``transformer.init_params``) and its zero AdamW state go to the port
through ``interop.lm_params`` and ``interop.adamw_state``; both packages
take the same numpy batches. After one and three steps the port's
``lm.train_step`` holds the reference's ``lm.train_step``: loss, aux,
total, lr and grad_norm within 1e-5 relative, and every parameter, ``mu``
and ``nu`` within 1e-5 of that leaf's largest magnitude (read back with
``interop.lm_tree`` and ``interop.adamw_tree``); the MoE slot map
``inv_perm`` unchanged. Configs with attention run with ``use_flash`` on
(the port's flash op and its plain backward against the reference's
Pallas forward in interpret mode and its chunked ``_bwd``) and off
(autograd through the plain attention on both sides).

The comparison runs AdamW with ``eps = 1e-3`` (the default elsewhere,
1e-8, is held on identical gradients by ``tests/test_torch_substrate.py``).
At 1e-8 the step ``m / (sqrt(v) + eps)`` of an element whose gradient is
near eps multiplies a rounding difference by up to ``1 / (4 eps)``
(2.5e7): after one step such elements set the two models apart by up to
the learning rate, and every gradient of the next step follows, far past
1e-5, whatever the gradients' accuracy. At 1e-3 the factor is 250. The weights
are the reference's ``init_params``, every leaf it sets to zeros (biases,
RWKV6's ``ln_x_bias``, Mamba2's ``conv_b``) drawn from ``0.1 * N(0, 1)``
instead, as ``tests/test_torch_lm.py``'s weights have them: a leaf that
starts at zero is all update after a step, and "relative to its largest
magnitude" would then compare Adam's normalised steps alone. One
leaf is held otherwise: without RoPE and qk-norm (hubert-xlarge) the
attention key bias ``bk`` has a gradient of zero in exact arithmetic (a
row's softmax is invariant to the shift ``q·bk``), so both packages'
gradients for it are rounding noise: on each side its moments stay under
1e-3 of the model's largest (``sqrt(nu)`` likewise) and its elements move
by under 5% of the summed learning rates.

rwkv6-3b is held to 1e-4, not 1e-5: on the third batch its float32
gradients differ by up to 4.4e-5 of a leaf's largest (``mu`` of
``cm_k``; grad_norm 1.7e-5) while the loss agrees to 2e-7 and the
parameters to 4e-7, and the next batch's agree to 5e-7 again. On that
batch the float32 gradient itself is that far from the exact one: against
the reference's loss evaluated in float64 (its float32 casts mapped to
float64) at the same parameters, the reference's float32 gradient is off
by up to 5.0e-5 of a leaf's largest and the port's by 3.3e-5 (a batch on
which the time mix, with its data-dependent decay and a head norm over 16
channels, is ill-conditioned; not a trajectory that drifts).

Then: ``_cross_entropy`` equal to the reference's one-hot version;
``remat="full"`` giving the same gradients as ``"none"`` bit for bit;
``"dots"`` raising; bf16 compute carrying float32 master copies.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import lm as rlm
from repro.models import transformer as rtr
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as radamw_init
import repro_torch.configs as tconfigs
from repro_torch import interop
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttr
from repro_torch.optim import AdamWConfig

TOL = 1e-5
TOL_RWKV = 1e-4
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


def _with_attention(arch):
    return not rconfigs.get(arch).rwkv


CASES = [(arch, flash) for arch in rconfigs.ARCH_IDS
         for flash in ((False, True) if _with_attention(arch) else (False,))]


def _flat(tree):
    """A reference tree -> {leaf path: numpy array} (None leaves dropped)."""
    return {"/".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _weights(rcfg, seed=0):
    """The reference's random weights, every leaf it sets to zeros drawn
    from 0.1 * N(0, 1) instead."""
    params, _ = rtr.init_params(jax.random.PRNGKey(seed), rcfg)
    rng = np.random.default_rng(seed)

    def spread(path, leaf):
        a = np.asarray(leaf)
        if path[-1].key == "inv_perm" or np.any(a):
            return leaf
        return jnp.asarray((a + 0.1 * rng.normal(size=a.shape)).astype(
            a.dtype))

    return jax.tree_util.tree_map_with_path(spread, params)


def _zero_grad_leaf(cfg):
    """The leaf whose gradient is zero in exact arithmetic, if any: the
    key bias, where neither RoPE nor qk-norm acts on the keys."""
    return "attn/bk" if cfg.qkv_bias and not (cfg.rope or cfg.qk_norm) \
        else None


def _batches(cfg, n, seed=0):
    """``n`` numpy batches of (B, S) in the reference's train layout."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if cfg.embedding_inputs:
            out.append({
                "embeddings": rng.normal(size=(B, S, cfg.d_model)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                    np.int32),
                "mask": rng.random((B, S)) < 0.3})
        else:
            out.append({"tokens": rng.integers(0, cfg.vocab_size, (B, S))
                        .astype(np.int32)})
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


NOISE = 1e-3
OPT = dict(total_steps=10, warmup_steps=2, eps=1e-3)


def _tol(cfg):
    return TOL_RWKV if cfg.rwkv else TOL


def _check_trees(got, want, zero_grad, tol, what):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for path in want:
        assert got[path].shape == want[path].shape, (what, path)
        if zero_grad is None or not path.endswith(zero_grad):
            err = _rel(got[path], want[path])
            assert err <= tol, (what, path, err)


def _check_zero_grad(trees, init, lrs, zero_grad, what):
    """A zero-gradient leaf on one side: moments at rounding level,
    parameters moved by under 5% of the summed learning rates."""
    params, mu, nu = trees
    top_mu = max(float(np.abs(x).max()) for x in mu.values())
    top_nu = max(float(np.abs(x).max()) for x in nu.values())
    for path in [p for p in mu if zero_grad and p.endswith(zero_grad)]:
        assert float(np.abs(mu[path]).max()) <= NOISE * top_mu, (what, path)
        assert float(np.abs(nu[path]).max()) <= NOISE ** 2 * top_nu, \
            (what, path)
        moved = float(np.abs(params[path] - init[path]).max())
        assert moved <= 0.05 * sum(lrs), (what, path, moved)


@pytest.mark.parametrize("arch, flash", CASES,
                         ids=[f"{a}-flash{int(f)}" for a, f in CASES])
def test_train_step_matches_reference(arch, flash):
    rcfg = dataclasses.replace(rconfigs.get(arch).reduced(), use_flash=flash)
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), use_flash=flash)
    params = _weights(rcfg)
    zero_grad = _zero_grad_leaf(rcfg)
    ropt = radamw_init(params)
    model = tlm.make_trainable(
        interop.lm_params(_flat(params), tcfg, device="cpu"), tcfg)
    topt = interop.adamw_state(
        {"mu": _flat(ropt["mu"]), "nu": _flat(ropt["nu"]),
         "step": ropt["step"]}, model)
    rstep = jax.jit(functools.partial(
        rlm.train_step, cfg=rcfg, ctx=None, opt_cfg=RAdamWConfig(**OPT)))
    tcfg_opt = AdamWConfig(**OPT)
    init = _flat(params)
    lrs = []
    for i, batch in enumerate(_batches(rcfg, 3)):
        params, ropt, rmet = rstep(params, ropt,
                                   {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        model, topt, tmet = tlm.train_step(
            model, topt, {k: torch.from_numpy(v) for k, v in batch.items()},
            tcfg, tcfg_opt)
        assert set(tmet) == set(rmet) == {"loss", "aux", "total", "lr",
                                           "grad_norm"}
        for key in rmet:
            want = float(rmet[key])
            got = float(tmet[key])
            assert abs(got - want) <= _tol(tcfg) * max(abs(want), 1e-6), \
                (i, key, got, want)
        lrs.append(float(rmet["lr"]))
        if i in (0, 2):
            st = interop.adamw_tree(topt, tcfg)
            assert st["step"] == int(ropt["step"]) == i + 1
            got = (interop.lm_tree(model, tcfg), st["mu"], st["nu"])
            want = (_flat(params), _flat(ropt["mu"]), _flat(ropt["nu"]))
            for name, g, w in zip(("params", "mu", "nu"), got, want):
                _check_trees(g, w, zero_grad, _tol(tcfg),
                             f"{name} after step {i + 1}")
            _check_zero_grad(got, init, lrs, zero_grad,
                             f"port, step {i + 1}")
            _check_zero_grad(want, init, lrs, zero_grad,
                             f"reference, step {i + 1}")
    tree = interop.lm_tree(model, tcfg)
    for k, v in init.items():
        if k.endswith("inv_perm"):
            assert tree[k].dtype == np.int32 and np.array_equal(tree[k], v)


def test_cross_entropy_equals_the_reference_one_hot():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    targets = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = np.asarray(rlm._cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(targets)))
    got = tlm._cross_entropy(torch.from_numpy(logits),
                             torch.from_numpy(targets)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the picked logit is the one-hot contraction's, exactly
    onehot = targets[..., None] == np.arange(50)[None, None, :]
    picked = (logits * onehot).sum(-1)
    lse = torch.logsumexp(torch.from_numpy(logits), -1).numpy()
    assert np.array_equal(got, lse - picked)


def _grads(cfg, seed=0):
    model, _ = tlm.init_all(cfg, seed=seed, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batches(cfg, 1, seed)[0]
             .items()}
    total, _ = tlm.loss_fn(model, batch, cfg)
    total.backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b",
                                  "zamba2-7b", "rwkv6-3b"])
def test_remat_full_gives_the_gradients_of_none_bit_for_bit(arch):
    base = dataclasses.replace(tconfigs.get(arch).reduced(),
                               use_flash=_with_attention(arch))
    full = _grads(dataclasses.replace(base, remat="full"))
    none = _grads(dataclasses.replace(base, remat="none"))
    assert set(full) == set(none)
    for name in full:
        assert torch.equal(full[name], none[name]), name


def test_remat_dots_raises():
    cfg = dataclasses.replace(tconfigs.get("qwen3-0.6b").reduced(),
                              remat="dots")
    model, opt = tlm.init_all(cfg, device="cpu")
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32)}
    with pytest.raises(ValueError, match="ROADMAP item 3"):
        tlm.train_step(model, opt, batch, cfg, AdamWConfig())
    # serving records no graph: the setting does not matter there
    logits, _ = tlm.prefill_step(model, batch, cfg)
    assert logits.shape == (1, cfg.vocab_size)


def test_bf16_compute_trains_float32_masters():
    cfg = dataclasses.replace(tconfigs.get("qwen3-0.6b").reduced(),
                              compute_dtype="bfloat16")
    flat = tlm.init_flat(cfg, device="cpu")
    model, opt = tlm.init_all(cfg, device="cpu")
    params = dict(model.named_parameters())
    # the matrices run in bf16, their masters are the drawn float32 leaves
    assert params["blocks.0.attn.wq"].dtype == torch.bfloat16
    master = model.master["blocks.0.attn.wq"]
    assert master.dtype == torch.float32
    assert torch.equal(master, flat["blocks/attn/wq"][0].reshape(
        master.shape))
    # norm scales are float32 in the module: no master, trained in place
    assert "blocks.0.ln1.scale" not in model.master
    assert set(opt["mu"]) == set(params)
    batch = {"tokens": torch.from_numpy(_batches(cfg, 1)[0]["tokens"])}
    before = master.clone()
    model, opt, met = tlm.train_step(model, opt, batch, cfg, AdamWConfig())
    assert np.isfinite(float(met["loss"]))
    assert not torch.equal(model.master["blocks.0.attn.wq"], before)
    for name, m in model.master.items():
        assert torch.equal(params[name], m.to(params[name].dtype)), name
    # a master is never upcast from the module's bf16-rounded weights
    with pytest.raises(ValueError, match="pass the tree"):
        tlm.make_trainable(ttr.Transformer(cfg, flat), cfg)


def test_leaf_paths_cover_the_reference_tree():
    for arch in tconfigs.ARCH_IDS:
        cfg = tconfigs.get(arch).reduced()
        model = tlm.init_params(cfg, device="cpu")
        shapes = tlm.param_shapes(cfg)
        seen = {}
        for name, p in model.named_parameters():
            path, layer = tlm.leaf_path(name)
            assert path in shapes, (arch, name)
            want = shapes[path] if layer is None else shapes[path][1:]
            assert p.numel() == int(np.prod(want)), (arch, name)
            seen.setdefault(path, set()).add(layer)
        buffers = {tlm.leaf_path(n)[0] for n, _ in model.named_buffers()}
        assert set(seen) | (buffers & set(shapes)) == set(shapes), arch
        for path, layers in seen.items():
            want = {None} if not path.startswith("blocks/") else \
                set(range(cfg.n_layers))
            assert layers == want, (arch, path)


def test_serving_steps_build_no_graph_on_a_trainable_model():
    cfg = tconfigs.get("qwen3-0.6b").reduced()
    model, _ = tlm.init_all(cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    toks = torch.from_numpy(_batches(cfg, 1)[0]["tokens"])
    logits, caches = tlm.prefill_step(model, {"tokens": toks}, cfg)
    assert logits.grad_fn is None and caches["k"].grad_fn is None
