"""repro_torch's Mamba2 stacks (zamba2's hybrid and the pure SSM variant)
against the reference on the CPU.

Reduced zamba2-7b (``cfg.reduced()``: 2 Mamba2 layers, d_model 64, 8 SSM
heads x 16, state 16, conv 4, ``ssm_chunk`` 8, the shared attention block
before every second layer, float32 compute). Weights come from the
reference's own ``init_params`` (key 0) or are drawn with numpy (larger
decays and states than the init's dt of 1e-3 to 1e-1 give), and reach the
port through ``interop.lm_params``. Tolerance 1e-4 absolute: the reference
computes the chunked form in jnp (intra-chunk matrix products, a scan over
chunk states), the port the per-step recurrence of its SSD op, the same
float32 function summed in other orders, through a few layers, on logits of
order 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import lm as rlm
from repro.models import ssm as rssm
from repro.models import transformer as rtr
import repro_torch.configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import _build
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr

TOL = 1e-4
ZAMBA = "zamba2-7b"
B, S = 2, 16
CACHES = ("conv", "ssm", "k", "v")
SSM_CACHES = ("conv", "ssm")


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


def _cfgs(**kw):
    return (dataclasses.replace(rconfigs.get(ZAMBA).reduced(), **kw),
            dataclasses.replace(tconfigs.get(ZAMBA).reduced(), **kw))


def _flatten(tree):
    return {"/".join(p.key for p in path): np.asarray(a) for path, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _unflatten(like, flat):
    paths = jax.tree_util.tree_flatten_with_path(like)[0]
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(like),
        [jnp.asarray(flat["/".join(p.key for p in path)])
         for path, _ in paths])


def _weights(rcfg, source, seed=0):
    """(flat numpy tree, reference tree): the reference's init, or numpy
    draws — matrices N(0, 1)/sqrt(fan_in), norm scales 1 + 0.1 N, conv
    0.3 N, dt_bias N(0, 1) (dt about 0.7), A_log 0.5 N, D N(0, 1)."""
    tree, _ = rtr.init_params(jax.random.PRNGKey(seed), rcfg)
    flat = _flatten(tree)
    if source == "reference_init":
        return flat, tree
    rng = np.random.default_rng(seed)
    for key, a in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("scale", "norm"):
            v = 1.0 + 0.1 * rng.normal(size=a.shape)
        elif leaf in ("conv_w", "conv_b"):
            v = 0.3 * rng.normal(size=a.shape)
        elif leaf in ("dt_bias", "D"):
            v = rng.normal(size=a.shape)
        elif leaf == "A_log":
            v = 0.5 * rng.normal(size=a.shape)
        else:
            fan_in = a.shape[1] if key.startswith("blocks/") else a.shape[0]
            if key.endswith("attn/wo"):
                fan_in = a.shape[0] * a.shape[1]
            v = rng.normal(size=a.shape) / np.sqrt(fan_in)
        flat[key] = v.astype(np.float32)
    return flat, _unflatten(tree, flat)


def _model(source="random", seed=0, **kw):
    rcfg, tcfg = _cfgs(**kw)
    flat, tree = _weights(rcfg, source, seed)
    return rcfg, tcfg, tree, interop.lm_params(flat, tcfg, device="cpu")


def _tokens(cfg, seed, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)


def _err(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


def _rel(got, want) -> float:
    return _err(got, want) / max(float(np.abs(np.asarray(want)).max()),
                                 1e-30)


def _grow(cfg, caches, s, total):
    """The port's prefill caches (K/V sized ``s``) in decode caches of
    ``total`` slots; the Mamba2 states as they are."""
    big = ttr.init_decode_caches(cfg, B, total, device="cpu")
    for k in big:
        if k in "kv":
            big[k][:, :, :s] = caches[k]
        else:
            big[k].copy_(caches[k])
    return big


def _decode_caches(rcfg, tcfg, rcaches, caches, s, total):
    """``_grow`` in both packages."""
    rbig = rtr.init_decode_caches(rcfg, B, total)
    rbig = {k: (rbig[k].at[:, :, :s].set(rcaches[k]) if k in "kv"
                else rcaches[k]) for k in rbig}
    return rbig, _grow(tcfg, caches, s, total)


@pytest.mark.parametrize("attn_every", [2, 0])
def test_param_shapes_are_the_reference_tree(attn_every):
    rcfg, tcfg = _cfgs(attn_every=attn_every)
    shapes = jax.eval_shape(
        lambda: rtr.init_params(jax.random.PRNGKey(0), rcfg)[0])
    want = {"/".join(p.key for p in path): tuple(sd.shape) for path, sd in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert tlm.param_shapes(tcfg) == want


@pytest.mark.parametrize("source", ["reference_init", "random"])
def test_mamba_block_matches_reference(source):
    """One Mamba2 layer: prefill output and decode-ready state, then three
    decode steps from it, against ``mamba2_apply`` / ``mamba2_decode``."""
    rcfg, tcfg = _cfgs()
    flat, tree = _weights(rcfg, source, seed=1)
    w = {k[len("blocks/mamba/"):]: torch.tensor(v[0])
         for k, v in flat.items() if k.startswith("blocks/mamba/")}
    blk = tssm.Mamba2(tcfg, w)
    rp = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"]["mamba"])
    x = np.random.default_rng(2).normal(size=(B, S + 3, 64)).astype(
        np.float32)
    y, st = tssm.mamba2_apply(blk, torch.from_numpy(x[:, :S]), tcfg,
                              return_state=True)
    ry, rst = rssm.mamba2_apply(rp, jnp.asarray(x[:, :S]), rcfg,
                                return_state=True)
    errs = {"prefill": _err(y, ry)}
    errs.update({k: _rel(st[k], rst[k]) for k in SSM_CACHES})
    for t in range(S, S + 3):
        y, st = tssm.mamba2_decode(blk, torch.from_numpy(x[:, t]), st, tcfg)
        ry, rst = rssm.mamba2_decode(rp, jnp.asarray(x[:, t]), rst, rcfg)
        errs[f"decode {t}"] = _err(y, ry)
    errs.update({f"{k} after decode": _rel(st[k], rst[k])
                 for k in SSM_CACHES})
    print({k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("attn_every", [2, 0])
@pytest.mark.parametrize("source", ["reference_init", "random"])
def test_prefill_and_decode_match_reference(source, attn_every):
    """Prefill logits and every cache against the reference's
    ``prefill_step`` (``forward(collect_cache=True)``), then 8 decode
    steps against its ``decode_step``, logits and caches; ``attn_every``
    0 is the pure Mamba2 stack (no shared block, no K/V caches). The port's
    shared block runs its flash op (the reference's flash decode raises;
    its plain attention computes the same function)."""
    rcfg, tcfg, tree, model = _model(source, seed=3, attn_every=attn_every)
    tcfg = dataclasses.replace(tcfg, use_flash=True)
    toks = _tokens(tcfg, 4, S + 8)
    rlogits, rcaches = rlm.prefill_step(
        tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg, None)
    _build.reset_launches()
    logits, caches = tlm.prefill_step(
        model, {"tokens": torch.from_numpy(toks[:, :S])}, tcfg)
    assert not _build.launches            # the CPU runs the plain version
    names = CACHES if attn_every else SSM_CACHES
    assert sorted(caches) == sorted(rcaches) == sorted(names)
    errs = {"prefill": _err(logits, rlogits)}
    for key in names:
        assert caches[key].dtype == torch.float32
        errs[key] = _err(caches[key], rcaches[key])
    rbig, big = _decode_caches(rcfg, tcfg, rcaches, caches, S, S + 8)
    for pos in range(S, S + 8):
        rlogits, rbig = rlm.decode_step(
            tree, rbig, {"token": jnp.asarray(toks[:, pos]),
                         "pos": jnp.asarray(pos, jnp.int32)}, rcfg, None)
        logits, big = tlm.decode_step(
            model, big, {"token": torch.from_numpy(toks[:, pos]),
                         "pos": pos}, tcfg)
        errs[f"decode {pos}"] = _err(logits, rlogits)
    errs.update({f"{k} after decode": _err(big[k], rbig[k]) for k in names})
    print({k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= TOL, errs


def test_flash_and_plain_attention_prefill_agree():
    """The shared block through the flash op (its plain version here) and
    through the plain attention path give the same logits."""
    _, tcfg, _, model = _model(seed=5)
    toks = torch.from_numpy(_tokens(tcfg, 6))
    out = [tlm.prefill_step(model, {"tokens": toks},
                            dataclasses.replace(tcfg, use_flash=flash))[0]
           for flash in (True, False)]
    assert _err(out[0], out[1]) <= TOL


@pytest.mark.parametrize("attn_every", [2, 0])
def test_teacher_forced_decode_equals_forward(attn_every):
    """Every position decoded one at a time from empty caches, and after a
    prefill of half the sequence, against the uncached forward."""
    _, cfg, _, model = _model(seed=7, attn_every=attn_every)
    toks = torch.from_numpy(_tokens(cfg, 8))
    full, _, _ = ttr.forward(model, toks, cfg)
    caches = ttr.init_decode_caches(cfg, B, S, device="cpu")
    for pos in range(S):
        logits, caches = tlm.decode_step(
            model, caches, {"token": toks[:, pos], "pos": pos}, cfg)
        assert _err(logits, full[:, pos]) <= TOL, pos
    _, pre = tlm.prefill_step(model, {"tokens": toks[:, :S // 2]}, cfg)
    caches = _grow(cfg, pre, S // 2, S)
    for pos in range(S // 2, S):
        logits, caches = tlm.decode_step(
            model, caches, {"token": toks[:, pos], "pos": pos}, cfg)
        assert _err(logits, full[:, pos]) <= TOL, pos


def test_state_handoff_prefill_then_decode_equals_longer_prefill():
    """prefill(S) plus one decode step against prefill(S + 1): logits and
    the Mamba2 states (the reference would refuse S + 1 = 17 with chunk 8;
    chunk 1 lets both lengths through)."""
    _, cfg, _, model = _model(seed=9, ssm_chunk=1)
    toks = torch.from_numpy(_tokens(cfg, 10, S + 1))
    _, pre = tlm.prefill_step(model, {"tokens": toks[:, :S]}, cfg)
    caches = _grow(cfg, pre, S, S + 1)
    logits, caches = tlm.decode_step(
        model, caches, {"token": toks[:, S], "pos": S}, cfg)
    want, want_caches = tlm.prefill_step(model, {"tokens": toks}, cfg)
    assert _err(logits, want) <= TOL
    for key in CACHES:
        assert _err(caches[key], want_caches[key]) <= TOL, key


def test_short_prefill_pads_the_conv_state_with_zeros():
    """A prompt shorter than the conv window (2 < K - 1 = 3 tokens): the
    conv state holds zeros before position 0, so decoding on from it
    equals the forward."""
    _, cfg, _, model = _model(seed=11)
    toks = torch.from_numpy(_tokens(cfg, 12, 6))
    full, _, _ = ttr.forward(model, toks, cfg)
    _, pre = tlm.prefill_step(model, {"tokens": toks[:, :2]}, cfg)
    assert tuple(pre["conv"].shape[2:]) == (3, 160)
    assert not pre["conv"][:, :, 0].any()
    caches = _grow(cfg, pre, 2, 6)
    for pos in range(2, 6):
        logits, caches = tlm.decode_step(
            model, caches, {"token": toks[:, pos], "pos": pos}, cfg)
        assert _err(logits, full[:, pos]) <= TOL, pos


def test_prefill_refuses_a_length_off_the_chunk_as_the_reference_does():
    rcfg, tcfg, tree, model = _model(seed=13)
    toks = _tokens(tcfg, 14, 12)            # 12 % 8 != 0
    with pytest.raises(AssertionError):
        rlm.prefill_step(tree, {"tokens": jnp.asarray(toks)}, rcfg, None)
    with pytest.raises(ValueError, match="SSM chunk 8"):
        tlm.prefill_step(model, {"tokens": torch.from_numpy(toks)}, tcfg)


@pytest.mark.parametrize("attn_every", [2, 0])
def test_init_decode_caches_take_the_reference_layout(attn_every):
    rcfg, tcfg = _cfgs(attn_every=attn_every)
    want = rtr.init_decode_caches(rcfg, 3, 7)
    got = ttr.init_decode_caches(tcfg, 3, 7, device="cpu")
    assert sorted(got) == sorted(want)
    for key in got:
        assert tuple(got[key].shape) == want[key].shape, key
        assert str(got[key].dtype).split(".")[-1] == want[key].dtype.name
        assert not got[key].any()


@pytest.mark.parametrize("attn_every", [2, 0])
def test_init_params_draws_the_mamba2_init_constants(attn_every):
    """The leaves ``mamba2_init`` sets without the key equal the
    reference's: ``dt_bias`` (one draw from ``default_rng(0)``, the same
    in every layer), ``D`` and ``norm`` ones, ``conv_b`` zeros, exactly;
    ``A_log = log(linspace(1, 16, H))`` within one float32 step (XLA's log
    is not correctly rounded; the port rounds the float64 log). The
    fixed-scale conv (0.1 N) and the matrices (1/sqrt(fan_in)) have the
    reference's spread."""
    rcfg, tcfg = _cfgs(attn_every=attn_every, n_layers=4, d_model=256)
    rflat = _flatten(rtr.init_params(jax.random.PRNGKey(0), rcfg)[0])
    model = tlm.init_params(tcfg, device="cpu",
                            generator=torch.Generator().manual_seed(4))
    got = {f"blocks/mamba/{name}": torch.stack(
        [getattr(blk.mamba, name) for blk in model.blocks]).numpy()
        for name in ("dt_bias", "A_log", "D", "norm", "conv_b", "conv_w",
                     "in_proj", "out_proj")}
    for name in ("dt_bias", "D", "norm", "conv_b"):
        path = f"blocks/mamba/{name}"
        assert np.array_equal(got[path], rflat[path]), path
    assert np.array_equal(got["blocks/mamba/dt_bias"][0],
                          got["blocks/mamba/dt_bias"][-1])
    ulps = np.abs(got["blocks/mamba/A_log"].view(np.int32)
                  - rflat["blocks/mamba/A_log"].view(np.int32))
    assert ulps.max() <= 1
    assert np.array_equal(tlm.mamba_constants(tcfg)["A_log"],
                          got["blocks/mamba/A_log"][1])
    for name in ("conv_w", "in_proj", "out_proj"):
        path = f"blocks/mamba/{name}"
        ratio = got[path].std() / rflat[path].std()
        assert 0.85 < ratio < 1.15, (path, ratio)
    blks = [blk.ln.scale for blk in model.blocks]
    assert np.array_equal(torch.stack(blks).numpy(), rflat["blocks/ln/scale"])
    assert (model.shared is None) == (attn_every == 0)
    if attn_every:
        ratio = (model.shared.attn.wo.float().std()
                 / rflat["shared/attn/wo"].std())
        assert 0.85 < ratio < 1.15
