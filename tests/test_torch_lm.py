"""repro_torch's LM serving path against the reference on the CPU.

Weights and inputs are drawn once with numpy and handed to both packages
(the reference as its parameter tree, the port through
``interop.lm_params``), at the reduced size of each config (2 layers,
d_model 64, float32 compute). Logits agree within 1e-4 absolute: the two
packages take the same float32 sums in different orders (XLA's and
torch's matmuls, the flash kernels' tiles), through two layers, on logits
of order 1.

The reference's cached decode raises with ``use_flash=True`` (its
``flash_attention`` passes a traced ``kv_valid_len`` as a static argument),
so the decode oracle is the reference's ``use_flash=False`` decode, which
computes the same function; the port's decode runs both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.models import rwkv as rrwkv
from repro.models import transformer as rtr
import repro_torch.configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import _build
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttr

TOL = 1e-4
ARCHS = ["qwen3-0.6b", "smollm-360m", "starcoder2-15b", "qwen2.5-32b",
         "chameleon-34b", "hubert-xlarge"]
B, S, EXTRA = 2, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


def _cfgs(arch, **kw):
    r = dataclasses.replace(rconfigs.get(arch).reduced(), **kw)
    t = dataclasses.replace(tconfigs.get(arch).reduced(), **kw)
    return r, t


def _path(path):
    return "/".join(p.key for p in path)


def _random_tree(rcfg, seed=0):
    """The reference's parameter tree filled from numpy: matrices normal
    over sqrt(fan_in) (``moe_init``'s fan-ins for MoE experts), norm
    scales near 1, biases small and nonzero, an MoE layer's slot map the
    identity (int32)."""
    rng = np.random.default_rng(seed)
    shapes = _shapes(rcfg)
    flat = {}
    for path, sd in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key, shape = _path(path), sd.shape
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "inv_perm":
            flat[key] = np.broadcast_to(np.arange(shape[-1], dtype=np.int32),
                                        shape).copy()
            continue
        if leaf in ("scale", "q_norm", "k_norm"):
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif leaf.startswith("b"):
            a = 0.1 * rng.normal(size=shape)
        elif key in ("blocks/moe/wg", "blocks/moe/wi", "blocks/moe/wo"):
            a = rng.normal(size=shape) / np.sqrt(shape[2])
        else:
            fan_in = shape[1] if key.startswith("blocks/") else shape[0]
            if key == "blocks/attn/wo":
                fan_in = shape[1] * shape[2]
            a = rng.normal(size=shape) / np.sqrt(fan_in)
        flat[key] = a.astype(np.float32)
    return flat, _tree(shapes, flat)


def _shapes(rcfg):
    """The reference's parameter tree of ``rcfg`` as shapes."""
    return jax.eval_shape(
        lambda: rtr.init_params(jax.random.PRNGKey(0), rcfg)[0])


def _tree(shapes, flat):
    """The reference's tree of ``shapes`` holding the arrays of ``flat``
    (keyed by path)."""
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [jnp.asarray(flat[_path(p)]) for p, _ in
         jax.tree_util.tree_flatten_with_path(shapes)[0]])


def _inputs(cfg, rng, b=B, s=S):
    if cfg.embedding_inputs:
        e = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
        return {"embeddings": jnp.asarray(e)}, {"embeddings":
                                                torch.from_numpy(e)}
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(norm):
    rng = np.random.default_rng(1)
    cfg = dataclasses.replace(tconfigs.get("qwen3-0.6b").reduced(),
                              norm=norm)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 0.5
    w = {"scale": rng.normal(size=64).astype(np.float32)}
    if norm == "layernorm":
        w["bias"] = rng.normal(size=64).astype(np.float32)
    got = tlayers.norm_apply(
        tlayers.Norm({k: torch.from_numpy(v) for k, v in w.items()}),
        torch.from_numpy(x), cfg)
    want = rlayers.norm_apply({k: jnp.asarray(v) for k, v in w.items()},
                              jnp.asarray(x), cfg)
    assert _err(got, want) <= 1e-5


def test_rms_head_norm_and_rope_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 7))
    assert _err(tlayers.rms_head_norm(torch.from_numpy(scale),
                                      torch.from_numpy(x)),
                rlayers.rms_head_norm(jnp.asarray(scale),
                                      jnp.asarray(x))) <= 1e-5
    for theta in (1e4, 1e6):
        got = tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        want = rlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        # angles up to 3000 rad: float32 cos/sin of two libraries
        assert _err(got, want) <= 1e-4


def _block_weights(rcfg, seed):
    flat, tree = _random_tree(rcfg, seed)
    return ({k[7:]: v[0] for k, v in flat.items() if k.startswith("blocks/")},
            jax.tree.map(lambda a: a[0], tree["blocks"]))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_qk_norm_attention_matches_reference(use_flash, cached):
    rcfg, tcfg = _cfgs("qwen3-0.6b", use_flash=use_flash)
    blk, rblk = _block_weights(rcfg, 3)
    attn = tlayers.Attention(tcfg, {k[5:]: torch.from_numpy(v)
                                    for k, v in blk.items()
                                    if k.startswith("attn/")})
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32)
    kw_t = dict(positions=torch.arange(3, 9)[None].expand(2, 6))
    kw_r = dict(positions=jnp.broadcast_to(jnp.arange(3, 9)[None], (2, 6)))
    if cached:
        shape = (2, 12, tcfg.n_kv_heads, tcfg.resolved_head_dim)
        kc = rng.normal(size=shape).astype(np.float32)
        vc = rng.normal(size=shape).astype(np.float32)
        kw_t.update(cache=(torch.from_numpy(kc.copy()),
                           torch.from_numpy(vc.copy())), cache_pos=3)
        kw_r.update(cache=(jnp.asarray(kc), jnp.asarray(vc)), cache_pos=3)
    y, cache = tlayers.attention_apply(attn, torch.from_numpy(x), tcfg,
                                       **kw_t)
    ry, rcache = rlayers.attention_apply(rblk["attn"], jnp.asarray(x), rcfg,
                                         **kw_r)
    assert _err(y, ry) <= 1e-5
    if cached:
        for got, want in zip(cache, rcache):
            assert _err(got, want) <= 1e-5


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "starcoder2-15b"])
def test_mlp_matches_reference(arch):
    rcfg, tcfg = _cfgs(arch)
    blk, rblk = _block_weights(rcfg, 5)
    mlp = tlayers.MLP(tcfg, {k[4:]: torch.from_numpy(v)
                             for k, v in blk.items() if k.startswith("mlp/")})
    x = np.random.default_rng(6).normal(size=(2, 5, 64)).astype(np.float32)
    got = tlayers.mlp_apply(mlp, torch.from_numpy(x), tcfg)
    want = rlayers.mlp_apply(rblk["mlp"], jnp.asarray(x), rcfg)
    assert _err(got, want) <= 1e-5


# --------------------------------------------------------------------------- #
# the slice: prefill and decode
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS + ["rwkv6-3b"])
def test_param_shapes_are_the_reference_tree(arch):
    rcfg, tcfg = _cfgs(arch)
    shapes = jax.eval_shape(
        lambda: rtr.init_params(jax.random.PRNGKey(0), rcfg)[0])
    want = {_path(p): tuple(sd.shape) for p, sd in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert tlm.param_shapes(tcfg) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    rcfg, tcfg = _cfgs(arch, use_flash=True)
    flat, tree = _random_tree(rcfg)
    model = interop.lm_params(flat, tcfg, device="cpu")
    rng = np.random.default_rng(7)
    rb, tb = _inputs(rcfg, rng)
    rlogits, rcaches = rlm.prefill_step(tree, rb, rcfg, None)
    _build.reset_launches()
    logits, caches = tlm.prefill_step(model, tb, tcfg)
    assert not _build.launches            # the CPU runs the plain version
    errs = {"prefill": _err(logits, rlogits)}
    assert logits.shape == (B, tcfg.vocab_size)
    if not tcfg.has_decode:               # encoder-only: prefill only
        assert caches is None and rcaches is None
    else:
        for key in "kv":
            errs[f"cache {key}"] = _err(caches[key], rcaches[key])
        big = rtr.init_decode_caches(rcfg, B, S + EXTRA)
        big = {k: big[k].at[:, :, :S].set(rcaches[k]) for k in "kv"}
        tok = rng.integers(0, rcfg.vocab_size, (B,)).astype(np.int32)
        rdec, _ = rlm.decode_step(
            tree, big, {"token": jnp.asarray(tok),
                        "pos": jnp.asarray(S, jnp.int32)},
            dataclasses.replace(rcfg, use_flash=False), None)
        for flash in (True, False):
            cfg = dataclasses.replace(tcfg, use_flash=flash)
            tbig = ttr.init_decode_caches(cfg, B, S + EXTRA, device="cpu")
            for key in "kv":
                tbig[key][:, :, :S] = caches[key]
            dec, _ = tlm.decode_step(
                model, tbig, {"token": torch.from_numpy(tok), "pos": S}, cfg)
            errs[f"decode flash={flash}"] = _err(dec, rdec)
    print(arch, {k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= TOL, errs


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "smollm-360m"])
def test_plain_attention_prefill_matches_reference(arch):
    rcfg, tcfg = _cfgs(arch, use_flash=False)
    flat, tree = _random_tree(rcfg, seed=8)
    model = interop.lm_params(flat, tcfg, device="cpu")
    rb, tb = _inputs(rcfg, np.random.default_rng(9))
    rlogits, rcaches = rlm.prefill_step(tree, rb, rcfg, None)
    logits, caches = tlm.prefill_step(model, tb, tcfg)
    assert _err(logits, rlogits) <= TOL
    assert max(_err(caches[k], rcaches[k]) for k in "kv") <= TOL


# float16 compute: each cast rounds to 2^-11 relative, and the two packages
# round the same float16 values at other points (the reference's plain
# attention takes the softmax weights to float16 and sums P·V in float16,
# the port's flash keeps both in float32) through two layers, a few
# float16 steps of the largest magnitude (2^-9.4 measured on the logits);
# 2^-7 of it leaves a factor of about 5
F16_REL = 2.0 ** -7


def _rel16(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_float16_prefill_and_decode_match_reference():
    """Reduced qwen3-0.6b with ``compute_dtype="float16"`` and flash
    attention, which the port's CPU tier computes (the CUDA tier on the
    scalar flash kernel): prefill logits and K/V caches, then a decode
    step through flash and through plain attention, against the
    reference's float16 prefill and its ``use_flash=False`` decode."""
    rcfg, tcfg = _cfgs("qwen3-0.6b", use_flash=True, compute_dtype="float16")
    flat, tree = _random_tree(rcfg)
    model = interop.lm_params(flat, tcfg, device="cpu")
    rng = np.random.default_rng(7)
    rb, tb = _inputs(rcfg, rng)
    rlogits, rcaches = rlm.prefill_step(tree, rb, rcfg, None)
    logits, caches = tlm.prefill_step(model, tb, tcfg)
    assert caches["k"].dtype == torch.float16
    errs = {"prefill": _rel16(logits, rlogits)}
    errs.update({f"cache {k}": _rel16(caches[k], rcaches[k]) for k in "kv"})
    big = rtr.init_decode_caches(rcfg, B, S + EXTRA)
    big = {k: big[k].at[:, :, :S].set(rcaches[k]) for k in "kv"}
    tok = rng.integers(0, rcfg.vocab_size, (B,)).astype(np.int32)
    rdec, _ = rlm.decode_step(
        tree, big, {"token": jnp.asarray(tok), "pos": jnp.asarray(S, jnp.int32)},
        dataclasses.replace(rcfg, use_flash=False), None)
    for flash in (True, False):
        cfg = dataclasses.replace(tcfg, use_flash=flash)
        tbig = ttr.init_decode_caches(cfg, B, S + EXTRA, device="cpu")
        for key in "kv":
            tbig[key][:, :, :S] = caches[key]
        dec, _ = tlm.decode_step(
            model, tbig, {"token": torch.from_numpy(tok), "pos": S}, cfg)
        errs[f"decode flash={flash}"] = _rel16(dec, rdec)
    print({k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= F16_REL, errs


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2.5-32b"])
def test_teacher_forced_decode_equals_forward(arch, use_flash):
    _, cfg = _cfgs(arch, use_flash=use_flash)
    flat, _ = _random_tree(_cfgs(arch)[0], seed=10)
    model = interop.lm_params(flat, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    full, _, _ = ttr.forward(model, toks, cfg)
    _, caches = tlm.prefill_step(model, {"tokens": toks[:, :8]}, cfg)
    big = ttr.init_decode_caches(cfg, 2, 16, device="cpu")
    for key in "kv":
        big[key][:, :, :8] = caches[key]
    for pos in range(8, 16):
        logits, big = tlm.decode_step(
            model, big, {"token": toks[:, pos], "pos": pos}, cfg)
        assert _err(logits, full[:, pos]) <= TOL


def test_init_params_follows_the_reference_distribution():
    _, cfg = _cfgs("qwen3-0.6b")
    model = tlm.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    again = tlm.init_params(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))
    wq = model.blocks[0].attn.wq
    assert abs(float(wq.std()) - 1 / np.sqrt(cfg.d_model)) < 0.02
    assert torch.equal(model.ln_f.scale, torch.ones(cfg.d_model))


def test_entry_points_default_to_the_card():
    _, cfg = _cfgs("qwen3-0.6b")
    if torch.cuda.is_available():
        assert tlm.init_params(cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.make_batch(cfg, "prefill_32k", np.random.default_rng(0), 2)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen3-0.6b"])
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_make_batch_draws_what_the_reference_draws(arch, shape):
    rcfg, tcfg = _cfgs(arch)
    want = rlm.make_batch(rcfg, shape, np.random.default_rng(12), 2)
    got = tlm.make_batch(tcfg, shape, np.random.default_rng(12), 2,
                         device="cpu")
    assert sorted(got) == sorted(want)
    for key in got:
        g = got[key]
        g = float(g) if isinstance(g, int) else g.float().numpy()
        assert np.array_equal(g, np.asarray(want[key], np.float32)), key


def test_lm_params_refuses_a_tree_of_another_config():
    rcfg, tcfg = _cfgs("qwen3-0.6b")
    flat, _ = _random_tree(rcfg)
    with pytest.raises(ValueError, match="paths differ"):
        interop.lm_params({k: v for k, v in flat.items() if k != "head"},
                          tcfg, device="cpu")
    flat["embed"] = flat["embed"][:-1]
    with pytest.raises(ValueError, match="embed: shape"):
        interop.lm_params(flat, tcfg, device="cpu")


# --------------------------------------------------------------------------- #
# RWKV6 (reduced rwkv6-3b: 2 layers, d_model 64, 4 heads x 16, float32).
# The reference's prefill runs its Pallas WKV kernel in interpret mode under
# use_flash=True and its scan otherwise; its decode always scans. The port
# runs its WKV op (here the plain version) in both.
# --------------------------------------------------------------------------- #

RWKV = "rwkv6-3b"
RWKV_CACHES = ("tm_shift", "cm_shift", "wkv")


def _rwkv_model(seed=0, **kw):
    rcfg, tcfg = _cfgs(RWKV, **kw)
    flat, tree = _random_tree(rcfg, seed)
    return rcfg, tcfg, tree, interop.lm_params(flat, tcfg, device="cpu")


def _tokens(cfg, seed, b=B, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _rel_err(got, want) -> float:
    """Max abs difference over the largest magnitude: the WKV states grow
    to magnitudes of 10 and more, where 1e-5 absolute is below float32's
    step."""
    return _err(got, want) / float(np.abs(np.asarray(want)).max())


def _rwkv_block(rcfg, tcfg, seed):
    blk, rblk = _block_weights(rcfg, seed)
    return trwkv.RWKVBlock(tcfg, {k: torch.from_numpy(v)
                                  for k, v in blk.items()}), rblk


@pytest.mark.parametrize("part", ["time_mix", "time_mix_state",
                                  "channel_mix"])
def test_rwkv_mixes_match_reference(part):
    rcfg, tcfg = _cfgs(RWKV)
    blk, rblk = _rwkv_block(rcfg, tcfg, 13)
    rng = np.random.default_rng(14)
    x = rng.normal(size=(2, 6, 64)).astype(np.float32)
    xs = rng.normal(size=(2, 6, 64)).astype(np.float32)
    if part == "channel_mix":
        got = trwkv.channel_mix(blk.cm, torch.from_numpy(x),
                                torch.from_numpy(xs), tcfg)
        want = rrwkv.channel_mix(rblk["tm"], jnp.asarray(x), jnp.asarray(xs),
                                 rcfg)
        assert _err(got, want) <= 1e-5
        return
    st = None
    if part == "time_mix_state":
        st = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    y, new = trwkv.time_mix(blk.tm, torch.from_numpy(x), torch.from_numpy(xs),
                            None if st is None else torch.from_numpy(st),
                            tcfg)
    ry, rnew = rrwkv.time_mix(rblk["tm"], jnp.asarray(x), jnp.asarray(xs),
                              None if st is None else jnp.asarray(st), rcfg)
    assert _err(y, ry) <= 1e-5 and _rel_err(new, rnew) <= 1e-5


def test_rwkv_block_decode_matches_reference():
    rcfg, tcfg = _cfgs(RWKV)
    blk, rblk = _rwkv_block(rcfg, tcfg, 15)
    rng = np.random.default_rng(16)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    st = {"tm_shift": rng.normal(size=(3, 64)),
          "cm_shift": rng.normal(size=(3, 64)),
          "wkv": rng.normal(size=(3, 4, 16, 16))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    y, new = trwkv.rwkv_block_decode(
        blk, torch.from_numpy(x), {k: torch.from_numpy(v)
                                   for k, v in st.items()}, tcfg)
    ry, rnew = rrwkv.rwkv_block_decode(
        rblk, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()},
        rcfg)
    assert _err(y, ry) <= 1e-5
    assert max(_rel_err(new[k], rnew[k]) for k in RWKV_CACHES) <= 1e-5


@pytest.mark.parametrize("ref_flash", [True, False])
def test_rwkv_prefill_matches_reference(ref_flash):
    """Logits and all three caches against the reference's prefill through
    its interpret-mode Pallas kernel and through its scan."""
    rcfg, tcfg, tree, model = _rwkv_model(use_flash=True)
    toks = _tokens(tcfg, 17)
    rlogits, rcaches = rlm.prefill_step(
        tree, {"tokens": jnp.asarray(toks)},
        dataclasses.replace(rcfg, use_flash=ref_flash), None)
    _build.reset_launches()
    logits, caches = tlm.prefill_step(model, {"tokens":
                                              torch.from_numpy(toks)}, tcfg)
    assert not _build.launches            # the CPU runs the plain version
    assert logits.shape == (B, tcfg.vocab_size)
    errs = {"logits": _err(logits, rlogits)}
    for key in RWKV_CACHES:
        assert caches[key].dtype == torch.float32
        assert tuple(caches[key].shape) == rcaches[key].shape
        errs[key] = _err(caches[key], rcaches[key])
    print({k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= TOL, errs


def test_rwkv_decode_matches_reference_for_eight_steps():
    rcfg, tcfg, tree, model = _rwkv_model(seed=1, use_flash=True)
    toks = _tokens(tcfg, 18, s=S + 8)
    _, rcaches = rlm.prefill_step(tree, {"tokens": jnp.asarray(toks[:, :S])},
                                  rcfg, None)
    _, caches = tlm.prefill_step(
        model, {"tokens": torch.from_numpy(toks[:, :S])}, tcfg)
    for pos in range(S, S + 8):
        rlogits, rcaches = rlm.decode_step(
            tree, rcaches, {"token": jnp.asarray(toks[:, pos]),
                            "pos": jnp.asarray(pos, jnp.int32)}, rcfg, None)
        logits, caches = tlm.decode_step(
            model, caches, {"token": torch.from_numpy(toks[:, pos]),
                            "pos": pos}, tcfg)
        assert _err(logits, rlogits) <= TOL, pos
    assert max(_err(caches[k], rcaches[k]) for k in RWKV_CACHES) <= TOL


def test_rwkv_teacher_forced_decode_equals_forward():
    """Every position decoded one at a time from the zero state, and after
    a prefill of half the sequence, against the uncached forward."""
    _, cfg, _, model = _rwkv_model(seed=2)
    toks = torch.from_numpy(_tokens(cfg, 19))
    full, _, _ = ttr.forward(model, toks, cfg)
    caches = ttr.init_decode_caches(cfg, B, 0, device="cpu")
    for pos in range(S):
        logits, caches = tlm.decode_step(
            model, caches, {"token": toks[:, pos], "pos": pos}, cfg)
        assert _err(logits, full[:, pos]) <= TOL, pos
    _, caches = tlm.prefill_step(model, {"tokens": toks[:, :S // 2]}, cfg)
    for pos in range(S // 2, S):
        logits, caches = tlm.decode_step(
            model, caches, {"token": toks[:, pos], "pos": pos}, cfg)
        assert _err(logits, full[:, pos]) <= TOL, pos


def test_rwkv_state_handoff_prefill_then_decode_equals_longer_prefill():
    _, cfg, _, model = _rwkv_model(seed=3)
    toks = torch.from_numpy(_tokens(cfg, 20, s=S + 1))
    _, caches = tlm.prefill_step(model, {"tokens": toks[:, :S]}, cfg)
    logits, caches = tlm.decode_step(
        model, caches, {"token": toks[:, S], "pos": S}, cfg)
    want, want_caches = tlm.prefill_step(model, {"tokens": toks}, cfg)
    assert _err(logits, want) <= TOL
    assert max(_err(caches[k], want_caches[k]) for k in RWKV_CACHES) <= TOL


def test_rwkv_init_decode_caches_take_the_reference_layout():
    rcfg, tcfg = _cfgs(RWKV)
    want = rtr.init_decode_caches(rcfg, 3, 7)
    got = ttr.init_decode_caches(tcfg, 3, 7, device="cpu")
    assert sorted(got) == sorted(want) == sorted(RWKV_CACHES)
    for key in RWKV_CACHES:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.float32 and not got[key].any()


def test_rwkv_init_params_draws_the_reference_constants():
    """The leaves ``rwkv6_init`` sets to constants equal the reference's;
    the fixed-scale normals (mix_w2, decay_w2: 0.01; u: 0.1) and the
    matrices (1/sqrt(fan_in)) have the reference's spread."""
    rcfg, tcfg = _cfgs(RWKV)
    rparams, _ = rtr.init_params(jax.random.PRNGKey(0), rcfg)
    rflat = {_path(p): np.asarray(a) for p, a in
             jax.tree_util.tree_flatten_with_path(rparams)[0]}
    model = tlm.init_params(tcfg, device="cpu",
                            generator=torch.Generator().manual_seed(4))
    got = {f"blocks/tm/{name}": torch.stack(
        [getattr(blk.tm if hasattr(blk.tm, name) else blk.cm, name)
         for blk in model.blocks]).numpy()
        for name in trwkv.TIME_MIX_LEAVES + trwkv.CHANNEL_MIX_LEAVES}
    for name in tlm.RWKV_CONSTANTS:
        path = f"blocks/tm/{name}"
        assert np.array_equal(got[path], rflat[path]), path
    for name in ("ln1/scale", "ln2/scale"):
        blks = [getattr(b, name.split("/")[0]).scale for b in model.blocks]
        assert np.array_equal(torch.stack(blks).numpy(),
                              rflat[f"blocks/{name}"])
    for name in tuple(tlm.RWKV_NORMAL_SCALES) + ("wr", "cm_v", "decay_w1"):
        path = f"blocks/tm/{name}"
        ratio = got[path].std() / rflat[path].std()
        assert 0.85 < ratio < 1.15, (path, ratio)
