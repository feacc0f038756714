"""repro_torch's zamba2 hybrid in bfloat16 compute against the reference
on the CPU.

The float32 parity tests (``test_torch_zamba.py``) do not reach the casts
that only bf16 compute makes. Here both packages run
``compute_dtype="bfloat16"`` on the same weights, the reference's own
``init_params`` (``mamba2_init``'s constants, key 0) carried across by
``interop.lm_params``.

The two bf16 paths differ by design. The reference computes the Mamba2
scan in its chunked form and rounds two of its terms to bf16 before it
sums them: the intra-chunk scores before ``att @ x`` (``ssm.py:119-120``)
and the inter-chunk term ``y_inter`` (``ssm.py:142-144``), and adds ``D·x``
in bf16; the port's SSD op keeps the whole scan in float32 and rounds
``y`` once, for the gated norm. Limits, relative to the largest magnitude
of the reference's output: one Mamba2 layer within 2^-6 (the reference's
two extra roundings of 2^-9 each, on terms that partly cancel in their
sum, against the port's one: a few bf16 steps of 2^-8); the reduced
model's logits and caches within 2^-4, the limit ``chip_smoke.py`` sets for
bf16 logits.

The deep case (81 layers, as zamba2-7b has, at d_model 256 with the shared
block before every sixth) is the witness for the float32 checks (b) and (c)
of ``chip_smoke.py`` phase 10: at that depth bf16 rounding alone moves the
reference's own logits past 2^-4 of its float32 logits, and the port's
bf16 logits lie about as far from the reference's.
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
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr

ZAMBA = "zamba2-7b"
CACHES = ("conv", "ssm", "k", "v")
BF16_LOGITS = 2.0 ** -4
BF16_BLOCK = 2.0 ** -6
# float32 at 81 layers: the same sums in other orders (about 2^-20
# relative) through the stack's gain, with room to spare
F32_DEEP = 2.0 ** -10
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process;
    one call on a single element first makes every later call accurate."""
    torch.exp(torch.zeros(1))


def _cfgs(dt, **size):
    kw = dict(compute_dtype=dt, **size)
    return (dataclasses.replace(rconfigs.get(ZAMBA).reduced(), **kw),
            dataclasses.replace(tconfigs.get(ZAMBA).reduced(), **kw))


def _reference_init(rcfg):
    """The reference's init as its tree and as the port's flat numpy."""
    tree, _ = rtr.init_params(jax.random.PRNGKey(0), rcfg)
    flat = {"/".join(p.key for p in path): np.asarray(a) for path, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    return tree, flat


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.float().numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _tokens(vocab, seed, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (B, s)) \
        .astype(np.int32)


def test_zamba_bf16_mamba_layer_matches_reference():
    """One Mamba2 layer in bf16: the prefill's output and decode state,
    then a decode step from it."""
    rcfg, tcfg = _cfgs("bfloat16")
    tree, flat = _reference_init(rcfg)
    blk = tssm.Mamba2(tcfg, {k[len("blocks/mamba/"):]: torch.tensor(v[0])
                             for k, v in flat.items()
                             if k.startswith("blocks/mamba/")})
    rp = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"]["mamba"])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S + 1, tcfg.d_model)).astype(np.float32)
    y, st = tssm.mamba2_apply(blk, torch.from_numpy(x[:, :S]).bfloat16(),
                              tcfg, return_state=True)
    ry, rst = rssm.mamba2_apply(rp, jnp.asarray(x[:, :S], jnp.bfloat16),
                                rcfg, return_state=True)
    assert y.dtype == st["conv"].dtype == torch.bfloat16
    assert st["ssm"].dtype == torch.float32
    errs = {"prefill": _rel(y, ry)}
    errs.update({k: _rel(st[k], rst[k]) for k in ("conv", "ssm")})
    y, st = tssm.mamba2_decode(blk, torch.from_numpy(x[:, S]).bfloat16(),
                               st, tcfg)
    ry, rst = rssm.mamba2_decode(rp, jnp.asarray(x[:, S], jnp.bfloat16),
                                 rst, rcfg)
    errs["decode"] = _rel(y, ry)
    errs.update({f"{k} after decode": _rel(st[k], rst[k])
                 for k in ("conv", "ssm")})
    print({k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= BF16_BLOCK, errs


def test_zamba_bf16_prefill_and_decode_match_reference():
    """Reduced zamba2-7b in bf16: prefill logits and the four caches, then
    8 decode steps (the port through its flash op, the reference through
    its plain attention: its flash decode raises), logits and caches."""
    rcfg, tcfg = _cfgs("bfloat16")
    tree, flat = _reference_init(rcfg)
    tcfg = dataclasses.replace(tcfg, use_flash=True)
    model = interop.lm_params(flat, tcfg, device="cpu")
    toks = _tokens(tcfg.vocab_size, 6, S + 8)
    rlogits, rcaches = rlm.prefill_step(
        tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg, None)
    logits, caches = tlm.prefill_step(
        model, {"tokens": torch.from_numpy(toks[:, :S])}, tcfg)
    errs = {"prefill": _rel(logits, rlogits)}
    errs.update({k: _rel(caches[k], rcaches[k]) for k in CACHES})
    rbig = rtr.init_decode_caches(rcfg, B, S + 8)
    rbig = {k: (rbig[k].at[:, :, :S].set(rcaches[k]) if k in "kv"
                else rcaches[k]) for k in rbig}
    big = ttr.init_decode_caches(tcfg, B, S + 8, device="cpu")
    for k in big:
        if k in "kv":
            big[k][:, :, :S] = caches[k]
        else:
            big[k].copy_(caches[k])
    for pos in range(S, S + 8):
        rlogits, rbig = rlm.decode_step(
            tree, rbig, {"token": jnp.asarray(toks[:, pos]),
                         "pos": jnp.asarray(pos, jnp.int32)}, rcfg, None)
        logits, big = tlm.decode_step(
            model, big, {"token": torch.from_numpy(toks[:, pos]),
                         "pos": pos}, tcfg)
        errs[f"decode {pos}"] = _rel(logits, rlogits)
    errs.update({f"{k} after decode": _rel(big[k], rbig[k])
                 for k in CACHES})
    print({k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= BF16_LOGITS, errs


def test_zamba_bf16_rounding_moves_the_reference_past_the_bf16_limit():
    """81 layers at d_model 256 (the shared block before every sixth,
    ``ssm_chunk`` 64, vocab 512), 2 x 128 tokens: in float32 the port
    meets the reference within 2^-10; in bf16 the reference's own logits
    leave its float32 logits by more than 2^-4 of the largest, and the
    port's bf16 logits are no farther from the reference's than that
    (within a factor 2), their own bf16 gap within a factor 2 of the
    reference's."""
    size = dict(n_layers=81, d_model=256, vocab_size=512, attn_every=6,
                ssm_chunk=64)
    rcfg32, _ = _cfgs("float32", **size)
    tree, flat = _reference_init(rcfg32)
    toks = _tokens(512, 7, 128)
    fwd = {}
    for dt in ("float32", "bfloat16"):
        rcfg, tcfg = _cfgs(dt, **size)
        model = interop.lm_params(flat, tcfg, device="cpu")
        fwd["ref", dt] = rtr.forward(tree, jnp.asarray(toks), rcfg, None)[0]
        fwd["port", dt] = ttr.forward(model, torch.from_numpy(toks), tcfg)[0]
    f32_gap = _rel(fwd["port", "float32"], fwd["ref", "float32"])
    ref_noise = _rel(fwd["ref", "bfloat16"], fwd["ref", "float32"])
    port_noise = _rel(fwd["port", "bfloat16"], fwd["port", "float32"])
    port_gap = _rel(fwd["port", "bfloat16"], fwd["ref", "bfloat16"])
    print(f"port vs reference, float32: {f32_gap:.2e}; reference bf16 vs "
          f"its float32: {ref_noise:.4f}; port bf16 vs its float32: "
          f"{port_noise:.4f}; port bf16 vs reference bf16: {port_gap:.4f}")
    assert f32_gap <= F32_DEEP
    assert ref_noise > BF16_LOGITS
    assert port_gap <= 2 * ref_noise
    assert 0.5 <= port_noise / ref_noise <= 2
