"""repro_torch's RWKV6 path in bfloat16 compute against the reference on
the CPU.

The float32 parity tests (``test_torch_lm.py``) do not reach the casts that
only bf16 compute makes: the norms and the channel mix in bf16, the shift
states cast between bf16 and float32, the time mix upcast to float32 and
cast back. Here both packages run ``compute_dtype="bfloat16"`` on the same
weights, the reference's own ``init_params`` (``rwkv6_init``'s constants
and scales, key 0) carried across by ``interop.lm_params``.

Limits, relative to the largest magnitude of the reference's output: one
block's mixes within 2^-7 (two bf16 steps of 2^-8: the two packages round
the same bf16 products, summed in other orders); the reduced model's logits
and caches within 2^-4, the limit ``chip_smoke.py`` sets for bf16 logits.

The deep case (32 layers, as rwkv6-3b has, at d_model 256) is the witness
for the bf16 teacher-forced check of ``chip_smoke.py`` phase 11: at that
depth bf16 rounding alone moves the reference's own logits past 2^-4, and
the port's bf16 logits lie as far from the reference's as the reference's
bf16 logits lie from its float32 ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rconfigs
from repro.models import lm as rlm
from repro.models import rwkv as rrwkv
from repro.models import transformer as rtr
import repro_torch.configs as tconfigs
from repro_torch import interop
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttr

RWKV = "rwkv6-3b"
CACHES = ("tm_shift", "cm_shift", "wkv")
BF16_LOGITS = 2.0 ** -4
BF16_MIX = 2.0 ** -7
# float32 at 32 layers: the same sums in other orders (about 2^-20
# relative) through the stack's gain of up to 2^9, with room to spare
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
    return (dataclasses.replace(rconfigs.get(RWKV).reduced(), **kw),
            dataclasses.replace(tconfigs.get(RWKV).reduced(), **kw))


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


@pytest.mark.parametrize("part", ["time_mix", "channel_mix", "block_decode"])
def test_rwkv_bf16_mixes_match_reference(part):
    rcfg, tcfg = _cfgs("bfloat16")
    tree, flat = _reference_init(rcfg)
    blk = {k[len("blocks/"):]: torch.tensor(v[0]) for k, v in flat.items()
           if k.startswith("blocks/")}
    p = trwkv.RWKVBlock(tcfg, blk)
    rp = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 6, tcfg.d_model)).astype(np.float32)
    xs = rng.normal(size=(B, 6, tcfg.d_model)).astype(np.float32)
    tx, txs = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, xs))
    rx, rxs = (jnp.asarray(a, jnp.bfloat16) for a in (x, xs))
    if part == "time_mix":
        y, st = trwkv.time_mix(p.tm, tx, txs, None, tcfg)
        ry, rst = rrwkv.time_mix(rp["tm"], rx, rxs, None, rcfg)
        assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
        errs = [_rel(y, ry), _rel(st, rst)]
    elif part == "channel_mix":
        y = trwkv.channel_mix(p.cm, tx, txs, tcfg)
        ry = rrwkv.channel_mix(rp["tm"], rx, rxs, rcfg)
        assert y.dtype == torch.bfloat16
        errs = [_rel(y, ry)]
    else:
        st = {"tm_shift": rng.normal(size=(B, tcfg.d_model)),
              "cm_shift": rng.normal(size=(B, tcfg.d_model)),
              "wkv": rng.normal(size=(B, 4, 16, 16))}
        st = {k: v.astype(np.float32) for k, v in st.items()}
        y, new = trwkv.rwkv_block_decode(
            p, tx[:, 0], {k: torch.from_numpy(v) for k, v in st.items()},
            tcfg)
        ry, rnew = rrwkv.rwkv_block_decode(
            rp, rx[:, 0], {k: jnp.asarray(v) for k, v in st.items()}, rcfg)
        assert y.dtype == torch.bfloat16
        errs = [_rel(y, ry)] + [_rel(new[k], rnew[k]) for k in CACHES]
    print([f"{e:.2e}" for e in errs])
    assert max(errs) <= BF16_MIX, errs


@pytest.mark.parametrize("ref_flash", [True, False])
def test_rwkv_bf16_prefill_and_decode_match_reference(ref_flash):
    """Reduced rwkv6-3b in bf16: prefill logits and caches, then 8 decode
    steps, against the reference's prefill (its interpret-mode Pallas WKV
    or its scan) and decode."""
    rcfg, tcfg = _cfgs("bfloat16", use_flash=True)
    tree, flat = _reference_init(rcfg)
    rcfg = dataclasses.replace(rcfg, use_flash=ref_flash)
    model = interop.lm_params(flat, tcfg, device="cpu")
    toks = _tokens(tcfg.vocab_size, 6, S + 8)
    rlogits, rcaches = rlm.prefill_step(
        tree, {"tokens": jnp.asarray(toks[:, :S])}, rcfg, None)
    logits, caches = tlm.prefill_step(
        model, {"tokens": torch.from_numpy(toks[:, :S])}, tcfg)
    errs = {"prefill": _rel(logits, rlogits)}
    errs.update({k: _rel(caches[k], rcaches[k]) for k in CACHES})
    for pos in range(S, S + 8):
        rlogits, rcaches = rlm.decode_step(
            tree, rcaches, {"token": jnp.asarray(toks[:, pos]),
                            "pos": jnp.asarray(pos, jnp.int32)}, rcfg, None)
        logits, caches = tlm.decode_step(
            model, caches, {"token": torch.from_numpy(toks[:, pos]),
                            "pos": pos}, tcfg)
        errs[f"decode {pos}"] = _rel(logits, rlogits)
    errs.update({f"{k} after decode": _rel(caches[k], rcaches[k])
                 for k in CACHES})
    print({k: f"{v:.2e}" for k, v in errs.items()})
    assert max(errs.values()) <= BF16_LOGITS, errs


def _by_position(got, want) -> np.ndarray:
    """max |got - want| at each position over the largest |want|."""
    got, want = _f32(got), _f32(want)
    return np.abs(got - want).max(axis=(0, 2)) / np.abs(want).max()


def test_rwkv_bf16_rounding_moves_the_reference_as_far_as_the_port():
    """32 layers at d_model 256 (4 heads x 64, ff 896, vocab 1024): in
    float32 the port meets the reference within 2^-10; in bf16 the
    reference's own teacher-forced decode leaves its own forward by more
    than 2^-4, and the port's bf16 logits are no farther from the
    reference's than the reference's bf16 logits are from its float32 ones
    (within a factor 2, at the worst position and at position 0)."""
    size = dict(n_layers=32, d_model=256, d_ff=896, vocab_size=1024,
                rwkv_head_dim=64, rwkv_lora_dim=64)
    rcfg32, _ = _cfgs("float32", **size)
    tree, flat = _reference_init(rcfg32)
    toks = _tokens(1024, 7)
    fwd, dec = {}, {}
    for dt in ("float32", "bfloat16"):
        rcfg, tcfg = _cfgs(dt, **size)
        model = interop.lm_params(flat, tcfg, device="cpu")
        fwd["ref", dt] = rtr.forward(tree, jnp.asarray(toks), rcfg, None)[0]
        fwd["port", dt] = ttr.forward(model, torch.from_numpy(toks), tcfg)[0]
        if dt == "bfloat16":
            caches = rtr.init_decode_caches(rcfg, B, 0)
            steps = []
            for pos in range(S):
                lg, caches = rlm.decode_step(
                    tree, caches, {"token": jnp.asarray(toks[:, pos]),
                                   "pos": jnp.asarray(pos, jnp.int32)},
                    rcfg, None)
                steps.append(_f32(lg))
            dec["ref", dt] = np.stack(steps, 1)
    f32_gap = _by_position(fwd["port", "float32"], fwd["ref", "float32"])
    ref_teacher = _by_position(dec["ref", "bfloat16"],
                               fwd["ref", "bfloat16"])
    ref_noise = _by_position(fwd["ref", "bfloat16"], fwd["ref", "float32"])
    port_noise = _by_position(fwd["port", "bfloat16"],
                              fwd["port", "float32"])
    port_gap = _by_position(fwd["port", "bfloat16"], fwd["ref", "bfloat16"])
    for name, e in (("port vs reference, float32", f32_gap),
                    ("reference bf16 decode vs its bf16 forward",
                     ref_teacher),
                    ("reference bf16 vs its float32", ref_noise),
                    ("port bf16 vs its float32", port_noise),
                    ("port bf16 vs reference bf16", port_gap)):
        print(f"{name}: max {e.max():.4f}, position 0 {e[0]:.4f}")
    assert f32_gap.max() <= F32_DEEP
    assert ref_teacher.max() > BF16_LOGITS
    assert ref_noise.max() > BF16_LOGITS
    assert port_gap.max() <= 2 * ref_noise.max()
    assert 0.5 <= port_noise.max() / ref_noise.max() <= 2
    assert port_noise[0] <= 2 * ref_noise.max()
