"""repro_torch's training substrate against the reference on the CPU:
optimizer, gradient compression, data pipeline, checkpointing,
resilience and the trainer.

The counterparts of ``tests/test_substrate.py``, on the port, and beside
them the same functions of both packages on the same numpy inputs: AdamW
(the schedule, the global norm, clipping, one update at the default eps),
int8 compression bit for bit, the token and frame streams equal, the
checkpoint layout (files, manifest and bytes) equal and each side's
``restore`` reading the other's.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint import manager as rckpt
from repro.data import pipeline as rpipe
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
from repro.optim import compression as rcomp
from repro.optim import cosine_schedule as rcosine
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.pipeline import (DataConfig, MaskedFrameStream,
                                       Prefetcher, TokenStream)
from repro_torch.launch import train
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm)
from repro_torch.optim.compression import (compress, compressed_gradients,
                                           decompress)
from repro_torch.runtime.resilience import (StragglerMonitor,
                                            SupervisorConfig,
                                            TrainSupervisor)

SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(autouse=True, scope="module")
def _exp_initialised():
    """torch's CPU ``exp`` (2.13, AVX-512 build) now and then returns
    values about 1e-4 off on its first multi-threaded call in a process
    (7 of 64 fresh processes); one call on a single element first makes
    every later call accurate to float32 rounding."""
    torch.exp(torch.zeros(1))


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #

def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=200,
                      weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.1
    assert int(state["step"]) == 150 and state["step"].dtype == torch.int32


def test_adamw_state_is_float32_for_floating_leaves_only():
    params = {"w": torch.zeros(3, dtype=torch.bfloat16),
              "ids": torch.arange(3)}
    state = adamw_init(params)
    assert set(state["mu"]) == set(state["nu"]) == {"w"}
    assert state["mu"]["w"].dtype == torch.float32


def test_cosine_schedule_shape():
    cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lrs = [float(cosine_schedule(cfg, torch.tensor(s))) for s in range(101)]
    assert lrs[0] < lrs[9] <= cfg.peak_lr + 1e-9
    assert abs(lrs[10] - cfg.peak_lr) < 1e-9
    assert abs(lrs[100] - cfg.peak_lr * 0.1) < 1e-6


def test_cosine_schedule_equals_reference():
    cfg = dict(peak_lr=3e-4, warmup_steps=7, total_steps=50,
               min_lr_ratio=0.1)
    for s in range(60):
        got = float(cosine_schedule(AdamWConfig(**cfg),
                                    torch.tensor(s, dtype=torch.int32)))
        want = float(rcosine(RAdamWConfig(**cfg), jnp.asarray(s, jnp.int32)))
        assert abs(got - want) <= 1e-7 * want + 1e-12, s


def test_grad_clipping():
    cfg = AdamWConfig(clip_norm=1.0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    big = {"w": torch.full((4,), 1e6)}
    _, _, metrics = adamw_update(params, big, state, cfg)
    assert float(metrics["grad_norm"]) > 1e6   # reported pre-clip


def test_adamw_update_equals_reference_at_the_default_eps():
    """Three updates of both optimizers from the same parameters and
    gradients (some elements' gradients near eps, some zero, a leaf
    without a gradient): the same parameters, moments, lr and grad_norm
    within float32 rounding."""
    rng = np.random.default_rng(4)
    shapes = {"a": (5, 7), "b": (11,), "c": (3, 2, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = dict(warmup_steps=2, total_steps=10)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    rp = {k: jnp.asarray(v) for k, v in p0.items()}
    ts, rs = adamw_init(tp), radamw_init(rp)
    for step in range(3):
        g = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-9, 0, s))
             .astype(np.float32) for k, s in shapes.items()}
        g["b"][:3] = 0.0
        g["c"] = None if step == 1 else g["c"]
        tp, ts, tm = adamw_update(
            tp, {k: None if v is None else torch.from_numpy(v)
                 for k, v in g.items()}, ts, AdamWConfig(**cfg))
        rg = {k: jnp.zeros(shapes[k], jnp.float32) if v is None
              else jnp.asarray(v) for k, v in g.items()}
        rp, rs, rm = radamw_update(rp, rg, rs, RAdamWConfig(**cfg))
        for key in ("lr", "grad_norm"):
            assert abs(float(tm[key]) - float(rm[key])) <= \
                1e-6 * abs(float(rm[key]))
        for k in shapes:
            for got, want in ((tp[k], rp[k]), (ts["mu"][k], rs["mu"][k]),
                              (ts["nu"][k], rs["nu"][k])):
                want = np.asarray(want)
                assert np.abs(got.numpy() - want).max() <= \
                    1e-6 * np.abs(want).max(), (step, k)
    assert int(ts["step"]) == int(rs["step"]) == 3


def test_global_norm_skips_none_and_integer_leaves():
    tree = {"a": torch.tensor([3.0]), "b": None,
            "c": torch.tensor([4], dtype=torch.int32)}
    assert float(global_norm(tree)) == 3.0
    assert float(global_norm({})) == 0.0


# --------------------------------------------------------------------------- #
# gradient compression
# --------------------------------------------------------------------------- #

@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=20, deadline=None)
def test_compression_bounded_error(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=32).astype(np.float32))
    q, scale = compress(x)
    err = (decompress(q, scale) - x).abs().max()
    assert float(err) <= float(scale) / 2 + 1e-9
    assert q.dtype == torch.int8


def test_compression_equals_reference():
    rng = np.random.default_rng(8)
    x = (rng.normal(size=257) * 3).astype(np.float32)
    x[:5] = [0.0, 127.0, -127.0, 0.5, -0.5]
    q, scale = compress(torch.from_numpy(x))
    rq, rscale = rcomp.compress(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)
    assert np.array_equal(decompress(q, scale).numpy(),
                          np.asarray(rcomp.decompress(rq, rscale)))


def test_error_feedback_accumulates():
    """With error feedback, the sum of k quantized steps converges to the
    sum of the raw gradients (residual carries over)."""
    g = {"w": torch.full((8,), 0.3), "ids": torch.arange(2), "none": None}
    state = None
    total = torch.zeros(8)
    for _ in range(50):
        deq, state = compressed_gradients(g, state)
        total = total + deq["w"]
    np.testing.assert_allclose(total.numpy(), 0.3 * 50, rtol=0.05)
    assert deq["ids"] is g["ids"] and state["ids"] is None
    assert deq["none"] is None


# --------------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------------- #

def test_stream_deterministic_and_host_sharded():
    cfg = DataConfig(seed=3, global_batch=8, seq_len=32)
    s1 = TokenStream(cfg, vocab_size=100)
    s2 = TokenStream(cfg, vocab_size=100)
    np.testing.assert_array_equal(s1.batch(7), s2.batch(7))
    parts = []
    for host in range(4):
        c = dataclasses.replace(cfg, host_id=host, n_hosts=4)
        parts.append(TokenStream(c, 100).host_batch(7)["tokens"])
    np.testing.assert_array_equal(np.concatenate(parts), s1.batch(7))


def test_streams_equal_the_reference():
    cfg = dict(seed=5, global_batch=4, seq_len=40)
    tok = TokenStream(DataConfig(**cfg), 300).host_batch(3)
    rtok = rpipe.TokenStream(rpipe.DataConfig(**cfg), 300).host_batch(3)
    assert np.array_equal(tok["tokens"], rtok["tokens"])
    fr = MaskedFrameStream(DataConfig(**cfg), 16, 50).host_batch(2)
    rfr = rpipe.MaskedFrameStream(rpipe.DataConfig(**cfg), 16,
                                  50).host_batch(2)
    assert set(fr) == set(rfr)
    for k in fr:
        assert np.array_equal(fr[k], rfr[k]), k


def test_prefetcher_orders_batches():
    cfg = DataConfig(seed=1, global_batch=2, seq_len=8)
    stream = TokenStream(cfg, vocab_size=50)
    pf = Prefetcher(stream)
    steps = [next(pf)[0] for _ in range(5)]
    pf.close()
    assert steps == [0, 1, 2, 3, 4]


# --------------------------------------------------------------------------- #
# checkpointing
# --------------------------------------------------------------------------- #

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32), "d": None},
            "e": [torch.tensor(2.5, dtype=torch.bfloat16),
                  np.arange(3, dtype=np.int64)]}
    ckpt.save(tmp_path, 7, tree)
    assert ckpt.latest_step(tmp_path) == 7
    out = ckpt.restore(tmp_path, 7, tree)
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["d"] is None
    assert out["e"][0].dtype == torch.bfloat16 and float(out["e"][0]) == 2.5
    assert torch.equal(out["e"][1], torch.arange(3))
    manifest = json.loads((tmp_path / "step_7" / "manifest.json")
                          .read_text())
    assert manifest["e__0"] == {"dtype": "bfloat16", "shape": []}


def test_checkpoint_keep_last(tmp_path):
    tree = {"x": torch.zeros(2)}
    for step in (1, 2, 3, 4):
        ckpt.save(tmp_path, step, tree, keep_last=2)
    assert ckpt.available_steps(tmp_path) == [3, 4]


def test_async_checkpointer(tmp_path):
    ac = ckpt.AsyncCheckpointer(tmp_path, keep_last=2)
    ac.save(1, {"x": torch.ones(3)})
    ac.wait()
    out = ckpt.restore(tmp_path, 1, {"x": torch.zeros(3)})
    assert torch.equal(out["x"], torch.ones(3))


def test_async_snapshot_unchanged_by_an_update_right_after_save(tmp_path):
    """``save`` copies every leaf to the host before it returns: an
    in-place update made right after (the optimizer's) does not reach the
    checkpoint."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    n = np.arange(1 << 16, dtype=np.int32)
    want_w, want_n = w.clone(), n.copy()
    ac = ckpt.AsyncCheckpointer(tmp_path)
    ac.save(3, {"w": w, "n": n, "step": torch.tensor(3)})
    w.add_(1.0)
    n += 1
    ac.wait()
    out = ckpt.restore(tmp_path, 3, {"w": w, "n": n,
                                     "step": torch.tensor(0)})
    assert torch.equal(out["w"], want_w) and int(out["step"]) == 3
    assert np.array_equal(out["n"].numpy(), want_n)


def test_restore_onto_a_device(tmp_path):
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    ckpt.save(tmp_path, 0, tree)
    out = ckpt.restore(tmp_path, 0, tree, device="cpu")
    assert out["w"].device.type == "cpu"
    assert torch.equal(out["w"], tree["w"])


def _both_trees():
    rng = np.random.default_rng(2)
    arrays = {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                         "b": rng.normal(size=(5,)).astype(np.float32)},
              "opt": {"step": np.asarray(12, np.int32),
                      "ids": np.arange(6, dtype=np.int32).reshape(2, 3)}}
    port = {k: {kk: torch.from_numpy(v.copy()) for kk, v in sub.items()}
            for k, sub in arrays.items()}
    ref = {k: {kk: jnp.asarray(v) for kk, v in sub.items()}
           for k, sub in arrays.items()}
    return arrays, port, ref


def test_save_writes_the_reference_layout_byte_for_byte(tmp_path):
    _, port, ref = _both_trees()
    a = ckpt.save(tmp_path / "port", 5, port)
    b = rckpt.save(tmp_path / "ref", 5, ref)
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert "manifest.json" in names and "opt__step.npy" in names
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_each_side_restores_the_others_checkpoint(tmp_path):
    arrays, port, ref = _both_trees()
    ckpt.save(tmp_path / "port", 1, port)
    rckpt.save(tmp_path / "ref", 1, ref)
    got = ckpt.restore(tmp_path / "ref", 1, port)
    want = rckpt.restore(tmp_path / "port", 1, ref)
    for k, sub in arrays.items():
        for kk, v in sub.items():
            assert np.array_equal(got[k][kk].numpy(), v)
            assert np.array_equal(np.asarray(want[k][kk]), v)
            assert got[k][kk].dtype == port[k][kk].dtype


# --------------------------------------------------------------------------- #
# resilience
# --------------------------------------------------------------------------- #

def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor()
    for step in range(10):
        mon.record(step, 0.1)
    assert mon.record(10, 0.5, host_times={0: 0.1, 3: 0.5})
    assert mon.flagged[-1]["host"] == 3


def test_supervisor_recovers_from_failure(tmp_path):
    calls = {"n": 0, "failed": False}

    def step_fn(state, step):
        calls["n"] += 1
        if step == 7 and not calls["failed"]:
            calls["failed"] = True
            raise RuntimeError("injected")
        return dict(state, value=state["value"] + 1)

    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                         max_failures=2),
        step_fn,
        state_to_tree=lambda s: {"value": torch.tensor(float(s["value"]))},
        tree_to_state=lambda tree, s: dict(s, value=float(tree["value"])),
        device="cpu")
    final = sup.run({"value": 0.0}, 12)
    assert sup.failures == 1
    assert sup.restores == 1
    # ckpt after steps 2 and 5; failure at 7 -> restore value 6, resume at 6
    assert final["value"] == 12.0


def test_supervisor_gives_up_after_max_failures(tmp_path):
    def step_fn(state, step):
        if step > 0:
            raise RuntimeError("always broken")
        return dict(state, value=state["value"] + 1)

    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=1,
                         max_failures=2),
        step_fn,
        state_to_tree=lambda s: {"value": torch.tensor(float(s["value"]))},
        tree_to_state=lambda tree, s: dict(s, value=float(tree["value"])),
        device="cpu")
    with pytest.raises(RuntimeError, match="always broken"):
        sup.run({"value": 0.0}, 5)
    # restored from step 0's checkpoint after each of the first two
    assert (sup.failures, sup.restores) == (3, 2)


def test_supervisor_raises_a_failure_before_the_first_checkpoint(
        tmp_path, monkeypatch):
    """The step updates the state in place: a failure partway through
    AdamW's update, with no checkpoint yet, leaves no valid state to go
    on from, and the supervisor raises it rather than restart there."""
    from repro_torch.models import lm
    cfg, model, opt, stream, step_fn = train.build(
        "qwen3-0.6b", reduced=True, batch=2, seq=16, steps=6, device="cpu")

    def torn(params, grads, state, cfg):
        first = next(iter(state["mu"]))
        adamw_update(params, grads,
                     dict(state, mu={first: state["mu"][first]}), cfg)
        raise RuntimeError("out of memory")

    def one_step(state, step):
        if step == 1:
            monkeypatch.setattr(lm, "adamw_update", torn)
        m, o, met = step_fn(state.model, state.opt_state,
                            train.to_device(stream.host_batch(step), "cpu"))
        return train.TrainState(m, o, {k: float(v) for k, v in met.items()})

    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=3), one_step,
        train.state_tree, train.load_state, device="cpu")
    with pytest.raises(RuntimeError, match="before the first checkpoint") \
            as info:
        sup.run(train.TrainState(model, opt, {}), 6)
    assert "out of memory" in str(info.value.__cause__)
    assert (sup.failures, sup.restores) == (1, 0)
    assert ckpt.available_steps(tmp_path) == []


# --------------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------------- #

def test_build_refuses_a_mesh_and_a_missing_card():
    """A mesh needs a process group the caller has initialised
    (``tests/test_torch_moe_ep_train.py`` trains inside one)."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        train.build("qwen3-0.6b", reduced=True, batch=2, seq=8, steps=1,
                    data_parallel=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.build("qwen3-0.6b", reduced=True, batch=2, seq=8,
                        steps=1)


def test_supervised_training_restores_the_checkpoint_exactly(tmp_path):
    """The trainer's state through an async checkpoint and a failure: the
    supervisor puts back, bit for bit, the model and AdamW state saved at
    the last checkpoint, and the run goes on to its end."""
    cfg, model, opt, stream, step_fn = train.build(
        "qwen3-0.6b", reduced=True, batch=2, seq=16, steps=6,
        use_flash=True, device="cpu")
    failed, after_restore = [], []

    def one_step(state, step):
        if step == 4 and not failed:
            failed.append(step)
            raise RuntimeError("injected")
        m, o, met = step_fn(state.model, state.opt_state,
                            train.to_device(stream.host_batch(step), "cpu"))
        return train.TrainState(m, o, {k: float(v) for k, v in met.items()})

    def load(tree, state):
        state = train.load_state(tree, state)
        after_restore.append({k: v.clone() for k, v in ckpt._flatten(
            train.state_tree(state)).items()})
        return state

    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=3), one_step,
        train.state_tree, load, device="cpu")
    state = sup.run(train.TrainState(model, opt, {}), 6)
    assert sup.failures == sup.restores == 1
    # saved after step 2, restored at the failure of step 4, steps 3 to 5
    # run again: six optimizer steps in all
    assert ckpt.available_steps(tmp_path) == [2, 5]
    assert int(state.opt_state["step"]) == 6
    disk = ckpt._flatten(ckpt.restore(tmp_path, 2, train.state_tree(state)))
    (back,) = after_restore
    assert set(back) == set(disk) and int(back["opt__step"]) == 3
    for key in disk:
        assert back[key].dtype == disk[key].dtype, key
        assert torch.equal(back[key], disk[key]), key


def test_train_cli_on_cpu_recovers_and_learns(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-360m", "--reduced", "--steps", "30", "--batch", "4",
         "--seq", "32", "--ckpt-every", "10", "--inject-failure-at", "15",
         "--ckpt-dir", str(tmp_path), "--device", "cpu", "--log-every",
         "10"], env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert "failures=1 restores=1" in last and "device=cpu" in last
    first, final = (float(x) for x in
                    last.split("loss ")[1].split(" |")[0].split(" -> "))
    assert final < first
