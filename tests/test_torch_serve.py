"""repro_torch.launch.serve — the paper's two experiments, the streaming
demo and the CLI — against the reference's ``repro.launch.serve``.

At LUBM(1) on 4 shards, atomic and with a 64 KiB migration budget and 16
synthetic writes ahead of every drain window, ``experiment1`` and
``experiment2`` run on the port (``device="cpu"``) with the torch and the
numpy executors and on the reference with ``executor="numpy"``. Every
per-query modeled time must be equal exactly (the modeled clock is a
function of the COMPARABLE stats), and so must the accept decision, the
migration plan's summary and the final layout. Every run builds its
dataset fresh (``lubm.generate`` in place of ``build_system``'s
``lubm.load``): ``lubm.load`` memoizes the dataset and writes mutate its
store in place, in this module or in any test module run before it in the
same process.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import canon_bindings
from repro.graph import lubm as ref_lubm
from repro.launch import serve as ref_serve
from repro_torch.graph import lubm
from repro_torch.launch import serve

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
BUDGET = 64 << 10
MODES = {"atomic": dict(budget=None, writes=0),
         "budget": dict(budget=BUDGET, writes=16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the CPU tier's ops are
    small, and test workers running side by side would otherwise each
    spin a thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(mod, lubm_mod, monkeypatch, **kw):
    """``mod.build_system(1, 4, ...)`` over a freshly generated LUBM(1)."""
    monkeypatch.setattr(lubm_mod, "load", lubm_mod.generate)
    out = mod.build_system(1, 4, **kw)
    monkeypatch.undo()
    return out


def _run(mod, lubm_mod, monkeypatch, exp, mode, **kw):
    cfg = MODES[mode]
    ds, svc = _build(mod, lubm_mod, monkeypatch,
                     migration_budget=cfg["budget"], **kw)
    if exp == 1:
        out = mod.experiment1(ds, svc, verbose=False,
                              writes_per_window=cfg["writes"])
    else:
        out = mod.experiment2(ds, svc, verbose=False,
                              writes_per_window=cfg["writes"])
    return out, svc


@pytest.fixture(scope="module")
def reference():
    return {}


def _reference(cache, exp, mode):
    if (exp, mode) not in cache:
        with pytest.MonkeyPatch.context() as mp:
            cache[exp, mode] = _run(ref_serve, ref_lubm, mp, exp, mode,
                                    executor="numpy")
    return cache[exp, mode]


def _same_layout(out, want):
    np.testing.assert_array_equal(out["state"].feature_to_shard,
                                  want["state"].feature_to_shard)
    assert out["kg"].shard_sizes() == want["kg"].shard_sizes()


@pytest.mark.parametrize("executor", ["torch", "numpy"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_experiment1_equals_reference(reference, monkeypatch, executor,
                                      mode):
    want, ref_svc = _reference(reference, 1, mode)
    out, svc = _run(serve, lubm, monkeypatch, 1, mode, executor=executor,
                    device="cpu")
    assert svc.executor.name == executor and svc.device.type == "cpu"
    assert out["initial"] == want["initial"]
    assert out["adaptive"] == want["adaptive"]
    assert len(out["initial"]) == 24
    for phase in ("stats_initial", "stats_adaptive"):
        for name, st in want[phase].items():
            assert out[phase][name].rows == st.rows, (phase, name)
    assert out["report"].accepted == want["report"].accepted is True
    assert out["report"].plan.summary() == want["report"].plan.summary()
    _same_layout(out, want)
    assert svc.write_log.n_inserted == ref_svc.write_log.n_inserted
    if mode == "budget":
        assert svc.write_log.n_inserted > 0 and svc.kg.epoch > 2


@pytest.mark.parametrize("executor", ["torch", "numpy"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_experiment2_equals_reference(reference, monkeypatch, executor,
                                      mode):
    want, ref_svc = _reference(reference, 2, mode)
    out, svc = _run(serve, lubm, monkeypatch, 2, mode, executor=executor,
                    device="cpu")
    assert out["t_initial"] == want["t_initial"]
    assert out["t_adaptive"] == want["t_adaptive"]
    assert out["report"].accepted == want["report"].accepted
    assert out["report"].plan.summary() == want["report"].plan.summary()
    _same_layout(out, want)
    assert svc.write_log.n_inserted == ref_svc.write_log.n_inserted


def test_static_strategy_has_no_round(monkeypatch):
    ds, svc = _build(serve, lubm, monkeypatch, partitioner="hash",
                     device="cpu")
    rds, rsvc = _build(ref_serve, ref_lubm, monkeypatch, partitioner="hash")
    out = serve.experiment1(ds, svc, verbose=False)
    want = ref_serve.experiment1(rds, rsvc, verbose=False)
    assert out["report"] is None and out["initial"] == want["initial"]
    assert out["adaptive"] is out["initial"]


def test_stream_demo_equals_reference(monkeypatch):
    kw = dict(migration_budget=120_000)
    ds, svc = _build(serve, lubm, monkeypatch, device="cpu", **kw)
    rds, rsvc = _build(ref_serve, ref_lubm, monkeypatch, executor="numpy",
                       **kw)
    out = serve.stream_demo(ds, svc, 300.0, writes_per_window=48,
                            verbose=False)
    want = ref_serve.stream_demo(rds, rsvc, 300.0, writes_per_window=48,
                                 verbose=False)
    assert out["report"].accepted == want["report"].accepted is True
    assert len(out["results"]) == len(want["results"]) == 96
    for r, w in zip(out["results"], want["results"]):
        assert (r.seq, r.query.name) == (w.seq, w.query.name)
        assert canon_bindings(r.bindings) == canon_bindings(w.bindings)
        assert r.stats.modeled_time() == w.stats.modeled_time()
        assert dataclasses.astuple(r.latency) == dataclasses.astuple(w.latency)
    assert out["stats"]["rows_inserted"] == want["stats"]["rows_inserted"]
    assert out["stats"]["latency"] == want["stats"]["latency"]
    assert out["stream"].n_windows == want["stream"].n_windows
    _same_layout(out, want)


def test_build_system_takes_the_card_unless_told():
    if torch.cuda.is_available():
        _, svc = serve.build_system(1, 4)
        assert svc.device.type == "cuda" and svc.executor.name == "torch"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.build_system(1, 4)


def _cli(*args, module="repro_torch.launch.serve"):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", module,
                           "--universities", "1", "--shards", "4", *args],
                          env=env, capture_output=True, text=True,
                          timeout=600)


def _lines(out, tag):
    return [ln for ln in out.splitlines() if ln.startswith(tag)]


def test_cli_on_the_cpu_matches_reference(tmp_path):
    trace, csv = tmp_path / "trace.json", tmp_path / "metrics.csv"
    got = _cli("--experiment", "1", "--device", "cpu", "--show-federated",
               "--trace", str(trace), "--metrics-csv", str(csv))
    assert got.returncode == 0, got.stderr
    want = _cli("--experiment", "1", "--show-federated",
                module="repro.launch.serve")
    assert want.returncode == 0, want.stderr
    assert "executor=torch, device=cpu" in got.stdout
    assert _lines(got.stdout, "[exp1]") == _lines(want.stdout, "[exp1]")
    assert len(_lines(got.stdout, "[exp1]")) == 4
    fed = got.stdout.split("Federated rewrite of Q9")[1].split("[obs]")[0]
    assert fed == want.stdout.split("Federated rewrite of Q9")[1]
    assert trace.stat().st_size > 0 and csv.stat().st_size > 0


def test_cli_experiment2_and_stream_on_the_cpu():
    got = _cli("--experiment", "2", "--device", "cpu", "--executor",
               "numpy", "--migration-budget", "65536")
    assert got.returncode == 0, got.stderr
    assert len(_lines(got.stdout, "[exp2]")) == 1
    got = _cli("--stream", "--device", "cpu", "--arrival-rate", "300",
               "--migration-budget", "120000", "--writes-per-window", "48")
    assert got.returncode == 0, got.stderr
    assert "chunks drained mid-stream" in got.stdout


def test_cli_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there")
    got = _cli("--experiment", "2")
    assert got.returncode != 0
    assert "CUDA is not available" in got.stderr
