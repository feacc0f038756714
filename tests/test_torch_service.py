"""The port's main path as a whole: the ``KGService`` loop on an AWAPart
layout, held against the reference.

The reference's traced drain loop (bootstrap, one window of the extended
workload, an explicit adaptation round, then windows served while the
migration drains) runs on ``repro`` with ``executor="numpy"`` and on
``repro_torch`` with ``device="cpu"`` over the same LUBM(1) dataset, carried
across by ``repro_torch.interop``. Every window's bindings and COMPARABLE
stats, the adaptation report, the final layout and the trace must be
identical.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import canon_bindings
from repro.api import KGService as RefService
from repro.query.exec import ExecStats
from repro_torch import interop
from repro_torch.api import KGService

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


def _port_dataset(ds):
    terms = [ds.dictionary.decode(i) for i in range(len(ds.dictionary))]
    return interop.lubm_dataset(
        ds.store.triples, terms, dataclasses.asdict(ds.named),
        [(q.name, q.patterns, q.frequency, q.shape)
         for q in ds.queries.values()], ds.n_universities)


def _traced_drain(service_cls, ds, **kwargs):
    svc = service_cls.from_dataset(ds, n_shards=4, migration_budget=120_000,
                                   trace=True, **kwargs)
    svc.bootstrap(ds.base_workload())
    window = ds.extended_workload()
    windows = [svc.query_batch(window)]
    report = svc.adapt(ds.workload([f"EQ{i}" for i in range(1, 11)]))
    assert report.accepted and svc.session is not None
    while svc.session is not None:       # drain while serving, traced
        windows.append(svc.query_batch(window))
    return svc, windows, report


@pytest.fixture(scope="module")
def both_loops(small_lubm):
    ref = _traced_drain(RefService, small_lubm, executor="numpy")
    port = _traced_drain(KGService, _port_dataset(small_lubm), device="cpu")
    return ref, port


def test_interop_dataset_equals_port_generator():
    from repro.graph import lubm as ref_lubm
    from repro_torch.graph import lubm
    # a freshly generated reference dataset: the memoized one that
    # ``small_lubm`` shares across the process may already carry triples
    # that write-path tests inserted
    carried = _port_dataset(ref_lubm.generate(1, 0))
    own = lubm.load(1, seed=0)
    np.testing.assert_array_equal(carried.store.triples, own.store.triples)
    assert carried.queries == own.queries
    assert carried.named == own.named


def test_windows_match_reference(both_loops):
    (_, ref_windows, _), (_, windows, _) = both_loops
    assert len(windows) == len(ref_windows) >= 4
    for w, (ref_res, res) in enumerate(zip(ref_windows, windows)):
        assert len(res) == len(ref_res)
        for i, ((rb, rs), (b, s)) in enumerate(zip(ref_res, res)):
            assert canon_bindings(b) == canon_bindings(rb), (w, i)
            for f in ExecStats.COMPARABLE:
                assert getattr(s, f) == getattr(rs, f), (w, i, f)


def test_adapt_report_and_final_layout_match_reference(both_loops):
    (ref_svc, _, ref_rep), (svc, _, rep) = both_loops
    assert (rep.accepted, rep.reason) == (ref_rep.accepted, ref_rep.reason)
    assert rep.plan.moves == ref_rep.plan.moves
    assert rep.plan.bytes == ref_rep.plan.bytes
    assert rep.chosen_cut == ref_rep.chosen_cut
    assert rep.n_clusters == ref_rep.n_clusters
    assert (rep.t_base, rep.t_new) == (ref_rep.t_base, ref_rep.t_new)
    np.testing.assert_array_equal(svc.kg.state.feature_to_shard,
                                  ref_svc.kg.state.feature_to_shard)
    assert svc.space.feature_keys() == ref_svc.space.feature_keys()


def test_trace_byte_identical_to_reference(both_loops):
    (ref_svc, _, _), (svc, _, _) = both_loops
    assert svc.tracer().to_json() == ref_svc.tracer().to_json()
    assert svc.tracer().to_jsonl() == ref_svc.tracer().to_jsonl()


def test_dispatch_counters_name_the_cpu_tier(both_loops):
    _, (svc, _, _) = both_loops
    counters = svc.stats()["metrics"]["counters"]
    assert counters["kernels.dispatch.jaccard.distance.torch"] > 0
    assert counters["kernels.dispatch.join.pipeline.torch"] > 0
    assert not any(k.endswith(".cuda") for k in counters)


def test_service_device_reaches_a_caller_owned_partitioner(small_lubm):
    from repro_torch.api import AWAPartitioner
    ds = _port_dataset(small_lubm)
    part = AWAPartitioner()
    svc = KGService.from_dataset(ds, n_shards=4, partitioner=part,
                                 device="cpu")
    svc.bootstrap(ds.base_workload())
    assert part.controller.device == torch.device("cpu")
    assert not hasattr(part, "device")      # the strategy keeps no device


_LOOP = """
import json, sys
import repro_torch
from repro_torch.api import KGService
from repro_torch.graph import lubm
ds = lubm.load(1, seed=0)
svc = KGService.from_dataset(ds, n_shards=4, migration_budget=120_000,
                             trace=True, device="cpu")
svc.bootstrap(ds.base_workload())
window = ds.extended_workload()
svc.query_batch(window)
rep = svc.adapt(ds.workload([f"EQ{i}" for i in range(1, 11)]))
svc.drain()
svc.query_batch(window)
import dataclasses
import numpy as np
from repro_torch import configs
from repro_torch.models import lm
cfg = dataclasses.replace(configs.get("qwen3-0.6b").reduced(), use_flash=True)
model = lm.init_params(cfg, device="cpu")
batch = lm.make_batch(cfg, "prefill_32k", np.random.default_rng(0), 2,
                      device="cpu")
batch["tokens"] = batch["tokens"][:, :12]
logits, caches = lm.prefill_step(model, batch, cfg)
big = lm.transformer.init_decode_caches(cfg, 2, 14, device="cpu")
for key in "kv":
    big[key][:, :, :12] = caches[key]
for pos in (12, 13):
    logits, big = lm.decode_step(
        model, big, {"token": logits.argmax(-1), "pos": pos}, cfg)
rcfg = configs.get("rwkv6-3b").reduced()
rmodel = lm.init_params(rcfg, device="cpu")
rlogits, state = lm.prefill_step(rmodel, {"tokens": batch["tokens"]}, rcfg)
for pos in (12, 13):
    rlogits, state = lm.decode_step(
        rmodel, state, {"token": rlogits.argmax(-1), "pos": pos}, rcfg)
zcfg = configs.get("zamba2-7b").reduced()
zmodel = lm.init_params(zcfg, device="cpu")
zlogits, zc = lm.prefill_step(zmodel, {"tokens": batch["tokens"][:, :8]},
                              zcfg)
zbig = lm.transformer.init_decode_caches(zcfg, 2, 10, device="cpu")
for key in zbig:
    if key in "kv":
        zbig[key][:, :, :8] = zc[key]
    else:
        zbig[key].copy_(zc[key])
for pos in (8, 9):
    zlogits, zbig = lm.decode_step(
        zmodel, zbig, {"token": zlogits.argmax(-1), "pos": pos}, zcfg)
from repro_torch import scenario
from repro_torch.core import hac
from repro_torch.graph import watdiv
from repro_torch.launch import serve
from repro_torch.query import engine, rewrite
wds = watdiv.load(1, seed=0)
one = scenario.DriftScenario("one", (scenario.Phase(
    "p", 1, tuple((n, 1.0) for n in sorted(wds.queries))),),
    queries_per_window=4)
wsvc = KGService.from_dataset(wds, n_shards=4, device="cpu")
wsvc.bootstrap(one.bootstrap_workload(wds))
wrep = scenario.run_scenario(wsvc, one, wds, adapt=True)
sds, ssvc = serve.build_system(1, 4, device="cpu")
exp2 = serve.experiment2(sds, ssvc, verbose=False)
fed = rewrite.federated_sparql(sds.queries["Q9"], ssvc.space, ssvc.kg.state)
z = hac.hac_torch(np.eye(3, dtype=np.float32), device="cpu")
from repro_torch.launch import train
tcfg, tmodel, topt, tstream, tstep = train.build(
    "qwen3-0.6b", reduced=True, batch=2, seq=16, steps=2, use_flash=True,
    device="cpu")
tmodel, topt, tmet = tstep(tmodel, topt, train.to_device(
    tstream.host_batch(0), "cpu"))
trained = int(topt["step"]) == 1 and bool(np.isfinite(float(tmet["loss"])))
for arch in ("rwkv6-3b", "zamba2-7b"):
    acfg, amodel, aopt, astream, astep = train.build(
        arch, reduced=True, batch=2, seq=16, steps=2, device="cpu")
    amodel, aopt, amet = astep(amodel, aopt, train.to_device(
        astream.host_batch(0), "cpu"))
    trained = trained and int(aopt["step"]) == 1 and bool(
        np.isfinite(float(amet["loss"])))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"accepted": rep.accepted, "bad": bad,
                  "windows": len(wrep.windows),
                  "exp2": exp2["t_adaptive"] > 0, "fed": "SELECT" in fed,
                  "z": list(z.shape),
                  "trained": trained,
                  "logits": list(logits.shape),
                  "rwkv_logits": list(rlogits.shape),
                  "zamba_logits": list(zlogits.shape)}))
"""


def test_port_loop_loads_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _LOOP], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"accepted": True, "bad": [], "logits": [2, 128],
                   "rwkv_logits": [2, 128], "zamba_logits": [2, 128],
                   "windows": 1, "exp2": True, "fed": True, "z": [2, 4],
                   "trained": True}


def test_default_device_is_the_card(small_lubm):
    ds = _port_dataset(small_lubm)
    if torch.cuda.is_available():
        svc = KGService.from_dataset(ds, n_shards=4)
        assert svc.device.type == "cuda"
        assert svc.executor.name == "torch"
        assert svc.executor.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            KGService.from_dataset(ds, n_shards=4)
