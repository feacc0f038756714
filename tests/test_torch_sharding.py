"""repro_torch's mesh axes and sharding rule table against the reference.

``launch.sharding.spec_for`` resolves every leaf of ``lm.param_axes(cfg)``
of all ten configs to the reference's ``PartitionSpec`` contents, on the
production meshes (16 x 16, 2 x 16 x 16) and a (2, 4) host mesh, in both
profiles; the reference is handed an object with ``axis_names`` and
``devices.shape``, so no device is needed. ``lm.param_axes`` is the
reference's axes tree (from ``transformer.init_params`` under
``jax.eval_shape``) by path; ``cache_axes``, ``tree_specs``,
``batch_specs`` and ``opt_state_specs`` equal the reference's;
``to_placements`` gives DTensor placements; importing the two modules
loads neither jax nor the reference.
"""
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec
from torch.distributed.tensor import Replicate, Shard

import repro.configs as rconfigs
from repro.launch import sharding as rsharding
from repro.models import lm as rlm
from repro.models import transformer as rtr
from repro.optim import adamw_init as radamw_init
import repro_torch.configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCHS = list(tconfigs.ARCH_IDS)
MESHES = {"16x16": tmesh.production_shape(),
          "2x16x16": tmesh.production_shape(multi_pod=True),
          "2x4": tmesh.host_shape(2, 4)}
PROFILES = ["fsdp_tp", "dp"]


def _ref_mesh(sizes):
    """What the reference's resolution reads of a mesh."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


def _path(path):
    return "/".join(p.key for p in path)


def _ref_axes(cfg):
    """The reference's axes tree of ``cfg`` by path (traced abstractly)."""
    box = {}

    def init(key):
        params, box["axes"] = rtr.init_params(key, cfg)
        return params
    jax.eval_shape(init, jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_flatten_with_path(
        box["axes"], is_leaf=lambda x: isinstance(x, tuple))[0]
    return {_path(p): a for p, a in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_are_the_reference_tree(arch):
    cfg = rconfigs.get(arch).reduced()
    assert tlm.param_axes(tconfigs.get(arch).reduced()) == _ref_axes(cfg)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_every_leaf_equals_the_reference(arch, mesh, profile):
    cfg = tconfigs.get(arch)
    sizes, rmesh = MESHES[mesh], _ref_mesh(MESHES[mesh])
    shapes, axes = tlm.param_shapes(cfg), tlm.param_axes(cfg)
    sharded = 0
    for path, shape in shapes.items():
        got = tsharding.spec_for(axes[path], shape, sizes, profile=profile)
        want = rsharding.spec_for(axes[path], shape, rmesh, profile=profile)
        assert got == tuple(want), (path, got, want)
        sharded += any(got)
    assert sharded                      # the meshes split something
    # trees: params replicate under the dp profile, as the reference's
    got = tsharding.tree_specs(axes, shapes, sizes, profile=profile,
                               kind="param")
    assert all(s == () for s in got.values()) == (profile == "dp")


def test_expert_leaves_split_their_slots_over_model():
    cfg = tconfigs.get("olmoe-1b-7b")
    for path in tlm.MOE_EXPERT_LEAVES:
        spec = tsharding.spec_for(tlm.param_axes(cfg)[path],
                                  tlm.param_shapes(cfg)[path],
                                  tmesh.host_shape(1, 4))
        assert spec == (None, "model")          # (layers, experts, ...)
    # the slots each rank holds (``moe.expert_slice``) are the rule table's
    # even split of the experts over "model"
    slots = np.arange(cfg.n_experts)
    for r, block in enumerate(np.split(slots, 4)):
        mesh = types.SimpleNamespace(
            shape=(1, 4), mesh_dim_names=("data", "model"),
            get_local_rank=lambda axis, r=r: r if axis == "model" else 0)
        ctx = tmoe.ShardCtx(mesh, ("data",))
        assert np.array_equal(slots[tmoe.expert_slice(cfg, ctx)], block)
    assert np.array_equal(slots[tmoe.expert_slice(cfg)], slots)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_equal_the_reference(arch):
    assert tsharding.cache_axes(tconfigs.get(arch)) == \
        rsharding.cache_axes(rconfigs.get(arch))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-0.6b", "rwkv6-3b",
                                  "zamba2-7b", "hubert-xlarge"])
def test_batch_and_opt_state_specs_equal_the_reference(arch, mesh,
                                                       monkeypatch):
    # no device: the reference's NamedSharding stands in as its spec
    monkeypatch.setattr(rsharding, "NamedSharding",
                        lambda _, spec: types.SimpleNamespace(spec=spec))
    rcfg = rconfigs.get(arch).reduced()
    tcfg = tconfigs.get(arch).reduced()
    sizes, rmesh = MESHES[mesh], _ref_mesh(MESHES[mesh])
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        for b in (1, 32):
            specs = rlm.input_specs(rcfg, shape_name, b)
            want = rsharding.batch_specs(specs, rmesh)
            got = tsharding.batch_specs(
                tlm.input_specs(tcfg, shape_name, b), sizes)
            assert set(got) == set(want)
            for key in got:
                assert got[key] == tuple(want[key].spec), (key, got, want)
    shapes = jax.eval_shape(lambda: rtr.init_params(
        jax.random.PRNGKey(0), rcfg)[0])
    opt = jax.eval_shape(radamw_init, shapes)
    axes = _ref_axes(rcfg)
    want = rsharding.opt_state_shardings(
        _nested(shapes, axes), shapes, opt, rmesh)
    flat = {_path(p): tuple(s.shape)
            for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    moments = {key: {_path(p): (None if m is None else tuple(m.shape))
                     for p, m in jax.tree_util.tree_flatten_with_path(
                         opt[key], is_leaf=lambda x: x is None)[0]}
               for key in ("mu", "nu")}
    got = tsharding.opt_state_specs(tlm.param_axes(tcfg), flat, moments,
                                    sizes)
    assert got["step"] == tuple(want["step"].spec)
    for key in ("mu", "nu"):
        ref = {_path(p): tuple(s.spec) for p, s in
               jax.tree_util.tree_flatten_with_path(want[key])[0]}
        assert got[key] == ref


def _nested(shapes, axes):
    """``axes`` (by path) in the tree structure of ``shapes``."""
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(shapes),
        [axes[_path(p)] for p, _ in
         jax.tree_util.tree_flatten_with_path(shapes)[0]])


def test_to_placements():
    sizes = tmesh.production_shape(multi_pod=True)
    assert tsharding.to_placements(("data", None, "model"),
                                   tmesh.host_shape(2, 4)) == (
        Shard(0), Shard(2))
    assert tsharding.to_placements((("pod", "data"), "model"), sizes) == (
        Shard(0), Shard(0), Shard(1))
    assert tsharding.to_placements((), sizes) == (Replicate(),) * 3
    assert tsharding.to_placements((None, "model"), sizes) == (
        Replicate(), Replicate(), Shard(1))


def test_spec_tuple_is_the_partition_spec_contents():
    spec = rsharding.spec_for(("batch", "cache_time", None), (4, 64, 8),
                              _ref_mesh(MESHES["2x16x16"]))
    assert isinstance(spec, PartitionSpec)
    assert tsharding.spec_for(("batch", "cache_time", None), (4, 64, 8),
                              MESHES["2x16x16"]) == tuple(spec)


_IMPORTS = """
import json, sys
import repro_torch.launch.mesh, repro_torch.launch.sharding
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))))
"""


def test_importing_mesh_and_sharding_loads_neither_jax_nor_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORTS],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []
