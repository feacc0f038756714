"""Logical-axis -> partition resolution (MaxText-style rule table).

Counterpart of ``repro/launch/sharding.py``. Every parameter / activation /
cache dimension carries a logical axis name (``models.lm.param_axes``,
:func:`cache_axes`); rules map each name to an ordered list of mesh-axis
candidates. Resolution is greedy left-to-right per tensor with two
constraints:
  * divisibility -- a mesh axis is only used if it divides the dim size,
  * exclusivity -- each mesh axis is used at most once per tensor.
Non-divisible axes degrade to replication (8 kv heads never shard on a
16-way model axis), and long decode caches shard their time dim over the
otherwise-idle ``data`` axis when batch==1.

A spec is the reference's ``PartitionSpec`` contents as a plain tuple: one
entry per leading dimension, each a mesh axis name, a tuple of names (a
joint shard, major first) or None, trailing Nones dropped. A mesh is a
``DeviceMesh`` or a mapping of axis name -> size in the mesh's order
(``launch.mesh.production_shape``), so specs resolve without a process
group. :func:`to_placements` turns a spec into ``DTensor`` placements.
Trees are flat dicts keyed by leaf path, as ``models.lm.param_shapes``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

Spec = Tuple[Any, ...]

# ordered candidates per logical axis; tuples are joint (multi-axis) shards
PRIORITIES: Dict[str, List[Tuple[str, ...]]] = {
    "batch": [("pod", "data"), ("data",), ("pod",)],
    "cache_time": [("pod", "data"), ("data",), ("pod",)],
    # dp profile (small models): batch spreads over the model axis too
    "batch_dp": [("pod", "data", "model"), ("data", "model"),
                 ("pod", "data"), ("data",)],
    "vocab": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    # head_dim deliberately has NO candidates: sharding the attention
    # contraction dim forces replicated compute and reshards
    "head_dim": [],
    "experts": [("model",)],
    "ff": [("model",)],
    "embed": [("pod", "data"), ("data",)],     # FSDP axis for params
    "embed2": [("model",)],
    "heads_x_dim": [("model",)],
    "state": [],
    "layers": [],
    "shared_apps": [],
}


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis: size} in the mesh's order, of a ``DeviceMesh`` or a
    mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def spec_for(axes: Optional[Tuple[Optional[str], ...]],
             shape: Sequence[int], mesh, *, profile: str = "fsdp_tp"
             ) -> Spec:
    """Resolve one tensor's logical axes tuple to a spec.

    Profiles:
      * ``fsdp_tp`` (large models): params FSDP over data + TP over model.
      * ``dp`` (<= ~1.5B params): pure data parallelism -- batch spreads
        over BOTH mesh axes, parameters replicate, optimizer moments stay
        sharded (ZeRO-1).
    Tensors already sharded on ``model`` through their experts or vocab
    dimension stay out of FSDP: their ``embed`` dimension is not split.
    """
    if axes is None:
        return ()
    sizes = mesh_sizes(mesh)
    used: set = set()
    parts: List[Any] = []
    has_experts = ("experts" in axes) or ("vocab" in axes)
    for dim, name in enumerate(axes):
        assignment = None
        lookup = name
        if profile == "dp" and name in ("batch", "cache_time"):
            lookup = "batch_dp"
        if has_experts and name == "embed":
            name = None
        if name is not None:
            for cand in PRIORITIES.get(lookup, []):
                if any(a in used or a not in sizes for a in cand):
                    continue
                total = 1
                for a in cand:
                    total *= sizes[a]
                if shape[dim] % total == 0 and shape[dim] > 0:
                    assignment = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
        parts.append(assignment)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def to_placements(spec: Spec, mesh) -> tuple:
    """A spec as ``DTensor`` placements, one per mesh axis in the mesh's
    order: ``Shard(dim)`` where the axis splits tensor dimension ``dim``
    (a joint entry shards its dimension on each of its axes, major
    first, as the mesh orders them), else ``Replicate()``."""
    out = []
    for axis in mesh_sizes(mesh):
        dims = [d for d, entry in enumerate(spec)
                if entry == axis or (isinstance(entry, tuple)
                                     and axis in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def tree_specs(axes_tree: Mapping[str, Any], shape_tree: Mapping[str, Any],
               mesh, *, profile: str = "fsdp_tp", kind: str = "cache"
               ) -> Dict[str, Spec]:
    """The spec of every leaf of a flat tree: ``axes_tree`` maps each path
    to its logical axes (or None), ``shape_tree`` to its shape (or a
    tensor). ``kind="param"`` with the ``dp`` profile replicates
    everything (pure data parallelism)."""
    if set(axes_tree) != set(shape_tree):
        raise ValueError("the axes and shape trees have different leaves")
    if profile == "dp" and kind == "param":
        return {path: () for path in axes_tree}
    return {path: spec_for(axes_tree[path], _shape(shape_tree[path]), mesh,
                           profile=profile)
            for path in axes_tree}


def _shape(leaf) -> tuple:
    return tuple(leaf.shape if hasattr(leaf, "shape") else leaf)


def batch_specs(batch: Mapping[str, Any], mesh, *,
                profile: str = "fsdp_tp") -> Dict[str, Spec]:
    """Input batch specs: the leading dim is the batch, everything else
    replicated; scalars (a decode step's ``pos``) replicated."""
    out = {}
    for key, leaf in batch.items():
        shape = tuple(getattr(leaf, "shape", ()))     # an int pos: ()
        out[key] = (spec_for(("batch",) + (None,) * (len(shape) - 1), shape,
                             mesh, profile=profile) if shape else ())
    return out


def cache_axes(cfg) -> Dict[str, Tuple]:
    """Logical axes for decode caches (``transformer.init_decode_caches``)."""
    if cfg.rwkv:
        return dict(
            tm_shift=("layers", "batch", "embed2"),
            cm_shift=("layers", "batch", "embed2"),
            wkv=("layers", "batch", "heads", None, None))
    if cfg.family in ("ssm", "hybrid"):
        axes = dict(
            conv=("layers", "batch", None, "ff"),
            ssm=("layers", "batch", "heads", "state", None))
        if cfg.attn_every:
            axes["k"] = ("shared_apps", "batch", "cache_time", "kv_heads",
                         "head_dim")
            axes["v"] = axes["k"]
        return axes
    kv = ("layers", "batch", "cache_time", "kv_heads", "head_dim")
    return {"k": kv, "v": kv}


def opt_state_specs(axes_tree: Mapping[str, Any],
                    param_shapes: Mapping[str, Any],
                    opt_state_shapes: Mapping[str, Any], mesh
                    ) -> Dict[str, Any]:
    """Adam moments are ALWAYS FSDP-sharded (ZeRO-1 when params
    replicate): each moment takes its parameter's ``fsdp_tp`` spec; a
    moment that is None (an integer leaf the optimizer skips, such as
    ``inv_perm``) and ``step`` replicate. ``opt_state_shapes``: ``{"mu":
    {path: shape or None}, "nu": ...}``."""
    moments = tree_specs(axes_tree, param_shapes, mesh, profile="fsdp_tp",
                         kind="param")
    return {key: {path: (() if opt_state_shapes[key].get(path) is None
                         else moments[path]) for path in moments}
            for key in ("mu", "nu")} | {"step": ()}
