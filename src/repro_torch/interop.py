"""Build the port's objects from plain state.

The partitioning service's state is data, not weights: a
dictionary-encoded triple set, a query workload, the feature universe, a
feature->shard assignment and replica holder masks. The language models'
state is their parameter tree. Each function here takes that state as
plain numpy arrays and Python values — as any other implementation of the
system can export it — and returns the ``repro_torch`` object that holds
it, so one dataset, layout or set of weights can be served by this package
and compared with another's. A language model's training state goes both
ways: ``lm_params`` and ``adamw_state`` build it, ``lm_tree`` and
``adamw_tree`` export it as plain numpy, keyed by the same leaf paths.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.features import FeatureSpace
from repro_torch.core.partition import PartitionState
from repro_torch.graph import lubm
from repro_torch.graph.triples import Dictionary, TripleStore
from repro_torch.kernels import dispatch
from repro_torch.query.pattern import Query
from repro_torch.replicate import ReplicaMap


def dictionary(terms: Iterable[str]) -> Dictionary:
    """A ``Dictionary`` in which ``terms[i]`` has id ``i``."""
    d = Dictionary()
    for i, term in enumerate(terms):
        if d.encode(term) != i:
            raise ValueError(f"duplicate term {term!r}")
    return d


def triple_store(triples: np.ndarray, terms: Iterable[str]) -> TripleStore:
    """(N, 3) dictionary-encoded triples, in their row order, plus the
    dictionary's terms in id order -> ``TripleStore``."""
    return TripleStore(np.array(triples, dtype=np.int32), dictionary(terms))


def query(spec: Tuple) -> Query:
    """``(name, patterns, frequency, shape)`` -> ``Query``."""
    name, patterns, frequency, shape = spec
    return Query(name=str(name),
                 patterns=tuple(tuple(int(x) for x in p) for p in patterns),
                 frequency=float(frequency), shape=str(shape))


def feature_space(store: TripleStore, keys: Iterable[Tuple],
                  type_predicate: "int | None" = None) -> FeatureSpace:
    """A ``FeatureSpace`` over ``store`` whose feature ``i`` is
    ``keys[i]`` (``("P", p)`` or ``("PO", p, o)``), so that assignments
    indexed by feature carry over unchanged."""
    space = FeatureSpace(store, type_predicate=type_predicate)
    for key in keys:
        if key[0] == "PO":
            space.track_po(key[1], key[2])
        else:
            space.track_p(key[1])
    keys = [tuple(k) for k in keys]
    if space.feature_keys() != keys:
        raise ValueError("feature keys are not in the order this store "
                         "and type predicate produce")
    return space


def partition_state(feature_to_shard: np.ndarray, feature_sizes: np.ndarray,
                    n_shards: int) -> PartitionState:
    """A feature->shard assignment -> ``PartitionState``."""
    return PartitionState(np.array(feature_to_shard, dtype=np.int32),
                          np.array(feature_sizes, dtype=np.int64),
                          int(n_shards))


def replica_map(masks: np.ndarray, n_shards: int) -> ReplicaMap:
    """Per-feature holder bitmasks (bit ``s`` set: shard ``s`` holds a copy)
    -> ``ReplicaMap``."""
    return ReplicaMap(np.array(masks, dtype=np.uint64), int(n_shards))


def lubm_dataset(triples: np.ndarray, terms: Sequence[str],
                 named: Mapping[str, int], queries: Iterable[Tuple],
                 n_universities: int) -> lubm.LubmDataset:
    """A LUBM dataset (store, dictionary, named entities, benchmark
    queries) from its plain state."""
    store = triple_store(triples, terms)
    qs: Dict[str, Query] = {}
    for spec in queries:
        q = query(spec)
        qs[q.name] = q
    return lubm.LubmDataset(store=store, dictionary=store.dictionary,
                            named=lubm.Named(**{k: int(v)
                                                for k, v in named.items()}),
                            queries=qs, n_universities=int(n_universities))


def lm_params(tree: Mapping[str, np.ndarray], cfg: ArchConfig, *,
              device="cuda", ctx=None):
    """A language model's parameter tree -> the port's
    ``models.transformer.Transformer`` on ``device``. ``tree`` maps each
    leaf's path (``"embed"``, ``"ln_f/scale"``, ``"blocks/attn/wq"``; for
    RWKV6 ``"blocks/tm/wr"``; for Mamba2 ``"blocks/mamba/in_proj"`` and the
    hybrid's unstacked ``"shared/attn/wq"``; for MoE ``"blocks/moe/wg"``
    and the integer slot map ``"blocks/moe/inv_perm"``, ...) to its array,
    blocks stacked on a leading ``layers`` axis; the paths and shapes must
    be exactly those of ``models.lm.param_shapes(cfg)``. Every leaf is
    carried as float32 but ``inv_perm``, which stays an integer (int32).
    With a ``ctx`` (a ``models.moe.ShardCtx``) an expert leaf keeps only
    this rank's slots (``models.moe.expert_slice``)."""
    from repro_torch.models import lm, moe, transformer
    dev = dispatch.resolve_device(device)
    want = lm.param_shapes(cfg)
    if set(tree) != set(want):
        raise ValueError(f"parameter paths differ: missing "
                         f"{sorted(set(want) - set(tree))}, unexpected "
                         f"{sorted(set(tree) - set(want))}")
    flat = {}
    for path, shape in want.items():
        a = np.asarray(tree[path])
        if a.shape != shape:
            raise ValueError(f"{path}: shape {a.shape}, expected {shape}")
        dt = np.int32 if path.endswith("/inv_perm") else np.float32
        if path in lm.MOE_EXPERT_LEAVES:
            a = a[:, moe.expert_slice(cfg, ctx)]
        flat[path] = torch.from_numpy(np.array(a, dtype=dt)).to(dev)
    return transformer.Transformer(cfg, flat)


def adamw_state(ref_state: Mapping, model) -> Dict:
    """An AdamW state ``{"mu", "nu", "step"}`` whose moments are parameter
    trees keyed by leaf path as :func:`lm_params` takes them (a leaf the
    optimizer does not train, such as ``inv_perm``, may be absent or None)
    -> the port's state for ``model``: float32 moments keyed by the model's
    trainable parameter names, in the parameters' shapes, and an int32
    ``step``, on the model's device."""
    from repro_torch.models import lm
    dev = model.device
    out: Dict = {"mu": {}, "nu": {}}
    for name, p in lm.trainable(model).items():
        path, layer = lm.leaf_path(name)
        for key in ("mu", "nu"):
            a = np.asarray(ref_state[key][path])
            a = a if layer is None else a[layer]
            out[key][name] = torch.from_numpy(
                np.array(a, dtype=np.float32).reshape(p.shape)).to(dev)
    out["step"] = torch.tensor(int(np.asarray(ref_state["step"])),
                               dtype=torch.int32, device=dev)
    return out


def _by_path(tensors: Mapping[str, torch.Tensor], cfg: ArchConfig,
             ctx=None) -> Dict[str, np.ndarray]:
    """Tensors keyed by the model's names -> numpy arrays keyed by leaf
    path, layers stacked, in ``param_shapes``' shapes (copies: an update
    in place does not reach them); with a ``ctx`` the expert slots
    gathered over tp."""
    from repro_torch.models import lm, moe
    shapes = lm.param_shapes(cfg)
    parts: Dict[str, Dict] = {}
    for name, t in tensors.items():
        path, layer = lm.leaf_path(name)
        if ctx is not None and path in lm.MOE_EXPERT_LEAVES:
            t = moe.gather_slots(t, ctx)
        if path in shapes:
            parts.setdefault(path, {})[layer] = np.array(   # a copy
                t.detach().to("cpu", torch.float32 if t.dtype.is_floating_point
                              else t.dtype))
    out = {}
    for path, by_layer in parts.items():
        if None in by_layer:
            a = by_layer[None]
        else:
            a = np.stack([by_layer[i] for i in range(len(by_layer))])
        out[path] = a.reshape(shapes[path])
    return out


def lm_tree(model, cfg: ArchConfig, ctx=None) -> Dict[str, np.ndarray]:
    """The inverse of :func:`lm_params`: the model's parameter tree keyed
    by leaf path, layers stacked, as float32 numpy arrays (the trained
    values: the master copies where the model has them) and the int32
    ``inv_perm``. With a ``ctx`` (on every rank of its mesh) the expert
    leaves are gathered over tp: every rank gets the whole tree."""
    from repro_torch.models import lm
    tensors = dict(model.named_parameters())
    tensors.update(lm.trainable(model))
    tensors.update((n, b) for n, b in model.named_buffers()
                   if n.endswith("inv_perm"))
    return _by_path(tensors, cfg, ctx)


def adamw_tree(state: Mapping, cfg: ArchConfig, ctx=None) -> Dict:
    """The inverse of :func:`adamw_state`: ``{"mu", "nu"}`` keyed by leaf
    path (trained leaves only), ``"step"`` a numpy int32; with a ``ctx``
    the expert leaves' moments gathered over tp, as :func:`lm_tree`."""
    return {"mu": _by_path(state["mu"], cfg, ctx),
            "nu": _by_path(state["nu"], cfg, ctx),
            "step": np.int32(int(state["step"]))}
