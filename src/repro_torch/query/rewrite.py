"""Query → federated query rewriting (Table I / QRP in Fig. 6).

Produces the SERVICE-decorated form of a BGP against the current partition
metadata: patterns whose features are homed on the PPN stay plain; patterns
homed elsewhere become ``SERVICE <endpoint_k> { ... }`` clauses. The engine
executes the same plan natively; this module renders it (for logs, docs and
the examples) exactly as the paper's Query Rewriter would emit it.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core.features import FeatureSpace
from repro_torch.core.partition import PartitionState
from repro_torch.graph.triples import Dictionary
from repro_torch.query.pattern import Query, is_var
from repro_torch.query.plan import pattern_home, primary_shard


def _term(slot: int, d: Dictionary | None) -> str:
    if is_var(slot):
        return f"?v{-slot - 1}"
    if d is not None:
        try:
            return d.decode(slot)
        except IndexError:
            pass
    return f"<e{slot}>"


def federated_sparql(q: Query, space: FeatureSpace, state: PartitionState,
                     dictionary: Dictionary | None = None,
                     endpoints: List[str] | None = None,
                     replicas=None) -> str:
    """Render the federated form of ``q`` under the current PMeta. Pass the
    layout's ``ReplicaMap`` (e.g. ``kg.replicas``) so the rendering matches
    the replica-aware plan the engine executes: the PPN vote counts local
    copies, and a pattern replicated onto the PPN stays plain (no SERVICE
    clause)."""
    ppn = primary_shard(q, space, state, replicas)
    eps = endpoints or [f"http://node{i}/sparql" for i in range(state.n_shards)]
    head = " ".join(f"?v{-v - 1}" for v in q.variables())
    lines = [f"SELECT {head} WHERE {{"]
    for pat in q.patterns:
        home = pattern_home(pat, space, state, replicas, ppn)
        triple = " ".join(_term(t, dictionary) for t in pat) + " ."
        if home in (ppn, -1):
            lines.append(f"  {triple}")
        else:
            lines.append(f"  SERVICE <{eps[home]}> {{ {triple} }}")
    lines.append("}")
    return "\n".join(lines)


def service_counts(q: Query, space: FeatureSpace, state: PartitionState,
                   replicas=None) -> Dict[str, int]:
    """How many patterns run locally at the PPN vs. via SERVICE calls."""
    ppn = primary_shard(q, space, state, replicas)
    local = remote = 0
    for pat in q.patterns:
        home = pattern_home(pat, space, state, replicas, ppn)
        if home in (ppn, -1):
            local += 1
        else:
            remote += 1
    return {"local": local, "service": remote, "ppn": ppn}
