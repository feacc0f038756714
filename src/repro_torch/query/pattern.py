"""Triple patterns and basic graph pattern (BGP) queries.

A pattern is ``(s, p, o)`` where each slot is either a non-negative dictionary
id (constant) or a negative int (variable). A ``Query`` is a conjunctive BGP —
the SPARQL subset AWAPart's QueryAnalyzer handles (SELECT over a BGP).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

Pattern = Tuple[int, int, int]

# Variable slots are negative. var(0) == -1, var(1) == -2, ...
def var(i: int) -> int:
    return -(i + 1)


def is_var(slot: int) -> bool:
    return slot < 0


@dataclasses.dataclass(frozen=True)
class Query:
    name: str
    patterns: Tuple[Pattern, ...]
    frequency: float = 1.0
    # query shape tag used by the paper's Exp-1 workload (linear/star/snowflake/complex)
    shape: str = ""

    def variables(self) -> List[int]:
        out = []
        for pat in self.patterns:
            for slot in pat:
                if is_var(slot) and slot not in out:
                    out.append(slot)
        return out

    def with_frequency(self, f: float) -> "Query":
        return dataclasses.replace(self, frequency=f)


def join_structure(q: Query) -> List[Tuple[int, int, str]]:
    """Enumerate join-type edges between pattern pairs.

    Returns (i, j, kind) with kind in {SSJ, OOJ, OSJ} following the paper's
    definitions: SSJ = shared subject, OOJ = shared object, OSJ = object of
    one is subject of the other (the "elbow" join).
    """
    edges: List[Tuple[int, int, str]] = []
    pats = q.patterns
    for i in range(len(pats)):
        for j in range(i + 1, len(pats)):
            si, _, oi = pats[i]
            sj, _, oj = pats[j]
            if is_var(si) and si == sj:
                edges.append((i, j, "SSJ"))
            if is_var(oi) and oi == oj:
                edges.append((i, j, "OOJ"))
            if is_var(oi) and oi == sj:
                edges.append((i, j, "OSJ"))
            if is_var(oj) and oj == si:
                edges.append((j, i, "OSJ"))
    return edges
