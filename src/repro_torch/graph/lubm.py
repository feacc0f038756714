"""LUBM(k)-style synthetic knowledge graph + the paper's 24-query workload.

Faithful to the evaluation setup of the paper: LUBM with 10 universities
(~1.5M triples after materialization), the 14 standard LUBM queries Q1..Q14,
and 10 extra queries EQ1..EQ10 that are "a mixture of linear, star, snowflake,
and complex queries" (Sec. V, Exp 1).

RDFS subclass/subproperty entailment (Student ⊒ GraduateStudent, degreeFrom ⊒
undergraduateDegreeFrom, ...) is materialized at generation time, as the
LUBM queries require inference the raw data does not contain.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.graph.triples import Dictionary, TripleStore, build_store
from repro_torch.query.pattern import Query, var

# --------------------------------------------------------------------------- #
# Schema
# --------------------------------------------------------------------------- #

PROPERTIES = [
    "rdf:type", "ub:memberOf", "ub:subOrganizationOf",
    "ub:undergraduateDegreeFrom", "ub:mastersDegreeFrom",
    "ub:doctoralDegreeFrom", "ub:degreeFrom", "ub:worksFor", "ub:advisor",
    "ub:teacherOf", "ub:takesCourse", "ub:publicationAuthor", "ub:headOf",
    "ub:researchInterest", "ub:emailAddress", "ub:telephone", "ub:name",
    "ub:teachingAssistantOf",
]

CLASSES = [
    "ub:University", "ub:Department", "ub:ResearchGroup", "ub:FullProfessor",
    "ub:AssociateProfessor", "ub:AssistantProfessor", "ub:Lecturer",
    "ub:UndergraduateStudent", "ub:GraduateStudent", "ub:Course",
    "ub:GraduateCourse", "ub:Publication", "ub:TeachingAssistant",
    # materialized superclasses
    "ub:Professor", "ub:Faculty", "ub:Student", "ub:Person", "ub:Organization",
    "ub:Chair",
]

SUPERCLASSES: Dict[str, Tuple[str, ...]] = {
    "ub:FullProfessor": ("ub:Professor", "ub:Faculty", "ub:Person"),
    "ub:AssociateProfessor": ("ub:Professor", "ub:Faculty", "ub:Person"),
    "ub:AssistantProfessor": ("ub:Professor", "ub:Faculty", "ub:Person"),
    "ub:Lecturer": ("ub:Faculty", "ub:Person"),
    "ub:UndergraduateStudent": ("ub:Student", "ub:Person"),
    "ub:GraduateStudent": ("ub:Student", "ub:Person"),
    "ub:University": ("ub:Organization",),
    "ub:Department": ("ub:Organization",),
    "ub:ResearchGroup": ("ub:Organization",),
    "ub:GraduateCourse": ("ub:Course",),
}

DEGREE_PROPS = ("ub:undergraduateDegreeFrom", "ub:mastersDegreeFrom",
                "ub:doctoralDegreeFrom")


@dataclasses.dataclass
class Named:
    """Concrete entity ids referenced as constants in the benchmark queries."""
    university0: int
    department0: int           # Department0 of University0
    grad_course0: int          # GraduateCourse0 of Department0
    assistant_prof0: int
    associate_prof0: int
    research_interest0: int


@dataclasses.dataclass
class LubmDataset:
    store: TripleStore
    dictionary: Dictionary
    named: Named
    queries: Dict[str, Query]
    n_universities: int

    def workload(self, names: List[str],
                 frequencies: Dict[str, float] | None = None) -> List[Query]:
        freqs = frequencies or {}
        return [self.queries[n].with_frequency(freqs.get(n, 1.0))
                for n in names]

    def base_workload(self) -> List[Query]:
        return self.workload([f"Q{i}" for i in range(1, 15)])

    def extended_workload(self) -> List[Query]:
        return self.workload([f"Q{i}" for i in range(1, 15)]
                             + [f"EQ{i}" for i in range(1, 11)])


# --------------------------------------------------------------------------- #
# Generation
# --------------------------------------------------------------------------- #


def generate(n_universities: int = 10, seed: int = 0) -> LubmDataset:
    rng = np.random.default_rng(seed)
    d = Dictionary()
    pid = {name: d.encode(name) for name in PROPERTIES}
    cid = {name: d.encode(name) for name in CLASSES}
    rtype = pid["rdf:type"]

    next_id = len(d)

    def alloc(n: int) -> np.ndarray:
        nonlocal next_id
        ids = np.arange(next_id, next_id + n, dtype=np.int64)
        next_id += n
        return ids

    blocks: List[np.ndarray] = []

    def emit(s: np.ndarray, p: int, o) -> None:
        s = np.asarray(s, dtype=np.int64).ravel()
        o_arr = (np.full(s.shape, o, dtype=np.int64)
                 if np.isscalar(o) else np.asarray(o, dtype=np.int64).ravel())
        blk = np.stack([s, np.full(s.shape, p, dtype=np.int64), o_arr], axis=1)
        blocks.append(blk)

    def emit_type(s: np.ndarray, cls: str) -> None:
        emit(s, rtype, cid[cls])
        for sup in SUPERCLASSES.get(cls, ()):
            emit(s, rtype, cid[sup])

    # research-interest vocabulary shared across the graph
    interests = alloc(40)

    universities = alloc(n_universities)
    emit_type(universities, "ub:University")
    named: Named | None = None

    for u_idx, univ in enumerate(universities):
        n_dept = int(rng.integers(15, 26))
        depts = alloc(n_dept)
        emit_type(depts, "ub:Department")
        emit(depts, pid["ub:subOrganizationOf"], univ)

        for d_idx, dept in enumerate(depts):
            nf_full = int(rng.integers(7, 11))
            nf_assoc = int(rng.integers(10, 15))
            nf_asst = int(rng.integers(8, 12))
            nf_lect = int(rng.integers(5, 8))
            full = alloc(nf_full); assoc = alloc(nf_assoc)
            asst = alloc(nf_asst); lect = alloc(nf_lect)
            for ids, cls in ((full, "ub:FullProfessor"),
                             (assoc, "ub:AssociateProfessor"),
                             (asst, "ub:AssistantProfessor"),
                             (lect, "ub:Lecturer")):
                emit_type(ids, cls)
            faculty = np.concatenate([full, assoc, asst, lect])
            emit(faculty, pid["ub:worksFor"], dept)
            # head of department (a full professor) — materialized ub:Chair
            emit(full[:1], pid["ub:headOf"], dept)
            emit_type(full[:1], "ub:Chair")

            # attributes: one literal-ish object each (unique ids)
            for prop in ("ub:emailAddress", "ub:telephone", "ub:name"):
                emit(faculty, pid[prop], alloc(len(faculty)))
            emit(faculty, pid["ub:researchInterest"],
                 rng.choice(interests, size=len(faculty)))

            # degrees: professors hold all three; lecturers one
            prof = np.concatenate([full, assoc, asst])
            for prop in DEGREE_PROPS:
                target = rng.choice(universities, size=len(prof))
                emit(prof, pid[prop], target)
                emit(prof, pid["ub:degreeFrom"], target)
            lect_deg = rng.choice(universities, size=len(lect))
            emit(lect, pid["ub:undergraduateDegreeFrom"], lect_deg)
            emit(lect, pid["ub:degreeFrom"], lect_deg)

            # courses: every faculty teaches 1-2; ~30% are graduate courses
            n_courses = len(faculty) + int(rng.integers(0, len(faculty) // 2 + 1))
            courses = alloc(n_courses)
            n_grad_c = max(1, int(0.3 * n_courses))
            grad_courses, ug_courses = courses[:n_grad_c], courses[n_grad_c:]
            emit_type(grad_courses, "ub:GraduateCourse")
            emit_type(ug_courses, "ub:Course")
            teachers = np.concatenate(
                [faculty, rng.choice(faculty, size=n_courses - len(faculty))])
            emit(teachers[:n_courses], pid["ub:teacherOf"], courses)

            # students
            n_ug = int(len(faculty) * rng.integers(9, 16))
            n_gr = int(len(faculty) * rng.integers(3, 6))
            ug = alloc(n_ug); gr = alloc(n_gr)
            emit_type(ug, "ub:UndergraduateStudent")
            emit_type(gr, "ub:GraduateStudent")
            students = np.concatenate([ug, gr])
            emit(students, pid["ub:memberOf"], dept)
            for prop in ("ub:emailAddress", "ub:telephone", "ub:name"):
                emit(students, pid[prop], alloc(len(students)))
            # course enrollment: UG take UG courses, grads take grad courses
            for group, pool, lo, hi in ((ug, ug_courses, 2, 5),
                                        (gr, grad_courses, 1, 4)):
                if len(pool) == 0:
                    continue
                k = int(rng.integers(lo, hi))
                take = rng.choice(pool, size=(len(group), k))
                emit(np.repeat(group, k), pid["ub:takesCourse"], take.ravel())
            # advisors + UG degree for grads
            emit(gr, pid["ub:advisor"], rng.choice(prof, size=len(gr)))
            gr_deg = rng.choice(universities, size=len(gr))
            emit(gr, pid["ub:undergraduateDegreeFrom"], gr_deg)
            emit(gr, pid["ub:degreeFrom"], gr_deg)
            # ~20% of grads TA a course
            n_ta = len(gr) // 5
            if n_ta and len(ug_courses):
                tas = gr[:n_ta]
                emit_type(tas, "ub:TeachingAssistant")
                emit(tas, pid["ub:teachingAssistantOf"],
                     rng.choice(ug_courses, size=n_ta))

            # publications: faculty author 5-15; grads co-author some
            n_pub_per = rng.integers(5, 16, size=len(faculty))
            n_pubs = int(n_pub_per.sum())
            pubs = alloc(n_pubs)
            emit_type(pubs, "ub:Publication")
            emit(pubs, pid["ub:publicationAuthor"],
                 np.repeat(faculty, n_pub_per))
            co = rng.random(n_pubs) < 0.25
            if co.any() and len(gr):
                emit(pubs[co], pid["ub:publicationAuthor"],
                     rng.choice(gr, size=int(co.sum())))

            # research groups
            n_rg = int(rng.integers(10, 21))
            rgs = alloc(n_rg)
            emit_type(rgs, "ub:ResearchGroup")
            emit(rgs, pid["ub:subOrganizationOf"], dept)

            if u_idx == 0 and d_idx == 0:
                named = Named(
                    university0=int(univ), department0=int(dept),
                    grad_course0=int(grad_courses[0]),
                    assistant_prof0=int(asst[0]),
                    associate_prof0=int(assoc[0]),
                    research_interest0=int(interests[0]),
                )

    triples = np.concatenate(blocks, axis=0)
    assert triples.max() < np.iinfo(np.int32).max
    store = build_store(triples.astype(np.int32), d)
    assert named is not None
    queries = _make_queries(pid, cid, named)
    return LubmDataset(store=store, dictionary=d, named=named,
                       queries=queries, n_universities=n_universities)


# --------------------------------------------------------------------------- #
# The 24-query workload
# --------------------------------------------------------------------------- #


def _make_queries(pid: Dict[str, int], cid: Dict[str, int],
                  nm: Named) -> Dict[str, Query]:
    t = pid["rdf:type"]
    X, Y, Z, W, V1, V2, V3 = (var(i) for i in range(7))

    def q(name: str, shape: str, *pats) -> Query:
        return Query(name=name, patterns=tuple(pats), shape=shape)

    qs = [
        q("Q1", "star",
          (X, t, cid["ub:GraduateStudent"]),
          (X, pid["ub:takesCourse"], nm.grad_course0)),
        q("Q2", "complex",
          (X, t, cid["ub:GraduateStudent"]),
          (Y, t, cid["ub:University"]),
          (Z, t, cid["ub:Department"]),
          (X, pid["ub:memberOf"], Z),
          (Z, pid["ub:subOrganizationOf"], Y),
          (X, pid["ub:undergraduateDegreeFrom"], Y)),
        q("Q3", "star",
          (X, t, cid["ub:Publication"]),
          (X, pid["ub:publicationAuthor"], nm.assistant_prof0)),
        q("Q4", "star",
          (X, t, cid["ub:Professor"]),
          (X, pid["ub:worksFor"], nm.department0),
          (X, pid["ub:name"], V1),
          (X, pid["ub:emailAddress"], V2),
          (X, pid["ub:telephone"], V3)),
        q("Q5", "star",
          (X, t, cid["ub:Person"]),
          (X, pid["ub:memberOf"], nm.department0)),
        q("Q6", "linear", (X, t, cid["ub:Student"])),
        q("Q7", "snowflake",
          (X, t, cid["ub:Student"]),
          (Y, t, cid["ub:Course"]),
          (X, pid["ub:takesCourse"], Y),
          (nm.associate_prof0, pid["ub:teacherOf"], Y)),
        q("Q8", "snowflake",
          (X, t, cid["ub:Student"]),
          (Y, t, cid["ub:Department"]),
          (X, pid["ub:memberOf"], Y),
          (Y, pid["ub:subOrganizationOf"], nm.university0),
          (X, pid["ub:emailAddress"], Z)),
        q("Q9", "complex",
          (X, t, cid["ub:Student"]),
          (Y, t, cid["ub:Faculty"]),
          (Z, t, cid["ub:Course"]),
          (X, pid["ub:advisor"], Y),
          (Y, pid["ub:teacherOf"], Z),
          (X, pid["ub:takesCourse"], Z)),
        q("Q10", "star",
          (X, t, cid["ub:Student"]),
          (X, pid["ub:takesCourse"], nm.grad_course0)),
        q("Q11", "star",
          (X, t, cid["ub:ResearchGroup"]),
          (X, pid["ub:subOrganizationOf"], nm.university0)),
        q("Q12", "snowflake",
          (X, t, cid["ub:Chair"]),
          (Y, t, cid["ub:Department"]),
          (X, pid["ub:worksFor"], Y),
          (Y, pid["ub:subOrganizationOf"], nm.university0)),
        q("Q13", "star",
          (X, t, cid["ub:Person"]),
          (X, pid["ub:degreeFrom"], nm.university0)),
        q("Q14", "linear", (X, t, cid["ub:UndergraduateStudent"])),
        # ---- 10 extra queries (Exp 1): linear / star / snowflake / complex
        q("EQ1", "linear",
          (X, pid["ub:advisor"], Y),
          (Y, pid["ub:worksFor"], Z),
          (Z, pid["ub:subOrganizationOf"], W)),
        q("EQ2", "star",
          (X, t, cid["ub:FullProfessor"]),
          (X, pid["ub:name"], V1),
          (X, pid["ub:emailAddress"], V2),
          (X, pid["ub:telephone"], V3),
          (X, pid["ub:researchInterest"], W)),
        q("EQ3", "snowflake",
          (X, t, cid["ub:FullProfessor"]),
          (X, pid["ub:teacherOf"], Y),
          (Z, pid["ub:takesCourse"], Y),
          (Z, t, cid["ub:UndergraduateStudent"])),
        q("EQ4", "complex",
          (X, t, cid["ub:GraduateStudent"]),
          (X, pid["ub:advisor"], Y),
          (Z, pid["ub:publicationAuthor"], Y),
          (Z, t, cid["ub:Publication"])),
        q("EQ5", "star",
          (Y, t, cid["ub:Department"]),
          (Y, pid["ub:subOrganizationOf"], nm.university0),
          (X, pid["ub:worksFor"], Y),
          (X, t, cid["ub:AssociateProfessor"])),
        q("EQ6", "linear",
          (X, pid["ub:publicationAuthor"], Y),
          (Y, pid["ub:worksFor"], Z),
          (Z, pid["ub:subOrganizationOf"], W)),
        q("EQ7", "complex",
          (X, t, cid["ub:GraduateStudent"]),
          (X, pid["ub:advisor"], Y),
          (Y, pid["ub:headOf"], Z),
          (Z, t, cid["ub:Department"])),
        q("EQ8", "snowflake",
          (X, pid["ub:teachingAssistantOf"], Y),
          (Y, t, cid["ub:Course"]),
          (X, pid["ub:memberOf"], Z),
          (Z, t, cid["ub:Department"])),
        q("EQ9", "star",
          (X, t, cid["ub:FullProfessor"]),
          (X, pid["ub:mastersDegreeFrom"], nm.university0),
          (X, pid["ub:researchInterest"], nm.research_interest0)),
        q("EQ10", "complex",
          (X, pid["ub:publicationAuthor"], Y),
          (X, pid["ub:publicationAuthor"], Z),
          (Y, t, cid["ub:FullProfessor"]),
          (Z, t, cid["ub:GraduateStudent"]),
          (Y, pid["ub:worksFor"], W)),
    ]
    return {query.name: query for query in qs}


_CACHE: Dict[Tuple[int, int], LubmDataset] = {}


def load(n_universities: int = 10, seed: int = 0) -> LubmDataset:
    """Memoized generation (the dataset is reused across benchmarks)."""
    key = (n_universities, seed)
    if key not in _CACHE:
        _CACHE[key] = generate(n_universities, seed)
    return _CACHE[key]
