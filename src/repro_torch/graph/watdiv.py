"""WatDiv-style synthetic e-commerce knowledge graph + query workload.

WatDiv (Waterloo SPARQL Diversity Test Suite) is the second workload family
the adaptive-partitioning literature evaluates beside LUBM: a retail graph
(users, products, retailers, offers, reviews) whose benchmark queries are
grouped into the four structural families AWAPart's Exp-1 mixes — star (S*),
linear/path (L*), snowflake (F*) and complex (C*).

This module is a seeded miniature of that design:

* :func:`generate` builds the graph at a given ``scale`` (≈15k triples per
  unit) with Zipf-skewed popularity — ``product0`` is the most liked,
  reviewed, purchased and offered product, which is exactly the kind of
  single hot feature a flash crowd concentrates on;
* 16 named template queries (S1–S5, L1–L5, F1–F3, C1–C3) whose answer sets
  are non-empty **by construction**: every template's join path is either
  dense in the generated data or pinned by an explicitly emitted witness
  subgraph;
* ``topics`` groups the templates into *focus* families (``retail`` /
  ``social`` / ``review``) with near-disjoint feature sets — the axis the
  drift scenarios (``repro_torch.scenario``) shift along;
* :meth:`WatDivDataset.sample_query` draws fresh random queries of any
  shape by walking actual edges of the store, so the walk instance itself
  is a witness binding and every sampled query is answerable.

The dataset satisfies the same ``Dataset`` duck type as ``graph.lubm``
(``store`` / ``dictionary`` / ``queries`` / ``workload`` /
``base_workload``), so it plugs straight into ``KGService.from_dataset``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.graph.triples import Dictionary, TripleStore, build_store
from repro_torch.query.pattern import Query, var

# --------------------------------------------------------------------------- #
# Schema
# --------------------------------------------------------------------------- #

PROPERTIES = [
    "rdf:type",
    # social
    "wsdbm:follows", "wsdbm:friendOf", "wsdbm:likes", "wsdbm:subscribes",
    # retail
    "wsdbm:makesPurchase", "wsdbm:purchaseFor", "wsdbm:purchaseDate",
    "gr:offers", "gr:includes", "gr:price",
    # reviews
    "rev:hasReview", "rev:reviewer", "rev:ratingValue",
    # attributes
    "wsdbm:hasGenre", "sorg:caption", "sorg:nationality",
    "foaf:givenName", "foaf:homepage", "og:tag",
]

N_CATEGORIES = 5

CLASSES = [
    "wsdbm:User", "wsdbm:Product", "wsdbm:Purchase", "rev:Review",
    "gr:Offer", "wsdbm:Retailer", "wsdbm:Website", "wsdbm:Genre",
    "wsdbm:Country", "og:Tag",
] + [f"wsdbm:ProductCategory{i}" for i in range(N_CATEGORIES)]

# category membership is materialized up to the product superclass, the same
# RDFS-entailment move graph.lubm makes for the ub:* hierarchy
SUPERCLASSES: Dict[str, Tuple[str, ...]] = {
    f"wsdbm:ProductCategory{i}": ("wsdbm:Product",)
    for i in range(N_CATEGORIES)
}


@dataclasses.dataclass
class WatDivNamed:
    """Concrete entity ids referenced as constants in the template queries."""
    product0: int        # the Zipf head: most liked/reviewed/offered product
    genre0: int          # product0's genre
    country0: int        # the most common user nationality
    retailer0: int
    website0: int        # the most-subscribed website
    tag0: int


@dataclasses.dataclass
class WatDivDataset:
    store: TripleStore
    dictionary: Dictionary
    named: WatDivNamed
    queries: Dict[str, Query]
    scale: int
    # focus families with near-disjoint feature sets — what drift scenarios
    # shift between (shape families live on Query.shape, as in graph.lubm)
    topics: Dict[str, Tuple[str, ...]]

    def workload(self, names: List[str],
                 frequencies: Dict[str, float] | None = None) -> List[Query]:
        freqs = frequencies or {}
        return [self.queries[n].with_frequency(freqs.get(n, 1.0))
                for n in names]

    def base_workload(self) -> List[Query]:
        return self.workload(sorted(self.queries))

    def extended_workload(self) -> List[Query]:
        return self.base_workload()

    def topic_workload(self, topic: str) -> List[Query]:
        return self.workload(list(self.topics[topic]))

    def family(self, shape: str) -> List[Query]:
        """All template queries of one structural shape
        (``star`` / ``linear`` / ``snowflake`` / ``complex``)."""
        return [q for _, q in sorted(self.queries.items())
                if q.shape == shape]

    # ------------------------------------------------------------------ #
    # the random query generator (witness-walk sampling)
    # ------------------------------------------------------------------ #
    def sample_query(self, rng: np.random.Generator,
                     shape: Optional[str] = None, name: str = "") -> Query:
        """Draw one random query of the given shape (random shape if None).

        Star/linear/snowflake queries are sampled by walking *actual edges*
        of the store outward from a random witness entity, so the walk
        itself is a binding and the query is answerable by construction.
        Complex queries instantiate one of the C templates (whose witness
        subgraphs the generator pinned). Same ``rng`` state, same query."""
        shape = shape or ["star", "linear", "snowflake",
                          "complex"][int(rng.integers(4))]
        if shape == "star":
            q = self._sample_star(rng)
        elif shape == "linear":
            q = self._sample_linear(rng)
        elif shape == "snowflake":
            q = self._sample_snowflake(rng)
        elif shape == "complex":
            tmpl = ["C1", "C2", "C3"][int(rng.integers(3))]
            q = self.queries[tmpl]
        else:
            raise ValueError(f"unknown shape {shape!r}")
        return dataclasses.replace(
            q, name=name or f"{shape[0].upper()}R{int(rng.integers(1 << 30))}")

    # hub classes and the attribute predicates dense on them
    _STAR_HUBS = (
        ("wsdbm:User", ("foaf:givenName", "sorg:nationality",
                        "wsdbm:subscribes", "wsdbm:likes")),
        ("wsdbm:Product", ("wsdbm:hasGenre", "sorg:caption", "og:tag")),
        ("rev:Review", ("rev:reviewer", "rev:ratingValue")),
        ("gr:Offer", ("gr:includes", "gr:price")),
    )
    # predicate chains that compose along dense paths (see generation)
    _CHAINS = (
        ("wsdbm:follows", "wsdbm:likes", "wsdbm:hasGenre"),
        ("wsdbm:makesPurchase", "wsdbm:purchaseFor", "sorg:caption"),
        ("gr:offers", "gr:includes", "wsdbm:hasGenre"),
        ("rev:hasReview", "rev:reviewer", "sorg:nationality"),
        ("wsdbm:friendOf", "wsdbm:subscribes"),
    )

    def _pid(self, term: str) -> int:
        tid = self.dictionary.lookup(term)
        assert tid is not None, term
        return tid

    def _sample_star(self, rng) -> Query:
        cls, preds = self._STAR_HUBS[int(rng.integers(len(self._STAR_HUBS)))]
        t, c = self._pid("rdf:type"), self._pid(cls)
        hubs = self.store.match(None, t, c)[:, 0]
        hub = int(hubs[int(rng.integers(len(hubs)))])      # witness entity
        X = var(0)
        pats, nv = [(X, t, c)], 1
        order = rng.permutation(len(preds))
        bound_const = False
        for pi in order.tolist():
            p = self._pid(preds[pi])
            rows = self.store.match(hub, p, None)
            if not len(rows):
                continue
            if not bound_const:        # exactly one constant-object pattern
                o = int(rows[int(rng.integers(len(rows)))][2])
                pats.append((X, p, o))
                bound_const = True
            else:
                pats.append((X, p, var(nv)))
                nv += 1
            if len(pats) >= 4:
                break
        return Query(name="SR", patterns=tuple(pats), shape="star")

    def _walk(self, rng, chain: Tuple[str, ...],
              tries: int = 32) -> Optional[List[Tuple[int, int, int]]]:
        """One witness walk along a predicate chain: each hop's subject is
        the previous hop's object, following real edges only."""
        pids = [self._pid(p) for p in chain]
        for _ in range(tries):
            rows = self.store.match(None, pids[0], None)
            trip = rows[int(rng.integers(len(rows)))]
            walk = [tuple(int(x) for x in trip)]
            ok = True
            for p in pids[1:]:
                nxt = self.store.match(walk[-1][2], p, None)
                if not len(nxt):
                    ok = False
                    break
                walk.append(tuple(int(x)
                                  for x in nxt[int(rng.integers(len(nxt)))]))
            if ok:
                return walk
        return None

    def _sample_linear(self, rng) -> Query:
        chain = self._CHAINS[int(rng.integers(len(self._CHAINS)))]
        walk = self._walk(rng, chain)
        if walk is None:               # vanishingly rare: fall back to L1
            return self.queries["L1"]
        pats = [(var(i), p, var(i + 1))
                for i, (_, p, _) in enumerate(walk)]
        if rng.random() < 0.5:         # pin the tail to the witness object
            s, p, o = pats[-1]
            pats[-1] = (s, p, walk[-1][2])
        return Query(name="LR", patterns=tuple(pats), shape="linear")

    def _sample_snowflake(self, rng) -> Query:
        # a 2-hop walk plus an attribute branch on the *middle* node
        chain = self._CHAINS[int(rng.integers(len(self._CHAINS)))][:2]
        walk = self._walk(rng, chain)
        if walk is None:
            return self.queries["F1"]
        X, Y, Z, W = var(0), var(1), var(2), var(3)
        pats = [(X, walk[0][1], Y), (Y, walk[1][1], Z)]
        mid = walk[0][2]
        branches = self.store.match(mid, None, None)
        used = {walk[1][1]}
        for row in branches[rng.permutation(len(branches))].tolist():
            p = int(row[1])
            if p not in used:
                pats.append((Y, p, W))
                break
        return Query(name="FR", patterns=tuple(pats), shape="snowflake")


# --------------------------------------------------------------------------- #
# Generation
# --------------------------------------------------------------------------- #


def _zipf_weights(n: int) -> np.ndarray:
    """Normalized 1/rank popularity weights: index 0 is the hot head."""
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64)
    return w / w.sum()


def generate(scale: int = 1, seed: int = 0) -> WatDivDataset:
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

    def emit(s, p: int, o) -> None:
        s = np.asarray(s, dtype=np.int64).ravel()
        o_arr = (np.full(s.shape, o, dtype=np.int64)
                 if np.isscalar(o) else np.asarray(o, dtype=np.int64).ravel())
        blk = np.stack([s, np.full(s.shape, p, dtype=np.int64), o_arr], axis=1)
        blocks.append(blk)

    def emit_type(s, cls: str) -> None:
        emit(s, rtype, cid[cls])
        for sup in SUPERCLASSES.get(cls, ()):
            emit(s, rtype, cid[sup])

    # ------------------------------------------------------------------ #
    # entity pools
    # ------------------------------------------------------------------ #
    n_users = 600 * scale
    n_products = 240 * scale
    n_retailers = 12 * scale
    n_websites = 24 * scale
    n_genres = 12
    n_countries = 10
    n_tags = 30
    n_ratings = 10

    genres = alloc(n_genres);     emit_type(genres, "wsdbm:Genre")
    countries = alloc(n_countries); emit_type(countries, "wsdbm:Country")
    tags = alloc(n_tags);         emit_type(tags, "og:Tag")
    ratings = alloc(n_ratings)    # 1..10 rating vocabulary (no class)
    websites = alloc(n_websites); emit_type(websites, "wsdbm:Website")

    products = alloc(n_products)
    cat = rng.integers(0, N_CATEGORIES, n_products)
    for c in range(N_CATEGORIES):
        emit_type(products[cat == c], f"wsdbm:ProductCategory{c}")
    # product0 carries genre0 (the S1/L2/F1 constant); every product has
    # exactly one genre, one caption, 1-2 tags
    prod_genre = rng.choice(genres, size=n_products)
    prod_genre[0] = genres[0]
    emit(products, pid["wsdbm:hasGenre"], prod_genre)
    emit(products, pid["sorg:caption"], alloc(n_products))
    emit(products, pid["og:tag"], rng.choice(tags, size=n_products))
    extra_tag = rng.random(n_products) < 0.4
    emit(products[extra_tag], pid["og:tag"],
         rng.choice(tags, size=int(extra_tag.sum())))

    # popularity: product0 is the hot head of every retail interaction
    pop = _zipf_weights(n_products)

    users = alloc(n_users)
    emit_type(users, "wsdbm:User")
    emit(users, pid["foaf:givenName"], alloc(n_users))
    # country0 is deliberately the modal nationality (S2/L5/F3 constant)
    country_of = countries[
        np.minimum(rng.geometric(0.35, n_users) - 1, n_countries - 1)]
    emit(users, pid["sorg:nationality"], country_of)
    # subscriptions: website0 is the hot head
    sub_w = _zipf_weights(n_websites)
    emit(users, pid["wsdbm:subscribes"], rng.choice(websites, n_users, p=sub_w))
    # social edges: ~3 follows + ~2 friendships per user
    emit(np.repeat(users, 3), pid["wsdbm:follows"],
         rng.choice(users, 3 * n_users))
    emit(np.repeat(users, 2), pid["wsdbm:friendOf"],
         rng.choice(users, 2 * n_users))
    # likes, Zipf-weighted toward product0
    emit(np.repeat(users, 3), pid["wsdbm:likes"],
         rng.choice(products, 3 * n_users, p=pop))

    # purchases: 2 per user; ~30% of purchases spawn a review BY THE BUYER
    # of the purchased product — the C2 witness pattern, dense on purpose
    n_purch = 2 * n_users
    purchases = alloc(n_purch)
    emit_type(purchases, "wsdbm:Purchase")
    buyers = np.repeat(users, 2)
    bought = rng.choice(products, n_purch, p=pop)
    emit(buyers, pid["wsdbm:makesPurchase"], purchases)
    emit(purchases, pid["wsdbm:purchaseFor"], bought)
    emit(purchases, pid["wsdbm:purchaseDate"], alloc(n_purch))
    reviewed = rng.random(n_purch) < 0.3
    n_rev = int(reviewed.sum())
    reviews = alloc(n_rev)
    emit_type(reviews, "rev:Review")
    emit(bought[reviewed], pid["rev:hasReview"], reviews)
    emit(reviews, pid["rev:reviewer"], buyers[reviewed])
    emit(reviews, pid["rev:ratingValue"], rng.choice(ratings, n_rev))

    # retailers and offers: each retailer lists ~20 Zipf-weighted products
    retailers = alloc(n_retailers)
    emit_type(retailers, "wsdbm:Retailer")
    emit(retailers, pid["foaf:homepage"], rng.choice(websites, n_retailers))
    n_offers = 20 * n_retailers
    offers = alloc(n_offers)
    emit_type(offers, "gr:Offer")
    emit(np.repeat(retailers, 20), pid["gr:offers"], offers)
    listed = rng.choice(products, n_offers, p=pop)
    listed[0] = products[0]            # offer0 lists product0 (S3 witness)
    emit(offers, pid["gr:includes"], listed)
    emit(offers, pid["gr:price"], alloc(n_offers))

    # ------------------------------------------------------------------ #
    # pinned witness subgraph: guarantees the sparse template joins
    # ------------------------------------------------------------------ #
    u0, u1 = users[0], users[1]
    emit(u0, pid["wsdbm:friendOf"], u1)
    emit(u0, pid["wsdbm:likes"], products[0])    # C1: friends co-like
    emit(u1, pid["wsdbm:likes"], products[0])
    emit(u1, pid["wsdbm:subscribes"], websites[0])   # L4 tail
    emit(u0, pid["sorg:nationality"], countries[0])  # S5 ∩ S2 witness

    triples = np.concatenate(blocks, axis=0)
    assert triples.max() < np.iinfo(np.int32).max
    store = build_store(triples.astype(np.int32), d)
    named = WatDivNamed(
        product0=int(products[0]), genre0=int(genres[0]),
        country0=int(countries[0]), retailer0=int(retailers[0]),
        website0=int(websites[0]), tag0=int(tags[0]))
    queries, topics = _make_queries(pid, cid, named)
    return WatDivDataset(store=store, dictionary=d, named=named,
                         queries=queries, scale=scale, topics=topics)


# --------------------------------------------------------------------------- #
# The 16-query template workload
# --------------------------------------------------------------------------- #


def _make_queries(pid: Dict[str, int], cid: Dict[str, int],
                  nm: WatDivNamed) -> Tuple[Dict[str, Query],
                                            Dict[str, Tuple[str, ...]]]:
    t = pid["rdf:type"]
    X, Y, Z, W, V1, V2 = (var(i) for i in range(6))

    def q(name: str, shape: str, *pats) -> Query:
        return Query(name=name, patterns=tuple(pats), shape=shape)

    qs = [
        # ---- stars
        q("S1", "star",
          (X, t, cid["wsdbm:Product"]),
          (X, pid["wsdbm:hasGenre"], nm.genre0),
          (X, pid["sorg:caption"], V1)),
        q("S2", "star",
          (X, t, cid["wsdbm:User"]),
          (X, pid["sorg:nationality"], nm.country0),
          (X, pid["foaf:givenName"], V1)),
        q("S3", "star",
          (X, t, cid["gr:Offer"]),
          (X, pid["gr:includes"], nm.product0),
          (X, pid["gr:price"], V1)),
        q("S4", "star",
          (X, t, cid["rev:Review"]),
          (X, pid["rev:ratingValue"], V1),
          (X, pid["rev:reviewer"], Y)),
        q("S5", "star",
          (X, pid["wsdbm:likes"], nm.product0),
          (X, pid["wsdbm:subscribes"], Y),
          (X, pid["foaf:givenName"], V1)),
        # ---- linear paths
        q("L1", "linear",
          (X, pid["wsdbm:follows"], Y),
          (Y, pid["wsdbm:likes"], Z),
          (Z, pid["wsdbm:hasGenre"], W)),
        q("L2", "linear",
          (X, pid["wsdbm:makesPurchase"], Y),
          (Y, pid["wsdbm:purchaseFor"], Z),
          (Z, pid["wsdbm:hasGenre"], nm.genre0)),
        q("L3", "linear",
          (X, pid["gr:offers"], Y),
          (Y, pid["gr:includes"], Z),
          (Z, pid["sorg:caption"], W)),
        q("L4", "linear",
          (X, pid["wsdbm:friendOf"], Y),
          (Y, pid["wsdbm:subscribes"], nm.website0)),
        q("L5", "linear",
          (X, pid["rev:hasReview"], Y),
          (Y, pid["rev:reviewer"], Z),
          (Z, pid["sorg:nationality"], nm.country0)),
        # ---- snowflakes
        q("F1", "snowflake",
          (X, t, cid["wsdbm:Product"]),
          (X, pid["wsdbm:hasGenre"], nm.genre0),
          (X, pid["rev:hasReview"], Y),
          (Y, pid["rev:reviewer"], Z),
          (Z, pid["sorg:nationality"], W)),
        q("F2", "snowflake",
          (X, pid["gr:includes"], Y),
          (X, pid["gr:price"], V1),
          (Y, pid["wsdbm:hasGenre"], Z),
          (Y, pid["sorg:caption"], V2)),
        q("F3", "snowflake",
          (X, pid["wsdbm:likes"], Y),
          (X, pid["sorg:nationality"], nm.country0),
          (Y, pid["rev:hasReview"], Z),
          (Z, pid["rev:ratingValue"], W)),
        # ---- complex
        q("C1", "complex",
          (X, pid["wsdbm:friendOf"], Y),
          (X, pid["wsdbm:likes"], Z),
          (Y, pid["wsdbm:likes"], Z),
          (Z, t, cid["wsdbm:Product"])),
        q("C2", "complex",
          (X, pid["wsdbm:makesPurchase"], Y),
          (Y, pid["wsdbm:purchaseFor"], Z),
          (Z, pid["rev:hasReview"], W),
          (W, pid["rev:reviewer"], X)),
        q("C3", "complex",
          (X, pid["wsdbm:follows"], Y),
          (Y, pid["wsdbm:follows"], Z),
          (X, pid["sorg:nationality"], W),
          (Z, pid["sorg:nationality"], W)),
    ]
    topics = {
        "retail": ("S1", "S3", "L2", "L3", "F2", "C2"),
        "social": ("S2", "S5", "L1", "L4", "C1", "C3"),
        "review": ("S4", "L5", "F1", "F3"),
    }
    return {query.name: query for query in qs}, topics


_CACHE: Dict[Tuple[int, int], WatDivDataset] = {}


def load(scale: int = 1, seed: int = 0) -> WatDivDataset:
    """Memoized generation (the dataset is reused across benchmarks)."""
    key = (scale, seed)
    if key not in _CACHE:
        _CACHE[key] = generate(scale, seed)
    return _CACHE[key]
