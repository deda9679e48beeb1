"""Port of `orientdb_tpu/storage/bigshape.py`: the array-native Person–knows
snapshot (the SF100-shape bench graph), the SNB-shape snapshot of the
config-5 workload (Person–knows with a ``creationDate`` edge column, and
Message–hasCreator), and their exact numpy references.

The same seed gives byte-identical arrays in both packages: the random
draws happen in the reference's order, and the CSR assembly is the
reference's. The ``lat``/``lng`` columns of ``build_person_knows(...,
geo=True)`` are the port's own, from a stream of their own. The returned database holds the schema only, so queries run
on the compiled path; parity comes from `numpy_1hop_count` /
`numpy_2hop_count` / `numpy_config5_count` (exact int64 over the same
arrays), for variable-depth and NOT arms from `numpy_var_depth_rows` /
`numpy_has_out_neighbour`, for edge bindings, OPTIONAL arms and
binding references from the row enumerations at the end of this module,
and for ``distance()`` from `numpy_distance_km` (float64).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from orientdb_tpu_torch.models.database import Database
from orientdb_tpu_torch.storage.snapshot import (
    EdgeClassCSR,
    GraphSnapshot,
    PropertyColumn,
)


def _csr_from_degrees(
    name: str, degrees: np.ndarray, dst: np.ndarray
) -> EdgeClassCSR:
    """Both-direction CSR from per-vertex out-degrees and the dst array in
    out-CSR order: indptr from cumsum, stable in-direction sort, edge ids
    into out order."""
    V = degrees.shape[0]
    csr = EdgeClassCSR(name)
    csr.indptr_out = np.concatenate([[0], np.cumsum(degrees)]).astype(
        np.int32
    )
    csr.dst = dst.astype(np.int32)
    edge_src = np.repeat(np.arange(V, dtype=np.int32), degrees)
    order_in = np.argsort(dst, kind="stable")
    csr.src = edge_src[order_in].astype(np.int32)
    csr.edge_id_in = order_in.astype(np.int32)
    counts_in = np.bincount(dst, minlength=V)
    csr.indptr_in = np.concatenate([[0], np.cumsum(counts_in)]).astype(
        np.int32
    )
    return csr


def build_person_knows(
    n_persons: int,
    avg_knows: int = 10,
    seed: int = 0,
    supernodes: int = 0,
    supernode_degree: int = 0,
    name: str = "bigshape",
    device=None,
    geo: bool = False,
) -> Tuple[Database, GraphSnapshot]:
    """A Person–knows graph as (schema-only Database, attached snapshot).

    Properties: ``uid`` (dense id) and ``age`` (18–79) on Person.
    ``supernodes`` plants that many vertices of out-degree
    ``supernode_degree`` on top of the Poisson base. ``geo`` adds float32
    ``lat`` (uniform on (-85, 85)) and ``lng`` (on (-180, 180)), each about
    2 % absent, drawn from a stream of their own (`geo_rng`), so every other
    array is the same as without them. ``device`` is the database's (the
    card unless the caller asks for the CPU)."""
    rng = np.random.default_rng(seed)
    db = Database(name, device=device)
    db.schema.create_vertex_class("Person")
    db.schema.create_edge_class("knows")

    V = int(n_persons)
    degrees = rng.poisson(avg_knows, V).astype(np.int64)
    if supernodes > 0:
        hubs = np.linspace(0, V - 1, supernodes, dtype=np.int64)
        degrees[hubs] = supernode_degree
    E = int(degrees.sum())
    dst = rng.integers(0, V, E, dtype=np.int64)
    csr = _csr_from_degrees("knows", degrees, dst)

    snap = GraphSnapshot()
    snap.num_vertices = V
    person_cluster = db.schema.get_class("Person").cluster_ids[0]
    snap.v_cluster = np.full(V, person_cluster, np.int32)
    snap.v_position = np.arange(V, dtype=np.int32)
    all_classes = sorted(db.schema.classes(), key=lambda c: c.name)
    snap.class_names = [c.name for c in all_classes]
    snap.class_id_of = {c.name.lower(): i for i, c in enumerate(all_classes)}
    snap.v_class = np.full(V, snap.class_id_of["person"], np.int32)
    for c in all_classes:
        closure = [
            snap.class_id_of[s.name.lower()]
            for s in c.subclasses(include_self=True)
        ]
        snap.class_closure[c.name.lower()] = np.array(sorted(closure), np.int32)
    for c in all_classes:
        if c.is_vertex_type and not c.abstract:
            snap.class_vertex_range[c.name.lower()] = (
                (0, V) if c.name == "Person" else (0, 0)
            )
    ones = np.ones(V, bool)
    snap.v_columns = {
        "uid": PropertyColumn(
            "uid", "int", np.arange(V, dtype=np.int32), ones
        ),
        "age": PropertyColumn(
            "age", "int", rng.integers(18, 80, V, dtype=np.int32), ones
        ),
    }
    if geo:
        grng = geo_rng(seed)
        for cname, lim in (("lat", 85.0), ("lng", 180.0)):
            vals = grng.uniform(-lim, lim, V).astype(np.float32)
            snap.v_columns[cname] = PropertyColumn(cname, "float", vals, grng.random(V) >= 0.02)
    snap.edge_classes["knows"] = csr
    for c in all_classes:
        if c.is_edge_type:
            snap.edge_closure[c.name.lower()] = sorted(
                s.name
                for s in c.subclasses(include_self=True)
                if s.name in snap.edge_classes
            )
    db.attach_snapshot(snap)
    return db, snap


def geo_rng(seed: int) -> np.random.Generator:
    """The ``lat``/``lng`` draws' own stream (apart from the graph's)."""
    return np.random.default_rng([seed, 0x6E0])


def build_snb_shape(
    n_persons: int,
    msgs_per_person: int = 2,
    avg_knows: int = 10,
    seed: int = 0,
    name: str = "snbshape",
    device=None,
) -> Tuple[Database, GraphSnapshot]:
    """The LDBC SNB interactive shape at array scale, config 5's graph:

    - Person–knows–Person, ``avg_knows`` Poisson out-degree, with a
      ``creationDate`` edge column (ints 10000–19999 by edge id);
    - Message–hasCreator–Person, one creator a message; messages follow
      the persons in the vertex index space;
    - ``uid`` on every vertex, ``age`` (18–79) on persons only and
      ``length`` (1–1999) on messages only, with presence masks.

    The reference's record ids (``v_cluster``, ``v_position``,
    ``rid_to_idx``) are not built: the port has no RIDs."""
    rng = np.random.default_rng(seed)
    db = Database(name, device=device)
    db.schema.create_vertex_class("Person")
    db.schema.create_vertex_class("Message")
    db.schema.create_edge_class("knows")
    db.schema.create_edge_class("hasCreator")

    P = int(n_persons)
    M = P * int(msgs_per_person)
    V = P + M  # persons [0, P), messages [P, V)

    deg = np.zeros(V, np.int64)
    deg[:P] = rng.poisson(avg_knows, P)
    E = int(deg.sum())
    dst = rng.integers(0, P, E, dtype=np.int64)  # always a Person
    knows = _csr_from_degrees("knows", deg, dst)
    knows.edge_columns = {
        "creationDate": PropertyColumn(
            "creationDate",
            "int",
            rng.integers(10_000, 20_000, E, dtype=np.int32),
            np.ones(E, bool),
        ),
    }

    hc_deg = np.zeros(V, np.int64)
    hc_deg[P:] = 1
    creators = rng.integers(0, P, M, dtype=np.int64)
    hc = _csr_from_degrees("hasCreator", hc_deg, creators)

    snap = GraphSnapshot()
    snap.num_vertices = V
    pc = db.schema.get_class("Person").cluster_ids[0]
    mc = db.schema.get_class("Message").cluster_ids[0]
    snap.v_cluster = np.concatenate(
        [np.full(P, pc, np.int32), np.full(M, mc, np.int32)]
    )
    snap.v_position = np.concatenate(
        [np.arange(P, dtype=np.int32), np.arange(M, dtype=np.int32)]
    )
    all_classes = sorted(db.schema.classes(), key=lambda c: c.name)
    snap.class_names = [c.name for c in all_classes]
    snap.class_id_of = {c.name.lower(): i for i, c in enumerate(all_classes)}
    snap.v_class = np.concatenate(
        [
            np.full(P, snap.class_id_of["person"], np.int32),
            np.full(M, snap.class_id_of["message"], np.int32),
        ]
    )
    for c in all_classes:
        closure = [
            snap.class_id_of[s.name.lower()]
            for s in c.subclasses(include_self=True)
        ]
        snap.class_closure[c.name.lower()] = np.array(sorted(closure), np.int32)
    ranges = {"person": (0, P), "message": (P, V)}
    for c in all_classes:
        if c.is_vertex_type and not c.abstract:
            snap.class_vertex_range[c.name.lower()] = ranges.get(c.name.lower(), (0, 0))

    person_pres = np.zeros(V, bool)
    person_pres[:P] = True
    age = np.zeros(V, np.int32)
    age[:P] = rng.integers(18, 80, P, dtype=np.int32)
    length = np.zeros(V, np.int32)
    length[P:] = rng.integers(1, 2000, M, dtype=np.int32)
    snap.v_columns = {
        "uid": PropertyColumn("uid", "int", np.arange(V, dtype=np.int32), np.ones(V, bool)),
        "age": PropertyColumn("age", "int", age, person_pres),
        "length": PropertyColumn("length", "int", length, ~person_pres),
    }
    snap.edge_classes["knows"] = knows
    snap.edge_classes["hasCreator"] = hc
    for c in all_classes:
        if c.is_edge_type:
            snap.edge_closure[c.name.lower()] = sorted(
                s.name
                for s in c.subclasses(include_self=True)
                if s.name in snap.edge_classes
            )
    db.attach_snapshot(snap)
    return db, snap


def _seg_sum(vals: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    tot = np.concatenate([[0], np.cumsum(vals, dtype=np.int64)])
    return tot[indptr[1:].astype(np.int64)] - tot[indptr[:-1].astype(np.int64)]


def numpy_1hop_count(snap: GraphSnapshot, src_mask, dst_mask) -> int:
    """count of (p, f) pairs with src_mask[p] and dst_mask[f]."""
    csr = snap.edge_classes["knows"]
    w1 = _seg_sum(dst_mask[csr.dst].astype(np.int64), csr.indptr_out)
    return int((w1 * src_mask.astype(np.int64)).sum())


def numpy_2hop_count(snap: GraphSnapshot, src_mask, mid_mask, dst_mask) -> int:
    """count of (p, f, g) paths with the three masks applied."""
    csr = snap.edge_classes["knows"]
    w2 = _seg_sum(dst_mask[csr.dst].astype(np.int64), csr.indptr_out)
    w1 = _seg_sum((mid_mask[csr.dst] * w2[csr.dst]).astype(np.int64), csr.indptr_out)
    return int((w1 * src_mask.astype(np.int64)).sum())


def _sorted(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(rows.T[::-1])]


def _neighbours(indptr: np.ndarray, nbrs: np.ndarray, vs: np.ndarray) -> np.ndarray:
    """Concatenated CSR slices of the vertices ``vs``."""
    ip = indptr.astype(np.int64)
    deg = ip[vs + 1] - ip[vs]
    first = np.repeat(ip[vs] - (np.cumsum(deg) - deg), deg)
    return nbrs[first + np.arange(int(deg.sum()))].astype(np.int64)


def numpy_var_depth_rows(
    snap: GraphSnapshot,
    roots,
    direction: str,
    node_mask: np.ndarray,
    max_depth: Optional[int] = None,
    while_depth: Optional[int] = None,
    while_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Sorted int64 ``(root, vertex, depth)`` rows of a variable-depth
    ``knows`` arm: a breadth-first walk from each root (``direction`` out,
    in or both) that emits every vertex passing ``node_mask`` at its
    minimum discovery depth, the root at depth 0; the walk expands level
    ``d`` only while ``d < max_depth`` and, for the WHILE condition
    ``$depth < while_depth AND while_mask``, only the level's vertices that
    pass it."""
    csr = snap.edge_classes["knows"]
    sides = {"out": [(csr.indptr_out, csr.dst)], "in": [(csr.indptr_in, csr.src)]}
    sides["both"] = sides["out"] + sides["in"]
    out = []
    for r in roots:
        frontier = np.array([r], np.int64)
        seen = frontier
        depth = 0
        while frontier.size:
            keep = frontier[node_mask[frontier]]
            out.append(np.stack([np.full(keep.size, r), keep, np.full(keep.size, depth)], 1))
            if max_depth is not None and depth >= max_depth:
                break
            if while_depth is not None and depth >= while_depth:
                break
            grow = frontier if while_mask is None else frontier[while_mask[frontier]]
            reached = np.concatenate([_neighbours(ip, nb, grow) for ip, nb in sides[direction]])
            frontier = np.setdiff1d(np.unique(reached), seen)
            seen = np.union1d(seen, frontier)
            depth += 1
    return _sorted(np.concatenate(out) if out else np.zeros((0, 3), np.int64))


def numpy_has_out_neighbour(snap: GraphSnapshot, mask: np.ndarray) -> np.ndarray:
    """bool [V]: the vertex has a ``knows`` out-neighbour passing ``mask``
    (a NOT arm ``{as:x}-knows->{where:(...)}``)."""
    csr = snap.edge_classes["knows"]
    return _seg_sum(mask[csr.dst].astype(np.int64), csr.indptr_out) > 0


def numpy_config5_count(snap: GraphSnapshot, d_cut: int) -> int:
    """Exact count of the config-5 multi-pattern MATCH:

        MATCH {class:Person, as:p, where:(age > 40)}
              .outE('knows'){where:(creationDate > d_cut)}
              .inV(){as:f, where:(age < 30)},
              {class:Message, as:m}-hasCreator->{as:f}
        RETURN count(*)

    = Σ over knows edges (p→f) passing the vertex and edge predicates of
    the number of messages whose creator is f."""
    knows = snap.edge_classes["knows"]
    hc = snap.edge_classes["hasCreator"]
    age_col = snap.v_columns["age"]
    age, pres = age_col.values, age_col.present
    cdate = knows.edge_columns["creationDate"].values
    msg_cnt = np.diff(hc.indptr_in).astype(np.int64)  # messages per person
    dst = knows.dst
    w = ((age[dst] < 30) & pres[dst] & (cdate > d_cut)).astype(np.int64) * msg_cnt[dst]
    per_src = _seg_sum(w, knows.indptr_out)
    src_mask = ((age > 40) & pres).astype(np.int64)
    return int((per_src * src_mask).sum())


def numpy_config5_counts(snap: GraphSnapshot, d_cuts) -> List[int]:
    """`numpy_config5_count` at every cut of ``d_cuts`` from one pass: each
    knows edge's weight (the terms of that count without the
    ``creationDate > d_cut`` factor) summed by creation date, then a suffix
    sum over the dates past each cut."""
    knows = snap.edge_classes["knows"]
    hc = snap.edge_classes["hasCreator"]
    age_col = snap.v_columns["age"]
    age, pres = age_col.values, age_col.present
    cdate = knows.edge_columns["creationDate"].values
    msg_cnt = np.diff(hc.indptr_in).astype(np.int64)
    dst = knows.dst
    src_ok = np.repeat((age > 40) & pres, np.diff(knows.indptr_out))
    w = ((age[dst] < 30) & pres[dst] & src_ok).astype(np.int64) * msg_cnt[dst]
    by_date = np.bincount(cdate, weights=w).astype(np.int64)  # exact: integer sums < 2^53
    after = np.concatenate([np.cumsum(by_date[::-1])[::-1], [0]])  # after[d] = sum over dates >= d
    return [int(after[min(max(int(d) + 1, 0), len(by_date))]) for d in d_cuts]


# ---------------------------------------------------------------------------
# row enumerations of the ``knows`` edges of the persons 0..n-1 (uid = index)
# ---------------------------------------------------------------------------


def _slices(indptr: np.ndarray, vs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(owner, CSR position) of every slot of the vertices ``vs``'s CSR
    slices, in order."""
    ip = indptr.astype(np.int64)
    deg = ip[vs + 1] - ip[vs]
    owner = np.repeat(vs, deg)
    first = np.repeat(ip[vs] - (np.cumsum(deg) - deg), deg)
    return owner, first + np.arange(int(deg.sum()))


def numpy_out_edge_rows(snap: GraphSnapshot, n: int, d_cut: int, dst_mask) -> np.ndarray:
    """Sorted ``(p, f, creationDate)`` of the out edges p→f of the persons
    p < n with ``creationDate > d_cut`` and ``dst_mask[f]``: the rows of
    ``{as:p}.outE('knows'){as:e, where:(creationDate > d)}.inV(){as:f}``."""
    csr = snap.edge_classes["knows"]
    cd = csr.edge_columns["creationDate"].values
    p, e = _slices(csr.indptr_out, np.arange(n))
    f = csr.dst[e].astype(np.int64)
    keep = (cd[e] > d_cut) & dst_mask[f]
    return _sorted(np.stack([p[keep], f[keep], cd[e][keep].astype(np.int64)], 1))


def numpy_incident_rows(snap: GraphSnapshot, n: int) -> np.ndarray:
    """Sorted ``(p, v)`` of ``{as:p}.bothE('knows'){as:e}, {as:e}.bothV(){as:v}``
    for p < n: each edge at p (out, then in) gives its source and its
    target."""
    csr = snap.edge_classes["knows"]
    po, eo = _slices(csr.indptr_out, np.arange(n))
    pi, ei = _slices(csr.indptr_in, np.arange(n))
    src = np.concatenate([po, csr.src[ei].astype(np.int64)])
    tgt = np.concatenate([csr.dst[eo].astype(np.int64), pi])
    p = np.concatenate([po, pi])
    return _sorted(np.stack([np.concatenate([p, p]), np.concatenate([src, tgt])], 1))


def numpy_undirected_rows(snap: GraphSnapshot, n: int) -> np.ndarray:
    """``(p, f, creationDate)`` of ``{as:p}-knows{as:kn}-{as:f}`` for p < n
    (each edge at p, either direction), in the query's ORDER BY cd DESC,
    f ASC, ties by p."""
    csr = snap.edge_classes["knows"]
    cd = csr.edge_columns["creationDate"].values
    po, eo = _slices(csr.indptr_out, np.arange(n))
    pi, ei = _slices(csr.indptr_in, np.arange(n))
    p = np.concatenate([po, pi])
    f = np.concatenate([csr.dst[eo], csr.src[ei]]).astype(np.int64)
    c = np.concatenate([cd[eo], cd[csr.edge_id_in[ei]]]).astype(np.int64)
    order = np.lexsort((p, f, -c))
    return np.stack([p, f, c], 1)[order]


def numpy_optional_rows(snap: GraphSnapshot, n: int, dst_mask) -> np.ndarray:
    """Sorted ``(p, f)`` of ``{as:p}-knows->{as:f, optional:true}`` for
    p < n with the target admitted by ``dst_mask``: the matches, and
    ``(p, -1)`` for each p with none."""
    csr = snap.edge_classes["knows"]
    p, e = _slices(csr.indptr_out, np.arange(n))
    f = csr.dst[e].astype(np.int64)
    keep = dst_mask[f]
    lonely = np.setdiff1d(np.arange(n), p[keep])
    rows = np.concatenate(
        [np.stack([p[keep], f[keep]], 1), np.stack([lonely, np.full(lonely.size, -1)], 1)]
    )
    return _sorted(rows)


def numpy_probe_rows(snap: GraphSnapshot, n: int, d_cut: int) -> np.ndarray:
    """Sorted ``(p, f, probe)`` of the IS7 shape
    ``{as:p}-knows->{as:f, where:(age < p.age)},
    {as:f}-knows{as:kn, optional:true, where:(creationDate > d)}-{as:p}``
    for p < n: each first-arm row (p, f) repeats once for every knows edge
    between f and p, either direction, with ``creationDate > d_cut`` (probe
    1), or appears once with probe 0 when there is none."""
    csr = snap.edge_classes["knows"]
    cd = csr.edge_columns["creationDate"].values
    age = snap.v_columns["age"].values
    p_all, e = _slices(csr.indptr_out, np.arange(n))
    f = csr.dst[e].astype(np.int64)
    keep = age[f] < age[p_all]
    p, f = p_all[keep], f[keep]
    V = np.int64(snap.num_vertices)
    # the hot edges p→x at the persons p, keyed (p, x), and the hot edges
    # f→x at the targets f, keyed (x, f): both name the pair (p, f)
    hot_p = cd[e] > d_cut
    fu = np.unique(f)
    fo, fe = _slices(csr.indptr_out, fu)
    hot_f = cd[fe] > d_cut
    keys = np.concatenate(
        [
            p_all[hot_p] * V + csr.dst[e][hot_p],
            csr.dst[fe][hot_f].astype(np.int64) * V + fo[hot_f],
        ]
    )
    keys, counts = np.unique(keys, return_counts=True)
    want = p * V + f
    at = np.clip(np.searchsorted(keys, want), 0, max(keys.size - 1, 0))
    k = np.where(keys[at] == want, counts[at], 0) if keys.size else np.zeros(p.size, np.int64)
    reps = np.maximum(k, 1)
    rows = np.stack([np.repeat(p, reps), np.repeat(f, reps), np.repeat((k > 0).astype(np.int64), reps)], 1)
    return _sorted(rows)


def numpy_distance_km(lat1, lon1, lat2, lon2) -> np.ndarray:
    """The haversine in float64 over degrees (the reference's formula,
    `orientdb_tpu/utils/geo.py`), km."""
    lat1, lon1, lat2, lon2 = (np.radians(np.asarray(x, np.float64)) for x in (lat1, lon1, lat2, lon2))
    h = np.sin((lat2 - lat1) / 2) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin((lon2 - lon1) / 2) ** 2
    return 2.0 * 6371.0 * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))
