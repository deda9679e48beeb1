"""Port of `orientdb_tpu/storage/deltas.py`: delta maintenance of a resident
snapshot. Writes land in place on the card instead of a new snapshot and a
whole re-upload.

- **Append slabs**: `pad_for_deltas` grows a snapshot, before its first
  upload, with spare vertex rows (class -1) and per-edge-class spare edge
  slots (-1 endpoints, ``live`` False), and bucket tables that index the
  slab's edges by endpoint. New vertices and edges land in slab slots; the
  compiled path reads the slab beside the base CSR (`exec/tpu_engine`:
  K18 `slab_probe`, K17 `slab_scan`, the ``live`` mask of the bitmap hops).
- **Patch batches**: `SnapshotMaintainer.apply_batch` takes a write batch as
  the reference's CDC event dicts (``op``, ``rid``, ``class``, ``record``
  with ``@out`` / ``@in`` for edges), patches the host arrays, and ships the
  changed cells as per-key index/value segments that K16 `scatter_set`
  writes into the resident tensors in place
  (`ops/device_graph.DeviceGraph.apply_patches`). A captured replay holds
  the tensors' pointers, so it sees the patch without a re-capture; the
  bytes uploaded are bounded by the delta, not the graph.
- **Patch order**: the three phases DEAD, DATA and LIVE run in that order
  on the replay stream. Deletes flip liveness (``v_class`` -1, edge ``live``
  False) before clearing endpoint data; inserts write their data before
  flipping liveness on. A replay queued before a batch sees the old
  records and one queued after it the new ones, never half a record.
- **Plan generations**: the first topology delta, a dictionary append and
  a bucket overflow bump the overlay's ``plan_gen`` and clear the plan
  cache; a plan picked before the bump re-records at its next dispatch. A
  DATA-only batch (column updates) leaves it, and cached plans replay the
  same graphs on the new values.

Unsupported deltas poison the overlay: a full slab, an edge whose endpoint
is not in the snapshot, new columnar properties, type changes, unknown
classes. As the reference's maintainer does, `apply_batch` then compacts
before it returns (`SnapshotMaintainer.compact`), and also once the worst
slab fill or the dead fraction reaches ``config.delta_compact_ratio``. The
port has no records to rebuild from, but its host arrays are the whole
truth (each patch lands there before it ships), so a compaction folds them
into a clean snapshot: the live vertex rows in the reference's rebuild
order, each edge class's live base and slab slots as a clean CSR, re-padded
and swapped in once the replays queued on the old snapshot have run. The
batch's remaining events then apply to the fresh overlay; an edge whose
endpoint is gone is dropped there, as the reference's rebuild drops a
dangling edge, and an event a fresh overlay cannot take either raises. A
compiled query on an overlay that is poisoned and not yet compacted (a
caller that patched around `apply_batch`) raises `Uncompilable` with the
reason. String columns take new dictionary entries by appending (equality
stays exact; ordered compares refuse to compile, `ops/predicates`); a
compaction keeps the dictionaries as they are.
"""

from __future__ import annotations

import base64
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from orientdb_tpu_torch.models.rid import RID
from orientdb_tpu_torch.ops.device_graph import cached_device_graph, release_device_graph
from orientdb_tpu_torch.ops.replay_stream import REPLAY_LOCK, on_replay_stream, replay_resources
from orientdb_tpu_torch.storage.snapshot import (
    MISSING_FLOAT,
    MISSING_INT,
    GraphSnapshot,
    PropertyColumn,
    RidIndex,
)
from orientdb_tpu_torch.utils.config import config


class DeltaUnsupported(Exception):
    """An event the overlay cannot apply on the card: the overlay is
    poisoned."""


class _DanglingEdge(DeltaUnsupported):
    """An edge create whose endpoint is not a live vertex of the snapshot:
    it poisons the overlay, and a compaction drops it (the reference's
    rebuild drops dangling edges)."""


class _EdgeSlab:
    """Per-edge-class slab bookkeeping (host side)."""

    __slots__ = ("base", "cap", "next_slot", "dead", "_rid_pos", "_in_pos")

    def __init__(self, base: int, cap: int) -> None:
        self.base = base  # base CSR edge count (the slab starts here)
        self.cap = cap  # padded edge array length
        self.next_slot = base  # next free absolute slot
        self.dead = 0  # tombstoned edges (base + slab)
        self._rid_pos: Optional[RidIndex] = None  # lazy edge RID → slot
        self._in_pos: Optional[np.ndarray] = None  # out pos → in pos

    def rid_pos(self, csr) -> RidIndex:
        m = self._rid_pos
        if m is None:
            m = self._rid_pos = RidIndex(csr.e_cluster, csr.e_position)
        return m

    def in_pos(self, csr) -> np.ndarray:
        inv = self._in_pos
        if inv is None:
            inv = np.full(self.cap, -1, np.int64)
            ids = np.asarray(csr.edge_id_in[: self.base], np.int64)
            inv[ids] = np.arange(self.base, dtype=np.int64)
            self._in_pos = inv
        return inv


class SnapshotOverlay:
    """Delta bookkeeping for one capacity-padded snapshot."""

    def __init__(self, snap: GraphSnapshot, base_vertices: int) -> None:
        self.snap = snap
        self.base_vertices = base_vertices  # live rows at build
        self.cap_vertices = snap.num_vertices  # padded universe
        self.next_v_slot = base_vertices
        self.dead_vertices = 0
        self.edge_slabs: Dict[str, _EdgeSlab] = {}
        #: plans recorded clean (count pushdown, no slab read) must not
        #: replay over dirty topology: the first topology delta bumps the
        #: generation
        self.topology_dirty = False
        self.plan_gen = 0
        #: bumped once per applied batch: a TRAVERSE replay, static by
        #: construction (its roots and level counts are baked), re-records
        #: when any batch landed since its recording
        self.data_version = 0
        self.applied_events = 0
        self.upload_bytes = 0
        #: why the overlay can no longer track the writes (None: healthy)
        self.poisoned: Optional[str] = None
        #: per class, flat [NB*BK] tables of RELATIVE slab slots keyed by
        #: endpoint & (NB-1), host mirrors of ``bk:{class}:{dir}``
        self.bk: Dict[str, Dict[str, np.ndarray]] = {}
        self.bk_nb = 0
        self.bk_bk = 0
        #: classes one of whose buckets filled: their plans scan the slab
        #: window (K17) instead of probing buckets (K18)
        self.bucket_overflow: set = set()

    # -- state transitions --------------------------------------------------

    def mark_topology_dirty(self) -> None:
        if not self.topology_dirty:
            self.topology_dirty = True
            self.bump_plan_gen()

    def bump_plan_gen(self) -> None:
        """Invalidate every plan recorded under the previous structure:
        the plan cache is cleared, and plans picked already fail their
        generation check at dispatch (and re-record)."""
        self.plan_gen += 1
        cache = getattr(self.snap, "_plan_cache", None)
        if cache is not None:
            cache.clear()

    def poison(self, reason: str) -> None:
        if self.poisoned is None:
            self.poisoned = reason

    # -- geometry -----------------------------------------------------------

    def edge_base(self, class_name: str) -> int:
        return self.edge_slabs[class_name].base

    def bucket_add(self, cname: str, src: int, dst: int, rel: int, patches=None) -> None:
        """Index a freshly appended slab edge (relative slot ``rel``) under
        both endpoints' buckets. A full bucket switches the class to the
        window scan (and re-records its plans); tombstones need no removal,
        since the expansion ANDs the live mask."""
        t = self.bk.get(cname)
        if t is None or cname in self.bucket_overflow:
            return
        nb, bk = self.bk_nb, self.bk_bk
        for tab, fill, key_v, dev in (
            (t["out"], t["fill_out"], src, f"bk:{cname}:out"),
            (t["in"], t["fill_in"], dst, f"bk:{cname}:in"),
        ):
            b = int(key_v) & (nb - 1)
            n = int(fill[b])
            if n >= bk:
                self.bucket_overflow.add(cname)
                self.bump_plan_gen()
                return
            slot = b * bk + n
            tab[slot] = rel
            fill[b] = n + 1
            if patches is not None:
                patches.add(_PH_DATA, dev, slot, np.int32(rel))

    def slab_fill(self) -> float:
        """Worst-case slab occupancy (the vertex slab and every edge slab)."""
        fills = []
        vcap = self.cap_vertices - self.base_vertices
        if vcap > 0:
            fills.append((self.next_v_slot - self.base_vertices) / vcap)
        for slab in self.edge_slabs.values():
            ecap = slab.cap - slab.base
            if ecap > 0:
                fills.append((slab.next_slot - slab.base) / ecap)
        return max(fills) if fills else 0.0

    def dead_fraction(self) -> float:
        """The larger of the deleted share of the base vertices and, per edge
        class, the tombstoned share of the slots used (the reference's
        second compaction trigger)."""
        v = self.dead_vertices / max(1, self.base_vertices)
        e = max((s.dead / max(1, s.next_slot) for s in self.edge_slabs.values()), default=0.0)
        return max(v, e)

    def stats(self) -> Dict:
        return {
            "base_vertices": self.base_vertices,
            "cap_vertices": self.cap_vertices,
            "slab_vertices": self.next_v_slot - self.base_vertices,
            "dead_vertices": self.dead_vertices,
            "slab_edges": {c: s.next_slot - s.base for c, s in self.edge_slabs.items()},
            "slab_fill": round(self.slab_fill(), 4),
            "dead_fraction": round(self.dead_fraction(), 4),
            "topology_dirty": self.topology_dirty,
            "plan_gen": self.plan_gen,
            "applied_events": self.applied_events,
            "upload_bytes": self.upload_bytes,
            "poisoned": self.poisoned,
            "bucket_overflow": sorted(self.bucket_overflow),
        }


# ---------------------------------------------------------------------------
# capacity padding
# ---------------------------------------------------------------------------


def _pad1(arr: np.ndarray, n: int, fill) -> np.ndarray:
    if arr.shape[0] >= n:
        return arr
    pad = np.full(n - arr.shape[0], fill, arr.dtype)
    return np.concatenate([arr, pad])


def _pad_column(col: PropertyColumn, n: int) -> None:
    fill = MISSING_FLOAT if col.kind == "float" else MISSING_INT
    col.values = _pad1(col.values, n, fill)
    col.present = _pad1(col.present.astype(bool), n, False)


def pad_for_deltas(
    snap: GraphSnapshot,
    spare_vertices: int = 1024,
    spare_edges: int = 4096,
) -> SnapshotOverlay:
    """Grow a snapshot with slab capacity and attach a `SnapshotOverlay`.
    Spare vertex rows carry class -1 (excluded by every class mask and by
    the armed liveness conjunct); spare edge slots carry -1 endpoints and
    ``live`` False; the bucket tables have ``bk_bk = 8`` slots in each of
    ``bk_nb = max(256, 2^(bitlen(se - 1) - 2))`` buckets (about twice the
    slab), per class and direction.

    Must run before the snapshot's first device upload: the padded host
    arrays are what reaches the card. A tiered snapshot refuses."""
    if cached_device_graph(snap) is not None:
        raise ValueError("pad_for_deltas must run before device upload")
    if snap._overlay is not None:
        raise ValueError("snapshot is already padded for deltas")
    if snap._tier is not None:
        raise ValueError(
            "tiered snapshots are immutable: delta maintenance needs the flat "
            "resident edge arrays — raise tier_hbm_cap_bytes to detach the tier"
        )
    sv = max(1, int(spare_vertices))
    se = max(1, int(spare_edges))
    base_v = snap.num_vertices
    cap_v = base_v + sv
    snap.v_cluster = _pad1(snap.v_cluster, cap_v, -1)
    snap.v_position = _pad1(snap.v_position, cap_v, -1)
    snap.v_class = _pad1(snap.v_class, cap_v, -1)
    for col in snap.v_columns.values():
        _pad_column(col, cap_v)
    snap.num_vertices = cap_v
    snap._rid_index = None
    ov = SnapshotOverlay(snap, base_v)
    for cname, csr in snap.edge_classes.items():
        base_e = int(csr.dst.shape[0])
        cap_e = base_e + se
        # indptr over the padded universe: slab rows have zero degree in
        # the base CSR (the slab is read separately)
        csr.indptr_out = _pad1(csr.indptr_out, cap_v + 1, csr.indptr_out[-1])
        csr.indptr_in = _pad1(csr.indptr_in, cap_v + 1, csr.indptr_in[-1])
        # the edge list padded with -1 endpoints; edge_src materialised now
        # so that the padded form is what reaches the card
        csr._edge_src = _pad1(csr.edge_src, cap_e, -1)
        csr.dst = _pad1(csr.dst, cap_e, -1)
        csr.src = _pad1(csr.src, cap_e, -1)
        csr.edge_id_in = _pad1(csr.edge_id_in, cap_e, -1)
        csr.live = np.concatenate([np.ones(base_e, bool), np.zeros(cap_e - base_e, bool)])
        none = np.full(base_e, -1, np.int32)
        csr.e_cluster = _pad1(none if csr.e_cluster is None else csr.e_cluster, cap_e, -1)
        csr.e_position = _pad1(none if csr.e_position is None else csr.e_position, cap_e, -1)
        for col in csr.edge_columns.values():
            _pad_column(col, cap_e)
        ov.edge_slabs[cname] = _EdgeSlab(base_e, cap_e)
    ov.bk_bk = 8
    ov.bk_nb = max(256, 1 << max(0, (se - 1).bit_length() - 2))
    for cname in snap.edge_classes:
        ov.bk[cname] = {
            "out": np.full(ov.bk_nb * ov.bk_bk, -1, np.int32),
            "in": np.full(ov.bk_nb * ov.bk_bk, -1, np.int32),
            "fill_out": np.zeros(ov.bk_nb, np.int32),
            "fill_in": np.zeros(ov.bk_nb, np.int32),
        }
    snap._overlay = ov
    return ov


# ---------------------------------------------------------------------------
# compaction: the fold of an armed snapshot into a clean one
# ---------------------------------------------------------------------------


def _folded_column(col: PropertyColumn, take: np.ndarray) -> Dict:
    return {
        "kind": col.kind,
        "values": col.values[take],
        "present": col.present[take],
        "dictionary": col.dictionary,
    }


def fold_snapshot(snap: GraphSnapshot, schema) -> GraphSnapshot:
    """The clean snapshot an armed ``snap`` stands for: what the reference's
    compaction rebuilds from its records (`build_snapshot`,
    orientdb_tpu/storage/snapshot.py:479), folded from the host arrays.

    Vertices: the live rows (class >= 0) in RID order (cluster, then
    position), so that each class is one contiguous range again; each
    class's range is the reference's (its clusters' span in the sorted
    clusters). Edges, per class: the live base and slab slots, endpoints
    renumbered, in out order by source and then by edge RID (the
    reference's browse order; slot order without edge RIDs), the in CSR by
    a stable sort of the targets. Columns, RIDs, dictionaries and the class
    tables carry over as they are. The result is unpadded and has no
    overlay: `pad_for_deltas` arms it."""
    from orientdb_tpu_torch.carry import snapshot_of_arrays

    ov = snap._overlay
    if ov is None:
        raise ValueError("fold_snapshot: the snapshot is not padded for deltas")
    live = np.flatnonzero(snap.v_class >= 0)
    rows = live[np.lexsort((live, snap.v_position[live], snap.v_cluster[live]))]
    V = int(rows.shape[0])
    new_of = np.full(snap.num_vertices, -1, np.int64)
    new_of[rows] = np.arange(V, dtype=np.int64)
    v_cluster = snap.v_cluster[rows]
    ranges = {}
    for name in snap.class_vertex_range:
        cls = schema.get_class(name)
        ids = list(cls.cluster_ids) if cls is not None else []
        if ids:
            lo = int(np.searchsorted(v_cluster, min(ids), "left"))
            hi = int(np.searchsorted(v_cluster, max(ids), "right"))
            ranges[name] = (lo, hi)
        else:
            ranges[name] = (0, 0)
    edges = {}
    for cname, csr in snap.edge_classes.items():
        used = ov.edge_slabs[cname].next_slot
        slots = np.flatnonzero(csr.live[:used])
        src = new_of[csr.edge_src[slots]]
        dst = new_of[csr.dst[slots]]
        if slots.size and (src.min() < 0 or dst.min() < 0):
            raise ValueError(f"fold_snapshot: a live {cname} edge has a deleted endpoint")
        ec, ep = csr.e_cluster[slots], csr.e_position[slots]
        if slots.size and ec.min() >= 0:
            order = np.lexsort((ep, ec, src))
        else:
            order = np.argsort(src, kind="stable")
        take = slots[order]
        src_o, dst_o = src[order], dst[order]
        order_in = np.argsort(dst_o, kind="stable")
        edges[cname] = {
            "indptr_out": np.concatenate([[0], np.cumsum(np.bincount(src_o, minlength=V))]),
            "dst": dst_o,
            "indptr_in": np.concatenate([[0], np.cumsum(np.bincount(dst_o, minlength=V))]),
            "src": src_o[order_in],
            "edge_id_in": order_in,
            "columns": {n: _folded_column(c, take) for n, c in csr.edge_columns.items()},
            "non_columnar": sorted(csr.non_columnar),
            "e_cluster": csr.e_cluster[take],
            "e_position": csr.e_position[take],
        }
    folded = snapshot_of_arrays(
        {
            "num_vertices": V,
            "v_class": snap.v_class[rows],
            "v_cluster": v_cluster,
            "v_position": snap.v_position[rows],
            "class_names": snap.class_names,
            "class_id_of": snap.class_id_of,
            "class_closure": snap.class_closure,
            "class_vertex_range": ranges,
            "edge_closure": snap.edge_closure,
            "v_columns": {n: _folded_column(c, rows) for n, c in snap.v_columns.items()},
            "v_non_columnar": sorted(snap.v_non_columnar),
            "edge_classes": edges,
        }
    )
    # a dictionary the maintainer appended to stays unsorted
    for cols, new in [(snap.v_columns, folded.v_columns)] + [
        (csr.edge_columns, folded.edge_classes[c].edge_columns) for c, csr in snap.edge_classes.items()
    ]:
        for n, col in cols.items():
            new[n].dict_unsorted = col.dict_unsorted
    return folded


# ---------------------------------------------------------------------------
# the maintainer
# ---------------------------------------------------------------------------

#: patch phases: deletes flip liveness first, inserts flip it last
_PH_DEAD, _PH_DATA, _PH_LIVE = 0, 1, 2


class _PatchSet:
    """One batch's scatter segments: ONE (phase, value) cell per (device
    key, index), the last write winning, emitted into each cell's final
    phase. Without it two events of a batch touching one cell would scatter
    a repeated index with two values, and a create followed by a delete in
    the same batch would come back to life (the insert's LIVE flip landing
    after the delete's DEAD one)."""

    def __init__(self) -> None:
        self._cells: Dict[str, Dict[int, Tuple[int, object]]] = {}

    def add(self, phase: int, key: str, idx: int, val) -> None:
        self._cells.setdefault(key, {})[int(idx)] = (phase, val)

    def empty(self) -> bool:
        return not self._cells

    @property
    def phases(self) -> List[Dict[str, Tuple[np.ndarray, np.ndarray]]]:
        """Per phase, ``{key: (int32 indices, values)}`` as host arrays."""
        lists: List[Dict[str, Tuple[List[int], List]]] = [{}, {}, {}]
        for key, cells in self._cells.items():
            for idx, (phase, val) in cells.items():
                sl = lists[phase].setdefault(key, ([], []))
                sl[0].append(idx)
                sl[1].append(val)
        return [
            {k: (np.asarray(i, np.int32), np.asarray(v)) for k, (i, v) in ph.items()}
            for ph in lists
        ]


def _dec(v):
    """A record field as the reference's changefeed encodes it, decoded:
    ``{"@link": "#c:p"}`` is a RID, ``{"@bytes": b64}`` bytes."""
    if isinstance(v, dict):
        if "@link" in v and len(v) == 1:
            return RID.parse(v["@link"])
        if "@bytes" in v and len(v) == 1:
            return base64.b64decode(v["@bytes"])
        return {k: _dec(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_dec(x) for x in v]
    return v


class SnapshotMaintainer:
    """Keeps a database's attached snapshot current across writes by
    applying each write batch as in-place patches (`apply_batch`), and by
    compacting it (`compact`) where the reference's maintainer does. Made
    by `arm_delta_maintenance`."""

    def __init__(self, db, spare_vertices: int = 1024, spare_edges: int = 4096) -> None:
        self.db = db
        #: the spare counts every compaction re-pads with
        self.spare_vertices = spare_vertices
        self.spare_edges = spare_edges
        #: the last batch's bytes uploaded and K16 launches
        self.last: Dict[str, int] = {}
        self._events = None  # CUDA events around the last batch's patches
        self.compactions = 0
        self.last_compact_reason: Optional[str] = None
        #: the last compaction's host fold milliseconds and vertex rows
        self.last_compact: Dict[str, object] = {}

    def patch_device_ms(self) -> Optional[float]:
        """Device milliseconds of the last batch's patches on the card
        (uploads and K16 launches, between events on the replay stream;
        synchronises), or None without a card."""
        if self._events is None:
            return None
        self._events[1].synchronize()
        return self._events[0].elapsed_time(self._events[1])

    @property
    def overlay(self) -> Optional[SnapshotOverlay]:
        snap = self.db.current_snapshot()
        return snap._overlay if snap is not None else None

    # -- event application --------------------------------------------------

    def apply_batch(self, events: List[Dict]) -> bool:
        """Apply one ordered batch of write events, then compact where the
        reference's maintainer does (`SnapshotMaintainer.catch_up`,
        orientdb_tpu/storage/deltas.py:474-490, :543-550): when an event
        poisoned the overlay (the batch's remaining events, that one first,
        then apply to the compacted snapshot; if they dirtied its slabs, it
        is folded once more, so that the snapshot is the clean one of the
        whole batch), and when the worst slab fill or the dead fraction
        reached ``config.delta_compact_ratio``. Returns True: the attached
        snapshot holds the batch (False only without an overlay). A
        compaction that cannot fold the batch raises."""
        ov = self.overlay
        if ov is None:
            return False
        rest, fresh = list(events), False
        while True:
            done = self._apply_events(ov, rest, fresh)
            if ov.poisoned is None:
                break
            reason = f"poisoned: {ov.poisoned}"
            ov = self.compact(reason)
            rest, fresh = rest[done:], True
        if fresh and ov.topology_dirty:
            ov = self.compact(reason)
        fill = ov.slab_fill()
        if fill >= config.delta_compact_ratio or ov.dead_fraction() >= config.delta_compact_ratio:
            self.compact(f"slab fill {fill:.2f}")
        return True

    def _apply_events(self, ov: SnapshotOverlay, events: List[Dict], fresh: bool) -> int:
        """Apply ``events`` in order as one patch set and ship it; returns
        how many applied before one poisoned the overlay (all of them when
        none did). On a freshly compacted overlay (``fresh``) the first
        event is the one that poisoned the old overlay: a dangling edge is
        dropped, as the reference's rebuild drops it, and any other refusal
        raises (compaction cannot fold it)."""
        patches = _PatchSet()
        done = 0
        for ev in events:
            first = fresh and done == 0
            try:
                self._apply_event(ov, ev, patches)
            except _DanglingEdge as e:
                if not first:
                    ov.poison(str(e))
                    break
            except DeltaUnsupported as e:
                if first:
                    raise DeltaUnsupported(f"compaction cannot fold the event: {e}") from e
                ov.poison(str(e))
                break
            except Exception as e:  # never leave a batch half-tracked
                if first:
                    raise
                ov.poison(f"{type(e).__name__}: {e}")
                break
            done += 1
        self._flush_patches(ov, patches)
        ov.applied_events += done
        ov.data_version += 1
        return done

    def compact(self, reason: str) -> SnapshotOverlay:
        """Fold the overlay into a clean snapshot and swap it in: the port of
        the reference's `SnapshotMaintainer.compact`
        (orientdb_tpu/storage/deltas.py:960), which rebuilds from its
        records. `fold_snapshot` of the host arrays, re-padded with this
        maintainer's spare counts (`pad_for_deltas`), is attached in place
        of the old snapshot under the replay lock, once every replay queued
        on the old one has run (the reference's retain / release); then the
        old overlay's generation bumps (its plans drop, and a plan picked
        before the swap re-records) and its device tensors are freed. The
        new snapshot uploads at its first query. Returns its overlay."""
        db = self.db
        old = db.current_snapshot()
        t0 = time.perf_counter()
        snap = fold_snapshot(old, db.schema)
        ov = pad_for_deltas(snap, self.spare_vertices, self.spare_edges)
        fold_ms = (time.perf_counter() - t0) * 1e3
        dg = cached_device_graph(old)
        with REPLAY_LOCK:
            if dg is not None and dg.device.type == "cuda":
                torch.cuda.synchronize(dg.device)
            db.attach_snapshot(snap)
            old._overlay.bump_plan_gen()
            release_device_graph(old)
        self.compactions += 1
        self.last_compact_reason = reason
        self.last_compact = {"reason": reason, "fold_ms": fold_ms, "vertices": ov.base_vertices}
        return ov

    def stats(self) -> Dict:
        """The reference's maintainer stats: compactions, the last one's
        reason, the dead fraction and the overlay's own stats."""
        ov = self.overlay
        return {
            "armed": ov is not None,
            "compactions": self.compactions,
            "last_compact_reason": self.last_compact_reason,
            "dead_fraction": ov.dead_fraction() if ov is not None else None,
            "overlay": ov.stats() if ov is not None else None,
        }

    def _flush_patches(self, ov: SnapshotOverlay, patches: _PatchSet) -> None:
        """Ship the batch's phases in order, on the replay stream, under
        the replay lock: a replay queued before sees none of the batch, one
        queued after sees all of it. Without a device graph the host arrays
        are already patched and the upload carries them."""
        self.last = {"upload_bytes": 0, "launches": 0}
        self._events = None
        if patches.empty():
            return
        dg = cached_device_graph(ov.snap)
        if dg is None:
            return
        from orientdb_tpu_torch.ops import csr as K

        before = K.LAUNCHES["scatter_set"]
        phases = patches.phases  # host work first: the phases then run back to back
        n = 0
        with REPLAY_LOCK:
            cuda = dg.device.type == "cuda"
            if cuda:
                stream = replay_resources(dg.device)[1]
                stream.wait_stream(torch.cuda.current_stream(dg.device))
            with on_replay_stream(dg.device):
                if cuda:
                    self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    self._events[0].record()
                for phase in phases:
                    if phase:
                        n += dg.apply_patches(phase)
                if cuda:
                    self._events[1].record()
            if cuda:
                torch.cuda.current_stream(dg.device).wait_stream(stream)
        ov.upload_bytes += n
        self.last = {"upload_bytes": n, "launches": K.LAUNCHES["scatter_set"] - before}

    def _apply_event(self, ov: SnapshotOverlay, ev: Dict, patches: _PatchSet) -> None:
        op = ev.get("op")
        if op not in ("create", "update", "delete"):
            return
        rid = self._rid_of(ev)
        if rid is None:
            raise DeltaUnsupported("event without rid")
        snap = ov.snap
        if op == "delete":
            if rid in snap.rid_to_idx:
                self._delete_vertex(ov, rid, patches)
                return
            hit = self._find_edge(ov, rid)
            if hit is not None:
                self._tombstone_edge(ov, hit[0], hit[1], patches)
            return  # unknown rid: a plain document, or already gone
        cname = ev.get("class")
        if cname is None:
            raise DeltaUnsupported(f"classless {op} for {rid}")
        cls = self.db.schema.get_class(cname)
        if cls is None:
            raise DeltaUnsupported(f"unknown class {cname!r}")
        if not (cls.is_vertex_type or cls.is_edge_type):
            return  # plain documents are not in the snapshot
        record = ev.get("record") or {}
        if cls.is_edge_type:
            self._apply_edge(ov, cname, rid, record, op, patches)
        else:
            self._apply_vertex(ov, cname, rid, record, op, patches)

    @staticmethod
    def _rid_of(ev: Dict) -> Optional[RID]:
        try:
            return RID.parse(ev["rid"])
        except (KeyError, ValueError):
            return None

    # -- vertices -----------------------------------------------------------

    def _apply_vertex(self, ov, cname: str, rid: RID, record: Dict, op: str, patches) -> None:
        snap = ov.snap
        idx = snap.rid_to_idx.get(rid)
        if idx is None:
            if op == "update":
                raise DeltaUnsupported(f"update for unknown vertex {rid}")
            cid = snap.class_id_of.get(cname.lower())
            if cid is None:
                raise DeltaUnsupported(f"class {cname!r} not in snapshot")
            if ov.next_v_slot >= ov.cap_vertices:
                raise DeltaUnsupported("vertex slab full")
            idx = ov.next_v_slot
            ov.next_v_slot = idx + 1
            ov.mark_topology_dirty()
            snap.v_cluster[idx] = rid.cluster
            snap.v_position[idx] = rid.position
            self._patch_columns(ov, snap.v_columns, snap.v_non_columnar, "v", idx, record, patches)
            snap.rid_to_idx[rid] = idx
            # v_class is the liveness bit: written LAST
            snap.v_class[idx] = cid
            patches.add(_PH_LIVE, "v_class", idx, np.int32(cid))
            return
        # update (or a create delivered again): columns in place
        self._patch_columns(ov, snap.v_columns, snap.v_non_columnar, "v", idx, record, patches)

    def _patch_columns(self, ov, columns, non_columnar, prefix: str, idx: int, record: Dict, patches) -> None:
        fields = {k: _dec(v) for k, v in record.items() if not k.startswith("@")}
        for name, val in fields.items():
            if name in columns or name in non_columnar:
                continue
            if isinstance(val, (bool, int, float, str)):
                # a build would have made this a column: ignoring it would
                # drop predicates on it silently
                raise DeltaUnsupported(f"new columnar property {name!r}")
        for name, col in columns.items():
            val = fields.get(name)
            have = name in fields and val is not None
            if have and not isinstance(val, (bool, int, float, str)):
                have = False  # a non-scalar in a columnar slot: absent
            if have:
                code = self._encode(ov, col, val)
                patches.add(_PH_DATA, f"{prefix}:{name}:v", idx, code)
                patches.add(_PH_DATA, f"{prefix}:{name}:p", idx, True)
                col.values[idx] = code
                col.present[idx] = True
            elif bool(col.present[idx]):
                patches.add(_PH_DATA, f"{prefix}:{name}:p", idx, False)
                col.present[idx] = False

    def _encode(self, ov, col: PropertyColumn, val):
        if col.kind == "str":
            if not isinstance(val, str):
                raise DeltaUnsupported(f"non-string into string column {col.name!r}")
            lookup = col.dict_lookup
            code = lookup.get(val) if lookup else None
            if code is None:
                if col.dictionary is None:
                    raise DeltaUnsupported(f"string column {col.name!r} has no dictionary")
                # append IN PLACE: the device column shares this list, so
                # new recordings see the grown dictionary; the generation
                # bump re-records plans whose code tables are now short
                col.dictionary.append(val)
                code = len(col.dictionary) - 1
                col.dict_lookup[val] = code
                col._dict_arr = None
                col.dict_unsorted = True
                ov.bump_plan_gen()
            return np.int32(code)
        if col.kind == "int":
            if isinstance(val, float) and not float(val).is_integer():
                raise DeltaUnsupported(f"float into int column {col.name!r}")
            if isinstance(val, str):
                raise DeltaUnsupported(f"string into {col.kind} column {col.name!r}")
            iv = int(val)
            if not (-(2**31) + 2 <= iv < 2**31):
                raise DeltaUnsupported(f"out-of-range int into column {col.name!r}")
            return np.int32(iv)
        if col.kind == "float":
            if isinstance(val, str):
                raise DeltaUnsupported(f"string into float column {col.name!r}")
            return np.float32(val)
        if col.kind == "bool":
            if not isinstance(val, bool):
                raise DeltaUnsupported(f"non-bool into bool column {col.name!r}")
            return np.int32(bool(val))
        raise DeltaUnsupported(f"column kind {col.kind!r}")

    def _delete_vertex(self, ov, rid: RID, patches) -> None:
        snap = ov.snap
        idx = snap.rid_to_idx.pop(rid, None)
        if idx is None:
            return
        ov.mark_topology_dirty()
        # liveness first: class -1 leaves every class mask and the armed
        # liveness conjunct
        snap.v_class[idx] = -1
        patches.add(_PH_DEAD, "v_class", idx, np.int32(-1))
        ov.dead_vertices += 1
        # cascade: tombstone every incident edge, base CSR slots by the
        # vertex's CSR ranges, slab slots by one vectorised scan of the used
        # slab (ascending, the reference's order)
        for cname, csr in snap.edge_classes.items():
            slab = ov.edge_slabs[cname]
            lo, hi = int(csr.indptr_out[idx]), int(csr.indptr_out[idx + 1])
            for pos in range(lo, hi):
                self._tombstone_edge(ov, cname, pos, patches)
            lo, hi = int(csr.indptr_in[idx]), int(csr.indptr_in[idx + 1])
            for ip in range(lo, hi):
                out_pos = int(csr.edge_id_in[ip])
                if out_pos >= 0:
                    self._tombstone_edge(ov, cname, out_pos, patches)
            w = slice(slab.base, slab.next_slot)
            hits = np.flatnonzero(
                csr.live[w] & ((csr._edge_src[w] == idx) | (csr.dst[w] == idx))
            )
            for pos in (hits + slab.base).tolist():
                self._tombstone_edge(ov, cname, pos, patches)

    # -- edges --------------------------------------------------------------

    def _find_edge(self, ov, rid: RID) -> Optional[Tuple[str, int]]:
        for cname, csr in ov.snap.edge_classes.items():
            pos = ov.edge_slabs[cname].rid_pos(csr).get(rid)
            if pos is not None:
                return cname, pos
        return None

    def _apply_edge(self, ov, cname: str, rid: RID, record: Dict, op: str, patches) -> None:
        snap = ov.snap
        csr = snap.edge_classes.get(cname)
        if csr is None:
            raise DeltaUnsupported(f"edge class {cname!r} not in snapshot")
        slab = ov.edge_slabs[cname]
        pos = slab.rid_pos(csr).get(rid)
        if pos is not None:
            # update (or a create delivered again): properties only, the
            # endpoints are immutable
            self._patch_columns(ov, csr.edge_columns, csr.non_columnar, f"e:{cname}:c", pos, record, patches)
            return
        if op == "update":
            raise DeltaUnsupported(f"update for unknown edge {rid}")
        try:
            src_rid = RID.parse(str(record["@out"]))
            dst_rid = RID.parse(str(record["@in"]))
        except (KeyError, ValueError):
            raise DeltaUnsupported(f"edge create without endpoints {rid}")
        src = snap.rid_to_idx.get(src_rid)
        dst = snap.rid_to_idx.get(dst_rid)
        if src is None or dst is None:
            raise _DanglingEdge(f"edge {rid} endpoint not in snapshot")
        if slab.next_slot >= slab.cap:
            raise DeltaUnsupported(f"edge slab full for {cname!r}")
        ov.mark_topology_dirty()
        pos = slab.next_slot
        slab.next_slot = pos + 1
        p = f"e:{cname}"
        csr._edge_src[pos] = src
        csr.dst[pos] = dst
        csr.e_cluster[pos] = rid.cluster
        csr.e_position[pos] = rid.position
        slab.rid_pos(csr)[rid] = pos
        patches.add(_PH_DATA, f"{p}:edge_src", pos, np.int32(src))
        patches.add(_PH_DATA, f"{p}:dst", pos, np.int32(dst))
        # bucket entry in the DATA phase, before the LIVE flip: no reader
        # sees a live edge that is not indexed yet
        ov.bucket_add(cname, src, dst, pos - slab.base, patches)
        self._patch_columns(ov, csr.edge_columns, csr.non_columnar, f"{p}:c", pos, record, patches)
        # liveness LAST
        csr.live[pos] = True
        patches.add(_PH_LIVE, f"{p}:live", pos, True)

    def _tombstone_edge(self, ov, cname: str, pos: int, patches) -> None:
        csr = ov.snap.edge_classes[cname]
        if not bool(csr.live[pos]):
            return
        ov.mark_topology_dirty()
        slab = ov.edge_slabs[cname]
        p = f"e:{cname}"
        # liveness first (the bitmap hops), endpoints after (the CSR walk)
        csr.live[pos] = False
        patches.add(_PH_DEAD, f"{p}:live", pos, False)
        if pos < slab.base:
            # a base CSR slot stays in the expansion: a -1 endpoint makes it
            # padding (the CSR expansion masks nbr < 0)
            csr.dst[pos] = -1
            patches.add(_PH_DATA, f"{p}:dst", pos, np.int32(-1))
            ip = int(slab.in_pos(csr)[pos])
            if ip >= 0:
                csr.src[ip] = -1
                patches.add(_PH_DATA, f"{p}:src", ip, np.int32(-1))
        slab.dead += 1

    def refresh_plans(self) -> None:
        """Drop every cached plan, so that the next executions record at the
        current slab occupancy (a caller expecting a burst of writes takes
        the re-record when it chooses)."""
        ov = self.overlay
        if ov is not None:
            ov.bump_plan_gen()


def arm_delta_maintenance(
    db, spare_vertices: int = 1024, spare_edges: int = 4096
) -> SnapshotMaintainer:
    """Pad ``db``'s attached snapshot for deltas and return its maintainer:
    from then on ``maintainer.apply_batch(events)`` patches the resident
    snapshot in place. Raises once the snapshot is on the device (pad
    before the first query)."""
    snap = db.current_snapshot()
    if snap is None:
        raise ValueError("no snapshot attached")
    pad_for_deltas(snap, spare_vertices, spare_edges)
    return SnapshotMaintainer(db, spare_vertices, spare_edges)
