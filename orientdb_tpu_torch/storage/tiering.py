"""Port of `orientdb_tpu/storage/tiering.py`: tiered snapshots, a hot/cold
adjacency plane on the card.

A snapshot whose flat adjacency exceeds ``config.tier_hbm_cap_bytes`` is
admitted to the tier plane (`maybe_tier_snapshot`, called by
`Database.attach_snapshot`) and keeps serving instead of uploading it flat:

- Each (edge class, direction) partition's flat ``[E]`` arrays are cut into
  contiguous **vertex-range blocks** of about ``config.tier_block_edges``
  edges (quotient blocking: a hub vertex never splits). The blocks' values
  live in a fixed device **pool** of ``P`` pages of ``Wp`` slots, three
  int32 rows a page (``own``, ``nbr``, ``eid``); ``pageof[B]`` maps each
  block to its page (-1 = cold) and ``blockv[V]`` each vertex to its block.
  The cold tier is the partition's host arrays. A paged class uploads only
  its two indptrs (`ops/device_graph`).
- **Placement** is degree-skew seeded (the blocks holding the highest
  degrees load first) and maintained LRU by touch recency.
- **Faulting** happens while a plan records: the eager run sees concrete
  frontiers, so the solver makes every touched block resident before the
  gather reads it, and the touched set becomes the plan's **footprint**.
  `prepare_dispatch` re-ensures the footprint before each replay and pins
  it until the replay's rows are materialised; the replay's paged kernels
  (K19–K21 in `ops/csr`) raise a device **cold-miss flag** that joins the
  replay's overflow flag, so a replay off its footprint re-records.

The reference's pools are functional JAX arrays passed to every compiled
plan as arguments. A captured CUDA graph instead holds the pointers it was
captured with, so here loads and evictions write the SAME tensors in place:
a page's three rows by asynchronous copies from pinned staging buffers
(``_STAGE_BLOCKS`` blocks at a time; the whole host arrays are never
pinned), ``pageof`` by a copy of the host indirection, eviction by filling
the page's ``own`` row with -1. Every such write is enqueued on the replay
stream under the replay lock, after the work already queued on the caller's
stream and on the replay stream, and the caller's stream waits for it: a
page is never overwritten under a queued replay, and the next replay or
recording gather reads the loaded page. Growing a pool (a request larger
than the pool) allocates new tensors; it bumps ``generation``, and a plan
captured under an older generation re-records at its next dispatch.

The reference's metric gauges, memory ledger entries, device fault domain
and ``scrub.flip`` chaos point have no counterpart yet: `TierManager.stats`
carries every number the gauges showed. Tiered snapshots are immutable:
arming delta maintenance on one refuses (`storage/deltas.pad_for_deltas`),
as does tiering an armed one.
"""

from __future__ import annotations

import contextlib
from collections import deque
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np
import torch

from orientdb_tpu_torch.ops import csr as K
from orientdb_tpu_torch.ops.device_graph import cached_device_graph
from orientdb_tpu_torch.ops.replay_stream import REPLAY_LOCK, replay_resources
from orientdb_tpu_torch.utils.config import config

#: reload of a block evicted within this many ensure calls counts as a
#: thrash event; ``thrash`` is events over the window
_THRASH_WINDOW = 32

#: pool arrays per partition (own/nbr/eid), int32 each
_POOL_ROWS = ("own", "nbr", "eid")

#: blocks staged through one pinned host buffer per load wave
_STAGE_BLOCKS = 32


def adjacency_bytes(snap) -> int:
    """Resident-form device bytes of the flat adjacency (the four ``[E]``
    int32 arrays plus both indptrs, per edge class): the quantity
    ``tier_hbm_cap_bytes`` caps. Property columns upload lazily and are
    not counted."""
    total = 0
    for csr in snap.edge_classes.values():
        E = int(csr.dst.shape[0])
        total += 4 * (4 * E + int(csr.indptr_out.shape[0]) + int(csr.indptr_in.shape[0]))
    return total


class _Partition:
    """Host-side layout and residency bookkeeping for one (edge class,
    direction) partition of the adjacency."""

    __slots__ = (
        "cname", "d", "V", "E", "W", "Wp", "B", "P",
        "edge_start", "block_of_v", "vdeg", "prio",
        "host", "page_of", "block_of_page", "free_pages",
        "lru", "pins", "evicted_at",
    )

    def __init__(self, cname: str, d: str, indptr: np.ndarray, host: Dict[str, np.ndarray]) -> None:
        self.cname = cname
        self.d = d
        self.V = int(indptr.shape[0]) - 1
        self.E = int(host["nbr"].shape[0])
        deg = np.diff(indptr).astype(np.int64)
        deg_max = int(deg.max()) if deg.size else 0
        self.W = max(int(config.tier_block_edges), deg_max, 1)
        # quotient blocking: a vertex belongs to the block of its first
        # edge's W-quotient, so a block spans < W + deg_max edges and hubs
        # never split across blocks
        self.Wp = K.bucket(self.W + deg_max, minimum=8)
        q = (indptr[:-1].astype(np.int64) // self.W) if self.V else np.zeros(0, np.int64)
        uq, inv = np.unique(q, return_inverse=True)
        self.B = int(uq.shape[0])
        self.block_of_v = inv.astype(np.int32)
        first_v = np.searchsorted(inv, np.arange(self.B), side="left")
        self.edge_start = np.concatenate([indptr[first_v].astype(np.int64), [self.E]]).astype(np.int32)
        self.vdeg = deg.astype(np.int32)
        # degree-skew placement priority: the hottest block holds the
        # highest-degree vertex (hubs dominate frontier touch odds)
        self.prio = np.maximum.reduceat(deg, first_v) if self.B else np.zeros(0, np.int64)
        self.host = host  # name -> [E] int32 in this partition's order
        # residency state (reset per install)
        self.page_of = np.full(self.B, -1, np.int32)
        self.block_of_page = np.zeros(0, np.int32)
        self.free_pages: List[int] = []
        self.lru: Dict[int, int] = {}
        self.pins: Dict[int, int] = {}
        self.evicted_at: Dict[int, int] = {}
        self.P = 0

    @property
    def key(self) -> Tuple[str, str]:
        return (self.cname, self.d)

    def block_bytes(self) -> int:
        return self.Wp * 4 * len(_POOL_ROWS)

    def fill_block(self, name: str, b: int, out: np.ndarray) -> None:
        """Write block ``b``'s values of ``name`` into the page row ``out``
        ([Wp]), -1 past the block's end."""
        lo, hi = int(self.edge_start[b]), int(self.edge_start[b + 1])
        out[: hi - lo] = self.host[name][lo:hi]
        out[hi - lo :] = -1

    def block_values(self, name: str, b: int) -> np.ndarray:
        out = np.empty(self.Wp, np.int32)
        self.fill_block(name, b, out)
        return out


def _keys(cname: str, d: str) -> Dict[str, str]:
    p = f"t:{cname}:{d}"
    return {
        "own": f"{p}:own", "nbr": f"{p}:nbr", "eid": f"{p}:eid",
        "pageof": f"{p}:pageof", "blockv": f"{p}:blockv", "estart": f"{p}:estart",
    }


def _indptr_key(cname: str, d: str) -> str:
    return f"e:{cname}:indptr_{d}"


def _host_ids(verts) -> np.ndarray:
    if isinstance(verts, torch.Tensor):
        verts = verts.cpu().numpy()
    return np.asarray(verts).reshape(-1)


class TierManager:
    """Hot/cold residency manager for one snapshot's adjacency.

    Built by `maybe_tier_snapshot` when the snapshot's adjacency exceeds
    ``config.tier_hbm_cap_bytes``, and installed into the snapshot's
    DeviceGraph when it is built (`install`). Every residency change runs
    under ``self.lock``, the replay lock of `ops/replay_stream`: a pool write
    and a replay dispatch never interleave. The manager holds no reference
    to the snapshot, which owns it (``snap._tier``)."""

    def __init__(self, snap, cap_bytes: int) -> None:
        self.cap = int(cap_bytes)
        self.lock = REPLAY_LOCK
        self.parts: Dict[Tuple[str, str], _Partition] = {}
        for cname, csr in snap.edge_classes.items():
            E = int(csr.dst.shape[0])
            if E == 0:
                continue
            out_host = {
                "own": csr.edge_src,
                "nbr": np.asarray(csr.dst, np.int32),
                # out-partition edge ids ARE the CSR positions
                "eid": np.arange(E, dtype=np.int32),
            }
            in_host = {
                # per-edge owning dst in in-CSR order (reverse hops activate
                # the dst endpoint)
                "own": np.repeat(
                    np.arange(int(csr.indptr_in.shape[0]) - 1, dtype=np.int32),
                    np.diff(csr.indptr_in),
                ),
                "nbr": np.asarray(csr.src, np.int32),
                "eid": np.asarray(csr.edge_id_in, np.int32),
            }
            pair = [
                _Partition(cname, d, indptr, host)
                for d, indptr, host in (
                    ("out", np.asarray(csr.indptr_out), out_host),
                    ("in", np.asarray(csr.indptr_in), in_host),
                )
            ]
            # a class tiers as a PAIR or not at all: a flat direction would
            # need the flat arrays the paged one leaves on the host.
            # Single-block partitions gain nothing from paging.
            if all(p.B >= 2 for p in pair):
                for p in pair:
                    self.parts[p.key] = p
        self._size_pools()
        self._dg = None
        self.ensure_seq = 0
        self.evictions = 0
        #: a miss is one block loaded host → device (the install's seed
        #: is not counted); loaded_bytes are their pages' bytes
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.loaded_bytes = 0
        #: bumped whenever a pool grows into new tensors: plans captured
        #: under an older generation re-record
        self.generation = 0
        self._thrash: deque = deque()

    def _size_pools(self) -> None:
        """Split the byte cap across partitions proportionally to their
        edge counts; each partition gets at least one page."""
        tot = sum(p.E for p in self.parts.values()) or 1
        for part in self.parts.values():
            share = self.cap * part.E // tot
            part.P = max(1, min(part.B, int(share // part.block_bytes())))

    def pages_dir(self, cname: str, d: str) -> bool:
        return (cname, d) in self.parts

    # -- device install -----------------------------------------------------

    def install(self, dg) -> None:
        """Upload the tier plane into a freshly built DeviceGraph: block
        indexes, the pools, and the degree-skew hot seed (one upload per
        array)."""
        with self.lock:
            self._dg = dg
            for part in self.parts.values():
                part.page_of = np.full(part.B, -1, np.int32)
                part.block_of_page = np.full(part.P, -1, np.int32)
                part.lru.clear()
                part.pins.clear()
                part.evicted_at.clear()
                keys = _keys(part.cname, part.d)
                order = np.argsort(-part.prio, kind="stable")[: part.P]
                pools = {n: np.full((part.P, part.Wp), -1, np.int32) for n in _POOL_ROWS}
                for p, b in enumerate(order):
                    b = int(b)
                    for n in _POOL_ROWS:
                        part.fill_block(n, b, pools[n][p])
                    part.page_of[b] = p
                    part.block_of_page[p] = b
                    part.lru[b] = 0
                part.free_pages = list(range(len(order), part.P))
                for n in _POOL_ROWS:
                    dg._put(keys[n], pools[n])
                # a copy: the host indirection changes apart from the device one
                dg._put(keys["pageof"], part.page_of.copy())
                dg._put(keys["blockv"], part.block_of_v)
                dg._put(keys["estart"], part.edge_start)

    # -- residency ----------------------------------------------------------

    def ensure_vertices(self, cname: str, d: str, verts, touched: Optional[Set] = None) -> None:
        """Recording-time fault: make every block owning an edge of these
        frontier vertices (host or device ids, -1 padding ignored) resident
        before the gather reads it."""
        part = self.parts.get((cname, d))
        if part is None:
            return
        v = _host_ids(verts)
        v = v[(v >= 0) & (v < part.V)]
        if v.size == 0:
            return
        v = v[part.vdeg[v] > 0]
        if v.size == 0:
            return
        blocks = np.unique(part.block_of_v[v])
        self._ensure_blocks(part, [int(b) for b in blocks], touched)

    def ensure_frontier(
        self, cname: str, d: str, frontier: torch.Tensor, touched: Optional[Set] = None,
        gate: Optional[torch.Tensor] = None,
    ) -> None:
        """Recording-time fault for a ``[C, vb]`` frontier bitmap: the
        vertices active in some row, and in ``gate`` (a WHILE condition),
        which are the vertices the hop expands."""
        part = self.parts.get((cname, d))
        if part is None:
            return
        fa = frontier.any(dim=0)
        if gate is not None:
            fa = fa & gate
        self.ensure_vertices(cname, d, torch.nonzero(fa[: part.V]).view(-1), touched)

    def prepare_dispatch(self, footprint: FrozenSet) -> None:
        """Dispatch-time footprint prefetch: the recorded footprint's cold
        blocks load (queued ahead of the replay on the replay stream) and
        its pins bump until `release_footprint`."""
        with self.lock:
            by_part: Dict[Tuple[str, str], List[int]] = {}
            for key, b in footprint:
                by_part.setdefault(key, []).append(int(b))
            for key, blocks in by_part.items():
                part = self.parts.get(key)
                if part is not None:
                    self._ensure_blocks(part, blocks, None, pin=True)

    def release_footprint(self, footprint: FrozenSet) -> None:
        with self.lock:
            for key, b in footprint:
                part = self.parts.get(key)
                if part is not None:
                    n = part.pins.get(int(b), 0)
                    if n <= 1:
                        part.pins.pop(int(b), None)
                    else:
                        part.pins[int(b)] = n - 1

    def _ensure_blocks(self, part: _Partition, blocks: List[int], touched: Optional[Set], pin: bool = False) -> None:
        """Make ALL of ``blocks`` resident at once: the caller is one
        expansion or hop (one kernel reads every block it touches) or one
        replay. When the request exceeds the pool (free pages plus the
        resident blocks outside the request) the pool GROWS to hold it: the
        cap is enforced between requests by LRU eviction, never inside one,
        where violating it is the only way to be correct."""
        with self.lock:
            dg = self._dg
            if dg is None:
                return
            self.ensure_seq += 1
            seq = self.ensure_seq
            requested = set(blocks)
            need = []
            for b in blocks:
                if touched is not None:
                    touched.add((part.key, b))
                part.lru[b] = seq
                if pin:
                    part.pins[b] = part.pins.get(b, 0) + 1
                if part.page_of[b] < 0:
                    need.append(b)
                else:
                    self.prefetch_hits += 1
            if not need:
                return
            evictable = sum(
                1 for b2 in range(part.B) if part.page_of[b2] >= 0 and b2 not in requested
            )
            with self._pool_stream(dg):
                short = len(need) - len(part.free_pages) - evictable
                if short > 0:
                    self._grow_pool(part, short)
                self._load_blocks(part, need, seq, requested)

    @contextlib.contextmanager
    def _pool_stream(self, dg):
        """Run pool writes on the replay stream, after the work queued so
        far on the caller's stream (a recording's gathers) and on the replay
        stream (queued replays); the caller's stream then waits for them."""
        if dg.device.type != "cuda":
            yield
            return
        stream = replay_resources(dg.device)[1]
        cur = torch.cuda.current_stream(dg.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            yield
        cur.wait_stream(stream)

    def _grow_pool(self, part: _Partition, extra: int) -> None:
        """Append ``extra`` empty pages: new tensors (a captured replay
        holds the old pointers), so the generation moves on. The old
        tensors are freed only after the replay stream's queued work."""
        dg = self._dg
        keys = _keys(part.cname, part.d)
        for n in _POOL_ROWS:
            old = dg.arrays[keys[n]]
            pad = torch.full((extra, part.Wp), -1, dtype=torch.int32, device=old.device)
            dg.arrays[keys[n]] = torch.cat([old, pad])
            if old.is_cuda:
                old.record_stream(torch.cuda.current_stream(old.device))
        part.free_pages.extend(range(part.P, part.P + extra))
        part.block_of_page = np.concatenate([part.block_of_page, np.full(extra, -1, np.int32)])
        part.P += extra
        self.generation += 1

    def _load_blocks(self, part: _Partition, need: List[int], seq: int, requested: Set[int]) -> None:
        """Assign a page to each cold block of ``need`` (evicting LRU
        victims), stage the blocks' rows in pinned host buffers and copy
        them into the pool rows in place, then copy the host ``pageof``
        over the device one. Runs inside `_pool_stream`."""
        dg = self._dg
        keys = _keys(part.cname, part.d)
        todo: List[Tuple[int, int]] = []
        for b in need:
            if part.page_of[b] >= 0:
                continue
            last = part.evicted_at.get(b)
            if last is not None and seq - last <= _THRASH_WINDOW:
                self._thrash.append(seq)
            p = self._grab_page(part, requested)
            part.page_of[b] = p
            part.block_of_page[p] = b
            todo.append((b, p))
            self.prefetch_misses += 1
        if not todo:
            return
        pools = [dg.arrays[keys[n]] for n in _POOL_ROWS]
        cuda = pools[0].is_cuda
        for c0 in range(0, len(todo), _STAGE_BLOCKS):
            chunk = todo[c0 : c0 + _STAGE_BLOCKS]
            # a fresh pinned buffer per wave: the caching host allocator
            # reuses it only after the copies queued from it have run
            stage = torch.empty((len(chunk), len(_POOL_ROWS), part.Wp), dtype=torch.int32, pin_memory=cuda)
            host = stage.numpy()
            for i, (b, _p) in enumerate(chunk):
                for k, n in enumerate(_POOL_ROWS):
                    part.fill_block(n, b, host[i, k])
            for i, (_b, p) in enumerate(chunk):
                for k, pool in enumerate(pools):
                    pool[p].copy_(stage[i, k], non_blocking=cuda)
        pageof = torch.from_numpy(part.page_of.copy())
        dg.arrays[keys["pageof"]].copy_(pageof.pin_memory() if cuda else pageof, non_blocking=cuda)
        self.loaded_bytes += len(todo) * part.block_bytes()

    def _grab_page(self, part: _Partition, protect: Set[int]) -> int:
        if part.free_pages:
            return part.free_pages.pop()
        # LRU victim outside the current request, unpinned preferred; a
        # fully pinned remainder still evicts (the replay stream orders the
        # overwrite after every queued replay)
        resident = [b for b in range(part.B) if part.page_of[b] >= 0 and b not in protect]
        victim = min(resident, key=lambda b: (part.pins.get(b, 0) > 0, part.lru.get(b, -1)))
        return self._evict(part, victim)

    def _evict(self, part: _Partition, b: int) -> int:
        """Invalidate block ``b``'s page: its owner row reads -1 (the
        reference's slot walk masks its slots out) and its ``pageof`` entry
        -1, copied to the device at the end of the wave, before any hop or
        gather runs after it on the replay stream; K19's push and K21 read
        a page only through ``pageof``, so the stale nbr and eid rows are
        never read."""
        keys = _keys(part.cname, part.d)
        p = int(part.page_of[b])
        self._dg.arrays[keys["own"]][p].fill_(-1)
        part.page_of[b] = -1
        part.block_of_page[p] = -1
        part.lru.pop(b, None)
        part.evicted_at[b] = self.ensure_seq
        self.evictions += 1
        return p

    # -- accounting ----------------------------------------------------------

    def hot_bytes(self) -> int:
        """Device bytes of the plane: pages plus the per-partition indexes
        (pageof, blockv, estart)."""
        total = 0
        for part in self.parts.values():
            total += part.P * part.block_bytes()
            total += 4 * (part.B + part.B + 1 + part.V + part.P)
        return total

    def pool_bytes(self) -> int:
        """Device bytes the hot pools occupy right now (pages only)."""
        return sum(part.P * part.block_bytes() for part in self.parts.values())

    def headroom_bytes(self) -> int:
        return max(0, int(self.cap) - self.hot_bytes())

    def thrash_rate(self) -> float:
        floor = self.ensure_seq - _THRASH_WINDOW
        while self._thrash and self._thrash[0] <= floor:
            self._thrash.popleft()
        return float(len(self._thrash))

    def stats(self) -> Dict:
        looked = self.prefetch_hits + self.prefetch_misses
        return {
            "cap_bytes": self.cap,
            "hot_bytes": self.hot_bytes(),
            "pool_bytes": self.pool_bytes(),
            "headroom_bytes": self.headroom_bytes(),
            "partitions": len(self.parts),
            "evictions": self.evictions,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_misses": self.prefetch_misses,
            "prefetch_hit": (self.prefetch_hits / looked) if looked else 1.0,
            "thrash": self.thrash_rate(),
            "loaded_bytes": self.loaded_bytes,
            "generation": self.generation,
        }


# ---------------------------------------------------------------------------
# the paged reads over a device graph's arrays (K19–K21, `ops/csr`)
# ---------------------------------------------------------------------------


def paged_hop(arrays, cname: str, d: str, emask, frontier, gate=None, alive=None, out=None, miss=None):
    """One frontier bitmap hop over a paged partition (K19): the active
    vertices' rows of the resident indptr, through the block → page
    indirection into the pool; with ``miss`` (a 0-d bool) the same launch
    sets it where `paged_hop_miss` would flag."""
    k = _keys(cname, d)
    return K.paged_hop_csr(
        arrays[_indptr_key(cname, d)], arrays[k["blockv"]], arrays[k["pageof"]], arrays[k["estart"]],
        arrays[k["nbr"]], arrays[k["eid"]], emask, frontier, gate, alive, out, miss,
    )


def paged_hop_miss(arrays, cname: str, d: str, frontier, gate=None, alive=None):
    """The hop's device cold-miss flag (K20) in a launch of its own: an
    active vertex with edges whose block is not resident."""
    k = _keys(cname, d)
    return K.paged_hop_miss(
        frontier, arrays[k["blockv"]], arrays[k["pageof"]], arrays[_indptr_key(cname, d)], gate, alive
    )


def paged_expand(arrays, cname: str, d: str, srcs, offsets, total_dev, out_size: int, flag=None):
    """CSR gather over a paged partition (K21): ``(row, eid, nbr,
    cold_miss_flag)``, cold slots nulled; with ``flag`` (a 0-d bool) the
    launch stores the cold miss into it and returns it as the flag."""
    k = _keys(cname, d)
    return K.paged_expand(
        arrays[_indptr_key(cname, d)], srcs, offsets, total_dev, out_size,
        arrays[k["blockv"]], arrays[k["pageof"]], arrays[k["estart"]],
        arrays[k["nbr"]], None if d == "out" else arrays[k["eid"]], d == "out", flag,
    )


# ---------------------------------------------------------------------------
# admission
# ---------------------------------------------------------------------------


def maybe_tier_snapshot(snap) -> Optional[TierManager]:
    """Snapshot admission: when ``tier_hbm_cap_bytes`` is set and the
    snapshot's adjacency exceeds it, attach a TierManager so the device
    build pages adjacency instead of uploading it flat. Under-cap snapshots
    stay fully resident. A mesh or a delta overlay refuses: both assume
    flat resident adjacency."""
    cap = int(config.tier_hbm_cap_bytes)
    if cap <= 0:
        return None
    existing = getattr(snap, "_tier", None)
    if existing is not None:
        return existing
    if adjacency_bytes(snap) <= cap:
        return None
    if cached_device_graph(snap) is not None:
        raise ValueError("tier admission must run before the snapshot's first device upload")
    if getattr(snap, "_mesh", None) is not None:
        raise ValueError(
            "tiered snapshots are single-device: adjacency exceeds "
            "tier_hbm_cap_bytes but a mesh is attached — raise the cap, "
            "drop the mesh, or shard the graph instead"
        )
    if getattr(snap, "_overlay", None) is not None:
        raise ValueError(
            "delta-maintained snapshots cannot tier: adjacency exceeds "
            "tier_hbm_cap_bytes with a delta overlay armed — compact to "
            "a clean snapshot before tiering"
        )
    tier = snap._tier = TierManager(snap, cap)
    return tier
