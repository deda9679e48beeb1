#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`orientdb_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

from the root of a checkout. Phases, each of which raises on failure:

1. device — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them;
2. build — compiles `orientdb_tpu_torch/csrc/csr_kernels.cu` with nvcc;
3. kernels — on the SF100-shape Person–knows graph (8M persons, ~80M knows
   edges, seed 5, with the port's float32 lat/lng columns), holds each kernel against its plain PyTorch version at
   the main path's shapes and at edge-case lengths: int32 and bool results
   exactly, float32 results to rtol 1e-6 (the kernels add in another order
   than the plain version); times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call (`library_ms`,
   which the port never calls). The bitmap-BFS kernels (K9–K12) are held
   exactly at V1's shapes (8-row chunks of 2^23-vertex bitmaps over the
   ~80M edges), on live BFS levels, in both directions, with an edge mask,
   a WHILE gate, an empty frontier, an empty edge list, all-padding rows,
   duplicate targets and a bound (close-arm) row vector; K10 in both
   forms: the CSR form (the engine's hop, `bitmap_hop_csr`) at the roots,
   levels 1 and 2, every vertex active and 33 rows, out and in (the mask
   through ``edge_id_in``), masked, gated, both directions ORed, each
   timed eagerly and in a graph beside the edge-list form (which the
   engine runs over a dirty delta slab) and ``torch.sparse.mm``. K15
   `predicate_eval` is held exactly against its plain version on every
   instruction family of its predicate programs (`K15_WHERES`) over 2^23
   synthetic slots with ~10 % absent values, ids with -1 and past-end
   entries, identity mode, binding rows, the WHILE level and a parameter
   row (distance() masks outside the boundary band: float64 distance
   within 0.01 km + 1e-5·r of r), with split launches against one; its
   lane form against 16 parameter rows (`check_predicate_lanes`) and its
   stacked form over 16 lanes of 2^20 lane-stacked ids, binding rows and
   split values (`check_predicate_stacked`) lane by lane against the single
   kernel and the plain version; then
   timed on Q1's two node masks over the 2^23-vertex universe, on G1's
   (beside its byte and operation bounds) and on guarded programs whose
   first conjunct rejects every slot or none. K4 (the merge-path segment
   sum) is held at Q2's ~80M weights into 2^23 (padded) and into V / 3
   (cut), at the edge lengths and on a Zipf-degree CSR with a segment of
   30 tiles and runs of empty segments (int32 exactly, float32 to rtol
   1e-6, every call twice and bit for bit equal), and timed eagerly and in
   a graph beside ``torch.segment_reduce``. K1 (the
   single-pass look-back scan) is held in every form (inclusive,
   exclusive, with its device total, the total alone, a bool mask's ranks
   through its int32 cast) at Q2's ~80M weights, around its tile and K3's
   and at 4,097 tiles, and over 1,000 replays of one captured launch on
   fresh inputs; K3 (the one-pass compaction on the same look-back) at
   Q3's roots, with truncation, and at the same lengths. Both are timed
   eagerly and in a captured graph beside `torch.cumsum` /
   `torch.nonzero`, and each must enqueue one CUDA kernel and one memset a
   call, counted from the nodes of a graph that captured the call. K5a
   `take_pad` (int32, float32, bool) is held exactly at A's weight pass,
   at the edge lengths and with the index 1–3 elements off 16 bytes (the
   output is always a fresh allocation), and timed beside
   ``torch.index_select``; the fused weight gather (`weight_gather`, the
   COUNT pushdown's per-edge value in one launch) bit for bit against its
   plain version and the parent's five calls on A's out and in walks (the
   edge mask through ``edge_id_in``), with and without the weights and
   the edge mask, int32 and float32, in the node-mask-operand form, on
   slices one element off and after a fold of the vertex mask into the
   weights, timed at Q1's and Q2's steps and a masked in walk beside the
   five calls (Q2's also folded), and (phase 6) on E1's two walks on B;
   K5b `mask_count` exactly at 2^23, at V1's
   8-byte chunk, at 0, 1, 15, 17, around its one-block tile and starting
   1–15 bytes off 16, timed beside ``torch.count_nonzero``; K2 (the degree
   scan, `expand_offsets`: offsets and total in one look-back launch), K2a
   `degree_counts` and K2b (the merge-path `gather_expand`, with and
   without the in walk's ``edge_id_in`` map) exactly at Q3's second-hop
   frontier out and in, with out sizes equal to, past and below the total,
   sources off 16 bytes, at the edge lengths, all padding, over an empty
   edge list, on a Zipf frontier (a 150,000-edge row, runs of empty rows, a
   third of the sources -1) and at k = 50,000's hop as the engine chunks
   it, each timed eagerly and in a graph beside its bound and the parent's
   five launches for the same hop; then `entry.forward` (the graft entry's
   forward step: K2b, two K5 gathers, ``age > 30``) at Q3's frontier
   against its plain composition and numpy;
4. record — the recording path, with the plan cache off so that every
   call records (solves eagerly, reading each size on the host): zeroes
   the kernels' launch counts, runs the 1-hop COUNT (Q1), the 2-hop COUNT
   (Q2), the row-returning 2-hop (Q3), the variable-depth COUNT (V1), the
   variable-depth rows with a depth alias (V2) and the NOT anti-join (V3)
   through ``db.query``, reads the counts, and fails unless every kernel of
   the path launched; Q1, Q2 and V1 must equal the exact numpy counts and
   Q3, V2 and V3's rows the numpy rows (V1/V2 by a per-root breadth-first
   walk over the host CSR); then times each query (median of 5 after the
   first run), splits it into its layers (plan, solve, marshal) and reads
   the card's busy share with torch.profiler;
5. replay — the plan cache on, launch counts zeroed: the first call of
   Q1, Q2, Q3, the direct rows, their in walk, V1, V2 and V3 records and
   captures the replay as a CUDA
   graph, then 5 timed calls replay it, each equal to numpy, with the
   statement holding exactly one captured plan whose replay counter
   advanced; Q3, V2 and V3 at a lower ``k`` replay the same plan, Q3 and
   V2 at a ``k`` past the recorded buckets re-record a second variant
   (all equal to numpy); a small row query takes the direct-fetch buffer.
   Prints record, capture and replay times, the replay's layers
   (parameter upload, dispatch, device wait, fetch, marshal), its busy
   share, the launches per replay and the reserved device memory after
   each capture; fails unless every kernel launched, the bitmap-BFS
   kernels inside the V plans' replays, one degree scan and one gather a
   walk (no K2a) in Q3's, the direct rows', the in walk's and V3's, and
   no more take_pads in the in walk's than in the out walk's. Then holds the replay's kernels
   (front-pack, meta row, int16 narrowing) against their plain versions
   at Q3's shapes and at edge lengths, and times them. Then T1 (phase 9's
   query) on resident A, timed as phase 9 times it. Then the G cells
   (``distance()``): G1, a root-scan COUNT over the 8M persons through
   float parameters (recorded at r = 8000 km, r = 300 and 2500 replay the
   plan), G2, rows in miles (r = 100, then 60), and G3, a binding-
   referencing distance inside an expansion (k = 100,000 roots, r = 2000),
   on the recording path and as replays, launch counts zeroed before and
   read after each; each equals the float64 numpy haversine outside the
   boundary band (a COUNT lies between the count outside the band and that
   plus the band's slots), whose slots are printed;
5c. TRAVERSE and record rows — on A while it is resident: TR1 (the
   reference bench's TRAVERSE, `bench.py:1290`: ``out('knows')`` from the
   compiled SELECT ``uid < 50``, ``WHILE $depth < 2``), TR2 (``both``,
   MAXDEPTH 3: in hops), TR3 (``WHILE $depth < 4 AND age > 30``: the
   admission gate), TR4 (the whole closure of one person, ~8M records), S1
   (``SELECT count(*)`` over an age range), S2 (``SELECT FROM Person WHERE
   uid < :k``: record rows, parameter-generic), M1 / M2 (a rid-filtered
   MATCH returning ``p, f, f.@class``, then ``$elements``), first on the
   recording path (plan cache off, launch counts zeroed before and read
   after: K16, K10, K12, K3 and K15 must launch), then recorded, captured
   and replayed 5 times; every result equals numpy (a level-wise BFS over
   the host CSR with the reference's admission rule and emission order;
   record dicts against the host columns; TR4's ids in order, its first
   1,000,000 rows decoded and timed). BT1: TR1 x 8 through
   ``db.query_batch`` as one shared dispatch. Prints record, capture and
   replay times, launches per replay, levels, rows, layers and the busy
   share. Then holds K12 with its gate (TR3's first level, empty and
   all-true gates), K15's ID instruction (M1's mask, a compare against -2)
   and K3's offset form (TR4's largest level, the buffer's end) exactly
   against their plain versions and re-times the three rows in these
   forms;
6. SNB shape — frees the Person–knows graph (plan cache and device
   cache), builds config 5's graph (`build_snb_shape(8_000_000,
   msgs_per_person=2, avg_knows=10, seed=7)`: 24M vertices, ~80M knows
   edges with a ``creationDate`` column, 16M hasCreator edges) and prints
   both graphs' resident and peak bytes. E1 (the config-5 COUNT with an
   edge WHERE, `bench.py:357`), E2 (method-form rows with an edge alias,
   and ``.bothE()``/``.bothV()``), E3 (the IS3 shape, ORDER BY), E4 (an
   OPTIONAL left join) and E5 (the IS7 shape: a binding-referencing WHERE
   and an arm-optional probe) run first on the recording path (plan cache
   off, launch counts zeroed before and read after), then record, capture
   and replay, each second parameter value replaying the same plan; every
   result equals its numpy enumeration. Then holds `rows_with_matches`
   (K13) against its plain version at E4's shapes, at edge cases and on
   2^26 slots, and times it beside ``torch.bincount``; then E1's shapes:
   K15's edge mask (``creationDate > :d`` over the 80M ``knows`` edges,
   the replayed plan's program and parameter row) exactly against its
   plain version, timed eagerly and in a graph beside its bound, and K4
   over the ``knows`` CSR of all 24M vertices into 2^25 (padded and cut,
   two calls bit for bit), timed the same way beside ``segment_reduce``;
7. batches — ``db.query_batch`` on both graphs while each is resident (the
   Person–knows cells before phase 6 frees that graph, the SNB-shape cells
   after E1–E5), the plan cache cleared first and each statement recorded
   once at its cell's largest parameter, launch counts zeroed before each
   graph's cells and read after: BQ1/BQ2 (Q1/Q2 × 64, one shared replay),
   BQ3 (Q3 × 16, k = 1000 + 62·i: a rows group of 16 lanes, its page
   elected through K14 `group_page`), BV1 (V1 from ``uid < :k`` × 8, k =
   200 − 12·i: a variable-depth COUNT group), BV2/BV3 (V2/V3 × 8, k =
   9..16: rows groups with the bitmap BFS inside the lanes), Bmix (seven items of six
   plans: one replay each, pages elected from each plan's ladder, order
   kept), BQ3o (BQ3 with lane 15 at k = 50,000: that lane alone
   re-records), BE1 (E1 × 64, `bench.py:372-377`: a count group of 16
   lanes in 4 chunks), BE2 (E2 × 16: a rows group with edge columns and a
   lane-varying edge WHERE past the root) and BE5 (E5 × 8: a binding-reading
   mask and an OPTIONAL closing arm), BG1 (G1 × 16, r = 300 + 500·i:
   a count group) and BQD (the direct rows × 16, k = 100 − 4·i: a
   direct-fetch group). BG1 and BE1 must run on the lane axis
   (``plan.lane_axis``: one replay over the 16 lanes' parameter stack, the
   lane forms of K15, K5a, K4 and K5b inside it), and so must BQ3, BQD and
   BQ3o's lanes 0–14 (the lane forms of K15, K5b, K3, K2, K2b, K5's lane
   stride, K1 and K6/K7), and BE2 and BE5 (with them K15's stacked form over
   an arm's lane-stacked ids, and in BE5 K13's lane form), and BV1–BV3 (the
   lanes' [B, C, vb] bitmap stacks through the lane forms of K10, K11 and,
   but for BV3's NOT arm, K12). Every item equals numpy
   (BG1 outside the band); K15 launches in both graphs' batch cells. The
   lane forms are held at BG1's, BE1's and BQ3's shapes (each call of one
   eager run of the group body) against their plain versions and, lane by
   lane, against the single-lane kernels, and timed eager and in a graph
   beside their bounds and beside B single-lane launches (K15's stacked form
   and K13's lane form at BE5's and BE2's shapes, with K13's ``out``; K10's,
   K11's and K12's at BV1's, BV3's and BV2's); each
   group's captured replay is timed, and the groups of BQ3, BE5, BE2, BV2 and BV3 are
   captured anew on the lane axis and lane after lane in the same run: each
   route's launches, graph nodes, capture peak bytes and device ms a replay
   side by side. Each cell
   prints its path, each group's capture ms, graph nodes, launches per
   group replay and reserved bytes, its batch q/s (the reference's
   statistic, `bench.py:273`) beside the same items as sequential
   ``db.query`` calls, and one batch's busy share. K14 is held exactly
   against its plain version at BQ3's lane stack and at edge cases, and
   timed beside its bound and the library's slice copy;
7m. mesh — after phase 7a, while A is resident, A's twin (its host arrays
   shared) is attached with ``make_mesh(4)`` (`LocalShards` on the card):
   the sharded layout (1.98 GB beside A's 1.54 GB) is printed with the
   card's name and power limit. Launch counts zeroed, then MQ1–MQ3 (Q1–Q3,
   k = 2000), MR1 (``-knows-`` rows from ``uid < 2000``), MV1 (V1) and MTR1
   (TR1) through ``db.query`` (recorded, captured, 5 replays), each equal
   to numpy and to the single-device port's answer on A in this run and
   printed beside the single-device replay, with its busy share and
   launches per replay, and MBFS (`bfs_reachability` over ``knows`` from 8
   roots spread over the shards, depth 3, 2 replicas) against a numpy
   BFS; K2's range form, K22, K10's eid form, K23 and K24 must have
   launched. Then each is held exactly against its plain version at the
   cells' shapes and timed beside its bound (K10's eid form, the push over
   the row-sharded CSR, at MV1's level-1 frontiers out and in, with and
   without an edge mask and a gate, and on an empty frontier, also against
   the slot walk over the edge-list slices it replaced; K23, the segmented
   sum over the same CSR, at MQ2's pass against its plain CSR walk and the
   slices' walk: out and in, with and without an edge mask, ``w`` None and
   given, int32 and float32 (its sum repeated bit for bit), and a one-hub
   skew case; timed with the vertex mask folded into the weights first, as
   the engine runs it); then MQ2n: MQ2 and MBFS over
   a one-rank NCCL process group (`ProcessShards`, replays uncaptured).
   After phase 6's E cells, ME1: E1 at d = 12,000 and 15,000 on B's twin
   split four ways, equal to numpy and the single-device port;
8. deltas — after phase 7a frees A, A's twin (copied before A's upload)
   is padded with `arm_delta_maintenance(db, 65_536, 1_048_576)` (V_cap
   8,065,536 keeps vb = 2^23; NB = 2^18 buckets of BK = 8) and uploaded.
   D1 (a 1-hop COUNT over the roots ``uid < 100,000``: the pushdown on
   clean topology), Q3 (k = 2000), V1 and BQ3 record and capture, then
   the seeded write batches go through ``apply_batch`` as changefeed
   events: W1 16,384 new persons with one out and one in ``knows`` edge
   each plus 98,304 edges between base persons (131,072 slab edges), W2
   age updates on 16,384 base persons (DATA only: the cached plans must
   replay their captured graphs), W3 deletes of 4,096 slab edges by RID
   and 256 base persons (16 of them Q3 roots) with the cascade, and W4 16
   edges out of one person (its bucket overflows and the class switches
   to the K17 window scan and its hops to K10's edge-list form over the
   window; then only Q3 at k = 200, the direct rows and V1 run). After
   each batch every cell equals numpy over the live host
   arrays (the base CSR minus tombstones plus the live slab edges); no
   bucket overflows before W4; no resident tensor is reallocated. Prints
   each batch's maintainer host ms, bytes uploaded, K16 launches and the
   patches' device ms, and each cell's first and second call; launch
   counts zeroed before W1 and read after W3 (K16, K18, K10's push with
   the slab probe, K14, K15 must launch, K10's edge-list form must not)
   and again after W4 (K17 and the edge-list form must launch, the probe
   must not). K16 is held against its plain version on W1's segments,
   K18 at D1's probe, K17 at Q3 k = 200's second hop after W4, and the
   slab's part of a dirty hop at its real shape (an out hop after W3,
   the slab's whole window of 1,048,576 slots): K10's push with the probe
   against the CSR push ORed with the plain edge-list hop over the window,
   beside the parent's two launches, and the edge-list form alone, each
   timed eager and in a captured graph. TR1 runs before the writes, after
   W1 (the cleared cache records it anew) and after W2 (its stale data
   version sends the cached plan to a re-record), each equal to numpy over
   the base graph plus the events. W5 deletes a person and then writes an
   edge to it: the overlay poisons ("endpoint not in snapshot") and
   ``apply_batch`` compacts it into a clean, re-padded snapshot; D1 (back
   on the pushdown), Q3, V1, BQ3 and TR1 then equal numpy; prints the
   fold's host ms, the new snapshot's bytes uploaded and ``compactions``.
9. tiering — after phase 8, A's second twin (copied before A's upload)
   is attached with ``tier_hbm_cap_bytes`` = its adjacency bytes / 2
   (configuration T, `bench.py:507`; ``tier_block_edges`` 65,536): its
   ``knows`` edges page between a device pool and host memory, and the
   flat ``dst``/``src``/``edge_id_in``/``edge_src`` never reach the card.
   Prints each partition's V/E/W/Wp/B/P and T's resident bytes beside A's
   flat ones. Launch counts zeroed, then: T1 (the reference's tiered bench
   query, `bench.py:466-470`, u = (i·131) mod (V/4), i < 64) timed as in
   phase 5, where it ran on resident A, and the tiered/resident ratio
   (`bench.py:531`); T1c (u = (i·65,537) mod V, i < 1,024: more blocks
   than the pool holds) on the recording path, with evictions; a replay
   whose root's block is outside its footprint (the cold-miss flag, then
   clean once resident, then a re-record through the front door); T2
   (rows through the ``in`` partition, k = 100); T3 (``while:($depth <
   2)`` from 16 roots, twice; the second pass's replay median and
   launches per replay printed; T1's and T2's launches per replay too).
   K19 and K21 must have launched, and K20 must not: a replay's K19 push
   and K21 gather set the replay's one cold-miss byte themselves. Then
   holds K19–K21 exactly against their plain versions at T's pool shapes
   (K21 also on a skewed Zipf frontier and with K19 in one captured graph
   sharing one miss byte; K19,
   the push over the resident indptr and the page indirection, also
   against the slot walk over the pool it replaced; K20 alone and folded
   into K19's push, also at ``alive`` 0),
   every page evicted, an empty pool, C = 8 and in a captured graph, and
   times them (K19 also with the flag); then T4c (TR1's shape from 50 roots in a cold block: its
   recording faults blocks in, its prefetch reloads them after an eviction
   pass, a replay without the roots' block flags and re-records); then
   T_GROW (a 2-hop COUNT from ``uid < 2000``) grows the pool, and T1
   re-records and re-captures under the new generation; then T4 (TR1 on
   T: K19 inside a captured TRAVERSE replay, which launches no K20).
   Every result equals numpy over the host CSR. Prints ``stats()`` and the
   bytes loaded after each pass.

The line before the last is one JSON object with every kernel's numbers
(``launches`` from phase 5, from phase 6's replay path for
`rows_with_matches`, from phase 7 for `group_page` and the lane forms, from phase 8 for
K16–K18, K10's push with the slab probe and its edge-list form, from
phase 9 for K19–K21 (K20 0: off the
path, held and timed) and from phase 7m's cells for the mesh
kernels, each but the mesh's plus phase 5c's replay path;
K3, K12 and K15 timed in their TRAVERSE forms: the offset form on TR4's
largest level, the gated step at [1, 2^23], M1's node mask with its ID
instruction); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import functools
import gc
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from orientdb_tpu_torch.storage.bigshape import (  # noqa: E402
    numpy_1hop_count,
    numpy_2hop_count,
    numpy_config5_count,
    numpy_config5_counts,
    numpy_distance_km,
    numpy_has_out_neighbour,
    numpy_incident_rows,
    numpy_optional_rows,
    numpy_out_edge_rows,
    numpy_probe_rows,
    numpy_undirected_rows,
    numpy_var_depth_rows,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet): the
#: data sheet's highest rate for 32-bit scalar operations, so an upper bound
#: on the card's int32 compare rate too
SCALAR_OPS_PER_S = 67e12
F32_RTOL = 1e-6
SOURCE = "orientdb_tpu_torch/csrc/csr_kernels.cu"
REPLACES = {
    "scan_i32": "orientdb_tpu/ops/csr.py:129",
    "scan_f32": "orientdb_tpu/ops/csr.py:129",
    "degree_counts": "orientdb_tpu/ops/csr.py:39",
    "degree_scan_i32": "orientdb_tpu/ops/csr.py:39",
    "gather_expand": "orientdb_tpu/ops/csr.py:54",
    "compact_indices": "orientdb_tpu/ops/csr.py:185",
    "segment_sum_i32": "orientdb_tpu/ops/csr.py:227",
    "segment_sum_f32": "orientdb_tpu/ops/csr.py:227",
    "take_pad_i32": "orientdb_tpu/ops/csr.py:211",
    "take_pad_f32": "orientdb_tpu/ops/csr.py:211",
    "take_pad_b8": "orientdb_tpu/ops/csr.py:211",
    "mask_count": "orientdb_tpu/ops/csr.py:222",
    "weight_gather_i32": "orientdb_tpu/exec/tpu_engine.py:1600",
    "weight_gather_f32": "orientdb_tpu/exec/tpu_engine.py:1600",
    "front_pack": "orientdb_tpu/exec/tpu_engine.py:3030",
    "replay_meta": "orientdb_tpu/exec/tpu_engine.py:3041",
    "narrow_i16": "orientdb_tpu/exec/tpu_engine.py:3197",
    "rows_to_bitmap": "orientdb_tpu/ops/csr.py:251",
    "bitmap_hop": "orientdb_tpu/ops/csr.py:260",
    "bitmap_hop_csr": "orientdb_tpu/ops/csr.py:260",
    "bitmap_hop_probe": "orientdb_tpu/exec/tpu_engine.py:527",
    "bitmap_emit": "orientdb_tpu/exec/tpu_engine.py:475",
    "frontier_advance": "orientdb_tpu/exec/tpu_engine.py:2171",
    "rows_with_matches": "orientdb_tpu/ops/csr.py:283",
    "group_page": "orientdb_tpu/exec/tpu_engine.py:3131",
    "predicate_eval": "orientdb_tpu/ops/predicates.py:550",
    "scatter_set": "orientdb_tpu/ops/device_graph.py:382",
    "slab_scan": "orientdb_tpu/exec/tpu_engine.py:1007",
    "slab_probe": "orientdb_tpu/exec/tpu_engine.py:1061",
    "paged_hop_csr": "orientdb_tpu/storage/tiering.py:575",
    "paged_hop_miss": "orientdb_tpu/storage/tiering.py:590",
    "paged_expand": "orientdb_tpu/storage/tiering.py:606",
    "degree_counts_range": "orientdb_tpu/parallel/mesh_graph.py:258",
    "shard_gather": "orientdb_tpu/parallel/mesh_graph.py:345",
    "bitmap_hop_shard": "orientdb_tpu/parallel/mesh_graph.py:426",
    "shard_weight_pass": "orientdb_tpu/parallel/mesh_graph.py:480",
    "rowshard_hop": "orientdb_tpu/parallel/sharded.py:202",
    # the lane forms: K15, K5a, K4 and K5b under the group replay's vmap
    "predicate_eval_lanes": "orientdb_tpu/exec/tpu_engine.py:3436",
    "weight_gather_lanes_i32": "orientdb_tpu/exec/tpu_engine.py:3436",
    "segment_sum_lanes_i32": "orientdb_tpu/exec/tpu_engine.py:3436",
    "mask_count_lanes": "orientdb_tpu/exec/tpu_engine.py:3436",
    # a rows group's lane forms under the same vmap: K1 (the front-pack's
    # ranks), K3, K2, K2b, K5's lane stride, K6 and K7
    "scan_lanes_i32": "orientdb_tpu/ops/csr.py:129",
    "compact_indices_lanes": "orientdb_tpu/ops/csr.py:185",
    "degree_scan_lanes_i32": "orientdb_tpu/ops/csr.py:39",
    "gather_expand_lanes": "orientdb_tpu/ops/csr.py:54",
    "take_pad_lanes": "orientdb_tpu/ops/csr.py:211",
    "front_pack_lanes": "orientdb_tpu/exec/tpu_engine.py:3030",
    "replay_meta_lanes": "orientdb_tpu/exec/tpu_engine.py:3041",
    # past the root (BE2, BE5): K15 over lane-stacked ids, K13's lane form
    "predicate_eval_stacked": "orientdb_tpu/ops/predicates.py:550",
    "rows_with_matches_lanes": "orientdb_tpu/ops/csr.py:283",
    # the bitmap BFS under the same vmap (BV1-BV3): K10's hop, K11's
    # emission and counts, K12's level step over [B, C, vb] stacks
    "bitmap_hop_csr_lanes": "orientdb_tpu/ops/csr.py:260",
    "bitmap_emit_lanes": "orientdb_tpu/exec/tpu_engine.py:475",
    "frontier_advance_lanes": "orientdb_tpu/exec/tpu_engine.py:2171",
}
BITMAP_KERNELS = ["rows_to_bitmap", "bitmap_hop_csr", "bitmap_emit", "frontier_advance"]
REPLAY_ONLY = ("front_pack", "replay_meta", "narrow_i16")
#: the lane forms of K15, K5a, K4 and K5b, which a count group on the lane
#: axis runs (phase 7: BG1 and BE1), and of K1, K3, K2, K2b, K5's lane
#: stride, K6 and K7, which a rows group on the lane axis runs (BQ3, BQD)
#: with K15's and K5b's; their wrappers in ops/csr.py (`take_pad` with a
#: lane-stacked table: its lane stride)
ROWS_LANE_FORMS = {
    "value_cumsum_lanes": "scan_lanes_i32",
    "compact_indices_lanes": "compact_indices_lanes",
    "expand_offsets_lanes": "degree_scan_lanes_i32",
    "gather_expand_lanes": "gather_expand_lanes",
    "take_pad": "take_pad_lanes",
    "front_pack_lanes": "front_pack_lanes",
    "replay_meta_lanes": "replay_meta_lanes",
}
#: the lane forms of a rows group's arms past the root (BE2, BE5): K15 over
#: lane-stacked ids (an arm's mask that reads a parameter) and K13's lane
#: form (an OPTIONAL arm's left join)
ARM_LANE_FORMS = {
    "predicate_eval_stacked": "predicate_eval_stacked",
    "rows_with_matches_lanes": "rows_with_matches_lanes",
}
#: the lane forms of the bitmap BFS (BV1-BV3): K10's hop over the lanes'
#: [B, C, vb] frontier stack, K11's emission with a count a lane, K12's
#: level step with an alive (and emitted) count a lane
BITMAP_LANE_FORMS = {
    "bitmap_hop_csr_lanes": "bitmap_hop_csr_lanes",
    "bitmap_emit_lanes": "bitmap_emit_lanes",
    "frontier_advance_lanes": "frontier_advance_lanes",
}
#: the operands (positional indices) of a lane form that it writes in
#: place, or that a later call of its group replay writes (K12 steps the
#: frontier K10 read and the level K11 emitted from): copied when a call is
#: recorded and again for each rerun
LANE_COPIES = {"bitmap_hop_csr_lanes": (4, 7), "bitmap_emit_lanes": (0,), "frontier_advance_lanes": (0, 1)}
#: calls of each form in `LANE_COPIES` a check keeps (copies of their [B, C,
#: vb] operands, 512 MiB each at A's 8 lanes): a chunk's levels
BITMAP_LANE_CALLS = 4
LANE_FORMS = {
    "predicate_eval_lanes": "predicate_eval_lanes",
    "weight_gather_lanes": "weight_gather_lanes_i32",
    "indptr_segment_sum_lanes": "segment_sum_lanes_i32",
    "mask_count_lanes": "mask_count_lanes",
    **ROWS_LANE_FORMS,
    **ARM_LANE_FORMS,
    **BITMAP_LANE_FORMS,
}
LANE_KERNELS = tuple(dict.fromkeys(LANE_FORMS.values()))
#: the kernels only the batch path launches (phase 7)
BATCH_ONLY = ("group_page",) + LANE_KERNELS
#: the kernels only a delta-maintained snapshot launches (phase 8: on dirty
#: topology K10's push probes the slab's buckets, and its edge-list form
#: walks the slab's slots once a bucket of the class overflowed)
DELTA_ONLY = ("scatter_set", "slab_scan", "slab_probe", "bitmap_hop", "bitmap_hop_probe")
#: the kernels only a tiered snapshot launches (phase 9)
TIER_ONLY = ("paged_hop_csr", "paged_hop_miss", "paged_expand")
#: the kernels only a meshed snapshot launches (phase 7m)
MESH_ONLY = ("degree_counts_range", "shard_gather", "bitmap_hop_shard", "shard_weight_pass", "rowshard_hop")
#: the kernels no cell launches: the bool take_pad's only callers were the
#: weight pass's gathers, which the fused weight_gather now makes,
#: degree_counts' the expansion's sizing, which the degree scan
#: (degree_scan_i32) now computes in one launch, and paged_hop_miss's a
#: tiered replay's hops, whose cold-miss flag K19's push now sets in its own
#: launch (each still held against its plain version and timed)
OFF_PATH = ("take_pad_b8", "degree_counts", "paged_hop_miss")
#: the kernels of the Person–knows phases 4–5 (the OPTIONAL arm's left-join
#: count runs on the SNB-shape phase)
PK_KERNELS = [
    n for n in REPLACES
    if n != "rows_with_matches" and n not in BATCH_ONLY + DELTA_ONLY + TIER_ONLY + MESH_ONLY + OFF_PATH
]
#: the kernels a Person–knows recording run launches
RECORD_KERNELS = [n for n in PK_KERNELS if n not in REPLAY_ONLY]
#: the kernels the SNB-shape cells E1–E5 launch while recording (no bitmap
#: BFS there), and on their replays (no float32 overflow twin)
E_RECORD_KERNELS = [
    n for n in REPLACES
    if n not in REPLAY_ONLY and n not in BITMAP_KERNELS and n not in BATCH_ONLY + DELTA_ONLY + TIER_ONLY + MESH_ONLY + OFF_PATH
]
E_REPLAY_KERNELS = [
    n for n in REPLACES
    if n not in BITMAP_KERNELS and n not in BATCH_ONLY + DELTA_ONLY + TIER_ONLY + MESH_ONLY + OFF_PATH
    and n not in ("scan_f32", "segment_sum_f32", "take_pad_f32", "weight_gather_f32")
]
EDGE_LENGTHS = [0, 1, 255, 256, 257, 511, 513]
#: K1's and K3's eager times before their look-back redesign (the
#: three-pass scan, and the cast + scan + scatter compaction; `PERF.md` §6),
#: and K4's before its merge path, printed beside this run's
WAS_MS = {
    "scan_i32": 0.3601, "scan_f32": 0.3599, "compact fill": 0.0921, "compact offset": 0.1179,
    # K4's warp-a-segment design at A's shape (`PERF.md` §6)
    "segment_sum_i32": 1.1925, "segment_sum_f32": 1.1950,
    # K5's first cut: a thread an index, a byte a thread (`PERF.md` §6)
    "take_pad_i32": 0.9522, "take_pad_f32": 0.9525, "take_pad_b8": 0.6533, "mask_count": 0.0313,
}
#: K11's and K12's times before their sparse redesign, when each read every
#: byte of its [8, 2^23] bitmaps at every level (`PERF.md` §6: V1's replay
#: profile in chip run 3 of PR 12, K12 18.2 ms over 203 launches and K11
#: 12.7 ms over 267, its depth-0 launches included; the
#: eager rows of K11 and of the gated [1, 2^23] K12), printed beside this
#: run's
WAS_LEVEL_MS = {
    "K12 level, in a graph": 0.0897,
    "K12 gated, eager": 0.0333,
    "K12 gated, in a graph": 0.0116,
    "K11 count-only, in a graph": 0.0476,
    "K11 count-only, eager": 0.0531,
    "K11 emit + count, eager": 0.0667,
}
#: `PERF.md` §5's replay medians (ms) of the cells that run K1 and K3
SECTION5_REPLAY_MS = {
    "Q1": 3.265, "Q2": 6.992, "Q3": 31.646, "V1": 99.821, "E1": 12.615, "TR1": 2.160, "TR4": 30.330,
}
#: this run's replay medians (ms), by cell
REPLAY_MS = {}

Q1 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    "-knows->{as:f, where:(age < 30)} RETURN count(*) AS n"
)
Q2 = (
    "MATCH {class:Person, as:p, where:(age > 40)}-knows->{as:f}"
    "-knows->{as:g, where:(age < 30)} RETURN count(*) AS n"
)
Q3 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}"
    "-knows->{as:g, where:(age < 30)} "
    "RETURN p.uid AS p, f.uid AS f, g.uid AS g"
)
Q3_K = 2000
Q3_K_SMALLER = 1000
Q3_K_OVERFLOW = 50_000
# a 1-hop row query small enough for the direct-fetch buffer
Q_DIRECT = "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f} RETURN p.uid AS p, f.uid AS f"
Q_DIRECT_K = 100
# its in walk: the edge ids come through edge_id_in inside the gather
Q_IN = "MATCH {class:Person, as:p, where:(uid < :k)}<-knows-{as:f} RETURN p.uid AS p, f.uid AS f"
# variable-depth COUNT in the reference bench's shape (bench.py:1285)
V1 = (
    "MATCH {class:Person, as:p, where:(uid < 200)}"
    "-knows->{as:f, while:($depth < 3), where:(age < 30)} RETURN count(*) AS n"
)
#: V1 with its roots a parameter: BV1's items (k = 200 - 12·i), a
#: variable-depth COUNT group on the lane axis
V1P = V1.replace("uid < 200", "uid < :k")
# variable-depth rows, both directions, with a depth alias
V2 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}"
    "-knows-{as:f, maxDepth:2, depthAlias:d} RETURN p.uid AS p, f.uid AS f, d AS d"
)
V2_K, V2_K_SMALLER, V2_K_OVERFLOW = 16, 8, 64
# the NOT anti-join
V3 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f}, "
    "NOT {as:f}-knows->{where:(age > 70)} RETURN p.uid AS p, f.uid AS f"
)
V3_K, V3_K_SMALLER = 16, 8

# the SNB-shape cells (config 5's graph): the config-5 COUNT (bench.py:357),
# method-form rows, the IS3 shape, an OPTIONAL left join, the IS7 shape
E1 = (
    "MATCH {class:Person, as:p, where:(age > 40)}"
    ".outE('knows'){where:(creationDate > :d)}"
    ".inV(){as:f, where:(age < 30)}, "
    "{class:Message, as:m}-hasCreator->{as:f} "
    "RETURN count(*) AS n"
)
E2 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}"
    ".outE('knows'){as:e, where:(creationDate > :d)}.inV(){as:f, where:(age < 30)} "
    "RETURN p.uid AS p, f.uid AS f, e.creationDate AS cd"
)
E2_BOTH = (
    "MATCH {class:Person, as:p, where:(uid < :n)}.bothE('knows'){as:e}, "
    "{as:e}.bothV(){as:v} RETURN p.uid AS p, v.uid AS v"
)
E3 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}-knows{as:kn}-{as:f} "
    "RETURN p.uid AS p, f.uid AS f, kn.creationDate AS cd ORDER BY cd DESC, f ASC"
)
E4 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}"
    "-knows->{as:f, optional:true, where:(age > 75)} RETURN p.uid AS p, f.uid AS f"
)
E5 = (
    "MATCH {class:Person, as:p, where:(uid < :n)}-knows->{as:f, where:(age < p.age)}, "
    "{as:f}-knows{as:kn, optional:true, where:(creationDate > :d)}-{as:p} "
    "RETURN p.uid AS p, f.uid AS f, kn IS NOT NULL AS probe"
)
#: cell → (query, the recording's parameters, parameters that replay its plan)
E_CELLS = {
    "E1": (E1, {"d": 12_000}, [{"d": 15_000}, {"d": 18_500}]),
    "E2": (E2, {"n": 20_000, "d": 15_000}, [{"n": 10_000, "d": 15_000}]),
    "E2b": (E2_BOTH, {"n": 64}, [{"n": 32}]),
    "E3": (E3, {"n": 256}, [{"n": 128}]),
    "E4": (E4, {"n": 20_000}, [{"n": 10_000}]),
    "E5": (E5, {"n": 2_000, "d": 15_000}, [{"n": 1_000, "d": 15_000}]),
}

# the G cells: distance() over the Person–knows graph's lat/lng columns
G1 = "MATCH {class:Person, as:p, where:(distance(lat, lng, :x, :y) < :r)} RETURN count(*) AS n"
G2 = (
    "MATCH {class:Person, as:p, where:(distance(lat, lng, 48.0, 2.0, 'mi') < :r)} "
    "RETURN p.uid AS uid"
)
G3 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f, "
    "where:(distance(lat, lng, p.lat, p.lng) < :r)} RETURN count(*) AS n"
)
G3_K = 100_000
G_CELLS = {
    "G1": (G1, {"x": 48.0, "y": 2.0, "r": 8000.0}, [{"x": 48.0, "y": 2.0, "r": 300.0}, {"x": 48.0, "y": 2.0, "r": 2500.0}]),
    "G2": (G2, {"r": 100}, [{"r": 60}]),
    "G3": (G3, {"k": G3_K, "r": 2000.0}, []),
}
#: the kernels of the G cells (a root scan, one hop with a binding-
#: referencing mask, a rows front-pack)
G_RECORD_KERNELS = ["predicate_eval", "compact_indices", "mask_count", "degree_scan_i32", "gather_expand"]
G_REPLAY_KERNELS = G_RECORD_KERNELS + ["front_pack", "replay_meta"]


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def _time_ms(torch, fn, reps: int = 10) -> float:
    """Mean milliseconds per call over ``reps`` calls after one warm-up,
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _library_ms(torch, name, library):
    """The yardstick call's time, or None where there is none or this
    PyTorch build refuses it for these inputs."""
    if library is None:
        return None
    try:
        return _time_ms(torch, library)
    except (RuntimeError, TypeError, NotImplementedError) as e:
        print(f"library call for {name} refused: {e}")
        return None


class Kernels:
    """Comparisons and timings of each kernel, keyed by kernel name."""

    def __init__(self, torch, K):
        self.torch = torch
        self.K = K
        self.err = {name: 0.0 for name in REPLACES}
        self.rows = {}

    def same(self, name, got, want, exact: bool = True) -> None:
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            _require(g.shape == w.shape and g.dtype == w.dtype, f"{name}: shape/dtype")
            if exact:
                _require(torch.equal(g, w), f"{name}: differs from its plain version")
                continue
            diff = (g.double() - w.double()).abs()
            err = float(diff.max()) if diff.numel() else 0.0
            bound = F32_RTOL * float(w.double().abs().max()) if w.numel() else 0.0
            _require(err <= max(bound, F32_RTOL), f"{name}: |err| {err} > {bound}")
            self.err[name] = max(self.err[name], err)

    def timed(self, name, kernel, plain, library, bound_bytes: float, bound_ops: float = 0.0) -> None:
        torch = self.torch
        t_bytes = bound_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = bound_ops / SCALAR_OPS_PER_S * 1e3
        self.rows[name] = {
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "ms": _time_ms(torch, kernel),
            "plain_ms": _time_ms(torch, plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": _library_ms(torch, name, library),
        }


def old_scan_launches(n: int) -> int:
    """Kernels the earlier three-pass scan enqueued for n elements: a
    tile-sum and a tile-scan launch a level over tiles of 1,024, then one
    scan of the last level."""
    launches = 0
    while n > 1024:
        n = -(-n // 1024)
        launches += 2
    return launches + 1


def one_kernel_one_memset(torch, what: str, fn) -> str:
    """Requires that one call of ``fn`` enqueues one CUDA kernel and one
    memset, counted from the nodes of a graph that captured the call
    (libcuda's ``cuGraphGetNodes`` / ``cuGraphNodeGetType``), and says so."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    drv = ctypes.CDLL("libcuda.so.1")
    count = ctypes.c_size_t(0)
    _require(drv.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0, "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _require(drv.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0, "cuGraphGetNodes")
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _require(drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0, "cuGraphNodeGetType")
        types.append(kind.value)
    # CU_GRAPH_NODE_TYPE_KERNEL 0, CU_GRAPH_NODE_TYPE_MEMSET 2
    _require(
        len(types) == 2 and types.count(0) == 1 and types.count(2) == 1,
        f"{what}: a call enqueues graph nodes of types {types}, not one kernel and one memset",
    )
    return "1 kernel + 1 memset"


def captured_scan_replays(torch, K, ks, vals, n: int, reps: int = 1000) -> None:
    """1,000 replays of one captured K1 launch on the same look-back state:
    each replay scans the other of two inputs into a poisoned output and
    must equal the plain version, so state left from the replay before
    would show. Its launches are not counted."""
    counted = dict(K.LAUNCHES)
    inputs = [vals[:n].clone(), vals[-n:].clone()]
    wants = [K.plain_cumsum(v) for v in inputs]
    _require(not torch.equal(wants[0], wants[1]), "the two replay inputs have the same scan")
    static = inputs[0].clone()
    K.value_cumsum(static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.value_cumsum(static)
    for i in range(reps):
        static.copy_(inputs[i % 2])
        out.fill_(-7)
        graph.replay()
        ks.same("scan_i32", out, wants[i % 2])
    print(f"kernel scan_i32: {reps} replays of one captured launch (n={n}) equal the plain version")
    K.LAUNCHES.update(counted)


def segment_sum_bytes(ne: int, nseg: int, out_size: int) -> float:
    """K4's bound in bytes: each value and indptr entry read once, each
    output slot written once."""
    return 4.0 * ne + 4.0 * (nseg + 1) + 4.0 * out_size


def same_segment_sum(torch, K, ks, name, vals, indptr, out_size) -> None:
    """K4 against its plain version (int32 exactly, float32 to rtol 1e-6 of
    the largest magnitude) and against itself: a second call equal bit for
    bit."""
    got = K.indptr_segment_sum(vals, indptr, out_size)
    ks.same(name, got, K.plain_indptr_segment_sum(vals, indptr, out_size), vals.dtype == torch.int32)
    again = K.indptr_segment_sum(vals, indptr, out_size)
    _require(torch.equal(got.view(torch.int32), again.view(torch.int32)), f"{name}: two calls differ")


def print_segment_sum(torch, K, row, name, vals, indptr, out_size, shape: str, card: str) -> None:
    """K4's eager and in-graph times at one shape, beside its bound, the
    earlier design's time and (float32) `torch.segment_reduce`."""
    fn = lambda: K.indptr_segment_sum(vals, indptr, out_size)  # noqa: E731
    nseg = min(indptr.shape[0] - 1, out_size)
    bound = segment_sum_bytes(vals.shape[0], nseg, out_size) / HBM_BYTES_PER_S * 1e3
    lib = ""
    if vals.dtype == torch.float32:
        seg = lambda: torch.segment_reduce(vals, "sum", offsets=indptr)  # noqa: E731
        lib = f"; torch.segment_reduce {_time_ms(torch, seg):.4f} eager, {_graph_ms(torch, seg):.4f} in a graph"
    eager = row["ms"] if row is not None else _time_ms(torch, fn)
    print(
        f"kernel {name} at {shape}'s shape ({vals.shape[0]} values, {nseg} segments into {out_size}): "
        f"{eager:.4f} ms eager (was {WAS_MS[name]} at A's), {_graph_ms(torch, fn):.4f} ms in a graph; "
        f"bound {bound:.4f} ms{lib} [{card}]"
    )


def zipf_indptr(np, torch, dev):
    """A Zipf-degree CSR's indptr from a seed: 1M vertices (~28M edges,
    degrees Zipf(1.6) up to 1,000), one of 150,000 edges, ten runs of 5,000
    empty vertices; and the generator, to draw more from."""
    rng = np.random.default_rng(41)
    v = 1_000_000
    deg = np.minimum(rng.zipf(1.6, v), 1_000)
    deg[v // 2] = 150_000
    for start in rng.choice(v - 5_000, 10, replace=False):
        deg[start : start + 5_000] = 0
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)).to(dev)
    return indptr, rng


def check_segment_sum_degrees(np, torch, K, ks, dev) -> None:
    """K4 on `zipf_indptr`'s CSR: 1M segments, one of 150,000 values (30 of
    the kernel's 5,120-item tiles), ten runs of 5,000 empty segments, int32
    values over the whole range (the sums wrap) and float32 ones;
    ``out_size`` above and below the segment count."""
    indptr, rng = zipf_indptr(np, torch, dev)
    v = indptr.shape[0] - 1
    ne = int(indptr[-1])
    vals_i = torch.from_numpy(rng.integers(-(2**31), 2**31 - 1, ne, dtype=np.int32)).to(dev)
    vals_f = torch.from_numpy(rng.random(ne, dtype=np.float32)).to(dev)
    for name, vals in (("segment_sum_i32", vals_i), ("segment_sum_f32", vals_f)):
        for out_size in (K.bucket(v), v // 3):
            same_segment_sum(torch, K, ks, name, vals, indptr, out_size)
    print(f"kernel indptr_segment_sum: equals its plain version on a Zipf CSR ({v} segments, {ne} values)")


def _unaligned_views(torch, t, offsets):
    """Copies of ``t`` that start ``k`` elements into a buffer, for each k."""
    for k in offsets:
        buf = torch.empty(t.shape[0] + k, dtype=t.dtype, device=t.device)
        view = buf[k:]
        view.copy_(t)
        yield k, view


def check_take_pad(torch, K, ks, w_i, ok_vec, dst, gen, card: str) -> None:
    """K5a in all three dtypes, exactly: at A's weight pass (the ~80M knows
    targets into the 2^23 weights and node mask), at the edge lengths with
    -1 and past-the-end indices, with the index starting 1–3 elements off
    16 bytes (the output is always a fresh allocation); then each timed
    eagerly and in a graph beside `torch.index_select` (every index of dst
    is in range, so one index_select computes the same function)."""
    E, vb = dst.shape[0], w_i.shape[0]
    idx_rand = torch.randint(-2, vb + 2, (513,), generator=gen, device=dst.device, dtype=torch.int32)
    for name, vals, fill, elt in (
        ("take_pad_i32", w_i, 0, 4),
        ("take_pad_f32", w_i.to(torch.float32), 0.0, 4),
        ("take_pad_b8", ok_vec, False, 1),
    ):
        want = K.plain_take_pad(vals, dst, fill)
        ks.same(name, K.take_pad(vals, dst, fill), want)
        for n in EDGE_LENGTHS:
            ix = idx_rand[:n].contiguous()
            ks.same(name, K.take_pad(vals, ix, fill), K.plain_take_pad(vals, ix, fill))
            cut = vals[:n].contiguous()
            ks.same(name, K.take_pad(cut, idx_rand, fill), K.plain_take_pad(cut, idx_rand, fill))
        head = dst[: 1 << 20]
        want_head = want[: 1 << 20]
        for _k, ix in _unaligned_views(torch, head, range(1, 4)):
            ks.same(name, K.take_pad(vals, ix, fill), want_head)
        kernel = lambda v=vals, fl=fill: K.take_pad(v, dst, fl)  # noqa: E731
        library = lambda v=vals: torch.index_select(v, 0, dst)  # noqa: E731
        # bound: each index read and each value written once, the table once
        ks.timed(name, kernel, lambda v=vals, fl=fill: K.plain_take_pad(v, dst, fl), library, 4.0 * E + elt * E + elt * vb)
        row = ks.rows[name]
        print(
            f"kernel {name} at A's weight pass ({E} indices into {vb}): {row['ms']:.4f} ms eager (was "
            f"{WAS_MS[name]}), {_graph_ms(torch, kernel):.4f} in a graph; torch.index_select "
            f"{row['library_ms']:.4f} eager, {_graph_ms(torch, library):.4f} in a graph; bound "
            f"{row['bound_ms']:.4f} ms (an element gathered an index: "
            f"{(4.0 * E + 2 * elt * E) / HBM_BYTES_PER_S * 1e3:.4f}) [{card}]"
        )


def five_call_weights(K, emit, dtype, ok, node_ok, emask, eid, w):
    """The weight pass as the parent tree launched it: take_pad of the edge
    mask through eid (in walks), the vertex mask's take_pad (or the node
    mask at the endpoints), ``&``, ``.to``, take_pad of the weights, ``*``."""
    em = None if emask is None else emask if eid is None else K.take_pad(emask, eid, False)
    contrib = K.take_pad(ok, emit, False) if ok is not None else node_ok
    if em is not None:
        contrib = em if contrib is None else contrib & em
    vals = emit.new_ones(emit.shape, dtype=dtype) if contrib is None else contrib.to(dtype)
    if w is not None:
        vals = vals * K.take_pad(w, emit, 0)
    return vals


def weight_gather_bytes(e: int, ok=None, node_ok=None, emask=None, eid=None, w=None, elt: int = 4) -> float:
    """The fused gather's bound in bytes: eid and the per-edge masks read
    once, emit read once where a table is read through it (``ok`` or
    ``w``: the kernel does not read it otherwise), the output written once,
    each table read once."""
    b = elt * e + (4.0 * e if ok is not None or w is not None else 0.0)
    for t, per_edge in ((node_ok, 1), (eid, 4)):
        b += 0 if t is None else per_edge * e
    for t in (ok, emask, w):
        b += 0 if t is None else t.numel() * t.element_size()
    return b


def time_weight_gather(torch, K, what: str, card: str, emit, dtype, **kw) -> str:
    """The fused gather's eager and in-graph times on one walk beside its
    bound and the parent's five-call composition in a graph."""
    fused = lambda: K.weight_gather(emit, dtype, **kw)  # noqa: E731
    parent = lambda: five_call_weights(K, emit, dtype, kw.get("ok"), kw.get("node_ok"), kw.get("emask"), kw.get("eid"), kw.get("w"))  # noqa: E731
    bound = weight_gather_bytes(emit.shape[0], **kw) / HBM_BYTES_PER_S * 1e3
    line = (
        f"kernel weight_gather {what} ({emit.shape[0]} edges, {str(dtype).split('.')[-1]}): "
        f"{_time_ms(torch, fused):.4f} ms eager, {_graph_ms(torch, fused):.4f} in a graph; the parent's "
        f"five-call composition (with this tree's take_pad) {_graph_ms(torch, parent):.4f} in a graph; "
        f"bound {bound:.4f} ms [{card}]"
    )
    print(line)
    return line


def same_weight_gather(torch, K, ks, emit, dtype, **kw) -> None:
    """The fused gather against its plain version (int32 exactly, float32
    bit for bit) and against the five-call composition of the kernels."""
    name = "weight_gather_i32" if dtype == torch.int32 else "weight_gather_f32"
    got = K.weight_gather(emit, dtype, **kw)
    want = K.plain_weight_gather(emit, dtype, **kw)
    _require(got.dtype == want.dtype and torch.equal(got.view(torch.int32), want.view(torch.int32)),
             f"{name}: differs from its plain version")
    parent = five_call_weights(K, emit, dtype, kw.get("ok"), kw.get("node_ok"), kw.get("emask"), kw.get("eid"), kw.get("w"))
    _require(torch.equal(got.view(torch.int32), parent.view(torch.int32)), f"{name}: differs from the five-call composition")


def check_weight_gather(torch, K, ks, dg, ok_vec, w_i, gen, card: str) -> None:
    """The fused weight gather on A's walks, bit for bit against its plain
    version and the parent's five calls: the out walk (dst) and the in
    walk (src, the edge mask through edge_id_in), with and without the
    weights and the edge mask, int32 and float32; the mask-operand form
    (the node mask at the endpoints, as where E < vb); slices one element
    off; the fold of the vertex mask into the weights and the walks' gather
    of the folded weights. Then times Q1's step (ok only: the row), a
    masked in walk, and Q2's first step with a sparse and an all-true
    vertex mask, unfolded and folded."""
    dec = dg.edges["knows"]
    E, vb = dec.num_edges, w_i.shape[0]
    w_f = w_i.to(torch.float32)
    emask = torch.rand(E, generator=gen, device=dg.device) < 0.7
    node_ok = K.take_pad(ok_vec, dec.dst, False)
    for walk, emit, eid in (("out", dec.dst, None), ("in", dec.src, dec.edge_id_in)):
        for dtype, w in ((torch.int32, w_i), (torch.float32, w_f)):
            for masked in (False, True):
                for weighted in (False, True):
                    kw = dict(ok=ok_vec, emask=emask if masked else None,
                              eid=eid if masked else None, w=w if weighted else None)
                    same_weight_gather(torch, K, ks, emit, dtype, **kw)
    for dtype, w in ((torch.int32, w_i), (torch.float32, w_f)):
        same_weight_gather(torch, K, ks, dec.dst, dtype, node_ok=node_ok, emask=emask, w=w)
        for n in EDGE_LENGTHS:
            same_weight_gather(torch, K, ks, dec.dst[1 : 1 + n], dtype, ok=ok_vec, emask=emask[1 : 1 + n], w=w)
            same_weight_gather(torch, K, ks, dec.src[1 : 1 + n], dtype, node_ok=node_ok[1 : 1 + n], emask=emask, eid=dec.edge_id_in[1 : 1 + n])
    # the fold of the vertex mask into weights that fit L2 (the engine's form
    # of a step that carries weights on A), then the walks' one gather
    every = torch.zeros_like(ok_vec)
    every[: dg.num_vertices] = True  # Q2's f, unfiltered: every vertex kept
    for dtype, w in ((torch.int32, w_i), (torch.float32, w_f)):
        for ok in (ok_vec, every):
            folded = K.weight_gather(None, dtype, ok=ok, w=w)
            _require(torch.equal(folded.view(torch.int32), K.plain_weight_gather(None, dtype, ok=ok, w=w).view(torch.int32)),
                     "weight_gather: the fold differs from its plain version")
            for emit, eid in ((dec.dst, None), (dec.src, dec.edge_id_in)):
                got = K.weight_gather(emit, dtype, emask=emask, eid=eid, w=folded)
                want = five_call_weights(K, emit, dtype, ok, None, emask, eid, w)
                _require(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                         "weight_gather: a gather of folded weights differs from the five-call composition")
    print("kernel weight_gather: equals its plain version and the five-call composition on A's walks (folded too)")
    for name, dtype in (("weight_gather_i32", torch.int32), ("weight_gather_f32", torch.float32)):
        ks.timed(
            name,
            lambda d=dtype: K.weight_gather(dec.dst, d, ok=ok_vec),
            lambda d=dtype: K.plain_weight_gather(dec.dst, d, ok=ok_vec),
            None,
            weight_gather_bytes(E, ok=ok_vec),
        )
    time_weight_gather(torch, K, "Q1's step (ok)", card, dec.dst, torch.int32, ok=ok_vec)
    time_weight_gather(torch, K, "an in walk (ok, emask through edge_id_in, w)", card, dec.src, torch.int32,
                       ok=ok_vec, emask=emask, eid=dec.edge_id_in, w=w_i)
    for what, ok in (("age < 30", ok_vec), ("f unfiltered: every vertex kept", every)):
        time_weight_gather(torch, K, f"Q2's first step ({what})", card, dec.dst, torch.int32, ok=ok, w=w_i)
        folded = lambda ok=ok: K.weight_gather(dec.dst, torch.int32, w=K.weight_gather(None, torch.int32, ok=ok, w=w_i))  # noqa: E731
        print(f"kernel weight_gather Q2's first step ({what}), folded (a [vb] fold, then one gather an edge, "
              f"as the engine runs it on A): {_time_ms(torch, folded):.4f} ms eager, {_graph_ms(torch, folded):.4f} "
              f"in a graph [{card}]")


def check_mask_count(torch, K, ks, dense, card: str) -> None:
    """K5b exactly against its plain version: at 2^23 (Q1's roots), at
    V1's chunk length (8 rows), at 0, 1, 15, 17 and the edge lengths, at
    its one-block tile and past it, starting 1–15 bytes off 16; every call
    twice. Timed eagerly and in a graph at 2^23 and at V1's chunk beside
    `torch.count_nonzero`."""
    vb = dense.shape[0]
    chunk = dense[:8].contiguous()
    lengths = [0, 1, 8, 15, 16, 17, 16_384, 16_385, 1_000_003] + EDGE_LENGTHS
    cases = [dense, chunk] + [dense[:n].contiguous() for n in lengths]
    for m in cases:
        for k, view in _unaligned_views(torch, m, (0, 1, 3, 7, 15)):
            got = K.mask_count(view)
            ks.same("mask_count", got, K.plain_mask_count(m))
            ks.same("mask_count", K.mask_count(view), got)
    ks.timed("mask_count", lambda: K.mask_count(dense), lambda: K.plain_mask_count(dense),
             lambda: torch.count_nonzero(dense), vb + 4.0)
    row = ks.rows["mask_count"]
    small = lambda: K.mask_count(chunk)  # noqa: E731
    print(
        f"kernel mask_count at {vb} bytes: {row['ms']:.4f} ms eager (was {WAS_MS['mask_count']}), "
        f"{_graph_ms(torch, lambda: K.mask_count(dense)):.4f} in a graph; torch.count_nonzero "
        f"{row['library_ms']:.4f} eager, {_graph_ms(torch, lambda: torch.count_nonzero(dense)):.4f} in a graph; "
        f"bound {row['bound_ms']:.4f} ms; at V1's chunk (8 bytes): {_time_ms(torch, small):.4f} eager, "
        f"{_graph_ms(torch, small):.4f} in a graph, torch.count_nonzero {_graph_ms(torch, lambda: torch.count_nonzero(chunk)):.4f} [{card}]"
    )


def q3_frontier(torch, dec, k: int):
    """Q3's second-hop frontier on A: the f vertices of p < k in CSR order,
    -1-padded to the binding table's capacity."""
    from orientdb_tpu_torch.exec.tpu_engine import _cap_of

    f = dec.dst[: int(dec.indptr_out[k])]
    width = _cap_of(f.shape[0])
    return torch.cat([f, torch.full((width - f.shape[0],), -1, dtype=torch.int32, device=f.device)])


def check_kernels(np, torch, K, dg, card: str) -> Kernels:
    from orientdb_tpu_torch.exec.tpu_engine import _cap_of

    ks = Kernels(torch, K)
    dev = dg.device
    dec = dg.edges["knows"]
    V, E = dg.num_vertices, dec.num_edges
    vb = K.bucket(V)
    i32 = torch.int32
    age = dg.columns["age"].values
    dst, indptr = dec.dst, dec.indptr_out
    gen = torch.Generator(device=dev).manual_seed(5)

    # Q2's last-hop contributions over the edge list, and its weights
    contrib = age[dst.long()] < 30
    vals_i = contrib.to(i32)
    vals_f = contrib.to(torch.float32)
    univ = torch.arange(vb, dtype=i32, device=dev)
    ok_vec = torch.cat([age < 30, torch.zeros(vb - V, dtype=torch.bool, device=dev)])
    root_mask = univ < Q3_K
    srcs = q3_frontier(torch, dec, Q3_K)

    # -- K1 scans: every form, at Q2's weights and around the tile -----------
    from orientdb_tpu_torch.ops import _kernels

    lib = _kernels.load()
    for what, scratch, tile in (("K1", lib.csr_scan_scratch, K._TILE), ("K3", lib.csr_compact_scratch, K._COMPACT_TILE)):
        # the plain versions' tiles mirror the library's: a state word a tile
        _require(scratch(tile) == 16 and scratch(tile + 1) == 24, f"{what}'s tile is not csr.py's {tile}")
    tile = K._TILE
    tile_lengths = sorted(
        {0, 1, 4097 * max(tile, K._COMPACT_TILE) + 5}
        | {n for t in (tile, K._COMPACT_TILE) for n in (t - 1, t, t + 1, 2 * t + 1)}
    )
    for name, vals in (("scan_i32", vals_i), ("scan_f32", vals_f)):
        exact = vals.dtype == i32
        for n in [E] + tile_lengths + EDGE_LENGTHS:
            v = vals[:n]
            for excl in (False, True):
                ks.same(name, K._scan(v, excl), K.plain_cumsum(v, excl), exact)
            inc = K.plain_cumsum(v)
            want = inc[-1] if n else torch.zeros((), dtype=v.dtype, device=dev)
            ks.same(name, K.exclusive_cumsum_total(v), (inc - v, want), exact)
            ks.same(name, K.value_sum(v), want, exact)
    for n in [E] + tile_lengths + EDGE_LENGTHS:
        ks.same("scan_i32", K.mask_cumsum(contrib[:n]), K.plain_cumsum(contrib[:n].to(i32)))
    captured_scan_replays(torch, K, ks, vals_i, tile_lengths[-1])
    for name, vals in (("scan_i32", vals_i), ("scan_f32", vals_f)):
        ks.timed(
            name,
            lambda v=vals: K.value_cumsum(v),
            lambda v=vals: K.plain_cumsum(v),
            lambda v=vals: torch.cumsum(v, 0, dtype=v.dtype),
            8.0 * E,
        )
        row = ks.rows[name]
        print(
            f"kernel {name} at n={E}: {row['ms']:.4f} ms eager (was {WAS_MS[name]}), "
            f"{_graph_ms(torch, lambda v=vals: K.value_cumsum(v)):.4f} ms in a graph; torch.cumsum "
            f"{row['library_ms']:.4f} eager, {_graph_ms(torch, lambda v=vals: torch.cumsum(v, 0, dtype=v.dtype)):.4f} "
            f"in a graph; bound {row['bound_ms']:.4f} ms; "
            f"sum alone {_time_ms(torch, lambda v=vals: K.value_sum(v)):.4f} eager, "
            f"{_graph_ms(torch, lambda v=vals: K.value_sum(v)):.4f} in a graph (bound {4.0 * E / 3.35e12 * 1e3:.4f}); "
            f"offsets + total {_graph_ms(torch, lambda v=vals: K.exclusive_cumsum_total(v)):.4f} in a graph"
        )
    print(
        f"kernel scan_i32 launches per _scan call at n={E}: "
        f"{one_kernel_one_memset(torch, 'value_cumsum', lambda: K.value_cumsum(vals_i))} "
        f"(offsets + total: {one_kernel_one_memset(torch, 'exclusive_cumsum_total', lambda: K.exclusive_cumsum_total(vals_i))}; "
        f"sum alone: {one_kernel_one_memset(torch, 'value_sum', lambda: K.value_sum(vals_i))}); "
        f"the three-pass scan before enqueued {old_scan_launches(E)} kernels"
    )

    # -- K3 compaction (both of the reference's regimes) ----------------------
    dense = ok_vec & (univ < V)
    for mask, out_size in (
        (root_mask, _cap_of(Q3_K)),
        (dense, _cap_of(int(dense.sum()))),
        (dense, 1000),  # truncation
    ):
        ks.same(
            "compact_indices",
            K.compact_indices(mask, out_size),
            K.plain_compact_indices(mask, out_size),
        )
    for n in EDGE_LENGTHS + tile_lengths:
        m = contrib[:n] if n > len(dense) else dense[:n]
        for out_size in (8, K.bucket(max(int(m.sum()), 1)), K.bucket(max(n, 1))):
            ks.same("compact_indices", K.compact_indices(m, out_size), K.plain_compact_indices(m, out_size))
    out_size = _cap_of(Q3_K)
    ks.timed(
        "compact_indices",
        lambda: K.compact_indices(root_mask, out_size),
        lambda: K.plain_compact_indices(root_mask, out_size),
        lambda: torch.nonzero(root_mask),
        vb + 4.0 * out_size,
    )
    row = ks.rows["compact_indices"]
    print(
        f"kernel compact_indices, fill form at Q3's roots ({Q3_K} of {vb} slots into {out_size}): "
        f"{row['ms']:.4f} ms eager (was {WAS_MS['compact fill']}), "
        f"{_graph_ms(torch, lambda: K.compact_indices(root_mask, out_size)):.4f} ms in a graph; "
        f"torch.nonzero {row['library_ms']:.4f} eager (it reads its size on the host: no graph); "
        f"bound {row['bound_ms']:.4f} ms; per call {one_kernel_one_memset(torch, 'compact_indices fill form', lambda: K.compact_indices(root_mask, out_size))}; "
        f"before: a cast, {old_scan_launches(vb)} scan kernels and a scatter"
    )

    # -- K5b popcount ---------------------------------------------------------
    check_mask_count(torch, K, ks, dense, card)

    # -- K2 degree scan + K2b merge-path gather on Q3's frontier --------------
    check_expansion(np, torch, K, ks, dg, srcs, card)

    # -- K4 segment sums over the edge list into vb (merge path) -------------
    for name, vals in (("segment_sum_i32", vals_i), ("segment_sum_f32", vals_f)):
        for out_size in (vb, V // 3):  # padded past nseg, and cut below it
            same_segment_sum(torch, K, ks, name, vals, indptr, out_size)
        for n in EDGE_LENGTHS:
            ip = torch.clamp(indptr[: n + 1], max=n).contiguous() if n else indptr[:1].clone() * 0
            same_segment_sum(torch, K, ks, name, vals[:n].contiguous(), ip, K.bucket(max(n, 1)))
        ks.timed(
            name,
            lambda v=vals: K.indptr_segment_sum(v, indptr, vb),
            lambda v=vals: K.plain_indptr_segment_sum(v, indptr, vb),
            lambda v=vals: torch.segment_reduce(v, "sum", offsets=indptr),
            segment_sum_bytes(E, V, vb),
        )
        print_segment_sum(torch, K, ks.rows[name], name, vals, indptr, vb, "A", card)
    check_segment_sum_degrees(np, torch, K, ks, dev)

    # -- K5a padding-safe gathers and the fused weight gather ------------------
    w_i = K.indptr_segment_sum(vals_i, indptr, vb)
    check_take_pad(torch, K, ks, w_i, ok_vec, dst, gen, card)
    check_weight_gather(torch, K, ks, dg, ok_vec, w_i, gen, card)
    torch.cuda.synchronize()
    return ks


def expand_bounds(width: int, live_srcs: int, total: int, size: int, mapped: bool = False):
    """K2's and K2b's bounds in ms at one shape: the degree scan reads each
    source, a live source's two indptr entries, and writes each offset and
    the total; the gather reads 12 bytes a source (its source, offset and
    indptr entry), a neighbour (and, mapped, an edge-map entry) a live slot,
    and writes 12 bytes a bucket slot."""
    live = min(total, size)
    scan = 8.0 * width + 8.0 * live_srcs + 4.0
    gather = 12.0 * width + (8.0 if mapped else 4.0) * live + 12.0 * size
    return scan / HBM_BYTES_PER_S * 1e3, gather / HBM_BYTES_PER_S * 1e3


def earlier_hop(K, indptr, nbrs, srcs, size, emap=None):
    """The parent's launches for one one-hop expansion, on this tree's
    kernels: K2a and K1's sum (the chunk count), K2a and K1's offsets and
    total again, the gather, and the in walk's take_pad over the map."""
    K.value_sum(K.degree_counts(indptr, srcs))
    offsets, total = K.exclusive_cumsum_total(K.degree_counts(indptr, srcs))
    row, pos, nbr = K.gather_expand(indptr, nbrs, srcs, offsets, total, size)
    return row, pos if emap is None else K.take_pad(emap, pos, -1), nbr


def one_hop(K, indptr, nbrs, srcs, size, emap=None):
    """This tree's launches for the same expansion: one degree scan, one
    gather (the map read inside it)."""
    return K.gather_expand(indptr, nbrs, srcs, *K.expand_offsets(indptr, srcs), size, emap)


def time_expansion(torch, K, what: str, card: str, indptr, nbrs, srcs, emap=None) -> None:
    """Prints, on one line, the eager and in-graph times of K2a, K1's sum of
    its counts, K2's degree scan and K2b (mapped where ``emap`` is given) at
    one shape, beside their bounds, the plain versions' times, and the whole
    hop as the parent launched it and as this tree does."""
    from orientdb_tpu_torch.exec.tpu_engine import _cap_of

    offsets, total = K.expand_offsets(indptr, srcs)
    t = int(total)
    size = _cap_of(t)
    width, live_srcs = srcs.shape[0], int((srcs >= 0).sum())
    b_scan, b_gather = expand_bounds(width, live_srcs, t, size, emap is not None)
    counts = K.degree_counts(indptr, srcs)
    fns = {
        "degree_counts": lambda: K.degree_counts(indptr, srcs),
        "K1 sum": lambda: K.value_sum(counts),
        "K1 offsets + total": lambda: K.exclusive_cumsum_total(counts),
        "degree_scan_i32": lambda: K.expand_offsets(indptr, srcs),
        "gather_expand": lambda: K.gather_expand(indptr, nbrs, srcs, offsets, total, size, emap),
        "parent's hop": lambda: earlier_hop(K, indptr, nbrs, srcs, size, emap),
        "this hop": lambda: one_hop(K, indptr, nbrs, srcs, size, emap),
    }
    times = {name: (_time_ms(torch, fn), _graph_ms(torch, fn)) for name, fn in fns.items()}
    plain = {
        "degree_scan_i32": _time_ms(torch, lambda: K.plain_expand_offsets(indptr, srcs)),
        "gather_expand": _time_ms(torch, lambda: K.plain_gather_expand(indptr, nbrs, srcs, offsets, total, size, emap)),
    }
    print(
        f"kernel K2/K2b at {what} ({width} sources, {live_srcs} live, {t} slots into {size}"
        f"{', edge map' if emap is not None else ''}), ms eager / in a graph: "
        + ", ".join(f"{n} {e:.4f} / {g:.4f}" for n, (e, g) in times.items())
        + f"; bounds: degree scan {b_scan:.4f}, gather {b_gather:.4f}; plain: degree scan "
        f"{plain['degree_scan_i32']:.4f}, gather {plain['gather_expand']:.4f} [{card}]"
    )


def check_expansion(np, torch, K, ks, dg, srcs, card: str) -> None:
    """K2a (`degree_counts`), K2 (`expand_offsets`, the degree scan) and K2b
    (`gather_expand`, the merge-path gather) exactly against their plain
    versions: at Q3's second-hop frontier on A, out and in (the in walk's
    ``edge_id_in`` read inside the gather), with out sizes equal to, past
    and below the total (a replay that outgrew its bucket: every slot
    live), the sources one element off 16 bytes; at the edge lengths and
    all padding; over an empty edge list; on `zipf_indptr`'s CSR from a
    frontier of every vertex with a third of them -1 (the 150,000-edge row,
    the runs of empty rows); and at Q3's second hop for k = 50,000 as the
    engine chunks it. Then times them at Q3's frontier (the JSON rows) and
    at the k = 50,000 hop, eagerly and in a graph, beside the parent's
    launches for the same hop."""
    from orientdb_tpu_torch.exec.tpu_engine import _cap_of
    from orientdb_tpu_torch.utils.config import config

    dev, i32 = dg.device, torch.int32
    dec = dg.edges["knows"]

    def same_all(indptr, nbrs, s, emap=None, sizes=None):
        ks.same("degree_counts", K.degree_counts(indptr, s), K.plain_degree_counts(indptr, s))
        offsets, total = K.expand_offsets(indptr, s)
        ks.same("degree_scan_i32", (offsets, total), K.plain_expand_offsets(indptr, s))
        t = int(total)
        for size in sizes or (_cap_of(t),):
            for m in (None, emap) if emap is not None else (None,):
                ks.same(
                    "gather_expand",
                    K.gather_expand(indptr, nbrs, s, offsets, total, size, m),
                    K.plain_gather_expand(indptr, nbrs, s, offsets, total, size, m),
                )
        return t

    walks = (("out", dec.indptr_out, dec.dst, None), ("in", dec.indptr_in, dec.src, dec.edge_id_in))
    for _d, indptr, nbrs, emap in walks:
        t = same_all(indptr, nbrs, srcs, emap)
        same_all(indptr, nbrs, srcs, emap, (t, _cap_of(t) * 4, max(t // 4, 1)))
        same_all(indptr, nbrs, srcs[1:], emap)  # sources off 16 bytes
        for n in EDGE_LENGTHS:
            same_all(indptr, nbrs, srcs[:n].contiguous(), emap)
            same_all(indptr, nbrs, torch.full((n,), -1, dtype=i32, device=dev), emap)  # all padding
    empty = torch.zeros(1001, dtype=i32, device=dev)
    same_all(empty, empty[:0], srcs[:777].contiguous() % 1000, empty[:0], (8, 4096))  # E = 0
    zip_ip, rng = zipf_indptr(np, torch, dev)
    zv, ze = zip_ip.shape[0] - 1, int(zip_ip[-1])
    gen = torch.Generator(device=dev).manual_seed(43)
    zip_nbrs = torch.randint(0, zv, (ze,), generator=gen, device=dev, dtype=i32)
    zip_map = torch.randperm(ze, generator=gen, device=dev).to(i32)
    zip_srcs = torch.arange(zv, dtype=i32, device=dev)
    zip_srcs[torch.from_numpy(rng.random(zv) < 1 / 3).to(dev)] = -1
    zt = same_all(zip_ip, zip_nbrs, zip_srcs, zip_map)
    print(f"kernel K2/K2b: equal their plain versions on a Zipf frontier ({zv} sources, a third -1, {zt} slots)")
    # Q3's second hop at k = 50,000, as the engine chunks it
    big = q3_frontier(torch, dec, Q3_K_OVERFLOW)
    width, big_live = big.shape[0], int((big >= 0).sum())
    big_total = same_all(dec.indptr_out, dec.dst, big)
    n_chunks = max(1, -(-_cap_of(big_total) // max(1, config.max_expansion_cap)))
    chunk = big[: -(-width // n_chunks)]
    same_all(dec.indptr_out, dec.dst, chunk, dec.edge_id_in)

    # the JSON rows: Q3's second hop (out), as the replay runs it
    offsets, total = K.expand_offsets(dec.indptr_out, srcs)
    size = _cap_of(int(total))
    live = int((srcs >= 0).sum())
    b_scan, b_gather = expand_bounds(srcs.shape[0], live, int(total), size)
    ms = HBM_BYTES_PER_S / 1e3
    ks.timed(
        "degree_counts",
        lambda: K.degree_counts(dec.indptr_out, srcs),
        lambda: K.plain_degree_counts(dec.indptr_out, srcs),
        None,
        4.0 * srcs.shape[0] + 8.0 * live + 4.0 * srcs.shape[0],
    )
    ks.timed(
        "degree_scan_i32",
        lambda: K.expand_offsets(dec.indptr_out, srcs),
        lambda: K.plain_expand_offsets(dec.indptr_out, srcs),
        None,
        b_scan * ms,
    )
    ks.timed(
        "gather_expand",
        lambda: K.gather_expand(dec.indptr_out, dec.dst, srcs, offsets, total, size),
        lambda: K.plain_gather_expand(dec.indptr_out, dec.dst, srcs, offsets, total, size),
        None,
        b_gather * ms,
    )
    print(
        f"kernel degree_scan_i32 per call at Q3's frontier: "
        f"{one_kernel_one_memset(torch, 'expand_offsets', lambda: K.expand_offsets(dec.indptr_out, srcs))}"
    )
    for what, indptr, nbrs, s, emap in (
        ("Q3's second hop", dec.indptr_out, dec.dst, srcs, None),
        ("Q3's second hop, in", dec.indptr_in, dec.src, srcs, dec.edge_id_in),
        (f"k={Q3_K_OVERFLOW}'s second hop, chunk 1 of {n_chunks}", dec.indptr_out, dec.dst, chunk, None),
        (f"k={Q3_K_OVERFLOW}'s second hop, chunk 1 of {n_chunks}, in", dec.indptr_in, dec.src, chunk, dec.edge_id_in),
        ("the Zipf frontier", zip_ip, zip_nbrs, zip_srcs, zip_map),
    ):
        time_expansion(torch, K, what, card, indptr, nbrs, s, emap=emap)
    sizing = lambda: K.expand_offsets(dec.indptr_out, big)  # noqa: E731
    print(
        f"kernel degree_scan_i32 at k={Q3_K_OVERFLOW}'s sizing scan ({width} sources, {big_total} slots): "
        f"{_time_ms(torch, sizing):.4f} ms eager, {_graph_ms(torch, sizing):.4f} in a graph; "
        f"bound {expand_bounds(width, big_live, 0, 0)[0]:.4f} [{card}]"
    )
    del zip_nbrs, zip_map, zip_srcs, zip_ip, big, chunk


def numpy_forward(np, indptr, dst, srcs, age, present, out_size: int):
    """`entry.forward` in numpy: the sources' CSR slices in order, -1 past
    the total, the reached vertices kept where their age is present and
    above 30."""
    s = np.where(srcs >= 0, srcs, 0)
    counts = np.where(srcs >= 0, indptr[s + 1] - indptr[s], 0).astype(np.int64)
    total = int(counts.sum())
    live = min(total, out_size)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    row = np.repeat(np.arange(srcs.shape[0]), counts)[:live]
    pos = (indptr[s][row] + np.arange(live) - offsets[row]).astype(np.int64)
    nbr = dst[pos].astype(np.int64)
    mask = present[nbr] & (age[nbr] > 30)
    out = [np.full(out_size, -1, np.int64) for _ in range(3)] + [np.zeros(out_size, bool)]
    out[0][:live], out[1][:live], out[2][:live], out[3][:live] = row, pos, np.where(mask, nbr, -1), mask
    return out


def check_forward(np, torch, K, dg, snap, card: str) -> None:
    """The graft entry's forward step in the port (`entry.forward`: K2b, two K5
    gathers, the mask) on A at Q3's second-hop frontier: equal to its
    plain composition and to numpy, exactly, in all four outputs; timed
    eagerly and in a graph."""
    from orientdb_tpu_torch.entry import forward
    from orientdb_tpu_torch.exec.tpu_engine import _cap_of

    dec = dg.edges["knows"]
    age = dg.columns["age"]
    srcs = q3_frontier(torch, dec, Q3_K)
    offsets, total = K.expand_offsets(dec.indptr_out, srcs)
    size = _cap_of(int(total))
    args = (dec.indptr_out, dec.dst, srcs, offsets, total, age.values, age.present, size)
    got = forward(*args)
    row, pos, nbr = K.plain_gather_expand(dec.indptr_out, dec.dst, srcs, offsets, total, size)
    mask = (nbr >= 0) & K.plain_take_pad(age.present, nbr, False) & (K.plain_take_pad(age.values, nbr, 0) > 30)
    plain = (row, pos, torch.where(mask, nbr, -1), mask)
    for g, w in zip(got, plain):
        _require(g.dtype == w.dtype and torch.equal(g, w), "entry.forward differs from its plain composition")
    host = snap.edge_classes["knows"]
    col = snap.v_columns["age"]
    want = numpy_forward(np, host.indptr_out.astype(np.int64), host.dst, srcs.cpu().numpy(), col.values, col.present, size)
    for g, w in zip(got, want):
        _require(np.array_equal(g.cpu().numpy().astype(w.dtype), w), "entry.forward differs from numpy")
    fn = lambda: forward(*args)  # noqa: E731
    print(
        f"forward (entry.forward at Q3's second hop: {srcs.shape[0]} sources, {int(total)} slots into {size}, "
        f"{int(got[3].sum())} kept): equals its plain composition and numpy; {_time_ms(torch, fn):.4f} ms eager, "
        f"{_graph_ms(torch, fn):.4f} in a graph [{card}]"
    )


def check_bitmap_kernels(torch, K, ks, dg) -> None:
    """K9–K12 against their plain versions at V1's shapes: one chunk of 8
    binding rows (the roots 0..7), vb = bucket(V) = 2^23, the ~80M knows
    edges in out-CSR order; on the roots and on two live BFS levels, in
    both directions, with an edge mask, a WHILE gate, and at the edge
    cases. Every result is bool or int32 and must be equal. Then times."""
    from orientdb_tpu_torch.exec.tpu_engine import TpuMatchSolver

    dev = dg.device
    i32, b8 = torch.int32, torch.bool
    dec = dg.edges["knows"]
    V, E = dg.num_vertices, dec.num_edges
    vb = K.bucket(V)
    C = TpuMatchSolver._var_chunk_rows(512, vb)
    _require(C == 8, f"V1's chunk is {C} rows, not 8")
    src, dst = dec.edge_src, dec.dst
    age = dg.columns["age"].values
    pad = torch.zeros(vb - V, dtype=b8, device=dev)
    young = torch.cat([age < 30, pad])  # V1's node mask
    gate = torch.cat([age < 40, pad])  # a vertex WHILE gate
    gen = torch.Generator(device=dev).manual_seed(9)
    emask = torch.rand(E, generator=gen, device=dev) < 0.7

    def same(name, got, want):
        ks.same(name, got, want)

    # -- K9 ------------------------------------------------------------------
    roots = torch.arange(C, dtype=i32, device=dev)
    odd = torch.tensor([-1, 5, vb + 3, -7, 0, V - 1, -1, 12], dtype=i32, device=dev)
    for rows in (roots, odd, torch.full((C,), -1, dtype=i32, device=dev), roots[:0]):
        same("rows_to_bitmap", K.rows_to_bitmap(rows, vb), K.plain_rows_to_bitmap(rows, vb))
    fr0 = K.rows_to_bitmap(roots, vb)
    alive0 = K.mask_count(roots >= 0)

    # -- K10: two live levels, out and in, masked, gated, empty cases -----------
    def hop_both(act, emit, m, fr, g=None, alive=None):
        got = K.bitmap_hop(act, emit, m, fr, gate=g, alive=alive)
        same("bitmap_hop", got, K.plain_bitmap_hop(act, emit, m, fr, g, alive))
        return got

    fr1 = hop_both(src, dst, None, fr0, alive=alive0)
    fr2 = hop_both(src, dst, None, fr1, alive=K.mask_count(fr1.view(-1)))
    _require(int(fr2.sum()) > 100 * C, "level 2 of the check is not live")
    hop_both(dst, src, None, fr1)  # the in direction
    hop_both(src, dst, emask, fr1)  # masked edges
    hop_both(src, dst, None, fr1, g=gate)  # WHILE gate at the active endpoint
    acc = K.bitmap_hop(src, dst, None, fr1)  # both directions, ORed in place
    K.bitmap_hop(dst, src, None, fr1, out=acc)
    same("bitmap_hop", acc, K.plain_bitmap_hop(src, dst, None, fr1) | K.plain_bitmap_hop(dst, src, None, fr1))
    zero_fr = torch.zeros_like(fr1)
    hop_both(src, dst, None, zero_fr, alive=torch.zeros((), dtype=i32, device=dev))
    empty = src[:0]
    hop_both(empty, empty, None, fr1)
    hop_both(src, dst, None, K.rows_to_bitmap(torch.full((C,), -1, dtype=i32, device=dev), vb))
    # duplicate targets with mixed activity, and endpoints to clip
    few = torch.randint(0, 3, (4096,), generator=gen, device=dev, dtype=i32)
    act = torch.randint(-2, 64, (4096,), generator=gen, device=dev, dtype=i32)
    small = torch.rand((C, 64), generator=gen, device=dev) < 0.3
    hop_both(act, few, None, small)
    hop_both(act, few + 62, emask[:4096].contiguous(), small)

    # -- K10's CSR form at V1's shapes: the engine's hop ------------------------
    csr_out = (dec.indptr_out, dst, None)
    csr_in = (dec.indptr_in, dec.src, dec.edge_id_in)  # the mask through eid
    dense = torch.ones_like(fr1)
    fr33 = K.bitmap_hop_csr(*csr_out, None, K.rows_to_bitmap(torch.arange(33, dtype=i32, device=dev), vb))
    for fr in (fr0, fr1, fr2, dense, fr33, zero_fr):
        alive = K.mask_count(fr.view(-1))
        for hop in (csr_out, csr_in):
            for m, g in ((None, None), (emask, None), (None, gate), (emask, gate)):
                got = K.bitmap_hop_csr(*hop, m, fr, gate=g, alive=alive)
                same("bitmap_hop_csr", got, K.plain_bitmap_hop_csr(*hop, m, fr, g, alive))
        acc = K.bitmap_hop_csr(*csr_out, emask, fr)  # both directions, ORed in place
        K.bitmap_hop_csr(*csr_in, emask, fr, out=acc)
        same("bitmap_hop_csr", acc,
             K.plain_bitmap_hop_csr(*csr_out, emask, fr) | K.plain_bitmap_hop_csr(*csr_in, emask, fr))
    # the CSR form equals the edge-list form over the edges it expands to
    same("bitmap_hop_csr", K.bitmap_hop_csr(*csr_out, emask, fr2), K.bitmap_hop(src, dst, emask, fr2))
    same("bitmap_hop_csr", K.bitmap_hop_csr(*csr_in, None, fr2), K.bitmap_hop(dst, src, None, fr2))

    # -- K11: open and close emissions, each output --------------------------
    bound = torch.tensor([-2, -1, 0, 5, vb - 1, -2, 7, 3], dtype=i32, device=dev)
    hits = torch.nonzero(fr2[:, :V]).to(i32)  # a reached (row, vertex) per row
    for r in range(C):
        rv = hits[hits[:, 0] == r]
        if r % 2 == 0 and rv.shape[0]:
            bound[r] = rv[0, 1]
    for reached in (fr0, fr1, fr2, zero_fr, dense):
        for b in (None, bound):
            got = K.bitmap_emit(reached, young, b, emit=True, any_row=True, count=True)
            same("bitmap_emit", got, K.plain_bitmap_emit(reached, young, b, True, True, True))
            for flags in ((False, False, True), (False, True, False), (False, True, True), (True, False, False)):
                # count-only (the COUNT's depth 0), the NOT arm's last step,
                # and with ``b`` the close arm's O(C) form
                part = K.bitmap_emit(reached, young, b, *flags)
                for x, want in zip(part, got):
                    _require(x is None or torch.equal(x, want), "bitmap_emit: an output alone differs")
    same("bitmap_emit", K.bitmap_emit(small, few[:64] > 0, None, True, True, True),
         K.plain_bitmap_emit(small, few[:64] > 0, None, True, True, True))

    # -- K12: the level step, in place, gated, with the folded count -------------
    for nxt, vis in ((fr1, fr0), (fr1, fr0 | fr1), (fr2, fr0 | fr1), (fr2, zero_fr), (zero_fr, fr2), (dense, fr2),
                     (small, small.roll(1, 1))):
        vb_n = nxt.shape[1]
        for g in (None, gate if vb_n == vb else None):
            for nd, b in ((None, None), (young, None), (young, bound)):
                if vb_n != vb and nd is not None:
                    nd, b = few[:vb_n] > 0, None if b is None else bound.clamp(max=vb_n - 1)
                n1, v1, n2, v2 = nxt.clone(), vis.clone(), nxt.clone(), vis.clone()
                got = K.frontier_advance(n1, v1, g, nd, b)
                want = K.plain_frontier_advance(n2, v2, g, nd, b)
                got, want = (got, want) if nd is not None else ((got,), (want,))
                same("frontier_advance", (n1, v1, *got), (n2, v2, *want))
    torch.cuda.synchronize()

    # -- times at V1's shapes -------------------------------------------------------
    ks.timed(
        "rows_to_bitmap",
        lambda: K.rows_to_bitmap(roots, vb),
        lambda: K.plain_rows_to_bitmap(roots, vb),
        None,  # F.one_hot refuses the -1 ids and returns int64
        4.0 * C + C * vb,
    )
    alive1 = K.mask_count(fr1.view(-1))
    in_csr = None
    try:
        # the hop as one sparse product: counts of active in-edges per
        # (vertex, row), the transposed adjacency in CSR (rows = dst)
        crow = torch.cat([dec.indptr_in, dec.indptr_in[-1:].expand(vb - V)])
        in_csr = torch.sparse_csr_tensor(
            crow, dec.src, torch.ones(E, device=dev), size=(vb, vb)
        )
        fr1_t = fr1.t().float().contiguous()
    except (RuntimeError, TypeError) as e:
        print(f"library call for bitmap_hop refused: {e}")
    # the edge-list form must read every edge's active endpoint, and the
    # emitted endpoint of each edge whose endpoint is active
    act_edges = int(fr1.any(0)[src.long()].sum())
    ks.timed(
        "bitmap_hop",
        lambda: K.bitmap_hop(src, dst, None, fr1, alive=alive1),
        lambda: K.plain_bitmap_hop(src, dst, None, fr1, None, alive1),
        None if in_csr is None else (lambda: torch.sparse.mm(in_csr, fr1_t)),
        4.0 * E + 4.0 * act_edges + 2.0 * C * vb + 4.0,
    )
    time_bitmap_hop_csr(torch, K, ks, dg, fr0, fr1, fr2, dense, fr33, zero_fr, emask, gate, in_csr)
    time_level_steps(torch, K, ks, fr0, fr1, fr2, K.bitmap_hop_csr(*csr_out, None, fr2), dense, young, bound)
    torch.cuda.synchronize()
    print(f"bitmap kernels: equal their plain versions at C={C}, vb={vb}, E={E}")


def nonzero_groups(torch, bm) -> int:
    """The 16-byte groups of a [C, vb] bitmap that hold a set byte: the
    groups K11 and K12 touch beyond their one read (set bytes where vb is
    not a multiple of 16)."""
    C, vb = bm.shape
    if vb % 16:
        return int(bm.sum())
    return int(bm.view(C, vb // 16, 16).any(-1).sum())


def level_step_bytes(torch, nxt, gate=None, node=None, bound=None) -> float:
    """The bytes K12 must move for this level: nxt read once, and for each
    non-zero 16-byte group of it visited loaded and stored, nxt stored, and
    gate and node loaded (16 bytes each); bound read; the counts written.
    A dense level comes to 4·C·vb."""
    C, vb = nxt.shape
    per = 48.0 + (16.0 if gate is not None else 0.0) + (16.0 if node is not None else 0.0)
    return (
        1.0 * C * vb + per * nonzero_groups(torch, nxt) + 4.0 + (4.0 if node is not None else 0.0)
        + (4.0 * C if bound is not None else 0.0)
    )


def emit_bytes(torch, reached, emit: bool, bound=None) -> float:
    """The bytes K11 must move: reached read once, 16 bytes of node a
    non-zero group, the bitmap written when asked for, the count; with
    ``bound`` and no bitmap only reached[c, bound[c]] and node[bound[c]]
    (and bound itself) can matter."""
    C, vb = reached.shape
    if bound is not None and not emit:
        return 4.0 * C + 2.0 * C + 4.0
    return 1.0 * C * vb + 16.0 * nonzero_groups(torch, reached) + (1.0 * C * vb if emit else 0.0) + 4.0


def _copies(tensors, n: int):
    """An iterator over ``n`` fresh copies of ``tensors``, one a call of an
    in-place kernel: a second call on the same copy would time a level its
    first call already emptied."""
    return iter([tuple(t.clone() for t in tensors) for _ in range(n)])


def _fresh_ms(torch, fn, tensors, reps: int = 10, graph: bool = False, trials: int = 3) -> float:
    """Mean ms of ``fn(*copy)`` over ``reps`` calls, each on its own fresh
    copy of ``tensors`` (``fn`` may change them in place). Eager: the calls
    between CUDA events. In a graph: the ``reps`` calls captured in one
    graph, as a captured plan runs them among its other launches, replayed
    ``trials`` times over refreshed copies (the refresh outside the
    events)."""
    ins = [tuple(t.clone() for t in tensors) for _ in range(reps + 1)]
    fn(*ins[-1])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if not graph:
        start.record()
        for i in range(reps):
            fn(*ins[i])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(*ins[i])
    total = 0.0
    for _ in range(trials):
        for copy in ins[:reps]:
            for t, src in zip(copy, tensors):
                t.copy_(src)
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / (trials * reps)


def time_level_steps(torch, K, ks, fr0, fr1, fr2, fr3, dense, young, bound) -> None:
    """K12 and K11 timed at V1's shapes ([8, 2^23]): K12 on V1's levels 1–3
    (nxt the hop's output, visited the levels before), an empty level (the
    WHILE gate closed) and a dense one, eager and in a graph, each call on
    fresh bitmaps; the folded emission count at level 2, open and close.
    K11 count-only over the roots (V1's depth 0) and level 2, emit + count,
    and the close arm's count. Each beside its bound, recounted from these
    bitmaps, and the earlier design's time (`WAS_LEVEL_MS`). The JSON rows:
    K11 count-only at level 2, K12 at level 2 (phase 5c re-times K12 in
    TRAVERSE's gated form)."""
    C, vb = fr2.shape
    seen = fr0 | fr1
    levels = [
        ("level 1", fr1, fr0),
        ("level 2", fr2, seen),
        ("level 3", fr3, seen | fr2),
        ("empty level", torch.zeros_like(fr2), seen | fr2 | fr3),
        ("dense level", dense, seen),
    ]
    step = lambda n, v: K.frontier_advance(n, v)  # noqa: E731
    kern, plain = _copies((fr2, seen), 11), _copies((fr2, seen), 11)
    ks.timed(
        "frontier_advance",
        lambda: K.frontier_advance(*next(kern)),
        lambda: K.plain_frontier_advance(*next(plain)),
        None,  # an in-place and-not, an or and a count: three calls at least
        level_step_bytes(torch, fr2),
    )
    for name, nxt, vis in levels:
        print(
            f"kernel frontier_advance (V1 {name}, [{C}, {vb}], {int(nxt.sum())} reached, "
            f"{nonzero_groups(torch, nxt)} non-zero groups): {_fresh_ms(torch, step, (nxt, vis)):.4f} ms eager, "
            f"{_fresh_ms(torch, step, (nxt, vis), graph=True):.4f} in a graph; "
            f"bound {level_step_bytes(torch, nxt) / HBM_BYTES_PER_S * 1e3:.4f}; "
            f"was {WAS_LEVEL_MS['K12 level, in a graph']:.4f} in a graph"
        )
    for name, b in (("open", None), ("close", bound)):
        fold = lambda n, v, b=b: K.frontier_advance(n, v, node=young, bound=b)  # noqa: E731
        n_t, v_t = fr2.clone(), seen.clone()
        emitted = int(K.frontier_advance(n_t, v_t, node=young, bound=b)[1])
        print(
            f"kernel frontier_advance (V1 level 2 with the folded emission count, {name}: {emitted} emitted): "
            f"{_fresh_ms(torch, fold, (fr2, seen)):.4f} ms eager, {_fresh_ms(torch, fold, (fr2, seen), graph=True):.4f} "
            f"in a graph (without: {_fresh_ms(torch, step, (fr2, seen), graph=True):.4f}); "
            f"bound {level_step_bytes(torch, fr2, node=young, bound=b) / HBM_BYTES_PER_S * 1e3:.4f}; "
            f"was K12 + K11 {WAS_LEVEL_MS['K12 level, in a graph'] + WAS_LEVEL_MS['K11 count-only, in a graph']:.4f}"
        )
    ks.timed(
        "bitmap_emit",
        lambda: K.bitmap_emit(fr2, young, None, emit=False, count=True),
        lambda: K.plain_bitmap_emit(fr2, young, None, False, False, True),
        None,  # a logical_and then a count_nonzero: two calls
        emit_bytes(torch, fr2, False),
    )
    for name, reached, b, emit, was in (
        ("count-only, V1's depth 0", fr0, None, False, "K11 count-only, in a graph"),
        ("count-only, V1's level 2", fr2, None, False, "K11 count-only, in a graph"),
        ("emit + count, level 2", fr2, None, True, "K11 emit + count, eager"),
        ("close-arm count, level 2", fr2, bound, False, "K11 count-only, in a graph"),
        ("emit + count with bound, level 2", fr2, bound, True, "K11 emit + count, eager"),
    ):
        fn = lambda r, b=b, e=emit: K.bitmap_emit(r, young, b, emit=e, count=True)  # noqa: E731
        print(
            f"kernel bitmap_emit ({name}, {nonzero_groups(torch, reached)} non-zero groups): "
            f"{_time_ms(torch, lambda: fn(reached)):.4f} ms eager, "
            f"{_fresh_ms(torch, fn, (reached,), graph=True):.4f} in a graph; "
            f"bound {emit_bytes(torch, reached, emit, b) / HBM_BYTES_PER_S * 1e3:.4f}; was {WAS_LEVEL_MS[was]:.4f} ({was})"
        )


def csr_hop_bytes(torch, indptr, fr, gate, masked: bool, eid: bool):
    """(bytes, active vertices, their edges): the bytes K10's CSR form must
    move for this frontier are the frontier (and gate) read once, 8 bytes
    of indptr an active vertex, 4 of nbr (+1 of mask, +4 of eid) an edge of
    an active vertex, and the bitmap written once."""
    C, vb = fr.shape
    nv = indptr.shape[0] - 1
    act = fr.any(0)[:nv]
    if gate is not None:
        act = act & gate[:nv]
    deg = (indptr[1:] - indptr[:-1]).long()
    n_act, n_edges = int(act.sum()), int(deg[act].sum())
    per_edge = 4.0 + (1.0 if masked else 0.0) + (4.0 if masked and eid else 0.0)
    return 2.0 * C * vb + (vb if gate is not None else 0.0) + 8.0 * n_act + per_edge * n_edges, n_act, n_edges


def time_bitmap_hop_csr(torch, K, ks, dg, fr0, fr1, fr2, dense, fr33, zero_fr, emask, gate, in_csr):
    """K10's CSR form timed at V1's shapes, each beside the edge-list form
    on the same hop and `torch.sparse.mm` (counts, not bits; the yardstick
    of `PERF.md` §6): the roots, levels 1 and 2 from 8 roots, every vertex
    active, out and in, masked through eid, gated, C = 33, both directions
    ORed, an empty frontier. The row of the JSON line is level 1's out hop
    (the timed shape of the edge-list row). Bounds from this run's data."""
    i32 = torch.int32
    dec = dg.edges["knows"]
    E = dec.num_edges
    vb = fr1.shape[1]
    src, dst = dec.edge_src, dec.dst
    out_ip, in_ip = dec.indptr_out, dec.indptr_in
    csr_out = (out_ip, dst, None)
    csr_in = (in_ip, dec.src, dec.edge_id_in)
    out_sp = None
    try:
        crow = torch.cat([out_ip, out_ip[-1:].expand(vb + 1 - out_ip.shape[0])])
        out_sp = torch.sparse_csr_tensor(crow, dst, torch.ones(E, device=dst.device), size=(vb, vb))
    except (RuntimeError, TypeError) as e:
        print(f"library call for bitmap_hop_csr refused: {e}")
    alive1 = K.mask_count(fr1.view(-1))
    b1, n_act, n_edges = csr_hop_bytes(torch, out_ip, fr1, None, False, False)
    ks.timed(
        "bitmap_hop_csr",
        lambda: K.bitmap_hop_csr(*csr_out, None, fr1, alive=alive1),
        lambda: K.plain_bitmap_hop_csr(*csr_out, None, fr1, None, alive1),
        None if in_csr is None else (lambda: torch.sparse.mm(in_csr, fr1.t().float().contiguous())),
        b1,
    )
    row = ks.rows["bitmap_hop_csr"]
    print(
        f"kernel bitmap_hop_csr (level 1 out, {n_act} active vertices, {n_edges} edges): {row['ms']:.4f} ms, "
        f"{_graph_ms(torch, lambda: K.bitmap_hop_csr(*csr_out, None, fr1, alive=alive1)):.4f} in a graph, "
        f"bound {row['bound_ms']:.4f}; edge-list {ks.rows['bitmap_hop']['ms']:.4f}, sparse.mm {row['library_ms']}"
    )

    def spmm(sp, fr):
        if sp is None:
            return None
        fr_t = fr.t().float().contiguous()
        return lambda: torch.sparse.mm(sp, fr_t)

    both = lambda fr, m: K.bitmap_hop_csr(*csr_in, m, fr, out=K.bitmap_hop_csr(*csr_out, m, fr))  # noqa: E731
    both_el = lambda fr, m: K.bitmap_hop(dst, src, m, fr, out=K.bitmap_hop(src, dst, m, fr))  # noqa: E731
    cases = [
        ("roots out", fr0, csr_out, (src, dst), None, None, in_csr),
        ("level 1 in", fr1, csr_in, (dst, src), None, None, out_sp),
        ("level 2 out", fr2, csr_out, (src, dst), None, None, in_csr),
        ("level 2 in", fr2, csr_in, (dst, src), None, None, out_sp),
        ("dense out", dense, csr_out, (src, dst), None, None, in_csr),
        ("dense in", dense, csr_in, (dst, src), None, None, out_sp),
        ("level 1 in, masked through eid", fr1, csr_in, (dst, src), emask, None, None),
        ("level 2 out, masked", fr2, csr_out, (src, dst), emask, None, None),
        ("level 2 out, gated", fr2, csr_out, (src, dst), None, gate, None),
        ("C=33 level 1 out", fr33, csr_out, (src, dst), None, None, in_csr),
    ]
    for name, fr, hop, el, m, g, sp in cases:
        alive = K.mask_count(fr.view(-1))
        nbytes, n_act, n_edges = csr_hop_bytes(torch, hop[0], fr, g, m is not None, hop[2] is not None)
        ms = _time_ms(torch, lambda: K.bitmap_hop_csr(*hop, m, fr, gate=g, alive=alive))
        g_ms = _graph_ms(torch, lambda: K.bitmap_hop_csr(*hop, m, fr, gate=g, alive=alive))
        el_ms = _time_ms(torch, lambda: K.bitmap_hop(*el, m, fr, gate=g, alive=alive))
        lib = _library_ms(torch, "bitmap_hop_csr", spmm(sp, fr))
        print(
            f"kernel bitmap_hop_csr ({name}, {n_act} active vertices, {n_edges} edges): {ms:.4f} ms, "
            f"{g_ms:.4f} in a graph, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f}; edge-list {el_ms:.4f}, "
            f"sparse.mm {lib}"
        )
    for name, fr in (("level 1 both, ORed", fr1), ("level 2 both, ORed", fr2)):
        ms, el_ms = _time_ms(torch, lambda: both(fr, None)), _time_ms(torch, lambda: both_el(fr, None))
        print(f"kernel bitmap_hop_csr ({name}): {ms:.4f} ms, edge-list {el_ms:.4f}")
    zero = torch.zeros((), dtype=i32, device=fr1.device)
    ms = _time_ms(torch, lambda: K.bitmap_hop_csr(*csr_out, None, zero_fr, alive=zero))
    el_ms = _time_ms(torch, lambda: K.bitmap_hop(src, dst, None, zero_fr, alive=zero))
    print(f"kernel bitmap_hop_csr (empty frontier, early exit): {ms:.4f} ms, edge-list {el_ms:.4f}")


class VRef:
    """numpy answers of V1–V3 from the host arrays, by k."""

    def __init__(self, np, snap):
        self.np, self.snap = np, snap
        age = snap.v_columns["age"].values
        self._v1 = numpy_var_depth_rows(snap, range(200), "out", age < 30, while_depth=3)
        self.v1 = int(self._v1.shape[0])
        self._drop = numpy_has_out_neighbour(snap, age > 70)
        self._v2, self._v3 = {}, {}

    def v1_below(self, k) -> int:
        """V1's count from the roots ``uid < k`` (k <= 200): BV1's items."""
        return int((self._v1[:, 0] < k).sum())

    def v2(self, k):
        if k not in self._v2:
            ones = self.np.ones(self.snap.num_vertices, bool)
            self._v2[k] = numpy_var_depth_rows(self.snap, range(k), "both", ones, max_depth=2)
        return self._v2[k]

    def v3(self, k):
        np = self.np
        if k not in self._v3:
            csr = self.snap.edge_classes["knows"]
            p = np.repeat(np.arange(k), np.diff(csr.indptr_out[: k + 1]))
            f = csr.dst[: csr.indptr_out[k]].astype(np.int64)
            rows = np.stack([p, f], 1)[~self._drop[f]]
            self._v3[k] = rows[np.lexsort(rows.T[::-1])]
        return self._v3[k]

    def check(self, name, rows, params):
        np = self.np
        if name == "V1":
            _require(rows == [{"n": self.v1}], f"V1 {rows} != numpy {self.v1}")
            return
        cols = ("p", "f", "d") if name == "V2" else ("p", "f")
        want = self.v2(params["k"]) if name == "V2" else self.v3(params["k"])
        got = _sorted_rows(np, rows, cols)
        _require(got.shape == want.shape and np.array_equal(got, want), f"{name} k={params['k']} rows differ from numpy")


def numpy_q3_rows(np, snap, k: int):
    """Sorted (p, f, g) rows of Q3 from the host arrays."""
    csr = snap.edge_classes["knows"]
    ip = csr.indptr_out.astype(np.int64)
    dst = csr.dst.astype(np.int64)
    age = snap.v_columns["age"].values
    deg_p = np.diff(ip[: k + 1])
    ps = np.repeat(np.arange(k), deg_p)
    fs = dst[ip[0] : ip[k]]
    deg_f = ip[fs + 1] - ip[fs]
    first = np.repeat(ip[fs] - (np.cumsum(deg_f) - deg_f), deg_f)
    gpos = first + np.arange(int(deg_f.sum()))
    gs = dst[gpos]
    keep = age[gs] < 30
    rows = np.stack([np.repeat(ps, deg_f)[keep], np.repeat(fs, deg_f)[keep], gs[keep]], 1)
    return rows[np.lexsort(rows.T[::-1])]


def run_slice(np, torch, K, db, snap, card: str, vref: VRef):
    """Phase 4: the main path through ``db.query``, with the launch counts
    zeroed just before it and read just after. Returns the counts."""
    V = snap.num_vertices
    age = snap.v_columns["age"].values
    want1 = numpy_1hop_count(snap, age > 40, age < 30)
    want2 = numpy_2hop_count(snap, age > 40, np.ones(V, bool), age < 30)
    want3 = numpy_q3_rows(np, snap, Q3_K)
    sync = torch.cuda.synchronize if db.device.type == "cuda" else (lambda: None)
    queries = (
        ("Q1", Q1, None),
        ("Q2", Q2, None),
        ("Q3", Q3, {"k": Q3_K}),
        ("V1", V1, None),
        ("V2", V2, {"k": V2_K}),
        ("V3", V3, {"k": V3_K}),
    )
    results = {}
    K.reset_launches()
    before = dict(K.LAUNCHES)
    for name, sql, params in queries:
        results[name] = db.query(sql, params).to_dicts()
        sync()
        after = dict(K.LAUNCHES)
        per = {k: after[k] - before[k] for k in after}
        print(f"launches {name}: {sum(per.values())} {per}")
        before = after
    launches = dict(K.LAUNCHES)
    r1, r2, r3 = results["Q1"], results["Q2"], results["Q3"]
    _require(r1 == [{"n": want1}], f"Q1 {r1} != numpy {want1}")
    _require(r2 == [{"n": want2}], f"Q2 {r2} != numpy {want2}")
    got3 = np.array([(r["p"], r["f"], r["g"]) for r in r3], np.int64).reshape(-1, 3)
    got3 = got3[np.lexsort(got3.T[::-1])]
    _require(
        got3.shape == want3.shape and np.array_equal(got3, want3),
        "Q3 rows differ from numpy",
    )
    for name, _sql, params in queries[3:]:
        vref.check(name, results[name], params)
    if db.device.type == "cuda":
        missing = [n for n in RECORD_KERNELS if launches[n] == 0]
        _require(not missing, f"kernels never launched on the recording path: {missing}")
    print(
        f"record: Q1={want1} Q2={want2} Q3 rows={len(r3)} V1={vref.v1} "
        f"V2 rows={len(results['V2'])} V3 rows={len(results['V3'])}; launches {launches}"
    )
    for name, sql, params in queries:
        rows = len(results[name])
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            db.query(sql, params).to_dicts()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        print(
            f"query {name}: median {med:.3f} ms over {len(times)} runs "
            f"(runs {[round(t, 3) for t in times]}), {rows / med * 1e3:.1f} rows/s [{card}]"
        )
        print(f"layers {name}: {query_layers(torch, db, sql, params, sync)}")
        if db.device.type == "cuda":
            print(f"device {name}: {device_share(torch, db, sql, params, med)}")
    return launches


def numpy_direct_rows(np, snap, k: int):
    """Sorted (p, f) rows of Q_DIRECT from the host arrays."""
    csr = snap.edge_classes["knows"]
    ip = csr.indptr_out.astype(np.int64)
    ps = np.repeat(np.arange(k), np.diff(ip[: k + 1]))
    rows = np.stack([ps, csr.dst[ip[0] : ip[k]].astype(np.int64)], 1)
    return rows[np.lexsort(rows.T[::-1])]


def numpy_in_rows(np, snap, k: int):
    """Sorted (p, f) rows of Q_IN (f -knows-> p) from the host in-CSR."""
    csr = snap.edge_classes["knows"]
    ip = csr.indptr_in.astype(np.int64)
    ps = np.repeat(np.arange(k), np.diff(ip[: k + 1]))
    rows = np.stack([ps, csr.src[ip[0] : ip[k]].astype(np.int64)], 1)
    return rows[np.lexsort(rows.T[::-1])]


def _sorted_rows(np, rows, names):
    """Rows as a sorted int64 array (None as -1, bools as 0/1)."""
    got = np.array(
        [tuple(-1 if r[n] is None else int(r[n]) for n in names) for r in rows], np.int64
    ).reshape(-1, len(names))
    return got[np.lexsort(got.T[::-1])]


def _only_plan(TE, snap, sql):
    """The statement's cache entry (PlanVariants): exactly one."""
    from orientdb_tpu_torch.sql.parser import parse

    stmt = parse(sql)
    found = [v for k, v in TE._plan_cache(snap).items() if k[0] == stmt]
    _require(len(found) == 1, f"{len(found)} cache entries for {sql}")
    return found[0]


def run_replay(np, torch, K, db, snap, card: str, vref: VRef):
    """Phase 5: the replay path through ``db.query`` with the plan cache
    on, launch counts zeroed just before it and read just after. Returns
    (launches, the Q3 plan, Q3's sorted numpy rows at k = 50,000)."""
    from orientdb_tpu_torch.exec import tpu_engine as TE

    V = snap.num_vertices
    age = snap.v_columns["age"].values
    want = {
        "Q1": [{"n": numpy_1hop_count(snap, age > 40, age < 30)}],
        "Q2": [{"n": numpy_2hop_count(snap, age > 40, np.ones(V, bool), age < 30)}],
    }
    q3_want = {k: numpy_q3_rows(np, snap, k) for k in (Q3_K, Q3_K_SMALLER, Q3_K_OVERFLOW)}

    def check(name, rows, params):
        if name.startswith("V"):
            vref.check(name, rows, params)
        elif name in want:
            _require(rows == want[name], f"{name} {rows} != numpy {want[name]}")
        elif name == "Q3":
            got = _sorted_rows(np, rows, ("p", "f", "g"))
            exp = q3_want[params["k"]]
            _require(got.shape == exp.shape and np.array_equal(got, exp), f"Q3 k={params['k']} rows differ from numpy")
        else:
            got = _sorted_rows(np, rows, ("p", "f"))
            exp = (numpy_in_rows if name == "in walk" else numpy_direct_rows)(np, snap, params["k"])
            _require(got.shape == exp.shape and np.array_equal(got, exp), f"{name} rows differ from numpy")

    sync = torch.cuda.synchronize
    K.reset_launches()
    plans = {}
    for name, sql, params in (
        ("Q1", Q1, None),
        ("Q2", Q2, None),
        ("Q3", Q3, {"k": Q3_K}),
        ("direct", Q_DIRECT, {"k": Q_DIRECT_K}),
        ("in walk", Q_IN, {"k": Q_DIRECT_K}),
        ("V1", V1, None),
        ("V2", V2, {"k": V2_K}),
        ("V3", V3, {"k": V3_K}),
    ):
        t0 = time.perf_counter()
        rows = db.query(sql, params).to_dicts()
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        check(name, rows, params)
        variants = _only_plan(TE, snap, sql)
        _require(len(variants.plans) == 1, f"{name}: {len(variants.plans)} variants")
        plan = variants.plans[0]
        _require(plan.graph is not None and plan.replays == 0, f"{name}: not captured")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            rows = db.query(sql, params).to_dicts()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            check(name, rows, params)
        _require(plan.replays == 5 and len(_only_plan(TE, snap, sql).plans) == 1, f"{name}: replays {plan.replays}")
        med = statistics.median(times)
        REPLAY_MS.setdefault(name, med)
        per = plan.launches
        print(
            f"replay {name}: record {first_ms - plan.capture_ms:.3f} ms, capture {plan.capture_ms:.3f} ms, "
            f"replay median {med:.3f} ms over {len(times)} runs (runs {[round(t, 3) for t in times]}), "
            f"{len(rows) / med * 1e3:.1f} rows/s; launches per replay {sum(per.values())} {per}; "
            f"reserved after capture {plan.reserved_bytes} bytes; direct_fetch {plan.direct_fetch} [{card}]"
        )
        print(f"replay layers {name}: {replay_layers(torch, db, sql, plan, params)}")
        print(f"replay device {name}: {device_share(torch, db, sql, params, med)}")
        if name == "V1":
            print(f"replay kernels V1 (one profiled replay): {level_profile(torch, lambda: db.query(sql, params).to_dicts())}")
        plans[name] = plan
    _require(plans["direct"].direct_fetch and not plans["Q3"].direct_fetch, "direct-fetch path not taken")
    # the one-hop expansion: one degree scan (K2) and one merge-path gather
    # (K2b) a walk and no K2a; the in walk reads its edge ids inside the
    # gather, so it launches the out walk's take_pads and not one more
    for name, walks in (("Q3", 2), ("direct", 1), ("in walk", 1), ("V3", 1)):
        per = plans[name].launches
        _require(
            per.get("degree_scan_i32", 0) == walks and per.get("gather_expand", 0) == walks
            and per.get("degree_counts", 0) == 0,
            f"{name}: the expansion launched {per}",
        )
    takes = {n: plans[n].launches.get("take_pad_i32", 0) for n in ("direct", "in walk")}
    _require(takes["in walk"] == takes["direct"], f"the in walk launched take_pads {takes}")
    print(
        "replay expansion: degree_scan_i32 / gather_expand / degree_counts / scan_i32 a replay: "
        + ", ".join(
            f"{n} {plans[n].launches.get('degree_scan_i32', 0)} / {plans[n].launches.get('gather_expand', 0)} / "
            f"{plans[n].launches.get('degree_counts', 0)} / {plans[n].launches.get('scan_i32', 0)}"
            for n in ("Q3", "direct", "in walk", "V3")
        )
        + f"; take_pad_i32 out / in walk {takes['direct']} / {takes['in walk']}"
    )
    # the COUNT pushdown's weight step: one fused gather a class and
    # direction (Q1 one walk, Q2 two), and a fold of the vertex mask into
    # A's weights (32 MB, within L2) where a step carries them (Q2's first)
    for name, gathers in (("Q1", 1), ("Q2", 3)):
        per = plans[name].launches
        _require(per.get("weight_gather_i32", 0) == gathers and per.get("take_pad_b8", 0) == 0,
                 f"{name}: the weight step launched {per}")
    # the bitmap-BFS kernels run inside the V plans' captured replays
    for name, kernels in (("V1", BITMAP_KERNELS), ("V2", BITMAP_KERNELS), ("V3", BITMAP_KERNELS[:3])):
        missing = [n for n in kernels if plans[name].launches.get(n, 0) == 0]
        _require(not missing, f"{name}: {missing} not in its captured replay")

    # parameter-generic V2 and V3: a lower k replays the recorded plan, V2
    # past its root buckets re-records a second variant
    for name, sql, k in (("V2", V2, V2_K_SMALLER), ("V3", V3, V3_K_SMALLER)):
        plan = plans[name]
        replays = plan.replays
        rows = db.query(sql, {"k": k}).to_dicts()
        check(name, rows, {"k": k})
        _require(plan.replays == replays + 1 and len(_only_plan(TE, snap, sql).plans) == 1, f"{name} k={k} did not replay")
        print(f"replay {name} k={k}: {len(rows)} rows from the k={V2_K if name == 'V2' else V3_K} plan")
    v2 = plans["V2"]
    t0 = time.perf_counter()
    rows = db.query(V2, {"k": V2_K_OVERFLOW}).to_dicts()
    sync()
    over_ms = (time.perf_counter() - t0) * 1e3
    check("V2", rows, {"k": V2_K_OVERFLOW})
    variants = _only_plan(TE, snap, V2)
    _require(len(variants.plans) == 2 and variants.plans[1] is v2, "V2 k=64 did not re-record a second variant")
    big = variants.plans[0]
    print(
        f"replay V2 k={V2_K_OVERFLOW}: {len(rows)} rows; the k={V2_K} plan overflowed and a second variant "
        f"recorded (width {big.width} vs {v2.width}) and captured in {over_ms:.3f} ms "
        f"(capture {big.capture_ms:.3f} ms, reserved {big.reserved_bytes} bytes)"
    )

    # parameter-generic Q3: under capacity it replays the recorded plan, past
    # the recorded buckets it re-records into a second variant
    q3 = plans["Q3"]
    size, replays = len(TE._plan_cache(snap)), q3.replays
    rows = db.query(Q3, {"k": Q3_K_SMALLER}).to_dicts()
    check("Q3", rows, {"k": Q3_K_SMALLER})
    _require(q3.replays == replays + 1 and len(TE._plan_cache(snap)) == size, "k=1000 did not replay the k=2000 plan")
    print(f"replay Q3 k={Q3_K_SMALLER}: {len(rows)} rows from the k={Q3_K} plan (replay {q3.replays})")
    t0 = time.perf_counter()
    rows = db.query(Q3, {"k": Q3_K_OVERFLOW}).to_dicts()
    sync()
    over_ms = (time.perf_counter() - t0) * 1e3
    check("Q3", rows, {"k": Q3_K_OVERFLOW})
    variants = _only_plan(TE, snap, Q3)
    _require(len(variants.plans) == 2 and variants.plans[1] is q3, "k=50000 did not re-record a second variant")
    _require(q3.replays == replays + 2, "k=50000 did not try the recorded plan first")
    big = variants.plans[0]
    print(
        f"replay Q3 k={Q3_K_OVERFLOW}: {len(rows)} rows; the k={Q3_K} plan's replay overflowed and a "
        f"second variant recorded (width {big.width} vs {q3.width}) and captured in {over_ms:.3f} ms "
        f"(capture {big.capture_ms:.3f} ms, reserved {big.reserved_bytes} bytes); launches per replay "
        f"{sum(big.launches.values())} {big.launches}"
    )
    for k in (Q3_K_OVERFLOW, Q3_K):
        rows = db.query(Q3, {"k": k}).to_dicts()
        check("Q3", rows, {"k": k})
    _require(big.replays == 1 and q3.replays == replays + 3, "variants are not sticky per value")
    sync()
    launches = dict(K.LAUNCHES)
    missing = [n for n in PK_KERNELS if launches[n] == 0]
    _require(not missing, f"kernels never launched on the replay path: {missing}")
    print(
        f"replay: all equal numpy; launches {launches}; "
        f"reserved {torch.cuda.memory_reserved()} bytes after {sum(len(v.plans) for v in TE._plan_cache(snap).values())} captures"
    )
    return launches, q3, q3_want[Q3_K_OVERFLOW]


def replay_layers(torch, db, sql, plan, params, reps: int = 5) -> str:
    """Median ms of a replay's layers over ``reps`` calls: the front door
    (parse, plan-cache lookup, variant pick), parameter upload and replay
    launch (host, inside `dispatch`), device wait (until the result copies
    are done), fetch (host arrays) and marshal (rows)."""
    from orientdb_tpu_torch.exec import tpu_engine as TE
    from orientdb_tpu_torch.exec.result import ResultSet
    from orientdb_tpu_torch.sql.parser import parse

    runs = []
    for _ in range(reps):
        tf = time.perf_counter()
        variants, _rows = TE._prepare(db, parse(sql), params or {})
        _require(variants.pick(params or {}) is plan, "front door picked another plan")
        t0 = time.perf_counter()
        fetch = plan.dispatch(params)
        t1 = time.perf_counter()
        fetch.event.synchronize()
        t2 = time.perf_counter()
        meta, data = plan.fetch(fetch)
        t3 = time.perf_counter()
        ResultSet(plan.materialize(meta, data, params)).to_dicts()
        t4 = time.perf_counter()
        up = plan.dispatch_s["param_upload"]
        runs.append(
            ((t0 - tf) * 1e3, up * 1e3, (t1 - t0 - up) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3, (t4 - t3) * 1e3)
        )
    front, up, disp, wait, fetch_ms, marshal = (statistics.median(r[i] for r in runs) for i in range(6))
    return (
        f"front door {front:.3f} ms, param upload {up:.3f} ms, dispatch {disp:.3f} ms, "
        f"device wait {wait:.3f} ms, fetch {fetch_ms:.3f} ms, marshal {marshal:.3f} ms"
    )


def _graph_ms(torch, fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn`` captured once in a CUDA graph and
    replayed ``reps`` times between CUDA events: the device time of a
    call without its host launch overhead, as a captured plan runs it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_replay_kernels(torch, K, ks, plan, params) -> None:
    """K6–K8 against their plain versions at the shapes Q3's replay gives
    them (its replay-mode table, run eagerly) and at edge lengths; then
    their times."""
    dev = plan.solver.device
    i32 = torch.int32
    torch.cuda.synchronize()
    plan._upload(plan._dyn_args(params))
    table = plan._replay_table()
    W, C = plan.width, plan.ncols
    valid = table.valid_device[:W].contiguous()
    cols = [table.cols[a] for a in plan.v_names]
    count = table.count_device.to(i32)
    over = torch.zeros((), dtype=i32, device=dev)
    data = K.front_pack(valid, cols)
    ks.same("front_pack", data, K.plain_front_pack(valid, cols))
    ks.same("front_pack", K.front_pack(valid, cols * 6), K.plain_front_pack(valid, cols * 6))
    ks.same("replay_meta", K.replay_meta(data, count, over), K.plain_replay_meta(data, count, over))
    ks.same("narrow_i16", K.narrow_i16(data), K.plain_narrow_i16(data))
    gen = torch.Generator(device=dev).manual_seed(7)
    for n in EDGE_LENGTHS:
        v = (torch.rand(n, generator=gen, device=dev) < 0.5).to(i32)
        cs = [torch.randint(-1, 1 << 20, (n,), generator=gen, device=dev, dtype=i32) for _ in range(C)]
        d = K.front_pack(v, cs)
        ks.same("front_pack", d, K.plain_front_pack(v, cs))
        for cnt in (0, n // 2, n):
            c_dev = torch.full((), cnt, dtype=i32, device=dev)
            ks.same("replay_meta", K.replay_meta(d, c_dev, over), K.plain_replay_meta(d, c_dev, over))
            small = d % 1000
            ks.same("replay_meta", K.replay_meta(small, c_dev, over), K.plain_replay_meta(small, c_dev, over))
        wide = torch.randint(-(2**31), 2**31 - 1, (n * C,), generator=gen, device=dev, dtype=i32)
        ks.same("narrow_i16", K.narrow_i16(wide), K.plain_narrow_i16(wide))
    live = int(count)
    ks.timed(
        "front_pack",
        lambda: K.front_pack(valid, cols),
        lambda: K.plain_front_pack(valid, cols),
        None,
        4.0 * W * (1 + 2 * C),
    )
    ks.timed(
        "replay_meta",
        lambda: K.replay_meta(data, count, over),
        lambda: K.plain_replay_meta(data, count, over),
        None,
        4.0 * live * C + 8.0 + 12.0,
    )
    ks.timed(
        "narrow_i16",
        lambda: K.narrow_i16(data),
        lambda: K.plain_narrow_i16(data),
        lambda: data.to(torch.int16),
        6.0 * W * C,
    )
    # the plain versions read sizes on the host (boolean indexing), so
    # only the kernels and the library cast are captured
    for name, kernel in (
        ("front_pack", lambda: K.front_pack(valid, cols)),
        ("replay_meta", lambda: K.replay_meta(data, count, over)),
        ("narrow_i16", lambda: K.narrow_i16(data)),
        ("narrow_i16 library", lambda: data.to(torch.int16)),
    ):
        print(f"kernel {name} in a captured graph: {_graph_ms(torch, kernel):.4f} ms")
    torch.cuda.synchronize()
    print(f"replay kernels: equal their plain versions at W={W}, C={C}, live rows {live}")


#: float32 operations of one distance() slot, each counted once at the
#: card's float32 rate (a least time): 17 arithmetic operations and the
#: compare with r, and six calls (sin and cos twice each, asin, sqrt)
G1_SLOT_OPS = 24


def time_predicate_kernel(np, torch, K, ks, db, card: str) -> None:
    """K15: first held exactly against `plain_predicate_eval` on every
    instruction family at 2^23 synthetic slots (`check_predicate_kernel`;
    distance() outside the boundary band); then timed on Q1's two node masks
    as the main path runs them, over the [vb] vertex universe in identity
    mode (one launch a mask), eagerly and inside a captured graph, beside
    the plain version and the byte bound: each column read once, the
    class ids (mask p), the mask written; G1's mask beside its byte and
    operation bounds; and guarded programs whose first conjunct rejects
    every slot or none. These launches are not counted."""
    from orientdb_tpu_torch.exec.tpu_engine import TpuMatchSolver
    from orientdb_tpu_torch.ops.predicates import (
        ColumnScope, Predicate, _mask, class_term, compile_where, id_term, valid_term,
    )
    from orientdb_tpu_torch.sql.parser import parse

    counted = dict(K.LAUNCHES)
    t0 = time.perf_counter()
    band, checked, length = check_predicate_kernel(np, torch, K, 1 << 23)
    torch.cuda.synchronize()
    gc.collect()  # the synthetic device graph's cycle (graph ↔ column proxies)
    print(
        f"kernel predicate_eval: equals its plain version on {checked} programs of "
        f"{len(K15_WHERES)} WHEREs (+ class lookup) over 2^23 slots, ids and identity mode; "
        f"the long program {length} instructions; distance() band slots {band} "
        f"({time.perf_counter() - t0:.1f} s)"
    )
    t0 = time.perf_counter()
    band, checked = check_predicate_lanes(np, torch, K, 1 << 23, 16)
    torch.cuda.synchronize()
    gc.collect()
    print(
        f"kernel predicate_eval_lanes: equals its plain version and the single-lane kernel row by row on "
        f"{checked} programs of {len(K15_LANE_WHERES)} WHEREs over 2^23 slots and 16 parameter rows, ids and "
        f"identity mode; distance() band slots {band} ({time.perf_counter() - t0:.1f} s)"
    )
    t0 = time.perf_counter()
    band, checked = check_predicate_stacked(np, torch, K, 1 << 20, 16)
    torch.cuda.synchronize()
    gc.collect()
    print(
        f"kernel predicate_eval_stacked: equals its plain version and the single kernel lane by lane on "
        f"{checked} launches of {len(K15_LANE_WHERES) + 1} WHEREs (the last split) over 16 lanes of 2^20 "
        f"lane-stacked ids and binding rows, ids and identity mode; distance() band slots {band} "
        f"({time.perf_counter() - t0:.1f} s)"
    )
    solver = TpuMatchSolver(db, parse(Q1), {})
    V = solver.dg.num_vertices
    vb = solver._vb()
    # p: class Person (v_class, 4 bytes) AND age > 40 (values 4 + presence 1)
    for alias, col_bytes in (("p", 9.0 * V), ("f", 5.0 * V)):
        pred = solver._node_masks[alias]
        (prog,) = pred.programs
        bufs = prog.buffers({}, [], vb)
        ks.same("predicate_eval", pred.identity(vb, V), K.plain_predicate_eval(prog.prog, bufs, None, vb, V))
        bound = col_bytes + vb
        kernel = lambda pr=pred: pr.identity(vb, V)  # noqa: E731
        plain = lambda pg=prog, b=bufs: K.plain_predicate_eval(pg.prog, b, None, vb, V)  # noqa: E731
        if alias == "p":
            ks.timed("predicate_eval", kernel, plain, None, bound)
        print(
            f"kernel predicate_eval, Q1 node mask {alias} ({len(prog.prog.rows)} instructions): "
            f"{_time_ms(torch, kernel):.4f} ms eager, {_graph_ms(torch, kernel):.4f} ms in a captured "
            f"graph, plain {_time_ms(torch, plain):.4f} ms, bound {bound / HBM_BYTES_PER_S * 1e3:.4f} ms "
            f"over vb={vb} [{card}]"
        )
    # G1's mask: class AND distance() through the parameter row; lat/lng
    # values and presence, the class ids, the mask written
    pred = TpuMatchSolver(db, parse(G1), dict(G_CELLS["G1"][1]))._node_masks["p"]
    (prog,) = pred.programs
    bufs = prog.buffers({}, [], vb)
    row = pred.box.row(pred.device)
    plain = lambda: K.plain_predicate_eval(prog.prog, bufs, None, vb, V, params=row)  # noqa: E731
    kernel = lambda: pred.identity(vb, V)  # noqa: E731
    diff = int((kernel() != plain()).sum())
    print(
        f"kernel predicate_eval, G1 node mask p ({len(prog.prog.rows)} instructions, distance()): "
        f"{_time_ms(torch, kernel):.4f} ms eager, {_graph_ms(torch, kernel):.4f} ms in a captured graph, "
        f"plain {_time_ms(torch, plain):.4f} ms, bound {(14.0 * V + vb) / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"(bytes), {G1_SLOT_OPS * V / SCALAR_OPS_PER_S * 1e3:.4f} ms (operations: {G1_SLOT_OPS} a slot); "
        f"{diff} slots differ from the plain version (boundary band) [{card}]"
    )
    # guards: a head conjunct that rejects every slot (a rid no vertex
    # has) or none (a true constant), before Q1's class lookup and column
    scope = ColumnScope(solver.dg.columns, solver.dg.non_columnar, device=solver.dg.device)
    for what, head in (("rejects every slot", id_term(-2)), ("rejects none", _mask(True))):
        pred = Predicate(
            [valid_term(), head, class_term(solver.dg.v_class, solver.dg.class_table("Person")),
             compile_where(parse("SELECT FROM V WHERE age > 40").where, scope, {})],
            solver.dg.device,
        )
        (prog,) = pred.programs
        bufs = prog.buffers({}, [], vb)
        ks.same("predicate_eval", pred.identity(vb, V), K.plain_predicate_eval(prog.prog, bufs, None, vb, V))
        kernel = lambda pr=pred: pr.identity(vb, V)  # noqa: E731
        print(
            f"kernel predicate_eval, a guard that {what} before Q1's mask p: {_time_ms(torch, kernel):.4f} ms "
            f"eager, {_graph_ms(torch, kernel):.4f} ms in a captured graph [{card}]"
        )
    K.LAUNCHES.update(counted)


def query_layers(torch, db, sql, params, sync) -> str:
    """Median ms of the query's layers over 3 runs: parse + plan + predicate
    compile, the device solve (with its host syncs), and row marshalling."""
    from orientdb_tpu_torch.exec.result import ResultSet
    from orientdb_tpu_torch.exec.tpu_engine import TpuMatchSolver
    from orientdb_tpu_torch.sql.parser import parse

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        solver = TpuMatchSolver(db, parse(sql), dict(params or {}))
        t1 = time.perf_counter()
        table = solver.solve_table()
        sync()
        t2 = time.perf_counter()
        ResultSet(solver.rows_from_table(table)).to_dicts()
        t3 = time.perf_counter()
        runs.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3))
    plan, solve, marshal = (statistics.median(r[i] for r in runs) for i in range(3))
    return (
        f"plan {plan:.3f} ms, solve {solve:.3f} ms "
        f"({len(solver.sched.values)} observed sizes), marshal {marshal:.3f} ms"
    )


def device_share(torch, db, sql, params, wall_ms: float) -> str:
    """Kernel time on the card for one profiled run of the query
    (torch.profiler), against that run's own wall time: the device's busy
    share. The profiler slows the run; ``wall_ms`` is the unprofiled
    median, printed beside it."""
    return busy_share(torch, lambda: db.query(sql, params).to_dicts(), wall_ms)


def _profiled(torch, run):
    """One call of ``run`` under torch.profiler: its key averages and its
    wall ms (the profiler slows it)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
    return prof.key_averages(), run_ms


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", 0) or 0


def busy_share(torch, run, wall_ms: float) -> str:
    """`device_share` of any callable (one query, or one batch)."""
    events, run_ms = _profiled(torch, run)
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if busy_ms == 0:
        return "kernel time not measured (the profiler saw no device activity)"
    top = sorted(events, key=_device_us, reverse=True)[:6]
    tops = ", ".join(f"{e.key[:48]} {_device_us(e) / 1e3:.3f} ms x{e.count}" for e in top)
    return (
        f"kernels {busy_ms:.3f} ms in a profiled run of {run_ms:.3f} ms "
        f"(unprofiled median {wall_ms:.3f} ms): busy {busy_ms / run_ms:.1%}, "
        f"idle {1 - busy_ms / run_ms:.1%}; top: {tops}"
    )


#: the kernels of a bitmap-BFS level, by the profiler's kernel names
LEVEL_PROFILE = (
    ("K10 bitmap_hop_csr", "bitmap_hop_csr_kernel"),
    ("K12 frontier_advance", "frontier_advance_kernel"),
    ("K11 bitmap_emit", "bitmap_emit"),
    ("memsets", "Memset"),
)


def level_profile(torch, run) -> str:
    """Device ms and launches of K10, K12, K11 and the memsets in one
    profiled call of ``run``, beside all its kernel time."""
    events, _ = _profiled(torch, run)
    total = sum(_device_us(e) for e in events) / 1e3
    if total == 0:
        return "kernel time not measured (the profiler saw no device activity)"
    parts = []
    for label, key in LEVEL_PROFILE:
        hit = [e for e in events if key in e.key and _device_us(e) > 0]
        ms = sum(_device_us(e) for e in hit) / 1e3
        parts.append(f"{label} {ms:.3f} ms x{sum(e.count for e in hit)}")
    return f"{', '.join(parts)}, of {total:.3f} ms of kernels"


class ERef:
    """numpy answers of E1–E5 from the SNB-shape host arrays, by cell and
    parameters."""

    _COLS = {"E2": ("p", "f", "cd"), "E2b": ("p", "v"), "E4": ("p", "f"), "E5": ("p", "f", "probe")}

    def __init__(self, np, snap):
        self.np, self.snap = np, snap
        age = snap.v_columns["age"].values
        self.young, self.old = age < 30, age > 75
        self._want = {}

    def want(self, name, p):
        key = (name, tuple(sorted(p.items())))
        if key not in self._want:
            snap = self.snap
            if name == "E1":
                v = numpy_config5_count(snap, p["d"])
            elif name == "E2":
                v = numpy_out_edge_rows(snap, p["n"], p["d"], self.young)
            elif name == "E2b":
                v = numpy_incident_rows(snap, p["n"])
            elif name == "E3":
                v = numpy_undirected_rows(snap, p["n"])
            elif name == "E4":
                v = numpy_optional_rows(snap, p["n"], self.old)
            else:
                v = numpy_probe_rows(snap, p["n"], p["d"])
            self._want[key] = v
        return self._want[key]

    def check(self, name, rows, p):
        np = self.np
        want = self.want(name, p)
        if name == "E1":
            _require(rows == [{"n": want}], f"E1 d={p['d']}: {rows} != numpy {want}")
            return
        if name == "E3":
            # ORDER BY cd DESC, f ASC: the keys in order, the rows as a multiset
            got = np.array([(r["p"], r["f"], r["cd"]) for r in rows], np.int64).reshape(-1, 3)
            _require(
                got.shape == want.shape
                and np.array_equal(got[:, 1:], want[:, 1:])
                and np.array_equal(got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])]),
                f"E3 {p}: rows differ from numpy",
            )
            return
        if name == "E4":
            nulls = sum(r["f"] is None for r in rows)
            _require(0 < nulls < len(rows), f"E4 {p}: {nulls} of {len(rows)} rows unmatched")
        if name == "E5":
            _require(all(isinstance(r["probe"], bool) for r in rows), "E5: probe is not a bool")
            _require({r["probe"] for r in rows} == {True, False}, "E5: one probe value only")
        got = _sorted_rows(np, rows, self._COLS[name])
        _require(got.shape == want.shape and np.array_equal(got, want), f"{name} {p}: rows differ from numpy")


class GRef:
    """numpy answers of G1–G3 (float64 haversine over the float32 columns).
    A slot of the boundary band (`distance_band`) may fall either way: a
    COUNT must lie between the count outside the band and that plus the
    band's slots, rows must equal numpy outside the band."""

    def __init__(self, np, snap):
        self.np = np
        lat, lng = snap.v_columns["lat"], snap.v_columns["lng"]
        self.live = lat.present & lng.present
        self.d = numpy_distance_km(lat.values, lng.values, 48.0, 2.0)
        csr = snap.edge_classes["knows"]
        ip = csr.indptr_out
        ps = np.repeat(np.arange(G3_K), np.diff(ip[: G3_K + 1]))
        fs = csr.dst[ip[0] : ip[G3_K]]
        self.g3_live = self.live[ps] & self.live[fs]
        self.g3_d = numpy_distance_km(lat.values[fs], lng.values[fs], lat.values[ps], lng.values[ps])
        #: (cell, r) → slots in the band
        self.band = {}

    def count_range(self, d, live, r):
        band = distance_band(self.np, d, r) & live
        lo = int((live & (d < r) & ~band).sum())
        return lo, lo + int(band.sum()), int(band.sum())

    def check(self, name, rows, p):
        np = self.np
        r = p["r"]
        if name == "G2":
            band = distance_band(np, self.d, r / 0.621371192) & self.live
            want = self.live & (self.d * 0.621371192 < r)
            uids = np.array([x["uid"] for x in rows], np.int64)
            got = np.zeros(want.shape[0], bool)
            got[uids] = True
            _require(len(set(uids.tolist())) == uids.shape[0] > 0, f"G2 r={r}: duplicate or no rows")
            _require(not ((got ^ want) & ~band).any(), f"G2 r={r}: rows differ from numpy outside the band")
            self.band[(name, r)] = int(band.sum())
            return
        if name == "G3":
            _require(p["k"] == G3_K, "G3 is checked at k = 100,000")
            lo, hi, nb = self.count_range(self.g3_d, self.g3_live, r)
        else:
            _require((p["x"], p["y"]) == (48.0, 2.0), "G1 is checked at (48, 2)")
            lo, hi, nb = self.count_range(self.d, self.live, r)
        got = rows[0]["n"] if rows else None
        _require(got is not None and lo <= got <= hi, f"{name} r={r}: {got} outside numpy's [{lo}, {hi}]")
        self.band[(name, r)] = nb


def run_edges_record(np, torch, K, db, card: str, eref, cells=E_CELLS, kernels=E_RECORD_KERNELS):
    """Phase 6a: E1–E5 (or other ``cells``, held by ``eref``) on the
    recording path (plan cache off) through ``db.query``, launch counts
    zeroed just before and read just after, every kernel of ``kernels``
    launched; then each cell's times, layers and busy share."""
    sync = torch.cuda.synchronize
    results = {}
    K.reset_launches()
    before = dict(K.LAUNCHES)
    for name, (sql, params, _rest) in cells.items():
        results[name] = db.query(sql, params).to_dicts()
        sync()
        after = dict(K.LAUNCHES)
        per = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        print(f"launches {name}: {sum(per.values())} {per}")
        before = after
    launches = dict(K.LAUNCHES)
    for name, (_sql, params, _rest) in cells.items():
        eref.check(name, results[name], params)
    missing = [n for n in kernels if launches[n] == 0]
    _require(not missing, f"kernels never launched on the recording path of {list(cells)}: {missing}")
    print(
        "record: " + ", ".join(
            f"{n}={results[n][0]['n']}" if results[n] and list(results[n][0]) == ["n"]
            else f"{n} rows={len(results[n])}" for n in cells
        ) + f"; launches {launches}"
    )
    for name, (sql, params, _rest) in cells.items():
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            db.query(sql, params).to_dicts()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        med = statistics.median(times)
        rows = len(results[name])
        print(
            f"query {name}: median {med:.3f} ms over {len(times)} runs "
            f"(runs {[round(t, 3) for t in times]}), {rows / med * 1e3:.1f} rows/s [{card}]"
        )
        print(f"layers {name}: {query_layers(torch, db, sql, params, sync)}")
        print(f"device {name}: {device_share(torch, db, sql, params, med)}")
    return launches


def run_edges_replay(np, torch, K, db, snap, card: str, eref, cells=E_CELLS, kernels=E_REPLAY_KERNELS):
    """Phase 6b: E1–E5 (or other ``cells``) with the plan cache on, launch
    counts zeroed just before and read just after: each cell records and
    captures once, replays 5 timed calls, then replays its other parameter
    values from the same plan; every kernel of ``kernels`` launched.
    Returns (launches, plans by cell)."""
    from orientdb_tpu_torch.exec import tpu_engine as TE

    sync = torch.cuda.synchronize
    K.reset_launches()
    plans = {}
    for name, (sql, params, rest) in cells.items():
        t0 = time.perf_counter()
        rows = db.query(sql, params).to_dicts()
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
        eref.check(name, rows, params)
        plan = _only_plan(TE, snap, sql).plans[0]
        _require(plan.graph is not None and plan.replays == 0, f"{name}: not captured")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            rows = db.query(sql, params).to_dicts()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            eref.check(name, rows, params)
        for p in rest:
            eref.check(name, db.query(sql, p).to_dicts(), p)
        variants = _only_plan(TE, snap, sql)
        _require(
            len(variants.plans) == 1 and plan.replays == 5 + len(rest),
            f"{name}: {len(variants.plans)} variants, {plan.replays} replays",
        )
        med = statistics.median(times)
        REPLAY_MS.setdefault(name, med)
        per = plan.launches
        print(
            f"replay {name}: record {first_ms - plan.capture_ms:.3f} ms, capture {plan.capture_ms:.3f} ms, "
            f"replay median {med:.3f} ms over {len(times)} runs (runs {[round(t, 3) for t in times]}), "
            f"{len(rows) / med * 1e3:.1f} rows/s; {rest} replayed the {params} plan "
            f"(plan.replays {plan.replays}); launches per replay {sum(per.values())} {per}; "
            f"reserved after capture {plan.reserved_bytes} bytes [{card}]"
        )
        print(f"replay layers {name}: {replay_layers(torch, db, sql, plan, params)}")
        print(f"replay device {name}: {device_share(torch, db, sql, params, med)}")
        plans[name] = plan
    for name in ("E4", "E5"):
        if name in cells:
            _require(plans[name].launches.get("rows_with_matches", 0) > 0, f"{name}: rows_with_matches not in its replay")
    if "E1" in cells:
        # two walks, no fold: B's [2^25] weights (128 MB) are past L2
        per = plans["E1"].launches
        _require(per.get("weight_gather_i32", 0) == 2 and per.get("take_pad_b8", 0) == 0,
                 f"E1: the weight step launched {per}")
    sync()
    launches = dict(K.LAUNCHES)
    missing = [n for n in kernels if launches[n] == 0]
    _require(not missing, f"kernels never launched on the replay path of {list(cells)}: {missing}")
    for kernel in ("rows_with_matches", "predicate_eval"):
        print(
            f"{kernel} launches per replay: "
            + ", ".join(f"{n} {plans[n].launches.get(kernel, 0)}" for n in cells)
        )
    print(f"replay {list(cells)}: all equal numpy; launches {launches}")
    return launches, plans


def check_snb_kernels(torch, K, ks, dg, e1_plan, card: str) -> None:
    """E1's shapes on the SNB-shape graph. K15's edge mask (``creationDate >
    :d``) over the 80M ``knows`` edges in identity mode, as E1's replays run
    it (its compiled program and parameter row), held exactly against its
    plain version and timed eagerly and in a captured graph beside its
    bound (a value and a presence byte read, a mask byte written, an edge);
    then K4 over the ``knows`` CSR of all 24M vertices into vb = 2^25
    (Person segments of ~10 edges, 16M empty Message ones), held against its
    plain version (padded and cut) and timed the same way. These launches
    are not counted."""
    counted = dict(K.LAUNCHES)
    dec = dg.edges["knows"]
    V, E = dg.num_vertices, dec.num_edges
    vb = K.bucket(V)
    (pred,) = [p for (c, _w, _v), p in e1_plan.solver._edge_preds.items() if c == "knows"]
    row = pred.box.row(pred.device) if pred.uses_params else None
    tmps = []
    for prog in pred.programs:
        values = prog is not pred.programs[-1]
        bufs = prog.buffers({}, tmps, E)
        got = K.predicate_eval(prog.prog, bufs, None, E, E, 0, 0, row, values=values)
        ks.same("predicate_eval", got, K.plain_predicate_eval(prog.prog, bufs, None, E, E, 0, 0, row, values=values))
        tmps.append(got)
    emask = tmps[-1]
    kernel = lambda: pred.identity(E)  # noqa: E731
    rows = sum(len(p.prog.rows) for p in pred.programs)
    print(
        f"kernel predicate_eval, E1 edge mask ({rows} instructions, {E} edges, {int(emask.sum())} admitted): "
        f"{_time_ms(torch, kernel):.4f} ms eager, {_graph_ms(torch, kernel):.4f} ms in a captured graph, "
        f"bound {6.0 * E / HBM_BYTES_PER_S * 1e3:.4f} ms [{card}]"
    )
    contrib = (K.take_pad(dg.columns["age"].values, dec.dst, 0) < 30) & emask
    for name, dtype in (("segment_sum_i32", torch.int32), ("segment_sum_f32", torch.float32)):
        vals = contrib.to(dtype)
        for out_size in (vb, V // 3):
            same_segment_sum(torch, K, ks, name, vals, dec.indptr_out, out_size)
        print_segment_sum(torch, K, None, name, vals, dec.indptr_out, vb, "E1", card)
    # the fused weight gather on E1's two walks: hasCreator read backwards
    # from f (16M edges < vb: the node mask at the endpoints), then knows
    # out of p with the edge mask and the weights from hasCreator
    hc = dg.edges["hasCreator"]
    gen = torch.Generator(device=dg.device).manual_seed(71)
    node_ok = torch.rand(hc.num_edges, generator=gen, device=dg.device) < 0.9
    age = dg.columns["age"].values
    ok_vec = torch.cat([age < 30, torch.zeros(vb - V, dtype=torch.bool, device=dg.device)])
    ws = {}
    for dtype in (torch.int32, torch.float32):
        same_weight_gather(torch, K, ks, hc.src, dtype, node_ok=node_ok)
        ws[dtype] = w = K.indptr_segment_sum(K.weight_gather(hc.src, dtype, node_ok=node_ok), hc.indptr_in, vb)
        same_weight_gather(torch, K, ks, dec.dst, dtype, ok=ok_vec, emask=emask, w=w)
        same_weight_gather(torch, K, ks, dec.src, dtype, ok=ok_vec, emask=emask, eid=dec.edge_id_in, w=w)
    print("kernel weight_gather: equals its plain version on E1's walks")
    time_weight_gather(torch, K, "E1's hasCreator walk (node mask)", card, hc.src, torch.int32, node_ok=node_ok)
    time_weight_gather(torch, K, "E1's knows walk (ok, edge mask, w)", card, dec.dst, torch.int32, ok=ok_vec,
                       emask=emask, w=ws[torch.int32])
    torch.cuda.synchronize()
    K.LAUNCHES.update(counted)


def check_rows_with_matches(torch, K, ks, dg) -> None:
    """K13 against its plain version at E4's shapes (the roots p < 20000
    in their recorded buffer, one out hop over knows, the age > 75 mask)
    and at edge cases, exactly; times it there, beside the bincount
    yardstick; then checks and times it on 2^26 ascending slots."""
    from orientdb_tpu_torch.exec.tpu_engine import _cap_of

    dev = dg.device
    i32 = torch.int32
    dec = dg.edges["knows"]
    age = dg.columns["age"].values
    n = E_CELLS["E4"][1]["n"]
    width = _cap_of(n)
    srcs = torch.cat([torch.arange(n, dtype=i32, device=dev), torch.full((width - n,), -1, dtype=i32, device=dev)])
    offsets, total = K.expand_offsets(dec.indptr_out, srcs)
    row, _pos, nbr = K.gather_expand(dec.indptr_out, dec.dst, srcs, offsets, total, _cap_of(int(total)))
    mask = (row >= 0) & (K.take_pad(age, nbr, 0) > 75)
    W = int(row.shape[0])
    gen = torch.Generator(device=dev).manual_seed(13)
    perm = torch.randperm(W, generator=gen, device=dev)
    cases = [
        (row, mask, width),
        (row, mask, 1),
        (row[perm].contiguous(), mask[perm].contiguous(), width),  # shuffled rows
        (torch.full_like(row, -1), mask, width),  # all padding
        (row, torch.zeros_like(mask), width),  # all masked
        (row, mask, n // 2),  # ids past the end
    ]
    for k in EDGE_LENGTHS:
        cases.append((row[:k].contiguous(), mask[:k].contiguous(), 7))
    for r, m, segs in cases:
        ks.same("rows_with_matches", K.rows_with_matches(r, m, segs), K.plain_rows_with_matches(r, m, segs))
        acc = torch.full((segs,), 5, dtype=i32, device=dev)
        ks.same("rows_with_matches", K.rows_with_matches(r, m, segs, out=acc), K.plain_rows_with_matches(r, m, segs) + 5)
    matched = int((K.plain_rows_with_matches(row, mask, width) > 0).sum())
    ok = mask & (row >= 0)
    ks.timed(
        "rows_with_matches",
        lambda: K.rows_with_matches(row, mask, width),
        lambda: K.plain_rows_with_matches(row, mask, width),
        lambda: torch.bincount(row[ok], minlength=width),
        5.0 * W + 4.0 * width,
    )
    # the config-5 expansion's scale: 2^26 ascending slots, ten a row
    Wb = 1 << 26
    rows_b = torch.arange(Wb, dtype=i32, device=dev) // 10
    mask_b = torch.rand(Wb, generator=gen, device=dev) < 0.5
    segs_b = K.bucket(Wb // 10 + 1)
    ks.same("rows_with_matches", K.rows_with_matches(rows_b, mask_b, segs_b), K.plain_rows_with_matches(rows_b, mask_b, segs_b))
    big_ms = _time_ms(torch, lambda: K.rows_with_matches(rows_b, mask_b, segs_b))
    big_plain = _time_ms(torch, lambda: K.plain_rows_with_matches(rows_b, mask_b, segs_b))
    big_bound = (5.0 * Wb + 4.0 * segs_b) / HBM_BYTES_PER_S * 1e3
    graph_ms = _graph_ms(torch, lambda: K.rows_with_matches(row, mask, width))
    print(
        f"kernel rows_with_matches at E4's shapes: W={W}, num_segments={width}, {matched} of {n} rows matched, "
        f"{graph_ms:.4f} ms in a graph; "
        f"at W=2^26 ascending (10 a row), num_segments={segs_b}: {big_ms:.4f} ms, plain {big_plain:.4f} ms, "
        f"bound {big_bound:.4f} ms"
    )
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 5c: TRAVERSE, record rows and compiled SELECT on A
# ---------------------------------------------------------------------------

TR1 = (
    "TRAVERSE out('knows') FROM (SELECT FROM Person WHERE uid < 50) "
    "WHILE $depth < 2 STRATEGY BREADTH_FIRST"
)
TR2 = "TRAVERSE both('knows') FROM (SELECT FROM Person WHERE uid < 20) MAXDEPTH 3 STRATEGY BREADTH_FIRST"
TR3 = (
    "TRAVERSE out('knows') FROM (SELECT FROM Person WHERE uid < 100) "
    "WHILE $depth < 4 AND age > 30 STRATEGY BREADTH_FIRST"
)
#: the whole closure of one person (unconditional DEPTH_FIRST: reachability)
TR4 = "TRAVERSE out('knows') FROM #{c}:0"
TR4_DICTS = 1_000_000
S1 = "SELECT count(*) AS n FROM Person WHERE age > 35 AND age < 55"
S2 = "SELECT FROM Person WHERE uid < :k"
S2_K, S2_K_SMALLER = 2000, 1000
M_POS = 123_457
M1 = "MATCH {{class:Person, rid:#{c}:{p}, as:p}}-knows->{{as:f}} RETURN p, f, f.@class"
M2 = "MATCH {{class:Person, rid:#{c}:{p}, as:p}}-knows->{{as:f}} RETURN $elements"
BT1_ITEMS = 8
#: the kernels a TRAVERSE replay runs: the root seed (K16), the hops (K10),
#: the admission (K12), the level's compaction (K3) and the WHILE gate (K15)
TRAVERSE_KERNELS = ["scatter_set", "bitmap_hop_csr", "frontier_advance", "compact_indices", "predicate_eval"]


def csr_neighbours(np, indptr, nbrs, f):
    """Every neighbour (with repeats) of the vertices ``f`` in one CSR."""
    deg = indptr[f + 1] - indptr[f]
    start = np.repeat(indptr[f] - (np.cumsum(deg) - deg), deg)
    return nbrs[start + np.arange(int(deg.sum()))]


def numpy_traverse(np, n, roots, expand, max_depth=None, admit=None):
    """The reference's BREADTH_FIRST TRAVERSE over host arrays: depth 0 the
    roots in their order (first occurrence kept), then each level's newly
    reached vertices that ``admit(depth)`` keeps (a bool, or a bool [n]
    vector), ascending; it stops on an empty level or at ``max_depth``.
    Returns (vertex ids in emission order, level sizes)."""
    roots = np.asarray(roots, np.int64)
    _, first = np.unique(roots, return_index=True)
    roots = roots[np.sort(first)]
    visited = np.zeros(n, bool)
    visited[roots] = True
    parts, levels = [roots], [int(roots.shape[0])]
    frontier, depth = roots, 0
    while max_depth is None or depth < max_depth:
        new = np.zeros(n, bool)
        new[expand(frontier)] = True
        new &= ~visited
        if admit is not None:
            new &= admit(depth + 1)
        level = np.flatnonzero(new)
        if level.size == 0:
            break
        visited[level] = True
        parts.append(level)
        levels.append(int(level.size))
        frontier, depth = level, depth + 1
    return np.concatenate(parts), levels


class TRRef:
    """numpy answers of the phase 5c cells from A's host arrays."""

    def __init__(self, np, snap, pc: int):
        self.np, self.snap, self.pc = np, snap, pc
        csr = snap.edge_classes["knows"]
        n = snap.num_vertices
        ip_out, ip_in = csr.indptr_out.astype(np.int64), csr.indptr_in.astype(np.int64)
        self.age = snap.v_columns["age"].values
        self.out = lambda f: csr_neighbours(np, ip_out, csr.dst, f)  # noqa: E731
        both = lambda f: np.concatenate([self.out(f), csr_neighbours(np, ip_in, csr.src, f)])  # noqa: E731
        old = self.age > 30
        self.tr = {
            "TR1": numpy_traverse(np, n, np.arange(50), self.out, admit=lambda d: d < 2),
            "TR2": numpy_traverse(np, n, np.arange(20), both, max_depth=3),
            "TR3": numpy_traverse(np, n, np.arange(100), self.out, admit=lambda d: old & (d < 4)),
            "TR4": numpy_traverse(np, n, np.arange(1), self.out),
        }
        self.s1 = int(((self.age > 35) & (self.age < 55)).sum())
        self.m_f = self.out(np.array([M_POS]))

    def rid(self, i) -> str:
        return f"#{self.pc}:{i}"

    def check_records(self, name, rows, ids, stride: int = 1) -> None:
        """Each ``stride``-th record row against the host columns at its
        vertex: ``@rid``, ``@class``, ``uid``, ``age``, ``lat`` / ``lng``
        (float32 values; an absent one leaves its key out)."""
        cols = self.snap.v_columns
        for j in range(0, len(rows), stride):
            r, i = rows[j], int(ids[j])
            want = {"@rid": self.rid(i), "@class": "Person", "uid": i, "age": int(self.age[i])}
            for g in ("lat", "lng"):
                if cols[g].present[i]:
                    want[g] = float(cols[g].values[i])
            _require(r == want, f"{name}: record {j} {r} != {want}")

    def check(self, name, rows, params=None) -> None:
        np = self.np
        if name == "S1":
            _require(rows == [{"n": self.s1}], f"S1 {rows} != numpy {self.s1}")
            return
        if name == "S2":
            k = params["k"]
            ids = sorted(int(r["uid"]) for r in rows)
            _require(ids == list(range(k)), f"S2 k={k}: the uids are not 0..k-1")
            self.check_records(name, sorted(rows, key=lambda r: r["uid"]), range(k))
            return
        if name == "M1":
            got = sorted((r["p"], r["f"], r["f.@class"]) for r in rows)
            want = sorted((self.rid(M_POS), self.rid(int(f)), "Person") for f in self.m_f)
            _require(got == want, "M1 rows differ from numpy")
            return
        if name == "M2":
            want = [x for f in self.m_f for x in (M_POS, int(f))]
            _require([r["@rid"] for r in rows] == [self.rid(i) for i in want], "M2 records differ from numpy")
            self.check_records(name, rows, want)
            return
        ids, _levels = self.tr[name]
        got = np.array([int(r["@rid"].split(":")[1]) for r in rows], np.int64)
        _require(np.array_equal(got, ids), f"{name}: records differ from numpy (order included)")
        self.check_records(name, rows, ids, stride=max(1, len(rows) // 20_000))


def _tr_cells(pc: int):
    """cell → (statement, parameters); TR4 and the M cells name Person's
    cluster."""
    return {
        "TR1": (TR1, None),
        "TR2": (TR2, None),
        "TR3": (TR3, None),
        "TR4": (TR4.format(c=pc), None),
        "S1": (S1, None),
        "S2": (S2, {"k": S2_K}),
        "M1": (M1.format(c=pc, p=M_POS), None),
        "M2": (M2.format(c=pc, p=M_POS), None),
    }


def _tr4_ids(rs):
    """TR4's vertex ids from its result set, without decoding a record."""
    _require(hasattr(rs._rows, "ids"), "TR4 did not return record rows")
    return rs._rows.ids


def run_traverse(np, torch, K, TE, ks, db, snap, card: str):
    """Phase 5c: TRAVERSE, record rows and compiled SELECT on A through
    ``db.query`` / ``db.query_batch``. Each cell first on the recording
    path (plan cache off), launch counts zeroed before and read after, then
    recorded, captured and replayed 5 times with the cache on; every
    result equals numpy (TR4's ids in order, its first 1,000,000 rows
    decoded and timed). BT1: TR1 × 8 as one shared dispatch. Then the
    kernel forms of this path against their plain versions. Returns the
    replay path's launches."""
    from orientdb_tpu_torch.exec.result import RecordRows
    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.utils.config import config

    sync = torch.cuda.synchronize
    pc = db.schema.get_class("Person").cluster_ids[0]
    t0 = time.perf_counter()
    ref = TRRef(np, snap, pc)
    print(
        f"numpy references of TR1–TR4, S1, M1: {time.perf_counter() - t0:.1f} s; levels "
        + ", ".join(f"{n} {lv}" for n, (_ids, lv) in ref.tr.items())
    )
    cells = _tr_cells(pc)

    def run(name, sql, params):
        """The cell through the front door: its rows, or TR4's vertex ids
        (its records stay undecoded). Timed without its check."""
        rs = db.query(sql, params)
        return _tr4_ids(rs) if name == "TR4" else rs.to_dicts()

    def check(name, out, params):
        if name == "TR4":
            _require(np.array_equal(out, ref.tr["TR4"][0]), "TR4: vertex ids differ from numpy (order included)")
        else:
            ref.check(name, out, params)

    # the recording path, the plan cache off
    cache = config.plan_cache_size
    config.plan_cache_size = 0
    try:
        K.reset_launches()
        before = dict(K.LAUNCHES)
        for name, (sql, params) in cells.items():
            t = time.perf_counter()
            out = run(name, sql, params)
            sync()
            ms = (time.perf_counter() - t) * 1e3
            check(name, out, params)
            after = dict(K.LAUNCHES)
            per = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            before = after
            print(f"record {name}: {ms:.3f} ms (plan cache off); launches {sum(per.values())} {per} [{card}]")
        sync()
        rec = dict(K.LAUNCHES)
        missing = [n for n in TRAVERSE_KERNELS if rec[n] == 0]
        _require(not missing, f"kernels never launched on the TRAVERSE recording path: {missing}")
    finally:
        config.plan_cache_size = cache

    # record + capture, then 5 replays
    K.reset_launches()
    plans = {}
    for name, (sql, params) in cells.items():
        t = time.perf_counter()
        out = run(name, sql, params)
        sync()
        first_ms = (time.perf_counter() - t) * 1e3
        check(name, out, params)
        plan = _only_plan(TE, snap, sql).plans[0]
        _require(plan.graph is not None and plan.replays == 0, f"{name}: not captured")
        times = []
        for _ in range(5):
            t = time.perf_counter()
            out = run(name, sql, params)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            check(name, out, params)
        _require(plan.replays == 5 and len(_only_plan(TE, snap, sql).plans) == 1, f"{name}: replays {plan.replays}")
        med = statistics.median(times)
        REPLAY_MS.setdefault(name, med)
        levels = getattr(plan.solver, "levels", None)
        print(
            f"replay {name}: record {first_ms - plan.capture_ms:.3f} ms, capture {plan.capture_ms:.3f} ms, "
            f"replay median {med:.3f} ms over {len(times)} runs (runs {[round(x, 3) for x in times]}); "
            f"{len(out)} rows, levels {levels}; launches per replay {sum(plan.launches.values())} "
            f"{plan.launches}; reserved after capture {plan.reserved_bytes} bytes [{card}]"
        )
        if name == "TR4":
            print(f"replay device TR4: {busy_share(torch, lambda: db.query(sql), med)}")
            ids = out
            t = time.perf_counter()
            rows = RecordRows(snap, ids[:TR4_DICTS]).to_dicts()
            dict_ms = (time.perf_counter() - t) * 1e3
            ref.check_records("TR4", rows, ids[:TR4_DICTS], stride=97)
            print(
                f"replay TR4: {len(ids)} records; to_dicts() of the first {len(rows)} rows {dict_ms:.3f} ms "
                f"({len(rows) / dict_ms * 1e3:.0f} rows/s) [{card}]"
            )
            del rows
        else:
            print(f"replay layers {name}: {replay_layers(torch, db, sql, plan, params)}")
            print(f"replay device {name}: {device_share(torch, db, sql, params, med)}")
        plans[name] = plan
    # S2 at a smaller k replays the k = 2000 plan (SELECT is parameter-generic)
    s2 = plans["S2"]
    before = s2.replays
    check("S2", run("S2", S2, {"k": S2_K_SMALLER}), {"k": S2_K_SMALLER})
    _require(
        s2.replays == before + 1 and len(_only_plan(TE, snap, S2).plans) == 1,
        "S2 k=1000 did not replay the k=2000 plan",
    )
    print(f"replay S2 k={S2_K_SMALLER}: {S2_K_SMALLER} records from the k={S2_K} plan (replay {s2.replays})")
    for name in ("TR1", "TR2", "TR3", "TR4"):
        _require(isinstance(plans[name], TE._CompiledTraverse), f"{name} is not a TRAVERSE plan")
    for kernel in TRAVERSE_KERNELS:
        _require(
            any(plans[n].launches.get(kernel, 0) > 0 for n in ("TR1", "TR3")),
            f"{kernel} not in the TRAVERSE replays",
        )
    # BT1: TR1 x 8 through query_batch, one shared dispatch; then the
    # reference's batch statistic beside the same items run one by one
    tr1 = plans["TR1"]
    before = tr1.replays
    for rs in db.query_batch([TR1] * BT1_ITEMS):
        ref.check("TR1", rs.to_dicts())
    _require(tr1.replays == before + 1, f"BT1 was not one shared dispatch ({tr1.replays - before} replays)")

    def batched():
        return [rs.to_dicts() for rs in db.query_batch([TR1] * BT1_ITEMS)]

    def sequential():
        return [db.query(TR1).to_dicts() for _ in range(BT1_ITEMS)]

    # one shot of each right after the cells above, then the reference's
    # statistic, before and after a full collection, each with the time the
    # collector spent inside it (a full pass walks every object the cells
    # above left alive)
    shots = []
    for fn in (batched, sequential):
        with GcClock() as g:
            t = time.perf_counter()
            fn()
            shots.append(f"{(time.perf_counter() - t) * 1e3:.3f} ms (collector: {g})")
    tracked = len(gc.get_objects())
    stats, qps = [], {}
    for when in ("before", "after"):
        if when == "after":
            t = time.perf_counter()
            gc.collect()
            stats.append(f"a full collection {(time.perf_counter() - t) * 1e3:.3f} ms")
        for fn in (batched, sequential):
            with GcClock() as g:
                qps[fn.__name__, when] = _batch_qps(fn, BT1_ITEMS)
            stats.append(f"{fn.__name__} {when} {qps[fn.__name__, when]:.1f} q/s (collector: {g})")
    print(
        f"batch BT1 shots: batched {shots[0]}, sequential {shots[1]}; {tracked} objects tracked "
        f"before the collection [{card}]"
    )
    print(
        f"batch BT1: TR1 x {BT1_ITEMS} in one shared dispatch (each equal to numpy): "
        f"{qps['batched', 'after']:.1f} q/s against {qps['sequential', 'after']:.1f} q/s sequential after a full "
        f"collection; " + "; ".join(stats) + f" [{card}]"
    )
    sync()
    launches = dict(K.LAUNCHES)
    print(f"traverse replay path: all equal numpy; launches {launches}")
    check_traverse_kernels(np, torch, K, ks, device_graph(snap, db.device), ref, plans)
    TE._plan_cache(snap).clear()
    return launches


def check_traverse_kernels(np, torch, K, ks, dg, ref, plans) -> None:
    """The three kernel forms of the TRAVERSE path against their plain
    versions, exactly, at TR3's and TR4's shapes: K12 with its admission
    gate on TR3's first level ([1, 2^23] bitmaps; TR3's gate, an empty
    gate, an all-true gate, none; row lengths off the 16-byte path), K15's
    ID instruction in M1's node mask over the 2^23-slot universe (and a
    compare against -2), K3's offset form on TR4's largest level (and at
    the buffer's end, and at edge lengths). Then re-times the three rows
    in their new forms; the gate-free K12 and the ID-free K15 keep their
    checks of phase 3 and print their times beside."""
    from orientdb_tpu_torch.ops.predicates import Predicate, id_term

    dev = dg.device
    V = dg.num_vertices
    vb = K.bucket(V)
    dec = dg.edges["knows"]
    counted = dict(K.LAUNCHES)

    # K12: TR3's first level, gated by age > 30 at $depth 1
    roots = torch.zeros((1, vb), dtype=torch.bool, device=dev)
    roots[0, :100] = True
    nxt = K.bitmap_hop(dec.edge_src, dec.dst, None, roots)
    tr3 = plans["TR3"].solver
    gate = tr3.while_fn.identity(vb, V, env={"depth": 1})
    cases = [gate, torch.zeros(vb, dtype=torch.bool, device=dev), torch.ones(vb, dtype=torch.bool, device=dev), None]
    for g in cases:
        n1, v1, n2, v2 = nxt.clone(), roots.clone(), nxt.clone(), roots.clone()
        ks.same("frontier_advance", (n1, v1, K.frontier_advance(n1, v1, g)), (n2, v2, K.plain_frontier_advance(n2, v2, g)))
    for n in EDGE_LENGTHS[1:]:
        a, b = nxt[:, :n].contiguous(), roots[:, :n].contiguous()
        g = gate[:n].contiguous()
        n1, v1, n2, v2 = a.clone(), b.clone(), a.clone(), b.clone()
        ks.same("frontier_advance", (n1, v1, K.frontier_advance(n1, v1, g)), (n2, v2, K.plain_frontier_advance(n2, v2, g)))
    reached = int(K.mask_count(nxt.view(-1)))
    kern, plain = _copies((nxt, roots), 11), _copies((nxt, roots), 11)
    ks.timed(
        "frontier_advance",
        lambda: K.frontier_advance(*next(kern), gate),
        lambda: K.plain_frontier_advance(*next(plain), gate),
        None,  # an and-not, an and, an or and a count: four calls at least
        level_step_bytes(torch, nxt, gate=gate),
    )
    gated = lambda n, v: K.frontier_advance(n, v, gate)  # noqa: E731
    print(
        f"kernel frontier_advance gated at [1, {vb}] ({int(K.frontier_advance(nxt.clone(), roots.clone(), gate))} "
        f"admitted of {reached} reached, {nonzero_groups(torch, nxt)} non-zero groups): "
        f"{ks.rows['frontier_advance']['ms']:.4f} ms (was {WAS_LEVEL_MS['K12 gated, eager']:.4f}); "
        f"gate-free {_fresh_ms(torch, lambda n, v: K.frontier_advance(n, v), (nxt, roots)):.4f} ms, in a graph "
        f"{_fresh_ms(torch, gated, (nxt, roots), graph=True):.4f} ms (was {WAS_LEVEL_MS['K12 gated, in a graph']:.4f}); "
        f"bound {ks.rows['frontier_advance']['bound_ms']:.4f}"
    )

    # K15: M1's node mask p (valid, Person's class, the ID compare)
    m1 = plans["M1"].solver
    pred = m1._node_masks["p"]
    (prog,) = pred.programs
    _require(any(r[0] == K.PredOp.ID for r in prog.prog.rows), "M1's mask has no ID instruction")
    bufs = prog.buffers({}, [], vb)
    ks.same("predicate_eval", pred.identity(vb, V), K.plain_predicate_eval(prog.prog, bufs, None, vb, V))
    _require(int(pred.identity(vb, V).sum()) == 1, "M1's mask does not admit exactly its RID")
    none = Predicate([id_term(-2)], dev)
    ids = torch.randint(-2, vb + 2, (1 << 23,), dtype=torch.int32, device=dev)
    for p in (none, pred):
        (pg,) = p.programs
        b = pg.buffers({}, [], ids.shape[0])
        ks.same("predicate_eval", p(ids), K.plain_predicate_eval(pg.prog, b, ids))
    _require(not bool(none(ids).any()), "an ID compare against -2 admitted a slot")
    ks.timed(
        "predicate_eval",
        lambda: pred.identity(vb, V),
        lambda: K.plain_predicate_eval(prog.prog, bufs, None, vb, V),
        None,  # no single PyTorch call evaluates a predicate program
        # the mask written; the class id read at the one slot the ID term
        # admits (every other slot's answer needs no column)
        vb + 4.0,
    )
    print(
        f"kernel predicate_eval, M1 node mask p ({len(prog.prog.rows)} instructions, ID): "
        f"{ks.rows['predicate_eval']['ms']:.4f} ms eager, {_graph_ms(torch, lambda: pred.identity(vb, V)):.4f} ms "
        f"in a captured graph"
    )

    # K3's offset form: TR4's largest level, written at its offset
    ids4, levels = ref.tr["TR4"]
    big = int(np.argmax(levels))
    off = int(sum(levels[:big]))
    cnt = levels[big]
    level = torch.from_numpy(ids4[off : off + cnt]).to(dev)
    mask = torch.zeros(vb, dtype=torch.bool, device=dev)
    mask[level.long()] = True
    total = int(sum(levels))
    width = K.bucket(total)
    for size, at in ((cnt, off), (cnt + 5, off), (0, width)):
        a = torch.full((width,), -1, dtype=torch.int32, device=dev)
        b = a.clone()
        K.compact_indices(mask, size, out=a, offset=at)
        K.plain_compact_indices(mask, size, out=b, offset=at)
        ks.same("compact_indices", a, b)
    for n in EDGE_LENGTHS:
        m = mask[:n].contiguous()
        a = torch.full((n + 9,), -1, dtype=torch.int32, device=dev)
        b = a.clone()
        c = int(m.sum())
        ks.same("compact_indices", K.compact_indices(m, c, out=a, offset=9 - (n % 9)), K.plain_compact_indices(m, c, out=b, offset=9 - (n % 9)))
        ks.same("compact_indices", a, b)
    buf = torch.full((width,), -1, dtype=torch.int32, device=dev)
    ks.timed(
        "compact_indices",
        lambda: K.compact_indices(mask, cnt, out=buf, offset=off),
        lambda: K.plain_compact_indices(mask, cnt, out=buf, offset=off),
        lambda: torch.nonzero(mask),
        vb + 4.0 * cnt,  # the mask read, the level's indices written
    )
    row = ks.rows["compact_indices"]
    print(
        f"kernel compact_indices, offset form on TR4's level {big} ({cnt} of {vb} slots at offset {off}): "
        f"{row['ms']:.4f} ms eager (was {WAS_MS['compact offset']}), "
        f"{_graph_ms(torch, lambda: K.compact_indices(mask, cnt, out=buf, offset=off)):.4f} ms in a graph; "
        f"torch.nonzero {row['library_ms']:.4f} eager; bound {row['bound_ms']:.4f} ms; per call "
        f"{one_kernel_one_memset(torch, 'compact_indices offset form', lambda: K.compact_indices(mask, cnt, out=buf, offset=off))}"
    )
    torch.cuda.synchronize()
    K.LAUNCHES.update(counted)


# ---------------------------------------------------------------------------
# phase 7: batches (db.query_batch)
# ---------------------------------------------------------------------------


class GcClock:
    """The collector's passes and milliseconds, by generation, while a
    block runs (`gc.callbacks`)."""

    def __init__(self) -> None:
        self.n = [0, 0, 0]
        self.ms = [0.0, 0.0, 0.0]
        self._t = None

    def _cb(self, phase, info) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            g = info["generation"]
            self.n[g] += 1
            self.ms[g] += (time.perf_counter() - self._t) * 1e3
            self._t = None

    def __enter__(self) -> "GcClock":
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)

    def __str__(self) -> str:
        return ", ".join(f"gen {g} {self.n[g]} passes {self.ms[g]:.3f} ms" for g in range(3))


def _batch_qps(run, n_items: int, iters: int = 3, reps: int = 3) -> float:
    """The reference bench's statistic (`bench.py:273`, after its warm
    rounds): the median over ``reps`` of ``iters`` timed runs, in items/s."""
    qps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        qps.append(iters * n_items / (time.perf_counter() - t0))
    return statistics.median(qps)


def _cell_plans(TE, snap, sqls):
    """Every cached plan (all variants) of the statements ``sqls``."""
    from orientdb_tpu_torch.sql.parser import parse

    stmts = {parse(s) for s in sqls}
    return [p for k, v in TE._plan_cache(snap).items() if k[0] in stmts for p in v.plans]


class BatchCell:
    """One batch cell: its items, the check of each item's rows, the path
    its plans must take (``shared``, ``group``, ``per-lane``; None where
    the plan decides) and the (sql, params) each statement is first
    recorded with (its cell's largest parameter)."""

    def __init__(self, name, sqls, plist, check, path, warm=()):
        self.name, self.sqls, self.check, self.path, self.warm = name, sqls, check, path, warm
        self.plist = plist if plist is not None else [None] * len(sqls)
        #: peak device bytes allocated while the cell ran (`run_batch_cell`)
        self.peak_bytes = 0


def run_batch_cell(torch, K, TE, db, snap, card, cell: BatchCell, timed: bool = True):
    """One cell through ``db.query_batch``: the first batch (a group's
    capture included) checked item by item; the path each plan took, from
    its replay counters; each group's capture ms, graph nodes, launches per
    group replay and reserved bytes beside the plan's own; the peak device
    memory above the resident graph while the warm-up recorded and
    captured the plans, and while the first batch ran (a group whose lanes
    kept their intermediates would hold Bb times a lane's). When
    ``timed``: the batch's q/s by the reference's statistic (two warm
    rounds, then the median of 3 reps of 3 batches, each result's rows
    built and dropped), the same items as sequential ``db.query`` calls in
    q/s (median of 3 runs), one batch's host split (parsing the
    statements; ``query_batch``: dispatch, meta wave, page election and
    fetch, marshal; ``to_dicts``) and its busy share. Returns ``(plan,
    replays, group replays)`` of the first batch for every plan that
    served the cell."""
    from orientdb_tpu_torch.sql.parser import parse

    sync = torch.cuda.synchronize
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for sql, params in cell.warm:
        db.query(sql, params).to_dicts()
    sync()
    cell.peak_bytes = torch.cuda.max_memory_allocated()
    warm_peak = cell.peak_bytes - base
    before = {id(p): (p.replays, p.group_replays) for p in _cell_plans(TE, snap, cell.sqls)}
    l0 = dict(K.LAUNCHES)

    def run():
        for rs in db.query_batch(cell.sqls, cell.plist):
            rs.to_dicts()
        sync()

    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = [rs.to_dicts() for rs in db.query_batch(cell.sqls, cell.plist)]
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    first_peak = torch.cuda.max_memory_allocated() - base
    for i, r in enumerate(rows):
        cell.check(i, r)
    launched = {k: K.LAUNCHES[k] - l0[k] for k in l0 if K.LAUNCHES[k] != l0[k]}
    stmts = [parse(s) for s in cell.sqls]
    paths = []
    for p in _cell_plans(TE, snap, cell.sqls):
        r0, g0 = before.get(id(p), (0, 0))
        dr, dg = p.replays - r0, p.group_replays - g0
        if id(p) not in before:
            kind = "recorded"
        elif dg:
            kind = "group"
        elif dr == 1 and stmts.count(p.solver.stmt) >= TE._GROUP_MIN and not p.dyn_spec:
            kind = "shared"
        elif dr:
            kind = "per-lane"
        else:
            continue
        d = (
            f"{kind} (width {p.width}, columns {p.ncols}, direct_fetch {p.direct_fetch}, "
            f"batchable {p.batchable()}, replays +{dr}, group replays +{dg}"
        )
        if kind == "group":
            Bb = min(1 << (len(cell.sqls) - 1).bit_length(), p._group_lane_cap())
            g = p.groups[Bb]
            d += (
                f"; Bb {Bb}, lane axis {getattr(p, 'lane_axis', None)}, {dg} chunks, capture {g.capture_ms} ms, "
                f"{g.nodes} graph nodes, "
                f"launches per group replay {sum(g.launches.values())} {g.launches}, reserved after "
                f"the group capture {g.reserved_bytes} bytes vs {p.reserved_bytes} after the plan's own"
            )
        paths.append((kind, p, dr, dg, d + ")"))
    print(
        f"batch {cell.name}: {len(cell.sqls)} items, first batch {first_ms:.3f} ms, all equal numpy; "
        f"paths: {'; '.join(d for *_x, d in paths)}; launches {launched}; peak allocated above the "
        f"resident {warm_peak} bytes while the warm-up recorded and captured, {first_peak} bytes in "
        f"the first batch [{card}]"
    )
    kinds = {k for k, *_x in paths}
    if cell.path is not None:
        _require(kinds == {cell.path}, f"batch {cell.name}: paths {kinds}, want {cell.path}")
    if timed:
        run()  # the second warm round
        bq = _batch_qps(run, len(cell.sqls))

        def seq():
            for s, p in zip(cell.sqls, cell.plist):
                db.query(s, p).to_dicts()
            sync()

        seq()
        sq = _batch_qps(seq, len(cell.sqls), iters=1)
        print(
            f"batch {cell.name}: {bq:.1f} q/s batched, {sq:.1f} q/s as sequential db.query "
            f"(x{bq / sq:.2f}) [{card}]"
        )
        t0 = time.perf_counter()
        for s in cell.sqls:
            parse(s)
        t1 = time.perf_counter()
        rss = db.query_batch(cell.sqls, cell.plist)
        sync()
        t2 = time.perf_counter()
        for rs in rss:
            rs.to_dicts()
        t3 = time.perf_counter()
        print(
            f"batch layers {cell.name}: parsing the statements {(t1 - t0) * 1e3:.3f} ms (inside "
            f"query_batch), query_batch {(t2 - t1) * 1e3:.3f} ms, to_dicts {(t3 - t2) * 1e3:.3f} ms"
        )
        print(f"batch device {cell.name}: {busy_share(torch, run, len(cell.sqls) / bq * 1e3)}")
    cell.peak_bytes = max(cell.peak_bytes, torch.cuda.max_memory_allocated())
    return [(p, dr, dg) for _k, p, dr, dg, _d in paths]


def _rows_check(np, name, want_of, cols):
    """Check of item i's rows against ``want_of(i)`` (sorted int64 rows)."""

    def check(i, rows):
        got = _sorted_rows(np, rows, cols)
        want = want_of(i)
        _require(got.shape == want.shape and np.array_equal(got, want), f"batch {name} item {i}: rows differ from numpy")

    return check


def _below(rows, k):
    """The sorted rows (root id first) of the roots p < k."""
    return rows[rows[:, 0] < k]


def run_batches_pk(np, torch, K, ks, db, snap, card, vref, q3_big, gref):
    """Phase 7a: the batch cells on the Person–knows graph, the plan cache
    cleared first; then K14 against its plain version at BQ3's lane stack.
    ``q3_big`` holds Q3's sorted numpy rows at k = 50,000; every Q3 item
    filters them by p < k. Returns the peak device bytes allocated."""
    from orientdb_tpu_torch.exec import tpu_engine as TE

    TE._plan_cache(snap).clear()
    V = snap.num_vertices
    age = snap.v_columns["age"].values
    n1 = numpy_1hop_count(snap, age > 40, age < 30)
    n2 = numpy_2hop_count(snap, age > 40, np.ones(V, bool), age < 30)
    ks3 = [Q3_K // 2 + Q3_K // 32 * i for i in range(16)]  # 1000 + 62·i, as BQ3
    kv = list(range(9, 17))
    v2_all, v3_all = vref.v2(16), vref.v3(16)

    def count_is(n):
        return lambda i, rows: _require(rows == [{"n": n}], f"count {rows} != numpy {n}")

    q3_rows = lambda k: _rows_check(np, "Q3", lambda i: _below(q3_big, k), ("p", "f", "g"))  # noqa: E731
    done = []
    for cell in (
        BatchCell("BQ1", [Q1] * 64, None, count_is(n1), "shared", warm=[(Q1, None)]),
        BatchCell("BQ2", [Q2] * 64, None, count_is(n2), "shared", warm=[(Q2, None)]),
        BatchCell("BQ3", [Q3] * 16, [{"k": k} for k in ks3],
                  _rows_check(np, "BQ3", lambda i: _below(q3_big, ks3[i]), ("p", "f", "g")), "group",
                  warm=[(Q3, {"k": max(ks3)})]),
    ):
        run_batch_cell(torch, K, TE, db, snap, card, cell)
        done.append(cell)
    g1 = [{"x": 48.0, "y": 2.0, "r": 300.0 + 500.0 * i} for i in range(16)]
    bg1 = BatchCell("BG1", [G1] * 16, g1, lambda i, rows: gref.check("G1", rows, g1[i]), "group",
                    warm=[(G1, G_CELLS["G1"][1])])
    ((bg1_plan, _dr, _dg),) = run_batch_cell(torch, K, TE, db, snap, card, bg1)
    done.append(bg1)
    _require(bg1_plan.lane_axis and 16 in bg1_plan.groups, "BG1 is not a count group of 16 lanes on the lane axis")
    check_lane_kernels(
        np, torch, K, ks, bg1_plan, bg1_plan.groups[16].stack.clone(), "BG1", card,
        band_of=lambda b, slots: distance_band(np, gref.d[slots], g1[b]["r"]),
    )
    (q3,) = _cell_plans(TE, snap, [Q3])
    _require(q3._rows_grouped() and 16 in q3.groups, "BQ3 is not a rows group of 16 lanes")
    _require(q3.lane_axis, "BQ3 did not run on the lane axis")
    check_group_page(torch, K, ks, q3.groups[16].out["data"], q3, ks3, q3_big)
    check_lane_kernels(np, torch, K, ks, q3, q3.groups[16].stack.clone(), "BQ3", card, forms=ROWS_LANE_FORMS)
    compare_group_routes(torch, K, q3, q3.groups[16].stack.cpu().numpy(), "BQ3", card)
    # BQD: a direct-fetch group (Q_DIRECT × 16), its pages and meta rows
    # written straight into the group's direct stack
    kd = [Q_DIRECT_K - 4 * i for i in range(16)]
    bqd = BatchCell("BQD", [Q_DIRECT] * 16, [{"k": k} for k in kd],
                    _rows_check(np, "BQD", lambda i: numpy_direct_rows(np, snap, kd[i]), ("p", "f")), "group",
                    warm=[(Q_DIRECT, {"k": max(kd)})])
    ((qd, _dr, _dg),) = run_batch_cell(torch, K, TE, db, snap, card, bqd)
    done.append(bqd)
    _require(qd.direct_fetch and qd.lane_axis and 16 in qd.groups, "BQD is not a direct-fetch group on the lane axis")
    k1 = [200 - 12 * i for i in range(8)]
    bv = {}
    for cell in (
        BatchCell("BV1", [V1P] * 8, [{"k": k} for k in k1],
                  lambda i, rows: _require(rows == [{"n": vref.v1_below(k1[i])}],
                                           f"BV1 k={k1[i]}: {rows} != numpy {vref.v1_below(k1[i])}"), "group",
                  warm=[(V1P, {"k": max(k1)})]),
        BatchCell("BV2", [V2] * 8, [{"k": k} for k in kv],
                  _rows_check(np, "BV2", lambda i: _below(v2_all, kv[i]), ("p", "f", "d")), "group",
                  warm=[(V2, {"k": 16})]),
        BatchCell("BV3", [V3] * 8, [{"k": k} for k in kv],
                  _rows_check(np, "BV3", lambda i: _below(v3_all, kv[i]), ("p", "f")), "group",
                  warm=[(V3, {"k": 16})]),
    ):
        ((plan, _dr, _dg),) = run_batch_cell(torch, K, TE, db, snap, card, cell)
        done.append(cell)
        bv[cell.name] = plan
        g = plan.groups[8]
        print(f"batch {cell.name}: direct_fetch {plan.direct_fetch}, rows group {plan._rows_grouped()}")
        # the bitmap BFS inside the group replay through K10's, K11's and
        # (but for V3's NOT arm) K12's lane forms
        need = ["rows_to_bitmap", "bitmap_hop_csr_lanes", "bitmap_emit_lanes"]
        need += [] if cell.name == "BV3" else ["frontier_advance_lanes"]
        missing = [n for n in need if g.launches.get(n, 0) == 0]
        _require(plan.lane_axis, f"{cell.name} did not run on the lane axis")
        _require(cell.name != "BV2" or plan._rows_grouped(), "BV2 is not a rows group")
        _require(db.device.type != "cuda" or not missing, f"{cell.name}: {missing} not in the group replay")
    # the bitmap lane forms held at BV1's (K11's count-only depth 0, K12's
    # folded count), BV3's and then BV2's shapes (BV2's rows are the
    # JSON's), and BV2 and BV3 captured anew on each route
    for name, forms in (("BV1", BITMAP_LANE_FORMS), ("BV3", ("bitmap_hop_csr_lanes", "bitmap_emit_lanes")),
                        ("BV2", BITMAP_LANE_FORMS)):
        plan = bv[name]
        check_lane_kernels(np, torch, K, ks, plan, plan.groups[8].stack.clone(), name, card, forms=forms)
    for name in ("BV2", "BV3"):
        compare_group_routes(torch, K, bv[name], bv[name].groups[8].stack.cpu().numpy(), name, card)
    mix = [
        (Q1, None, count_is(n1)),
        (Q3, {"k": 2000}, q3_rows(2000)),
        (V1, None, lambda i, rows: vref.check("V1", rows, None)),
        (Q_DIRECT, {"k": Q_DIRECT_K},
         _rows_check(np, "Bmix", lambda i: numpy_direct_rows(np, snap, Q_DIRECT_K), ("p", "f"))),
        (Q3, {"k": 1000}, q3_rows(1000)),
        (V3, {"k": 16}, lambda i, rows: vref.check("V3", rows, {"k": 16})),
        (V2, {"k": 16}, lambda i, rows: vref.check("V2", rows, {"k": 16})),
    ]
    done.append(BatchCell("Bmix", [m[0] for m in mix], [m[1] for m in mix], lambda i, rows: mix[i][2](i, rows),
                          "per-lane", warm=[(V1, None), (Q_DIRECT, {"k": Q_DIRECT_K})]))
    run_batch_cell(torch, K, TE, db, snap, card, done[-1])
    # BQ3o: lane 15 past the recorded buckets re-records alone
    ks_o = ks3[:15] + [Q3_K_OVERFLOW]
    plist = [{"k": k} for k in ks_o]
    done.append(BatchCell("BQ3o", [Q3] * 16, plist,
                          _rows_check(np, "BQ3o", lambda i: _below(q3_big, ks_o[i]), ("p", "f", "g")), None))
    g3 = q3.group_replays
    run_batch_cell(torch, K, TE, db, snap, card, done[-1], timed=False)
    variants = _only_plan(TE, snap, Q3)
    _require(
        len(variants.plans) == 2 and variants.plans[1] is q3
        and all(variants.pick(p) is q3 for p in plist[:15]) and variants.pick(plist[15]) is variants.plans[0],
        "BQ3o: lane 15 did not re-record alone",
    )
    _require(q3.group_replays == g3 + 1 and q3.lane_axis, "BQ3o: lanes 0-14 did not run as one lane-axis group")
    print(
        f"batch BQ3o: lane 15 (k={Q3_K_OVERFLOW}) overflowed and recorded a second variant "
        f"(width {variants.plans[0].width} vs {q3.width}); lanes 0-14 kept their rows from the group"
    )
    return max(c.peak_bytes for c in done)


def compare_group_routes(torch, K, plan, host, cell, card, reps: int = 20):
    """The group replay of ``plan`` captured anew on each route, the lane
    axis then lane after lane, on the parameter stack ``host`` (numpy [B,
    P]): each capture's peak device bytes above what was allocated before
    it (the eager warm-up run included), its launches, graph nodes, and
    its device ms a replay (CUDA events over ``reps`` replays), side by
    side; both routes' meta rows and pages must agree. The plan keeps its
    own groups and route; these launches are not counted."""
    counted = dict(K.LAUNCHES)
    saved = plan.groups, plan.lane_axis
    B = host.shape[0]
    outs, line = {}, []
    try:
        for route in (True, False):
            plan.groups, plan.lane_axis = {}, route
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            g = plan._group_replay(B, host)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            g.graph.replay()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                g.graph.replay()
            end.record()
            torch.cuda.synchronize()
            outs[route] = {k: v.clone() for k, v in g.out.items()}
            line.append(
                f"{'lane axis' if route else 'lane after lane'} {start.elapsed_time(end) / reps:.4f} ms a replay, "
                f"{sum(g.launches.values())} launches, {g.nodes} graph nodes, capture peak {peak} bytes"
            )
            del g
    finally:
        plan.groups, plan.lane_axis = saved
        K.LAUNCHES.update(counted)
    meta = outs[True].get("meta", outs[True].get("direct"))
    _require(torch.equal(meta, outs[False].get("meta", outs[False].get("direct"))), f"{cell}: routes' meta rows differ")
    if "data" in outs[True]:
        for b in range(B):
            n = int(meta[b, 0])
            _require(torch.equal(outs[True]["data"][b, :n], outs[False]["data"][b, :n]), f"{cell}: lane {b} differs")
    print(f"group replay {cell} ({B} lanes), same run: {'; '.join(line)} [{card}]")


def check_group_page(torch, K, ks, stack, plan, ks3, q3_big):
    """K14 against its plain version at BQ3's lane stack (16 lanes of Q3's
    [W, 3] front-packs) at the page BQ3 elects, in int32 and int16, and at
    edge cases (B < Bb, B = 1, n = W, n·C not a multiple of 4 or 8, C = 1,
    one row, an empty page, a lane stride that breaks 16-byte alignment),
    exactly; then its time at BQ3's page (int32: Q3's uids
    pass 32767) beside its bound and the library's slice copy, and the
    int16 page and the full stack; its own launches are not counted."""
    counted = dict(K.LAUNCHES)  # these launches compare and time: not the main path's
    Bb, W, C = (int(x) for x in stack.shape)
    need = int(max(_below(q3_big, k).shape[0] for k in ks3))
    n = plan._page_round(W, need)
    one_col = stack[:, :, :1].contiguous()
    one_row = stack[:, :1].contiguous()
    # W - 1 rows of 3 columns: a lane stride that breaks the source's
    # 16-byte alignment, so each lane starts at its own offset; at the
    # elected page n the output's lanes stay aligned and the sources are
    # read with 4-byte loads, at n - 1 both shift alike
    odd = stack[:, : W - 1].contiguous()
    for f16 in (False, True):
        for st, B, m in ((stack, Bb, n), (stack, 11, n), (stack, Bb, W), (stack, 3, 5), (stack, Bb, 1),
                         (one_col, Bb, n), (one_col, 5, 7), (one_row, Bb, 1), (stack, 0, 0),
                         (odd, Bb, n), (odd, Bb, n - 1), (odd, 1, n - 3), (stack, 1, n), (stack, Bb, n - 3)):
            ks.same("group_page", K.group_page(st, B, m, f16), K.plain_group_page(st, B, m, f16))
    torch.cuda.synchronize()
    ks.timed(
        "group_page",
        lambda: K.group_page(stack, Bb, n, False),
        lambda: K.plain_group_page(stack, Bb, n, False),
        lambda: stack[:Bb, :n].clone(),
        8.0 * Bb * n * C,
    )
    ms16 = _time_ms(torch, lambda: K.group_page(stack, Bb, n, True))
    lib16 = _time_ms(torch, lambda: stack[:Bb, :n].to(torch.int16))
    bound16 = 6.0 * Bb * n * C / HBM_BYTES_PER_S * 1e3
    ms_w = _time_ms(torch, lambda: K.group_page(stack, Bb, W, False))
    for m in (n, n - 1):
        print(
            f"kernel group_page (unaligned: stride {(W - 1) * C} values, run {m * C}): "
            f"{_time_ms(torch, lambda: K.group_page(odd, Bb, m, False)):.4f} ms, "
            f"{_graph_ms(torch, lambda: K.group_page(odd, Bb, m, False), 200):.4f} in a graph "
            f"(library .clone() {_graph_ms(torch, lambda: odd[:Bb, :m].clone(), 200):.4f}); int16 "
            f"{_graph_ms(torch, lambda: K.group_page(odd, Bb, m, True), 200):.4f} in a graph"
        )
    print(
        f"kernel group_page: equals its plain version at BQ3's stack [{Bb}, {W}, {C}], elected page "
        f"n={n} (largest lane {need} rows); int16 at that page {ms16:.4f} ms (library .to(int16) "
        f"{lib16:.4f} ms, bound {bound16:.4f} ms); int32 full stack n=W {ms_w:.4f} ms; in a captured "
        f"graph (200 replays), int32 at the page {_graph_ms(torch, lambda: K.group_page(stack, Bb, n, False), 200):.4f} ms "
        f"(library .clone() {_graph_ms(torch, lambda: stack[:Bb, :n].clone(), 200):.4f} ms), int16 "
        f"{_graph_ms(torch, lambda: K.group_page(stack, Bb, n, True), 200):.4f} ms"
    )
    K.LAUNCHES.update(counted)


def lane_calls(torch, K, plan, stack, forms=None, at_call=None):
    """One eager run of ``plan``'s group body on the lane axis over the
    parameter stack ``stack``, recording each lane form's arguments (the
    shapes the main path gives it) in call order (`take_pad`'s only with a
    lane-stacked table: its lane stride; K13's without the counts it adds
    into; of ``forms`` only, when given). The operands of `LANE_COPIES` are
    kept as copies taken before the call, for a form's first
    `BITMAP_LANE_CALLS` calls. With ``at_call``, each call's arguments go
    to ``at_call(name, a, kw)`` before the call instead, and nothing is
    kept. Its launches are not counted."""
    counted = dict(K.LAUNCHES)
    calls = []
    kept = dict.fromkeys(LANE_COPIES, 0)
    orig = {name: getattr(K, name) for name in LANE_FORMS}

    def spy(name):
        @functools.wraps(orig[name])  # `_named` reads the wrapper's signature
        def call(*a, **kw):
            args = (a[:3], {}) if name == "rows_with_matches_lanes" else (a, kw)
            if forms is not None and name not in forms or name == "take_pad" and a[0].dim() != 2:
                pass
            elif at_call is not None:
                at_call(name, *args)
            elif name not in LANE_COPIES:
                calls.append((name, *args))
            elif kept[name] < BITMAP_LANE_CALLS:
                kept[name] += 1
                calls.append((name, _copied(name, a), dict(kw)))
            return orig[name](*a, **kw)

        return call

    for name in LANE_FORMS:
        setattr(K, name, spy(name))
    try:
        plan._run_group(stack, plan._group_outputs(stack.shape[0]))
    finally:
        for name, fn in orig.items():
            setattr(K, name, fn)
    if stack.is_cuda:
        torch.cuda.synchronize()
    K.LAUNCHES.update(counted)
    return calls


def _copied(name, a):
    """``a`` with the operands of `LANE_COPIES` cloned."""
    a = list(a)
    for i in LANE_COPIES.get(name, ()):
        if i < len(a) and a[i] is not None:
            a[i] = a[i].clone()
    return tuple(a)


def _named(K, name, a, kw) -> dict:
    """A lane form's arguments by parameter name, defaults filled in."""
    bound = inspect.signature(getattr(K, name)).bind(*a, **kw)
    bound.apply_defaults()
    return dict(bound.arguments)


def _row(t, b):
    """Lane ``b``'s row of a [B, vb] gate or node mask, or the shared one."""
    return t if t is None or t.dim() == 1 else t[b]


def _lane_run(K, name, a, kw):
    """A lane form's call on fresh copies of the operands it writes in
    place (`LANE_COPIES`); K12's result is ``(nxt, visited, alive[,
    emitted])``."""
    a = _copied(name, a)
    got = getattr(K, name)(*a, **kw)
    if name == "frontier_advance_lanes":
        return (a[0], a[1], *(got if isinstance(got, tuple) else (got,)))
    return got


def _lane_plain(K, name, a, kw):
    """A lane form's call through its plain version (an ``out`` dropped;
    K10's ``out`` ORed in, as the kernel does; in-place operands copied)."""
    if name == "bitmap_hop_csr_lanes":
        n = _named(K, name, a, kw)
        out = n.pop("out")
        hop = K.plain_bitmap_hop_csr_lanes(**n)
        return hop if out is None else out | hop
    if name == "frontier_advance_lanes":
        a = _copied(name, a)
        got = K.plain_frontier_advance_lanes(*a, **kw)
        return (a[0], a[1], *(got if isinstance(got, tuple) else (got,)))
    if name == "take_pad":
        return K.plain_take_pad_lanes(*a, **kw)
    if name in ("front_pack_lanes", "replay_meta_lanes"):
        return getattr(K, "plain_" + name)(*a[: 2 if name == "front_pack_lanes" else 3])
    return getattr(K, "plain_" + name)(*a, **kw)


def _lane_of(got, b):
    """Lane ``b`` of a lane form's result (each tensor of a tuple)."""
    return tuple(None if g is None else g[b] for g in got) if isinstance(got, tuple) else got[b]


def _lane_equal(torch, got, single) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    single = single if isinstance(single, tuple) else (single,)
    return len(got) == len(single) and all(
        (g is None and w is None) or (g is not None and w is not None and torch.equal(g, w))
        for g, w in zip(got, single)
    )


def _lane_single(K, name, a, kw, b, copy: bool = True):
    """Lane ``b`` of a lane form's call as the single-lane wrapper's call
    (on copies of the rows K10 ORs into and K12 steps; with ``copy`` False
    the rows themselves, for timing)."""
    if name in BITMAP_LANE_FORMS:
        n = _named(K, name, a, kw)
        rows = lambda t: None if t is None else (t[b].clone() if copy else t[b])  # noqa: E731
        if name == "bitmap_hop_csr_lanes":
            alive = n["alive"]
            return K.bitmap_hop_csr(
                n["indptr"], n["nbr"], n["eid"], n["edge_mask"], n["frontier"][b], _row(n["gate"], b),
                None if alive is None else alive[b], rows(n["out"]),
            )
        bound = None if n["bound"] is None else n["bound"][b]
        if name == "bitmap_emit_lanes":
            return K.bitmap_emit(n["reached"][b], _row(n["node"], b), bound, n["emit"], n["any_row"], n["count"])
        nxt, vis = rows(n["nxt"]), rows(n["visited"])
        got = K.frontier_advance(nxt, vis, _row(n["gate"], b), _row(n["node"], b), bound)
        return (nxt, vis, *(got if isinstance(got, tuple) else (got,)))
    if name == "value_cumsum_lanes":
        return K.value_cumsum(a[0][b])
    if name == "compact_indices_lanes":
        mask, out_size = a
        return K.compact_indices(mask[b], out_size)
    if name == "expand_offsets_lanes":
        indptr, srcs = a
        return K.expand_offsets(indptr, srcs[b])
    if name == "gather_expand_lanes":
        indptr, nbrs, srcs, offsets, total, out_size, *emap = a
        return K.gather_expand(indptr, nbrs, srcs[b], offsets[b], total[b], out_size, *emap, **kw)
    if name == "take_pad":
        values, idx, fill = a
        return K.take_pad(values[b], idx[b], fill)
    if name == "front_pack_lanes":
        valid, cols = a[:2]
        return K.front_pack(valid[b], [c[b] for c in cols])
    if name == "replay_meta_lanes":
        data, count, overflow = a[:3]
        return K.replay_meta(data[b], count[b], overflow[b])
    if name == "predicate_eval_lanes":
        prog, bufs, ids, n, n_valid, base, depth, params = a
        return K.predicate_eval(prog, bufs, ids, n, n_valid, base, depth, params[b])
    if name == "predicate_eval_stacked":
        lane = lambda t: t[b] if t is not None and t.dim() == 2 else t  # noqa: E731
        prog, bufs, ids, n, n_valid, base, depth, params, values = a
        bufs = [lane(t) for t in bufs]
        return K.predicate_eval(prog, bufs, lane(ids), n, n_valid, base, depth, lane(params), values)
    if name == "rows_with_matches_lanes":
        rows, mask, nseg = a
        return K.rows_with_matches(rows[b], mask[b], nseg)
    if name == "weight_gather_lanes":
        lane = lambda t: t[b] if t is not None and t.dim() == 2 else t  # noqa: E731
        emit, dtype, *rest = a
        ops = dict(zip(("ok", "node_ok", "emask", "eid", "w"), rest), **kw)
        return K.weight_gather(emit, dtype, **{k: lane(v) if k != "eid" else v for k, v in ops.items()})
    if name == "indptr_segment_sum_lanes":
        vals, indptr, out_size = a
        return K.indptr_segment_sum(vals[b], indptr, out_size)
    return K.mask_count(a[0][b])


def _hop_lanes_bytes(torch, K, n) -> float:
    """The bytes K10's lane form must move for this call: a live lane
    (alive not 0) reads its C frontier rows once, 8 bytes of indptr an
    active vertex and 4 of nbr (+1 of mask, +4 of eid) an edge of an active
    vertex (`csr_hop_bytes` without its output and gate), and its gate row
    (a shared gate once); a dead lane reads nothing. The output: when this
    call zeroes it, every lane's rows written once; when it ORs into a
    given ``out``, only the 1s the hop stores (each (row, vertex) it
    reaches, a byte each; the kernel reads nothing of ``out``)."""
    fr, gate, alive, out = n["frontier"], n["gate"], n["alive"], n["out"]
    B, C, vb = fr.shape
    alive_h = None if alive is None else alive.cpu()
    live = [b for b in range(B) if alive_h is None or int(alive_h[b]) != 0]
    masked, eid = n["edge_mask"] is not None, n["eid"] is not None
    total = 0.0
    for b in live:
        g = _row(gate, b)
        nbytes, _act, _edges = csr_hop_bytes(torch, n["indptr"], fr[b], g, masked, eid)
        total += nbytes - C * vb - (vb if g is not None else 0.0)
    if gate is not None and live:
        total += vb * (len(live) if gate.dim() == 2 else 1)
    if out is None:
        return total + B * C * vb
    n = {k: v for k, v in n.items() if k != "out"}
    return total + int(K.plain_bitmap_hop_csr_lanes(**n).sum())


def _lane_bound(torch, name, a, kw):
    """(bytes, operations, random 32-byte sectors) of a lane form's call:
    each shared input once, each lane-stacked input and each output once; a
    gather of a table through emit or eid a sector an index (shared: once,
    lane-stacked: a lane); the bitmap forms' bytes a lane as their single
    forms' (`_hop_lanes_bytes`, `emit_bytes`, `level_step_bytes`)."""
    if name in BITMAP_LANE_FORMS:
        from orientdb_tpu_torch.ops import csr as K

        n = _named(K, name, a, kw)
        if name == "bitmap_hop_csr_lanes":
            return _hop_lanes_bytes(torch, K, n), 0.0, 0
        rows = lambda t, b: None if t is None else t[b]  # noqa: E731
        if name == "bitmap_emit_lanes":
            reached = n["reached"]
            return sum(
                emit_bytes(torch, reached[b], n["emit"], rows(n["bound"], b)) for b in range(reached.shape[0])
            ), 0.0, 0
        nxt = n["nxt"]
        return sum(
            level_step_bytes(torch, nxt[b], _row(n["gate"], b), _row(n["node"], b), rows(n["bound"], b))
            for b in range(nxt.shape[0])
        ), 0.0, 0
    if name == "predicate_eval_lanes":
        prog, bufs, ids, n, _nv, _b, _d, params = a
        B = params.shape[0]
        per_slot = sum(t.element_size() for t in bufs) + (4 if ids is not None else 0)
        dist = any(r[0] == 20 for r in prog.rows)  # PredOp.DIST
        return per_slot * n + B * n, (G1_SLOT_OPS * n * B if dist else 0.0), 0
    if name == "predicate_eval_stacked":
        # each lane's ids, lane-stacked buffers and outputs once; a shared
        # buffer (a column or table) at most once a live id, at most whole
        prog, bufs, ids, _n, _nv, _b, _d, params, values = a
        B, n = ids.shape
        live = int((ids >= 0).sum())
        nbytes = 4.0 * B * n + (1 + 4 * bool(values)) * B * n
        for t in bufs:
            nbytes += t.numel() * t.element_size() if t.dim() == 2 else min(t.numel(), live) * t.element_size()
        dist = any(r[0] == 20 for r in prog.rows)  # PredOp.DIST
        return nbytes, (G1_SLOT_OPS * live if dist else 0.0), live
    if name == "rows_with_matches_lanes":
        rows, _mask, nseg = a
        return 5.0 * rows.numel() + 4.0 * rows.shape[0] * nseg, 0.0, 0
    if name == "weight_gather_lanes":
        emit, _dtype, *rest = a
        ops = dict(zip(("ok", "node_ok", "emask", "eid", "w"), rest), **kw)
        m = ops["w"].shape[-1] if emit is None else emit.shape[0]
        B = max(t.shape[0] for t in ops.values() if t is not None and t.dim() == 2)
        nbytes = 4.0 * m * (emit is not None) + 4.0 * m * (ops.get("eid") is not None) + 4.0 * B * m
        sectors = 0
        for key in ("ok", "node_ok", "emask", "w"):
            t = ops.get(key)
            if t is None:
                continue
            nbytes += t.numel() * t.element_size()
            through = emit is not None and key in ("ok", "w") or key == "emask" and ops.get("eid") is not None
            if through:
                sectors += m * (t.shape[0] if t.dim() == 2 else 1)
        return nbytes, 0.0, sectors
    if name == "indptr_segment_sum_lanes":
        vals, indptr, out_size = a
        return 4.0 * vals.numel() + 4.0 * indptr.numel() + 4.0 * vals.shape[0] * out_size, 0.0, 0
    if name == "value_cumsum_lanes":
        return 8.0 * a[0].numel(), 0.0, 0
    if name == "compact_indices_lanes":
        mask, out_size = a
        return float(mask.numel()) + 4.0 * mask.shape[0] * out_size, 0.0, 0
    if name == "expand_offsets_lanes":
        # each source read, a live source's two indptr entries, each offset
        # and total written
        _indptr, srcs = a
        live = int((srcs >= 0).sum())
        return 8.0 * srcs.numel() + 8.0 * live + 4.0 * srcs.shape[0], 0.0, live
    if name == "gather_expand_lanes":
        # `expand_bounds`' gather a lane: 12 bytes a source, a neighbour (and
        # an edge-map entry) a live slot, 12 bytes a bucket slot written
        _ip, _nb, srcs, _off, total, size, *emap = a
        mapped = bool(emap and emap[0] is not None) or kw.get("edge_map") is not None
        live = int(total.clamp(0, size).sum())
        nbytes = 12.0 * srcs.numel() + (8.0 if mapped else 4.0) * live + 12.0 * srcs.shape[0] * size
        return nbytes, 0.0, live * (2 if mapped else 1)
    if name == "take_pad":
        values, idx, _fill = a
        live = int((idx >= 0).sum())
        elt = values.element_size()
        return 4.0 * idx.numel() + elt * idx.numel() + min(values.numel(), live) * elt, 0.0, live
    if name == "front_pack_lanes":
        valid, cols = a[:2]
        return 4.0 * valid.numel() * (1 + 2 * len(cols)), 0.0, 0
    if name == "replay_meta_lanes":
        data, count = a[:2]
        rows = int(count.clamp(0, data.shape[1]).sum())
        return 4.0 * rows * data.shape[2] + 12.0 * data.shape[0], 0.0, 0
    mask = a[0]
    return float(mask.numel()) + 4.0 * mask.shape[0], 0.0, 0


def _lane_library(torch, name, a):
    """The one PyTorch call that computes a lane form's function on the same
    inputs, as the single rows' yardsticks do (`torch.cumsum`, `torch.gather`
    on the clamped lane-local index, `torch.nonzero`, `torch.count_nonzero`,
    `torch.segment_reduce` along the lanes' edges, `Tensor.scatter_add_` of
    K13's counts; K10's hop as `torch.sparse.mm` of the walk's transposed
    adjacency and the [vb, B·C] float frontier, counts, not bits, as K10's
    single row; K11's and K12's counts as one `torch.count_nonzero` a lane),
    or None where no single call computes it (K2's sizing, K2b's merge
    path, K6, K7, K15's lane and stacked forms, K5a)."""
    if name == "bitmap_hop_csr_lanes":
        indptr, nbr, _eid, _m, fr = a[:5]
        vb = fr.shape[-1]
        try:
            nv = indptr.shape[0] - 1
            act = torch.repeat_interleave(torch.arange(nv, device=fr.device), (indptr[1:] - indptr[:-1]).long())
            reach = nbr[indptr[0].long() : indptr[0].long() + act.shape[0]].long().clamp(0, vb - 1)
            mt = torch.sparse_coo_tensor(
                torch.stack([reach, act]), torch.ones(act.shape[0], device=fr.device), (vb, vb)
            ).to_sparse_csr()
            fr_t = fr.view(-1, vb).t().float().contiguous()
        except (RuntimeError, TypeError) as e:
            print(f"library call for {name} refused: {e}")
            return None
        return lambda: torch.sparse.mm(mt, fr_t)
    if name in ("bitmap_emit_lanes", "frontier_advance_lanes"):
        flat = a[0].view(a[0].shape[0], -1)
        return lambda: torch.count_nonzero(flat, 1)
    if name == "value_cumsum_lanes":
        vals = a[0]
        return lambda: torch.cumsum(vals, 1, dtype=vals.dtype)
    if name == "take_pad":
        values, idx, _fill = a
        ix = idx.clamp(0, max(values.shape[1] - 1, 0)).long()
        return lambda: torch.gather(values, 1, ix)
    if name == "compact_indices_lanes":
        mask = a[0]
        return lambda: torch.nonzero(mask)
    if name == "mask_count_lanes":
        mask = a[0]
        return lambda: torch.count_nonzero(mask, dim=1)
    if name == "indptr_segment_sum_lanes":
        vals, indptr, _out_size = a
        offsets = indptr.expand(vals.shape[0], -1).contiguous()
        return lambda: torch.segment_reduce(vals, "sum", offsets=offsets, axis=1)
    if name == "rows_with_matches_lanes":
        # `scatter_add_` along the lanes' rows of the clamped, masked rows
        rows, mask, nseg = a
        ok = mask & (rows >= 0) & (rows < nseg)
        idx = torch.where(ok, rows, 0).long()
        src = ok.to(torch.int32)
        shape = (rows.shape[0], nseg)
        return lambda: torch.zeros(shape, dtype=torch.int32, device=rows.device).scatter_add_(1, idx, src)
    return None


def check_lane_kernels(np, torch, K, ks, plan, stack, cell, card, band_of=None, forms=None):
    """The lane forms at ``cell``'s shapes (BE1's, BG1's, BQ3's, BV1's,
    BV2's or BV3's lanes; ``forms`` the wrappers to hold, default all): each
    call of one eager run of the plan's lane-axis group body (`lane_calls`;
    a bitmap lane form's first calls, on copies of the bitmaps it writes)
    held against its plain version (int32 and bool exactly; a distance()
    mask outside the boundary band, ``band_of(lane, slots)``), which decides
    correctness, and, lane by lane, against the single-lane wrapper exactly
    (for K1, K2, K2b, K3, K6, K7, K10, K11 and K12 that is the same kernel at
    one lane: it checks only the lane offsets); each form's largest call
    timed eager and in a captured graph beside its bound (bytes, or a
    distance() mask's operations), its library call and B single-lane
    launches (K12's on fresh copies of its bitmaps a call); then the
    group's captured replay timed (device ms a replay of all its lanes).
    Returns the lane forms' rows; their launches are not counted."""
    counted = dict(K.LAUNCHES)
    calls = lane_calls(torch, K, plan, stack, forms=forms)
    _require(calls, f"{cell}: the group body ran no lane form")
    _require(forms is None or {c[0] for c in calls} == set(forms), f"{cell}: lane forms {forms} did not all run")
    B = stack.shape[0]
    largest = {}
    for name, a, kw in calls:
        got = _lane_run(K, name, a, kw)
        want = _lane_plain(K, name, a, kw)
        kname = LANE_FORMS[name]
        singles = [_lane_single(K, name, a, kw, b) for b in range(B)]
        _require(
            all(_lane_equal(torch, _lane_of(got, b), singles[b]) for b in range(B)),
            f"{cell}: {name} differs from the single-lane kernel lane by lane",
        )
        if band_of is not None and name == "predicate_eval_lanes":
            _require(got.shape == want.shape and got.dtype == want.dtype, f"{cell}: {name} shape/dtype")
            for b in range(B):
                slots = torch.nonzero(got[b] != want[b]).flatten().cpu().numpy()
                _require(bool(band_of(b, slots).all()), f"{cell}: {name} lane {b} differs outside the band")
        elif isinstance(got, tuple):
            _require(all((g is None) == (w is None) for g, w in zip(got, want)), f"{cell}: {name} outputs")
            ks.same(kname, tuple(g for g in got if g is not None), tuple(w for w in want if w is not None))
        else:
            ks.same(kname, got, want)
        if name == "rows_with_matches_lanes":
            # with ``out`` the counts add into each lane's row
            acc = torch.ones_like(want)
            _require(torch.equal(K.rows_with_matches_lanes(*a, out=acc), want + 1), f"{cell}: {name} with out")
        size = next(g for g in (got if isinstance(got, tuple) else (got,)) if g is not None).numel()
        if size >= largest.get(name, (0,))[0]:
            largest[name] = (size, a, kw)
        del got, want, singles
    rows = {}
    for name, (_size, a, kw) in largest.items():
        kname = LANE_FORMS[name]
        nbytes, ops, sectors = _lane_bound(torch, name, a, kw)
        if name == "frontier_advance_lanes":
            row = _time_level_step_lanes(torch, K, ks, kname, a, kw, nbytes)
        else:
            kernel = lambda n=name, a=a, kw=kw: getattr(K, n)(*a, **kw)  # noqa: E731
            plain = lambda n=name, a=a, kw=kw: _lane_plain(K, n, a, kw)  # noqa: E731
            singles = lambda n=name, a=a, kw=kw: [_lane_single(K, n, a, kw, b, copy=False) for b in range(B)]  # noqa: E731
            ks.timed(kname, kernel, plain, _lane_library(torch, name, a), nbytes, ops)
            row = dict(ks.rows[kname])
            row["graph_ms"] = _graph_ms(torch, kernel)
            row["singles_ms"] = _time_ms(torch, singles)
            row["singles_graph_ms"] = _graph_ms(torch, singles)
        rows[kname] = row
        shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor)]
        if name == "front_pack_lanes":
            shapes += [f"{len(a[1])} columns"]
        print(
            f"kernel {kname} at {cell}'s shape {shapes}: {row['ms']:.4f} ms eager, {row['graph_ms']:.4f} in a "
            f"graph; {B} single-lane launches {row['singles_ms']:.4f} / {row['singles_graph_ms']:.4f}; plain "
            f"{row['plain_ms']:.4f}; library {row['library_ms']}; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
            f"{nbytes:.0f} bytes); random 32-byte sectors {sectors} [{card}]"
        )
    g = plan.groups[B]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    g.graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        g.graph.replay()
    end.record()
    torch.cuda.synchronize()
    # the group's own bound: every lane-form call of one replay at its bytes
    # (each at 3.35 TB/s; K15's shared masks over flattened ids not counted),
    # each call's bytes counted before it runs
    group_bytes = dict.fromkeys(LANE_FORMS, 0.0)

    def add(n, a, kw):
        group_bytes[n] += _lane_bound(torch, n, a, kw)[0]

    lane_calls(torch, K, plan, stack, at_call=add)
    total = sum(group_bytes.values())
    parts = ", ".join(f"{n} {v:.0f}" for n, v in group_bytes.items() if v)
    print(
        f"group replay {cell}: lane axis {plan.lane_axis}, {B} lanes, {start.elapsed_time(end) / 10:.4f} ms a "
        f"replay, {sum(g.launches.values())} launches {g.launches}, {g.nodes} graph nodes, capture "
        f"{g.capture_ms:.1f} ms, reserved after the capture {g.reserved_bytes} bytes; its lane-form calls' "
        f"bound {total / HBM_BYTES_PER_S * 1e3:.4f} ms ({total:.0f} bytes: {parts}) [{card}]"
    )
    K.LAUNCHES.update(counted)
    return rows


def _time_level_step_lanes(torch, K, ks, kname, a, kw, nbytes: float) -> dict:
    """K12's lane form timed as its single form is (`time_level_steps`):
    each call on fresh copies of its two bitmaps, eager and in a graph, its
    plain version and B single-lane launches the same way, beside its bound
    and one `torch.count_nonzero` a lane; sets its kernel row."""
    nxt, vis, *rest = a
    name = "frontier_advance_lanes"
    step = lambda n, v: K.frontier_advance_lanes(n, v, *rest, **kw)  # noqa: E731
    pstep = lambda n, v: K.plain_frontier_advance_lanes(n, v, *rest, **kw)  # noqa: E731
    singles = lambda n, v: [_lane_single(K, name, (n, v, *rest), kw, b, copy=False) for b in range(n.shape[0])]  # noqa: E731
    ks.rows[kname] = {
        "name": kname,
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES[kname],
        "ms": _fresh_ms(torch, step, (nxt, vis), reps=3),
        "plain_ms": _fresh_ms(torch, pstep, (nxt, vis), reps=3),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": _library_ms(torch, kname, _lane_library(torch, name, a)),
    }
    row = dict(ks.rows[kname])
    row["graph_ms"] = _fresh_ms(torch, step, (nxt, vis), reps=3, graph=True)
    row["singles_ms"] = _fresh_ms(torch, singles, (nxt, vis), reps=3)
    row["singles_graph_ms"] = _fresh_ms(torch, singles, (nxt, vis), reps=3, graph=True)
    return row


def run_batches_snb(np, torch, K, ks, db, snap, card):
    """Phase 7b: the batch cells on the SNB-shape graph, the plan cache
    cleared first; BE1's lane forms against their plain versions
    (`check_lane_kernels`). BE2 and BE5 must run on the lane axis: K15's
    stacked form (BE2's edge WHERE, BE5's closing arm) and K13's lane form
    (BE5's OPTIONAL arm) are held at their shapes (BE5's first, so that the
    JSON row of K15's stacked form is BE2's larger call), and each group is
    captured anew on both routes (`compare_group_routes`). Returns the peak
    device bytes allocated."""
    from orientdb_tpu_torch.exec import tpu_engine as TE

    TE._plan_cache(snap).clear()
    ds = [12_000 + (i * 211) % 8_000 for i in range(64)]
    t0 = time.perf_counter()
    counts = numpy_config5_counts(snap, ds)
    ns2 = [10_000 + 625 * i for i in range(16)]
    ns5 = [1_000 + 125 * i for i in range(8)]
    young = snap.v_columns["age"].values < 30
    e2_all = numpy_out_edge_rows(snap, max(ns2), 15_000, young)
    e5_all = numpy_probe_rows(snap, max(ns5), 15_000)
    print(f"numpy references of BE1, BE2, BE5: {time.perf_counter() - t0:.1f} s")

    def e1_check(i, rows):
        _require(rows == [{"n": counts[i]}], f"BE1 item {i}: {rows} != numpy {counts[i]}")

    cells = (
        BatchCell("BE1", [E1] * 64, [{"d": d} for d in ds], e1_check, "group", warm=[(E1, {"d": min(ds)})]),
        BatchCell("BE2", [E2] * 16, [{"n": n, "d": 15_000} for n in ns2],
                  _rows_check(np, "BE2", lambda i: _below(e2_all, ns2[i]), ("p", "f", "cd")), "group",
                  warm=[(E2, {"n": max(ns2), "d": 15_000})]),
        BatchCell("BE5", [E5] * 8, [{"n": n, "d": 15_000} for n in ns5],
                  _rows_check(np, "BE5", lambda i: _below(e5_all, ns5[i]), ("p", "f", "probe")), "group",
                  warm=[(E5, {"n": max(ns5), "d": 15_000})]),
    )
    plans = {}
    for cell in cells:
        ((plan, _dr, dg),) = run_batch_cell(torch, K, TE, db, snap, card, cell)
        plans[cell.name] = plan
        if cell.name == "BE1":
            _require(
                plan.count_name is not None and plan._group_lane_cap() == 16 and dg == 4 and plan.lane_axis,
                f"BE1: not a count group of 16 lanes in 4 chunks on the lane axis ({dg} chunks)",
            )
            check_lane_kernels(np, torch, K, ks, plan, plan.groups[16].stack.clone(), "BE1", card)
            continue
        B = len(cell.sqls)
        print(
            f"batch {cell.name}: batchable {plan.batchable()}, rows group {plan._rows_grouped()}, "
            f"lane axis {plan.lane_axis}"
        )
        _require(plan._rows_grouped() and B in plan.groups, f"{cell.name} is not a rows group of {B} lanes")
        _require(plan.lane_axis, f"{cell.name} did not run on the lane axis")
        launched = plan.groups[B].launches
        want = ["predicate_eval_stacked"] + (["rows_with_matches_lanes"] if cell.name == "BE5" else [])
        missing = [n for n in want if not launched.get(n)]
        _require(db.device.type != "cuda" or not missing, f"{cell.name}: {missing} not in the group replay")
    for name, forms in (("BE5", ARM_LANE_FORMS), ("BE2", ["predicate_eval_stacked"])):
        plan = plans[name]
        B = max(plan.groups)
        stack = plan.groups[B].stack.clone()
        check_lane_kernels(np, torch, K, ks, plan, stack, name, card, forms=forms)
        compare_group_routes(torch, K, plan, stack.cpu().numpy(), name, card)
    return max(c.peak_bytes for c in cells)


# ---------------------------------------------------------------------------
# phase 8: delta maintenance on configuration A
# ---------------------------------------------------------------------------

#: the delta cells: a 1-hop COUNT over bounded roots (the pushdown before
#: the writes, the full solve with a K18 probe after them), Q3, V1, BQ3
D1 = (
    "MATCH {class:Person, as:p, where:(uid < :k)}-knows->{as:f, where:(age > 40)} "
    "RETURN count(*) AS n"
)
D1_K = 100_000
D_SPARE_VERTICES, D_SPARE_EDGES = 65_536, 1_048_576
K17_LAUNCHES = 8  # a window scan: the histogram, four radix passes, the runs, the degree scan, the gather
W_PERSONS, W_EXTRA_EDGES, W_UPDATES, W_DEL_EDGES, W_DEL_PERSONS, W_FANOUT = 16_384, 98_304, 16_384, 4_096, 256, 16


class DeltaWriter:
    """Seeded write batches over a Person–knows graph, as the reference's
    changefeed events (``op``, ``rid``, ``class``, ``record``). A vertex's
    RID position is its dense index (a new person's too: it lands in the
    next vertex slab row), and so is its ``uid``; an edge's RID position is
    its creation count."""

    def __init__(self, np, db, snap, seed: int):
        self.np, self.snap = np, snap
        self.rng = np.random.default_rng(seed)
        self.pc = db.schema.get_class("Person").cluster_ids[0]
        self.kc = db.schema.get_class("knows").cluster_ids[0]
        self.base = snap._overlay.base_vertices
        self.next_v = self.base
        self.edges = []  # RIDs of the edges made, in order
        self.dead = set()  # the persons deleted

    def _person_record(self, i: int, age: int):
        rec = {"uid": int(i), "age": int(age)}
        for c in ("lat", "lng"):
            col = self.snap.v_columns.get(c)
            if col is not None and i < col.values.shape[0] and bool(col.present[i]):
                rec[c] = float(col.values[i])
        return rec

    def person(self):
        i = self.next_v
        self.next_v += 1
        age = int(self.rng.integers(18, 80))
        return i, {"op": "create", "rid": f"#{self.pc}:{i}", "class": "Person", "record": {"uid": i, "age": age}}

    def edge(self, s: int, d: int):
        rid = f"#{self.kc}:{len(self.edges)}"
        self.edges.append(rid)
        return {
            "op": "create", "rid": rid, "class": "knows",
            "record": {"@out": f"#{self.pc}:{s}", "@in": f"#{self.pc}:{d}"},
        }

    def w1(self, persons: int, extra: int):
        """New persons, each with one out and one in edge to a random base
        person, and edges between random base persons."""
        ev = []
        for _ in range(persons):
            i, e = self.person()
            ev.append(e)
            a, b = (int(x) for x in self.rng.integers(0, self.base, 2))
            ev += [self.edge(i, a), self.edge(b, i)]
        for s, d in self.rng.integers(0, self.base, (extra, 2)).tolist():
            ev.append(self.edge(s, d))
        return ev

    def w2(self, n: int):
        """Age updates on distinct random base persons (DATA only): each
        record carries every columnar field, as a changefeed's does."""
        ids = self.rng.choice(self.base, n, replace=False)
        return [
            {"op": "update", "rid": f"#{self.pc}:{int(i)}", "class": "Person",
             "record": self._person_record(int(i), int(self.rng.integers(18, 80)))}
            for i in ids
        ]

    def w3(self, edges: int, persons: int, low_uid: int):
        """Deletes: slab edges by RID, then base persons (a sixteenth of
        them under ``low_uid``, inside the cells' roots), with the
        cascade."""
        picks = self.rng.choice(len(self.edges), edges, replace=False)
        ev = [{"op": "delete", "rid": self.edges[int(j)]} for j in picks]
        low = self.rng.choice(low_uid, persons // 16, replace=False)
        high = self.rng.integers(low_uid, self.base, persons - low.shape[0])
        self.dead = set(low.tolist()) | set(high.tolist())
        for i in sorted(self.dead):
            ev.append({"op": "delete", "rid": f"#{self.pc}:{int(i)}", "class": "Person"})
        return ev

    def w4(self, src: int, n: int):
        """``n`` edges out of one person to live base persons: its out
        bucket overflows."""
        ev = []
        for d in self.rng.integers(0, self.base, n).tolist():
            while d in self.dead:
                d = int(self.rng.integers(0, self.base))
            ev.append(self.edge(src, d))
        return ev


class DRef:
    """numpy answers of the delta cells, kept apart from the maintainer
    under test: the base graph as copied before arming, and the write
    batches' events read by their plain meaning (a created person or edge
    exists, an update sets ``age``, a deleted person takes every edge at
    either end with it)."""

    def __init__(self, np, db, snap):
        self.np = np
        self.pc = db.schema.get_class("Person").cluster_ids[0]
        csr = snap.edge_classes["knows"]
        n = snap.num_vertices
        cap = n + D_SPARE_VERTICES
        ip = csr.indptr_out.astype(np.int64)
        self.ip = np.concatenate([ip, np.full(cap - n, ip[-1])])  # new persons: no base edges
        self.dst = csr.dst.copy()
        self.alive = np.zeros(cap, bool)
        self.alive[:n] = snap.v_class >= 0
        self.person = np.zeros(cap, bool)
        self.person[:n] = snap.v_class == snap.class_id_of["person"]
        self.age = np.zeros(cap, np.int64)
        self.age[:n] = snap.v_columns["age"].values
        self.uid = np.zeros(cap, np.int64)
        self.uid[:n] = snap.v_columns["uid"].values
        self.made = {}  # edge RID -> (out, in) positions, of the edges the batches made
        self.refresh()

    def apply(self, events):
        def pos(rid):
            c, p = rid.lstrip("#").split(":")
            return int(c), int(p)

        for ev in events:
            c, p = pos(ev["rid"])
            if ev["op"] == "delete":
                if c == self.pc:
                    self.alive[p] = False
                else:
                    del self.made[ev["rid"]]
            elif c == self.pc:
                rec = ev["record"]
                self.alive[p] = self.person[p] = True
                self.uid[p], self.age[p] = rec["uid"], rec["age"]
            else:
                rec = ev["record"]
                self.made[ev["rid"]] = (pos(rec["@out"])[1], pos(rec["@in"])[1])

    def refresh(self):
        """Index the live made edges by their source."""
        np = self.np
        e = np.array(list(self.made.values()), np.int64).reshape(-1, 2)
        e = e[self.alive[e[:, 0]] & self.alive[e[:, 1]]]
        order = np.argsort(e[:, 0], kind="stable")
        self.s_src, self.s_dst = e[order, 0], e[order, 1]

    def out(self, srcs):
        """(index into ``srcs``, neighbour) of every live out edge."""
        np = self.np
        deg = self.ip[srcs + 1] - self.ip[srcs]
        i = np.repeat(np.arange(srcs.shape[0]), deg)
        pos = np.repeat(self.ip[srcs] - (np.cumsum(deg) - deg), deg) + np.arange(int(deg.sum()))
        nb = self.dst[pos].astype(np.int64)
        keep = self.alive[srcs[i]] & self.alive[nb]
        lo = np.searchsorted(self.s_src, srcs, "left")
        cnt = np.searchsorted(self.s_src, srcs, "right") - lo
        i2 = np.repeat(np.arange(srcs.shape[0]), cnt)
        pos2 = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + np.arange(int(cnt.sum()))
        return np.concatenate([i[keep], i2]), np.concatenate([nb[keep], self.s_dst[pos2]])

    def roots(self, k: int):
        return self.np.flatnonzero(self.alive & self.person & (self.uid < k)).astype(self.np.int64)

    def d1(self, k: int) -> int:
        _i, f = self.out(self.roots(k))
        return int((self.alive[f] & (self.age[f] > 40)).sum())

    def q3(self, k: int):
        np = self.np
        r = self.roots(k)
        i, f = self.out(r)
        j, g = self.out(f)
        keep = self.alive[g] & (self.age[g] < 30)
        rows = np.stack([self.uid[r[i[j]]], self.uid[f[j]], self.uid[g]], 1)[keep].astype(np.int64)
        return rows[np.lexsort(rows.T[::-1])]

    def direct(self, k: int):
        np = self.np
        r = self.roots(k)
        i, f = self.out(r)
        rows = np.stack([self.uid[r[i]], self.uid[f]], 1).astype(np.int64)
        return rows[np.lexsort(rows.T[::-1])]

    def v1(self) -> int:
        np = self.np
        n = 0
        for r in self.roots(200):
            frontier = np.array([r], np.int64)
            seen = frontier
            for depth in range(4):
                n += int((self.alive[frontier] & (self.age[frontier] < 30)).sum())
                if depth == 3:
                    break
                _i, nb = self.out(frontier)
                frontier = np.setdiff1d(np.unique(nb), seen)
                seen = np.union1d(seen, frontier)
        return n


def _delta_cells(np, dref):
    """cell → (sql, params, check of the rows)."""
    def count_is(want):
        return lambda rows: _require(rows == [{"n": want()}], f"count {rows} != numpy {want()}")

    def rows_are(want, names):
        return lambda rows: _require(
            np.array_equal(_sorted_rows(np, rows, names), want()), "rows differ from numpy"
        )

    return {
        "D1": (D1, {"k": D1_K}, count_is(lambda: dref.d1(D1_K))),
        "Q3": (Q3, {"k": Q3_K}, rows_are(lambda: dref.q3(Q3_K), ("p", "f", "g"))),
        "V1": (V1, {}, count_is(dref.v1)),
    }


def run_deltas(np, torch, K, TE, ks, db, snap, card):
    """Phase 8: delta maintenance on configuration A, padded before its
    upload. Records D1, Q3, V1 and BQ3, then applies W1–W4 through
    `apply_batch`, each cell after each batch held against numpy over the
    live arrays. Returns the kernels' launches over the phase."""
    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.storage.deltas import arm_delta_maintenance

    sync = torch.cuda.synchronize
    dref = DRef(np, db, snap)
    t0 = time.perf_counter()
    m = arm_delta_maintenance(db, D_SPARE_VERTICES, D_SPARE_EDGES)
    ov = snap._overlay
    dg = device_graph(snap, db.device)
    sync()
    vb = K.bucket(snap.num_vertices)
    _require(vb == K.bucket(ov.base_vertices), f"padding to {snap.num_vertices} vertices grew vb to {vb}")
    mem = dg.memory_report()
    slab_bytes = sum(
        a.numel() * a.element_size() for k, a in dg.arrays.items() if k.startswith("bk:") or k.endswith(":live")
    )
    print(
        f"delta: A padded to V_cap={snap.num_vertices} E_cap={snap.edge_classes['knows'].num_edges} "
        f"(NB={ov.bk_nb}, BK={ov.bk_bk}), uploaded in {time.perf_counter() - t0:.1f} s; resident "
        f"{mem['total_bytes']} bytes, of them live mask + bucket tables {slab_bytes} bytes"
    )
    cells = _delta_cells(np, dref)
    ks3 = [Q3_K // 2 + Q3_K // 32 * i for i in range(16)]  # 1000 + 62·i, as BQ3

    def bq3():
        """BQ3 (Q3 × 16 through query_batch, rows built); returns its ms
        (the check against numpy after it is not timed)."""
        t = time.perf_counter()
        got = [rs.to_dicts() for rs in db.query_batch([Q3] * 16, [{"k": k} for k in ks3])]
        sync()
        ms = (time.perf_counter() - t) * 1e3
        every = dref.q3(Q3_K)
        for k, rows in zip(ks3, got):
            want = every[every[:, 0] < k]
            _require(np.array_equal(_sorted_rows(np, rows, ("p", "f", "g")), want), f"BQ3 k={k}")
        return ms

    def run_cells(tag, names=("D1", "Q3", "V1"), batch=True):
        out = []
        for name in names:
            sql, params, check = cells[name]
            for call in ("first", "second"):
                t = time.perf_counter()
                rows = db.query(sql, params).to_dicts()
                sync()
                out.append(f"{name} {call} {(time.perf_counter() - t) * 1e3:.3f} ms")
                check(rows)
            v = _only_plan(TE, snap, sql)
            out[-1] += f" [{len(v.plans)} plan(s), {v.plans[0].replays} replays]"
        if batch:
            out.append(f"BQ3 {bq3():.3f} ms")
        print(f"delta {tag}: " + "; ".join(out) + " (each equal to numpy)")

    def tr1(tag):
        """TR1 on the padded twin against numpy over the base graph plus
        the events so far (the live edges; order and ages included)."""
        want, levels = numpy_traverse(
            np, dref.alive.shape[0], dref.roots(50), lambda f: dref.out(f)[1], admit=lambda d: d < 2
        )
        t = time.perf_counter()
        rows = db.query(TR1).to_dicts()
        sync()
        ms = (time.perf_counter() - t) * 1e3
        got = np.array([int(r["@rid"].split(":")[1]) for r in rows], np.int64)
        _require(np.array_equal(got, want), f"TR1 {tag}: records differ from numpy")
        _require([r["age"] for r in rows] == dref.age[want].tolist(), f"TR1 {tag}: ages differ from numpy")
        v = _only_plan(TE, snap, TR1)
        print(
            f"delta TR1 {tag}: {ms:.3f} ms, {len(rows)} records, levels {levels}; {len(v.plans)} plan(s), "
            f"replays {[p.replays for p in v.plans]}, data version {ov.data_version} (equal to numpy)"
        )
        return v

    run_cells("before the writes (first call records and captures)")
    tr1_plans = list(tr1("before the writes").plans)
    _require(ov.plan_gen == 0, "a plan generation moved before any write")
    d1_plan = _only_plan(TE, snap, D1).plans[0]
    _require(d1_plan.solver._count_pushdown_steps(), "D1 does not take the pushdown on clean topology")
    ptrs = {k: a.data_ptr() for k, a in dg.arrays.items()}

    writer = DeltaWriter(np, db, snap, seed=8)
    K.reset_launches()
    batches = [
        ("W1", lambda: writer.w1(W_PERSONS, W_EXTRA_EDGES)),
        ("W2", lambda: writer.w2(W_UPDATES)),
        ("W3", lambda: writer.w3(W_DEL_EDGES, W_DEL_PERSONS, Q3_K)),
    ]
    for tag, make in batches:
        plans = {n: _only_plan(TE, snap, cells[n][0]).plans[0] for n in cells} if tag == "W2" else None
        gen = ov.plan_gen
        events = make()
        n_events = len(events)
        t = time.perf_counter()
        ok = m.apply_batch(events)
        sync()
        host_ms = (time.perf_counter() - t) * 1e3
        _require(ok, f"{tag} poisoned the overlay: {ov.poisoned}")
        t = time.perf_counter()
        dref.apply(events)
        dref.refresh()
        ref_s = time.perf_counter() - t
        # the batch's event dicts go before the cells are timed: the
        # collector would otherwise walk them inside a query's time
        del events
        gc.collect()
        print(
            f"delta {tag}: {n_events} events, maintainer {host_ms:.1f} ms (host, to the last patch), "
            f"uploaded {m.last['upload_bytes']} bytes, K16 launches {m.last['launches']}, patches on the "
            f"card {m.patch_device_ms():.3f} ms; plan_gen {gen} -> {ov.plan_gen}; overlay {ov.stats()}"
        )
        print(f"delta {tag}: numpy reference applied the events in {ref_s:.1f} s")
        if tag == "W2":
            _require(ov.plan_gen == gen, "a DATA-only batch moved the plan generation")
            before = {n: (p.graph, p.replays) for n, p in plans.items()}
        run_cells(f"after {tag}")
        if tag in ("W1", "W2"):
            # the TRAVERSE replay is static: after W1 the cleared cache
            # records it anew, after W2 (which keeps the cache) its stale
            # data version sends the dispatch to a re-record
            v = tr1(f"after {tag}")
            _require(all(p not in tr1_plans for p in v.plans[:1]), f"TR1 did not re-record after {tag}")
            if tag == "W2":
                _require(len(v.plans) == 2 and v.plans[1] is tr1_plans[0], "TR1 did not re-record as a variant after W2")
            tr1_plans = list(v.plans)
        if tag == "W1":
            _require(ov.plan_gen == gen + 1 and ov.topology_dirty, "W1 did not re-record once")
            _require(not _only_plan(TE, snap, D1).plans[0].solver._count_pushdown_steps(), "D1 kept the pushdown")
        if tag == "W2":
            for n, p in plans.items():
                now = _only_plan(TE, snap, cells[n][0]).plans
                _require(now == [p] and p.graph is before[n][0] and p.replays == before[n][1] + 2,
                         f"{n} did not replay its captured graph after a DATA-only batch")
        _require(not ov.bucket_overflow, f"{tag} overflowed a bucket: {ov.bucket_overflow}")
    _require(all(dg.arrays[k].data_ptr() == p for k, p in ptrs.items()), "a patch reallocated a resident tensor")
    path = dict(K.LAUNCHES)
    for name in ("scatter_set", "slab_probe", "predicate_eval", "bitmap_hop_probe", "group_page"):
        _require(path[name] > 0, f"{name} never launched in the delta phase")
    _require(path["bitmap_hop"] == 0, f"a dirty hop ran the edge-list form before any overflow: {path['bitmap_hop']}")
    check_delta_kernels(np, torch, K, ks, dg, snap)

    # W4: one person's out bucket overflows, the class switches to K17
    K.reset_launches()
    src = int(dref.roots(200)[0])
    events = writer.w4(src, W_FANOUT)
    gen = ov.plan_gen
    t = time.perf_counter()
    m.apply_batch(events)
    sync()
    print(
        f"delta W4: {len(events)} events, maintainer {(time.perf_counter() - t) * 1e3:.1f} ms, uploaded "
        f"{m.last['upload_bytes']} bytes, K16 launches {m.last['launches']}; plan_gen {gen} -> {ov.plan_gen}; "
        f"bucket_overflow {sorted(ov.bucket_overflow)}"
    )
    _require(ov.bucket_overflow == {"knows"} and ov.plan_gen > gen, "W4 did not overflow the bucket")
    dref.apply(events)
    dref.refresh()
    small = {"Q3": (Q3, {"k": 200}, lambda rows: _require(
        np.array_equal(_sorted_rows(np, rows, ("p", "f", "g")), dref.q3(200)), "Q3 k=200 after W4")),
        "direct": (Q_DIRECT, {"k": Q_DIRECT_K}, lambda rows: _require(
            np.array_equal(_sorted_rows(np, rows, ("p", "f")), dref.direct(Q_DIRECT_K)), "direct after W4"))}
    cells.update(small)
    # V1 hops over the overflowed class: K10's edge-list form over the window
    run_cells("after W4", names=("Q3", "direct", "V1"), batch=False)
    w4 = dict(K.LAUNCHES)
    _require(w4["slab_scan"] > 0 and w4["slab_probe"] == 0, f"W4's cells did not scan the slab: {w4}")
    _require(w4["bitmap_hop"] > 0 and w4["bitmap_hop_probe"] == 0, f"V1 after W4 did not hop the window: {w4}")
    scans = w4["slab_scan"] // K17_LAUNCHES
    print(
        f"delta W4 launches: { {k: v for k, v in w4.items() if v} }; {scans} window scans of "
        f"{K17_LAUNCHES} slab_scan launches each"
    )
    check_slab_scan(torch, K, ks, dg, snap, src)
    for name in DELTA_ONLY:
        path[name] += w4[name]

    # W5: the overlay poisons (a person deleted, then an edge written to
    # it: "endpoint not in snapshot"); apply_batch compacts, as the
    # reference's maintainer does, and the fresh snapshot answers
    victim = int(dref.roots(Q3_K)[1])
    events = [
        {"op": "delete", "rid": f"#{writer.pc}:{victim}", "class": "Person"},
        writer.edge(int(dref.roots(Q3_K)[0]), victim),
    ]
    before = m.compactions
    t = time.perf_counter()
    ok = m.apply_batch(events)
    sync()
    host_ms = (time.perf_counter() - t) * 1e3
    _require(
        ok and m.compactions == before + 1 and "endpoint not in snapshot" in m.last_compact_reason,
        f"W5 did not compact on the poisoned overlay: {m.stats()}",
    )
    dref.apply(events)
    dref.refresh()
    snap = db.current_snapshot()
    ov = snap._overlay
    _require(not ov.bucket_overflow and not ov.topology_dirty, "W5's compacted overlay is not clean")
    cells = _delta_cells(np, dref)
    t = time.perf_counter()
    run_cells("after W5 (compacted; the first calls upload the new snapshot, record and capture)")
    first_ms = (time.perf_counter() - t) * 1e3
    tr1("after W5")
    _require(_only_plan(TE, snap, D1).plans[0].solver._count_pushdown_steps(), "D1 lost the pushdown after W5")
    new_mem = device_graph(snap, db.device).memory_report()
    print(
        f"delta W5: {len(events)} events, maintainer {host_ms:.1f} ms (host, the compaction included), the "
        f"fold {m.last_compact['fold_ms']:.1f} ms host ({m.last_compact['vertices']} vertex rows, "
        f"{ov.edge_slabs['knows'].base} knows edges folded), the new snapshot's {new_mem['total_bytes']} bytes uploaded at its first "
        f"query; the cells after it {first_ms:.1f} ms; compactions {m.compactions}, reason "
        f"{m.last_compact_reason!r}, dead fraction {m.stats()['dead_fraction']} [{card}]"
    )
    return path


def check_delta_kernels(np, torch, K, ks, dg, snap):
    """K16 against its plain version at W1's segments (the dst and live
    slots of 131,072 new edges), on copies of the resident arrays; K18 at
    D1's probe (the 100,000 roots of `uid < 100,000`); each timed, and in
    a captured graph, beside its bound; then the slab's part of a dirty hop
    (`check_slab_hop`); their launches are not counted."""
    counted = dict(K.LAUNCHES)
    dev = dg.device
    ov = snap._overlay
    sl = ov.edge_slabs["knows"]
    dec = dg.edges["knows"]
    S = sl.next_slot - sl.base
    idx = torch.arange(sl.base, sl.next_slot, dtype=torch.int32, device=dev)
    for arr in (dec.dst, dec.live, dg.columns["age"].values):
        n = min(S, arr.shape[0])
        ii = idx[:n] if arr.shape[0] > sl.base else torch.arange(n, dtype=torch.int32, device=dev)
        vals = arr[ii.long()].flip(0).contiguous()
        a, b = arr.clone(), arr.clone()
        K.scatter_set(a, ii, vals)
        K.plain_scatter_set(b, ii, vals)
        ks.same("scatter_set", a, b)
    a = dec.dst.clone()
    vals = dec.dst[idx.long()].contiguous()
    idx64 = idx.long()
    w = 4
    ks.timed(
        "scatter_set",
        lambda: K.scatter_set(a, idx, vals),
        lambda: K.plain_scatter_set(a, idx, vals),
        lambda: a.index_put_((idx64,), vals),
        S * (4.0 + w) + S * w,
    )
    g_ms = _graph_ms(torch, lambda: K.scatter_set(a, idx, vals))
    gl_ms = _graph_ms(torch, lambda: a.index_put_((idx64,), vals))
    srcs = torch.full((K.bucket(D1_K),), -1, dtype=torch.int32, device=dev)
    srcs[:D1_K] = torch.arange(D1_K, dtype=torch.int32, device=dev)
    tab = dg.arrays["bk:knows:out"]
    out = [0]

    def size_for(total):
        out[0] = max(K.bucket(int(total)), 8)
        return out[0]

    got = K.slab_probe(tab, dec.edge_src, dec.dst, dec.live, srcs, sl.base, ov.bk_nb, ov.bk_bk, size_for)
    want = K.plain_slab_probe(tab, dec.edge_src, dec.dst, dec.live, srcs, sl.base, ov.bk_nb, ov.bk_bk, size_for)
    ks.same("slab_probe", got, want)
    n = out[0]
    fixed = lambda t: n  # noqa: E731 — no host read: capturable
    R, BK = srcs.shape[0], ov.bk_bk
    # what this probe reads: every source, the BK entries of each real
    # source's bucket, the owning endpoint and liveness behind each filled
    # entry, a neighbour per match; and the n output slots it writes
    host_tab = ov.bk["knows"]["out"].reshape(ov.bk_nb, BK)
    filled = int((host_tab[np.arange(D1_K) & (ov.bk_nb - 1)] >= 0).sum())
    matches = int(want[3])
    ks.timed(
        "slab_probe",
        lambda: K.slab_probe(tab, dec.edge_src, dec.dst, dec.live, srcs, sl.base, ov.bk_nb, BK, fixed),
        lambda: K.plain_slab_probe(tab, dec.edge_src, dec.dst, dec.live, srcs, sl.base, ov.bk_nb, BK, fixed),
        None,
        R * 4.0 + D1_K * BK * 4.0 + filled * 5.0 + matches * 4.0 + n * 12.0,
    )
    p_ms = _graph_ms(torch, lambda: K.slab_probe(tab, dec.edge_src, dec.dst, dec.live, srcs, sl.base, ov.bk_nb, BK, fixed))
    print(
        f"kernel scatter_set: equals its plain version on W1's segments ({S} slots of dst, live, age); "
        f"{ks.rows['scatter_set']['ms']:.4f} ms ({g_ms:.4f} in a graph), bound {ks.rows['scatter_set']['bound_ms']:.4f}, "
        f"library index_put_ {ks.rows['scatter_set']['library_ms']:.4f} ({gl_ms:.4f} in a graph); "
        f"kernel slab_probe: equals its plain version at D1's probe (R={R}, BK={BK}, total {int(want[3])}); "
        f"{ks.rows['slab_probe']['ms']:.4f} ms ({p_ms:.4f} in a graph), bound {ks.rows['slab_probe']['bound_ms']:.4f} "
        f"({filled} filled bucket entries probed)"
    )
    check_slab_hop(torch, K, ks, dg, dec, sl, ov)
    K.LAUNCHES.update(counted)


def probe_bytes(torch, probe, fr, emask) -> tuple:
    """(bytes, active vertices, filled entries, kept entries): what the
    slab probe adds to K10's push for this frontier: BK int32 of bucket an
    active vertex, the owning endpoint and liveness (5 bytes) at each filled
    entry of those buckets, and at each kept entry the mask byte and the
    emitted endpoint (5 bytes)."""
    vb = fr.shape[1]
    v = fr.any(0)[: min(vb, probe.own.shape[0])].nonzero().view(-1)
    rel = probe.tab.view(probe.nb, probe.bk)[v & (probe.nb - 1)].long()
    at = (probe.base + rel).clamp(0, probe.own.shape[0] - 1)
    filled = (rel >= 0) & (probe.base + rel < probe.own.shape[0])
    kept = filled & (probe.own[at].long() == v[:, None]) & probe.live[at] & emask[at]
    n_fill, n_kept = int(filled.sum()), int(kept.sum())
    return probe.bk * 4.0 * v.shape[0] + 5.0 * n_fill + 5.0 * n_kept, int(v.shape[0]), n_fill, n_kept


def check_slab_hop(torch, K, ks, dg, dec, sl, ov, c: int = 8) -> None:
    """The slab's part of a dirty hop at the shape the engine runs it on
    this snapshot after W3 (`build_bitmap_hops`; an out hop, ``live`` as
    the mask): K10's push with the slab probe (one launch), held against
    the CSR form's plain push ORed with the plain edge-list hop over the
    slab's whole window [base, cap) (the parent's two launches) and against
    its own plain version; and K10's edge-list form over that window (which
    a class runs once a bucket overflowed), held against its plain version.
    C = 8 rows of 10 random vertices and the sources of 64 random live slab
    edges each. Each timed eager and in a captured graph beside its bound
    at this shape, the parent's pair beside them: the probe's bound is the
    CSR push's (`csr_hop_bytes`) plus `probe_bytes`; the edge-list form's a
    mask byte a window slot, at a live slot its endpoints and the C
    frontier bytes at its active endpoint, and a byte a row it sets."""
    dev = dg.device
    win = slice(sl.base, sl.cap)
    a, e, m = dec.edge_src[win], dec.dst[win], dec.live[win]
    W = a.shape[0]
    vb = K.bucket(dg.num_vertices)
    gen = torch.Generator(device=dev).manual_seed(8)
    live = torch.nonzero(m).view(-1)
    fr = torch.zeros((c, vb), dtype=torch.bool, device=dev)
    for r in range(c):
        fr[r, torch.randint(0, dg.num_vertices, (10,), generator=gen, device=dev)] = True
        if live.numel():
            fr[r, a[live[torch.randint(0, live.numel(), (64,), generator=gen, device=dev)]].long()] = True
    alive = K.mask_count(fr.view(-1))
    csr = (dec.indptr_out, dec.dst, None)
    lv = dec.live
    base = K.bitmap_hop_csr(*csr, lv, fr)
    acc = base.clone()
    K.bitmap_hop(a, e, m, fr, None, alive, acc)
    want = K.plain_bitmap_hop(a, e, m, fr, None, alive)
    ks.same("bitmap_hop", acc, base | want)
    ks.same("bitmap_hop", K.bitmap_hop(a, e, m, fr, None, alive), want)
    probe = K.SlabIndex(dg.arrays["bk:knows:out"], dec.edge_src, dec.dst, lv, sl.base, ov.bk_nb, ov.bk_bk)
    folded = lambda f=fr, al=alive: K.bitmap_hop_csr(*csr, lv, f, None, al, probe=probe)  # noqa: E731
    plain_folded = lambda: (  # noqa: E731
        K.plain_bitmap_hop_csr(*csr, lv, fr, None, alive) | K.plain_bucket_hop(probe, lv, fr, None, alive)
    )
    got = folded()
    ks.same("bitmap_hop_probe", got, K.plain_bitmap_hop_csr(*csr, lv, fr, None, alive) | want)
    ks.same("bitmap_hop_probe", got, plain_folded())
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    _require(not folded(fr, zero).any(), "the probe hop wrote at alive 0")
    L = int(live.numel())
    act = int(fr.any(0)[a[live].long().clamp(0, vb - 1)].sum())
    n_set = int(want.sum())
    sp = None
    fr_t = fr.t().float().contiguous()
    try:
        idx = torch.stack([e[live].long(), a[live].long()])
        sp = torch.sparse_coo_tensor(idx, torch.ones(L, device=dev), (vb, vb)).coalesce().to_sparse_csr()
    except (RuntimeError, TypeError) as err:
        print(f"library call for bitmap_hop refused: {err}")
    hop = lambda: K.bitmap_hop(a, e, m, fr, None, alive, acc)  # noqa: E731
    ks.timed(
        "bitmap_hop",
        hop,
        lambda: K.plain_bitmap_hop(a, e, m, fr, None, alive),
        None if sp is None else (lambda: torch.sparse.mm(sp, fr_t)),
        1.0 * W + L * (8.0 + c) + n_set + 4.0,
    )
    r = ks.rows["bitmap_hop"]
    print(
        f"kernel bitmap_hop at the slab window (out hop, {W} slots [{sl.base}, {sl.cap}), {L} live, {act} with "
        f"an active endpoint, C={c}, ORed into the CSR hop): equals its plain version; {r['ms']:.4f} ms eager, "
        f"{_graph_ms(torch, hop):.4f} in a graph, bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, "
        f"library {r['library_ms']}"
    )
    # the probe's yardstick: one sparse product over every live edge, base
    # and slab (rows = the reached endpoint; counts, not bits)
    sp_all = None
    try:
        ok = lv.nonzero().view(-1)
        idx = torch.stack([dec.dst[ok].long(), dec.edge_src[ok].long()])
        sp_all = torch.sparse_coo_tensor(idx, torch.ones(ok.shape[0], device=dev), (vb, vb)).coalesce().to_sparse_csr()
        del idx, ok
    except (RuntimeError, TypeError) as err:
        print(f"library call for bitmap_hop_probe refused: {err}")
    b_csr, n_act, n_edges = csr_hop_bytes(torch, dec.indptr_out, fr, None, True, False)
    b_probe, _act, n_fill, n_kept = probe_bytes(torch, probe, fr, lv)
    ks.timed(
        "bitmap_hop_probe",
        folded,
        plain_folded,
        None if sp_all is None else (lambda: torch.sparse.mm(sp_all, fr_t)),
        b_csr + b_probe,
    )
    del sp_all
    parent = lambda: K.bitmap_hop(a, e, m, fr, None, alive, K.bitmap_hop_csr(*csr, lv, fr, None, alive))  # noqa: E731
    push = lambda: K.bitmap_hop_csr(*csr, lv, fr, None, alive)  # noqa: E731
    r = ks.rows["bitmap_hop_probe"]
    print(
        f"kernel bitmap_hop_probe at the slab window (out hop after W3, C={c}: {n_act} active vertices, "
        f"{n_edges} CSR edges, {n_fill} filled bucket entries probed, {n_kept} kept): equals the CSR push ORed "
        f"with the plain edge-list hop over the window, and its plain version; {r['ms']:.4f} ms eager, "
        f"{_graph_ms(torch, folded):.4f} in a graph, bound {r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, "
        f"library {r['library_ms']}; the parent's two launches (CSR push + edge-list window) "
        f"{_time_ms(torch, parent):.4f} eager, {_graph_ms(torch, parent):.4f} in a graph; the CSR push alone "
        f"{_graph_ms(torch, push):.4f} in a graph"
    )


def _in_adjacency(np, torch, csr, n: int, dev, name: str):
    """The edge class's in-CSR as a sparse [n, n] float matrix (rows = the
    reached endpoint), so that one `torch.sparse.mm` of it with a [n, Q]
    frontier is a hop: counts of lit in-edges per (vertex, query). None,
    with the reason printed, where PyTorch refuses the tensor."""
    try:
        ipi = csr.indptr_in.astype(np.int64)
        crow = torch.from_numpy(np.concatenate([ipi, np.full(n + 1 - ipi.shape[0], ipi[-1], np.int64)])).to(dev)
        col = torch.from_numpy(csr.src.astype(np.int64)).to(dev)
        return torch.sparse_csr_tensor(crow, col, torch.ones(col.shape[0], device=dev), (n, n))
    except (RuntimeError, TypeError) as e:
        print(f"library call for {name} refused: {e}")
        return None


def check_slab_scan(torch, K, ks, dg, snap, src: int):
    """K17 against its plain version at the shape of Q3 k=200's second hop
    after W4 (the 2-hop frontier of the roots, the used slab window), with
    padding rows and a truncating capacity, with the overflowed person
    repeated on 64 rows, and on an empty window; timed eager and in a
    captured graph, beside its byte bound (the reference's compare count
    printed as a figure); its launches are not counted."""
    from orientdb_tpu_torch.exec.tpu_engine import _cap_of

    counted = dict(K.LAUNCHES)
    dev = dg.device
    sl = snap._overlay.edge_slabs["knows"]
    dec = dg.edges["knows"]
    used = sl.next_slot - sl.base
    W = min(sl.cap - sl.base, _cap_of(used))
    a, e, lv = (t[sl.base : sl.base + W] for t in (dec.edge_src, dec.dst, dec.live))
    csr = snap.edge_classes["knows"]
    f = csr.dst[csr.indptr_out[0] : csr.indptr_out[200]]
    f = f[f >= 0]
    R = K.bucket(f.shape[0])
    srcs = torch.full((R,), -1, dtype=torch.int32, device=dev)
    srcs[: f.shape[0]] = torch.from_numpy(f.astype("int32")).to(dev)
    srcs[0] = src  # the overflowed person
    repeated = srcs.clone()
    repeated[1:65] = src
    out = [0]

    def size_for(total):
        out[0] = max(_cap_of(int(total)), 8)
        return out[0]

    for s in (repeated, srcs):
        ks.same("slab_scan", K.slab_scan(a, e, lv, s, sl.base, size_for),
                K.plain_slab_scan(a, e, lv, s, sl.base, size_for))
    n = out[0]
    ks.same("slab_scan", K.slab_scan(a, e, lv, srcs, sl.base, lambda t: 8),
            K.plain_slab_scan(a, e, lv, srcs, sl.base, lambda t: 8))
    empty = (a[:0], e[:0], lv[:0])
    ks.same("slab_scan", K.slab_scan(*empty, srcs, sl.base, lambda t: 8),
            K.plain_slab_scan(*empty, srcs, sl.base, lambda t: 8))
    fixed = lambda t: n  # noqa: E731
    total = int(K.plain_slab_scan(a, e, lv, srcs, sl.base, fixed)[3])
    ks.timed(
        "slab_scan",
        lambda: K.slab_scan(a, e, lv, srcs, sl.base, fixed),
        lambda: K.plain_slab_scan(a, e, lv, srcs, sl.base, fixed),
        None,
        # the sources, the window's active endpoints and liveness, the
        # emitted endpoint at each hit kept, the output
        R * 4.0 + W * 5.0 + min(total, n) * 4.0 + n * 12.0,
    )
    g_ms = _graph_ms(torch, lambda: K.slab_scan(a, e, lv, srcs, sl.base, fixed))
    before = dict(K.LAUNCHES)
    K.slab_scan(a, e, lv, srcs, sl.base, fixed)
    per_call = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES if K.LAUNCHES[k] != before[k]}
    print(
        f"kernel slab_scan: equals its plain version at R={R}, W={W} (used {used}; total "
        f"{total} into {n}), with the overflowed person on 64 "
        f"rows, a capacity of 8 and an empty window; {ks.rows['slab_scan']['ms']:.4f} ms ({g_ms:.4f} in a graph), "
        f"bound {ks.rows['slab_scan']['bound_ms']:.4f} ({ks.rows['slab_scan']['bound_by']}; the reference's "
        f"{f.shape[0] * W} compares are its algorithm, not the bound); launches a call {per_call}"
    )
    K.LAUNCHES.update(counted)


# ---------------------------------------------------------------------------
# K15: the predicate-program kernel on synthetic columns
# ---------------------------------------------------------------------------

#: WHERE clauses over `k15_snapshot`'s columns, every instruction family of
#: the predicate programs (`PredOp`); the last is a ~50-instruction program
K15_WHERES = [
    # int, float and mixed compares; bool vs int; incomparables
    "i > 3", "i <= j", "i = j", "i != 5", "f < 2.5", "f >= g", "i < f", "f = 3",
    "b = 1", "b < 1", "i != 'x'",
    # string rank, code tables, truthiness, same-dictionary codes, IN
    "s >= 'm'", "s < 'k1'", "s = 'q2'", "s != 'zz'", "s LIKE 'a%'", "s MATCHES '[a-f].*'",
    "s CONTAINSTEXT '1'", "s", "s = s", "i IN [20, 'x', 30.5, -7]",
    # arithmetic: wraps, negatives, zero divisors, floor modulo
    "i + j > 0", "i - j * 3 < 7", "i % j = 1", "i % j < 0", "f / g > 1.5", "f % g > 0.5",
    "i / j > 0.5", "-i > 3", "-big < 0", "big + big > 0", "big * 3 < 0", "f * 2.5 - i > 1",
    # nulls and boolean structure
    "f IS NULL", "s IS NOT NULL", "missing IS NULL", "NOT (f > 1 AND (b OR s IS NULL))",
    "i BETWEEN -3 AND 7", "b", "i", "f", "missing > 3 OR NOT (i < 2)",
    # the WHILE level and parameters
    "$depth < j", "i < :k AND f > :x AND b = :t",
    # binding references and distance()
    "i < p.i AND f > p.f",
    "distance(lat, lng, :x, :y) < :r",
    "distance(lat, lng, p.lat, p.lng, 'mi') < 900",
    "(i > 3 AND f < 2.5 OR s LIKE 'b%') AND NOT (j = 0) AND (i % j < 2 OR f / g > 1) "
    "AND i IN [1, 2, 3, 5, 8, 13] AND (b OR s >= 'm') AND distance(lat, lng, 40.0, -3.5) < 4000 "
    "AND -i < big AND (f IS NOT NULL OR i + j * 2 > 7)",
]
K15_PARAMS = {"k": 17, "x": 48.0, "y": 2.0, "r": 2500.0, "t": True}
#: the distance() WHEREs above: the other point ("param" :x/:y, "bind" p's
#: lat/lng, or a constant), the unit scale and the radius
K15_DIST = {
    "distance(lat, lng, :x, :y) < :r": ((48.0, 2.0), 1.0, 2500.0),
    "distance(lat, lng, p.lat, p.lng, 'mi') < 900": ("bind", 0.621371192, 900.0),
    K15_WHERES[-1]: ((40.0, -3.5), 1.0, 4000.0),
}
K15_DEPTH = 2


# ---------------------------------------------------------------------------
# phase 9: tiered snapshots (configuration T: A at half its adjacency bytes)
# ---------------------------------------------------------------------------

# the reference's tiered bench query (bench.py:466-470) on Person–knows
T1 = (
    "MATCH {class:Person, as:p, where:(uid = :u)}"
    "-knows->{as:f, where:(age < 30)} RETURN count(*) AS n"
)
# rows through the in partition
T2 = "MATCH {class:Person, as:p, where:(uid < :k)}<-knows-{as:f} RETURN p.uid AS pu, f.uid AS fu"
T2_K = 100
# variable depth: K19 hops and K20 flags
T3 = (
    "MATCH {class:Person, as:p, where:(uid = :u)}"
    "-knows->{as:f, while:($depth < 2)} RETURN count(*) AS n"
)
# a 2-hop COUNT whose second frontier spans every block: the pool grows
T_GROW_K = 2000
T_GROW = (
    f"MATCH {{class:Person, as:p, where:(uid < {T_GROW_K})}}"
    "-knows->{as:f}-knows->{as:g} RETURN count(*) AS n"
)
T_V = 8_000_000
#: T1's parameters (bench.py:471: u = (i·131) mod (V/4), i < 64), and
#: T1c's, spread over every block (u = (i·65,537) mod V, i < 1,024)
T1_PARAMS = [{"u": (i * 131) % (T_V // 4)} for i in range(64)]
T1C_PARAMS = [{"u": (i * 65_537) % T_V} for i in range(1_024)]
T3_ROOTS = [(i * 500_009) % T_V for i in range(16)]
#: T4c: TR1's shape from the 50 persons uid >= lo (chosen at run time)
T4C = (
    "TRAVERSE out('knows') FROM (SELECT FROM Person WHERE uid >= {lo} AND uid < {hi}) "
    "WHILE $depth < 2 STRATEGY BREADTH_FIRST"
)


class TRef:
    """numpy answers of T1–T3 and the growth COUNT from the host CSR."""

    def __init__(self, np, snap):
        self.np = np
        self.snap = snap
        csr = snap.edge_classes["knows"]
        self.ip, self.dst = csr.indptr_out, csr.dst
        self.ipi, self.src = csr.indptr_in, csr.src
        self.age = snap.v_columns["age"].values

    def t1(self, u: int) -> int:
        return int((self.age[self.dst[self.ip[u] : self.ip[u + 1]]] < 30).sum())

    def t2(self, k: int):
        np = self.np
        deg = np.diff(self.ipi[: k + 1])
        p = np.repeat(np.arange(k), deg)
        f = self.src[self.ipi[0] : self.ipi[k]]
        return np.unique(np.stack([p, f], 1).astype(np.int64), axis=0)

    def t3(self, u: int) -> int:
        np = self.np
        ones = np.ones(self.snap.num_vertices, bool)
        return int(numpy_var_depth_rows(self.snap, [u], "out", ones, while_depth=2).shape[0])

    def grow(self) -> int:
        """T_GROW's count: the 2-hop paths p → f → g from the persons with
        uid = p < T_GROW_K (a dense id), Σ over their out-neighbours f of
        deg(f)."""
        np = self.np
        return int(np.diff(self.ip)[self.dst[: self.ip[T_GROW_K]]].sum(dtype=np.int64))


def t1_qps(db, tref) -> float:
    """T1 over its 64 parameters as the reference times it (`bench.py:471-
    487`, ``time_singles``): two warm passes (the first checks every count
    against numpy), then three timed sequential passes of 64
    ``db.query(...).to_dicts()`` calls; their median q/s."""
    for p in T1_PARAMS:
        rows = db.query(T1, p).to_dicts()
        _require(rows == [{"n": tref.t1(p["u"])}], f"T1 u={p['u']}: {rows}")
    for p in T1_PARAMS:
        db.query(T1, p).to_dicts()
    qpss = []
    for _ in range(3):
        t = time.perf_counter()
        for p in T1_PARAMS:
            db.query(T1, p).to_dicts()
        qpss.append(len(T1_PARAMS) / (time.perf_counter() - t))
    return statistics.median(qpss)


def run_tiered(np, torch, K, TE, ks, db, snap, card, a_qps: float, a_bytes: int):
    """Phase 9: configuration T, A's graph (copied before A's upload)
    admitted at ``tier_hbm_cap_bytes`` = adjacency / 2 (`bench.py:507`).
    Runs T1 (timed as on A), T1c (churn, on the recording path), a replay
    off its footprint (the cold-miss flag), T2, T3, then holds K19–K21
    against their plain versions, then runs T4c (a cold TRAVERSE), then
    grows the pool with T_GROW and shows the plans re-capture, then T4.
    Returns the main path's launches."""
    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.storage import tiering
    from orientdb_tpu_torch.utils.config import config

    sync = torch.cuda.synchronize
    tref = TRef(np, snap)
    adj = tiering.adjacency_bytes(snap)
    cache = config.plan_cache_size
    config.tier_hbm_cap_bytes = adj // 2
    try:
        t0 = time.perf_counter()
        db.attach_snapshot(snap)
        tier = snap._tier
        _require(tier is not None, "T was not admitted to the tier plane")
        t_admit = time.perf_counter() - t0
        dg = device_graph(snap, db.device)
        sync()
        mem = dg.memory_report()
        print(
            f"tier: T admitted at cap {config.tier_hbm_cap_bytes} bytes (adjacency {adj}) in {t_admit:.1f} s, "
            f"device graph built in {time.perf_counter() - t0 - t_admit:.1f} s; resident {mem['total_bytes']} "
            f"bytes {mem['per_device']} against A's flat {a_bytes}; pools {tier.pool_bytes()} bytes, "
            f"hot {tier.hot_bytes()} bytes"
        )
        for key, part in sorted(tier.parts.items()):
            print(
                f"tier partition {key}: V={part.V} E={part.E} W={part.W} Wp={part.Wp} B={part.B} P={part.P} "
                f"({part.block_bytes()} bytes a page)"
            )
        _require(mem["total_bytes"] < a_bytes, "T's resident bytes are not below A's flat ones")
        for k in ("dst", "src", "edge_id_in", "edge_src"):
            _require(f"e:knows:{k}" not in dg.arrays and f"e:knows:{k}" not in dg._pending, f"knows {k} uploaded")
        K.reset_launches()
        mark = [tier.loaded_bytes, tier.prefetch_misses]

        def loaded(tag, t_s):
            print(
                f"tier {tag}: {t_s:.2f} s; loaded {tier.loaded_bytes - mark[0]} bytes "
                f"({tier.prefetch_misses - mark[1]} blocks); stats {tier.stats()}"
            )
            mark[:] = [tier.loaded_bytes, tier.prefetch_misses]

        # T1: the reference's tiered/resident statistic
        t = time.perf_counter()
        qps = t1_qps(db, tref)
        t1p = max(_only_plan(TE, snap, T1).plans, key=lambda p: p.replays)
        _require(t1p.launches.get("paged_expand", 0) > 0, f"T1's replay does not run K21: {t1p.launches}")
        print(
            f"tier T1: {qps:.1f} q/s tiered, {a_qps:.1f} q/s resident; tiered_vs_resident {qps / a_qps:.4f}; "
            f"launches per replay {sum(t1p.launches.values())} {t1p.launches} [{card}]"
        )
        loaded("T1", time.perf_counter() - t)
        # T1c: every block, more than the pool holds, on the recording path
        ev0 = tier.evictions
        config.plan_cache_size = 0
        t = time.perf_counter()
        try:
            for p in T1C_PARAMS:
                rows = db.query(T1, p).to_dicts()
                _require(rows == [{"n": tref.t1(p["u"])}], f"T1c u={p['u']}: {rows}")
        finally:
            config.plan_cache_size = cache
        _require(tier.evictions > ev0, "T1c evicted nothing")
        loaded(f"T1c ({len(T1C_PARAMS)} recordings, evictions {tier.evictions - ev0})", time.perf_counter() - t)
        cold_miss_replay(np, TE, db, snap, tier, tref)
        # T2: rows through the in partition (K21 reads eid from the pool)
        t = time.perf_counter()
        for k in (T2_K, T2_K, T2_K // 2):
            rows = db.query(T2, {"k": k}).to_dicts()
            _require(np.array_equal(_sorted_rows(np, rows, ("pu", "fu")), tref.t2(k)), f"T2 k={k}")
        t2p = _only_plan(TE, snap, T2).plans[0]
        _require(t2p.replays == 2, "T2 did not replay")
        print(f"tier T2: launches per replay {sum(t2p.launches.values())} {t2p.launches} [{card}]")
        loaded("T2", time.perf_counter() - t)
        # T3: K19 hops (each setting the replay's cold-miss byte), 16 roots
        # recorded, then replayed, the second pass timed
        t = time.perf_counter()
        times = []
        for rep in range(2):
            for u in T3_ROOTS:
                t0 = time.perf_counter()
                rows = db.query(T3, {"u": u}).to_dicts()
                sync()
                if rep:
                    times.append((time.perf_counter() - t0) * 1e3)
                _require(rows == [{"n": tref.t3(u)}], f"T3 u={u}: {rows}")
        t3 = _only_plan(TE, snap, T3)
        t3p = max(t3.plans, key=lambda p: p.replays)
        per = t3p.launches
        _require(t3p.replays >= 1 and per.get("paged_hop_csr", 0) > 0, "T3 did not replay its K19 hops")
        _require(per.get("paged_hop_miss", 0) == 0, f"T3's replay launches K20: {per}")
        print(
            f"tier T3: {len(t3.plans)} variants kept, replays {[p.replays for p in t3.plans]}; replay median "
            f"{statistics.median(times):.3f} ms (second pass over {len(T3_ROOTS)} roots, "
            f"{[round(x, 3) for x in times]}); launches per replay {sum(per.values())} {per} [{card}]"
        )
        loaded("T3", time.perf_counter() - t)
        sync()
        path = dict(K.LAUNCHES)
        for name in TIER_ONLY:
            if name not in OFF_PATH:
                _require(path[name] > 0, f"{name} never launched in the tiered phase")
        _require(path["paged_hop_miss"] == 0, "K20 launched in the tiered phase: K19 sets its flag")
        check_tier_kernels(np, torch, K, ks, dg, tier)
        t = time.perf_counter()
        cold_traverse(np, TE, db, snap, tier, tref, card)
        loaded("T4c", time.perf_counter() - t)
        # growth: a frontier over every block; the plans re-capture
        t1_old = list(_only_plan(TE, snap, T1).plans)
        gen, P0 = tier.generation, tier.parts[("knows", "out")].P
        want = tref.grow()
        t = time.perf_counter()
        for _ in range(2):
            rows = db.query(T_GROW).to_dicts()
            _require(rows == [{"n": want}], f"T_GROW: {rows}")
        part = tier.parts[("knows", "out")]
        _require(tier.generation > gen and part.P > P0, "T_GROW did not grow the pool")
        u = T1_PARAMS[0]["u"]
        rows = db.query(T1, {"u": u}).to_dicts()
        _require(rows == [{"n": tref.t1(u)}], f"T1 after growth: {rows}")
        v1 = _only_plan(TE, snap, T1)
        _require(
            v1.plans[0] not in t1_old and v1.plans[0].tier_gen == tier.generation
            and (v1.plans[0].graph is not None or db.device.type != "cuda"),
            "T1 did not re-capture under the new generation",
        )
        db.query(T1, {"u": u}).to_dicts()
        _require(v1.plans[0].replays >= 1, "the re-captured T1 plan does not replay")
        print(
            f"tier growth: generation {gen} -> {tier.generation}, out pool P {P0} -> {part.P} "
            f"(pools {tier.pool_bytes()} bytes); T1 re-recorded and re-captured under it"
        )
        loaded("T_GROW", time.perf_counter() - t)
        # T4: TR1's shape on T, K19 hops and K20 flags inside a TRAVERSE replay
        # (after K19–K21's checks and timings, which run on T1–T3's pool)
        ip64 = tref.ip.astype(np.int64)
        want, levels = numpy_traverse(
            np, snap.num_vertices, np.arange(50), lambda f: csr_neighbours(np, ip64, tref.dst, f),
            admit=lambda d: d < 2,
        )
        times = []
        for _ in range(4):
            t = time.perf_counter()
            rows = db.query(TR1).to_dicts()
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            got = np.array([int(r["@rid"].split(":")[1]) for r in rows], np.int64)
            _require(np.array_equal(got, want), "T4: records differ from numpy")
        t4 = _only_plan(TE, snap, TR1)
        plan = t4.plans[0]
        _require(plan.replays >= 1 and plan.graph is not None, "T4 did not replay a captured plan")
        _require(plan.launches.get("paged_hop_csr", 0) > 0, "paged_hop_csr not in T4's TRAVERSE replay")
        _require(plan.launches.get("paged_hop_miss", 0) == 0, f"T4's replay launches K20: {plan.launches}")
        print(
            f"tier T4: {len(rows)} records, levels {levels}; calls {[round(x, 3) for x in times]} ms "
            f"(the first records); {len(t4.plans)} variant(s), replays {[p.replays for p in t4.plans]}; "
            f"launches per replay {plan.launches}; footprint {len(plan.tier_footprint)} blocks [{card}]"
        )
        loaded("T4", sum(times) / 1e3)
        sync()
        launches = dict(K.LAUNCHES)
        print("tier launches: " + ", ".join(f"{n} {launches[n]}" for n in TIER_ONLY))
        TE._plan_cache(snap).clear()
        return launches
    finally:
        config.tier_hbm_cap_bytes = 0
        config.plan_cache_size = cache


def cold_traverse(np, TE, db, snap, tier, tref, card) -> None:
    """T4c: TR1's shape from 50 roots in a cold block (the first from the
    middle of the id range), on the capped pool. Its recording faults its
    blocks in (loaded bytes > 0); after an eviction pass (T1 recordings at
    one root of every other block until the roots' block is cold) its dispatch prefetch loads them back and the replay is clean;
    after another pass, a replay whose footprint lacks the roots' block
    (a stale footprint, made by hand: a TRAVERSE bakes its roots, so a full
    footprint never misses) raises K20's cold-miss flag, and the front door
    re-records. Every call's records equal numpy."""
    from orientdb_tpu_torch.utils.config import config

    part = tier.parts[("knows", "out")]
    V = snap.num_vertices

    def blocks_of(lo):
        return {int(b) for b in np.unique(part.block_of_v[lo : lo + 50])}

    lo = next((v for v in range(V // 2, V - 50, 50) if all(part.page_of[b] < 0 for b in blocks_of(v))), None)
    _require(lo is not None, "T4c: no cold block")
    sql = T4C.format(lo=lo, hi=lo + 50)
    roots = np.arange(lo, lo + 50)
    root_blocks = blocks_of(lo)
    # the eviction pass: T1 at the first person with out-edges of every
    # other block, in block order
    has = np.flatnonzero(part.vdeg[:V] > 0)
    blocks, first = np.unique(part.block_of_v[has], return_index=True)
    evict_us = [int(u) for b, u in zip(blocks, has[first]) if int(b) not in root_blocks]
    ip64 = tref.ip.astype(np.int64)
    want, levels = numpy_traverse(
        np, snap.num_vertices, roots, lambda f: csr_neighbours(np, ip64, tref.dst, f), admit=lambda d: d < 2
    )

    def call(tag):
        rows = db.query(sql).to_dicts()
        got = np.array([int(r["@rid"].split(":")[1]) for r in rows], np.int64)
        _require(np.array_equal(got, want), f"T4c {tag}: records differ from numpy")

    def evict_roots() -> int:
        cache = config.plan_cache_size
        config.plan_cache_size = 0
        try:
            for n, u in enumerate(evict_us, 1):
                _require(db.query(T1, {"u": u}).to_dicts() == [{"n": tref.t1(u)}], f"T4c pass u={u}")
                if all(part.page_of[b] < 0 for b in root_blocks):
                    return n
        finally:
            config.plan_cache_size = cache
        _require(False, f"T4c: {len(evict_us)} recordings left the roots' blocks resident")

    # the recording, then calls until the newest variant replays (a first
    # dispatch's footprint prefetch may grow the pool, which re-records)
    loaded0 = tier.loaded_bytes
    call("record")
    variants = _only_plan(TE, snap, sql)
    for _ in range(3):
        call("replay")
        if variants.plans[0].replays:
            break
    rec_bytes = tier.loaded_bytes - loaded0
    plan = variants.plans[0]
    _require(rec_bytes > 0 and plan.replays >= 1, f"T4c: loaded {rec_bytes} bytes, replays {plan.replays}")
    n1 = evict_roots()
    before, loaded1 = plan.replays, tier.loaded_bytes
    call("after an eviction pass")
    pre_bytes = tier.loaded_bytes - loaded1
    _require(
        pre_bytes > 0 and plan.replays == before + 1 and variants.plans[0] is plan,
        f"T4c after eviction: loaded {pre_bytes} bytes, replays {plan.replays - before}",
    )
    n2 = evict_roots()
    root_keys = {(part.key, b) for b in root_blocks}
    plan.tier_footprint = plan.tier_footprint - root_keys
    handle = plan.dispatch()
    meta, _ = plan.fetch(handle)
    plan.release(handle)
    _require(int(meta[1]) == 1, f"T4c: the replay off its roots' block did not flag: meta {meta}")
    call("re-record")
    new = variants.plans[0]
    _require(
        new is not plan and root_keys <= new.tier_footprint,
        "T4c: the flagged replay did not re-record",
    )
    print(
        f"tier T4c: roots uid {lo}..{lo + 49} (blocks {sorted(root_blocks)}), {len(want)} records, "
        f"levels {levels}; the recording and first calls loaded {rec_bytes} bytes; after {n1} evicting recordings the "
        f"dispatch prefetch loaded {pre_bytes} bytes and replayed clean; after {n2} more, a replay without "
        f"the roots' block flagged (meta {meta.tolist()}) and re-recorded ({len(variants.plans)} variants, "
        f"footprint {len(new.tier_footprint)} blocks) [{card}]"
    )


def cold_miss_replay(np, TE, db, snap, tier, tref) -> None:
    """A replay whose root's block lies outside its footprint: a T1 plan
    dispatched at a cold root with the same sizes as its recording's (the
    same degree and the same count, so no buffer overflows) raises the
    cold-miss flag in its meta row; once the block is resident the same
    replay is clean and right; through the front door another cold root
    re-records (one more variant)."""
    part = tier.parts[("knows", "out")]
    variants = _only_plan(TE, snap, T1)
    plan = variants.plans[-1]  # the oldest variant kept
    u0 = int(plan.solver.params["u"])
    fp = {b for (_k, b) in plan.tier_footprint}
    deg = np.diff(tref.ip)
    cands = np.nonzero(deg == deg[u0])[0]
    cold = cands[(part.page_of[part.block_of_v[cands]] < 0) & ~np.isin(part.block_of_v[cands], list(fp))]
    same = [int(u) for u in cold[:4096] if tref.t1(int(u)) == tref.t1(u0)]
    _require(len(same) >= 2, "no cold root with T1's sizes")
    uc, uc2 = same[0], same[-1]
    handle = plan.dispatch({"u": uc})
    meta, _ = plan.fetch(handle)
    plan.release(handle)
    _require(int(meta[1]) == 1, f"the off-footprint replay did not flag: meta {meta}")
    tier.ensure_vertices("knows", "out", [uc])
    handle = plan.dispatch({"u": uc})
    meta, _ = plan.fetch(handle)
    plan.release(handle)
    _require(int(meta[1]) == 0 and int(meta[0]) == tref.t1(uc), f"resident replay at u={uc}: meta {meta}")
    old = list(variants.plans)
    rows = db.query(T1, {"u": uc2}).to_dicts()
    _require(rows == [{"n": tref.t1(uc2)}], f"T1 at a cold root u={uc2}: {rows}")
    new = variants.plans[0]
    _require(
        new not in old and ((("knows", "out"), int(part.block_of_v[uc2])) in new.tier_footprint),
        "the cold root did not re-record",
    )
    print(
        f"tier cold miss: T1 recorded at u={u0} replayed at u={uc} (block {int(part.block_of_v[uc])} cold) "
        f"flagged; resident it returned {int(meta[0])}; u={uc2} re-recorded a variant "
        f"({len(old)} -> {len(variants.plans)} kept)"
    )


def check_tier_kernels(np, torch, K, ks, dg, tier):
    """K19–K21 against their plain versions at T's pool shapes (the knows
    pools of P pages of Wp slots), exactly: K19's push on T3's 8-row
    frontiers with a WHILE gate and on the in pool with an edge mask (also
    against the slot walk over the pool it replaces), K20 on the same
    frontiers, alone and folded into K19's push (the flag a replay's hops
    set, also at ``alive`` 0), K21 at T1c's roots (out) and T2's (in); each
    again with every page evicted, with an empty pool, and in a captured
    graph. Then times each beside its bound (bytes at 3.35 TB/s), and K19
    with and without the flag in a graph; their launches are not
    counted."""
    from orientdb_tpu_torch.storage import tiering

    counted = dict(K.LAUNCHES)
    dev = dg.device
    i32 = torch.int32
    V = dg.num_vertices
    vb = K.bucket(V)
    C = 8
    gen = torch.Generator(device=dev).manual_seed(19)
    pools = {}
    for d in ("out", "in"):
        k = tiering._keys("knows", d)
        pools[d] = {n: dg.arrays[k[n]] for n in k}
        pools[d]["indptr"] = dg.arrays[f"e:knows:indptr_{d}"]
    po = pools["out"]
    E = dg.edges["knows"].num_edges
    gate = torch.rand(vb, generator=gen, device=dev) < 0.9
    emask = torch.rand(E, generator=gen, device=dev) < 0.7
    roots = torch.tensor(T3_ROOTS[:C], dtype=i32, device=dev)
    fr0 = K.rows_to_bitmap(roots, vb)
    fr1 = K.plain_paged_hop(po["own"], po["nbr"], po["eid"], None, fr0)
    fr1[:, 0] = True  # vertex 0, the clip target of a -1 endpoint
    alive1 = K.mask_count(fr1.view(-1))
    zero = torch.zeros((), dtype=i32, device=dev)
    evicted = {d: dict(p, own=torch.full_like(p["own"], -1), pageof=torch.full_like(p["pageof"], -1)) for d, p in pools.items()}
    empty = {
        d: dict(p, own=p["own"][:0], nbr=p["nbr"][:0], eid=p["eid"][:0], pageof=torch.full_like(p["pageof"], -1))
        for d, p in pools.items()
    }

    def push(p):
        return (p["indptr"], p["blockv"], p["pageof"], p["estart"], p["nbr"], p["eid"])

    def hop(p, m, fr, g=None, alive=None):
        got = K.paged_hop_csr(*push(p), m, fr, g, alive)
        ks.same("paged_hop_csr", got, K.plain_paged_hop_csr(*push(p), m, fr, g, alive))
        ks.same("paged_hop_csr", got, K.plain_paged_hop(p["own"], p["nbr"], p["eid"], m, fr, g, alive))

    def miss(p, m, fr, g=None, alive=None):
        """K20 alone, and K19 with K20 folded in (the flag the replay's
        hops set, and its hop), against the plain hop and flag."""
        want = K.plain_paged_hop_miss(fr, p["blockv"], p["pageof"], p["indptr"], g, alive)
        got = K.paged_hop_miss(fr, p["blockv"], p["pageof"], p["indptr"], g, alive)
        ks.same("paged_hop_miss", got, want)
        flag = torch.zeros((), dtype=torch.bool, device=dev)
        hop_f = K.paged_hop_csr(*push(p), m, fr, g, alive, miss=flag)
        ks.same("paged_hop_csr", flag, want)
        ks.same("paged_hop_csr", hop_f, K.plain_paged_hop_csr(*push(p), m, fr, g, alive))
        return bool(got)

    for case in (pools, evicted, empty):
        for d, m in (("out", None), ("in", emask)):
            p = case[d]
            for fr in (fr0, fr1):
                hop(p, m, fr)
                hop(p, m, fr, gate, alive1)
                miss(p, m, fr)
                miss(p, m, fr, gate)
            hop(p, m, torch.zeros_like(fr1), alive=zero)
            _require(not miss(p, m, torch.zeros_like(fr1)), "K20 flagged an empty frontier")
            _require(not miss(p, m, fr1, gate, zero), "K20 flagged at alive 0")
            _require(miss(evicted[d], m, fr1), "K20 missed an all-evicted pool")
            _require(miss(empty[d], m, fr1), "K20 missed an empty pool")

    def expand_args(p, srcs):
        counts = K.degree_counts(p["indptr"], srcs)
        offsets = K.exclusive_cumsum(counts)
        total = K.value_sum(counts)
        return offsets, total, K.bucket(max(int(total), 1))

    def expand(p, d, srcs):
        offsets, total, n = expand_args(p, srcs)
        args = (p["indptr"], srcs, offsets, total, n, p["blockv"], p["pageof"], p["estart"], p["nbr"], p["eid"], d == "out")
        got = K.paged_expand(*args)
        want = K.plain_paged_expand(*args)
        ks.same("paged_expand", got, want)
        return want

    t1c = torch.tensor([q["u"] for q in T1C_PARAMS] + [-1] * 7, dtype=i32, device=dev)
    t2 = torch.cat([torch.arange(T2_K, dtype=i32, device=dev), torch.full((K.bucket(T2_K) - T2_K,), -1, dtype=i32, device=dev)])
    # a skewed frontier: 4,096 sources drawn by Zipf(1.3) ranks of the
    # vertices ordered by out-degree (the highest repeated hundreds of
    # times), a sixteenth of them -1
    deg = (po["indptr"][1:] - po["indptr"][:-1]).long()
    zr = torch.from_numpy(np.random.default_rng(21).zipf(1.3, 4_096) - 1).clamp(max=V - 1).to(dev)
    zipf = torch.argsort(deg, descending=True, stable=True)[zr].to(i32)
    zipf[::16] = -1
    for case in (pools, evicted, empty):
        for d, srcs in (("out", t1c), ("in", t2), ("out", t1c[:1]), ("in", t1c[-8:]), ("out", zipf)):
            expand(case[d], d, srcs)
    _require(bool(expand(evicted["out"], "out", t1c)[3]), "K21 did not flag an all-evicted pool")
    # in a captured graph: the same launches replayed, and a replay's
    # tiered reads sharing one miss byte (zeroed once, K19's push and
    # K21's gather storing into it)
    offs, tot, n = expand_args(po, t1c)
    z_offs, z_tot, z_n = expand_args(po, zipf)
    outs = {}
    k19 = lambda: K.paged_hop_csr(*push(po), None, fr1, gate, alive1)  # noqa: E731

    flag = torch.zeros((), dtype=torch.bool, device=dev)

    def k19_flag():
        flag.zero_()
        return K.paged_hop_csr(*push(po), None, fr1, gate, alive1, miss=flag)

    def k21(srcs=t1c, o=offs, t=tot, size=n, f=None):
        return K.paged_expand(po["indptr"], srcs, o, t, size, po["blockv"], po["pageof"], po["estart"], po["nbr"], po["eid"], True, f)

    def plain_k21(srcs=t1c, o=offs, t=tot, size=n):
        return K.plain_paged_expand(po["indptr"], srcs, o, t, size, po["blockv"], po["pageof"], po["estart"], po["nbr"], po["eid"], True)

    shared = torch.zeros((), dtype=torch.bool, device=dev)

    def k21_flag():
        return k21(f=shared)

    def captured():
        outs["hop"] = k19()
        outs["hop_f"] = k19_flag()
        outs["miss"] = K.paged_hop_miss(fr1, po["blockv"], po["pageof"], po["indptr"], gate, alive1)
        outs["expand"] = k21()
        outs["shared"] = torch.zeros((), dtype=torch.bool, device=dev)
        outs["hop_s"] = K.paged_hop_csr(*push(po), None, fr1, gate, alive1, miss=outs["shared"])
        outs["zipf_s"] = k21(zipf, z_offs, z_tot, z_n, outs["shared"])

    captured()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured()
    graph.replay()
    torch.cuda.synchronize()
    ks.same("paged_hop_csr", outs["hop"], K.plain_paged_hop_csr(*push(po), None, fr1, gate, alive1))
    ks.same("paged_hop_csr", outs["hop_f"], outs["hop"])
    ks.same("paged_hop_miss", outs["miss"], K.plain_paged_hop_miss(fr1, po["blockv"], po["pageof"], po["indptr"], gate, alive1))
    ks.same("paged_hop_csr", flag, outs["miss"])
    ks.same("paged_expand", outs["expand"], plain_k21())
    z_want = plain_k21(zipf, z_offs, z_tot, z_n)
    ks.same("paged_expand", outs["zipf_s"][:3], z_want[:3])
    ks.same("paged_hop_csr", outs["hop_s"], outs["hop"])
    ks.same("paged_expand", outs["shared"], outs["miss"] | z_want[3])
    torch.cuda.synchronize()

    # -- times ----------------------------------------------------------------
    S = po["own"].numel()
    live = int((po["own"] >= 0).sum())
    act_v = fr1.any(0) & gate
    av = act_v[:V].nonzero().view(-1)
    bv = po["blockv"].long()
    res = (bv[av] >= 0) & (po["pageof"][bv[av].clamp(min=0)] >= 0)
    ip = po["indptr"].long()
    res_v = int(res.sum())
    act_slots = int((ip[av + 1] - ip[av])[res].sum())
    sp = None
    try:
        # the hop as one sparse product over the resident slots (rows = the
        # reached endpoint): counts of active slots per (vertex, row)
        ok = (po["own"] >= 0).view(-1)
        idx = torch.stack([po["nbr"].view(-1)[ok].long(), po["own"].view(-1)[ok].long()])
        sp = torch.sparse_coo_tensor(idx, torch.ones(live, device=dev), (vb, vb)).coalesce().to_sparse_csr()
        fr1_t = fr1.t().float().contiguous()
    except (RuntimeError, TypeError) as e:
        print(f"library call for paged_hop_csr refused: {e}")
    ks.timed(
        "paged_hop_csr",
        k19,
        lambda: K.plain_paged_hop_csr(*push(po), None, fr1, gate, alive1),
        None if sp is None else (lambda: torch.sparse.mm(sp, fr1_t)),
        # the frontier rows and the gate at the V vertices; at an active
        # vertex its indptr pair, blockv, pageof and estart; nbr at the
        # slots of the active vertices of resident blocks; the [C, vb]
        # result written once
        (C + 1.0) * V + 20.0 * int(av.shape[0]) + 4.0 * act_slots + C * vb + 4.0,
    )
    in_fr = int(fr1[:, :V].any(0).sum())
    active = int(act_v[:V].sum())
    ks.timed(
        "paged_hop_miss",
        lambda: K.paged_hop_miss(fr1, po["blockv"], po["pageof"], po["indptr"], gate, alive1),
        lambda: K.plain_paged_hop_miss(fr1, po["blockv"], po["pageof"], po["indptr"], gate, alive1),
        None,  # a scatter-max over the blocks then an any: two calls at least
        # the frontier's first V columns; the gate at the vertices active
        # in a row; indptr, blockv and pageof at the gated active vertices;
        # one flag byte
        1.0 * C * V + in_fr + active * 16.0 + 1.0,
    )
    R = t1c.shape[0]

    def k21_bytes(r, t, size):
        # per source its offset, indptr pair, block, page and block start;
        # a pool read per live slot; three int32 outputs a slot; the flag
        return r * 24.0 + 4.0 + min(int(t), size) * 4.0 + size * 12.0 + 1.0

    ks.timed(
        "paged_expand",
        k21,
        plain_k21,
        None,  # a searchsorted then four gathers and the nulling selects
        k21_bytes(R, tot, n),
    )
    z_ms = [_time_ms(torch, lambda: k21(zipf, z_offs, z_tot, z_n)), _graph_ms(torch, lambda: k21(zipf, z_offs, z_tot, z_n))]
    z_bound = k21_bytes(zipf.shape[0], z_tot, z_n) / HBM_BYTES_PER_S * 1e3
    g_ms = {
        "paged_hop_csr": _graph_ms(torch, k19),
        "paged_hop_csr with the flag": _graph_ms(torch, k19_flag),
        "paged_hop_miss": _graph_ms(torch, lambda: K.paged_hop_miss(fr1, po["blockv"], po["pageof"], po["indptr"], gate, alive1)),
        "paged_expand": _graph_ms(torch, k21),
        "paged_expand with the shared flag": _graph_ms(torch, k21_flag),
    }
    for name in TIER_ONLY:
        r = ks.rows[name]
        print(
            f"kernel {name}: equals its plain version (T's pools, every page evicted, an empty pool, C={C}, "
            f"captured); {r['ms']:.4f} ms ({g_ms[name]:.4f} in a graph), bound {r['bound_ms']:.4f}, "
            f"plain {r['plain_ms']:.4f}, library {r['library_ms']}"
        )
    print(
        f"kernel paged_hop_csr with K20 folded in: its flag equals plain_paged_hop_miss (T's pools, every page "
        f"evicted, an empty pool, alive 0, captured); in a graph {g_ms['paged_hop_csr with the flag']:.4f} ms "
        f"with the flag (its zeroing included) against {g_ms['paged_hop_csr']:.4f} without and "
        f"{g_ms['paged_hop_miss']:.4f} for K20 alone"
    )
    print(
        f"kernel paged_expand as a replay runs it (the shared miss byte, no memset): "
        f"{g_ms['paged_expand with the shared flag']:.4f} ms in a graph against {g_ms['paged_expand']:.4f} with "
        f"its own zeroed byte; on the skewed frontier ({zipf.shape[0]} Zipf sources, total {int(z_tot)} into "
        f"{z_n}) {z_ms[0]:.4f} ms eager, {z_ms[1]:.4f} in a graph, bound {z_bound:.4f}; in one graph with K19 "
        f"sharing one miss byte: equal to the plain versions and the OR of their flags"
    )
    print(
        f"tier kernels: pool S={S} slots ({live} live), V={V}; K19's frontier: {int(av.shape[0])} active "
        f"vertices, {res_v} in resident blocks, {act_slots} slots; vb={vb}, K21 R={R} total {int(tot)}"
    )
    K.LAUNCHES.update(counted)


def k15_snapshot(np, n: int, seed: int):
    """``n`` vertices of three classes with int, float, bool and string
    columns (about 10 % absent, int32 extremes, zero and negative
    divisors, empty strings) and lat/lng."""
    from orientdb_tpu_torch.storage.snapshot import GraphSnapshot, PropertyColumn

    rng = np.random.default_rng(seed)
    snap = GraphSnapshot()
    snap.num_vertices = n
    snap.class_names = ["A", "B", "C"]
    snap.class_id_of = {"a": 0, "b": 1, "c": 2}
    snap.class_closure = {"a": np.array([0, 1], np.int32), "b": np.array([1], np.int32), "c": np.array([2], np.int32)}
    snap.v_class = rng.integers(0, 3, n, dtype=np.int32)
    i32 = np.iinfo(np.int32)

    def col(name, kind, vals, dictionary=None):
        snap.v_columns[name] = PropertyColumn(name, kind, vals, rng.random(n) >= 0.1, dictionary)

    i = rng.integers(-1000, 1000, n, dtype=np.int32)
    i[rng.integers(0, n, max(n // 64, 1))] = i32.min
    i[rng.integers(0, n, max(n // 64, 1))] = i32.max
    col("i", "int", i)
    col("j", "int", rng.integers(-5, 6, n, dtype=np.int32))
    big = rng.integers(2**30, i32.max, n, dtype=np.int32)
    big[::3] = -big[::3]
    big[::7] = i32.min
    col("big", "int", big)
    f = (rng.standard_normal(n) * 100).astype(np.float32)
    f[::11] = 0.0
    f[::13] = -0.0
    col("f", "float", f)
    g = rng.integers(-4, 5, n).astype(np.float32) * np.float32(0.75)
    col("g", "float", g)
    col("b", "bool", rng.integers(0, 2, n, dtype=np.int32))
    words = sorted({""} | {f"{c}{d}" for c in "abcdefghijklmnopqrstu" for d in range(3)})
    col("s", "str", rng.integers(0, len(words), n, dtype=np.int32), words)
    col("lat", "float", rng.uniform(-85, 85, n).astype(np.float32))
    col("lng", "float", rng.uniform(-180, 180, n).astype(np.float32))
    return snap


def distance_band(np, d64, r: float):
    """Slots whose float64 distance (km) lies within 0.01 km + 1e-5·r of
    the radius r (km): the only ones where a float32 mask may differ (the
    kernels' and the libraries' sin/cos/asin differ in the last bits)."""
    return np.abs(d64 - r) <= 0.01 + 1e-5 * r


def _k15_band(np, snap, ids, rows, where):
    """The boundary band of a distance() WHERE of K15_WHERES, per slot."""
    other, scale, r = K15_DIST[where]
    lat, lng = snap.v_columns["lat"].values, snap.v_columns["lng"].values
    n = lat.shape[0]
    at = np.clip(ids, 0, n - 1)
    if other == "bind":
        rr = np.clip(rows, 0, n - 1)
        d = numpy_distance_km(lat[at], lng[at], lat[rr], lng[rr])
    else:
        d = numpy_distance_km(lat[at], lng[at], other[0], other[1])
    return distance_band(np, d, r / scale)


def check_predicate_kernel(np, torch, K, n: int, seed: int = 15, device: str = "cuda"):
    """K15 against `plain_predicate_eval` on ``n`` synthetic slots: each
    WHERE of `K15_WHERES` compiled (padding not ANDed in, so padding reads
    are exercised), over ids with -1 and past-end entries and in identity
    mode (a third of the slots past ``n_valid``), with slot-aligned binding
    rows, the WHILE level and a parameter row; values and masks exactly,
    distance() masks outside the boundary band. Also the class-closure
    lookup, and the ~50-instruction program forced into split launches
    (stack 4, 8 buffers) against itself unsplit. Returns (band slots,
    programs checked, the long program's instruction count). On a CPU
    ``device`` both sides are the plain version: the compile and the splits
    are what is checked there."""
    from orientdb_tpu_torch.ops.device_graph import DeviceGraph
    from orientdb_tpu_torch.ops.predicates import (
        ColumnScope, ParamBox, Predicate, class_term, compile_where, valid_term,
    )
    from orientdb_tpu_torch.sql.parser import parse

    dev = torch.device(device)
    snap = k15_snapshot(np, n, seed)
    dg = DeviceGraph(snap, dev)
    rng = np.random.default_rng(seed + 1)
    ids_np = rng.integers(-1, n + 3, n).astype(np.int32)
    ids_np[::17] = -1
    rows_np = rng.integers(-1, n + 2, n).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    env = {"bindings": {"p": torch.from_numpy(rows_np).to(dev)}, "depth": K15_DEPTH}
    box = ParamBox(K15_PARAMS)
    scope = ColumnScope(
        dg.columns, dg.non_columnar, device=dev, binding_columns=dg.columns, visible_aliases={"p"}
    )
    base, n_valid = 5, n - n // 3
    band_total, checked = 0, 0

    def run(pred, fn, mode):
        """Every launch of ``pred``, kernel and plain on the same inputs
        (the kernel's splits feed both); returns the two final outputs."""
        a = (ids, n, n, 0) if mode == "ids" else (None, n, n_valid, base)
        row = box.row(dev) if pred.uses_params else None
        tmps, got = [], None
        for prog in pred.programs:
            bufs = prog.buffers(env, tmps, n)
            got = K.predicate_eval(prog.prog, bufs, *a, K15_DEPTH, row, values=True)
            want = fn(prog.prog, bufs, *a, K15_DEPTH, row, values=True)
            tmps.append(got)
            yield prog, got, want

    for where in K15_WHERES + ["class"]:
        if where == "class":
            pred = Predicate([valid_term(), class_term(dg.v_class, dg.class_table("A"))], dev)
        else:
            term = compile_where(parse(f"SELECT FROM V WHERE {where}").where, scope, box, allow_depth=True)
            pred = Predicate([term], dev, box, uses_bindings=True)
        for mode in ("ids", "identity"):
            for prog, (gv, gp), (wv, wp) in run(pred, K.plain_predicate_eval, mode):
                checked += 1
                if where not in K15_DIST:
                    _require(torch.equal(gv, wv) and torch.equal(gp, wp), f"K15 {where!r} ({mode}) differs from plain")
                    continue
                diff = (gp != wp).cpu().numpy()
                slot_ids = ids_np if mode == "ids" else np.where(np.arange(n) < n_valid, np.arange(n) + base, -1)
                band = _k15_band(np, snap, slot_ids, rows_np, where)
                _require(not (diff & ~band).any(), f"K15 {where!r} ({mode}) differs outside the band")
                band_total += int(band.sum())
    # the long program, split into launches of stack 4 and 8 buffers
    long_term = lambda: compile_where(parse(f"SELECT FROM V WHERE {K15_WHERES[-1]}").where, scope, box)  # noqa: E731
    whole = Predicate([long_term()], dev, box, uses_bindings=True)
    split = Predicate([long_term()], dev, box, uses_bindings=True, max_stack=4, max_bufs=8)
    _require(len(split.programs) > 1 and len(whole.programs) == 1, "the long program did not split")
    for mode in ("ids", "identity"):
        a = (ids, env) if mode == "ids" else None
        got_whole = whole(*a) if a else whole.identity(n, n_valid, base, env)
        got_split = split(*a) if a else split.identity(n, n_valid, base, env)
        _require(torch.equal(got_whole, got_split), f"K15 split launches differ from one launch ({mode})")
    return band_total, checked, len(whole.programs[0].prog.rows)


#: K15's lane form: the WHEREs of `K15_WHERES` that read parameters, and
#: more (string ranks, arithmetic, binding rows, NOT and OR around them)
K15_LANE_WHERES = [w for w in K15_WHERES if ":" in w] + [
    "s >= 'm' AND i > :k",
    "i + :k > j * 2 OR f IS NULL",
    "NOT (f > :x) AND (b = :t OR g < :y)",
    "i < p.i + :k AND lat > :x",
]


def k15_lane_params(lanes: int):
    """``lanes`` parameter sets around `K15_PARAMS`, one a lane."""
    return [
        {"k": 17 + 3 * b, "x": 48.0 - b, "y": 2.0 + 0.5 * b, "r": 2500.0 - 100.0 * b, "t": b % 2 == 0}
        for b in range(lanes)
    ]


def check_predicate_lanes(np, torch, K, n: int, lanes: int, seed: int = 15, device: str = "cuda"):
    """K15's lane form on ``n`` synthetic slots (`k15_snapshot`): each WHERE
    of `K15_LANE_WHERES` against a ``[lanes, P]`` parameter stack, over ids
    with -1 and past-end entries and in identity mode, with binding rows:
    row b equals the single-lane kernel on parameter row b exactly, and the
    plain version's lane b exactly (distance() outside the boundary band of
    lane b's point and radius). Returns (band slots, programs checked). On a
    CPU ``device`` both sides are plain versions."""
    from orientdb_tpu_torch.ops.device_graph import DeviceGraph
    from orientdb_tpu_torch.ops.predicates import ColumnScope, ParamBox, Predicate, compile_where, pack_params
    from orientdb_tpu_torch.sql.parser import parse

    dev = torch.device(device)
    snap = k15_snapshot(np, n, seed)
    dg = DeviceGraph(snap, dev)
    rng = np.random.default_rng(seed + 2)
    ids_np = rng.integers(-1, n + 3, n).astype(np.int32)
    rows_np = rng.integers(-1, n + 2, n).astype(np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    env = {"bindings": {"p": torch.from_numpy(rows_np).to(dev)}, "depth": K15_DEPTH}
    params = k15_lane_params(lanes)
    lat, lng = snap.v_columns["lat"].values, snap.v_columns["lng"].values
    base, n_valid = 5, n - n // 3
    band_total, checked = 0, 0
    for where in K15_LANE_WHERES:
        box = ParamBox(params[0])
        scope = ColumnScope(
            dg.columns, dg.non_columnar, device=dev, binding_columns=dg.columns, visible_aliases={"p"}
        )
        term = compile_where(parse(f"SELECT FROM V WHERE {where}").where, scope, box, allow_depth=True)
        pred = Predicate([term], dev, box, uses_bindings=True)
        _require(pred.uses_params and pred.lane_ok, f"K15 lanes: {where!r} is not a lane-form program")
        (prog,) = pred.programs
        stack = torch.from_numpy(np.stack([pack_params(p, box.used) for p in params])).to(dev)
        for mode in ("ids", "identity"):
            a = (ids, n, n, 0) if mode == "ids" else (None, n, n_valid, base)
            bufs = prog.buffers(env, [], n)
            got = K.predicate_eval(prog.prog, bufs, *a, K15_DEPTH, stack)
            want = K.plain_predicate_eval_lanes(prog.prog, bufs, *a, K15_DEPTH, stack)
            _require(got.shape == (lanes, n), f"K15 lanes {where!r}: shape {tuple(got.shape)}")
            slot_ids = ids_np if mode == "ids" else np.where(np.arange(n) < n_valid, np.arange(n) + base, -1)
            at = np.clip(slot_ids, 0, n - 1)
            for b in range(lanes):
                one = K.predicate_eval(prog.prog, bufs, *a, K15_DEPTH, stack[b])
                _require(torch.equal(got[b], one), f"K15 lanes {where!r} ({mode}) lane {b} != the single kernel")
                diff = (got[b] != want[b]).cpu().numpy()
                if "distance" not in where:
                    _require(not diff.any(), f"K15 lanes {where!r} ({mode}) lane {b} differs from plain")
                    continue
                p = params[b]
                band = distance_band(np, numpy_distance_km(lat[at], lng[at], p["x"], p["y"]), p["r"])
                _require(not (diff & ~band).any(), f"K15 lanes {where!r} ({mode}) lane {b} differs outside the band")
                band_total += int(band.sum())
            checked += 1
    return band_total, checked


#: K15's stacked form: `K15_LANE_WHERES`, then the long WHERE of
#: `K15_WHERES` with parameters and binding rows, split into launches of
#: stack 4 and 8 buffers (each launch's [B, n] values read by the next)
K15_STACKED_LONG = K15_WHERES[-1] + " AND i < p.i + :k AND f > :x"


def check_predicate_stacked(np, torch, K, n: int, lanes: int, seed: int = 15, device: str = "cuda"):
    """K15's stacked form on ``lanes`` × ``n`` synthetic slots
    (`k15_snapshot`): each WHERE of `K15_LANE_WHERES` and the split
    `K15_STACKED_LONG` over lane-stacked ids (each lane its own, with -1
    and past-end entries; lane 0 all padding) and in identity mode, with
    lane-stacked binding rows, against a ``[lanes, P]`` parameter stack:
    every launch's lane b equals the single kernel on lane b's ids, rows,
    earlier values and parameter row exactly, and the plain version's lane
    b exactly (a distance() mask outside lane b's boundary band); over ids
    the mask through `Predicate` (the engine's path) equals the launches'.
    Returns (band slots, launches checked). On a CPU ``device`` both sides
    are plain versions."""
    from orientdb_tpu_torch.ops.device_graph import DeviceGraph
    from orientdb_tpu_torch.ops.predicates import ColumnScope, ParamBox, Predicate, compile_where, pack_params
    from orientdb_tpu_torch.sql.parser import parse

    dev = torch.device(device)
    snap = k15_snapshot(np, n, seed)
    dg = DeviceGraph(snap, dev)
    rng = np.random.default_rng(seed + 3)
    ids_np = rng.integers(-1, n + 3, (lanes, n)).astype(np.int32)
    ids_np[0] = -1
    rows_np = rng.integers(-1, n + 2, (lanes, n)).astype(np.int32)
    ids, rows = torch.from_numpy(ids_np).to(dev), torch.from_numpy(rows_np).to(dev)
    params = k15_lane_params(lanes)
    lat, lng = snap.v_columns["lat"].values, snap.v_columns["lng"].values
    base, n_valid = 5, n - n // 3
    band_total, checked = 0, 0
    for where in K15_LANE_WHERES + [K15_STACKED_LONG]:
        split = where == K15_STACKED_LONG
        box = ParamBox(params[0])
        scope = ColumnScope(
            dg.columns, dg.non_columnar, device=dev, binding_columns=dg.columns, visible_aliases={"p"}
        )
        term = compile_where(parse(f"SELECT FROM V WHERE {where}").where, scope, box, allow_depth=True)
        kw = dict(max_stack=4, max_bufs=8) if split else {}
        pred = Predicate([term], dev, box, uses_bindings=True, **kw)
        _require(pred.uses_params and (len(pred.programs) > 1) == split, f"K15 stacked: {where!r} programs")
        stack = torch.from_numpy(np.stack([pack_params(p, box.used) for p in params])).to(dev)
        for mode in ("ids", "identity"):
            env = {"bindings": {"p": rows}, "depth": K15_DEPTH}
            a = (ids, n, n, 0) if mode == "ids" else (None, n, n_valid, base)
            tmps, singles = [], [[] for _ in range(lanes)]
            for prog in pred.programs:
                bufs = prog.buffers(env, tmps, n)
                got = K.predicate_eval_stacked(prog.prog, bufs, *a, K15_DEPTH, stack, values=True)
                want = K.plain_predicate_eval_stacked(prog.prog, bufs, *a, K15_DEPTH, stack, values=True)
                _require(got[1].shape == (lanes, n), f"K15 stacked {where!r}: shape {tuple(got[1].shape)}")
                for b in range(lanes):
                    a_b = (ids[b], n, n, 0) if mode == "ids" else a
                    bufs_b = prog.buffers({"bindings": {"p": rows[b]}, "depth": K15_DEPTH}, singles[b], n)
                    one = K.predicate_eval(prog.prog, bufs_b, *a_b, K15_DEPTH, stack[b], values=True)
                    _require(
                        torch.equal(got[0][b], one[0]) and torch.equal(got[1][b], one[1]),
                        f"K15 stacked {where!r} ({mode}) lane {b} != the single kernel",
                    )
                    singles[b].append(one)
                    if "distance" not in where:
                        _require(
                            torch.equal(got[0][b], want[0][b]) and torch.equal(got[1][b], want[1][b]),
                            f"K15 stacked {where!r} ({mode}) lane {b} differs from plain",
                        )
                        continue
                    diff = (got[1][b] != want[1][b]).cpu().numpy()
                    slots = np.arange(n)
                    slot_ids = ids_np[b] if mode == "ids" else np.where(slots < n_valid, slots + base, -1)
                    at = np.clip(slot_ids, 0, n - 1)
                    x, y, r = (40.0, -3.5, 4000.0) if split else (params[b]["x"], params[b]["y"], params[b]["r"])
                    band = distance_band(np, numpy_distance_km(lat[at], lng[at], x, y), r)
                    _require(
                        not (diff & ~band).any(), f"K15 stacked {where!r} ({mode}) lane {b} differs outside the band"
                    )
                    band_total += int(band.sum())
                tmps.append(got)
                checked += 1
            if mode == "ids":
                box.set_row(stack)
                try:
                    mask = pred(ids, env)
                finally:
                    box.reset()
                _require(torch.equal(mask, tmps[-1][1]), f"K15 stacked {where!r}: the Predicate's mask differs")
    return band_total, checked


# ---------------------------------------------------------------------------
# phase 7m: the mesh (A on a 4-shard LocalShards mesh; ME1 on B; MQ2n over a
# one-rank NCCL process group)
# ---------------------------------------------------------------------------

M_SHARDS = 4
MR1 = "MATCH {class:Person, as:p, where:(uid < 2000)}-knows-{as:f} RETURN p.uid AS p, f.uid AS f"
#: BFS roots spread over the four shards' row ranges, depth 3, 2 replicas
MBFS_ROOTS = [0, 1, 1_999_999, 2_000_000, 3_456_789, 4_000_001, 6_000_000, 7_999_999]
MBFS_DEPTH, MBFS_REPLICAS = 3, 2
ME1_PARAMS = [{"d": 12_000}, {"d": 15_000}]


def mesh_twin(db, snap, mesh):
    """A second database over ``snap``'s host arrays (shared, not copied),
    attached with ``mesh``: its device graph is the sharded layout, beside
    the resident single-device one."""
    msnap = copy.copy(snap)
    msnap.__dict__.pop("_plan_cache", None)
    msnap._mesh = None
    mdb = copy.copy(db)
    mdb._snapshot = None
    mdb.attach_snapshot(msnap, mesh=mesh)
    return mdb, msnap


def numpy_mr1_rows(np, snap, k: int):
    """Sorted (p, f) rows of MR1: every out and in edge at p < k."""
    csr = snap.edge_classes["knows"]
    rows = []
    for ip, nb in ((csr.indptr_out, csr.dst), (csr.indptr_in, csr.src)):
        p = np.repeat(np.arange(k), np.diff(ip[: k + 1]))
        rows.append(np.stack([p, nb[ip[0] : ip[k]].astype(np.int64)], 1))
    rows = np.concatenate(rows)
    return rows[np.lexsort(rows.T[::-1])]


def numpy_bfs(np, snap, roots, depth: int):
    """visited [Q, V] of a breadth-first walk over the out-CSR from each
    root, ``depth`` hops, the root included."""
    csr = snap.edge_classes["knows"]
    ip = csr.indptr_out.astype(np.int64)
    V = snap.num_vertices
    out = np.zeros((len(roots), V), bool)
    for q, r in enumerate(roots):
        frontier = np.array([r], np.int64)
        out[q, r] = True
        for _ in range(depth):
            nxt = np.unique(csr_neighbours(np, ip, csr.dst, frontier))
            nxt = nxt[~out[q, nxt]]
            out[q, nxt] = True
            frontier = nxt
    return out


def _mesh_cell(np, torch, K, TE, db, snap, name, sql, params, check, single_ms, card, uncaptured=False):
    """One mesh cell through the front door: the recording (+ capture),
    then 5 replays, each checked; prints the times beside the single-device
    replay median, the busy share and the launches per replay. Returns the
    rows."""
    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    rows = db.query(sql, params).to_dicts()
    sync()
    first_ms = (time.perf_counter() - t0) * 1e3
    check(rows)
    plan = _only_plan(TE, snap, sql).plans[0]
    captured = db.device.type == "cuda" and not uncaptured
    _require((plan.graph is not None) == captured and plan.replays == 0, f"{name}: capture state")
    times = []
    before = dict(K.LAUNCHES)
    for _ in range(5):
        t0 = time.perf_counter()
        rows = db.query(sql, params).to_dicts()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        check(rows)
    _require(plan.replays == 5 and len(_only_plan(TE, snap, sql).plans) == 1, f"{name}: replays {plan.replays}")
    per = plan.launches if not uncaptured else {
        k: (K.LAUNCHES[k] - before[k]) // 5 for k in K.LAUNCHES if K.LAUNCHES[k] != before[k]
    }
    med = statistics.median(times)
    cap = plan.capture_ms or 0.0
    print(
        f"mesh {name}: record {first_ms - cap:.3f} ms, capture {cap:.3f} ms, replay median {med:.3f} ms "
        f"(runs {[round(t, 3) for t in times]}) against the single-device replay {single_ms:.3f} ms; "
        f"launches per replay {sum(per.values())} {per} [{card}]"
    )
    print(f"mesh device {name}: {device_share(torch, db, sql, params, med)}")
    return rows


def _single_ms(torch, db, sql, params) -> float:
    """Median of 5 single-device replays of a cached statement."""
    db.query(sql, params).to_dicts()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        db.query(sql, params).to_dicts()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_mesh(np, torch, K, TE, ks, db, snap, card: str, vref: VRef):
    """Phase 7m: A's twin on a 4-shard `LocalShards` mesh on the card. The
    cells MQ1–MQ3, MR1, MV1, MTR1 through ``db.query`` (recorded, captured,
    5 replays) and MBFS through `bfs_reachability`, each equal to numpy and
    to the single-device port's answer on A in this run; the launch counts
    zeroed just before the cells and read just after. Then the mesh kernels
    against their plain versions at the cells' shapes, and MQ2n: MQ2 and
    MBFS over a one-rank NCCL `ProcessShards` group. Returns the cells'
    launches."""
    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.parallel.sharded import ShardedCSR, bfs_reachability, make_mesh

    sync = torch.cuda.synchronize
    V = snap.num_vertices
    age = snap.v_columns["age"].values
    t0 = time.perf_counter()
    mdb, msnap = mesh_twin(db, snap, make_mesh(M_SHARDS))
    mdg = device_graph(msnap, mdb.device)
    sync()
    sh_bytes = sum(a.numel() * a.element_size() for k, a in mdg.arrays.items() if k.startswith("sh:"))
    knows = sum(
        a.numel() * a.element_size() for k, a in mdg.arrays.items() if k.startswith("sh:knows:")
    )
    a_bytes = device_graph(snap, db.device).memory_report()["total_bytes"]
    print(
        f"mesh: {M_SHARDS} shards of R={mdg.mesh_graph.rows_per_shard} rows; sharded layout {sh_bytes} bytes "
        f"(knows {knows}, {knows // M_SHARDS} a shard; out emax {mdg.mesh_graph.edge['knows'].out_emax}, "
        f"edge-list slice W={mdg.mesh_graph.edge['knows'].e_slice}) beside A's {a_bytes} resident; "
        f"built and uploaded in {time.perf_counter() - t0:.1f} s [{card}]"
    )
    t0 = time.perf_counter()
    want = {
        "MQ1": [{"n": numpy_1hop_count(snap, age > 40, age < 30)}],
        "MQ2": [{"n": numpy_2hop_count(snap, age > 40, np.ones(V, bool), age < 30)}],
    }
    q3_rows, mr1_rows = numpy_q3_rows(np, snap, Q3_K), numpy_mr1_rows(np, snap, 2000)
    csr = snap.edge_classes["knows"]
    out_nb = lambda f: csr_neighbours(np, csr.indptr_out.astype(np.int64), csr.dst, f)  # noqa: E731
    tr1_ids, _ = numpy_traverse(np, V, np.arange(50), out_nb, admit=lambda d: d < 2)
    roots = np.zeros((len(MBFS_ROOTS), V), bool)
    roots[np.arange(len(MBFS_ROOTS)), MBFS_ROOTS] = True
    bfs_want = numpy_bfs(np, snap, MBFS_ROOTS, MBFS_DEPTH)
    print(f"numpy references of the mesh cells: {time.perf_counter() - t0:.1f} s")

    cells = {
        "MQ1": (Q1, None, lambda r: _require(r == want["MQ1"], f"MQ1 {r} != numpy {want['MQ1']}")),
        "MQ2": (Q2, None, lambda r: _require(r == want["MQ2"], f"MQ2 {r} != numpy {want['MQ2']}")),
        "MQ3": (Q3, {"k": Q3_K}, lambda r: _require(
            np.array_equal(_sorted_rows(np, r, ("p", "f", "g")), q3_rows), "MQ3 rows differ from numpy")),
        "MR1": (MR1, None, lambda r: _require(
            np.array_equal(_sorted_rows(np, r, ("p", "f")), mr1_rows), "MR1 rows differ from numpy")),
        "MV1": (V1, None, lambda r: vref.check("V1", r, None)),
        "MTR1": (TR1, None, lambda r: _require(
            np.array_equal(np.array([int(x["@rid"].split(":")[1]) for x in r]), tr1_ids),
            "MTR1 records differ from numpy (order included)")),
    }
    single = {}
    for name, (sql, params, check) in cells.items():
        rows = db.query(sql, params).to_dicts()
        check(rows)
        single[name] = (rows, _single_ms(torch, db, sql, params))

    def same_as_single(name, rows):
        key = (lambda r: tuple(sorted(map(str, r.items())))) if name != "MTR1" else None
        a, b = (rows, single[name][0]) if key is None else (sorted(rows, key=key), sorted(single[name][0], key=key))
        _require(a == b, f"{name}: the mesh's rows differ from the single-device port's")

    # the main path: counts zeroed just before, read just after
    sync()
    K.reset_launches()
    t_cells = time.perf_counter()
    for name, (sql, params, check) in cells.items():
        rows = _mesh_cell(np, torch, K, TE, mdb, msnap, name, sql, params, check, single[name][1], card)
        same_as_single(name, rows)
    scsr = ShardedCSR.from_snapshot(msnap, make_mesh(M_SHARDS, MBFS_REPLICAS), "knows")
    times = []
    for _ in range(3):
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        got = bfs_reachability(scsr, roots, MBFS_DEPTH)
        times.append((time.perf_counter() - t0) * 1e3)
        _require(np.array_equal(got, bfs_want), "MBFS differs from numpy")
    per = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES if K.LAUNCHES[k] != before[k]}
    print(
        f"mesh MBFS: {len(MBFS_ROOTS)} roots, depth {MBFS_DEPTH}, replicas {MBFS_REPLICAS}: "
        f"{int(got.sum())} reached; {[round(t, 3) for t in times]} ms a call (host clock, with the "
        f"upload of the roots and the fetch of [Q, V]); launches a call {sum(per.values())} {per} [{card}]"
    )
    mbfs = lambda: bfs_reachability(scsr, roots, MBFS_DEPTH)  # noqa: E731
    print(f"mesh device MBFS: {busy_share(torch, mbfs, statistics.median(times))}")
    sync()
    launches = dict(K.LAUNCHES)
    missing = [n for n in MESH_ONLY if launches[n] == 0]
    _require(not missing, f"mesh kernels never launched on the mesh path: {missing}")
    print(
        f"mesh cells: {time.perf_counter() - t_cells:.1f} s; launches "
        f"{ {n: launches[n] for n in MESH_ONLY} }, all {sum(launches.values())}"
    )
    check_mesh_kernels(np, torch, K, ks, mdg, msnap, roots)
    TE._plan_cache(msnap).clear()
    del mdb, msnap, mdg, scsr
    gc.collect()
    gc.collect()
    sync()
    torch.cuda.empty_cache()
    run_mesh_nccl(np, torch, K, TE, db, snap, card, want["MQ2"], roots, bfs_want)
    return launches


def run_mesh_nccl(np, torch, K, TE, db, snap, card, mq2_want, roots, bfs_want) -> None:
    """MQ2n: MQ2 and MBFS on a one-rank NCCL process group
    (`ProcessShards`: the same kernels, merged by NCCL collectives, the
    plan replayed uncaptured)."""
    import tempfile

    import torch.distributed as dist

    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.parallel.sharded import ShardedCSR, bfs_reachability, make_mesh

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous", rank=0, world_size=1)
        try:
            group = dist.group.WORLD
            ndb, nsnap = mesh_twin(db, snap, make_mesh(1, group=group))
            device_graph(nsnap, ndb.device)
            single_ms = _single_ms(torch, db, Q2, None)
            _mesh_cell(
                np, torch, K, TE, ndb, nsnap, "MQ2n", Q2, None,
                lambda r: _require(r == mq2_want, f"MQ2n {r} != numpy {mq2_want}"), single_ms, card,
                uncaptured=True,
            )
            scsr = ShardedCSR.from_snapshot(nsnap, make_mesh(1, MBFS_REPLICAS, group=group), "knows")
            t1 = time.perf_counter()
            got = bfs_reachability(scsr, roots, MBFS_DEPTH)
            _require(np.array_equal(got, bfs_want), "MBFS over NCCL differs from numpy")
            print(f"mesh MBFS over NCCL: {(time.perf_counter() - t1) * 1e3:.3f} ms [{card}]")
            TE._plan_cache(nsnap).clear()
            del ndb, nsnap, scsr
        finally:
            dist.destroy_process_group()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"mesh MQ2n phase: {time.perf_counter() - t0:.1f} s")


def check_mesh_kernels(np, torch, K, ks, mdg, msnap, roots) -> None:
    """K2's range form and K22 at MQ3's second hop (its ~20k sources, out
    and in), K10's eid form at MV1's 8-row frontiers (and with an edge mask
    and a gate), K23 at MQ2's pass over the 80M-edge slices (int32; the
    float32 twin to rtol 1e-6) and K24 at MBFS's first hop, each against
    its plain version exactly, then timed beside its bound (counted from
    these inputs at 3.35 TB/s); their launches are not counted."""
    counted = dict(K.LAUNCHES)
    dev = mdg.device
    A = mdg.arrays
    S = M_SHARDS
    csr = msnap.edge_classes["knows"]
    V = msnap.num_vertices
    vb = K.bucket(V)
    span = A["sh:rowspan"]
    # MQ3's second hop: the friends of uid < 2000
    srcs = torch.from_numpy(csr.dst[: csr.indptr_out[Q3_K]].astype(np.int32)).to(dev)
    n = srcs.shape[0]
    for d, extra in (("out", "ebase"), ("in", "eid")):
        ind, nbr, ex = A[f"sh:knows:{d}:indptr"], A[f"sh:knows:{d}:nbr"], A[f"sh:knows:{d}:{extra}"]
        counts, tots = K.degree_counts_range(ind, span, srcs)
        ks.same("degree_counts_range", (counts, tots), K.plain_degree_counts_range(ind, span, srcs))
        offsets = K.exclusive_cumsum(counts.view(-1))
        total, mx = int(tots.sum()), int(tots.max())
        for cap, cap_total in ((K.bucket(mx), K.bucket(total)), (max(mx // 2, 1), max(total // 3, 1))):
            for plus_one in (False, True):
                args = (ind, nbr, ex, span, srcs, offsets, tots, 0, cap, cap_total, d == "out", plus_one)
                ks.same("shard_gather", K.shard_gather(*args), K.plain_shard_gather(*args))
        if d == "out":
            g_args = (ind, nbr, ex, span, srcs, offsets, tots, 0, K.bucket(mx), K.bucket(total), True, False)
            g_total, g_cap_total = total, K.bucket(total)
            r_args = (ind, span, srcs)
    ks.timed(
        "degree_counts_range",
        lambda: K.degree_counts_range(*r_args),
        lambda: K.plain_degree_counts_range(*r_args),
        None,
        4 * n + 8 * n + 4 * S * n,
    )
    ks.timed(
        "shard_gather",
        lambda: K.shard_gather(*g_args),
        lambda: K.plain_shard_gather(*g_args),
        None,
        12 * g_cap_total + 4 * n * (S + 2) + 4 * g_total,
    )
    # MV1's frontiers: 8 rows, each a root's out-neighbours
    el = [A[f"sh:knows:el:{k}"] for k in ("src", "dst", "eid")]
    ip = csr.indptr_out
    fr = torch.zeros((8, vb), dtype=torch.bool, device=dev)
    for c in range(8):
        fr[c, torch.from_numpy(csr.dst[ip[c] : ip[c + 1]].astype(np.int64)).to(dev)] = True
    gen = torch.Generator(device=dev).manual_seed(23)
    emask = torch.rand(csr.num_edges, generator=gen, device=dev) < 0.7
    gate = torch.rand(vb, generator=gen, device=dev) < 0.8
    sh = {
        d: tuple(A[f"sh:knows:{d}:{k}"] for k in ("indptr", "nbr", x)) + (d == "out",)
        for d, x in (("out", "ebase"), ("in", "eid"))
    }
    for d, (a, e) in (("out", (el[0], el[1])), ("in", (el[1], el[0]))):
        for f in (fr, torch.zeros_like(fr)):
            for m, g in ((None, None), (emask, None), (emask, gate)):
                got = K.bitmap_hop_shard(*sh[d], 0, m, f, g)
                ks.same("bitmap_hop_shard", got, K.plain_bitmap_hop_shard(*sh[d], 0, m, f, g))
                # the slot walk over the edge-list slices it replaces
                ks.same("bitmap_hop_shard", got, K.plain_bitmap_hop_eid(a, e, el[2], m, f, g))
    av = np.nonzero(fr.any(0).cpu().numpy())[0]
    act_edges = int((ip[av + 1] - ip[av]).sum())
    sp = _in_adjacency(np, torch, csr, vb, dev, "bitmap_hop_shard")
    fr_t = fr.t().float().contiguous()
    k10 = lambda: K.bitmap_hop_shard(*sh["out"], 0, None, fr)  # noqa: E731
    ks.timed(
        "bitmap_hop_shard",
        k10,
        lambda: K.plain_bitmap_hop_shard(*sh["out"], 0, None, fr),
        None if sp is None else (lambda: torch.sparse.mm(sp, fr_t)),
        # the frontier read over the held rows and the result written once;
        # the indptr pair at an active vertex; the neighbours of its edges
        2 * fr.numel() + 8 * av.shape[0] + 4 * act_edges,
    )
    r = ks.rows["bitmap_hop_shard"]
    print(
        f"kernel bitmap_hop_shard: equals its plain push and the slot walk over the edge-list slices (MV1's "
        f"level-1 frontiers: {av.shape[0]} active vertices, {act_edges} edges; out and in, an edge mask, a "
        f"gate, an empty frontier); {r['ms']:.4f} ms ({_graph_ms(torch, k10):.4f} in a graph), bound "
        f"{r['bound_ms']:.4f}, plain {r['plain_ms']:.4f}, library {r['library_ms']}"
    )
    del sp
    # MQ2's weight pass: ok = age < 30 over the universe, w a weight vector
    age = torch.from_numpy(msnap.v_columns["age"].values).to(dev)
    ok = torch.zeros(vb, dtype=torch.bool, device=dev)
    ok[:V] = age < 30
    w_i = torch.randint(0, 40, (vb,), generator=gen, device=dev, dtype=torch.int32)
    check_weight_pass(torch, K, ks, sh, el, ok, w_i, emask)
    skew, skew_el, hub_v, hub_deg = sharded_graph(torch, gen, 2_000_000, S, 10.0, hub=(499_999, 1_000_000))
    vb_s = K.bucket(2_000_000)
    ok_s = torch.rand(vb_s, generator=gen, device=dev) < 0.7
    w_s = torch.randint(-5, 40, (vb_s,), generator=gen, device=dev, dtype=torch.int32)
    m_s = torch.rand(int((skew_el[0] >= 0).sum()), generator=gen, device=dev) < 0.7
    check_weight_pass(torch, K, ks, skew, skew_el, ok_s, w_s, m_s)
    print(f"kernel shard_weight_pass: the one-hub case (V 2,000,000 over {S} shards, vertex {hub_v} holding "
          f"{hub_deg} edges at its shard's end) equals both plain walks")
    del skew, skew_el
    time_weight_pass(torch, K, ks, sh, el, ok, w_i, emask, V)
    # MBFS's first hop: the roots of one replica block, [S, Q, R]; its second
    # hop (after one level step), every query lit on one row, 33 queries
    ind, dst = A["sh:knows:out:indptr"], A["sh:knows:out:nbr"]
    R = ind.shape[1] - 1
    qb = len(MBFS_ROOTS) // MBFS_REPLICAS
    block = np.zeros((qb, S * R), bool)
    block[:, :V] = roots[:qb]
    f0 = torch.from_numpy(np.ascontiguousarray(block.reshape(qb, S, R).transpose(1, 0, 2))).to(dev)
    f1 = K.rowshard_hop(ind, dst, f0, S)
    K.frontier_advance(f1.view(S * qb, R), f0.clone().view(S * qb, R))
    one = torch.zeros_like(f0)
    one[1, :, 12_345] = True
    f33 = torch.zeros((S, 33, R), dtype=torch.bool, device=dev)
    f33.view(-1)[torch.randint(0, f33.numel(), (330,), generator=gen, device=dev)] = True
    for f in (f0, f1, one, f33, torch.zeros_like(f0)):
        ks.same("rowshard_hop", K.rowshard_hop(ind, dst, f, S), K.plain_rowshard_hop(ind, dst, f, S))
    ipl = ip.astype(np.int64)

    def lit_of(f):
        lit = f.any(1).view(-1).nonzero().view(-1).cpu().numpy()
        return lit.shape[0], int((ipl[lit + 1] - ipl[lit]).sum())

    n_lit, lit_edges = lit_of(f0)
    sp = _in_adjacency(np, torch, csr, S * R, dev, "rowshard_hop")
    f0_t = f0.permute(0, 2, 1).reshape(S * R, qb).float().contiguous()
    ks.timed(
        "rowshard_hop",
        lambda: K.rowshard_hop(ind, dst, f0, S),
        lambda: K.plain_rowshard_hop(ind, dst, f0, S),
        None if sp is None else (lambda: torch.sparse.mm(sp, f0_t)),
        # the frontier read and the result written once, indptr a lit row, dst a lit edge
        2 * f0.numel() + 8 * n_lit + 4 * lit_edges,
    )
    r = ks.rows["rowshard_hop"]
    line = [f"MBFS's first hop ({n_lit} lit rows, {lit_edges} edges) {r['ms']:.4f} ms eager, "
            f"{_graph_ms(torch, lambda: K.rowshard_hop(ind, dst, f0, S)):.4f} in a graph, bound {r['bound_ms']:.4f}"]
    for name, f in (("its second hop", f1), ("every query on one row", one), ("Q=33", f33)):
        fn = lambda f=f: K.rowshard_hop(ind, dst, f, S)  # noqa: E731
        n_lit, lit_edges = lit_of(f)
        bound = (2 * f.numel() + 8 * n_lit + 4 * lit_edges) / HBM_BYTES_PER_S * 1e3
        line.append(f"{name} ({n_lit} lit rows, {lit_edges} edges) {_time_ms(torch, fn):.4f} / "
                    f"{_graph_ms(torch, fn):.4f}, bound {bound:.4f}")
    print(f"kernel rowshard_hop: equals its plain version on each frontier (and an empty one); " + "; ".join(line)
          + f"; plain {r['plain_ms']:.4f}, library {r['library_ms']}")
    del sp
    K.LAUNCHES.update(counted)
    print("mesh kernels: K2's range form, K22, K10's eid form (the push), K23 and K24 equal their plain versions")


def sharded_graph(torch, gen, v: int, s: int, avg: float, hub=None):
    """A random graph's mesh arrays on ``gen``'s device, laid out as
    `MeshGraph.build` lays them out: Poisson(avg) out-degrees (vertex
    ``hub[0]`` holding ``hub[1]`` edges), random targets; per direction the
    row-sharded CSR ``(indptr [S, R+1], nbr [S, emax], extra, is_out)``
    (``extra`` the shards' first edge ids out, the in CSR's out-order ids
    in) and the edge-list slices ``(src, dst, eid)`` [S, W]. Returns (csr
    by direction, slices, hub vertex, hub degree)."""
    dev, i32 = gen.device, torch.int32
    deg = torch.poisson(torch.full((v,), float(avg), device=dev), generator=gen).long()
    if hub is not None:
        deg[hub[0]] = hub[1]
    indptr = torch.cat([torch.zeros(1, dtype=torch.long, device=dev), torch.cumsum(deg, 0)])
    ne = int(indptr[-1])
    dst = torch.randint(0, v, (ne,), generator=gen, device=dev, dtype=i32)
    src = torch.repeat_interleave(torch.arange(v, dtype=i32, device=dev), deg)
    order = torch.sort(dst, stable=True).indices
    indptr_in = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                           torch.cumsum(torch.bincount(dst.long(), minlength=v), 0)])
    r = -(-v // s)
    csr = {}
    for d, ip, nb, ex in (("out", indptr, dst, None), ("in", indptr_in, src[order], order.to(i32))):
        cuts = [(min(h * r, v), min(h * r + r, v)) for h in range(s)]
        emax = max(1, max(int(ip[r1] - ip[r0]) for r0, r1 in cuts))
        ind = torch.zeros((s, r + 1), dtype=i32, device=dev)
        nbr = torch.full((s, emax), -1, dtype=i32, device=dev)
        eid = torch.full((s, emax), -1, dtype=i32, device=dev)
        for h, (r0, r1) in enumerate(cuts):
            seg = ip[r0 : r1 + 1] - ip[r0]
            ind[h, : seg.numel()] = seg.to(i32)
            ind[h, seg.numel():] = int(seg[-1])
            a, b = int(ip[r0]), int(ip[r1])
            nbr[h, : b - a] = nb[a:b]
            if ex is not None:
                eid[h, : b - a] = ex[a:b]
        extra = torch.tensor([[int(ip[r0])] for r0, _ in cuts], dtype=i32, device=dev) if ex is None else eid
        csr[d] = (ind, nbr, extra, d == "out")
    w = -(-ne // s)
    pad = s * w - ne

    def sliced(t):
        return torch.cat([t, torch.full((pad,), -1, dtype=i32, device=dev)]).view(s, w)

    el = (sliced(src), sliced(dst), sliced(torch.arange(ne, dtype=i32, device=dev)))
    return csr, el, (hub[0] if hub else None), (hub[1] if hub else None)


def check_weight_pass(torch, K, ks, sh, el, ok, w_i, emask) -> None:
    """K23 over the row-sharded CSR ``sh`` (by direction) against its plain
    CSR walk and the slices' walk ``el``, exactly in int32 (out and in,
    with and without an edge mask, ``w`` None and given, the vertex mask
    folded in), float32 to rtol 1e-6 and bit for bit between two calls."""
    dev, vb = ok.device, ok.shape[0]
    zeros = lambda dt=torch.int32: torch.zeros(vb, dtype=dt, device=dev)  # noqa: E731
    every = torch.ones_like(ok)
    w_f = w_i.float() * 0.37
    for d, (a, e) in (("out", (el[0], el[1])), ("in", (el[1], el[0]))):
        for m in (None, emask):
            for w in (None, w_i):
                got = K.shard_weight_pass(*sh[d], 0, m, ok, w, zeros())
                ks.same("shard_weight_pass", got, K.plain_shard_weight_pass_csr(*sh[d], 0, m, ok, w, zeros()))
                ks.same("shard_weight_pass", got, K.plain_shard_weight_pass(a, e, el[2], m, ok, w, zeros()))
            # every vertex kept: the kernel folds the mask into the weights
            ks.same("shard_weight_pass", K.shard_weight_pass(*sh[d], 0, m, every, w_i, zeros()),
                    K.plain_shard_weight_pass(a, e, el[2], m, every, w_i, zeros()))
        got = K.shard_weight_pass(*sh[d], 0, None, ok, w_f, zeros(torch.float32))
        ks.same("shard_weight_pass", got, K.plain_shard_weight_pass_csr(*sh[d], 0, None, ok, w_f, zeros(torch.float32)), exact=False)
        ks.same("shard_weight_pass", got, K.plain_shard_weight_pass(a, e, el[2], None, ok, w_f, zeros(torch.float32)), exact=False)
        again = K.shard_weight_pass(*sh[d], 0, None, ok, w_f, zeros(torch.float32))
        _require(torch.equal(got.view(torch.int32), again.view(torch.int32)), "K23's float32 sums differ between calls")


def weight_pass_bytes(sh, vb: int, fold: bool) -> float:
    """K23's bytes at one pass over ``sh`` (a direction's CSR): the indptr
    rows, 4 bytes of nbr an edge, the gathered table once (4 bytes a
    vertex), the output read and written at each held row below vb; with
    the fold, its [vb] pass (the mask and the weights read, the folded
    weights written)."""
    ind, nbr = sh[0], sh[1]
    edges = int(ind[:, -1].long().sum())
    rows = min(ind.shape[0] * (ind.shape[1] - 1), vb)
    return 4.0 * ind.numel() + 4.0 * edges + 4.0 * vb + 8.0 * rows + (9.0 * vb if fold else 0.0)


def time_weight_pass(torch, K, ks, sh, el, ok, w_i, emask, v: int) -> None:
    """K23 at MQ2's pass (out, ok = age < 30, int32 weights), beside its
    byte bound and the random 32-byte sectors its gathers move. Also in a
    graph: MQ2's second pass (every vertex kept: the kernel sequence folds
    the mask into the weights), MQ1's form (``w`` None: the mask alone),
    and in passes without and with an edge mask read through
    ``:in:eid``."""
    dev, vb = ok.device, ok.shape[0]
    out = torch.zeros(vb, dtype=torch.int32, device=dev)

    def mq2(o=ok):
        out.zero_()
        return K.shard_weight_pass(*sh["out"], 0, None, o, w_i, out)

    ks.timed(
        "shard_weight_pass",
        mq2,
        lambda: K.plain_shard_weight_pass_csr(*sh["out"], 0, None, ok, w_i, torch.zeros(vb, dtype=torch.int32, device=dev)),
        None,
        weight_pass_bytes(sh["out"], vb, False),
    )
    every = torch.ones_like(ok)
    forms = {
        "MQ2's pass": mq2,
        "MQ2's second pass (every vertex kept: folded)": lambda: mq2(every),
        "MQ1's form (w None)": lambda: K.shard_weight_pass(*sh["out"], 0, None, ok, None, out),
        "in": lambda: K.shard_weight_pass(*sh["in"], 0, None, ok, w_i, out),
        "in, the edge mask through :in:eid": lambda: K.shard_weight_pass(*sh["in"], 0, emask, ok, w_i, out),
    }
    g = {name: _graph_ms(torch, fn) for name, fn in forms.items()}
    edges = int(sh["out"][0][:, -1].long().sum())
    kept = int(ok[el[1].view(-1)[el[1].view(-1) >= 0].long()].sum())
    r = ks.rows["shard_weight_pass"]
    print(
        f"kernel shard_weight_pass (the segmented sum over the row-sharded CSR): equals both plain walks (out and "
        f"in, an edge mask, w None and given, the fold, int32; float32 to rtol {F32_RTOL}, repeated bit for bit); "
        f"MQ2's pass ({edges} edges, V {v}): {r['ms']:.4f} ms eager; in a graph "
        + "; ".join(f"{k} {x:.4f}" for k, x in g.items())
        + f"; byte bound {r['bound_ms']:.4f} (with the fold, every vertex kept, {weight_pass_bytes(sh['out'], vb, True) / HBM_BYTES_PER_S * 1e3:.4f}); "
        f"{gather_floor(edges, kept)}; plain {r['plain_ms']:.4f}, library {r['library_ms']}"
    )


#: L2's random 32-byte sector rates on the card (80M random gathers through
#: take_pad, NVIDIA H100 80GB HBM3 at 700 W; `PERF.md` §6, K23): tables
#: of 1-16 MiB, and a 32 MiB one
SECTORS_PER_S_SMALL = 125e9
SECTORS_PER_S_32MIB = 85e9


def gather_floor(edges: int, kept: int) -> str:
    """K23's random sectors at MQ2's pass beside their time at L2's
    measured rates: with a sparse mask the kernel gathers the 8 MiB mask at
    every edge and the 32 MiB weights at the kept ones; with a dense one
    the weights alone at every edge."""
    sparse = edges / SECTORS_PER_S_SMALL + kept / SECTORS_PER_S_32MIB
    return (
        f"random 32-byte sectors: {edges} mask gathers + {kept} weight gathers take {sparse * 1e3:.4f} ms at "
        f"L2's measured rates ({SECTORS_PER_S_SMALL / 1e9:.0f}·10^9 a second from an 8 MiB table, "
        f"{SECTORS_PER_S_32MIB / 1e9:.0f}·10^9 from a 32 MiB one); every vertex kept, {edges} weight gathers "
        f"{edges / SECTORS_PER_S_32MIB * 1e3:.4f} ms"
    )


def run_mesh_snb(np, torch, K, TE, sdb, ssnap, card, eref) -> dict:
    """ME1: the config-5 COUNT at two :d values on B's twin on a 4-shard
    mesh (the check `tools/dryrun.py:170-190` runs on the reference's
    mesh), equal to numpy and to the single-device port. Returns its
    launches."""
    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.parallel.sharded import make_mesh

    t0 = time.perf_counter()
    mdb, msnap = mesh_twin(sdb, ssnap, make_mesh(M_SHARDS))
    mdg = device_graph(msnap, mdb.device)
    torch.cuda.synchronize()
    sh_bytes = sum(a.numel() * a.element_size() for k, a in mdg.arrays.items() if k.startswith("sh:"))
    print(f"mesh B: sharded layout {sh_bytes} bytes, built and uploaded in {time.perf_counter() - t0:.1f} s")
    K.reset_launches()
    for p in ME1_PARAMS:
        want = [{"n": eref.want("E1", p)}]
        single = sdb.query(E1, p).to_dicts()
        _require(single == want, f"E1 d={p['d']} {single} != numpy {want}")
        single_ms = _single_ms(torch, sdb, E1, p)
        TE._plan_cache(msnap).clear()
        _mesh_cell(
            np, torch, K, TE, mdb, msnap, f"ME1 d={p['d']}", E1, p,
            lambda r, want=want: _require(r == want, f"ME1 {r} != numpy {want}"), single_ms, card,
        )
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    print(f"mesh ME1 launches { {n: launches[n] for n in MESH_ONLY} }")
    TE._plan_cache(msnap).clear()
    del mdb, msnap, mdg
    gc.collect()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import numpy as np
    import torch

    from orientdb_tpu_torch.ops import _kernels
    from orientdb_tpu_torch.ops import csr as K
    from orientdb_tpu_torch.ops.device_graph import device_graph
    from orientdb_tpu_torch.storage.bigshape import build_person_knows, build_snb_shape
    from orientdb_tpu_torch.utils.config import config

    t_start = time.perf_counter()
    # 1. device
    _require(torch.cuda.is_available(), "CUDA is not available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _kernels.load()
    print(f"build: {time.perf_counter() - t0:.1f} s")

    # the SF100-shape graph (set-up: host build, then upload)
    t0 = time.perf_counter()
    db, snap = build_person_knows(8_000_000, avg_knows=10, seed=5, geo=True)
    # phase 8's twin of A, copied before A's upload: it is padded for
    # deltas before its own; phase 9's, admitted to the tier plane
    ddb = copy.deepcopy(db)
    tdb = copy.deepcopy(db)
    dg = device_graph(snap, db.device)
    torch.cuda.synchronize()
    print(
        f"graph: V={snap.num_vertices} E={snap.edge_classes['knows'].num_edges}, "
        f"built and uploaded in {time.perf_counter() - t0:.1f} s"
    )

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    ks = check_kernels(np, torch, K, dg, card)
    check_bitmap_kernels(torch, K, ks, dg)
    check_forward(np, torch, K, dg, snap, card)
    print(f"kernels: all equal their plain versions ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    vref = VRef(np, snap)
    print(f"numpy references of V1–V3: {time.perf_counter() - t0:.1f} s")

    time_predicate_kernel(np, torch, K, ks, db, card)

    # 4. the recording path through the port's front door (cache off)
    torch.cuda.reset_peak_memory_stats()
    cache_size = config.plan_cache_size
    config.plan_cache_size = 0
    try:
        t0 = time.perf_counter()
        run_slice(np, torch, K, db, snap, card, vref)
        print(f"record phase: {time.perf_counter() - t0:.1f} s")
    finally:
        config.plan_cache_size = cache_size
    pk_mem = dg.memory_report()
    pk_peak = torch.cuda.max_memory_allocated()
    print(
        f"memory: graph {pk_mem['total_bytes']} bytes on the card "
        f"{pk_mem['per_device']}, host-only columns {pk_mem['pruned_bytes']} bytes; "
        f"peak allocated during the recording path {pk_peak} bytes"
    )

    # 5. the replay path: record + capture once, then captured replays
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches, q3_plan, q3_big = run_replay(np, torch, K, db, snap, card, vref)
    print(f"replay phase: {time.perf_counter() - t0:.1f} s")
    print(f"memory: peak allocated during the replay path {torch.cuda.max_memory_allocated()} bytes")
    pk_peak = max(pk_peak, torch.cuda.max_memory_allocated())
    check_replay_kernels(torch, K, ks, q3_plan, {"k": Q3_K})
    pk_peak = max(pk_peak, torch.cuda.max_memory_allocated())
    # T1 on resident A: the denominator of phase 9's tiered/resident ratio
    t0 = time.perf_counter()
    a_qps = t1_qps(db, TRef(np, snap))
    print(f"T1 resident: {a_qps:.1f} q/s over {len(T1_PARAMS)} roots ({time.perf_counter() - t0:.1f} s)")

    # 5b. distance(): the G cells on the same graph, recording then replays
    t0 = time.perf_counter()
    gref = GRef(np, snap)
    print(f"numpy references of G1–G3: {time.perf_counter() - t0:.1f} s")
    config.plan_cache_size = 0
    try:
        t0 = time.perf_counter()
        run_edges_record(np, torch, K, db, card, gref, G_CELLS, G_RECORD_KERNELS)
        print(f"record phase G: {time.perf_counter() - t0:.1f} s")
    finally:
        config.plan_cache_size = cache_size
    t0 = time.perf_counter()
    run_edges_replay(np, torch, K, db, snap, card, gref, G_CELLS, G_REPLAY_KERNELS)
    print(f"replay phase G: {time.perf_counter() - t0:.1f} s; boundary-band slots by (cell, r): {gref.band}")
    pk_peak = max(pk_peak, torch.cuda.max_memory_allocated())

    # 5c. TRAVERSE, record rows and compiled SELECT on the same graph
    from orientdb_tpu_torch.exec import tpu_engine as TE

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tr_launches = run_traverse(np, torch, K, TE, ks, db, snap, card)
    print(
        f"traverse phase: {time.perf_counter() - t0:.1f} s; peak allocated "
        f"{torch.cuda.max_memory_allocated()} bytes"
    )
    pk_peak = max(pk_peak, torch.cuda.max_memory_allocated())

    # 7a. batches on the Person–knows graph, while it is resident
    t0 = time.perf_counter()
    K.reset_launches()
    b_peak = run_batches_pk(np, torch, K, ks, db, snap, card, vref, q3_big, gref)
    torch.cuda.synchronize()
    batch_launches = dict(K.LAUNCHES)
    print(f"batch phase: {time.perf_counter() - t0:.1f} s; launches {batch_launches}")
    _require(batch_launches["predicate_eval"] > 0, "predicate_eval never launched in the batch phase")
    print(f"memory: peak allocated through the batch phase {b_peak} bytes")
    pk_peak = max(pk_peak, b_peak)

    # 7m. the mesh: A's twin on a 4-shard mesh, while A is resident
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mesh_launches = run_mesh(np, torch, K, TE, ks, db, snap, card, vref)
    print(
        f"mesh phase: {time.perf_counter() - t0:.1f} s; peak allocated "
        f"{torch.cuda.max_memory_allocated()} bytes"
    )

    # 6. the SNB-shape graph of config 5, after freeing the Person–knows one
    TE._plan_cache(snap).clear()
    del db, snap, dg, q3_plan, vref, q3_big, gref
    gc.collect()  # the snapshot's cycle (snapshot → plan cache → plan → solver)
    gc.collect()  # the device graph's, released by the weak map in the first pass
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(
        f"graph Person–knows: resident {pk_mem['total_bytes']} bytes {pk_mem['per_device']}, "
        f"peak allocated {pk_peak} bytes; allocated after freeing it {torch.cuda.memory_allocated()} bytes"
    )
    # 8. delta maintenance on A's twin, padded before its upload
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    delta_launches = run_deltas(np, torch, K, TE, ks, ddb, ddb.current_snapshot(), card)
    TE._plan_cache(ddb.current_snapshot()).clear()
    print(
        f"delta phase: {time.perf_counter() - t0:.1f} s; launches {delta_launches}; peak allocated "
        f"{torch.cuda.max_memory_allocated()} bytes"
    )
    del ddb
    gc.collect()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # 9. tiered snapshots on A's second twin, at half its adjacency bytes
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tier_launches = run_tiered(np, torch, K, TE, ks, tdb, tdb.current_snapshot(), card, a_qps, pk_mem["total_bytes"])
    print(
        f"tier phase: {time.perf_counter() - t0:.1f} s; peak allocated {torch.cuda.max_memory_allocated()} bytes"
    )
    del tdb
    gc.collect()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sdb, ssnap = build_snb_shape(8_000_000, msgs_per_person=2, avg_knows=10, seed=7)
    sdg = device_graph(ssnap, sdb.device)
    torch.cuda.synchronize()
    print(
        f"graph SNB-shape: V={ssnap.num_vertices} knows E={ssnap.edge_classes['knows'].num_edges} "
        f"hasCreator E={ssnap.edge_classes['hasCreator'].num_edges}, built and uploaded in "
        f"{time.perf_counter() - t0:.1f} s"
    )
    t0 = time.perf_counter()
    eref = ERef(np, ssnap)
    for name, (_sql, params, rest) in E_CELLS.items():
        for p in [params] + rest:
            eref.want(name, p)
    print(f"numpy references of E1–E5: {time.perf_counter() - t0:.1f} s")
    config.plan_cache_size = 0
    try:
        t0 = time.perf_counter()
        run_edges_record(np, torch, K, sdb, card, eref)
        print(f"record phase E: {time.perf_counter() - t0:.1f} s")
    finally:
        config.plan_cache_size = cache_size
    t0 = time.perf_counter()
    e_launches, e_plans = run_edges_replay(np, torch, K, sdb, ssnap, card, eref)
    print(f"replay phase E: {time.perf_counter() - t0:.1f} s")
    check_rows_with_matches(torch, K, ks, sdg)
    check_snb_kernels(torch, K, ks, sdg, e_plans["E1"], card)
    t0 = time.perf_counter()
    run_mesh_snb(np, torch, K, TE, sdb, ssnap, card, eref)
    print(f"mesh phase B: {time.perf_counter() - t0:.1f} s")

    # 7b. batches on the SNB-shape graph
    t0 = time.perf_counter()
    K.reset_launches()
    s_peak = max(torch.cuda.max_memory_allocated(), run_batches_snb(np, torch, K, ks, sdb, ssnap, card))
    torch.cuda.synchronize()
    print(f"batch phase E: {time.perf_counter() - t0:.1f} s; launches {dict(K.LAUNCHES)}")
    _require(K.LAUNCHES["predicate_eval"] > 0, "predicate_eval never launched in the SNB-shape batch phase")
    for name in BATCH_ONLY:
        batch_launches[name] += K.LAUNCHES[name]
    s_mem = sdg.memory_report()
    print(
        f"graph SNB-shape: resident {s_mem['total_bytes']} bytes {s_mem['per_device']}, host-only "
        f"columns {s_mem['pruned_bytes']} bytes; peak allocated {max(s_peak, torch.cuda.max_memory_allocated())} bytes"
    )
    launches["rows_with_matches"] = e_launches["rows_with_matches"]
    for name in BATCH_ONLY:
        launches[name] = batch_launches[name]
    for name in DELTA_ONLY:
        launches[name] = delta_launches[name]
    for name in TIER_ONLY:
        launches[name] = tier_launches[name]
    for name in MESH_ONLY:
        launches[name] = mesh_launches[name]
    for name in REPLACES:
        launches[name] += tr_launches[name]

    for name, row in ks.rows.items():
        row["launches"] = launches[name]
        row["max_abs_err"] = ks.err[name]
        print(
            f"kernel {name}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']}, bound {row['bound_ms']:.4f} ms, "
            f"launches {row['launches']}"
        )
    print(
        "replay medians beside PERF.md §5 (ms): "
        + ", ".join(f"{c} {REPLAY_MS.get(c, float('nan')):.3f} (§5 {w})" for c, w in SECTION5_REPLAY_MS.items())
    )
    _require(set(ks.rows) == set(REPLACES), "a kernel was not timed")
    _require(all(r["launches"] > 0 for n, r in ks.rows.items() if n not in OFF_PATH), "a kernel never launched")
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [ks.rows[n] for n in REPLACES]}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
