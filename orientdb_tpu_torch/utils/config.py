"""Port of `orientdb_tpu/utils/config.py`: only the knobs this package reads,
with the reference's defaults.

The reference's ``ORIENTTPU_<FIELD>`` environment overrides are not carried
over: every value here is fixed, so a plan's buffer sizes depend on nothing
but the statement and the snapshot. The reference's ``index_root_seed`` is
off here by construction: index-seeded roots are not ported, and every root
is a hull scan.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # Expansion/compaction buffers are padded to powers of two >= this
    # (ops/csr.bucket).
    min_expansion_cap: int = 8
    # Ceiling on one expansion output buffer (rows); larger expansions are
    # chunked over the binding table (tpu_engine._expand_one_dir_chunked).
    max_expansion_cap: int = 1 << 22
    # Byte budget for one variable-depth frontier bitmap chunk ([rows,
    # bucket(V)] bools): the chunk's row count shrinks as the graph grows
    # (tpu_engine._var_chunk_rows).
    var_depth_bitmap_budget: int = 1 << 26
    # Buffer headroom multiplier: buffers are sized bucket(observed * this)
    # (tpu_engine._cap_of), as in the reference.
    schedule_headroom: float = 2.0
    # Extra empty BFS levels a variable-depth (WHILE) recording runs past
    # frontier exhaustion, so that a replay whose walk is up to this many
    # levels deeper executes in place (tpu_engine._expand_var_depth).
    var_depth_pad_levels: int = 2
    # Plan cache entries per snapshot (tpu_engine._prepare).
    plan_cache_size: int = 256
    # Schedule variants kept per cached statement: parameter values whose
    # live sizes exceed every variant's capacities record a new variant
    # (tpu_engine.PlanVariants).
    plan_variants: int = 8
    # Device-memory budget for a replay's result page ladder (pow2 prefix
    # pages in int32 and int16, ~12 bytes a slot in the reference's
    # layout): plans whose ladder would exceed it emit only the full pages.
    result_page_budget_bytes: int = 16 << 20
    # Full result buffers at or below this many bytes replay into ONE
    # fused buffer (data rows + a meta row), fetched with one copy.
    result_direct_bytes: int = 64 << 10
    # Row-returning plans join a batch's group replay when one lane's full
    # int32 result stack fits this budget (the group keeps B of them on the
    # device); bigger plans keep per-lane dispatch and page election
    # (tpu_engine._CompiledPlan.batchable).
    result_group_lane_bytes: int = 4 << 20
    # Lanes of one group replay are capped as the reference caps them, so
    # that lanes x 4E (E the largest edge class the plan reads) stays inside
    # this budget; larger batches replay the group in several chunks
    # (tpu_engine._CompiledPlan._group_lane_cap). The reference's vmapped
    # lanes each hold an O(E) intermediate; the port's run one after
    # another, so here the cap bounds the captured graph's size.
    group_hbm_budget_bytes: int = 6 << 30
    # Tiered snapshots (storage/tiering): when tier_hbm_cap_bytes > 0 and a
    # snapshot's flat adjacency exceeds it, admission attaches a TierManager:
    # the adjacency pages between a device-resident hot pool and cold blocks
    # in host memory instead of uploading flat. 0 disables tiering.
    # tier_block_edges sets the target edges per block (the quotient
    # blocking widens a block that lands on a hub vertex rather than
    # splitting it).
    tier_hbm_cap_bytes: int = 0
    tier_block_edges: int = 65536
    # Delta maintenance (storage/deltas): once the worst slab's fill or the
    # dead fraction reaches this ratio, `apply_batch` folds the overlay into
    # a clean, re-padded snapshot (`SnapshotMaintainer.compact`), as it
    # does for a poisoned overlay.
    delta_compact_ratio: float = 0.75


config = Config()
