"""Port of `orientdb_tpu/ops/csr.py`: the CSR primitives of the compiled
MATCH path, the OPTIONAL arm's left-join count (`rows_with_matches`), the
bitmap BFS of variable-depth and NOT arms (with the level emission and
level step of `orientdb_tpu/exec/tpu_engine.py`), and the
result stage of a replay (front-pack, meta row, int16 narrowing of that
module's `_CompiledPlan`) and the compact page of a batch's rows group
(`group_page`), the interpreter of a compiled WHERE program
(`predicate_eval`, the masks of `ops/predicates.py`), and the delta path:
the in-place patch scatter of `ops/device_graph.DeviceGraph.apply_patches`
(`scatter_set`) and the append-slab expansions of a delta-maintained
snapshot (`slab_scan`, `slab_probe`), and the paged reads of a tiered
snapshot (`paged_hop_csr`, `paged_hop_miss`, `paged_expand`, over the page
pools of `storage/tiering`), and the mesh's per-shard kernels
(`degree_counts_range`, `shard_gather`, `bitmap_hop_shard`,
`shard_weight_pass`, `rowshard_hop`, for `parallel/`), each as a wrapper over a hand-written
CUDA kernel (`csrc/csr_kernels.cu`) beside its plain PyTorch version.
Wrappers also take a leading lane axis, the port's form of the
reference's ``jax.vmap`` over a batch group's lanes: `predicate_eval` with
a ``[B, P]`` parameter stack, `weight_gather` with lane-stacked masks or
weights, `indptr_segment_sum` with ``[B, E]`` values and `mask_count` with
``[B, n]`` masks (a count group's), and for a rows group `value_cumsum`
of ``[B, n]``, `compact_indices` of a ``[B, n]`` mask, `expand_offsets` and
`gather_expand` of ``[B, k]`` sources, `take_pad` of lane-local ``[B, m]``
rows (from a ``[B, n]`` table with a lane stride, or from one shared table
through the flattened index), `front_pack` of ``[B, W]`` columns and
`replay_meta` of ``[B, W, C]`` pages, `predicate_eval` over lane-stacked
``[B, n]`` ids (its stacked form: each lane its own ids, parameter row,
binding rows and split values) and `rows_with_matches` of ``[B, W]`` rows;
and for a variable-depth or NOT group the bitmap BFS's `bitmap_hop_csr`,
`bitmap_emit` and `frontier_advance` over the lanes' ``[B, C, vb]`` bitmap
stacks (a lane's gate, node mask, alive and counts its own);
each one launch for all B lanes that reads what the lanes share once (their
plain versions: the single-lane plain version a lane). Lane-stacked
operands are lane-major and contiguous, so each lane's row keeps the single
kernel's 16-byte accesses.

A wrapper checks dtype, contiguity and device, then:
- a CPU tensor goes to the plain version (``plain_*``), the reference's
  arithmetic in torch — the CPU tests run this path;
- a CUDA tensor goes to the kernel. If the library cannot be built or
  loaded, or a launch is refused, the wrapper raises: nothing falls back.

Each kernel launch adds one to ``LAUNCHES[name]`` (launches made through the
wrappers; a captured replay adds its plan's recorded launches once per
replay, `tpu_engine._CompiledPlan`), so a run can show that its main path
went through the kernels. Sizes follow the reference's static-shape
discipline: buffers are bucketed to powers of two (`bucket`) and padding
rows carry -1. Every
integer result is int32, as in the reference (JAX runs with x64 off).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch

from orientdb_tpu_torch.ops import _kernels
from orientdb_tpu_torch.utils.config import config

I32 = torch.int32
F32 = torch.float32

#: kernel name → launches through its wrapper since the last reset
LAUNCHES: Dict[str, int] = {
    name: 0
    for name in (
        "scan_i32",
        "scan_f32",
        "scan_lanes_i32",
        "degree_counts",
        "degree_scan_i32",
        "degree_scan_lanes_i32",
        "gather_expand",
        "gather_expand_lanes",
        "compact_indices",
        "compact_indices_lanes",
        "segment_sum_i32",
        "segment_sum_f32",
        "segment_sum_lanes_i32",
        "segment_sum_lanes_f32",
        "take_pad_i32",
        "take_pad_f32",
        "take_pad_b8",
        "take_pad_lanes",
        "mask_count",
        "mask_count_lanes",
        "weight_gather_i32",
        "weight_gather_f32",
        "weight_gather_lanes_i32",
        "weight_gather_lanes_f32",
        "front_pack",
        "front_pack_lanes",
        "replay_meta",
        "replay_meta_lanes",
        "narrow_i16",
        "rows_to_bitmap",
        "bitmap_hop",
        "bitmap_hop_csr",
        "bitmap_hop_probe",
        "bitmap_hop_csr_lanes",
        "bitmap_emit",
        "bitmap_emit_lanes",
        "frontier_advance",
        "frontier_advance_lanes",
        "rows_with_matches",
        "rows_with_matches_lanes",
        "group_page",
        "predicate_eval",
        "predicate_eval_lanes",
        "predicate_eval_stacked",
        "scatter_set",
        "slab_scan",
        "slab_probe",
        "paged_hop_csr",
        "paged_hop_miss",
        "paged_expand",
        "degree_counts_range",
        "shard_gather",
        "bitmap_hop_shard",
        "shard_weight_pass",
        "rowshard_hop",
    )
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def bucket(n: int, minimum: int = 0) -> int:
    """Round up to a power of two (≥ minimum, default
    config.min_expansion_cap)."""
    if minimum <= 0:
        minimum = max(1, config.min_expansion_cap)
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


# ---------------------------------------------------------------------------
# wrapper plumbing
# ---------------------------------------------------------------------------


def _check(t: torch.Tensor, dtypes, what: str) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != 1:
        raise ValueError(f"{what}: expected a 1-d tensor, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _check2d(t: torch.Tensor, dtypes, what: str) -> None:
    """`_check` for the [C, vb] bitmaps of the bitmap BFS."""
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != 2:
        raise ValueError(f"{what}: expected a 2-d tensor, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def _lanes_of(*ts: Optional[torch.Tensor]) -> Optional[int]:
    """The lane count B of the lane-stacked (2-d) operands among ``ts``,
    or None when every operand is shared (1-d); raises when two disagree."""
    B = None
    for t in ts:
        if t is not None and t.dim() == 2:
            if B is not None and t.shape[0] != B:
                raise ValueError(f"lane-stacked operands of {B} and {t.shape[0]} lanes")
            B = t.shape[0]
    return B


def _check_operand(t: torch.Tensor, dtypes, what: str, lanes: Optional[int]) -> None:
    """`_check` of a shared operand, or `_check2d` of a lane-stacked one."""
    if lanes is not None and t.dim() == 2:
        _check2d(t, dtypes, what)
    else:
        _check(t, dtypes, what)


def _lane(t: Optional[torch.Tensor], b: int) -> Optional[torch.Tensor]:
    """Lane ``b`` of a lane-stacked operand, or the shared operand itself."""
    return t[b] if t is not None and t.dim() == 2 else t


def _check_scalar(t: torch.Tensor, what: str) -> None:
    if t.dtype != I32 or t.dim() != 0:
        raise TypeError(f"{what}: expected a 0-d int32 tensor")


def _on_card(*ts: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (all on the same one)."""
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return dev.type == "cuda"


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# K1: prefix sums (value_cumsum / mask_cumsum / exclusive_cumsum)
# ---------------------------------------------------------------------------

#: the kernels' tiles (`csrc/csr_kernels.cu`'s kScanTile and kCompactTile,
#: chosen on the card, `PERF.md` §6), mirrored for the plain versions'
#: blocking; the look-back state is sized by the library itself
_TILE = 16384  # K1's elements per tile
_COMPACT_TILE = 16384  # K3's mask bytes per tile


def plain_cumsum(vals: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Prefix sum with the kernel's blocking: per-tile scans plus the
    scanned tile sums (int32 wraps mod 2^32 as the reference's does)."""
    n = vals.shape[0]
    if n <= _TILE:
        inc = torch.cumsum(vals, 0, dtype=vals.dtype)
    else:
        pad = (-n) % _TILE
        tiles = torch.cat([vals, vals.new_zeros(pad)]).view(-1, _TILE)
        local = torch.cumsum(tiles, 1, dtype=vals.dtype)
        before = plain_cumsum(local[:, -1].contiguous(), exclusive=True)
        inc = (local + before[:, None]).reshape(-1)[:n]
    return inc - vals if exclusive else inc


def _scan_card(
    vals: torch.Tensor, exclusive: bool, out: bool = True, total: bool = False
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One K1 launch (after one memset of its state) on a CUDA tensor: the
    scan (``out``) and/or the sum (``total``, a 0-d tensor)."""
    lib = _kernels.load()
    n, dev = vals.shape[0], vals.device
    res = torch.empty_like(vals) if out else None
    if n == 0:
        return res, torch.zeros((), dtype=vals.dtype, device=dev) if total else None
    tot = torch.empty((), dtype=vals.dtype, device=dev) if total else None
    # the look-back state, per call so that two streams never share one; in a
    # capture it comes from the graph's pool and the memset empties it at
    # every replay
    state = torch.empty(int(lib.csr_scan_scratch(n)), dtype=torch.uint8, device=dev)
    is_int = vals.dtype == I32
    _launch(
        "scan_i32" if is_int else "scan_f32",
        lib.csr_scan_i32 if is_int else lib.csr_scan_f32,
        vals.data_ptr(),
        None if res is None else res.data_ptr(),
        None if tot is None else tot.data_ptr(),
        n,
        state.data_ptr(),
        int(exclusive),
        _stream(vals),
    )
    return res, tot


def _scan(vals: torch.Tensor, exclusive: bool) -> torch.Tensor:
    _check(vals, (I32, F32), "scan")
    if not _on_card(vals):
        return plain_cumsum(vals, exclusive)
    return _scan_card(vals, exclusive)[0]


def value_cumsum(vals: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of int32/float32 values (exact in int32); of
    each row of lane-stacked int32 [B, n] values (`value_cumsum_lanes`)."""
    if vals.dim() == 2:
        return value_cumsum_lanes(vals)
    return _scan(vals, exclusive=False)


def plain_value_cumsum_lanes(vals: torch.Tensor) -> torch.Tensor:
    """The lane form's plain version: lane b's `plain_cumsum`."""
    if vals.shape[0] == 0:
        return vals.clone()
    return torch.stack([plain_cumsum(vals[b]) for b in range(vals.shape[0])])


def value_cumsum_lanes(vals: torch.Tensor) -> torch.Tensor:
    """K1's lane form: the inclusive scan of each row of int32 [B, n]
    values, one look-back chain a lane (the ranks of K6's lane form). On
    the card one launch after one memset of every lane's state."""
    _check2d(vals, (I32,), "value_cumsum_lanes")
    if not _on_card(vals):
        return plain_value_cumsum_lanes(vals)
    lib = _kernels.load()
    B, n = vals.shape
    out = torch.empty_like(vals)
    if B == 0 or n == 0:
        return out
    state = torch.empty(B * int(lib.csr_scan_scratch(n)), dtype=torch.uint8, device=vals.device)
    _launch(
        "scan_lanes_i32",
        lib.csr_scan_lanes_i32,
        vals.data_ptr(),
        out.data_ptr(),
        None,
        n,
        B,
        state.data_ptr(),
        0,
        _stream(vals),
    )
    return out


def exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    return _scan(counts, exclusive=True)


def exclusive_cumsum_total(counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`exclusive_cumsum` and `value_sum` of the same values in one pass:
    (offsets, total as a 0-d tensor)."""
    _check(counts, (I32, F32), "exclusive_cumsum_total")
    if not _on_card(counts):
        inc = plain_cumsum(counts)
        total = inc[-1] if counts.shape[0] else torch.zeros((), dtype=counts.dtype, device=counts.device)
        return inc - counts, total
    return _scan_card(counts, exclusive=True, total=True)


def mask_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a boolean mask, as int32."""
    _check(mask, (torch.bool,), "mask_cumsum")
    return value_cumsum(mask.to(I32))


def value_sum(vals: torch.Tensor) -> torch.Tensor:
    """Sum of int32/float32 values as a 0-d tensor of the same dtype: the
    last element of the inclusive scan (int32 wraps as the reference's
    int32 reduction does); on the card K1 without its output."""
    _check(vals, (I32, F32), "value_sum")
    if vals.shape[0] == 0:
        return torch.zeros((), dtype=vals.dtype, device=vals.device)
    if not _on_card(vals):
        return plain_cumsum(vals)[-1]
    return _scan_card(vals, exclusive=False, out=False, total=True)[1]


# ---------------------------------------------------------------------------
# K2: degree_counts, expand_offsets (the degree scan) + gather_expand
# ---------------------------------------------------------------------------


def plain_degree_counts(indptr: torch.Tensor, srcs: torch.Tensor) -> torch.Tensor:
    nv = indptr.shape[0] - 1
    valid = srcs >= 0
    if nv <= 0:
        return torch.zeros_like(srcs)
    s = torch.where(valid, srcs, 0).clamp(0, nv - 1).long()
    return torch.where(valid, indptr[s + 1] - indptr[s], 0).to(I32)


def degree_counts(indptr: torch.Tensor, srcs: torch.Tensor) -> torch.Tensor:
    """Per-source neighbor counts; padding (src=-1) counts 0. The engine's
    expansion takes `expand_offsets` instead."""
    _check(indptr, (I32,), "degree_counts indptr")
    _check(srcs, (I32,), "degree_counts srcs")
    if not _on_card(indptr, srcs):
        return plain_degree_counts(indptr, srcs)
    lib = _kernels.load()
    out = torch.empty_like(srcs)
    _launch(
        "degree_counts",
        lib.csr_degree_counts,
        indptr.data_ptr(),
        indptr.shape[0] - 1,
        srcs.data_ptr(),
        srcs.shape[0],
        out.data_ptr(),
        _stream(srcs),
    )
    return out


def plain_expand_offsets(
    indptr: torch.Tensor, srcs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    counts = plain_degree_counts(indptr, srcs)
    if counts.shape[0] == 0:
        return counts, torch.zeros((), dtype=I32, device=srcs.device)
    inc = plain_cumsum(counts)
    return inc - counts, inc[-1]


def plain_expand_offsets_lanes(
    indptr: torch.Tensor, srcs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lane form's plain version: lane b's `plain_expand_offsets`."""
    B = srcs.shape[0]
    if B == 0:
        return srcs.clone(), torch.zeros(0, dtype=I32, device=srcs.device)
    pairs = [plain_expand_offsets(indptr, srcs[b]) for b in range(B)]
    return torch.stack([o for o, _t in pairs]), torch.stack([t for _o, t in pairs])


def expand_offsets_lanes(indptr: torch.Tensor, srcs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's lane form: the sizing of B lanes of sources [B, k] over one
    CSR, offsets [B, k] and totals int32 [B], a look-back chain a lane. On
    the card one launch after one memset of every lane's state."""
    _check2d(srcs, (I32,), "expand_offsets_lanes srcs")
    return _expand_offsets(indptr, srcs)


def expand_offsets(indptr: torch.Tensor, srcs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A one-hop expansion's sizing: the exclusive cumsum of
    `degree_counts(indptr, srcs)` and its sum (a 0-d tensor), int32 wrapping
    as the reference's int32 cumsum does. On the card one degree-scan launch
    (after one memset of its look-back state). Lane-stacked sources [B, k]
    give offsets [B, k] and totals [B] (`expand_offsets_lanes`)."""
    if srcs.dim() == 2:
        return expand_offsets_lanes(indptr, srcs)
    return _expand_offsets(indptr, srcs)


def _expand_offsets(indptr: torch.Tensor, srcs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's one launch path for [k] sources (a lane) and [B, k] (a
    look-back chain a lane)."""
    lanes = _lanes_of(srcs)
    _check(indptr, (I32,), "expand_offsets indptr")
    _check_operand(srcs, (I32,), "expand_offsets srcs", lanes)
    if not _on_card(indptr, srcs):
        plain = plain_expand_offsets if lanes is None else plain_expand_offsets_lanes
        return plain(indptr, srcs)
    lib = _kernels.load()
    k, dev = srcs.shape[-1], srcs.device
    B = 1 if lanes is None else lanes
    offsets = torch.empty_like(srcs)
    total = torch.empty(srcs.shape[:-1], dtype=I32, device=dev)
    if B == 0:
        return offsets, total
    if k == 0:
        total.zero_()
        return offsets, total
    # the look-back state, per call (a capture takes it from the graph's pool)
    state = torch.empty(B * int(lib.csr_degree_scan_scratch(k)), dtype=torch.uint8, device=dev)
    _launch(
        "degree_scan_i32" if lanes is None else "degree_scan_lanes_i32",
        lib.csr_degree_scan_lanes_i32,
        indptr.data_ptr(),
        indptr.shape[0] - 1,
        srcs.data_ptr(),
        k,
        B,
        offsets.data_ptr(),
        total.data_ptr(),
        state.data_ptr(),
        _stream(srcs),
    )
    return offsets, total


def plain_gather_expand(
    indptr, neighbors, srcs, offsets, total, out_size: int, edge_map: Optional[torch.Tensor] = None
):
    dev = srcs.device
    K = srcs.shape[0]
    pos = torch.arange(out_size, dtype=I32, device=dev)
    neg = torch.full((out_size,), -1, dtype=I32, device=dev)
    if K == 0:
        return neg, neg.clone(), neg.clone()
    valid = pos < total
    # row(pos) = (#rows whose offset <= pos) - 1: an upper-bound search
    row = (torch.searchsorted(offsets, pos, right=True, out_int32=True) - 1).clamp(
        0, K - 1
    )
    src = srcs[row.long()]
    s = src.clamp(0, max(indptr.shape[0] - 2, 0)).long()
    edge_pos = (indptr[s] + (pos - offsets[row.long()])).to(I32)
    E = neighbors.shape[0]
    if E:
        nbr = neighbors[edge_pos.clamp(0, E - 1).long()]
    else:
        nbr = neg
    edge_pos = torch.where(valid, edge_pos, -1)
    if edge_map is not None:
        edge_pos = plain_take_pad(edge_map, edge_pos, -1)
    return (
        torch.where(valid, row, -1),
        edge_pos,
        torch.where(valid, nbr, -1),
    )


def plain_gather_expand_lanes(
    indptr, neighbors, srcs, offsets, total, out_size: int, edge_map: Optional[torch.Tensor] = None
):
    """The lane form's plain version: lane b's `plain_gather_expand`."""
    B = srcs.shape[0]
    if B == 0:
        empty = torch.zeros((0, out_size), dtype=I32, device=srcs.device)
        return empty, empty.clone(), empty.clone()
    lanes = [
        plain_gather_expand(indptr, neighbors, srcs[b], offsets[b], total[b], out_size, edge_map)
        for b in range(B)
    ]
    return tuple(torch.stack([ln[i] for ln in lanes]) for i in range(3))


def gather_expand_lanes(
    indptr: torch.Tensor,
    neighbors: torch.Tensor,
    srcs: torch.Tensor,
    offsets: torch.Tensor,
    total: torch.Tensor,
    out_size: int,
    edge_map: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2b's lane form: B lanes of sources and offsets [B, k] with totals
    int32 [B] over one CSR (and one ``edge_map``), each lane expanded as
    `gather_expand` expands it into its row of [B, out_size] (row,
    edge_pos, neighbour); a lane whose total exceeds ``out_size`` fills its
    row and writes nothing past it. On the card one merge-path launch, a
    grid row a lane."""
    _check2d(srcs, (I32,), "gather_expand_lanes srcs")
    return _gather_expand(indptr, neighbors, srcs, offsets, total, out_size, edge_map)


def gather_expand(
    indptr: torch.Tensor,
    neighbors: torch.Tensor,
    srcs: torch.Tensor,
    offsets: torch.Tensor,
    total: torch.Tensor,
    out_size: int,
    edge_map: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand every source's CSR slice into flat (row, edge_pos, neighbor).

    `offsets` is the exclusive cumsum of `degree_counts(indptr, srcs)` and
    `total` its sum (0-d int32 tensor; both from `expand_offsets`). Returns
    int32 arrays of length `out_size`, -1 past `total` (all live when
    total > out_size):
      row      — index into `srcs` this output came from
      edge_pos — position in CSR edge order; with ``edge_map`` (an in walk's
                 ``edge_id_in``) ``take_pad(edge_map, edge_pos, -1)``
      neighbor — the reached vertex (dst for out-CSR, src for in-CSR)
    On the card one merge-path launch. Lane-stacked sources and offsets
    [B, k] with totals [B] give [B, out_size] (`gather_expand_lanes`).
    """
    if srcs.dim() == 2:
        return gather_expand_lanes(indptr, neighbors, srcs, offsets, total, out_size, edge_map)
    return _gather_expand(indptr, neighbors, srcs, offsets, total, out_size, edge_map)


def _gather_expand(indptr, neighbors, srcs, offsets, total, out_size: int, edge_map=None):
    """K2b's one launch path for [k] sources (a lane) and [B, k] (a grid
    row a lane)."""
    lanes = _lanes_of(srcs)
    _check(indptr, (I32,), "gather_expand indptr")
    _check(neighbors, (I32,), "gather_expand neighbors")
    _check_operand(srcs, (I32,), "gather_expand srcs", lanes)
    _check_operand(offsets, (I32,), "gather_expand offsets", lanes)
    if offsets.shape != srcs.shape:
        raise ValueError("gather_expand: offsets and srcs differ in shape")
    if total.dtype != I32 or total.shape != srcs.shape[:-1] or not total.is_contiguous():
        raise TypeError(f"gather_expand total: expected a contiguous int32 tensor of shape {tuple(srcs.shape[:-1])}")
    mapped = () if edge_map is None else (edge_map,)
    if edge_map is not None:
        _check(edge_map, (I32,), "gather_expand edge_map")
    if not _on_card(indptr, neighbors, srcs, offsets, total, *mapped):
        plain = plain_gather_expand if lanes is None else plain_gather_expand_lanes
        return plain(indptr, neighbors, srcs, offsets, total, out_size, edge_map)
    lib = _kernels.load()
    B = 1 if lanes is None else lanes
    row = torch.empty((*srcs.shape[:-1], out_size), dtype=I32, device=srcs.device)
    edge_pos = torch.empty_like(row)
    nbr = torch.empty_like(row)
    if B == 0:
        return row, edge_pos, nbr
    _launch(
        "gather_expand" if lanes is None else "gather_expand_lanes",
        lib.csr_gather_expand_lanes,
        indptr.data_ptr(),
        indptr.shape[0] - 1,
        neighbors.data_ptr(),
        neighbors.shape[0],
        srcs.data_ptr(),
        offsets.data_ptr(),
        srcs.shape[-1],
        B,
        total.data_ptr(),
        out_size,
        None if edge_map is None else edge_map.data_ptr(),
        0 if edge_map is None else edge_map.shape[0],
        row.data_ptr(),
        edge_pos.data_ptr(),
        nbr.data_ptr(),
        _stream(srcs),
    )
    return row, edge_pos, nbr


# ---------------------------------------------------------------------------
# K3: compact_indices
# ---------------------------------------------------------------------------


def plain_compact_indices(
    mask: torch.Tensor, out_size: int, out: Optional[torch.Tensor] = None, offset: int = 0
) -> torch.Tensor:
    """The reference's rank scatter (each kept slot's position at its rank
    minus one, the ranks past ``out_size`` dropped): the first ``out_size``
    True positions in order, -1 after them."""
    res = torch.full((out_size,), -1, dtype=I32, device=mask.device)
    if mask.shape[0]:
        pos = mask.nonzero().view(-1)[:out_size]
        res[: pos.shape[0]] = pos.to(I32)
    if out is None:
        return res
    kept = min(int(mask.sum()), out_size)
    out[offset : offset + kept] = res[:kept]
    return out[offset : offset + out_size]


def plain_compact_indices_lanes(mask: torch.Tensor, out_size: int) -> torch.Tensor:
    """The lane form's plain version: lane b's `plain_compact_indices`."""
    if mask.shape[0] == 0:
        return torch.full((0, out_size), -1, dtype=I32, device=mask.device)
    return torch.stack([plain_compact_indices(mask[b], out_size) for b in range(mask.shape[0])])


def compact_indices_lanes(mask: torch.Tensor, out_size: int) -> torch.Tensor:
    """K3's lane form: each row of a [B, n] bool mask compacted as
    `compact_indices` compacts it, into int32 [B, out_size] (a lane clipped
    to ``out_size`` and padded with -1). On the card one launch after one
    memset that sets every lane's slots to -1 and empties every lane's
    look-back state (the states right behind the B·out_size slots)."""
    _check2d(mask, (torch.bool,), "compact_indices_lanes")
    return _compact_indices(mask, out_size)


def compact_indices(
    mask: torch.Tensor, out_size: int, out: Optional[torch.Tensor] = None, offset: int = 0
) -> torch.Tensor:
    """Indices of True entries (ascending), -1-padded to `out_size`; the
    first `out_size` when there are more.

    The offset form (``out`` given: an int32 buffer) writes the indices into
    ``out[offset : offset + out_size]`` and returns that view; the slots past
    the mask's count are left as they are (the caller fills the buffer
    once). A lane-stacked [B, n] mask gives [B, out_size]
    (`compact_indices_lanes`; no offset form)."""
    if mask.dim() == 2 and out is None:
        return compact_indices_lanes(mask, out_size)
    return _compact_indices(mask, out_size, out, offset)


def _compact_indices(
    mask: torch.Tensor, out_size: int, out: Optional[torch.Tensor] = None, offset: int = 0
) -> torch.Tensor:
    """K3's one launch path for an [n] mask (a lane) and a [B, n] one (a
    look-back chain a lane)."""
    lanes = _lanes_of(mask)
    _check_operand(mask, (torch.bool,), "compact_indices", lanes)
    if out is not None:
        if lanes is not None:
            raise ValueError("compact_indices: a lane-stacked mask has no offset form")
        _check(out, (I32,), "compact_indices out")
        if offset < 0 or offset + out_size > out.shape[0]:
            raise ValueError(
                f"compact_indices: [{offset}, {offset + out_size}) outside the {out.shape[0]}-slot buffer"
            )
    if not (_on_card(mask) if out is None else _on_card(mask, out)):
        if lanes is not None:
            return plain_compact_indices_lanes(mask, out_size)
        return plain_compact_indices(mask, out_size, out, offset)
    lib = _kernels.load()
    n, dev = mask.shape[-1], mask.device
    B = 1 if lanes is None else lanes
    state_bytes = B * int(lib.csr_compact_scratch(n))
    if out is None:
        # the fill form: the look-back states right behind the slots (8-byte
        # aligned), so that one memset sets both
        lead = B * out_size + ((B * out_size) & 1)
        buf = torch.empty(lead + state_bytes // 4, dtype=I32, device=dev)
        dst, state = buf.data_ptr(), buf.data_ptr() + 4 * lead
    else:
        buf = torch.empty(state_bytes, dtype=torch.uint8, device=dev)
        dst, state = out.data_ptr() + 4 * offset, buf.data_ptr()
    _launch(
        "compact_indices" if lanes is None else "compact_indices_lanes",
        lib.csr_compact_lanes,
        mask.data_ptr(),
        n,
        B,
        out_size,
        dst,
        state,
        int(out is None),
        _stream(mask),
    )
    if out is not None:
        return out[offset : offset + out_size]
    return buf[: B * out_size].view(*mask.shape[:-1], out_size)


# ---------------------------------------------------------------------------
# K4: indptr_segment_sum
# ---------------------------------------------------------------------------


def plain_indptr_segment_sum(
    vals: torch.Tensor, indptr: torch.Tensor, out_size: int
) -> torch.Tensor:
    """Per-segment sums as differences of a wide prefix sum (int64, or
    float64 for float32 values) at the indptr boundaries, cast back: exact
    int32 sums mod 2^32, float32 sums rounded once."""
    acc = torch.float64 if vals.dtype == F32 else torch.int64
    tot = torch.cat(
        [torch.zeros(1, dtype=acc, device=vals.device), torch.cumsum(vals, 0, dtype=acc)]
    )
    nseg = min(indptr.shape[0] - 1, out_size)
    out = torch.zeros(out_size, dtype=vals.dtype, device=vals.device)
    if nseg > 0:
        seg = tot[indptr[1 : nseg + 1].long()] - tot[indptr[:nseg].long()]
        out[:nseg] = seg.to(vals.dtype)
    return out


def plain_indptr_segment_sum_lanes(
    vals: torch.Tensor, indptr: torch.Tensor, out_size: int
) -> torch.Tensor:
    """The lane form's plain version: lane b's sums of ``vals[b]``."""
    B = vals.shape[0]
    if B == 0:
        return torch.zeros((0, out_size), dtype=vals.dtype, device=vals.device)
    return torch.stack([plain_indptr_segment_sum(vals[b], indptr, out_size) for b in range(B)])


def indptr_segment_sum(
    vals: torch.Tensor, indptr: torch.Tensor, out_size: int
) -> torch.Tensor:
    """Per-vertex sums of CSR-ordered values, zero-padded (or cut) to
    `out_size`. ``indptr`` is non-decreasing within ``[0, len(vals)]`` (a
    CSR's own); on the card a merge-path reduction whose float32 sums are
    the same bit for bit from call to call. Lane-stacked ``vals`` [B, E]
    give [B, out_size] (`indptr_segment_sum_lanes`)."""
    if vals.dim() == 2:
        return indptr_segment_sum_lanes(vals, indptr, out_size)
    _check(vals, (I32, F32), "indptr_segment_sum vals")
    _check(indptr, (I32,), "indptr_segment_sum indptr")
    if not _on_card(vals, indptr):
        return plain_indptr_segment_sum(vals, indptr, out_size)
    lib = _kernels.load()
    out = torch.empty(out_size, dtype=vals.dtype, device=vals.device)
    nseg, ne = max(min(indptr.shape[0] - 1, out_size), 0), vals.shape[0]
    scratch = torch.empty(lib.csr_segment_scratch(nseg, ne), dtype=I32, device=vals.device)
    is_int = vals.dtype == I32
    _launch(
        "segment_sum_i32" if is_int else "segment_sum_f32",
        lib.csr_segment_sum_i32 if is_int else lib.csr_segment_sum_f32,
        vals.data_ptr(),
        ne,
        indptr.data_ptr(),
        nseg,
        out_size,
        out.data_ptr(),
        scratch.data_ptr(),
        _stream(vals),
    )
    return out


def indptr_segment_sum_lanes(
    vals: torch.Tensor, indptr: torch.Tensor, out_size: int
) -> torch.Tensor:
    """K4's lane form: the sums of B lanes of values [B, E] over ONE
    ``indptr``, [B, out_size]. On the card one partition of the merge path
    serves every lane (it depends only on ``indptr`` and E), and a block
    stages its tile's segment ends once and walks each lane's values over
    them; each lane's float32 sums are the same bit for bit from call to
    call, and equal the single-lane kernel's."""
    _check2d(vals, (I32, F32), "indptr_segment_sum_lanes vals")
    _check(indptr, (I32,), "indptr_segment_sum_lanes indptr")
    if not _on_card(vals, indptr):
        return plain_indptr_segment_sum_lanes(vals, indptr, out_size)
    lib = _kernels.load()
    B, ne = vals.shape
    out = torch.empty((B, out_size), dtype=vals.dtype, device=vals.device)
    nseg = max(min(indptr.shape[0] - 1, out_size), 0)
    scratch = torch.empty(
        max(int(lib.csr_segment_lanes_scratch(nseg, ne, B)), 1), dtype=I32, device=vals.device
    )
    is_int = vals.dtype == I32
    _launch(
        "segment_sum_lanes_i32" if is_int else "segment_sum_lanes_f32",
        lib.csr_segment_sum_lanes_i32 if is_int else lib.csr_segment_sum_lanes_f32,
        vals.data_ptr(),
        ne,
        B,
        indptr.data_ptr(),
        nseg,
        out_size,
        out.data_ptr(),
        scratch.data_ptr(),
        _stream(vals),
    )
    return out


# ---------------------------------------------------------------------------
# K5: take_pad + mask_count
# ---------------------------------------------------------------------------


def plain_take_pad(values: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    n = values.shape[0]
    if n == 0:
        return torch.full(idx.shape, fill, dtype=values.dtype, device=idx.device)
    v = values[idx.clamp(0, n - 1).long()]
    return torch.where(idx >= 0, v, fill)


_TAKE = {
    I32: ("take_pad_i32", "csr_take_pad_i32", int),
    F32: ("take_pad_f32", "csr_take_pad_f32", float),
    torch.bool: ("take_pad_b8", "csr_take_pad_b8", int),
}


#: the largest table take_pad and weight_gather gather under an L2
#: evict_last policy (of the card's 50 MB L2), so that it stays there while
#: the index and output stream past; the COUNT pushdown folds its vertex
#: mask into weights of at most this size
L2_KEEP_BYTES = 40 << 20
#: beside a larger gathered table (the in walk's edge mask read through
#: edge ids, 80 MB at A), weight_gather keeps only tables of at most this
#: size: pinning a 32 MB weight table as well pushes the edge mask's lines
#: out twice as fast (PERF.md §6)
L2_KEEP_BESIDE = 16 << 20
#: the largest table the card's L2 gathers from at its full random rate:
#: 1-16 MiB tables take 0.61-0.66 ms for 80M random gathers, a 32 MiB one
#: 0.94 (`PERF.md` §6, K23)
L2_FAST_BYTES = 16 << 20


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def plain_take_pad_lanes(values: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """The lane stride's plain version: lane b's `plain_take_pad` of
    ``values[b]`` at ``idx[b]``."""
    if idx.shape[0] == 0:
        return torch.full(idx.shape, fill, dtype=values.dtype, device=idx.device)
    return torch.stack([plain_take_pad(values[b], idx[b], fill) for b in range(idx.shape[0])])


def take_pad(values: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """`values[idx]` where idx ≥ 0, else `fill` (padding-safe gather);
    indices past the end read the last value, as the reference's clip.

    On the lane axis ``idx`` is a [B, m] stack of lane-local rows: from a
    lane-stacked table ``values`` [B, n] lane b reads its own row (the same
    kernel with a lane stride: index i of lane b reads ``values[b·n + i]``);
    from a table the lanes share (1-d) the flattened index is one call."""
    if idx.dim() == 2:
        if values.dim() == 1:
            if not idx.is_contiguous():
                raise ValueError("take_pad idx: tensor must be contiguous")
            return take_pad(values, idx.view(-1), fill).view(idx.shape)
        _check2d(values, tuple(_TAKE), "take_pad values")
        _check2d(idx, (I32,), "take_pad idx")
        if values.shape[0] != idx.shape[0]:
            raise ValueError(f"take_pad: a table of {values.shape[0]} lanes and an index of {idx.shape[0]}")
        if not _on_card(values, idx):
            return plain_take_pad_lanes(values, idx, fill)
        lane_m, stride = idx.shape[1], values.shape[1]
    else:
        _check(values, tuple(_TAKE), "take_pad values")
        _check(idx, (I32,), "take_pad idx")
        if not _on_card(values, idx):
            return plain_take_pad(values, idx, fill)
        lane_m = stride = 0
    name, entry, cast = _TAKE[values.dtype]
    lib = _kernels.load()
    out = torch.empty(idx.shape, dtype=values.dtype, device=idx.device)
    if lane_m and values.shape[1] == 0:
        return out.fill_(fill)
    _launch(
        "take_pad_lanes" if lane_m else name,  # the same kernel, its lane stride counted apart
        getattr(lib, entry),
        values.data_ptr(),
        values.shape[-1],
        idx.data_ptr(),
        idx.numel(),
        cast(fill),
        int(_nbytes(values) <= L2_KEEP_BYTES),
        out.data_ptr(),
        lane_m,
        stride,
        _stream(idx),
    )
    return out


def plain_weight_gather(
    emit: Optional[torch.Tensor],
    dtype: torch.dtype,
    ok: Optional[torch.Tensor] = None,
    node_ok: Optional[torch.Tensor] = None,
    emask: Optional[torch.Tensor] = None,
    eid: Optional[torch.Tensor] = None,
    w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The reference's weight-pass chain (`orientdb_tpu/exec/tpu_engine.py`
    :1600-1606) as separate calls: ``em & take_pad(ok, emit, False)``,
    ``.to(dtype)``, ``* take_pad(w, emit, 0)``; without ``emit``, over
    the weights' own indices."""
    if emit is None:
        emit = torch.arange(w.shape[0], dtype=I32, device=w.device)
    keep = None
    for m in (
        None if ok is None else plain_take_pad(ok, emit, False),
        node_ok,
        None if emask is None else emask if eid is None else plain_take_pad(emask, eid, False),
    ):
        if m is not None:
            keep = m if keep is None else keep & m
    if keep is None:
        vals = torch.ones(emit.shape[0], dtype=dtype, device=emit.device)
    else:
        vals = keep.to(dtype)
    if w is not None:
        vals = vals * plain_take_pad(w, emit, 0)
    return vals


def weight_gather(
    emit: Optional[torch.Tensor],
    dtype: torch.dtype,
    ok: Optional[torch.Tensor] = None,
    node_ok: Optional[torch.Tensor] = None,
    emask: Optional[torch.Tensor] = None,
    eid: Optional[torch.Tensor] = None,
    w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The COUNT pushdown's value of each edge of one class and direction,
    in one launch: ``T(keep) * (w[emit] if w else 1)`` with ``keep`` the AND
    of ``ok[emit]`` (a [vb] vertex mask), ``node_ok`` (the node mask already
    at each edge's endpoint) and the edge mask ``emask`` (read through
    ``eid``, -1 reading False, or directly), each only where given; every
    gather is `take_pad`'s (clip past the end, a negative index reads the
    fill). Without ``emit`` it runs over the weights' own indices: ``ok ?
    w : 0``, the vertex mask folded into the weights before the walks
    gather them. The kernel writes 0 where ``keep`` is False without
    reading ``w``: the same bits as the product for finite weights other
    than -0.0, as the pushdown's sums are. Where ``ok``, ``node_ok``,
    ``emask`` or ``w`` is lane-stacked ([B, ·]) the result is [B, m]
    (`weight_gather_lanes`)."""
    if _lanes_of(ok, node_ok, emask, w) is not None:
        return weight_gather_lanes(emit, dtype, ok, node_ok, emask, eid, w)
    if dtype not in (I32, F32):
        raise TypeError(f"weight_gather: dtype {dtype} not int32 or float32")
    if emit is None:
        if w is None:
            raise ValueError("weight_gather: no emit and no weights")
        m = w.shape[0]
    else:
        _check(emit, (I32,), "weight_gather emit")
        m = emit.shape[0]
    for t, what in ((ok, "ok"), (node_ok, "node_ok"), (emask, "emask")):
        if t is not None:
            _check(t, (torch.bool,), f"weight_gather {what}")
    for t, what in ((node_ok, "node_ok"), (eid, "eid")):
        if t is not None and t.shape[0] != m:
            raise ValueError(f"weight_gather {what}: {t.shape[0]} entries for {m} edges")
    if eid is not None:
        _check(eid, (I32,), "weight_gather eid")
        if emask is None:
            raise ValueError("weight_gather: eid without emask")
    elif emask is not None and emask.shape[0] != m:
        raise ValueError(f"weight_gather emask: {emask.shape[0]} entries for {m} edges")
    if w is not None:
        _check(w, (dtype,), "weight_gather w")
    if not _on_card(*(t for t in (emit, ok, node_ok, emask, eid, w) if t is not None)):
        return plain_weight_gather(emit, dtype, ok, node_ok, emask, eid, w)
    name = "weight_gather_i32" if dtype == I32 else "weight_gather_f32"
    lib = _kernels.load()
    out = torch.empty(m, dtype=dtype, device=(w if emit is None else emit).device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # the tables gathered through emit or eid that stay in L2 (bits 1 ok,
    # 2 emask, 4 w); a fold reads each table once, in order: none
    keep = 0
    if emit is not None:
        tables = (_nbytes(ok), _nbytes(emask) if eid is not None else 0, _nbytes(w))
        limit = L2_KEEP_BESIDE if max(tables) > L2_KEEP_BYTES else L2_KEEP_BYTES
        keep = sum(bit for bit, b in zip((1, 2, 4), tables) if b <= limit)

    _launch(
        name,
        getattr(lib, "csr_" + name),
        ptr(emit),
        m,
        ptr(ok),
        0 if ok is None else ok.shape[0],
        ptr(node_ok),
        ptr(emask),
        0 if emask is None else emask.shape[0],
        ptr(eid),
        ptr(w),
        0 if w is None else w.shape[0],
        keep,
        out.data_ptr(),
        _stream(out),
    )
    return out


def plain_weight_gather_lanes(
    emit: Optional[torch.Tensor],
    dtype: torch.dtype,
    ok: Optional[torch.Tensor] = None,
    node_ok: Optional[torch.Tensor] = None,
    emask: Optional[torch.Tensor] = None,
    eid: Optional[torch.Tensor] = None,
    w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The lane form's plain version: `plain_weight_gather` a lane, with
    each lane-stacked operand's row of that lane and the shared ones as
    they are."""
    B = _lanes_of(ok, node_ok, emask, w)
    m = (w.shape[-1] if emit is None else emit.shape[0])
    dev = (w if emit is None else emit).device
    if not B:
        return torch.zeros((0, m), dtype=dtype, device=dev)
    return torch.stack(
        [
            plain_weight_gather(emit, dtype, _lane(ok, b), _lane(node_ok, b), _lane(emask, b), eid, _lane(w, b))
            for b in range(B)
        ]
    )


def weight_gather_lanes(
    emit: Optional[torch.Tensor],
    dtype: torch.dtype,
    ok: Optional[torch.Tensor] = None,
    node_ok: Optional[torch.Tensor] = None,
    emask: Optional[torch.Tensor] = None,
    eid: Optional[torch.Tensor] = None,
    w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5a's lane form: `weight_gather` for B lanes at once, [B, m]. Each
    of ``ok`` [vb], ``node_ok`` [m], ``emask`` and ``w`` is shared (1-d) or
    lane-stacked (2-d, a lane a row: lane-major, so that a lane's stream is
    contiguous, as K15's lane form writes it and K4's reads it); ``emit``
    and ``eid`` are always shared. On the card a thread reads its edges'
    ``emit``, ``eid`` and every shared gathered value once, and loops over
    the lanes for the lane-stacked ones only."""
    if dtype not in (I32, F32):
        raise TypeError(f"weight_gather_lanes: dtype {dtype} not int32 or float32")
    B = _lanes_of(ok, node_ok, emask, w)
    if B is None:
        raise ValueError("weight_gather_lanes: no lane-stacked operand")
    if emit is None:
        if w is None:
            raise ValueError("weight_gather_lanes: no emit and no weights")
        m = w.shape[-1]
    else:
        _check(emit, (I32,), "weight_gather_lanes emit")
        m = emit.shape[0]
    for t, what in ((ok, "ok"), (node_ok, "node_ok"), (emask, "emask")):
        if t is not None:
            _check_operand(t, (torch.bool,), f"weight_gather_lanes {what}", B)
    if node_ok is not None and node_ok.shape[-1] != m:
        raise ValueError(f"weight_gather_lanes node_ok: {node_ok.shape[-1]} entries for {m} edges")
    if eid is not None:
        _check(eid, (I32,), "weight_gather_lanes eid")
        if eid.shape[0] != m:
            raise ValueError(f"weight_gather_lanes eid: {eid.shape[0]} entries for {m} edges")
        if emask is None:
            raise ValueError("weight_gather_lanes: eid without emask")
    elif emask is not None and emask.shape[-1] != m:
        raise ValueError(f"weight_gather_lanes emask: {emask.shape[-1]} entries for {m} edges")
    if w is not None:
        _check_operand(w, (dtype,), "weight_gather_lanes w", B)
    ts = [t for t in (emit, ok, node_ok, emask, eid, w) if t is not None]
    if not _on_card(*ts):
        return plain_weight_gather_lanes(emit, dtype, ok, node_ok, emask, eid, w)
    name = "weight_gather_lanes_i32" if dtype == I32 else "weight_gather_lanes_f32"
    lib = _kernels.load()
    out = torch.empty((B, m), dtype=dtype, device=ts[0].device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def n_of(t):
        return 0 if t is None else t.shape[-1]

    def stride(t):
        return n_of(t) if t is not None and t.dim() == 2 else 0

    # the shared tables gathered through emit or eid that stay in L2 (bits
    # 1 ok, 2 emask, 4 w), chosen as the single-lane form chooses
    keep = 0
    if emit is not None:
        tables = (_nbytes(ok), _nbytes(emask) if eid is not None else 0, _nbytes(w))
        limit = L2_KEEP_BESIDE if max(tables) > L2_KEEP_BYTES else L2_KEEP_BYTES
        keep = sum(bit for bit, b in zip((1, 2, 4), tables) if b <= limit)
    _launch(
        name,
        getattr(lib, "csr_" + name),
        ptr(emit),
        m,
        ptr(ok),
        n_of(ok),
        stride(ok),
        ptr(node_ok),
        stride(node_ok),
        ptr(emask),
        n_of(emask),
        stride(emask),
        ptr(eid),
        ptr(w),
        n_of(w),
        stride(w),
        B,
        keep,
        out.data_ptr(),
        _stream(out),
    )
    return out


def plain_mask_count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=I32)


def plain_mask_count_lanes(mask: torch.Tensor) -> torch.Tensor:
    """The lane form's plain version: each lane's popcount, int32 [B]."""
    return mask.sum(dim=1, dtype=I32)


def mask_count_lanes(mask: torch.Tensor) -> torch.Tensor:
    """K5b's lane form: the popcount of each row of a [B, n] bool mask, as
    int32 [B], in one launch for all lanes (each row counted as K5b counts
    a mask)."""
    _check2d(mask, (torch.bool,), "mask_count_lanes")
    if not _on_card(mask):
        return plain_mask_count_lanes(mask)
    lib = _kernels.load()
    B, n = mask.shape
    out = torch.empty(B, dtype=I32, device=mask.device)
    _launch(
        "mask_count_lanes",
        lib.csr_mask_count_lanes,
        mask.data_ptr(),
        n,
        B,
        out.data_ptr(),
        _stream(mask),
    )
    return out


def mask_count(mask: torch.Tensor) -> torch.Tensor:
    """Popcount of a boolean mask as a 0-d int32 tensor; of each row of a
    lane-stacked [B, n] mask as int32 [B] (`mask_count_lanes`)."""
    if mask.dim() == 2:
        return mask_count_lanes(mask)
    _check(mask, (torch.bool,), "mask_count")
    if not _on_card(mask):
        return plain_mask_count(mask)
    lib = _kernels.load()
    out = torch.empty((), dtype=I32, device=mask.device)
    _launch(
        "mask_count",
        lib.csr_mask_count,
        mask.data_ptr(),
        mask.shape[0],
        out.data_ptr(),
        _stream(mask),
    )
    return out


# ---------------------------------------------------------------------------
# K6–K8: the result stage of a replay
# ---------------------------------------------------------------------------

_PACK_COLS = 16  # columns a front_pack launch moves (the kernel's kMaxCols)


def _check_out(out: torch.Tensor, shape, dtype, what: str) -> None:
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous {dtype} tensor of shape {tuple(shape)}")


def plain_front_pack(valid: torch.Tensor, cols: List[torch.Tensor]) -> torch.Tensor:
    """The reference's front-pack with rows leading: ``perm =
    compact_indices(valid != 0, W)``, then ``take_pad(col, perm, -1)`` per
    column, stacked as the columns of an int32 [W, C]."""
    perm = plain_compact_indices(valid != 0, valid.shape[0])
    return torch.stack([plain_take_pad(c, perm, -1) for c in cols], dim=1)


def _check_lane_out(out: torch.Tensor, shape, what: str) -> None:
    """A lane form's output: int32 of ``shape``, each lane's part contiguous
    (its rows back to back), lanes at any stride (a direct-fetch stack's
    rows)."""
    inner = [1]
    for d in reversed(shape[2:]):
        inner.insert(0, inner[0] * d)
    if (
        tuple(out.shape) != tuple(shape)
        or out.dtype != I32
        or list(out.stride()[1:]) != inner
        or out.stride(0) < (inner[0] * shape[1] if len(shape) > 1 else 1)
    ):
        raise ValueError(f"{what}: out must be int32 {tuple(shape)} with contiguous lanes")


def plain_front_pack_lanes(valid: torch.Tensor, cols: List[torch.Tensor]) -> torch.Tensor:
    """The lane form's plain version: lane b's `plain_front_pack`."""
    B, W = valid.shape
    if B == 0:
        return torch.zeros((0, W, len(cols)), dtype=I32, device=valid.device)
    return torch.stack([plain_front_pack(valid[b], [c[b] for c in cols]) for b in range(B)])


def front_pack_lanes(
    valid: torch.Tensor, cols: List[torch.Tensor], out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K6's lane form: each lane of [B, W] valid masks and [B, W] columns
    front-packed as `front_pack` packs it, into [B, W, C] (``out`` may
    place the lanes at any stride: a direct-fetch stack). On the card K1's
    lane form for the ranks, then one launch a 16 columns for all lanes."""
    _check2d(valid, (I32,), "front_pack_lanes valid")
    return _front_pack(valid, cols, out)


def front_pack(
    valid: torch.Tensor, cols: List[torch.Tensor], out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Live rows (``valid != 0``) first, in slot order, then rows of -1:
    int32 [W, C], row-major, so that a page of the result is a prefix of
    its rows. ``out`` (optional) receives the result. Lane-stacked [B, W]
    masks and columns give [B, W, C] (`front_pack_lanes`)."""
    if valid.dim() == 2:
        return front_pack_lanes(valid, cols, out)
    return _front_pack(valid, cols, out)


def _front_pack(valid: torch.Tensor, cols: List[torch.Tensor], out: Optional[torch.Tensor]) -> torch.Tensor:
    """K6's one launch path for [W] masks (a lane) and [B, W] (a grid row a
    lane)."""
    lanes = _lanes_of(valid)
    _check_operand(valid, (I32,), "front_pack valid", lanes)
    C = len(cols)
    if C == 0:
        raise ValueError("front_pack: no columns")
    for c in cols:
        _check_operand(c, (I32,), "front_pack column", lanes)
        if c.shape != valid.shape:
            raise ValueError("front_pack: a column and the valid mask differ in shape")
    shape = (*valid.shape, C)
    if out is None:
        out = torch.empty(shape, dtype=I32, device=valid.device)
    if lanes is None:
        _check_out(out, shape, I32, "front_pack")
    else:
        _check_lane_out(out, shape, "front_pack_lanes")
    if not _on_card(valid, out, *cols):
        out.copy_((plain_front_pack if lanes is None else plain_front_pack_lanes)(valid, cols))
        return out
    W, B = valid.shape[-1], 1 if lanes is None else lanes
    if W == 0 or B == 0:
        return out
    lib = _kernels.load()
    ranks = value_cumsum(valid)
    for c0 in range(0, C, _PACK_COLS):
        chunk = cols[c0 : c0 + _PACK_COLS]
        ptrs = (ctypes.c_void_p * len(chunk))(*(c.data_ptr() for c in chunk))
        _launch(
            "front_pack" if lanes is None else "front_pack_lanes",
            lib.csr_front_pack_lanes,
            valid.data_ptr(),
            ranks.data_ptr(),
            W,
            B,
            ctypes.cast(ptrs, ctypes.c_void_p),
            len(chunk),
            c0,
            C,
            out.data_ptr(),
            0 if lanes is None else out.stride(0),
            _stream(valid),
        )
    return out


def plain_replay_meta(
    data: torch.Tensor, count: torch.Tensor, overflow: torch.Tensor
) -> torch.Tensor:
    """``[count, overflow, fits16]``: fits16 is 1 when every value of the
    first ``count`` rows lies strictly inside (-32768, 32767), as the
    reference's `_fits16_flag` (padding reads as 0)."""
    live = torch.arange(data.shape[0], dtype=I32, device=data.device) < count
    masked = torch.where(live[:, None], data, 0)
    if masked.numel():
        fits = (masked.max() < 32767) & (masked.min() > -32768)
    else:
        fits = torch.ones((), dtype=torch.bool, device=data.device)
    return torch.stack([count.to(I32), overflow.to(I32), fits.to(I32)])


def plain_replay_meta_lanes(
    data: torch.Tensor, count: torch.Tensor, overflow: torch.Tensor
) -> torch.Tensor:
    """The lane form's plain version: lane b's `plain_replay_meta`."""
    if data.shape[0] == 0:
        return torch.zeros((0, 3), dtype=I32, device=data.device)
    return torch.stack([plain_replay_meta(data[b], count[b], overflow[b]) for b in range(data.shape[0])])


def replay_meta_lanes(
    data: torch.Tensor,
    count: torch.Tensor,
    overflow: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K7's lane form: the meta row of each lane, int32 [B, 3], from its
    front-packed [W, C] page of ``data`` [B, W, C] (lanes at any stride),
    its count and its flag (int32 [B] each); ``out`` may place the rows at
    any stride (a direct-fetch stack's tails). On the card one launch, a
    block a lane."""
    if data.dim() != 3:
        raise ValueError("replay_meta_lanes data: expected an int32 [B, W, C] tensor")
    return _replay_meta(data, count, overflow, out)


def replay_meta(
    data: torch.Tensor,
    count: torch.Tensor,
    overflow: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The meta row of a replay's result, int32 [3]: the live count, the
    overflow flag and the int16 election flag over the front-packed
    int32 [W, C] ``data``. ``out`` (optional) receives the row. Lane-stacked
    [B, W, C] pages give [B, 3] (`replay_meta_lanes`)."""
    if data.dim() == 3:
        return replay_meta_lanes(data, count, overflow, out)
    return _replay_meta(data, count, overflow, out)


def _replay_meta(data, count, overflow, out: Optional[torch.Tensor]) -> torch.Tensor:
    """K7's one launch path for a [W, C] page (a lane) and [B, W, C] pages
    (a block a lane)."""
    lanes = data.shape[0] if data.dim() == 3 else None
    if lanes is None:
        if data.dtype != I32 or data.dim() != 2 or not data.is_contiguous():
            raise ValueError("replay_meta data: expected a contiguous int32 [W, C] tensor")
    else:
        _check_lane_out(data, tuple(data.shape), "replay_meta_lanes data")
    lead = data.shape[:-2]
    for t, what in ((count, "count"), (overflow, "overflow")):
        if t.dtype != I32 or t.shape != lead or not t.is_contiguous():
            raise TypeError(f"replay_meta {what}: expected a contiguous int32 tensor of shape {tuple(lead)}")
    if out is None:
        out = torch.empty((*lead, 3), dtype=I32, device=data.device)
    if lanes is None:
        _check_out(out, (3,), I32, "replay_meta")
    else:
        _check_lane_out(out, (lanes, 3), "replay_meta_lanes")
    if not _on_card(data, count, overflow, out):
        out.copy_((plain_replay_meta if lanes is None else plain_replay_meta_lanes)(data, count, overflow))
        return out
    lib = _kernels.load()
    _launch(
        "replay_meta" if lanes is None else "replay_meta_lanes",
        lib.csr_replay_meta_lanes,
        data.data_ptr(),
        data.shape[-2],
        data.shape[-1],
        1 if lanes is None else lanes,
        0 if lanes is None else data.stride(0),
        count.data_ptr(),
        overflow.data_ptr(),
        out.data_ptr(),
        0 if lanes is None else out.stride(0),
        _stream(data),
    )
    return out


def plain_narrow_i16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int16)


def narrow_i16(x: torch.Tensor) -> torch.Tensor:
    """int32 → int16 keeping the low 16 bits (XLA's and torch's cast)."""
    if x.dtype != I32 or not x.is_contiguous():
        raise ValueError("narrow_i16: expected a contiguous int32 tensor")
    if not _on_card(x):
        return plain_narrow_i16(x)
    lib = _kernels.load()
    out = torch.empty(x.shape, dtype=torch.int16, device=x.device)
    _launch("narrow_i16", lib.csr_narrow_i16, x.data_ptr(), x.numel(), out.data_ptr(), _stream(x))
    return out


# ---------------------------------------------------------------------------
# K9–K12: the bitmap BFS (variable-depth arms, NOT arms)
# ---------------------------------------------------------------------------

B8 = torch.bool


def plain_rows_to_bitmap(rows: torch.Tensor, vb: int) -> torch.Tensor:
    """The reference's ``zeros.at[arange(C), clip(rows)].max(rows >= 0)``."""
    C = rows.shape[0]
    out = torch.zeros((C, vb), dtype=torch.uint8, device=rows.device)
    if C and vb:
        r = rows.clamp(0, vb - 1).long()
        out.scatter_(1, r[:, None], (rows >= 0).to(torch.uint8)[:, None])
    return out.bool()


def rows_to_bitmap(rows: torch.Tensor, vb: int) -> torch.Tensor:
    """[C] vertex ids (-1 = none) → [C, vb] one-hot frontier bitmap."""
    _check(rows, (I32,), "rows_to_bitmap rows")
    if not _on_card(rows):
        return plain_rows_to_bitmap(rows, vb)
    lib = _kernels.load()
    out = torch.empty((rows.shape[0], vb), dtype=B8, device=rows.device)
    _launch(
        "rows_to_bitmap",
        lib.csr_rows_to_bitmap,
        rows.data_ptr(),
        rows.shape[0],
        vb,
        out.data_ptr(),
        _stream(rows),
    )
    return out


def plain_bitmap_hop(
    act_idx: torch.Tensor,
    emit_idx: torch.Tensor,
    edge_mask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The reference's hop: ``act = frontier[:, clip(act_idx)] & mask``,
    scattered by max into the clipped ``emit_idx`` columns. The scatter
    stores True at every active (row, edge) pair and nothing else, so
    duplicate targets are exact (an unconditional store of ``act`` would
    let a False overwrite a True). It materialises the [C, E] activity.
    ``gate`` is ANDed into the frontier first; ``alive`` (the frontier's
    popcount, or 0) zeroes the result on the device as the kernel's early
    exit does."""
    C, vb = frontier.shape
    out = torch.zeros((C, vb), dtype=B8, device=frontier.device)
    E = act_idx.shape[0]
    if E == 0 or C == 0 or vb == 0:
        return out
    fr = frontier if gate is None else frontier & gate[None, :]
    act = fr[:, act_idx.clamp(0, vb - 1).long()]
    if edge_mask is not None:
        act = act & edge_mask[None, :]
    if alive is not None:
        act = act & (alive != 0)
    rows, edges = act.nonzero(as_tuple=True)
    cols = emit_idx.clamp(0, vb - 1).long()[edges]
    out.view(-1)[rows * vb + cols] = True
    return out


def bitmap_hop(
    act_idx: torch.Tensor,
    emit_idx: torch.Tensor,
    edge_mask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One frontier hop over an edge list as dense bitmaps:
    ``out[c, emit_idx[e]] |= frontier[c, act_idx[e]] & edge_mask[e]``.

    act_idx/emit_idx int32 [E] are the endpoint that must be in the
    frontier and the endpoint reached (swapped to walk edges backwards);
    ``edge_mask`` bool [E] or None (every edge); ``frontier`` bool [C, vb].
    ``gate`` (bool [vb], optional) restricts the active endpoints (a WHILE
    condition); ``alive`` (0-d int32, optional) must be the frontier's
    popcount: at 0 the kernel returns without reading the edge list. With
    ``out`` the hop ORs into it (a second direction or edge class), else
    into a new zeroed bitmap. Returns the bitmap."""
    _check(act_idx, (I32,), "bitmap_hop act_idx")
    _check(emit_idx, (I32,), "bitmap_hop emit_idx")
    _check2d(frontier, (B8,), "bitmap_hop frontier")
    E = act_idx.shape[0]
    C, vb = frontier.shape
    if emit_idx.shape[0] != E:
        raise ValueError("bitmap_hop: act_idx and emit_idx differ in length")
    opt = []
    if edge_mask is not None:
        _check(edge_mask, (B8,), "bitmap_hop edge_mask")
        if edge_mask.shape[0] != E:
            raise ValueError("bitmap_hop: edge_mask and the edge list differ in length")
        opt.append(edge_mask)
    if gate is not None:
        _check(gate, (B8,), "bitmap_hop gate")
        if gate.shape[0] != vb:
            raise ValueError("bitmap_hop: gate and the frontier differ in width")
        opt.append(gate)
    if alive is not None:
        _check_scalar(alive, "bitmap_hop alive")
        opt.append(alive)
    if out is not None:
        _check_out(out, (C, vb), B8, "bitmap_hop")
        opt.append(out)
    if not _on_card(act_idx, emit_idx, frontier, *opt):
        hop = plain_bitmap_hop(act_idx, emit_idx, edge_mask, frontier, gate, alive)
        if out is None:
            return hop
        out |= hop
        return out
    lib = _kernels.load()
    zero = out is None
    if zero:
        out = torch.empty((C, vb), dtype=B8, device=frontier.device)
    _launch(
        "bitmap_hop",
        lib.csr_bitmap_hop,
        act_idx.data_ptr(),
        emit_idx.data_ptr(),
        None if edge_mask is None else edge_mask.data_ptr(),
        E,
        frontier.data_ptr(),
        None if gate is None else gate.data_ptr(),
        C,
        vb,
        None if alive is None else alive.data_ptr(),
        int(zero),
        out.data_ptr(),
        _stream(frontier),
    )
    return out


def plain_bitmap_hop_csr(
    indptr: torch.Tensor,
    nbr: torch.Tensor,
    eid: Optional[torch.Tensor],
    edge_mask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The reference's hop over the edge list a CSR expands to: row ``v``'s
    slots activate on ``v`` and emit ``nbr[slot]``, the mask read at
    ``take_pad(edge_mask, eid[slot], False)`` (at the slot without
    ``eid``), as `plain_bitmap_hop` scatters them; walked from the set
    (row, vertex) pairs of the gated frontier, so that it costs the active
    edges, not [C, E]."""
    C, vb = frontier.shape
    dev = frontier.device
    out = torch.zeros((C, vb), dtype=B8, device=dev)
    nv = min(indptr.shape[0] - 1, vb)
    if C == 0 or nv <= 0:
        return out
    fr = frontier[:, :nv]
    if gate is not None:
        fr = fr & gate[None, :nv]
    if alive is not None:
        fr = fr & (alive != 0)
    r, v = fr.nonzero(as_tuple=True)
    start = indptr[v].long()
    deg = indptr[v + 1].long() - start
    rep = torch.repeat_interleave(torch.arange(v.shape[0], device=dev), deg)
    slots = start[rep] + torch.arange(rep.shape[0], device=dev) - (torch.cumsum(deg, 0) - deg)[rep]
    if edge_mask is not None:
        m = edge_mask[slots] if eid is None else plain_take_pad(edge_mask, eid[slots], False)
        rep, slots = rep[m], slots[m]
    cols = nbr[slots].clamp(0, vb - 1).long()
    out.view(-1)[r[rep] * vb + cols] = True
    return out


class SlabIndex(NamedTuple):
    """A delta slab's endpoint index for one (class, direction), as
    `storage/deltas.SnapshotOverlay` keeps it: ``tab`` int32 [nb * bk] holds
    relative slab slots (-1 empty), bucket ``endpoint & (nb - 1)``; ``own``
    / ``nbr`` int32 and ``live`` bool, one entry an edge slot, are the
    endpoint that must be active, the endpoint reached and liveness; the
    slab's slots start at edge slot ``base``."""

    tab: torch.Tensor
    own: torch.Tensor
    nbr: torch.Tensor
    live: torch.Tensor
    base: int
    nb: int
    bk: int


def plain_bucket_hop(
    probe: SlabIndex,
    edge_mask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    hi: Optional[int] = None,
) -> torch.Tensor:
    """The slab probe's hop in torch: each vertex below ``hi`` (default vb)
    active in some frontier row (and in ``gate``, with ``alive`` not 0)
    reads its bucket ``v & (nb - 1)``; an entry ``rel >= 0`` at slot ``at =
    base + rel`` is kept where ``at`` lies below the edge count, ``own[at]
    == v``, ``live[at]`` and ``take_pad(edge_mask, at, False)``; then
    `plain_bitmap_hop` over the kept entries (active endpoint ``v``,
    reached ``nbr[at]``)."""
    C, vb = frontier.shape
    dev = frontier.device
    ecap = probe.own.shape[0]
    fa = frontier.any(0)
    if gate is not None:
        fa = fa & gate
    if alive is not None:
        fa = fa & (alive != 0)
    v = fa[: vb if hi is None else min(hi, vb)].nonzero().view(-1)
    if C == 0 or ecap == 0 or probe.nb * probe.bk == 0:
        return torch.zeros((C, vb), dtype=B8, device=dev)
    rel = probe.tab.view(probe.nb, probe.bk)[v & (probe.nb - 1)].long()
    at = probe.base + rel
    ok = (rel >= 0) & (at < ecap)
    atc = at.clamp(0, ecap - 1)
    ok = ok & (probe.own[atc].long() == v[:, None]) & probe.live[atc]
    if edge_mask is not None:
        ok = ok & plain_take_pad(edge_mask, atc.view(-1), False).view(atc.shape)
    act = v[:, None].expand_as(atc).reshape(-1).to(I32)
    return plain_bitmap_hop(act, probe.nbr[atc].reshape(-1), ok.reshape(-1), frontier, gate, alive)


#: the most lanes of a bitmap lane form (one grid row a lane)
_GRID_LANES = 65535


def _check_stack(t: torch.Tensor, what: str) -> None:
    """`_check2d` for a lane form's bitmap stack: bool [B, C, vb], B lanes
    of C rows (row c of lane b is ``t[b, c]``), at most a grid's rows."""
    if t.dtype != B8:
        raise TypeError(f"{what}: dtype {t.dtype} is not torch.bool")
    if t.dim() != 3:
        raise ValueError(f"{what}: expected a [B, C, vb] stack, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if t.shape[0] > _GRID_LANES:
        raise ValueError(f"{what}: {t.shape[0]} lanes, at most {_GRID_LANES}")


def _lane_vec(vec: Optional[torch.Tensor], B: int, vb: int, what: str) -> int:
    """Checks a shared [vb] or lane-stacked [B, vb] bool vector; returns 1
    when it is lane-stacked (its kernel reads row ``lane``)."""
    if vec is None:
        return 0
    if vec.dim() == 2:
        _check2d(vec, (B8,), what)
        if vec.shape != (B, vb):
            raise ValueError(f"{what}: shape {tuple(vec.shape)} is not [{B}, {vb}]")
        return 1
    _check(vec, (B8,), what)
    if vec.shape[0] != vb:
        raise ValueError(f"{what}: {vec.shape[0]} entries for bitmap rows of {vb}")
    return 0


def _check_bound(bound: torch.Tensor, rows, what: str) -> None:
    """A close arm's bound column: int32, one a bitmap row ([C], or [B, C]
    for a lane form's stack)."""
    if len(rows) == 2:
        _check2d(bound, (I32,), f"{what} bound")
    else:
        _check(bound, (I32,), f"{what} bound")
    if tuple(bound.shape) != tuple(rows):
        raise ValueError(f"{what}: bound and bitmap differ in rows")


def plain_bitmap_hop_csr_lanes(
    indptr: torch.Tensor,
    nbr: torch.Tensor,
    eid: Optional[torch.Tensor],
    edge_mask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The lane form's plain version: lane b of the ``[B, C, vb]`` frontier
    hops as `plain_bitmap_hop_csr` hops it with lane b's gate row (or the
    shared gate) and ``alive[b]``: the gate and the alive test applied to
    each lane's rows first, then one hop of every row."""
    B, C, vb = frontier.shape
    fr = frontier
    if gate is not None:
        fr = fr & gate.view(-1, 1, vb)
    if alive is not None:
        fr = fr & (alive != 0).view(B, 1, 1)
    return plain_bitmap_hop_csr(indptr, nbr, eid, edge_mask, fr.reshape(B * C, vb)).view(B, C, vb)


def bitmap_hop_csr_lanes(
    indptr: torch.Tensor,
    nbr: torch.Tensor,
    eid: Optional[torch.Tensor],
    edge_mask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K10's lane form (the reference's ``jax.vmap`` of `bitmap_hop` over a
    group's lanes): the frontier holds B lanes of C rows, bool [B, C, vb];
    ``alive`` int32 [B] is each lane's frontier popcount (a lane at 0 adds
    nothing), ``gate`` a bool [vb] the lanes share or [B, vb] (a WHILE that
    reads a parameter). ``out`` ([B, C, vb]) as for `bitmap_hop_csr`, ORed
    in place. One launch for all lanes (the single form's kernel and entry
    point, a lane a grid row)."""
    _check_stack(frontier, "bitmap_hop_csr_lanes frontier")
    return _bitmap_hop_csr(indptr, nbr, eid, edge_mask, frontier, gate, alive, out, None)


def bitmap_hop_csr(
    indptr: torch.Tensor,
    nbr: torch.Tensor,
    eid: Optional[torch.Tensor],
    edge_mask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    probe: Optional[SlabIndex] = None,
) -> torch.Tensor:
    """`bitmap_hop` walked by the endpoint that must be active, reading only
    the active vertices' adjacency:
    ``out[c, nbr[s]] |= frontier[c, v] & edge_mask[eid[s]]`` for each slot
    ``s`` of row ``v``.

    ``indptr`` int32 [nv + 1] (nv ≤ vb) has a row for each active endpoint
    (``indptr_out`` for an out hop, ``indptr_in`` for an in hop), ``nbr``
    int32 the endpoint each slot reaches (``dst`` / ``src``); ``eid``
    (int32, one a slot, or None) maps a slot to its out-order edge id, read
    only to index ``edge_mask`` (bool, in out order; without ``eid`` it is
    indexed by slot and has one entry a slot). ``gate``, ``alive`` and
    ``out`` as for `bitmap_hop`. With ``probe`` (a `SlabIndex`) the same
    launch also walks each active vertex's slab edges through its bucket
    (`plain_bucket_hop`; ``edge_mask`` is then indexed by out-order edge id,
    the slab's slots included): the hop over the CSR and the slab of a
    delta-maintained snapshot, exact while no bucket of the class filled,
    for the vertices below nv. A lane-stacked frontier (bool [B, C, vb])
    makes it the lane form (`bitmap_hop_csr_lanes`). Returns the bitmap."""
    if frontier.dim() == 3:
        if probe is not None:
            raise ValueError("bitmap_hop_csr: the lane form takes no slab probe")
        return bitmap_hop_csr_lanes(indptr, nbr, eid, edge_mask, frontier, gate, alive, out)
    _check2d(frontier, (B8,), "bitmap_hop_csr frontier")
    return _bitmap_hop_csr(indptr, nbr, eid, edge_mask, frontier, gate, alive, out, probe)


def _bitmap_hop_csr(indptr, nbr, eid, edge_mask, frontier, gate, alive, out, probe) -> torch.Tensor:
    """K10's CSR push for one [C, vb] frontier, or for B lanes of C rows
    stacked as [B, C, vb] (a checked frontier)."""
    lanes = frontier.dim() == 3
    what = "bitmap_hop_csr_lanes" if lanes else "bitmap_hop_csr"
    _check(indptr, (I32,), f"{what} indptr")
    _check(nbr, (I32,), f"{what} nbr")
    B, C, vb = frontier.shape if lanes else (1, *frontier.shape)
    nv = indptr.shape[0] - 1
    if nv < 0 or nv > vb:
        raise ValueError(f"bitmap_hop_csr: {nv} rows for a frontier {vb} wide")
    opt = []
    if eid is not None:
        _check(eid, (I32,), "bitmap_hop_csr eid")
        if eid.shape[0] != nbr.shape[0]:
            raise ValueError("bitmap_hop_csr: eid and nbr differ in length")
        opt.append(eid)
    ne = 0
    if edge_mask is not None:
        _check(edge_mask, (B8,), "bitmap_hop_csr edge_mask")
        ne = edge_mask.shape[0]
        if eid is None and ne != nbr.shape[0]:
            raise ValueError("bitmap_hop_csr: edge_mask indexed by slot differs from nbr in length")
        opt.append(edge_mask)
    gate_lanes = 0
    if gate is not None:
        if lanes:
            gate_lanes = _lane_vec(gate, B, vb, f"{what} gate")
        else:
            _check(gate, (B8,), "bitmap_hop_csr gate")
            if gate.shape[0] != vb:
                raise ValueError("bitmap_hop_csr: gate and the frontier differ in width")
        opt.append(gate)
    if alive is not None:
        if not lanes:
            _check_scalar(alive, "bitmap_hop_csr alive")
        elif alive.dtype != I32 or alive.shape != (B,):
            raise TypeError(f"{what} alive: expected int32 [{B}]")
        opt.append(alive)
    if out is not None:
        _check_out(out, frontier.shape, B8, what)
        opt.append(out)
    if probe is not None:
        _check_probe(probe, edge_mask)
        opt.extend((probe.tab, probe.own, probe.nbr, probe.live))
    if not _on_card(indptr, nbr, frontier, *opt):
        plain = plain_bitmap_hop_csr_lanes if lanes else plain_bitmap_hop_csr
        hop = plain(indptr, nbr, eid, edge_mask, frontier, gate, alive)
        if probe is not None:
            hop |= plain_bucket_hop(probe, edge_mask, frontier, gate, alive, nv)
        if out is None:
            return hop
        out |= hop
        return out
    lib = _kernels.load()
    zero = out is None
    if zero:
        out = torch.empty(frontier.shape, dtype=B8, device=frontier.device)
    head = (
        indptr.data_ptr(),
        nv,
        nbr.data_ptr(),
        None if eid is None or edge_mask is None else eid.data_ptr(),
        None if edge_mask is None else edge_mask.data_ptr(),
        ne,
    )
    tail = (
        frontier.data_ptr(),
        None if gate is None else gate.data_ptr(),
        C,
        vb,
        None if alive is None else alive.data_ptr(),
        int(zero),
        out.data_ptr(),
    )
    if probe is None:
        _launch(what, lib.csr_bitmap_hop_csr, *head, *tail, B, gate_lanes, _stream(frontier))
        return out
    slab = (
        probe.tab.data_ptr(),
        probe.own.data_ptr(),
        probe.nbr.data_ptr(),
        probe.live.data_ptr(),
        probe.base,
        probe.own.shape[0],
        probe.nb,
        probe.bk,
    )
    _launch("bitmap_hop_probe", lib.csr_bitmap_hop_probe, *head, *slab, *tail, _stream(frontier))
    return out


def _check_probe(probe: SlabIndex, edge_mask: Optional[torch.Tensor]) -> None:
    for t, what in ((probe.tab, "tab"), (probe.own, "own"), (probe.nbr, "nbr")):
        _check(t, (I32,), f"bitmap_hop_csr probe {what}")
    _check(probe.live, (B8,), "bitmap_hop_csr probe live")
    ecap = probe.own.shape[0]
    if probe.nbr.shape[0] != ecap or probe.live.shape[0] != ecap:
        raise ValueError("bitmap_hop_csr: the probe's own, nbr and live differ in length")
    if probe.nb <= 0 or probe.nb & (probe.nb - 1) or probe.bk <= 0 or probe.tab.shape[0] != probe.nb * probe.bk:
        raise ValueError("bitmap_hop_csr: the probe's table is not nb (a power of two) × bk entries")
    if not 0 <= probe.base <= ecap:
        raise ValueError("bitmap_hop_csr: the probe's slab base lies outside the edge slots")
    if edge_mask is not None and edge_mask.shape[0] != ecap:
        raise ValueError("bitmap_hop_csr: with a probe the edge mask has one entry an edge slot")


def _plain_push(lo: int, hi: int, row, slot, edge, nbr_flat, emask, frontier, gate, alive) -> torch.Tensor:
    """The push walk of K10's row forms (`bitmap_hop_shard`,
    `paged_hop_csr`) in torch: the vertices of ``[lo, hi)`` (below vb)
    active in some frontier row, in ``gate`` and with ``alive`` not 0; each
    one's slot base, operand and degree from ``row``, its ``j``-th slot
    from ``slot(base, operand, j)`` and that slot's edge id from
    ``edge(slot, operand)``; then `plain_bitmap_hop` over the slots reached,
    the mask read through the edge ids as ``take_pad(emask, id, False)``."""
    C, vb = frontier.shape
    dev = frontier.device
    hi = min(hi, vb)
    if hi <= lo or C == 0:
        return torch.zeros((C, vb), dtype=B8, device=dev)
    fa = frontier[:, lo:hi].any(0)
    if gate is not None:
        fa = fa & gate[lo:hi]
    if alive is not None:
        fa = fa & (alive != 0)
    v = fa.nonzero().view(-1) + lo
    base, aux, deg = row(v)
    deg = deg.clamp(min=0)
    rep = torch.repeat_interleave(torch.arange(v.shape[0], device=dev), deg)
    j = torch.arange(rep.shape[0], device=dev) - (torch.cumsum(deg, 0) - deg)[rep]
    s = slot(base[rep], aux[rep], j)
    m = None if emask is None else plain_take_pad(emask, edge(s, aux[rep]), False)
    return plain_bitmap_hop(v[rep].to(I32), nbr_flat[s], m, frontier, gate, alive)


EmitResult =Tuple[Optional[torch.Tensor], Optional[torch.Tensor], Optional[torch.Tensor]]


def plain_bitmap_emit(
    reached: torch.Tensor,
    node: torch.Tensor,
    bound: Optional[torch.Tensor] = None,
    emit: bool = True,
    any_row: bool = False,
    count: bool = False,
) -> EmitResult:
    """The reference's `_var_emit_mask`, with its per-row any and its
    int32 popcount."""
    e = reached & node[None, :]
    if bound is not None:
        vcol = torch.arange(reached.shape[1], dtype=I32, device=reached.device)
        e = e & (vcol[None, :] == bound[:, None])
    return (
        e if emit else None,
        e.any(dim=1) if any_row else None,
        e.sum(dtype=I32) if count else None,
    )


def plain_bitmap_emit_lanes(
    reached: torch.Tensor,
    node: torch.Tensor,
    bound: Optional[torch.Tensor] = None,
    emit: bool = True,
    any_row: bool = False,
    count: bool = False,
) -> EmitResult:
    """The lane form's plain version: lane b of the ``[B, C, vb]`` stack
    through `plain_bitmap_emit` with lane b's node row (or the shared node)
    and bound row, its count one int32 a lane."""
    B, C, vb = reached.shape
    e = reached & node.view(-1, 1, vb)
    if bound is not None:
        vcol = torch.arange(vb, dtype=I32, device=reached.device)
        e = e & (vcol.view(1, 1, vb) == bound.view(B, C, 1))
    return (
        e if emit else None,
        e.any(dim=2) if any_row else None,
        e.sum(dim=(1, 2), dtype=I32) if count else None,
    )


def bitmap_emit_lanes(
    reached: torch.Tensor,
    node: torch.Tensor,
    bound: Optional[torch.Tensor] = None,
    emit: bool = True,
    any_row: bool = False,
    count: bool = False,
) -> EmitResult:
    """K11's lane form (the reference's ``jax.vmap`` of `_var_emit_mask`,
    its level sums and the NOT arm's any): ``reached`` holds B lanes of C
    rows, bool [B, C, vb]; ``node`` is a bool [vb] the lanes share or [B,
    vb], ``bound`` int32 [B, C]. Returns ``(bitmap [B, C, vb], any [B, C],
    popcount int32 [B])``, each None unless asked for: the count is each
    lane's own. One launch for all lanes (the single form's kernel and
    entry point, a lane a grid row)."""
    _check_stack(reached, "bitmap_emit_lanes reached")
    return _bitmap_emit(reached, node, bound, emit, any_row, count)


def bitmap_emit(
    reached: torch.Tensor,
    node: torch.Tensor,
    bound: Optional[torch.Tensor] = None,
    emit: bool = True,
    any_row: bool = False,
    count: bool = False,
) -> EmitResult:
    """One BFS level's emission: ``reached & node[None, :]``, restricted to
    column ``bound[c]`` in row c when ``bound`` (int32 [C]) is given (a
    close arm's bound endpoint; a negative bound matches nothing).
    Returns ``(bitmap, per-row any, popcount)``, each None unless asked
    for: bool [C, vb], bool [C] and a 0-d int32. A lane-stacked ``reached``
    (bool [B, C, vb]) makes it the lane form (`bitmap_emit_lanes`)."""
    if reached.dim() == 3:
        return bitmap_emit_lanes(reached, node, bound, emit=emit, any_row=any_row, count=count)
    _check2d(reached, (B8,), "bitmap_emit reached")
    return _bitmap_emit(reached, node, bound, emit, any_row, count)


def _bitmap_emit(reached, node, bound, emit, any_row, count) -> EmitResult:
    """K11 for one [C, vb] bitmap, or for B lanes of C rows stacked as [B,
    C, vb] (a checked ``reached``)."""
    lanes = reached.dim() == 3
    what = "bitmap_emit_lanes" if lanes else "bitmap_emit"
    B, C, vb = reached.shape if lanes else (1, *reached.shape)
    if lanes:
        node_lanes = _lane_vec(node, B, vb, f"{what} node")
    else:
        _check(node, (B8,), "bitmap_emit node")
        if node.shape[0] != vb:
            raise ValueError("bitmap_emit: node mask and bitmap differ in width")
        node_lanes = 0
    opt = []
    if bound is not None:
        _check_bound(bound, reached.shape[:-1], what)
        opt.append(bound)
    if not _on_card(reached, node, *opt):
        plain = plain_bitmap_emit_lanes if lanes else plain_bitmap_emit
        return plain(reached, node, bound, emit, any_row, count)
    lib = _kernels.load()
    dev = reached.device
    e_out = torch.empty(reached.shape, dtype=B8, device=dev) if emit else None
    a_out = torch.empty(reached.shape[:-1], dtype=B8, device=dev) if any_row else None
    c_out = torch.empty((B,) if lanes else (), dtype=I32, device=dev) if count else None
    _launch(
        what,
        lib.csr_bitmap_emit,
        reached.data_ptr(),
        node.data_ptr(),
        None if bound is None else bound.data_ptr(),
        C,
        vb,
        None if e_out is None else e_out.data_ptr(),
        None if a_out is None else a_out.data_ptr(),
        None if c_out is None else c_out.data_ptr(),
        B,
        node_lanes,
        _stream(reached),
    )
    return e_out, a_out, c_out


AdvanceResult = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


def plain_frontier_advance(
    nxt: torch.Tensor,
    visited: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    node: Optional[torch.Tensor] = None,
    bound: Optional[torch.Tensor] = None,
) -> AdvanceResult:
    nxt &= ~visited
    if gate is not None:
        nxt &= gate[None, :]
    visited |= nxt
    alive = nxt.sum(dtype=I32)
    if node is None:
        return alive
    return alive, plain_bitmap_emit(nxt, node, bound, emit=False, count=True)[2]


def plain_frontier_advance_lanes(
    nxt: torch.Tensor,
    visited: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    node: Optional[torch.Tensor] = None,
    bound: Optional[torch.Tensor] = None,
) -> AdvanceResult:
    """The lane form's plain version: lane b of the ``[B, C, vb]`` stacks
    stepped as `plain_frontier_advance` steps them with lane b's gate and
    node rows (or the shared ones), its counts one int32 a lane."""
    vb = nxt.shape[2]
    nxt &= ~visited
    if gate is not None:
        nxt &= gate.view(-1, 1, vb)
    visited |= nxt
    alive = nxt.sum(dim=(1, 2), dtype=I32)
    if node is None:
        return alive
    return alive, plain_bitmap_emit_lanes(nxt, node, bound, emit=False, count=True)[2]


def frontier_advance_lanes(
    nxt: torch.Tensor,
    visited: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    node: Optional[torch.Tensor] = None,
    bound: Optional[torch.Tensor] = None,
) -> AdvanceResult:
    """K12's lane form (the reference's ``jax.vmap`` of the level step):
    both bitmaps hold B lanes of C rows, bool [B, C, vb], stepped in place
    as `frontier_advance` steps them; ``gate`` and ``node`` are a bool [vb]
    the lanes share or [B, vb], ``bound`` int32 [B, C]. Returns each lane's
    alive count, int32 [B], or with ``node`` ``(alive, emitted)``, both
    [B]. One launch for all lanes (the single form's kernel and entry
    point, a lane a grid row)."""
    _check_stack(nxt, "frontier_advance_lanes nxt")
    return _frontier_advance(nxt, visited, gate, node, bound)


def frontier_advance(
    nxt: torch.Tensor,
    visited: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    node: Optional[torch.Tensor] = None,
    bound: Optional[torch.Tensor] = None,
) -> AdvanceResult:
    """The BFS level step, in place on both bitmaps: ``nxt &= ~visited;
    visited |= nxt``. With ``gate`` (bool [vb], broadcast over the rows),
    TRAVERSE's admission: ``nxt &= ~visited & gate[None, :]`` first, so a
    vertex the gate rejects is neither kept nor marked visited. Returns the
    popcount of the new ``nxt`` as a 0-d int32 (the level's alive count).
    With ``node`` (bool [vb]) it returns ``(alive, emitted)``: ``emitted``
    is `bitmap_emit`'s count over the new ``nxt`` (``bound``, int32 [C],
    as there), from the same pass. Lane-stacked bitmaps (bool [B, C, vb])
    make it the lane form (`frontier_advance_lanes`)."""
    if nxt.dim() == 3:
        return frontier_advance_lanes(nxt, visited, gate, node, bound)
    _check2d(nxt, (B8,), "frontier_advance nxt")
    return _frontier_advance(nxt, visited, gate, node, bound)


def _frontier_advance(nxt, visited, gate, node, bound) -> AdvanceResult:
    """K12 for one pair of [C, vb] bitmaps, or for B lanes of C rows stacked
    as [B, C, vb] (a checked ``nxt``)."""
    lanes = nxt.dim() == 3
    what = "frontier_advance_lanes" if lanes else "frontier_advance"
    if visited.dtype != B8 or not visited.is_contiguous():
        raise TypeError(f"{what} visited: expected a contiguous bool tensor")
    if nxt.shape != visited.shape:
        raise ValueError(f"{what}: bitmaps differ in shape")
    B, C, vb = nxt.shape if lanes else (1, *nxt.shape)
    ts = [nxt, visited]
    stacked = {}
    for vec, name in ((gate, "gate"), (node, "node")):
        if vec is not None:
            if lanes:
                stacked[name] = _lane_vec(vec, B, vb, f"{what} {name}")
            else:
                _check(vec, (B8,), f"frontier_advance {name}")
                if vec.shape[0] != vb:
                    raise ValueError(f"frontier_advance: {name} and bitmap rows differ in length")
            ts.append(vec)
    if bound is not None:
        if node is None:
            raise ValueError(f"{what}: bound without node")
        _check_bound(bound, nxt.shape[:-1], what)
        ts.append(bound)
    if not _on_card(*ts):
        plain = plain_frontier_advance_lanes if lanes else plain_frontier_advance
        return plain(nxt, visited, gate, node, bound)
    lib = _kernels.load()
    shape = (B,) if lanes else ()
    count = torch.empty(shape, dtype=I32, device=nxt.device)
    emitted = None if node is None else torch.empty(shape, dtype=I32, device=nxt.device)
    _launch(
        what,
        lib.csr_frontier_advance,
        nxt.data_ptr(),
        visited.data_ptr(),
        None if gate is None else gate.data_ptr(),
        None if node is None else node.data_ptr(),
        None if bound is None else bound.data_ptr(),
        C * vb,
        vb,
        count.data_ptr(),
        None if emitted is None else emitted.data_ptr(),
        B,
        stacked.get("gate", 0),
        stacked.get("node", 0),
        _stream(nxt),
    )
    return count if emitted is None else (count, emitted)


# ---------------------------------------------------------------------------
# K13: rows_with_matches (the OPTIONAL arm's left join)
# ---------------------------------------------------------------------------


def plain_rows_with_matches(
    rows: torch.Tensor, mask: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The reference's segment sum of the surviving slots by origin row,
    as an int32 index_add (ids outside ``[0, num_segments)`` dropped)."""
    out = torch.zeros(num_segments, dtype=I32, device=rows.device)
    if num_segments == 0 or rows.shape[0] == 0:
        return out
    ok = mask & (rows >= 0) & (rows < num_segments)
    out.index_add_(0, torch.where(ok, rows, 0).long(), ok.to(I32))
    return out


def plain_rows_with_matches_lanes(
    rows: torch.Tensor, mask: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """The lane form's plain version: `plain_rows_with_matches` a lane,
    stacked [B, num_segments]."""
    if rows.shape[0] == 0:
        return torch.zeros((0, num_segments), dtype=I32, device=rows.device)
    return torch.stack(
        [plain_rows_with_matches(rows[b], mask[b], num_segments) for b in range(rows.shape[0])]
    )


def rows_with_matches(
    rows: torch.Tensor,
    mask: torch.Tensor,
    num_segments: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per origin row, the count of surviving expansion slots:
    ``out[r] = #{i : mask[i] and rows[i] == r}`` for ``0 <= r <
    num_segments`` (int32 [num_segments]); ``rows`` int32 [W] with -1
    padding, ``mask`` bool [W]. With ``out`` the counts add into it (the
    next edge class or direction of the same arm), else into a new zeroed
    tensor. Returns the counts. Lane-local ``rows`` and ``mask`` [B, W]
    give [B, num_segments] (`rows_with_matches_lanes`)."""
    if rows.dim() == 2:
        return rows_with_matches_lanes(rows, mask, num_segments, out)
    _check(rows, (I32,), "rows_with_matches rows")
    _check(mask, (B8,), "rows_with_matches mask")
    if mask.shape[0] != rows.shape[0]:
        raise ValueError("rows_with_matches: rows and mask differ in length")
    opt = []
    if out is not None:
        _check_out(out, (num_segments,), I32, "rows_with_matches")
        opt.append(out)
    if not _on_card(rows, mask, *opt):
        got = plain_rows_with_matches(rows, mask, num_segments)
        if out is None:
            return got
        out += got
        return out
    return _rows_with_matches(rows, mask, num_segments, out, 1, "rows_with_matches")


def rows_with_matches_lanes(
    rows: torch.Tensor,
    mask: torch.Tensor,
    num_segments: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K13's lane form: ``out[b, r] = #{i : mask[b, i] and rows[b, i] ==
    r}`` over lane-local rows ``rows`` int32 [B, W] (-1 padding) and
    ``mask`` bool [B, W], int32 [B, num_segments]; with ``out`` the counts
    add into each lane's row. On the card one launch, a grid row a lane
    (the single form's kernel)."""
    _check2d(rows, (I32,), "rows_with_matches_lanes rows")
    _check2d(mask, (B8,), "rows_with_matches_lanes mask")
    if mask.shape != rows.shape:
        raise ValueError("rows_with_matches_lanes: rows and mask differ in shape")
    B = rows.shape[0]
    opt = []
    if out is not None:
        _check_out(out, (B, num_segments), I32, "rows_with_matches_lanes")
        opt.append(out)
    if not _on_card(rows, mask, *opt):
        got = plain_rows_with_matches_lanes(rows, mask, num_segments)
        if out is None:
            return got
        out += got
        return out
    return _rows_with_matches(rows, mask, num_segments, out, B, "rows_with_matches_lanes")


def _rows_with_matches(rows, mask, num_segments: int, out, lanes: int, name: str) -> torch.Tensor:
    """K13's one launch path: ``lanes`` rows of slots (1 for the single
    form), counted under ``name``."""
    lib = _kernels.load()
    zero = out is None
    if zero:
        shape = (lanes, num_segments) if rows.dim() == 2 else (num_segments,)
        out = torch.empty(shape, dtype=I32, device=rows.device)
    if lanes == 0:
        return out
    _launch(
        name,
        lib.csr_rows_with_matches_lanes,
        rows.data_ptr(),
        mask.data_ptr(),
        rows.shape[-1],
        lanes,
        num_segments,
        int(zero),
        out.data_ptr(),
        _stream(rows),
    )
    return out


# ---------------------------------------------------------------------------
# K14: the compact page of a batch's rows group
# ---------------------------------------------------------------------------


def plain_group_page(stack: torch.Tensor, B: int, n: int, fits16: bool) -> torch.Tensor:
    """The reference's ``d[:B, :, :n]`` (cast to int16 when ``fits16``) in
    the port's rows-leading layout, as a contiguous [B, n, C] page."""
    return stack[:B, :n].to(torch.int16 if fits16 else I32).contiguous()


def group_page(stack: torch.Tensor, B: int, n: int, fits16: bool) -> torch.Tensor:
    """The page a rows group ships after its meta wave: lanes ``[0, B)`` and
    rows ``[0, n)`` of the int32 [Bb, W, C] lane stack, as a contiguous
    [B, n, C] tensor, int16 (low 16 bits) when ``fits16``."""
    if stack.dtype != I32 or stack.dim() != 3 or not stack.is_contiguous():
        raise ValueError("group_page: expected a contiguous int32 [Bb, W, C] stack")
    Bb, W, C = stack.shape
    if not (0 <= B <= Bb and 0 <= n <= W):
        raise ValueError(f"group_page: page [{B}, {n}] outside the stack [{Bb}, {W}]")
    if not _on_card(stack):
        return plain_group_page(stack, B, n, fits16)
    out = torch.empty((B, n, C), dtype=torch.int16 if fits16 else I32, device=stack.device)
    if out.numel() == 0:
        return out
    lib = _kernels.load()
    _launch(
        "group_page",
        lib.csr_group_page,
        stack.data_ptr(),
        W,
        C,
        B,
        n,
        int(fits16),
        out.data_ptr(),
        _stream(stack),
    )
    return out


# ---------------------------------------------------------------------------
# K15: predicate_eval — a compiled WHERE program over the slots
# ---------------------------------------------------------------------------


class PredOp:
    """Opcodes of a predicate program (the kernel's `PredOp`). A program is
    an int32 [L, 4] array of postfix instructions ``(op, a, b, c)`` over a
    per-slot stack of (int32 bits, present) pairs; a mask is a pair whose
    ``present`` is the mask and whose value is 0. Buffer operands index the
    call's buffer list (``bufs``). A program whose root is an AND may end
    each conjunct with ``GUARD``: the slot's result is then the AND of every
    guarded conjunct's presence (with the final top's, if any), and the
    kernel stops reading buffers for a slot once a guard has rejected it."""

    COL = 1  # push column[id]: a values, b presence (padding-safe gather)
    BCOL = 2  # push column[rows[slot]]: a values, b presence, c binding rows
    CONST = 3  # push (a, b): value bits, present
    PARAM = 4  # push (params[a], 1)
    DEPTH = 5  # push (depth, 1)
    TMP = 6  # push (a[slot], b[slot]): an earlier launch's values / presence
    I2F = 7  # int32 → float32, rounding to nearest
    NEG = 8  # b: kind (0 int32, 1 float32)
    ARITH = 9  # a: ARITH_OPS index, b: kind, c: operands swapped on the stack
    CMP = 10  # a: CMP_OPS index, b: kind, c: swapped → mask
    TABLE = 11  # a: bool code table → present & table[clamp(v)]
    TRUTHY = 12  # b: kind → present & v != 0
    ISNULL = 13  # a: negated → present (IS NOT NULL) or its negation
    AND = 14
    OR = 15
    NOT = 16
    MASK = 17  # a: the constant mask bit
    CLASS = 18  # a: class ids (v_class), b: closure table → table[v_class[id]]
    VALID = 19  # id >= 0
    DIST = 20  # a: scale (float32 bits); pops lat1, lng1, lat2, lng2 (float32)
    ID = 21  # push (id, id >= 0): the slot's vertex id (a rid filter's operand)
    GUARD = 22  # pop a conjunct; AND its presence into the slot's live bit


ARITH_OPS = ("+", "-", "*", "/", "%")
CMP_OPS = ("=", "!=", "<", "<=", ">", ">=")
#: the most stack entries a program may need (kStack; the kernel sizes its
#: shared-memory stack by the program's own need) and the buffer table
#: (kMaxBufs); the compiler splits whatever would not fit into earlier launches
PRED_STACK = 16
PRED_BUFS = 32
#: the lane form's limits (kPredLanes, kPredLaneParams, kPredLaneEntries):
#: lanes a launch, parameters a lane, and shared-memory entries of a
#: thread's slots, the stack below the top plus the cached buffer loads
PRED_LANES = 64
PRED_LANE_PARAMS = 32
PRED_LANE_ENTRIES = 20
_DEG2RAD = 0.017453292519943295  # pi / 180, the reference's deg2rad factor


#: each opcode's change to the stack's depth
_PRED_EFFECT = {
    **dict.fromkeys(
        (PredOp.COL, PredOp.BCOL, PredOp.CONST, PredOp.PARAM, PredOp.DEPTH, PredOp.TMP,
         PredOp.MASK, PredOp.CLASS, PredOp.VALID, PredOp.ID),
        1,
    ),
    **dict.fromkeys(
        (PredOp.I2F, PredOp.NEG, PredOp.TABLE, PredOp.TRUTHY, PredOp.ISNULL, PredOp.NOT), 0
    ),
    **dict.fromkeys((PredOp.ARITH, PredOp.CMP, PredOp.AND, PredOp.OR, PredOp.GUARD), -1),
    PredOp.DIST: -3,
}


#: the instructions that read a buffer at each slot
_PRED_LOADS = (PredOp.COL, PredOp.BCOL, PredOp.CLASS, PredOp.TMP)


def program_need(rows) -> int:
    """The most stack entries the postfix program ``rows`` holds at once
    (what the kernel's shared-memory stack is sized by); raises ValueError
    on an unknown opcode, a pop of an empty stack, or a program that does
    not end with one entry (or none after its last GUARD)."""
    depth = need = 0
    guarded = False
    for r in rows:
        op = r[0]
        if op not in _PRED_EFFECT:
            raise ValueError(f"predicate program: unknown opcode {op}")
        pops = {1: 0, 0: 1, -1: 2, -3: 4}[_PRED_EFFECT[op]]
        if op == PredOp.GUARD:  # pops one entry and pushes nothing
            pops, guarded = 1, True
        if depth < pops:
            raise ValueError("predicate program pops an empty stack")
        depth += _PRED_EFFECT[op]
        need = max(need, depth)
    if depth != 1 and not (guarded and depth == 0):
        raise ValueError(f"predicate program ends with {depth} stack entries")
    return need


class PredProgram:
    """A predicate program, uploaded once: its instructions ``(op, a, b,
    c)`` on the host (what the plain version runs, so that it reads nothing
    from a tensor) and as the kernel's contiguous int32 [L, 4] array on
    ``device``; ``need`` is its stack need (`program_need`)."""

    def __init__(self, rows, device) -> None:
        self.rows = [tuple(int(x) for x in r) for r in rows]
        if not self.rows or any(len(r) != 4 for r in self.rows):
            raise ValueError("a predicate program is a non-empty list of 4-tuples")
        self.need = program_need(self.rows)
        if self.need > PRED_STACK:
            raise ValueError(f"predicate program needs {self.need} stack entries > {PRED_STACK}")
        #: instructions that read a buffer at the slot (the lane form reads
        #: each once for all lanes and caches it)
        self.loads = sum(1 for r in self.rows if r[0] in _PRED_LOADS)
        self.code = torch.tensor(self.rows, dtype=I32).reshape(-1, 4).to(device)

    @property
    def lane_ok(self) -> bool:
        """True when the lane form takes the program (its cached loads and
        stack fit the kernel's shared memory)."""
        return self.need - 1 + self.loads <= PRED_LANE_ENTRIES


class _PredArgs(ctypes.Structure):
    """The kernel's `PredArgs`, passed by value into the launch."""

    _fields_ = [
        ("prog", ctypes.c_void_p),
        ("len", ctypes.c_longlong),
        ("ids", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("n_valid", ctypes.c_longlong),
        ("base", ctypes.c_longlong),
        ("params", ctypes.c_void_p),
        ("out_p", ctypes.c_void_p),
        ("out_v", ctypes.c_void_p),
        ("depth", ctypes.c_int),
        ("nbufs", ctypes.c_int),
        ("need", ctypes.c_int),
        ("lane_bufs", ctypes.c_uint),
        ("pstride", ctypes.c_longlong),
        ("buf", ctypes.c_void_p * PRED_BUFS),
        ("blen", ctypes.c_longlong * PRED_BUFS),
    ]


def _bits_f(v: torch.Tensor) -> torch.Tensor:
    return v.view(F32)


def _f_bits(v: torch.Tensor) -> torch.Tensor:
    return v.contiguous().view(I32)


def _plain_gather(vals: torch.Tensor, pres: torch.Tensor, idx: torch.Tensor):
    """``plain_take_pad`` of a column's values (as int32 bits, absent → 0)
    and presence (absent → False) through ``idx``."""
    bits = vals.view(I32) if vals.dtype == F32 else vals
    return plain_take_pad(bits, idx, 0), plain_take_pad(pres, idx, False)


def _plain_haversine(lat1, lon1, lat2, lon2, scale):
    """The reference's float32 haversine (`orientdb_tpu/ops/predicates.py`
    `_distance`): each step a separate float32 operation."""
    dev = lat1.device
    k = torch.tensor(_DEG2RAD, dtype=F32, device=dev)
    lat1, lon1, lat2, lon2 = (x * k for x in (lat1, lon1, lat2, lon2))
    s1 = torch.sin((lat2 - lat1) / 2.0)
    s2 = torch.sin((lon2 - lon1) / 2.0)
    h = s1 * s1 + torch.cos(lat1) * torch.cos(lat2) * (s2 * s2)
    h = torch.clamp(h, 0.0, 1.0)
    two_r = torch.tensor(12742.0, dtype=F32, device=dev)
    return two_r * torch.asin(torch.sqrt(h)) * torch.tensor(scale, dtype=F32, device=dev)


def _plain_arith(op: str, kind: int, x, y):
    """(value bits, extra presence) of ``x op y``: int32 wrapping, or
    float32; ``/`` and ``%`` by zero are absent, ``%`` is floor modulo."""
    if kind:
        xf, yf = _bits_f(x), _bits_f(y)
        nz = yf != 0
        safe = torch.where(nz, yf, torch.ones_like(yf))
        if op == "+":
            return _f_bits(xf + yf), None
        if op == "-":
            return _f_bits(xf - yf), None
        if op == "*":
            return _f_bits(xf * yf), None
        if op == "/":
            return _f_bits(xf / safe), nz
        return _f_bits(torch.remainder(xf, safe)), nz
    if op == "+":
        return x + y, None
    if op == "-":
        return x - y, None
    if op == "*":
        return x * y, None
    nz = y != 0
    if op == "/":  # the compiler makes every division float32
        raise ValueError("integer division in a predicate program")
    # x mod -1 is 0 (and INT_MIN % -1 would trap in C)
    unit = (y == 0) | (y == -1)
    r = torch.remainder(x, torch.where(unit, torch.ones_like(y), y))
    return torch.where(y == -1, torch.zeros_like(r), r), nz


def _plain_cmp(op: str, kind: int, x, y) -> torch.Tensor:
    if kind:
        x, y = _bits_f(x), _bits_f(y)
    return {
        "=": torch.eq,
        "!=": torch.ne,
        "<": torch.lt,
        "<=": torch.le,
        ">": torch.gt,
        ">=": torch.ge,
    }[op](x, y)


def _slot_ids(ids, n, n_valid, base, device) -> torch.Tensor:
    if ids is not None:
        return ids
    i = torch.arange(n, dtype=I32, device=device)
    return torch.where(i < n_valid, i + base, -1).to(I32)


def plain_predicate_eval(
    prog: PredProgram,
    bufs: List[torch.Tensor],
    ids: Optional[torch.Tensor] = None,
    n: int = 0,
    n_valid: Optional[int] = None,
    base: int = 0,
    depth: int = 0,
    params: Optional[torch.Tensor] = None,
    values: bool = False,
):
    """The kernel's interpreter in torch: the same program, each
    instruction one vectorised operation over every slot."""
    O = PredOp
    dev = prog.code.device
    n = ids.shape[0] if ids is not None else n
    sid = _slot_ids(ids, n, n if n_valid is None else n_valid, base, dev)
    zero = torch.zeros(n, dtype=I32, device=dev)
    stack: List[Tuple[torch.Tensor, torch.Tensor]] = []
    live: Optional[torch.Tensor] = None  # the AND of the guarded conjuncts

    def full_mask(b: bool):
        return torch.full((n,), bool(b), dtype=torch.bool, device=dev)

    for op, a, b, c in prog.rows:
        if op == O.COL:
            stack.append(_plain_gather(bufs[a], bufs[b], sid))
        elif op == O.BCOL:
            stack.append(_plain_gather(bufs[a], bufs[b], bufs[c]))
        elif op == O.CONST:
            stack.append((torch.full((n,), a, dtype=I32, device=dev), full_mask(b)))
        elif op == O.PARAM:
            stack.append((params[a : a + 1].expand(n), full_mask(True)))
        elif op == O.DEPTH:
            stack.append((torch.full((n,), depth, dtype=I32, device=dev), full_mask(True)))
        elif op == O.TMP:
            stack.append((bufs[a], bufs[b]))
        elif op in (O.I2F, O.NEG, O.TABLE, O.TRUTHY, O.ISNULL, O.NOT):
            v, p = stack.pop()
            if op == O.I2F:
                stack.append((_f_bits(v.to(F32)), p))
            elif op == O.NEG:
                stack.append(((_f_bits(-_bits_f(v)) if b else -v), p))
            elif op == O.TABLE:
                t = bufs[a]
                hit = t[v.clamp(0, t.shape[0] - 1).long()] if t.shape[0] else torch.zeros_like(p)
                stack.append((zero, p & hit))
            elif op == O.TRUTHY:
                stack.append((zero, p & ((_bits_f(v) if b else v) != 0)))
            elif op == O.ISNULL:
                stack.append((zero, p if a else ~p))
            else:
                stack.append((zero, ~p))
        elif op in (O.ARITH, O.CMP, O.AND, O.OR):
            y, x = stack.pop(), stack.pop()
            if c and op in (O.ARITH, O.CMP):
                x, y = y, x
            (xv, xp), (yv, yp) = x, y
            if op == O.ARITH:
                v, nz = _plain_arith(ARITH_OPS[a], b, xv, yv)
                p = xp & yp if nz is None else xp & yp & nz
                stack.append((v, p))
            elif op == O.CMP:
                stack.append((zero, xp & yp & _plain_cmp(CMP_OPS[a], b, xv, yv)))
            else:
                stack.append((zero, (xp & yp) if op == O.AND else (xp | yp)))
        elif op == O.MASK:
            stack.append((zero, full_mask(a)))
        elif op == O.CLASS:
            cls = plain_take_pad(bufs[a], sid, -1)
            stack.append((zero, plain_take_pad(bufs[b], cls, False)))
        elif op == O.VALID:
            stack.append((zero, sid >= 0))
        elif op == O.ID:
            stack.append((sid, sid >= 0))
        elif op == O.GUARD:
            p = stack.pop()[1]
            live = p if live is None else live & p
        elif op == O.DIST:
            ops = [stack.pop() for _ in range(4)][::-1]
            p = ops[0][1] & ops[1][1] & ops[2][1] & ops[3][1]
            scale = struct.unpack("<f", struct.pack("<i", a))[0]
            d = _plain_haversine(*(_bits_f(v) for v, _ in ops), scale)
            stack.append((_f_bits(d), p))
        else:
            raise ValueError(f"predicate program: unknown opcode {op}")
    ((v, p),) = stack or [(zero, full_mask(True))]
    if live is not None:
        p = p & live
    v = v.contiguous()
    return (v, p) if values else p


def predicate_eval(
    prog: PredProgram,
    bufs: List[torch.Tensor],
    ids: Optional[torch.Tensor] = None,
    n: int = 0,
    n_valid: Optional[int] = None,
    base: int = 0,
    depth: int = 0,
    params: Optional[torch.Tensor] = None,
    values: bool = False,
):
    """Run a compiled predicate program (`PredOp`) over ``n`` slots and
    return its bool mask, or ``(int32 value bits, mask)`` with ``values``.

    Slot i's id is ``ids[i]``, or in identity mode (``ids`` None) ``base +
    i`` for ``i < n_valid`` and -1 past it; -1 reads every column as
    absent. ``bufs`` are the program's buffers (1-d contiguous int32,
    float32 or bool: column values and presence, slot-aligned binding rows,
    code and class tables, an earlier launch's values and presence),
    ``params`` the int32 parameter row (float32 values by their bits),
    ``depth`` the WHILE level. A ``[B, P]`` parameter stack gives the
    [B, n] masks of its B rows (`predicate_eval_lanes`); lane-stacked ids
    [B, n] give [B, n] (`predicate_eval_stacked`)."""
    if ids is not None and ids.dim() == 2:
        return predicate_eval_stacked(prog, bufs, ids, n, n_valid, base, depth, params, values)
    if params is not None and params.dim() == 2:
        if values:
            raise ValueError("predicate_eval: the lane form returns masks only")
        return predicate_eval_lanes(prog, bufs, ids, n, n_valid, base, depth, params)
    if len(bufs) > PRED_BUFS:
        raise ValueError(f"predicate_eval: {len(bufs)} buffers > {PRED_BUFS}")
    for t in bufs:
        _check(t, (I32, F32, torch.bool), "predicate_eval buffer")
    ts = [prog.code, *bufs]
    if ids is not None:
        _check(ids, (I32,), "predicate_eval ids")
        n = ids.shape[0]
        ts.append(ids)
    if params is not None:
        _check(params, (I32,), "predicate_eval params")
        ts.append(params)
    if n_valid is None:
        n_valid = n
    if not _on_card(*ts):
        return plain_predicate_eval(prog, bufs, ids, n, n_valid, base, depth, params, values)
    dev = prog.code.device
    out_p = torch.empty(n, dtype=torch.bool, device=dev)
    out_v = torch.empty(n, dtype=I32, device=dev) if values else None
    if n > 0:
        args = _pred_args(prog, bufs, ids, n, n_valid, base, depth, params, out_p, out_v)
        lib = _kernels.load()
        # the stacked form's kernel at one lane
        _launch("predicate_eval", lib.csr_predicate_eval_stacked, ctypes.byref(args), 1, _stream(prog.code))
    return (out_v, out_p) if values else out_p


def _pred_args(prog, bufs, ids, n, n_valid, base, depth, params, out_p, out_v=None) -> _PredArgs:
    """The kernel's `PredArgs` of one launch (a buffer's length its last
    axis's: a lane-stacked one's a lane's)."""
    args = _PredArgs()
    args.prog = prog.code.data_ptr()
    args.len = len(prog.rows)
    args.ids = ids.data_ptr() if ids is not None else None
    args.n, args.n_valid, args.base = n, n_valid, base
    args.params = params.data_ptr() if params is not None else None
    args.out_p = out_p.data_ptr()
    args.out_v = out_v.data_ptr() if out_v is not None else None
    args.depth, args.nbufs, args.need = int(depth), len(bufs), prog.need
    for j, t in enumerate(bufs):
        args.buf[j] = t.data_ptr()
        args.blen[j] = t.shape[-1]
    return args


def plain_predicate_eval_lanes(
    prog: PredProgram,
    bufs: List[torch.Tensor],
    ids: Optional[torch.Tensor],
    n: int,
    n_valid: Optional[int],
    base: int,
    depth: int,
    params: torch.Tensor,
) -> torch.Tensor:
    """The lane form's plain version: `plain_predicate_eval` a parameter
    row, stacked [B, n]."""
    n = ids.shape[0] if ids is not None else n
    if params.shape[0] == 0:
        return torch.zeros((0, n), dtype=torch.bool, device=prog.code.device)
    return torch.stack(
        [plain_predicate_eval(prog, bufs, ids, n, n_valid, base, depth, row) for row in params]
    )


def predicate_eval_lanes(
    prog: PredProgram,
    bufs: List[torch.Tensor],
    ids: Optional[torch.Tensor],
    n: int,
    n_valid: Optional[int],
    base: int,
    depth: int,
    params: torch.Tensor,
) -> torch.Tensor:
    """K15's lane form: one program over ``n`` slots against each of the B
    rows of the int32 parameter stack ``params`` [B, P], bool [B, n]. On the
    card a thread reads its slots' ids and every buffer the program loads
    once, caches them in shared memory, and evaluates the program once a
    lane with that lane's row (the rows staged in shared memory). Raises
    where the kernel does not take the program or the stack
    (`PredProgram.lane_ok`, at most `PRED_LANES` rows of `PRED_LANE_PARAMS`
    values)."""
    if len(bufs) > PRED_BUFS:
        raise ValueError(f"predicate_eval_lanes: {len(bufs)} buffers > {PRED_BUFS}")
    for t in bufs:
        _check(t, (I32, F32, torch.bool), "predicate_eval_lanes buffer")
    _check2d(params, (I32,), "predicate_eval_lanes params")
    B, P = params.shape
    if B > PRED_LANES or P > PRED_LANE_PARAMS:
        raise ValueError(
            f"predicate_eval_lanes: a [{B}, {P}] stack (at most [{PRED_LANES}, {PRED_LANE_PARAMS}])"
        )
    if not prog.lane_ok:
        raise ValueError(
            f"predicate_eval_lanes: {prog.need - 1} stack and {prog.loads} cached entries "
            f"> {PRED_LANE_ENTRIES}"
        )
    ts = [prog.code, *bufs, params]
    if ids is not None:
        _check(ids, (I32,), "predicate_eval_lanes ids")
        n = ids.shape[0]
        ts.append(ids)
    if n_valid is None:
        n_valid = n
    if not _on_card(*ts):
        return plain_predicate_eval_lanes(prog, bufs, ids, n, n_valid, base, depth, params)
    dev = prog.code.device
    out = torch.empty((B, n), dtype=torch.bool, device=dev)
    if n > 0 and B > 0:
        args = _pred_args(prog, bufs, ids, n, n_valid, base, depth, params, out)
        lib = _kernels.load()
        _launch(
            "predicate_eval_lanes",
            lib.csr_predicate_eval_lanes,
            ctypes.byref(args),
            B,
            P,
            prog.loads,
            _stream(prog.code),
        )
    return out


#: the most lanes of the stacked form (a grid row a lane)
PRED_STACKED_LANES = 65535


def _slot_buffers(prog: PredProgram) -> set:
    """The buffers the program reads at the slot (BCOL's binding rows,
    TMP's earlier values and presence): the ones a lane may stack."""
    O = PredOp
    out = set()
    for op, a, b, c in prog.rows:
        if op == O.BCOL:
            out.add(c)
        elif op == O.TMP:
            out.update((a, b))
    return out


def plain_predicate_eval_stacked(
    prog: PredProgram,
    bufs: List[torch.Tensor],
    ids: Optional[torch.Tensor],
    n: int = 0,
    n_valid: Optional[int] = None,
    base: int = 0,
    depth: int = 0,
    params: Optional[torch.Tensor] = None,
    values: bool = False,
):
    """The stacked form's plain version: `plain_predicate_eval` a lane, on
    its ids, its rows of the lane-stacked buffers and its parameter row,
    stacked [B, n]."""
    B = ids.shape[0] if ids is not None else params.shape[0]
    n = ids.shape[1] if ids is not None else n
    outs = [
        plain_predicate_eval(
            prog, [_lane(t, b) for t in bufs], _lane(ids, b), n, n_valid, base, depth, _lane(params, b), values
        )
        for b in range(B)
    ]
    dev = prog.code.device
    empty = torch.zeros((0, n), dtype=torch.bool, device=dev)
    if values:
        if not outs:
            return empty.to(I32), empty
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])
    return torch.stack(outs) if outs else empty


def predicate_eval_stacked(
    prog: PredProgram,
    bufs: List[torch.Tensor],
    ids: Optional[torch.Tensor],
    n: int = 0,
    n_valid: Optional[int] = None,
    base: int = 0,
    depth: int = 0,
    params: Optional[torch.Tensor] = None,
    values: bool = False,
):
    """K15's stacked form: one program over lane-stacked ids ``ids`` int32
    [B, n], each lane its own (or, with ``ids`` None, each lane's identity
    slots ``base + i`` below ``n_valid``), with ``params`` a [B, P] stack (a
    row a lane; None where the program reads no parameter and ``ids`` are
    given); bool [B, n], or ``(int32 value bits, mask)`` [B, n] with
    ``values``. A buffer is shared (1-d: columns, code and class tables)
    or lane-stacked [B, n] (only what the program reads at the slot:
    binding rows, a split program's earlier values and presence), so a
    split program runs too, each launch's [B, n] values read by the next
    at its lane's row. On the card one launch of the single form's kernel
    with a grid row a lane: nothing is cached across lanes, so the lane
    form's limits (`PredProgram.lane_ok`'s `PRED_LANE_ENTRIES`,
    `PRED_LANES`, `PRED_LANE_PARAMS`) do not apply, only the single
    form's (`PRED_STACK`, `PRED_BUFS`) and at most `PRED_STACKED_LANES`
    lanes."""
    if len(bufs) > PRED_BUFS:
        raise ValueError(f"predicate_eval_stacked: {len(bufs)} buffers > {PRED_BUFS}")
    ts = [prog.code, *bufs]
    if ids is not None:
        _check2d(ids, (I32,), "predicate_eval_stacked ids")
        B, n = ids.shape
        n_valid = n
        ts.append(ids)
    elif params is None or params.dim() != 2:
        raise ValueError("predicate_eval_stacked: identity slots need a [B, P] parameter stack")
    else:
        B = params.shape[0]
    if n_valid is None:
        n_valid = n
    if B > PRED_STACKED_LANES:
        raise ValueError(f"predicate_eval_stacked: {B} lanes > {PRED_STACKED_LANES}")
    slot = _slot_buffers(prog)
    lane_bufs = 0
    for j, t in enumerate(bufs):
        if t.dim() == 2:
            _check2d(t, (I32, F32, torch.bool), "predicate_eval_stacked buffer")
            if j not in slot or tuple(t.shape) != (B, n):
                raise ValueError(
                    f"predicate_eval_stacked: buffer {j} of shape {tuple(t.shape)} is lane-stacked but "
                    f"not a slot-aligned [{B}, {n}] one"
                )
            lane_bufs |= 1 << j
        else:
            _check(t, (I32, F32, torch.bool), "predicate_eval_stacked buffer")
    pstride = 0
    if params is not None:
        _check2d(params, (I32,), "predicate_eval_stacked params")
        if params.shape[0] != B:
            raise ValueError(f"predicate_eval_stacked: {params.shape[0]} parameter rows for {B} lanes")
        pstride = params.shape[1]
        ts.append(params)
    if not _on_card(*ts):
        return plain_predicate_eval_stacked(prog, bufs, ids, n, n_valid, base, depth, params, values)
    dev = prog.code.device
    out_p = torch.empty((B, n), dtype=torch.bool, device=dev)
    out_v = torch.empty((B, n), dtype=I32, device=dev) if values else None
    if n > 0 and B > 0:
        args = _pred_args(prog, bufs, ids, n, n_valid, base, depth, params, out_p, out_v)
        args.lane_bufs, args.pstride = lane_bufs, pstride
        lib = _kernels.load()
        _launch(
            "predicate_eval_stacked", lib.csr_predicate_eval_stacked, ctypes.byref(args), B, _stream(prog.code)
        )
    return (out_v, out_p) if values else out_p


# ---------------------------------------------------------------------------
# K16–K18: the delta path (in-place patches, append-slab expansions)
# ---------------------------------------------------------------------------

_ELEM = {I32: 4, F32: 4, torch.bool: 1}


def plain_scatter_set(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """The reference's ``arr.at[idx].set(vals)``, in place (repeated
    indices carry the same value by the caller's contract)."""
    if idx.shape[0]:
        arr[idx.long()] = vals


def scatter_set(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """``arr[idx[i]] = vals[i]`` in place, for int32, float32 or bool
    ``arr``: the storage, and so every captured replay's pointer to it,
    stays the same. ``idx`` int32 [S] (each in ``[0, len(arr))``), ``vals``
    [S] of ``arr``'s dtype; a repeated index must carry one value."""
    _check(arr, tuple(_ELEM), "scatter_set arr")
    _check(idx, (I32,), "scatter_set idx")
    _check(vals, (arr.dtype,), "scatter_set vals")
    if vals.shape[0] != idx.shape[0]:
        raise ValueError("scatter_set: idx and vals differ in length")
    if not _on_card(arr, idx, vals):
        plain_scatter_set(arr, idx, vals)
        return
    if idx.shape[0] == 0:
        return
    lib = _kernels.load()
    _launch(
        "scatter_set",
        lib.csr_scatter_set,
        arr.data_ptr(),
        arr.shape[0],
        idx.data_ptr(),
        vals.data_ptr(),
        idx.shape[0],
        _ELEM[arr.dtype],
        _stream(arr),
    )


def plain_slab_scan(a, e, live, srcs, base: int, size_for):
    """The reference's `_expand_slab` after its window cut: the [R, W] mask
    ``a[j] == srcs[r] ∧ live[j] ∧ srcs[r] >= 0``, its first ``out`` True
    positions in row-major order, decoded to (row, base + j, e[j])."""
    W, R = a.shape[0], srcs.shape[0]
    step = max(1, (1 << 28) // max(W, 1))  # rows a mask block: nonzero's element limit
    hits, total = [], torch.zeros((), dtype=I32, device=a.device)
    for r0 in range(0, R, step):
        s = srcs[r0 : r0 + step]
        m = (a[None, :] == s[:, None]) & live[None, :] & (s >= 0)[:, None]
        total = total + m.sum(dtype=I32)
        hits.append(m.reshape(-1).nonzero()[:, 0] + r0 * W)
    out = size_for(total)
    hit = torch.cat(hits)[:out] if hits else torch.zeros(0, dtype=torch.int64, device=a.device)
    row = torch.full((out,), -1, dtype=I32, device=a.device)
    eid, nbr = row.clone(), row.clone()
    n = hit.shape[0]
    row[:n] = (hit // W).to(I32)
    j = hit % W
    eid[:n] = (base + j).to(I32)
    nbr[:n] = e[j]
    return row, eid, nbr, total


def slab_scan(a, e, live, srcs, base: int, size_for):
    """Window scan of an append slab: every live window slot j (``a``, ``e``
    int32 [W] the active and emitted endpoints, ``live`` bool [W]) whose
    active endpoint is the row's source (``srcs`` int32 [R], -1 padding).
    ``size_for(total)`` maps the device total (0-d int32) to the output
    capacity (the caller's size schedule). Returns int32 ``(row, base + j,
    e[j])`` of that capacity in row-major order, -1 past the total, and the
    total. On the card a window join in eight launches after one memset:
    the key histogram, four radix passes that sort the live slots by active
    endpoint, each row's run of its source in the sorted window, K2's degree
    scan of the runs' lengths (offsets and total), and K2b's merge-path
    gather of the runs."""
    for t, what in ((a, "a"), (e, "e"), (srcs, "srcs")):
        _check(t, (I32,), f"slab_scan {what}")
    _check(live, (torch.bool,), "slab_scan live")
    W, R = a.shape[0], srcs.shape[0]
    if e.shape[0] != W or live.shape[0] != W:
        raise ValueError("slab_scan: a, e and live differ in length")
    if not _on_card(a, e, live, srcs):
        return plain_slab_scan(a, e, live, srcs, base, size_for)
    if W >= 1 << 31:
        raise ValueError("slab_scan: a window of 2^31 slots or more")
    lib = _kernels.load()
    dev, stream = a.device, _stream(a)
    scratch = torch.empty(int(lib.csr_slab_scan_scratch(W, R)), dtype=torch.uint8, device=dev)
    pairs = torch.empty((4, W), dtype=I32, device=dev)  # keys and slots, two buffers
    _launch("slab_scan", lib.csr_slab_scan_hist, a.data_ptr(), live.data_ptr(), W, R, scratch.data_ptr(), stream)
    for p in range(lib.csr_slab_scan_passes()):
        _launch(
            "slab_scan", lib.csr_slab_scan_pass,
            a.data_ptr(), live.data_ptr(), W, R, pairs.data_ptr(), scratch.data_ptr(), p, stream,
        )
    offsets = torch.empty(R, dtype=I32, device=dev)
    total = torch.empty((), dtype=I32, device=dev)
    if not R:
        total.zero_()
    else:
        _launch(
            "slab_scan", lib.csr_slab_scan_runs,
            pairs.data_ptr(), W, srcs.data_ptr(), R, scratch.data_ptr(), stream,
        )
        _launch(
            "slab_scan", lib.csr_slab_scan_rows,
            W, R, offsets.data_ptr(), total.data_ptr(), scratch.data_ptr(), stream,
        )
    out = size_for(total)
    row = torch.empty(out, dtype=I32, device=dev)
    eid, nbr = torch.empty_like(row), torch.empty_like(row)
    if not out:
        return row, eid, nbr, total
    _launch(
        "slab_scan", lib.csr_slab_scan_gather,
        pairs.data_ptr(), W, e.data_ptr(), int(base), srcs.data_ptr(), offsets.data_ptr(), R,
        total.data_ptr(), out, row.data_ptr(), eid.data_ptr(), nbr.data_ptr(), scratch.data_ptr(), stream,
    )
    return row, eid, nbr, total


def plain_slab_probe(tab, own, nbr_a, live, srcs, base: int, nb: int, bk: int, size_for):
    """The reference's `_expand_slab_bucketed`: probe each source's bucket
    ``srcs & (nb - 1)`` (BK relative slots of ``tab``), keep the live slots
    whose owning endpoint is the source, compact row-major and decode."""
    dev = srcs.device
    R = srcs.shape[0]
    b = srcs & (nb - 1)
    slots = b[:, None] * bk + torch.arange(bk, dtype=I32, device=dev)[None, :]
    rel = tab[slots.long()]
    at = (base + rel.clamp(min=0)).long()
    m = (rel >= 0) & (srcs >= 0)[:, None] & (own[at] == srcs[:, None]) & live[at]
    total = m.sum(dtype=I32)
    idx = plain_compact_indices(m.reshape(-1), size_for(total))
    ok = idx >= 0
    rel_sel = rel.reshape(-1)[idx.clamp(min=0).long()] if R else torch.zeros_like(idx)
    eid = torch.where(ok, base + rel_sel, -1).to(I32)
    nbr = torch.where(ok, nbr_a[(base + rel_sel).clamp(min=0).long()], -1).to(I32)
    return torch.where(ok, idx // bk, -1).to(I32), eid, nbr, total


def slab_probe(tab, own, nbr_a, live, srcs, base: int, nb: int, bk: int, size_for):
    """Bucket probe of an append slab: ``tab`` int32 [nb·bk] holds each
    bucket's relative slab slots (-1 empty), ``own`` / ``nbr_a`` int32 [E]
    the endpoint a slot is keyed by and the one it reaches, ``live`` bool
    [E]; ``srcs`` int32 [R] (-1 padding). ``size_for`` as in `slab_scan`.
    Returns int32 ``(row, base + rel, nbr_a[base + rel])`` in row-major
    order, -1 past the total, and the total. Two launches: the probe, which
    writes the [R·bk] match mask and relative slots, and the decode of
    their compaction (K5's count and K3 between them)."""
    for t, what in ((tab, "tab"), (own, "own"), (nbr_a, "nbr_a"), (srcs, "srcs")):
        _check(t, (I32,), f"slab_probe {what}")
    _check(live, (torch.bool,), "slab_probe live")
    if tab.shape[0] != nb * bk:
        raise ValueError("slab_probe: the table is not nb * bk slots")
    if own.shape[0] != live.shape[0] or nbr_a.shape[0] != live.shape[0]:
        raise ValueError("slab_probe: own, nbr_a and live differ in length")
    if nb & (nb - 1):
        raise ValueError("slab_probe: nb must be a power of two")
    if not _on_card(tab, own, nbr_a, live, srcs):
        return plain_slab_probe(tab, own, nbr_a, live, srcs, base, nb, bk, size_for)
    lib = _kernels.load()
    dev = srcs.device
    R, E = srcs.shape[0], live.shape[0]
    mask = torch.empty(R * bk, dtype=torch.bool, device=dev)
    rel = torch.empty(R * bk, dtype=I32, device=dev)
    _launch(
        "slab_probe", lib.csr_slab_probe,
        tab.data_ptr(), own.data_ptr(), live.data_ptr(), E, srcs.data_ptr(), R, nb, bk,
        int(base), mask.data_ptr(), rel.data_ptr(), _stream(srcs),
    )
    total = mask_count(mask)
    out = size_for(total)
    idx = compact_indices(mask, out)
    row = torch.empty(out, dtype=I32, device=dev)
    eid, nbr = torch.empty_like(row), torch.empty_like(row)
    _launch(
        "slab_probe", lib.csr_slab_decode,
        idx.data_ptr(), out, rel.data_ptr(), bk, int(base), nbr_a.data_ptr(), E,
        row.data_ptr(), eid.data_ptr(), nbr.data_ptr(), _stream(srcs),
    )
    return row, eid, nbr, total


# ---------------------------------------------------------------------------
# K19–K21: the tier plane's paged reads (storage/tiering)
# ---------------------------------------------------------------------------


def _check_pool(t: torch.Tensor, what: str) -> None:
    """A page pool row set: int32 [P, Wp], contiguous."""
    if t.dtype != I32 or t.dim() != 2 or not t.is_contiguous():
        raise TypeError(f"{what}: expected a contiguous int32 [P, Wp] pool")


def plain_paged_hop(own, nbr, eid, emask, frontier, gate=None, alive=None) -> torch.Tensor:
    """The reference's `paged_hop`, the slot walk K19's push is held
    against: the flattened pool as an edge list whose slots count when
    ``own >= 0`` (and ``take_pad(emask, eid, False)``), through
    `plain_bitmap_hop`."""
    own_f, nbr_f = own.reshape(-1), nbr.reshape(-1)
    m = own_f >= 0
    if emask is not None:
        m = m & plain_take_pad(emask, eid.reshape(-1), False)
    return plain_bitmap_hop(own_f, nbr_f, m, frontier, gate, alive)


def plain_paged_hop_csr(
    indptr, blockv, pageof, estart, nbr, eid, emask, frontier, gate=None, alive=None, miss=None
) -> torch.Tensor:
    """K19's push walk in torch (`_plain_push`): an active vertex ``v <
    V`` reads block ``b = blockv[v]`` at page ``p = pageof[clip(b, 0,
    B-1)]`` (nothing when ``b`` or ``p`` is -1) and its ``indptr`` row's
    slots ``p·Wp + clip(indptr[v] + j - estart[b], 0, Wp-1)`` (at most the
    last pool slot), K21's clips; ``nbr`` and the edge id are read from the
    pool rows there. ``miss`` (a 0-d bool) is ORed with the cold-miss
    flag (`plain_paged_hop_miss`)."""
    V, nb = blockv.shape[0], pageof.shape[0]
    Wp, ns = nbr.shape[1], nbr.numel()
    if miss is not None:
        miss |= plain_paged_hop_miss(frontier, blockv, pageof, indptr, gate, alive)
    if ns == 0 or nb == 0:
        return torch.zeros(frontier.shape, dtype=B8, device=frontier.device)
    ip, bv, pg, es = indptr.long(), blockv.long(), pageof.long(), estart.long()

    def row(v):
        b = bv[v]
        bc = b.clamp(0, nb - 1)
        p = torch.where(b >= 0, pg[bc], -1)
        st = ip[v]
        return p.clamp(min=0) * Wp, st - es[bc], torch.where(p >= 0, ip[v + 1] - st, 0)

    def slot(base, aux, j):
        return (base + (aux + j).clamp(0, Wp - 1)).clamp(max=ns - 1)

    eid_f = eid.reshape(-1)
    return _plain_push(
        0, V, row, slot, lambda s, a: eid_f[s], nbr.reshape(-1), emask, frontier, gate, alive
    )


def paged_hop_csr(
    indptr: torch.Tensor,
    blockv: torch.Tensor,
    pageof: torch.Tensor,
    estart: torch.Tensor,
    nbr: torch.Tensor,
    eid: torch.Tensor,
    emask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
    miss: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One frontier hop over a paged partition (K19), walked by its active
    vertices: ``out[c, nbr[s]] |= frontier[c, v]`` for the pool slots ``s``
    of each vertex ``v`` whose block is resident and, with ``emask`` (bool
    [E] in out order), a True ``emask[eid[s]]`` (-1 reads False).
    ``indptr`` int32 [V+1] is the partition's resident indptr, ``blockv``
    int32 [V], ``pageof`` int32 [B], ``estart`` int32 [B+1]; ``nbr`` /
    ``eid`` int32 [P, Wp] the pool rows; ``gate``, ``alive`` and ``out`` as
    for `bitmap_hop`. Equals the reference's slot walk (`plain_paged_hop`)
    on any pool `storage/tiering.TierManager` keeps: a resident block's
    page holds its slots, an evicted block's ``pageof`` is -1. ``miss`` (a
    0-d bool on the device) gets K20's cold-miss flag in the same launch
    (`paged_hop_miss`'s value, ORed in: the hop sets it and never clears
    it)."""
    for t, what in ((indptr, "indptr"), (blockv, "blockv"), (pageof, "pageof"), (estart, "estart")):
        _check(t, (I32,), f"paged_hop_csr {what}")
    for t, what in ((nbr, "nbr"), (eid, "eid")):
        _check_pool(t, f"paged_hop_csr {what}")
    if eid.shape != nbr.shape:
        raise ValueError("paged_hop_csr: nbr and eid differ in shape")
    if indptr.shape[0] != blockv.shape[0] + 1 or estart.shape[0] != pageof.shape[0] + 1:
        raise ValueError("paged_hop_csr: indptr / blockv or estart / pageof lengths disagree")
    _check2d(frontier, (B8,), "paged_hop_csr frontier")
    C, vb = frontier.shape
    opt = []
    if emask is not None:
        _check(emask, (B8,), "paged_hop_csr emask")
        opt.append(emask)
    if gate is not None:
        _check(gate, (B8,), "paged_hop_csr gate")
        if gate.shape[0] != vb:
            raise ValueError("paged_hop_csr: gate and the frontier differ in width")
        opt.append(gate)
    if alive is not None:
        _check_scalar(alive, "paged_hop_csr alive")
        opt.append(alive)
    if out is not None:
        _check_out(out, (C, vb), B8, "paged_hop_csr")
        opt.append(out)
    if miss is not None:
        _check_out(miss, (), B8, "paged_hop_csr miss")
        opt.append(miss)
    if not _on_card(indptr, blockv, pageof, estart, nbr, eid, frontier, *opt):
        hop = plain_paged_hop_csr(indptr, blockv, pageof, estart, nbr, eid, emask, frontier, gate, alive, miss)
        if out is None:
            return hop
        out |= hop
        return out
    lib = _kernels.load()
    zero = out is None
    if zero:
        out = torch.empty((C, vb), dtype=B8, device=frontier.device)
    _launch(
        "paged_hop_csr",
        lib.csr_paged_hop_csr,
        indptr.data_ptr(),
        blockv.shape[0],
        blockv.data_ptr(),
        pageof.data_ptr(),
        pageof.shape[0],
        estart.data_ptr(),
        nbr.data_ptr(),
        eid.data_ptr(),
        nbr.numel(),
        nbr.shape[1],
        None if emask is None else emask.data_ptr(),
        0 if emask is None else emask.shape[0],
        frontier.data_ptr(),
        None if gate is None else gate.data_ptr(),
        C,
        vb,
        None if alive is None else alive.data_ptr(),
        int(zero),
        out.data_ptr(),
        None if miss is None else miss.data_ptr(),
        _stream(frontier),
    )
    return out


def plain_paged_hop_miss(frontier, blockv, pageof, indptr, gate=None, alive=None) -> torch.Tensor:
    """The reference's `paged_hop_miss`: ``any(touched & (pageof < 0))``
    with ``touched`` the scatter-max of the active vertices (in a frontier
    row, with degree > 0) over their blocks. ``gate`` is ANDed into the
    frontier first; ``alive`` at 0 gives False."""
    V, B = blockv.shape[0], pageof.shape[0]
    fa = frontier.any(dim=0)[:V]
    if gate is not None:
        fa = fa & gate[: fa.shape[0]]
    if alive is not None:
        fa = fa & (alive != 0)
    deg = (indptr[1:] - indptr[:-1])[: fa.shape[0]]
    b = blockv[: fa.shape[0]][fa & (deg > 0)].long()
    touched = torch.zeros(B, dtype=B8, device=frontier.device)
    touched[b[(b >= 0) & (b < B)]] = True
    return (touched & (pageof < 0)).any()


def paged_hop_miss(
    frontier: torch.Tensor,
    blockv: torch.Tensor,
    pageof: torch.Tensor,
    indptr: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The cold-miss flag of a paged hop (K20), a 0-d bool on the device:
    True when a vertex ``v < V`` active in some frontier row (and in
    ``gate``) has edges in this direction (``indptr`` int32 [V+1]) and its
    block ``blockv[v]`` is cold (``pageof`` int32 [B] below 0). Nothing is
    read back to the host. A replay takes the flag from K19's push instead
    (`paged_hop_csr`'s ``miss``); this is its standalone form."""
    for t, what in ((blockv, "blockv"), (pageof, "pageof"), (indptr, "indptr")):
        _check(t, (I32,), f"paged_hop_miss {what}")
    _check2d(frontier, (B8,), "paged_hop_miss frontier")
    C, vb = frontier.shape
    V = blockv.shape[0]
    if indptr.shape[0] != V + 1:
        raise ValueError("paged_hop_miss: indptr is not V + 1 long")
    opt = []
    if gate is not None:
        _check(gate, (B8,), "paged_hop_miss gate")
        if gate.shape[0] != vb:
            raise ValueError("paged_hop_miss: gate and the frontier differ in width")
        opt.append(gate)
    if alive is not None:
        _check_scalar(alive, "paged_hop_miss alive")
        opt.append(alive)
    if not _on_card(frontier, blockv, pageof, indptr, *opt):
        return plain_paged_hop_miss(frontier, blockv, pageof, indptr, gate, alive)
    lib = _kernels.load()
    flag = torch.empty((), dtype=B8, device=frontier.device)
    _launch(
        "paged_hop_miss",
        lib.csr_paged_hop_miss,
        frontier.data_ptr(),
        None if gate is None else gate.data_ptr(),
        C,
        vb,
        blockv.data_ptr(),
        V,
        pageof.data_ptr(),
        pageof.shape[0],
        indptr.data_ptr(),
        None if alive is None else alive.data_ptr(),
        flag.data_ptr(),
        _stream(frontier),
    )
    return flag


def plain_paged_expand(
    indptr, srcs, offsets, total, out_size, blockv, pageof, estart, pool_nbr, pool_eid, out_dir, flag=None
):
    """The reference's `paged_expand`: `plain_gather_expand` without a
    neighbour array for row and edge_pos, then the block → page
    indirection with its clips, cold and padding slots nulled, and the
    flag ``any(live & cold)`` (ORed into ``flag`` and returned as it, when
    given). Every gather is a `plain_take_pad`."""
    dev = srcs.device
    empty = torch.zeros(0, dtype=I32, device=dev)
    row, edge_pos, _ = plain_gather_expand(indptr, empty, srcs, offsets, total, out_size)
    V, B, Wp = blockv.shape[0], pageof.shape[0], pool_nbr.shape[1]
    src = plain_take_pad(srcs, row, -1)
    live = row >= 0
    b = plain_take_pad(blockv, src.clamp(0, max(V - 1, 0)), -1)
    bc = b.clamp(max=max(B - 1, 0))
    p = plain_take_pad(pageof, bc, -1)
    local = edge_pos - plain_take_pad(estart, bc, 0)
    flat = p.clamp(min=0).long() * Wp + local.clamp(0, Wp - 1).long()

    def take(pool):
        if pool.numel() == 0:
            return torch.full_like(row, -1)
        return pool.reshape(-1)[flat.clamp(max=pool.numel() - 1)]

    nbr = take(pool_nbr)
    eid = edge_pos if out_dir else take(pool_eid)
    cold = live & (p < 0)
    ok = live & ~cold
    miss = cold.any()
    if flag is not None:
        flag |= miss
        miss = flag
    return torch.where(ok, row, -1), torch.where(ok, eid, -1), torch.where(ok, nbr, -1), miss


def paged_expand(
    indptr: torch.Tensor,
    srcs: torch.Tensor,
    offsets: torch.Tensor,
    total: torch.Tensor,
    out_size: int,
    blockv: torch.Tensor,
    pageof: torch.Tensor,
    estart: torch.Tensor,
    pool_nbr: torch.Tensor,
    pool_eid: Optional[torch.Tensor],
    out_dir: bool,
    flag: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CSR gather of a paged partition (K21): ``(row, eid, nbr,
    cold)``. Row and edge position come from the resident ``indptr`` as in
    `gather_expand` (``offsets`` / ``total`` / ``out_size`` as there); the
    neighbour (and, for the in direction, the edge id in out order) from
    the pool ``pool_nbr`` / ``pool_eid`` (int32 [P, Wp]) at page
    ``pageof[blockv[src]]``, slot ``edge_pos - estart[block]``. The out
    direction's edge id is the edge position (``pool_eid`` may be None).
    Slots of a cold block are -1 and raise ``cold``, a 0-d bool on the
    device: ``flag`` when given (only 1s are stored into it, so a replay's
    tiered reads share one byte zeroed once), else a byte zeroed here."""
    for t, what in (
        (indptr, "indptr"), (srcs, "srcs"), (offsets, "offsets"), (blockv, "blockv"),
        (pageof, "pageof"), (estart, "estart"),
    ):
        _check(t, (I32,), f"paged_expand {what}")
    _check_scalar(total, "paged_expand total")
    _check_pool(pool_nbr, "paged_expand pool_nbr")
    if offsets.shape[0] != srcs.shape[0]:
        raise ValueError("paged_expand: offsets and srcs differ in length")
    if indptr.shape[0] != blockv.shape[0] + 1 or estart.shape[0] != pageof.shape[0] + 1:
        raise ValueError("paged_expand: indptr / blockv or estart / pageof lengths disagree")
    opt = []
    if not out_dir:
        if pool_eid is None:
            raise ValueError("paged_expand: the in direction reads pool_eid")
        _check_pool(pool_eid, "paged_expand pool_eid")
        if pool_eid.shape != pool_nbr.shape:
            raise ValueError("paged_expand: pool_nbr and pool_eid differ in shape")
        opt.append(pool_eid)
    if flag is not None:
        _check_out(flag, (), B8, "paged_expand flag")
        opt.append(flag)
    if not _on_card(indptr, srcs, offsets, total, blockv, pageof, estart, pool_nbr, *opt):
        return plain_paged_expand(
            indptr, srcs, offsets, total, out_size, blockv, pageof, estart, pool_nbr, pool_eid, out_dir, flag
        )
    lib = _kernels.load()
    dev = srcs.device
    row = torch.empty(out_size, dtype=I32, device=dev)
    eid, nbr = torch.empty_like(row), torch.empty_like(row)
    cold = torch.empty((), dtype=B8, device=dev) if flag is None else flag
    _launch(
        "paged_expand",
        lib.csr_paged_expand,
        indptr.data_ptr(),
        blockv.shape[0],
        srcs.data_ptr(),
        offsets.data_ptr(),
        srcs.shape[0],
        total.data_ptr(),
        out_size,
        blockv.data_ptr(),
        pageof.data_ptr(),
        pageof.shape[0],
        estart.data_ptr(),
        pool_nbr.data_ptr(),
        None if out_dir else pool_eid.data_ptr(),
        pool_nbr.numel(),
        pool_nbr.shape[1],
        int(bool(out_dir)),
        row.data_ptr(),
        eid.data_ptr(),
        nbr.data_ptr(),
        cold.data_ptr(),
        int(flag is None),
        _stream(srcs),
    )
    return row, eid, nbr, cold


# ---------------------------------------------------------------------------
# The mesh (`parallel/mesh_graph.py`, `parallel/sharded.py`): K2's range
# form, K22 `shard_gather`, K10's eid form, K23 `shard_weight_pass`, K24
# `rowshard_hop`. A sharded tensor has a leading axis over the S_l shards
# this process holds (all S in one process, one a rank of a process group);
# each wrapper launches one kernel over all of them.
# ---------------------------------------------------------------------------


def _check_sharded(t: torch.Tensor, what: str, dtypes=(I32,)) -> None:
    """A sharded int32 array: [S_l, W], contiguous."""
    if t.dtype not in dtypes or t.dim() != 2 or not t.is_contiguous():
        raise TypeError(f"{what}: expected a contiguous [S_l, W] tensor of {dtypes}")


def plain_degree_counts_range(ind_sh: torch.Tensor, span: torch.Tensor, srcs: torch.Tensor):
    """The reference's per-shard count (`mesh_graph.expand_totals` body):
    each shard's sources are those inside its ``span`` row range, rebased,
    others -1 (count 0)."""
    rows = []
    for s in range(ind_sh.shape[0]):
        lo, hi = span[s, 0], span[s, 1]
        ls = torch.where((srcs >= lo) & (srcs < hi), srcs - lo, -1).to(I32)
        rows.append(plain_degree_counts(ind_sh[s], ls))
    counts = (
        torch.stack(rows)
        if rows
        else torch.zeros((0, srcs.shape[0]), dtype=I32, device=srcs.device)
    )
    return counts, counts.sum(1, dtype=I32)


def degree_counts_range(ind_sh: torch.Tensor, span: torch.Tensor, srcs: torch.Tensor):
    """K2's range form: for each shard s held, ``counts[s, i]`` is the out-
    degree of ``srcs[i]`` in shard s's rebased indptr row when ``span[s, 0]
    <= srcs[i] < span[s, 1]`` (the shard owns it), else 0; ``tots[s]`` is
    the row's sum. ``ind_sh`` int32 [S_l, R+1], ``span`` int32 [S_l, 2],
    ``srcs`` int32 [n]. Returns (counts [S_l, n], tots [S_l])."""
    _check_sharded(ind_sh, "degree_counts_range ind_sh")
    _check_sharded(span, "degree_counts_range span")
    _check(srcs, (I32,), "degree_counts_range srcs")
    if span.shape != (ind_sh.shape[0], 2):
        raise ValueError("degree_counts_range: span must be [S_l, 2]")
    if not _on_card(ind_sh, span, srcs):
        return plain_degree_counts_range(ind_sh, span, srcs)
    lib = _kernels.load()
    S_l, n = ind_sh.shape[0], srcs.shape[0]
    counts = torch.empty((S_l, n), dtype=I32, device=srcs.device)
    tots = torch.empty(S_l, dtype=I32, device=srcs.device)
    _launch(
        "degree_counts_range",
        lib.csr_degree_counts_range,
        ind_sh.data_ptr(),
        ind_sh.shape[1],
        span.data_ptr(),
        srcs.data_ptr(),
        n,
        S_l,
        counts.data_ptr(),
        tots.data_ptr(),
        _stream(srcs),
    )
    return counts, tots


def plain_shard_gather(
    ind_sh, nbr_sh, extra_sh, span, srcs, offsets, tots, s0: int, cap: int, cap_total: int,
    is_out: bool, plus_one: bool = False,
):
    """The reference's `expand_gather` body, shard by shard: count, scan and
    `gather_expand` at ``cap``, the edge id (``epos + ebase``, or the in
    CSR's ``eid`` row), then the live rows scattered at the shard's global
    offset (the exclusive prefix of ``tots``) shifted by one, positions at
    or past ``cap_total`` dropped. The sum of the shards' segments, minus
    one (or as it is with ``plus_one``, for a collective to add). The
    ``offsets`` the kernel searches are derived again here, as the
    reference derives them."""
    dev = srcs.device
    seg = torch.zeros((3, cap_total), dtype=I32, device=dev)
    before = torch.cumsum(tots, 0, dtype=I32) - tots
    counts, _ = plain_degree_counts_range(ind_sh, span, srcs)
    for s in range(ind_sh.shape[0]):
        lo = span[s, 0]
        ls = torch.where((srcs >= lo) & (srcs < span[s, 1]), srcs - lo, -1).to(I32)
        tot = counts[s].sum(dtype=I32)
        if int(tot) == 0:
            continue  # the reference's cond-skip: nothing to place
        offs = plain_cumsum(counts[s], exclusive=True)
        row, epos, nbr = plain_gather_expand(ind_sh[s], nbr_sh[s], ls, offs, tot, cap)
        if is_out:
            eid = torch.where(epos >= 0, epos + extra_sh[s, 0], -1).to(I32)
        else:
            eid = plain_take_pad(extra_sh[s], epos, -1)
        pos = torch.arange(cap, dtype=I32, device=dev)
        dest = torch.where(pos < tot, pos + before[s0 + s], cap_total).long()
        keep = dest < cap_total
        for k, v in enumerate((row, eid, nbr)):
            seg[k].index_add_(0, dest[keep], (v + 1)[keep])
    if not plus_one:
        seg -= 1
    return seg[0], seg[1], seg[2]


def shard_gather(
    ind_sh: torch.Tensor,
    nbr_sh: torch.Tensor,
    extra_sh: torch.Tensor,
    span: torch.Tensor,
    srcs: torch.Tensor,
    offsets: torch.Tensor,
    tots: torch.Tensor,
    s0: int,
    cap: int,
    cap_total: int,
    is_out: bool,
    plus_one: bool = False,
):
    """K22: the sharded CSR expansion's merged segment. Each shard s held
    (global index ``s0 + s``) expands the sources it owns (`degree_counts_
    range`) into at most ``cap`` rows and places them, front-packed, at its
    global offset (the exclusive prefix of ``tots``, int32 [S], every
    shard's total) in the ``[cap_total]`` segment; slots past a shard's rows
    and past the last are -1. ``offsets`` int32 [S_l * n] is the flat
    exclusive scan of K2's range-form counts. ``extra_sh`` is the shard's
    edge-id base ([S_l, 1], ``is_out``) or its in-CSR edge ids ([S_l,
    emax]). Returns (row, eid, nbr), int32 [cap_total] each, in shard-major
    order. With ``plus_one`` (a rank of a process group) the values are
    shifted by one and the slots of other shards 0, so that the ranks'
    segments sum to the merged one plus one."""
    for t, what in ((ind_sh, "ind_sh"), (nbr_sh, "nbr_sh"), (extra_sh, "extra_sh"), (span, "span")):
        _check_sharded(t, f"shard_gather {what}")
    _check(srcs, (I32,), "shard_gather srcs")
    _check(offsets, (I32,), "shard_gather offsets")
    _check(tots, (I32,), "shard_gather tots")
    S_l, n = ind_sh.shape[0], srcs.shape[0]
    if offsets.shape[0] != S_l * n:
        raise ValueError("shard_gather: offsets must hold S_l * n entries")
    if not (0 <= s0 and s0 + S_l <= tots.shape[0] <= 1024):
        raise ValueError("shard_gather: shards outside the totals (at most 1024 shards)")
    if not _on_card(ind_sh, nbr_sh, extra_sh, span, srcs, offsets, tots):
        return plain_shard_gather(
            ind_sh, nbr_sh, extra_sh, span, srcs, offsets, tots, s0, cap, cap_total, is_out,
            plus_one,
        )
    lib = _kernels.load()
    row = torch.empty(cap_total, dtype=I32, device=srcs.device)
    eid, nbr = torch.empty_like(row), torch.empty_like(row)
    _launch(
        "shard_gather",
        lib.csr_shard_gather,
        ind_sh.data_ptr(),
        ind_sh.shape[1],
        nbr_sh.data_ptr(),
        nbr_sh.shape[1],
        extra_sh.data_ptr(),
        extra_sh.shape[1],
        span.data_ptr(),
        srcs.data_ptr(),
        n,
        offsets.data_ptr(),
        tots.data_ptr(),
        tots.shape[0],
        s0,
        S_l,
        cap,
        cap_total,
        int(bool(is_out)),
        int(bool(plus_one)),
        row.data_ptr(),
        eid.data_ptr(),
        nbr.data_ptr(),
        _stream(srcs),
    )
    return row, eid, nbr


def plain_bitmap_hop_eid(act, emit, eid, emask, frontier, gate=None, alive=None) -> torch.Tensor:
    """The reference's shard hop (`sharded_bitmap_hop` body) over the
    edge-list slices, the slot walk K10's eid form is held against: slots
    count where ``act >= 0`` and ``take_pad(emask, eid, False)``, then
    `plain_bitmap_hop` (K19's plain slot walk over the flat slots)."""
    return plain_paged_hop(act, emit, eid, emask, frontier, gate, alive)


def plain_bitmap_hop_shard(
    indptr_sh, nbr_sh, extra_sh, is_out: bool, s0: int, emask, frontier, gate=None, alive=None
) -> torch.Tensor:
    """K10's eid form as a push in torch (`_plain_push`): the held vertices
    ``[s0·R, (s0+S_l)·R)``; vertex ``v`` is row ``v - s·R`` of shard ``s =
    v // R``, its slots that row of ``nbr_sh[s - s0]``, the edge id
    ``ebase[s - s0] + slot`` out or ``eid[s - s0, slot]`` in."""
    S_l, R = indptr_sh.shape[0], indptr_sh.shape[1] - 1
    if S_l == 0 or R <= 0:
        return torch.zeros(frontier.shape, dtype=B8, device=frontier.device)
    emax = nbr_sh.shape[1]
    ind, ex = indptr_sh.long(), extra_sh.reshape(-1).long()

    def row(v):
        sl = v // R - s0
        loc = v - (sl + s0) * R
        st = ind[sl, loc]
        aux = ex[sl] - sl * emax if is_out else torch.zeros_like(sl)
        return sl * emax + st, aux, ind[sl, loc + 1] - st

    edge = (lambda s, a: s + a) if is_out else (lambda s, a: ex[s])
    return _plain_push(
        s0 * R, (s0 + S_l) * R, row, lambda b, a, j: b + j, edge, nbr_sh.reshape(-1), emask,
        frontier, gate, alive,
    )


def bitmap_hop_shard(
    indptr_sh: torch.Tensor,
    nbr_sh: torch.Tensor,
    extra_sh: torch.Tensor,
    is_out: bool,
    s0: int,
    emask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K10's eid form: one frontier hop over the row-sharded CSR of the
    shards ``s0 .. s0+S_l-1`` held here, walked by their active vertices:
    ``out[c, nbr[s]] |= frontier[c, v]`` for each slot ``s`` of vertex
    ``v``'s row and, with ``emask`` (bool [E] in out order), a True
    ``emask[edge id]``. ``indptr_sh`` int32 [S_l, R+1] (rebased rows),
    ``nbr_sh`` int32 [S_l, emax], ``extra_sh`` ``:out:ebase`` [S_l, 1]
    (``is_out``: the edge id is ebase + the local slot) or ``:in:eid``
    [S_l, emax]. ``gate``, ``alive`` and ``out`` as for `bitmap_hop`: the
    shards' hops OR into one bitmap."""
    for t, what in ((indptr_sh, "indptr_sh"), (nbr_sh, "nbr_sh"), (extra_sh, "extra_sh")):
        _check_sharded(t, f"bitmap_hop_shard {what}")
    S_l = indptr_sh.shape[0]
    want = (S_l, 1) if is_out else tuple(nbr_sh.shape)
    if nbr_sh.shape[0] != S_l or tuple(extra_sh.shape) != want:
        raise ValueError(f"bitmap_hop_shard: nbr_sh / extra_sh do not match {S_l} shards")
    if s0 < 0:
        raise ValueError("bitmap_hop_shard: s0 must be >= 0")
    _check2d(frontier, (B8,), "bitmap_hop_shard frontier")
    C, vb = frontier.shape
    opt = []
    if emask is not None:
        _check(emask, (B8,), "bitmap_hop_shard emask")
        opt.append(emask)
    if gate is not None:
        _check(gate, (B8,), "bitmap_hop_shard gate")
        if gate.shape[0] != vb:
            raise ValueError("bitmap_hop_shard: gate and the frontier differ in width")
        opt.append(gate)
    if alive is not None:
        _check_scalar(alive, "bitmap_hop_shard alive")
        opt.append(alive)
    if out is not None:
        _check_out(out, (C, vb), B8, "bitmap_hop_shard")
        opt.append(out)
    if not _on_card(indptr_sh, nbr_sh, extra_sh, frontier, *opt):
        hop = plain_bitmap_hop_shard(indptr_sh, nbr_sh, extra_sh, is_out, s0, emask, frontier, gate, alive)
        if out is None:
            return hop
        out |= hop
        return out
    lib = _kernels.load()
    zero = out is None
    if zero:
        out = torch.empty((C, vb), dtype=B8, device=frontier.device)
    _launch(
        "bitmap_hop_shard",
        lib.csr_bitmap_hop_shard,
        indptr_sh.data_ptr(),
        indptr_sh.shape[1] - 1,
        S_l,
        s0,
        nbr_sh.data_ptr(),
        nbr_sh.shape[1],
        extra_sh.data_ptr(),
        int(bool(is_out)),
        None if emask is None else emask.data_ptr(),
        0 if emask is None else emask.shape[0],
        frontier.data_ptr(),
        None if gate is None else gate.data_ptr(),
        C,
        vb,
        None if alive is None else alive.data_ptr(),
        int(zero),
        out.data_ptr(),
        _stream(frontier),
    )
    return out


def plain_shard_weight_pass(seg, emit, eid, emask, ok, w, out) -> torch.Tensor:
    """The reference's `sharded_weight_pass` body over the edge-list
    slices' flat slots, the algorithm K23's CSR walk is held against:
    ``vals = (take_pad(emask, eid, False) & (seg >= 0) & take_pad(ok, emit,
    False)) * take_pad(w, emit, 0)`` summed into ``out`` at ``clip(seg, 0,
    vb - 1)`` (float32 in float64, rounded once); ``ok`` None keeps every
    vertex."""
    seg, emit, eid = seg.reshape(-1), emit.reshape(-1), eid.reshape(-1)
    vb = out.shape[0]
    m = seg >= 0
    if ok is not None:
        m = m & plain_take_pad(ok, emit, False)
    if emask is not None:
        m = m & plain_take_pad(emask, eid, False)
    vals = m.to(out.dtype)
    if w is not None:
        vals = vals * plain_take_pad(w, emit, 0)
    return _add_sums(out, seg.clamp(0, vb - 1).long(), vals)


def _add_sums(out: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[idx] += vals`` summed per index: int32 exactly (mod 2^32),
    float32 in float64 and rounded once (as `plain_indptr_segment_sum`),
    so that a long row's sum does not depend on the order of its adds."""
    if out.dtype != F32:
        return out.index_add_(0, idx, vals)
    acc = torch.zeros(out.shape[0], dtype=torch.float64, device=out.device)
    acc.index_add_(0, idx, vals.double())
    out += acc.to(F32)
    return out


def plain_shard_weight_pass_csr(
    indptr_sh, nbr_sh, extra_sh, is_out: bool, s0: int, emask, ok, w, out
) -> torch.Tensor:
    """K23's walk in torch: each held shard ``h`` (vertex rows ``(s0 +
    h)·R + l``) sums at each row below vb its slots ``[indptr[l],
    indptr[l+1])`` (K4's clip to the slots ``[0, emax]``), a slot weighing
    ``take_pad(ok, u, False) & take_pad(emask, edge id, False) ?
    take_pad(w, u, 0) : 0`` with ``u = nbr_sh[h, slot]`` and the edge id
    ``ebase[h] + slot`` out or ``eid[h, slot]`` in (each factor only where
    given), added into ``out`` in place (a float32 row summed in float64)."""
    S_l, R = indptr_sh.shape[0], indptr_sh.shape[1] - 1
    emax, vb = nbr_sh.shape[1], out.shape[0]
    dev = out.device
    for h in range(S_l):
        v0 = int(indptr_sh[h, 0].clamp(0, emax))
        ind = indptr_sh[h].long().clamp(v0, int(indptr_sh[h, R].clamp(v0, emax)))
        deg = ind[1:] - ind[:-1]
        rows = torch.repeat_interleave(torch.arange(R, device=dev), deg)
        slots = torch.arange(v0, int(ind[-1]), device=dev)
        u = nbr_sh[h, slots]
        keep = torch.ones(slots.shape[0], dtype=B8, device=dev)
        if ok is not None:
            keep &= plain_take_pad(ok, u, False)
        if emask is not None:
            ids = (slots + int(extra_sh[h, 0])).to(I32) if is_out else extra_sh[h, slots]
            keep &= plain_take_pad(emask, ids, False)
        vals = keep.to(out.dtype)
        if w is not None:
            vals = vals * plain_take_pad(w, u, 0)
        g = (s0 + h) * R + rows
        sel = g < vb
        _add_sums(out, g[sel], vals[sel])
    return out


def shard_weight_pass(
    indptr_sh: torch.Tensor,
    nbr_sh: torch.Tensor,
    extra_sh: torch.Tensor,
    is_out: bool,
    s0: int,
    emask: Optional[torch.Tensor],
    ok: Optional[torch.Tensor],
    w: Optional[torch.Tensor],
    out: torch.Tensor,
) -> torch.Tensor:
    """K23: one COUNT-pushdown weight pass over the row-sharded CSR of one
    direction of the shards ``s0 .. s0+S_l-1`` held here, added into
    ``out`` (int32 or float32 [vb]) in place: ``out[v] += Σ emask(e) &
    ok(u) ? w(u) : 0`` over the slots of each held row ``v`` below vb (an
    out pass sums at the source over ``:out:``, an in pass at the target
    over ``:in:``). ``indptr_sh`` int32 [S_l, R+1], ``nbr_sh`` int32 [S_l,
    emax], ``extra_sh`` ``:out:ebase`` [S_l, 1] (``is_out``: the edge id is
    ebase + the slot) or ``:in:eid`` [S_l, emax]; ``emask`` (bool [E] in
    out order), ``ok`` (bool, a vertex mask) and ``w`` (``out``'s dtype)
    may be None (every edge, every vertex, weight 1), each read with
    take_pad's semantics. The rows of different ranks are disjoint, so a
    process group's parts sum. On the card a merge-path segmented sum with
    no atomics: its float32 sums repeat bit for bit. Where ``ok`` and
    ``w`` are both given (one length, the weights at most 40 MiB) and the
    pass does not read its edge mask through ``:in:eid``, the kernel
    sequence first folds ``ok`` into the weights (one gather an edge), for
    weights over 16 MiB only where a device-side sample finds the mask
    keeping at least 30 % of the vertices; the sums are the same either
    way. Returns ``out``."""
    for t, what in ((indptr_sh, "indptr_sh"), (nbr_sh, "nbr_sh"), (extra_sh, "extra_sh")):
        _check_sharded(t, f"shard_weight_pass {what}")
    S_l = indptr_sh.shape[0]
    want = (S_l, 1) if is_out else tuple(nbr_sh.shape)
    if nbr_sh.shape[0] != S_l or tuple(extra_sh.shape) != want:
        raise ValueError(f"shard_weight_pass: nbr_sh / extra_sh do not match {S_l} shards")
    if s0 < 0:
        raise ValueError("shard_weight_pass: s0 must be >= 0")
    _check(out, (I32, F32), "shard_weight_pass out")
    vb = out.shape[0]
    opt = [out]
    for t, what in ((ok, "ok"), (emask, "emask")):
        if t is not None:
            _check(t, (B8,), f"shard_weight_pass {what}")
            opt.append(t)
    if w is not None:
        _check(w, (out.dtype,), "shard_weight_pass w")
        opt.append(w)
    if not _on_card(indptr_sh, nbr_sh, extra_sh, *opt):
        return plain_shard_weight_pass_csr(indptr_sh, nbr_sh, extra_sh, is_out, s0, emask, ok, w, out)
    lib = _kernels.load()
    R, emax = indptr_sh.shape[1] - 1, nbr_sh.shape[1]
    # the fold of ok into w (csr_kernels.cu, shard_fold_kernel): none for an
    # in pass that reads its edge mask through :in:eid (as the single-device
    # weight step keeps it apart), always where L2 gathers the weights at
    # its full rate, else decided on the device by a sample of ok
    fold = 0
    if (
        ok is not None
        and w is not None
        and ok.shape[0] == w.shape[0]
        and _nbytes(w) <= L2_KEEP_BYTES
        and (is_out or emask is None)
    ):
        fold = 1 if _nbytes(w) <= L2_FAST_BYTES else 2
    n_fold = w.shape[0] if fold else 0
    scratch = torch.empty(lib.csr_shard_weight_scratch(S_l, R, emax, n_fold), dtype=I32, device=out.device)
    # the gathered tables that stay in L2 (bits 1 ok, 2 the edge mask read
    # through :in:eid, 4 w), as weight_gather chooses them
    tables = (_nbytes(ok), 0 if is_out else _nbytes(emask), _nbytes(w))
    limit = L2_KEEP_BESIDE if max(tables) > L2_KEEP_BYTES else L2_KEEP_BYTES
    keep = sum(bit for bit, b in zip((1, 2, 4), tables) if 0 < b <= limit)

    def ptr(t):
        return None if t is None else t.data_ptr()

    _launch(
        "shard_weight_pass",
        lib.csr_shard_weight_pass_i32 if out.dtype == I32 else lib.csr_shard_weight_pass_f32,
        indptr_sh.data_ptr(),
        R,
        S_l,
        s0,
        nbr_sh.data_ptr(),
        emax,
        extra_sh.data_ptr(),
        int(bool(is_out)),
        ptr(emask),
        0 if emask is None else emask.shape[0],
        ptr(ok),
        0 if ok is None else ok.shape[0],
        ptr(w),
        0 if w is None else w.shape[0],
        keep,
        fold,
        vb,
        out.data_ptr(),
        scratch.data_ptr(),
        _stream(out),
    )
    return out


def plain_rowshard_hop(indptr_sh, dst_sh, frontier, n_shards: int) -> torch.Tensor:
    """The reference's BFS contribution (`build_bfs_step`'s ``expand``),
    shard by shard: each edge's local source by ``searchsorted`` over the
    rebased indptr, live where ``dst >= 0`` and before ``indptr[-1]``, its
    clipped target set in every lit query's row; laid out [S, Q, R]."""
    S_l, Q, R = frontier.shape
    v_pad = n_shards * R
    flat = torch.zeros((Q, v_pad), dtype=B8, device=frontier.device)
    for s in range(S_l):
        ind, dst = indptr_sh[s], dst_sh[s]
        epos = torch.arange(dst.shape[0], dtype=I32, device=dst.device)
        src_local = (torch.searchsorted(ind, epos, right=True, out_int32=True) - 1).clamp(0, R - 1)
        live = (dst >= 0) & (epos < ind[-1])
        active = frontier[s][:, src_local.long()] & live[None, :]
        q_idx, e_idx = active.nonzero(as_tuple=True)
        flat[q_idx, dst.clamp(0, v_pad - 1).long()[e_idx]] = True
    return flat.view(Q, n_shards, R).permute(1, 0, 2).contiguous()


def rowshard_hop(
    indptr_sh: torch.Tensor,
    dst_sh: torch.Tensor,
    frontier: torch.Tensor,
    n_shards: int,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K24: one hop of the row-sharded multi-source BFS. Shard s held owns
    rows [s R, (s+1) R) (``indptr_sh`` int32 [S_l, R+1] rebased, ``dst_sh``
    int32 [S_l, e_max] -1 padded) and its frontier slice ``frontier[s]``
    (bool [S_l, Q, R]); every edge of a lit row sets its target in that
    query's row of the result, bool [n_shards, Q, R] (the target's shard,
    query, local row). Into a new zeroed tensor, or ``out`` zeroed first."""
    _check_sharded(indptr_sh, "rowshard_hop indptr_sh")
    _check_sharded(dst_sh, "rowshard_hop dst_sh")
    if frontier.dtype != B8 or frontier.dim() != 3 or not frontier.is_contiguous():
        raise TypeError("rowshard_hop frontier: expected a contiguous bool [S_l, Q, R] tensor")
    S_l, Q, R = frontier.shape
    if indptr_sh.shape != (S_l, R + 1) or dst_sh.shape[0] != S_l:
        raise ValueError("rowshard_hop: indptr, dst and the frontier disagree on shards or rows")
    opt = []
    if out is not None:
        _check_out(out, (n_shards, Q, R), B8, "rowshard_hop")
        opt.append(out)
    if not _on_card(indptr_sh, dst_sh, frontier, *opt):
        hop = plain_rowshard_hop(indptr_sh, dst_sh, frontier, n_shards)
        if out is None:
            return hop
        out.copy_(hop)
        return out
    lib = _kernels.load()
    if out is None:
        out = torch.empty((n_shards, Q, R), dtype=B8, device=frontier.device)
    _launch(
        "rowshard_hop",
        lib.csr_rowshard_hop,
        indptr_sh.data_ptr(),
        R,
        dst_sh.data_ptr(),
        dst_sh.shape[1],
        frontier.data_ptr(),
        S_l,
        Q,
        n_shards,
        1,
        out.data_ptr(),
        _stream(frontier),
    )
    return out
