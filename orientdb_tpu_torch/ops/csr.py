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
snapshot (`paged_hop`, `paged_hop_miss`, `paged_expand`, over the page
pools of `storage/tiering`), and the mesh's per-shard kernels
(`degree_counts_range`, `shard_gather`, `bitmap_hop_eid`,
`shard_weight_pass`, `rowshard_hop`, for `parallel/`), each as a wrapper over a hand-written
CUDA kernel (`csrc/csr_kernels.cu`) beside its plain PyTorch version.

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
from typing import Dict, List, Optional, Tuple, Union

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
        "degree_counts",
        "degree_scan_i32",
        "gather_expand",
        "compact_indices",
        "segment_sum_i32",
        "segment_sum_f32",
        "take_pad_i32",
        "take_pad_f32",
        "take_pad_b8",
        "mask_count",
        "weight_gather_i32",
        "weight_gather_f32",
        "front_pack",
        "replay_meta",
        "narrow_i16",
        "rows_to_bitmap",
        "bitmap_hop",
        "bitmap_hop_csr",
        "bitmap_emit",
        "frontier_advance",
        "rows_with_matches",
        "group_page",
        "predicate_eval",
        "scatter_set",
        "slab_scan",
        "slab_probe",
        "paged_hop",
        "paged_hop_miss",
        "paged_expand",
        "degree_counts_range",
        "shard_gather",
        "bitmap_hop_eid",
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
    """Inclusive prefix sum of int32/float32 values (exact in int32)."""
    return _scan(vals, exclusive=False)


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


def expand_offsets(indptr: torch.Tensor, srcs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A one-hop expansion's sizing: the exclusive cumsum of
    `degree_counts(indptr, srcs)` and its sum (a 0-d tensor), int32 wrapping
    as the reference's int32 cumsum does. On the card one degree-scan launch
    (after one memset of its look-back state)."""
    _check(indptr, (I32,), "expand_offsets indptr")
    _check(srcs, (I32,), "expand_offsets srcs")
    if not _on_card(indptr, srcs):
        return plain_expand_offsets(indptr, srcs)
    lib = _kernels.load()
    k, dev = srcs.shape[0], srcs.device
    offsets = torch.empty_like(srcs)
    total = torch.empty((), dtype=I32, device=dev)
    if k == 0:
        total.zero_()
        return offsets, total
    # the look-back state, per call (a capture takes it from the graph's pool)
    state = torch.empty(int(lib.csr_degree_scan_scratch(k)), dtype=torch.uint8, device=dev)
    _launch(
        "degree_scan_i32",
        lib.csr_degree_scan_i32,
        indptr.data_ptr(),
        indptr.shape[0] - 1,
        srcs.data_ptr(),
        k,
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
    On the card one merge-path launch.
    """
    for t, what in ((indptr, "indptr"), (neighbors, "neighbors"), (srcs, "srcs"), (offsets, "offsets")):
        _check(t, (I32,), f"gather_expand {what}")
    if total.dtype != I32 or total.dim() != 0:
        raise TypeError("gather_expand total: expected a 0-d int32 tensor")
    if offsets.shape[0] != srcs.shape[0]:
        raise ValueError("gather_expand: offsets and srcs differ in length")
    mapped = () if edge_map is None else (edge_map,)
    if edge_map is not None:
        _check(edge_map, (I32,), "gather_expand edge_map")
    if not _on_card(indptr, neighbors, srcs, offsets, total, *mapped):
        return plain_gather_expand(indptr, neighbors, srcs, offsets, total, out_size, edge_map)
    lib = _kernels.load()
    row = torch.empty(out_size, dtype=I32, device=srcs.device)
    edge_pos = torch.empty_like(row)
    nbr = torch.empty_like(row)
    _launch(
        "gather_expand",
        lib.csr_gather_expand,
        indptr.data_ptr(),
        indptr.shape[0] - 1,
        neighbors.data_ptr(),
        neighbors.shape[0],
        srcs.data_ptr(),
        offsets.data_ptr(),
        srcs.shape[0],
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
    res = torch.full((out_size,), -1, dtype=I32, device=mask.device)
    if mask.shape[0]:
        ranks = plain_cumsum(mask.to(I32))
        keep = mask & (ranks <= out_size)
        pos = torch.arange(mask.shape[0], dtype=I32, device=mask.device)
        res[(ranks[keep] - 1).long()] = pos[keep]
    if out is None:
        return res
    kept = min(int(mask.sum()), out_size)
    out[offset : offset + kept] = res[:kept]
    return out[offset : offset + out_size]


def compact_indices(
    mask: torch.Tensor, out_size: int, out: Optional[torch.Tensor] = None, offset: int = 0
) -> torch.Tensor:
    """Indices of True entries (ascending), -1-padded to `out_size`; the
    first `out_size` when there are more.

    The offset form (``out`` given: an int32 buffer) writes the indices into
    ``out[offset : offset + out_size]`` and returns that view; the slots past
    the mask's count are left as they are (the caller fills the buffer
    once)."""
    _check(mask, (torch.bool,), "compact_indices")
    if out is not None:
        _check(out, (I32,), "compact_indices out")
        if offset < 0 or offset + out_size > out.shape[0]:
            raise ValueError(
                f"compact_indices: [{offset}, {offset + out_size}) outside the {out.shape[0]}-slot buffer"
            )
    if not (_on_card(mask) if out is None else _on_card(mask, out)):
        return plain_compact_indices(mask, out_size, out, offset)
    lib = _kernels.load()
    n, dev = mask.shape[0], mask.device
    state_bytes = int(lib.csr_compact_scratch(n))
    if out is None:
        # the fill form: the look-back state right behind the slots (8-byte
        # aligned), so that one memset sets both
        lead = out_size + (out_size & 1)
        buf = torch.empty(lead + state_bytes // 4, dtype=I32, device=dev)
        dst, state = buf.data_ptr(), buf.data_ptr() + 4 * lead
    else:
        buf = torch.empty(state_bytes, dtype=torch.uint8, device=dev)
        dst, state = out.data_ptr() + 4 * offset, buf.data_ptr()
    _launch(
        "compact_indices",
        lib.csr_compact,
        mask.data_ptr(),
        n,
        out_size,
        dst,
        state,
        int(out is None),
        _stream(mask),
    )
    return buf[:out_size] if out is None else out[offset : offset + out_size]


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


def indptr_segment_sum(
    vals: torch.Tensor, indptr: torch.Tensor, out_size: int
) -> torch.Tensor:
    """Per-vertex sums of CSR-ordered values, zero-padded (or cut) to
    `out_size`. ``indptr`` is non-decreasing within ``[0, len(vals)]`` (a
    CSR's own); on the card a merge-path reduction whose float32 sums are
    the same bit for bit from call to call."""
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


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def take_pad(values: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """`values[idx]` where idx ≥ 0, else `fill` (padding-safe gather);
    indices past the end read the last value, as the reference's clip."""
    _check(values, tuple(_TAKE), "take_pad values")
    _check(idx, (I32,), "take_pad idx")
    if not _on_card(values, idx):
        return plain_take_pad(values, idx, fill)
    name, entry, cast = _TAKE[values.dtype]
    lib = _kernels.load()
    out = torch.empty(idx.shape[0], dtype=values.dtype, device=idx.device)
    _launch(
        name,
        getattr(lib, entry),
        values.data_ptr(),
        values.shape[0],
        idx.data_ptr(),
        idx.shape[0],
        cast(fill),
        int(_nbytes(values) <= L2_KEEP_BYTES),
        out.data_ptr(),
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
    than -0.0, as the pushdown's sums are."""
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


def plain_mask_count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=I32)


def mask_count(mask: torch.Tensor) -> torch.Tensor:
    """Popcount of a boolean mask as a 0-d int32 tensor."""
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


def front_pack(
    valid: torch.Tensor, cols: List[torch.Tensor], out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Live rows (``valid != 0``) first, in slot order, then rows of -1:
    int32 [W, C], row-major, so that a page of the result is a prefix of
    its rows. ``out`` (optional) receives the result."""
    _check(valid, (I32,), "front_pack valid")
    W, C = valid.shape[0], len(cols)
    if C == 0:
        raise ValueError("front_pack: no columns")
    for c in cols:
        _check(c, (I32,), "front_pack column")
        if c.shape[0] != W:
            raise ValueError("front_pack: a column and the valid mask differ in length")
    if out is None:
        out = torch.empty((W, C), dtype=I32, device=valid.device)
    _check_out(out, (W, C), I32, "front_pack")
    if not _on_card(valid, out, *cols):
        out.copy_(plain_front_pack(valid, cols))
        return out
    if W == 0:
        return out
    lib = _kernels.load()
    ranks = value_cumsum(valid)
    for c0 in range(0, C, _PACK_COLS):
        chunk = cols[c0 : c0 + _PACK_COLS]
        ptrs = (ctypes.c_void_p * len(chunk))(*(c.data_ptr() for c in chunk))
        _launch(
            "front_pack",
            lib.csr_front_pack,
            valid.data_ptr(),
            ranks.data_ptr(),
            W,
            ctypes.cast(ptrs, ctypes.c_void_p),
            len(chunk),
            c0,
            C,
            out.data_ptr(),
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


def replay_meta(
    data: torch.Tensor,
    count: torch.Tensor,
    overflow: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The meta row of a replay's result, int32 [3]: the live count, the
    overflow flag and the int16 election flag over the front-packed
    int32 [W, C] ``data``. ``out`` (optional) receives the row."""
    if data.dtype != I32 or data.dim() != 2 or not data.is_contiguous():
        raise ValueError("replay_meta data: expected a contiguous int32 [W, C] tensor")
    for t, what in ((count, "count"), (overflow, "overflow")):
        if t.dtype != I32 or t.dim() != 0:
            raise TypeError(f"replay_meta {what}: expected a 0-d int32 tensor")
    if out is None:
        out = torch.empty(3, dtype=I32, device=data.device)
    _check_out(out, (3,), I32, "replay_meta")
    if not _on_card(data, count, overflow, out):
        out.copy_(plain_replay_meta(data, count, overflow))
        return out
    lib = _kernels.load()
    _launch(
        "replay_meta",
        lib.csr_replay_meta,
        data.data_ptr(),
        data.shape[0],
        data.shape[1],
        count.data_ptr(),
        overflow.data_ptr(),
        out.data_ptr(),
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
    ``eid``), then `plain_bitmap_hop`."""
    nv = indptr.shape[0] - 1
    deg = (indptr[1:] - indptr[:-1]).long()
    act = torch.repeat_interleave(torch.arange(nv, dtype=I32, device=indptr.device), deg)
    slots = torch.arange(act.shape[0], device=indptr.device) + indptr[0].long()
    m = None
    if edge_mask is not None:
        m = edge_mask[slots] if eid is None else plain_take_pad(edge_mask, eid[slots], False)
    return plain_bitmap_hop(act, nbr[slots], m, frontier, gate, alive)


def bitmap_hop_csr(
    indptr: torch.Tensor,
    nbr: torch.Tensor,
    eid: Optional[torch.Tensor],
    edge_mask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
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
    ``out`` as for `bitmap_hop`. Returns the bitmap."""
    _check(indptr, (I32,), "bitmap_hop_csr indptr")
    _check(nbr, (I32,), "bitmap_hop_csr nbr")
    _check2d(frontier, (B8,), "bitmap_hop_csr frontier")
    C, vb = frontier.shape
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
    if gate is not None:
        _check(gate, (B8,), "bitmap_hop_csr gate")
        if gate.shape[0] != vb:
            raise ValueError("bitmap_hop_csr: gate and the frontier differ in width")
        opt.append(gate)
    if alive is not None:
        _check_scalar(alive, "bitmap_hop_csr alive")
        opt.append(alive)
    if out is not None:
        _check_out(out, (C, vb), B8, "bitmap_hop_csr")
        opt.append(out)
    if not _on_card(indptr, nbr, frontier, *opt):
        hop = plain_bitmap_hop_csr(indptr, nbr, eid, edge_mask, frontier, gate, alive)
        if out is None:
            return hop
        out |= hop
        return out
    lib = _kernels.load()
    zero = out is None
    if zero:
        out = torch.empty((C, vb), dtype=B8, device=frontier.device)
    _launch(
        "bitmap_hop_csr",
        lib.csr_bitmap_hop_csr,
        indptr.data_ptr(),
        nv,
        nbr.data_ptr(),
        None if eid is None or edge_mask is None else eid.data_ptr(),
        None if edge_mask is None else edge_mask.data_ptr(),
        ne,
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
    for: bool [C, vb], bool [C] and a 0-d int32."""
    _check2d(reached, (B8,), "bitmap_emit reached")
    _check(node, (B8,), "bitmap_emit node")
    C, vb = reached.shape
    if node.shape[0] != vb:
        raise ValueError("bitmap_emit: node mask and bitmap differ in width")
    opt = []
    if bound is not None:
        _check(bound, (I32,), "bitmap_emit bound")
        if bound.shape[0] != C:
            raise ValueError("bitmap_emit: bound and bitmap differ in rows")
        opt.append(bound)
    if not _on_card(reached, node, *opt):
        return plain_bitmap_emit(reached, node, bound, emit, any_row, count)
    lib = _kernels.load()
    dev = reached.device
    e_out = torch.empty((C, vb), dtype=B8, device=dev) if emit else None
    a_out = torch.empty(C, dtype=B8, device=dev) if any_row else None
    c_out = torch.empty((), dtype=I32, device=dev) if count else None
    _launch(
        "bitmap_emit",
        lib.csr_bitmap_emit,
        reached.data_ptr(),
        node.data_ptr(),
        None if bound is None else bound.data_ptr(),
        C,
        vb,
        None if e_out is None else e_out.data_ptr(),
        None if a_out is None else a_out.data_ptr(),
        None if c_out is None else c_out.data_ptr(),
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
    as there), from the same pass."""
    _check2d(nxt, (B8,), "frontier_advance nxt")
    _check2d(visited, (B8,), "frontier_advance visited")
    if nxt.shape != visited.shape:
        raise ValueError("frontier_advance: bitmaps differ in shape")
    C, vb = nxt.shape
    ts = [nxt, visited]
    for vec, what in ((gate, "gate"), (node, "node")):
        if vec is not None:
            _check(vec, (B8,), f"frontier_advance {what}")
            if vec.shape[0] != vb:
                raise ValueError(f"frontier_advance: {what} and bitmap rows differ in length")
            ts.append(vec)
    if bound is not None:
        if node is None:
            raise ValueError("frontier_advance: bound without node")
        _check(bound, (I32,), "frontier_advance bound")
        if bound.shape[0] != C:
            raise ValueError("frontier_advance: bound and bitmap differ in rows")
        ts.append(bound)
    if not _on_card(*ts):
        return plain_frontier_advance(nxt, visited, gate, node, bound)
    lib = _kernels.load()
    count = torch.empty((), dtype=I32, device=nxt.device)
    emitted = None if node is None else torch.empty((), dtype=I32, device=nxt.device)
    _launch(
        "frontier_advance",
        lib.csr_frontier_advance,
        nxt.data_ptr(),
        visited.data_ptr(),
        None if gate is None else gate.data_ptr(),
        None if node is None else node.data_ptr(),
        None if bound is None else bound.data_ptr(),
        nxt.numel(),
        vb,
        count.data_ptr(),
        None if emitted is None else emitted.data_ptr(),
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
    tensor. Returns the counts."""
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
    lib = _kernels.load()
    zero = out is None
    if zero:
        out = torch.empty(num_segments, dtype=I32, device=rows.device)
    _launch(
        "rows_with_matches",
        lib.csr_rows_with_matches,
        rows.data_ptr(),
        mask.data_ptr(),
        rows.shape[0],
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
        self.code = torch.tensor(self.rows, dtype=I32).reshape(-1, 4).to(device)


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
    ``depth`` the WHILE level."""
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
            args.blen[j] = t.shape[0]
        lib = _kernels.load()
        _launch("predicate_eval", lib.csr_predicate_eval, ctypes.byref(args), _stream(prog.code))
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
    total. Two launches: a count pass and an emit pass (with K1's scan of
    the counts between them)."""
    for t, what in ((a, "a"), (e, "e"), (srcs, "srcs")):
        _check(t, (I32,), f"slab_scan {what}")
    _check(live, (torch.bool,), "slab_scan live")
    W, R = a.shape[0], srcs.shape[0]
    if e.shape[0] != W or live.shape[0] != W:
        raise ValueError("slab_scan: a, e and live differ in length")
    if not _on_card(a, e, live, srcs):
        return plain_slab_scan(a, e, live, srcs, base, size_for)
    lib = _kernels.load()
    dev = a.device
    counts = torch.empty(R, dtype=I32, device=dev)
    _launch(
        "slab_scan", lib.csr_slab_scan_count,
        a.data_ptr(), live.data_ptr(), W, srcs.data_ptr(), R, counts.data_ptr(), _stream(a),
    )
    offsets, total = exclusive_cumsum_total(counts)
    out = size_for(total)
    row = torch.empty(out, dtype=I32, device=dev)
    eid, nbr = torch.empty_like(row), torch.empty_like(row)
    _launch(
        "slab_scan", lib.csr_slab_scan_emit,
        a.data_ptr(), e.data_ptr(), live.data_ptr(), W, srcs.data_ptr(), counts.data_ptr(),
        offsets.data_ptr(), R, total.data_ptr(), int(base), out,
        row.data_ptr(), eid.data_ptr(), nbr.data_ptr(), _stream(a),
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
    """The reference's `paged_hop`: the flattened pool as an edge list
    whose slots count when ``own >= 0`` (and ``take_pad(emask, eid,
    False)``), through `plain_bitmap_hop`."""
    own_f, nbr_f = own.reshape(-1), nbr.reshape(-1)
    m = own_f >= 0
    if emask is not None:
        m = m & plain_take_pad(emask, eid.reshape(-1), False)
    return plain_bitmap_hop(own_f, nbr_f, m, frontier, gate, alive)


def paged_hop(
    own: torch.Tensor,
    nbr: torch.Tensor,
    eid: torch.Tensor,
    emask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One frontier hop over a paged partition's pool (K19):
    ``out[c, nbr[s]] |= frontier[c, own[s]]`` for the pool slots with
    ``own[s] >= 0`` and, with ``emask`` (bool [E] in out order), a True
    ``emask[eid[s]]`` (-1 reads False). ``own`` / ``nbr`` / ``eid`` int32
    [P, Wp]; ``gate``, ``alive`` and ``out`` as for `bitmap_hop`."""
    for t, what in ((own, "own"), (nbr, "nbr"), (eid, "eid")):
        _check_pool(t, f"paged_hop {what}")
    if nbr.shape != own.shape or eid.shape != own.shape:
        raise ValueError("paged_hop: own, nbr and eid differ in shape")
    _check2d(frontier, (B8,), "paged_hop frontier")
    C, vb = frontier.shape
    opt = []
    if emask is not None:
        _check(emask, (B8,), "paged_hop emask")
        opt.append(emask)
    if gate is not None:
        _check(gate, (B8,), "paged_hop gate")
        if gate.shape[0] != vb:
            raise ValueError("paged_hop: gate and the frontier differ in width")
        opt.append(gate)
    if alive is not None:
        _check_scalar(alive, "paged_hop alive")
        opt.append(alive)
    if out is not None:
        _check_out(out, (C, vb), B8, "paged_hop")
        opt.append(out)
    if not _on_card(own, nbr, eid, frontier, *opt):
        hop = plain_paged_hop(own, nbr, eid, emask, frontier, gate, alive)
        if out is None:
            return hop
        out |= hop
        return out
    lib = _kernels.load()
    zero = out is None
    if zero:
        out = torch.empty((C, vb), dtype=B8, device=frontier.device)
    _launch(
        "paged_hop",
        lib.csr_paged_hop,
        own.data_ptr(),
        nbr.data_ptr(),
        eid.data_ptr(),
        own.numel(),
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
    read back to the host."""
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


def plain_paged_expand(indptr, srcs, offsets, total, out_size, blockv, pageof, estart, pool_nbr, pool_eid, out_dir):
    """The reference's `paged_expand`: `plain_gather_expand` without a
    neighbour array for row and edge_pos, then the block → page
    indirection with its clips, cold and padding slots nulled, and the
    flag ``any(live & cold)``. Every gather is a `plain_take_pad`."""
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
    return torch.where(ok, row, -1), torch.where(ok, eid, -1), torch.where(ok, nbr, -1), cold.any()


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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CSR gather of a paged partition (K21): ``(row, eid, nbr,
    cold)``. Row and edge position come from the resident ``indptr`` as in
    `gather_expand` (``offsets`` / ``total`` / ``out_size`` as there); the
    neighbour (and, for the in direction, the edge id in out order) from
    the pool ``pool_nbr`` / ``pool_eid`` (int32 [P, Wp]) at page
    ``pageof[blockv[src]]``, slot ``edge_pos - estart[block]``. The out
    direction's edge id is the edge position (``pool_eid`` may be None).
    Slots of a cold block are -1 and raise ``cold``, a 0-d bool on the
    device."""
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
    if not _on_card(indptr, srcs, offsets, total, blockv, pageof, estart, pool_nbr, *opt):
        return plain_paged_expand(
            indptr, srcs, offsets, total, out_size, blockv, pageof, estart, pool_nbr, pool_eid, out_dir
        )
    lib = _kernels.load()
    dev = srcs.device
    row = torch.empty(out_size, dtype=I32, device=dev)
    eid, nbr = torch.empty_like(row), torch.empty_like(row)
    cold = torch.empty((), dtype=B8, device=dev)
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
    """The reference's shard hop (`sharded_bitmap_hop` body): slots count
    where ``act >= 0`` and ``take_pad(emask, eid, False)``, then
    `plain_bitmap_hop` (K19's plain version over the flat slots)."""
    return plain_paged_hop(act, emit, eid, emask, frontier, gate, alive)


def bitmap_hop_eid(
    act: torch.Tensor,
    emit: torch.Tensor,
    eid: torch.Tensor,
    emask: Optional[torch.Tensor],
    frontier: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    alive: Optional[torch.Tensor] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K10's eid form: one frontier hop over the edge-list slices of every
    shard held (``act`` / ``emit`` / ``eid`` int32 [S_l, W], -1 padded):
    ``out[c, emit[s]] |= frontier[c, act[s]]`` for the slots with ``act[s]
    >= 0`` and, with ``emask`` (bool [E] in out order), ``emask[eid[s]]``.
    ``gate``, ``alive`` and ``out`` as for `bitmap_hop`: the shards' hops
    OR into one bitmap."""
    for t, what in ((act, "act"), (emit, "emit"), (eid, "eid")):
        _check_sharded(t, f"bitmap_hop_eid {what}")
    if emit.shape != act.shape or eid.shape != act.shape:
        raise ValueError("bitmap_hop_eid: act, emit and eid differ in shape")
    _check2d(frontier, (B8,), "bitmap_hop_eid frontier")
    C, vb = frontier.shape
    opt = []
    if emask is not None:
        _check(emask, (B8,), "bitmap_hop_eid emask")
        opt.append(emask)
    if gate is not None:
        _check(gate, (B8,), "bitmap_hop_eid gate")
        if gate.shape[0] != vb:
            raise ValueError("bitmap_hop_eid: gate and the frontier differ in width")
        opt.append(gate)
    if alive is not None:
        _check_scalar(alive, "bitmap_hop_eid alive")
        opt.append(alive)
    if out is not None:
        _check_out(out, (C, vb), B8, "bitmap_hop_eid")
        opt.append(out)
    if not _on_card(act, emit, eid, frontier, *opt):
        hop = plain_bitmap_hop_eid(act, emit, eid, emask, frontier, gate, alive)
        if out is None:
            return hop
        out |= hop
        return out
    lib = _kernels.load()
    zero = out is None
    if zero:
        out = torch.empty((C, vb), dtype=B8, device=frontier.device)
    _launch(
        "bitmap_hop_eid",
        lib.csr_bitmap_hop_eid,
        act.data_ptr(),
        emit.data_ptr(),
        eid.data_ptr(),
        act.numel(),
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
    """The reference's `sharded_weight_pass` body over the flat slots:
    ``vals = (take_pad(emask, eid, False) & (seg >= 0) & take_pad(ok, emit,
    False)) * take_pad(w, emit, 0)`` summed into ``out`` at ``clip(seg, 0,
    vb - 1)``."""
    seg, emit, eid = seg.reshape(-1), emit.reshape(-1), eid.reshape(-1)
    vb = out.shape[0]
    m = (seg >= 0) & plain_take_pad(ok, emit, False)
    if emask is not None:
        m = m & plain_take_pad(emask, eid, False)
    vals = m.to(out.dtype)
    if w is not None:
        vals = vals * plain_take_pad(w, emit, 0)
    out.index_add_(0, seg.clamp(0, vb - 1).long(), vals)
    return out


def shard_weight_pass(
    seg: torch.Tensor,
    emit: torch.Tensor,
    eid: torch.Tensor,
    emask: Optional[torch.Tensor],
    ok: torch.Tensor,
    w: Optional[torch.Tensor],
    out: torch.Tensor,
) -> torch.Tensor:
    """K23: one COUNT-pushdown weight pass over the edge-list slices of
    every shard held (``seg`` / ``emit`` / ``eid`` int32 [S_l, W], -1
    padded), added into ``out`` (int32 or float32 [vb]) in place:
    ``out[clip(seg)] += emask[eid] & ok[emit] ? w[emit] : 0`` for the slots
    with ``seg >= 0``; ``emask`` (bool [E]) None admits every edge and
    ``w`` (``out``'s dtype, [vb]) None weighs 1. Returns ``out``."""
    for t, what in ((seg, "seg"), (emit, "emit"), (eid, "eid")):
        _check_sharded(t, f"shard_weight_pass {what}")
    if emit.shape != seg.shape or eid.shape != seg.shape:
        raise ValueError("shard_weight_pass: seg, emit and eid differ in shape")
    _check(out, (I32, F32), "shard_weight_pass out")
    vb = out.shape[0]
    _check(ok, (B8,), "shard_weight_pass ok")
    if ok.shape[0] != vb:
        raise ValueError("shard_weight_pass: ok and out differ in length")
    opt = [ok, out]
    if emask is not None:
        _check(emask, (B8,), "shard_weight_pass emask")
        opt.append(emask)
    if w is not None:
        _check(w, (out.dtype,), "shard_weight_pass w")
        if w.shape[0] != vb:
            raise ValueError("shard_weight_pass: w and out differ in length")
        opt.append(w)
    if not _on_card(seg, emit, eid, *opt):
        return plain_shard_weight_pass(seg, emit, eid, emask, ok, w, out)
    lib = _kernels.load()
    fn = lib.csr_shard_weight_pass_i32 if out.dtype == I32 else lib.csr_shard_weight_pass_f32
    _launch(
        "shard_weight_pass",
        fn,
        seg.data_ptr(),
        emit.data_ptr(),
        eid.data_ptr(),
        seg.numel(),
        None if emask is None else emask.data_ptr(),
        0 if emask is None else emask.shape[0],
        ok.data_ptr(),
        None if w is None else w.data_ptr(),
        vb,
        out.data_ptr(),
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
