"""Port of `orientdb_tpu/ops/csr.py`: the CSR primitives of the compiled
MATCH path, each as a wrapper over a hand-written CUDA kernel
(`csrc/csr_kernels.cu`) beside its plain PyTorch version.

A wrapper checks dtype, contiguity and device, then:
- a CPU tensor goes to the plain version (``plain_*``), the reference's
  arithmetic in torch — the CPU tests run this path;
- a CUDA tensor goes to the kernel. If the library cannot be built or
  loaded, or a launch is refused, the wrapper raises: nothing falls back.

Each kernel launch adds one to ``LAUNCHES[name]`` (launches made through the
wrappers only), so a run can show that its main path went through the
kernels. Sizes follow the reference's static-shape discipline: buffers are
bucketed to powers of two (`bucket`) and padding rows carry -1. Every
integer result is int32, as in the reference (JAX runs with x64 off).
"""

from __future__ import annotations

from typing import Dict, Tuple

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
        "gather_expand",
        "compact_indices",
        "segment_sum_i32",
        "segment_sum_f32",
        "take_pad_i32",
        "take_pad_f32",
        "take_pad_b8",
        "mask_count",
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

_TILE = 1024  # the kernel's elements per block


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


def _scan(vals: torch.Tensor, exclusive: bool) -> torch.Tensor:
    _check(vals, (I32, F32), "scan")
    if not _on_card(vals):
        return plain_cumsum(vals, exclusive)
    lib = _kernels.load()
    n = vals.shape[0]
    out = torch.empty_like(vals)
    if n == 0:
        return out
    scratch = torch.empty(
        int(lib.csr_scan_scratch(n)), dtype=vals.dtype, device=vals.device
    )
    is_int = vals.dtype == I32
    _launch(
        "scan_i32" if is_int else "scan_f32",
        lib.csr_scan_i32 if is_int else lib.csr_scan_f32,
        vals.data_ptr(),
        out.data_ptr(),
        n,
        scratch.data_ptr(),
        int(exclusive),
        _stream(vals),
    )
    return out


def value_cumsum(vals: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of int32/float32 values (exact in int32)."""
    return _scan(vals, exclusive=False)


def exclusive_cumsum(counts: torch.Tensor) -> torch.Tensor:
    return _scan(counts, exclusive=True)


def mask_cumsum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a boolean mask, as int32."""
    _check(mask, (torch.bool,), "mask_cumsum")
    return value_cumsum(mask.to(I32))


def value_sum(vals: torch.Tensor) -> torch.Tensor:
    """Sum of int32/float32 values as a 0-d tensor of the same dtype: the
    last element of the inclusive scan (int32 wraps as the reference's
    int32 reduction does)."""
    if vals.shape[0] == 0:
        return torch.zeros((), dtype=vals.dtype, device=vals.device)
    return value_cumsum(vals)[-1]


# ---------------------------------------------------------------------------
# K2: degree_counts + gather_expand
# ---------------------------------------------------------------------------


def plain_degree_counts(indptr: torch.Tensor, srcs: torch.Tensor) -> torch.Tensor:
    nv = indptr.shape[0] - 1
    valid = srcs >= 0
    if nv <= 0:
        return torch.zeros_like(srcs)
    s = torch.where(valid, srcs, 0).clamp(0, nv - 1).long()
    return torch.where(valid, indptr[s + 1] - indptr[s], 0).to(I32)


def degree_counts(indptr: torch.Tensor, srcs: torch.Tensor) -> torch.Tensor:
    """Per-source neighbor counts; padding (src=-1) counts 0."""
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


def plain_gather_expand(indptr, neighbors, srcs, offsets, total, out_size: int):
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
    return (
        torch.where(valid, row, -1),
        torch.where(valid, edge_pos, -1),
        torch.where(valid, nbr, -1),
    )


def gather_expand(
    indptr: torch.Tensor,
    neighbors: torch.Tensor,
    srcs: torch.Tensor,
    offsets: torch.Tensor,
    total: torch.Tensor,
    out_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand every source's CSR slice into flat (row, edge_pos, neighbor).

    `offsets` is the exclusive cumsum of `degree_counts(indptr, srcs)` and
    `total` its sum (0-d int32 tensor); `out_size` ≥ total. Returns int32
    arrays of length `out_size`, -1 past `total`:
      row      — index into `srcs` this output came from
      edge_pos — position in CSR edge order
      neighbor — the reached vertex (dst for out-CSR, src for in-CSR)
    """
    for t, what in ((indptr, "indptr"), (neighbors, "neighbors"), (srcs, "srcs"), (offsets, "offsets")):
        _check(t, (I32,), f"gather_expand {what}")
    if total.dtype != I32 or total.dim() != 0:
        raise TypeError("gather_expand total: expected a 0-d int32 tensor")
    if offsets.shape[0] != srcs.shape[0]:
        raise ValueError("gather_expand: offsets and srcs differ in length")
    if not _on_card(indptr, neighbors, srcs, offsets, total):
        return plain_gather_expand(indptr, neighbors, srcs, offsets, total, out_size)
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
        row.data_ptr(),
        edge_pos.data_ptr(),
        nbr.data_ptr(),
        _stream(srcs),
    )
    return row, edge_pos, nbr


# ---------------------------------------------------------------------------
# K3: compact_indices
# ---------------------------------------------------------------------------


def plain_compact_indices(mask: torch.Tensor, out_size: int) -> torch.Tensor:
    out = torch.full((out_size,), -1, dtype=I32, device=mask.device)
    if mask.shape[0] == 0:
        return out
    ranks = plain_cumsum(mask.to(I32))
    keep = mask & (ranks <= out_size)
    pos = torch.arange(mask.shape[0], dtype=I32, device=mask.device)
    out[(ranks[keep] - 1).long()] = pos[keep]
    return out


def compact_indices(mask: torch.Tensor, out_size: int) -> torch.Tensor:
    """Indices of True entries (ascending), -1-padded to `out_size`; the
    first `out_size` when there are more."""
    _check(mask, (torch.bool,), "compact_indices")
    if not _on_card(mask):
        return plain_compact_indices(mask, out_size)
    lib = _kernels.load()
    n = mask.shape[0]
    ranks = mask_cumsum(mask)
    out = torch.empty(out_size, dtype=I32, device=mask.device)
    _launch(
        "compact_indices",
        lib.csr_compact_scatter,
        mask.data_ptr(),
        ranks.data_ptr(),
        n,
        out_size,
        out.data_ptr(),
        _stream(mask),
    )
    return out


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
    `out_size`."""
    _check(vals, (I32, F32), "indptr_segment_sum vals")
    _check(indptr, (I32,), "indptr_segment_sum indptr")
    if not _on_card(vals, indptr):
        return plain_indptr_segment_sum(vals, indptr, out_size)
    lib = _kernels.load()
    out = torch.empty(out_size, dtype=vals.dtype, device=vals.device)
    is_int = vals.dtype == I32
    _launch(
        "segment_sum_i32" if is_int else "segment_sum_f32",
        lib.csr_segment_sum_i32 if is_int else lib.csr_segment_sum_f32,
        vals.data_ptr(),
        vals.shape[0],
        indptr.data_ptr(),
        min(indptr.shape[0] - 1, out_size),
        out_size,
        out.data_ptr(),
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
        out.data_ptr(),
        _stream(idx),
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
