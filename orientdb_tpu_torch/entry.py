"""The graft entry's forward step in the port: one batched one-hop expansion of a
frontier over a CSR, with a fused ``age > 30`` mask on the reached
vertices. Counterpart of ``__graft_entry__._forward`` (the reference's
flagship single-chip step): K2b's merge-path gather, then two K5 gathers of
the ``age`` column's values and presence.

    from orientdb_tpu_torch.entry import forward
    row, edge_pos, nbr, mask = forward(indptr, dst, srcs, offsets, total,
                                       age_vals, age_present, out_size)

The tensors' device decides where it runs: on a CUDA card every step is a
kernel launch, on the CPU the kernels' plain versions run (the tests).
``offsets`` and ``total`` are ``ops.csr.expand_offsets(indptr, srcs)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from orientdb_tpu_torch.ops import csr as K


def forward(
    indptr: torch.Tensor,
    dst: torch.Tensor,
    srcs: torch.Tensor,
    offsets: torch.Tensor,
    total: torch.Tensor,
    age_vals: torch.Tensor,
    age_present: torch.Tensor,
    out_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row, edge_pos, neighbour or -1 where the mask fails, mask) of the
    ``out_size`` expansion slots; int32 age values and bool presence."""
    row, edge_pos, nbr = K.gather_expand(indptr, dst, srcs, offsets, total, out_size)
    av = K.take_pad(age_vals, nbr, 0)
    ap = K.take_pad(age_present, nbr, False)
    mask = (nbr >= 0) & ap & (av > 30)
    return row, edge_pos, torch.where(mask, nbr, -1), mask
