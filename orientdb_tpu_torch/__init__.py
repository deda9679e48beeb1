"""PyTorch/CUDA port of `orientdb_tpu`: compiled MATCH over a columnar graph
snapshot on an NVIDIA H100, with hand-written CUDA kernels for the CSR
primitives (`ops/csr.py`, `csrc/csr_kernels.cu`).

Module paths mirror the reference package's, so each module's counterpart
is found by its path. The package imports torch and nothing of the
reference package.
"""

from orientdb_tpu_torch.models.database import Database

__all__ = ["Database"]
