"""Build and bind the hand-written CUDA kernels of `csrc/csr_kernels.cu`.

The source is compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, cached under ``_build/`` in this
package by the hash of the source, and loaded with ``ctypes``. Nothing is
built or loaded when this module is imported: `load()` does it, and raises
if the toolkit or the card is missing (a CUDA tensor never falls back to
the plain versions).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "csr_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry point → argument types (every pointer and the stream as void*)
SIGNATURES = {
    "csr_scan_scratch": [_N],
    "csr_compact_scratch": [_N],
    "csr_scan_i32": [_P, _P, _P, _N, _P, _I, _P],
    "csr_scan_f32": [_P, _P, _P, _N, _P, _I, _P],
    "csr_scan_lanes_i32": [_P, _P, _P, _N, _N, _P, _I, _P],
    "csr_degree_counts": [_P, _N, _P, _N, _P, _P],
    "csr_degree_scan_scratch": [_N],
    "csr_degree_scan_lanes_i32": [_P, _N, _P, _N, _N, _P, _P, _P, _P],
    "csr_gather_expand_lanes": [_P, _N, _P, _N, _P, _P, _N, _N, _P, _N, _P, _N, _P, _P, _P, _P],
    "csr_compact_lanes": [_P, _N, _N, _N, _P, _P, _I, _P],
    "csr_segment_scratch": [_N, _N],
    "csr_segment_sum_i32": [_P, _N, _P, _N, _N, _P, _P, _P],
    "csr_segment_sum_f32": [_P, _N, _P, _N, _N, _P, _P, _P],
    "csr_segment_lanes_scratch": [_N, _N, _N],
    "csr_segment_sum_lanes_i32": [_P, _N, _N, _P, _N, _N, _P, _P, _P],
    "csr_segment_sum_lanes_f32": [_P, _N, _N, _P, _N, _N, _P, _P, _P],
    "csr_take_pad_i32": [_P, _N, _P, _N, _I, _I, _P, _N, _N, _P],
    "csr_take_pad_f32": [_P, _N, _P, _N, _F, _I, _P, _N, _N, _P],
    "csr_take_pad_b8": [_P, _N, _P, _N, _I, _I, _P, _N, _N, _P],
    "csr_mask_count": [_P, _N, _P, _P],
    "csr_mask_count_lanes": [_P, _N, _N, _P, _P],
    "csr_weight_gather_i32": [_P, _N, _P, _N, _P, _P, _N, _P, _P, _N, _I, _P, _P],
    "csr_weight_gather_f32": [_P, _N, _P, _N, _P, _P, _N, _P, _P, _N, _I, _P, _P],
    "csr_weight_gather_lanes_i32": [_P, _N, _P, _N, _N, _P, _N, _P, _N, _N, _P, _P, _N, _N, _N, _I, _P, _P],
    "csr_weight_gather_lanes_f32": [_P, _N, _P, _N, _N, _P, _N, _P, _N, _N, _P, _P, _N, _N, _N, _I, _P, _P],
    "csr_front_pack_lanes": [_P, _P, _N, _N, _P, _I, _I, _I, _P, _N, _P],
    "csr_replay_meta_lanes": [_P, _N, _I, _N, _N, _P, _P, _P, _N, _P],
    "csr_narrow_i16": [_P, _N, _P, _P],
    "csr_rows_to_bitmap": [_P, _N, _N, _P, _P],
    "csr_bitmap_hop": [_P, _P, _P, _N, _P, _P, _N, _N, _P, _I, _P, _P],
    "csr_bitmap_hop_csr": [_P, _N, _P, _P, _P, _N, _P, _P, _N, _N, _P, _I, _P, _N, _I, _P],
    "csr_bitmap_hop_probe": [
        _P, _N, _P, _P, _P, _N, _P, _P, _P, _P, _N, _N, _I, _I, _P, _P, _N, _N, _P, _I, _P, _P
    ],
    "csr_bitmap_emit": [_P, _P, _P, _N, _N, _P, _P, _P, _N, _I, _P],
    "csr_frontier_advance": [_P, _P, _P, _P, _P, _N, _N, _P, _P, _N, _I, _I, _P],
    "csr_rows_with_matches_lanes": [_P, _P, _N, _N, _N, _I, _P, _P],
    "csr_group_page": [_P, _N, _I, _N, _N, _I, _P, _P],
    "csr_predicate_eval_stacked": [_P, _N, _P],
    "csr_predicate_eval_lanes": [_P, _N, _N, _N, _P],
    "csr_scatter_set": [_P, _N, _P, _P, _N, _I, _P],
    "csr_slab_scan_scratch": [_N, _N],
    "csr_slab_scan_passes": [],
    "csr_slab_scan_hist": [_P, _P, _N, _N, _P, _P],
    "csr_slab_scan_pass": [_P, _P, _N, _N, _P, _P, _I, _P],
    "csr_slab_scan_runs": [_P, _N, _P, _N, _P, _P],
    "csr_slab_scan_rows": [_N, _N, _P, _P, _P, _P],
    "csr_slab_scan_gather": [_P, _N, _P, _I, _P, _P, _N, _P, _N, _P, _P, _P, _P, _P],
    "csr_slab_probe": [_P, _P, _P, _N, _P, _N, _I, _I, _I, _P, _P, _P],
    "csr_slab_decode": [_P, _N, _P, _I, _I, _P, _N, _P, _P, _P, _P],
    "csr_paged_hop_csr": [
        _P, _N, _P, _P, _N, _P, _P, _P, _N, _N, _P, _N, _P, _P, _N, _N, _P, _I, _P, _P, _P
    ],
    "csr_paged_hop_miss": [_P, _P, _N, _N, _P, _N, _P, _N, _P, _P, _P, _P],
    "csr_paged_expand": [
        _P, _N, _P, _P, _N, _P, _N, _P, _P, _N, _P, _P, _P, _N, _N, _I, _P, _P, _P, _P, _I, _P
    ],
    "csr_degree_counts_range": [_P, _N, _P, _P, _N, _N, _P, _P, _P],
    "csr_shard_gather": [
        _P, _N, _P, _N, _P, _N, _P, _P, _N, _P, _P, _N, _N, _N, _N, _N, _I, _I, _P, _P, _P, _P
    ],
    "csr_bitmap_hop_shard": [
        _P, _N, _N, _N, _P, _N, _P, _I, _P, _N, _P, _P, _N, _N, _P, _I, _P, _P
    ],
    "csr_shard_weight_scratch": [_N, _N, _N, _N],
    "csr_shard_weight_pass_i32": [
        _P, _N, _N, _N, _P, _N, _P, _I, _P, _N, _P, _N, _P, _N, _I, _I, _N, _P, _P, _P
    ],
    "csr_shard_weight_pass_f32": [
        _P, _N, _N, _N, _P, _N, _P, _I, _P, _N, _P, _N, _P, _N, _I, _I, _N, _P, _P, _P
    ],
    "csr_rowshard_hop": [_P, _N, _P, _N, _P, _N, _N, _N, _I, _P, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernel source (if this version is not built yet) and
    return the library's path."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libcsr_kernels_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path


def load():
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _N if name.endswith("_scratch") else _I
            _lib = lib
    return _lib
