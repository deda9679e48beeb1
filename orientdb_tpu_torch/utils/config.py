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
    # Buffer headroom multiplier: buffers are sized bucket(observed * this)
    # (tpu_engine._cap_of), as in the reference.
    schedule_headroom: float = 2.0


config = Config()
