"""Port of `orientdb_tpu/exec/engine.py`: the front door. A query of the
port (MATCH, SELECT or TRAVERSE) runs through `execute_query`: parse, then
`tpu_engine.execute`, which records the statement on its first call and
replays its cached plan on every later one, and a `ResultSet` of the rows.
A batch runs through `execute_query_batch` and `tpu_engine.execute_batch`,
which dispatches its cached plans back to back (same-plan runs as one group
replay) and fetches their results in one overlapped wave.

Unlike the reference's front door there is no interpreter to fall back
to: a statement outside the compiled subset raises `Uncompilable` with the
reason.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from orientdb_tpu_torch.exec import tpu_engine
from orientdb_tpu_torch.exec.result import ResultSet
from orientdb_tpu_torch.sql.parser import parse


def _normalize_params(params) -> Dict:
    if params is None:
        return {}
    if isinstance(params, dict):
        return params
    # positional list → {0: v0, 1: v1, …}
    return {i: v for i, v in enumerate(params)}


def execute_query(db, sql: str, params: Optional[Dict] = None) -> ResultSet:
    return ResultSet(tpu_engine.execute(db, parse(sql), _normalize_params(params)))


def execute_query_batch(db, sqls: List[str], params_list=None) -> List[ResultSet]:
    """Run a batch of statements in ~one device round trip; one `ResultSet`
    per statement, in order. An item outside the compiled subset raises its
    `Uncompilable` (the reference's ``strict=True``)."""
    n = len(sqls)
    if params_list is None:
        params_list = [None] * n
    if len(params_list) != n:
        raise ValueError("params_list length must match sqls length")
    items = [(parse(sql), _normalize_params(p)) for sql, p in zip(sqls, params_list)]
    return [ResultSet(rows) for rows in tpu_engine.execute_batch(db, items)]
