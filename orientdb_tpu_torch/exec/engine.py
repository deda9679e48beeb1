"""Port of `orientdb_tpu/exec/engine.py`: the front door. Every query of the
port runs through `execute_query`: parse, then `tpu_engine.execute`, which
records the statement on its first call and replays its cached plan on
every later one, and a `ResultSet` of the rows.

Unlike the reference's front door there is no interpreter to fall back
to: a statement outside the compiled subset raises `Uncompilable` with the
reason.
"""

from __future__ import annotations

from typing import Dict, Optional

from orientdb_tpu_torch.exec import tpu_engine
from orientdb_tpu_torch.exec.result import ResultSet
from orientdb_tpu_torch.ops.predicates import Uncompilable
from orientdb_tpu_torch.sql import ast as A
from orientdb_tpu_torch.sql.parser import parse


def _normalize_params(params) -> Dict:
    if params is None:
        return {}
    if isinstance(params, dict):
        return params
    # positional list → {0: v0, 1: v1, …}
    return {i: v for i, v in enumerate(params)}


def execute_query(db, sql: str, params: Optional[Dict] = None) -> ResultSet:
    stmt = parse(sql)
    if not isinstance(stmt, A.MatchStatement):
        raise Uncompilable(f"{type(stmt).__name__} is not compiled in this slice")
    return ResultSet(tpu_engine.execute(db, stmt, _normalize_params(params)))
