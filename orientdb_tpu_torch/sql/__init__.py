from orientdb_tpu_torch.sql.parser import parse, ParseError

__all__ = ["parse", "ParseError"]
