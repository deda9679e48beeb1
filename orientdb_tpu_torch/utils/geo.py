"""Port of `orientdb_tpu/utils/geo.py`: the geodesic constants of
``distance()`` (OrientDB's ``OSQLFunctionDistance``).

The predicate compiler (`ops/predicates.py`) and the CUDA kernel's
``DIST`` instruction read these; the reference's engines use the same
values, so the port's masks agree with theirs on the same columns.
"""

from __future__ import annotations

#: mean earth radius, km
EARTH_RADIUS_KM = 6371.0

#: km → miles scale for the optional unit argument
MILES_PER_KM = 0.621371192

#: accepted spellings of the miles unit argument
MILE_UNITS = frozenset(("mi", "mile", "miles"))
