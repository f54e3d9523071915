"""spark-csv-compatible schema inference.

The reference reads its CSV with ``inferschema='true'`` through
``com.databricks.spark.csv`` (reference Main/main.py:18-20).  That package
types each column by attempting, over *all* rows, the narrowest type in the
chain int → long → double → string.  Fidelity here matters: the WISDM
``XPEAK/YPEAK/ZPEAK`` columns contain ``?`` sentinel values, so they infer as
*strings* and flow into the one-hot path, producing the 3,100-dim feature
space (SURVEY §2 F/G).  Were they parsed as doubles, the feature space would
collapse to 13 dims and none of the reference numbers would reproduce.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np


class ColumnType(enum.Enum):
    INT = "int"
    DOUBLE = "double"
    STRING = "string"

    @property
    def spark_name(self) -> str:
        """Type name as Spark's printSchema spells it (result.txt:4-17)."""
        return "integer" if self is ColumnType.INT else self.value


def _is_int(value: str) -> bool:
    try:
        int(value)
        return True
    except ValueError:
        return False


def _is_double(value: str) -> bool:
    try:
        float(value)
        return True
    except ValueError:
        return False


def infer_column_type(values: Sequence[str]) -> ColumnType:
    """Narrowest of int → double → string that parses every value."""
    current = ColumnType.INT
    for v in values:
        if current is ColumnType.INT:
            if _is_int(v):
                continue
            current = ColumnType.DOUBLE
        if current is ColumnType.DOUBLE:
            if _is_double(v):
                continue
            return ColumnType.STRING
    return current


@dataclasses.dataclass(frozen=True)
class Schema:
    names: tuple[str, ...]
    types: tuple[ColumnType, ...]

    def __post_init__(self):
        if len(self.names) != len(self.types):
            raise ValueError("names and types length mismatch")

    def type_of(self, name: str) -> ColumnType:
        return self.types[self.names.index(name)]

    def numpy_dtype(self, name: str):
        t = self.type_of(name)
        if t is ColumnType.INT:
            return np.int64
        if t is ColumnType.DOUBLE:
            return np.float64
        return object


def infer_schema(names: Sequence[str], columns: Sequence[Sequence[str]]) -> Schema:
    return Schema(
        names=tuple(names),
        types=tuple(infer_column_type(col) for col in columns),
    )
