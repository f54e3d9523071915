"""A minimal columnar table.

This replaces the reference's Spark DataFrame layer (reference
Main/main.py:16-47) for *host-side* work only: column access and
selection.  Anything per-row and numeric moves to the device as a dense
tensor; the table itself stays on the host.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

from har_tpu_torch.data.schema import Schema


class Table:
    """Immutable dict-of-numpy-columns with a schema."""

    def __init__(self, columns: Mapping[str, np.ndarray], schema: Schema):
        if set(columns) != set(schema.names):
            raise ValueError("columns do not match schema names")
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        self._columns = dict(columns)
        self.schema = schema

    # -- basic accessors ----------------------------------------------------
    def __len__(self) -> int:
        return len(next(iter(self._columns.values()))) if self._columns else 0

    @property
    def column_names(self) -> tuple[str, ...]:
        return self.schema.names

    def column(self, name: str) -> np.ndarray:
        return self._columns[name]

    def __getitem__(self, name: str) -> np.ndarray:
        return self._columns[name]

    # -- relational ops (host side) ----------------------------------------
    def select(self, names: Sequence[str]) -> "Table":
        schema = Schema(
            names=tuple(names),
            types=tuple(self.schema.type_of(n) for n in names),
        )
        return Table({n: self._columns[n] for n in names}, schema)

    def drop(self, names: Iterable[str]) -> "Table":
        dropped = set(names)
        keep = [n for n in self.schema.names if n not in dropped]
        return self.select(keep)
