"""A minimal columnar table.

This replaces the reference's Spark DataFrame layer (reference
Main/main.py:16-47) for *host-side* work only: column selection, group
counts, summary stats, row filtering.  Anything per-row and numeric moves
to the device as a dense tensor; the table itself stays on the host.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

from har_tpu_torch.data.schema import ColumnType, Schema


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
    def num_rows(self) -> int:
        return len(self)

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

    def take(self, indices: np.ndarray) -> "Table":
        return Table(
            {n: v[indices] for n, v in self._columns.items()}, self.schema
        )

    def head(self, n: int = 5) -> "Table":
        return self.take(np.arange(min(n, len(self))))

    def group_count(self, name: str, descending: bool = True) -> list[tuple[str, int]]:
        """groupBy(name).count().orderBy(count) (reference Main/main.py:35-38)."""
        values, counts = np.unique(self._columns[name], return_counts=True)
        order = np.argsort(-counts if descending else counts, kind="stable")
        return [(str(values[i]), int(counts[i])) for i in order]

    def describe(self, names: Sequence[str] | None = None) -> dict[str, dict[str, float]]:
        """count/mean/stddev/min/max per numeric column, MLlib-style
        (sample stddev, ddof=1 — matches DataFrame.describe)."""
        if names is None:
            names = [
                n
                for n, t in zip(self.schema.names, self.schema.types)
                if t is not ColumnType.STRING
            ]
        out: dict[str, dict[str, float]] = {}
        for n in names:
            col = self._columns[n].astype(np.float64)
            out[n] = {
                "count": float(len(col)),
                "mean": float(col.mean()) if len(col) else float("nan"),
                "stddev": float(col.std(ddof=1)) if len(col) > 1 else float("nan"),
                "min": float(col.min()) if len(col) else float("nan"),
                "max": float(col.max()) if len(col) else float("nan"),
            }
        return out

    def numeric_matrix(self, names: Sequence[str], dtype=np.float32) -> np.ndarray:
        """Stack numeric columns into an (n_rows, len(names)) dense matrix."""
        return np.stack(
            [self._columns[n].astype(dtype) for n in names], axis=1
        )

    def with_column(self, name: str, values: np.ndarray, ctype: ColumnType) -> "Table":
        cols = dict(self._columns)
        cols[name] = values
        if name in self.schema.names:
            types = tuple(
                ctype if n == name else t
                for n, t in zip(self.schema.names, self.schema.types)
            )
            schema = Schema(self.schema.names, types)
        else:
            schema = Schema(
                self.schema.names + (name,), self.schema.types + (ctype,)
            )
        return Table(cols, schema)
