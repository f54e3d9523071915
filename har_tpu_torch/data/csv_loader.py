"""CSV ingestion with spark-csv semantics.

Replaces the reference's ``com.databricks.spark.csv`` read (reference
Main/main.py:18-20): header row, full-pass schema inference, typed columns.

The file is parsed in Python: the only CSV the system reads is the
5,418-row WISDM table, where a native parser's first-use build would cost
more than it saves.
"""

from __future__ import annotations

import csv as _csv
from typing import Sequence

import numpy as np

from har_tpu_torch.data.schema import ColumnType, Schema, infer_schema
from har_tpu_torch.data.table import Table


def _columns_to_table(names: Sequence[str], columns: list[list[str]]) -> Table:
    schema = infer_schema(names, columns)
    out = {}
    for name, col in zip(names, columns):
        t = schema.type_of(name)
        if t is ColumnType.INT:
            out[name] = np.array([int(v) for v in col], dtype=np.int64)
        elif t is ColumnType.DOUBLE:
            out[name] = np.array([float(v) for v in col], dtype=np.float64)
        else:
            out[name] = np.array(col, dtype=object)
    return Table(out, schema)


def read_csv(path: str, header: bool = True, infer: bool = True) -> Table:
    """Read a CSV file into a columnar Table.

    `header=True, infer=True` matches the reference's read options
    (Main/main.py:18-20).  Without inference every column is a string.
    """
    with open(path, newline="") as f:
        reader = _csv.reader(f)
        rows = list(reader)
    if not rows:
        raise ValueError(f"empty CSV: {path}")
    if header:
        names, data = rows[0], rows[1:]
    else:
        names = [f"_c{i}" for i in range(len(rows[0]))]
        data = rows
    columns = [[row[i] for row in data] for i in range(len(names))]
    if not infer:
        schema = Schema(tuple(names), tuple(ColumnType.STRING for _ in names))
        return Table(
            {n: np.array(c, dtype=object) for n, c in zip(names, columns)},
            schema,
        )
    return _columns_to_table(names, columns)
