"""Spark-`show()`-style ASCII tables.

The reference's report is a stdout capture where every DataFrame `.show()`
prints the +---+---+ bordered table (reference result.txt throughout);
this renderer reproduces that format so our result.txt diffs cleanly
against the reference's.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np


def _java_double_str(v: float) -> str:
    """Java Double.toString: plain decimal for |v| in [1e-3, 1e7),
    scientific outside ('5.0E-4', '1.2345678E7'), a trailing .0 on whole
    doubles.  Python's repr shares the shortest-round-trip mantissa but
    switches notation at different thresholds and writes exponents
    differently, so parity tables need the Java rules."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "Infinity"
    if v == float("-inf"):
        return "-Infinity"
    a = abs(v)
    if a == 0.0:
        return "-0.0" if str(v).startswith("-") else "0.0"
    if 1e-3 <= a < 1e7:
        s = repr(v)  # never scientific in this range
        return s if "." in s else s + ".0"
    # shortest scientific mantissa that round-trips, Java exponent style
    for p in range(1, 18):
        cand = f"{v:.{p}e}"
        if float(cand) == v:
            m, e = cand.split("e")
            m = m.rstrip("0")
            if m.endswith("."):
                m += "0"
            return f"{m}E{int(e)}"
    return repr(v)  # pragma: no cover - p=17 always round-trips


def _fmt(v) -> str:
    if isinstance(v, (float, np.floating)):
        return _java_double_str(float(v))
    return str(v)


def show(
    columns: Sequence[str],
    rows: Iterable[Sequence],
    max_rows: int | None = 20,
    truncate: int = 20,
) -> str:
    """Render rows Spark-style; returns the table as a string."""
    rows = [list(r) for r in rows]
    shown = rows if max_rows is None else rows[:max_rows]
    cells = [
        [
            (s if len(s) <= truncate else s[: truncate - 3] + "...")
            for s in map(_fmt, row)
        ]
        for row in shown
    ]
    widths = [
        max(len(str(c)), *(len(r[i]) for r in cells)) if cells else len(str(c))
        for i, c in enumerate(columns)
    ]
    sep = "+" + "+".join("-" * w for w in widths) + "+"
    out = [sep]
    out.append(
        "|" + "|".join(str(c).rjust(w) for c, w in zip(columns, widths)) + "|"
    )
    out.append(sep)
    for r in cells:
        out.append("|" + "|".join(v.rjust(w) for v, w in zip(r, widths)) + "|")
    out.append(sep)
    if max_rows is not None and len(rows) > max_rows:
        out.append(f"only showing top {max_rows} rows")
    return "\n".join(out) + "\n"
