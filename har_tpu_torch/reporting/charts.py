"""Metric chart artifacts — the Graph.xlsx/Graph.pdf equivalent.

The reference ships hand-made Excel charts over its two metrics CSVs
(Main/wisdm_main_ver_0.0/main_result/{Graph.xlsx, Graph.pdf, Results.xls}
— SURVEY §0 file census: sheet "Graph" holds 8 charts over the CSV
columns).  This module renders the same eight views as PNGs directly
from the CSVs the run just wrote, so every run ships its charts instead
of a one-off spreadsheet:

  1-4  per-classifier Accuracy, F1 Score, Training Time, Testing Time
       (additional_param.csv)
  5-8  the cross-validation variants (crossFold_additional_param.csv)

Chart files are named ``Graph <metric>.png`` / ``Graph CV <metric>.png``.
"""

from __future__ import annotations

import csv
import os
import re

#: (column in the plain CSV, column in the CV CSV, filename stem)
_CHARTS = (
    ("Accuracy", "Cross Fold Accuracy", "Accuracy"),
    ("F1 Score", "F1 Score", "F1 Score"),
    ("Training Time", "Cross Validation Training Time", "Training Time"),
    ("Testing Time", "Cross Validation Testing Time", "Testing Time"),
)


def _short_name(classifier: str) -> str:
    """Compact estimator label from the CSV's Classifier repr."""
    m = re.match(r"([A-Za-z]+?)(?:Classification)?(?:Model)?_", classifier)
    if m:
        return m.group(1)
    return classifier.split(" ")[0][:24] or classifier[:24]


def _read_rows(csv_path: str) -> list[dict]:
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    # the reference appends runs (append-mode quirk); chart the LAST run
    # by dropping repeated header rows and keeping the trailing block
    return [r for r in rows if r.get("Classifier") != "Classifier"]


def save_metric_charts(
    csv_path: str | None,
    cv_csv_path: str | None,
    out_dir: str,
) -> list[str]:
    """Render the 8 chart PNGs; returns the files written (those whose
    source CSV exists).  Returns [] when matplotlib (the `plots` extra)
    is not installed — chart artifacts are optional, runs must not die
    after training because a plotting dependency is absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return []

    os.makedirs(out_dir, exist_ok=True)
    written: list[str] = []
    for path, prefix in ((csv_path, ""), (cv_csv_path, "CV ")):
        if path is None or not os.path.exists(path):
            continue
        rows = _read_rows(path)
        if not rows:
            continue
        names = [_short_name(r["Classifier"]) for r in rows]
        for plain_col, cv_col, stem in _CHARTS:
            col = cv_col if prefix else plain_col
            try:
                values = [float(r[col]) for r in rows]
            except (KeyError, ValueError):
                continue
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.bar(names, values, color="#4C72B0")
            ax.set_title(f"{prefix}{stem} by Classifier")
            ax.set_ylabel(
                f"{stem} (s)" if "Time" in stem else stem
            )
            ax.tick_params(axis="x", labelrotation=20)
            for i, v in enumerate(values):
                ax.annotate(
                    f"{v:.4g}",
                    (i, v),
                    ha="center",
                    va="bottom",
                    fontsize=8,
                )
            fig.tight_layout()
            out = os.path.join(out_dir, f"Graph {prefix}{stem}.png")
            fig.savefig(out, dpi=110)
            plt.close(fig)
            written.append(out)
    return written
