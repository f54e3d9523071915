"""result.txt-style run report + metrics CSV writers.

Reproduces the reference's three artifacts (SURVEY §5.5):
  - ``result.txt``: the full run log — schema, sample rows, class counts,
    summary stats, per-model evaluation blocks (reference redirects
    sys.stdout to this file, Main/main.py:11-12; we write it explicitly).
  - ``additional_param.csv``: per-classifier summary row with the exact
    reference header (Main/main.py:657).
  - ``crossFold_additional_param.csv``: CV variant (Main/main.py:671).

The reference opens its CSVs in append mode and rewrites the header every
run (a quirk that accumulates junk); we truncate and write.
"""

from __future__ import annotations

import csv
import dataclasses
import io
import os
from typing import Any, Mapping, Sequence

import numpy as np

from har_tpu_torch.data.table import Table
from har_tpu_torch.reporting.ascii_table import show

CSV_HEADER = [
    "Classifier",
    "Count Total",
    "Correct",
    "Wrong",
    "Ratio Wrong",
    "Ratio Correct",
    "F1 Score",
    "Training Time",
    "Testing Time",
    "Accuracy",
]

CV_CSV_HEADER = [
    "Classifier",
    "Count Total",
    "Correct",
    "Wrong",
    "Ratio Wrong",
    "Ratio Correct",
    "F1 Score",
    "Cross Validation Training Time",
    "Cross Validation Testing Time",
    "Cross Fold Accuracy",
]


@dataclasses.dataclass
class ModelResult:
    """Everything one CLASSIFICATION AND EVALUATION block needs."""

    name: str
    metrics: Mapping[str, Any]  # output of har_tpu_torch.ops.metrics.evaluate
    train_time_s: float
    test_time_s: float
    is_cv: bool = False
    # Spark-style model line for the report block (result.txt:141,186,231,
    # 276), e.g. "LogisticRegression_<uid>"; falls back to `name`
    display_name: str | None = None

    @property
    def counts(self) -> tuple[int, int, int]:
        cm = np.asarray(self.metrics["confusion_matrix"])
        total = int(cm.sum())
        correct = int(np.trace(cm))
        return total, correct, total - correct


def _welford(values: np.ndarray) -> tuple[float, float]:
    """Catalyst-order mean/sample-variance, row order preserved.

    Spark's describe() evaluates SQL ``avg`` (a plain sequential running
    sum over the rows, divided at the end) and ``stddev_samp`` (Welford's
    central-moment update per row); numpy's pairwise summation differs in
    the last ulps.  The golden result.txt diff is byte-exact only with
    the same accumulation order."""
    total = 0.0
    avg = 0.0
    m2 = 0.0
    n = 0
    for v in values:
        v = float(v)
        n += 1
        total += v
        delta = v - avg
        delta_n = delta / n
        avg += delta_n
        # Catalyst's exact expression (delta * (delta - deltaN)) — the
        # algebraic twin delta*(v - newAvg) rounds differently in the
        # last ulp and breaks the byte-exact diff
        m2 += delta * (delta - delta_n)
    return total / max(n, 1), (m2 / (n - 1) if n > 1 else float("nan"))


def _guava_partition(values: list, left: int, right: int,
                     pivot_index: int, cmp) -> int:
    pivot_value = values[pivot_index]
    values[pivot_index] = values[right]
    values[right] = pivot_value
    store = left
    for i in range(left, right):
        if cmp(values[i], pivot_value) < 0:
            values[store], values[i] = values[i], values[store]
            store += 1
    values[store], values[right] = values[right], values[store]
    return store


def _guava_least_of(items, k: int, cmp) -> list:
    """guava ``Ordering.leastOf(iterator, k)`` — the top-k kernel behind
    Spark's TakeOrderedAndProject (``show`` after ``orderBy``).

    Clean-room port of the published algorithm: a 2k buffer, a threshold
    that skips elements sorting at-or-after it, quickselect trims when the
    buffer fills (which permute tied elements — semantics the report's
    sample tables depend on), and a final stable sort of the buffer.
    """
    import functools

    it = iter(items)
    try:
        first = next(it)
    except StopIteration:
        return []
    if k == 0:
        return []
    buffer_cap = k * 2
    buf = [first]
    threshold = first
    while len(buf) < k:
        try:
            e = next(it)
        except StopIteration:
            break
        buf.append(e)
        if cmp(e, threshold) > 0:  # threshold = max(threshold, e)
            threshold = e
    for e in it:
        if cmp(e, threshold) >= 0:
            continue
        buf.append(e)
        if len(buf) == buffer_cap:
            left, right = 0, buffer_cap - 1
            min_threshold_position = 0
            while left < right:
                pivot_index = (left + right + 1) >> 1
                pivot_new_index = _guava_partition(
                    buf, left, right, pivot_index, cmp
                )
                if pivot_new_index > k:
                    right = pivot_new_index - 1
                elif pivot_new_index < k:
                    left = max(pivot_new_index, left + 1)
                    min_threshold_position = pivot_new_index
                else:
                    break
            del buf[k:]
            threshold = buf[min_threshold_position]
            for i in range(min_threshold_position + 1, k):
                if cmp(buf[i], threshold) > 0:
                    threshold = buf[i]
    buf.sort(key=functools.cmp_to_key(cmp))  # stable, like Arrays.sort
    return buf[:k]


class ReportWriter:
    """Accumulates the run log in memory; `save()` writes the artifacts."""

    def __init__(
        self,
        output_dir: str,
        class_names: Sequence[str] | None = None,
        reference_quirks: bool = False,
    ):
        self.output_dir = output_dir
        self.class_names = list(class_names) if class_names else None
        # True → replicate the reference's output bugs byte-for-byte
        # (the MSE label prints the rmse variable, Main/main.py:171) and
        # omit the per-class extras, for the golden parity artifact
        self.reference_quirks = reference_quirks
        self._buf = io.StringIO()
        self.results: list[ModelResult] = []

    # Dash/equals counts of the reference's print literals, preserved
    # byte-for-byte (they are inconsistent in Main/main.py and the golden
    # diff pins them): header -> dash count, banner -> (left, right).
    _HEADER_DASHES = {
        "Data Schema": 60,
        "Sample Data": 60,
        "Activity Count": 58,
        "Summary": 63,
        "Model Pipeline Schema": 60,
        "Sample Feature Data": 60,
    }
    _BANNER_PADS = {
        "MODELING PIPELINE": (27, 30),
        "TRAINING AND TESTING": (27, 30),
        "CLASSIFICATION AND EVALUATION": (28, 28),
    }

    # --- low-level -------------------------------------------------------
    def line(self, text: str = "") -> None:
        self._buf.write(text + "\n")

    def header(self, title: str, width: int = 74, fill: str = "-") -> None:
        dashes = self._HEADER_DASHES.get(title)
        if dashes is None:
            dashes = max(0, width - len(title))
        self.line(title + fill * dashes)

    def banner(self, title: str, pad: str = "=") -> None:
        left, right = self._BANNER_PADS.get(title, (27, 30))
        self.line(f"{pad * left}{title}{pad * right}")

    # --- sections matching the reference layout --------------------------
    def schema(self, table: Table) -> None:
        """Spark printSchema() block (reference result.txt:2-18)."""
        self.header("Data Schema")
        self.line("root")
        for name, ctype in zip(table.schema.names, table.schema.types):
            self.line(f" |-- {name}: {ctype.spark_name} (nullable = true)")
        self.line()

    def sample(self, table: Table, n: int = 5) -> None:
        self.header("Sample Data")
        cols = table.column_names
        rows = list(zip(*(table[c][:n] for c in cols)))
        self.line(show(cols, rows, max_rows=n) + f"only showing top {n} rows")
        self.line()

    def class_counts(self, labels: Sequence[str]) -> None:
        self.header("Activity Count", fill="-")
        vals, counts = np.unique(np.asarray(labels), return_counts=True)
        order = np.argsort(-counts)
        rows = [(vals[i], int(counts[i])) for i in order]
        self.line(show(["activity", "count"], rows, max_rows=None))

    def summary(self, table: Table) -> None:
        """describe().toPandas().transpose() block (result.txt:44-57).

        The reference prints the transposed pandas frame of Spark's
        describe() (Main/main.py:43): a 0..4 column-label row, a
        'summary' row naming the statistics, then one row per numeric
        column with count/mean/stddev as full-precision doubles and
        min/max rendered in the column's own dtype."""
        import pandas as pd

        self.header("Summary", fill="-")
        data: dict[str, list[str]] = {
            "summary": ["count", "mean", "stddev", "min", "max"]
        }
        for name in table.column_names:
            col = np.asarray(table[name])
            if not np.issubdtype(col.dtype, np.number):
                continue
            is_int = np.issubdtype(col.dtype, np.integer)
            fmt = (
                (lambda v: str(int(v)))
                if is_int
                else (lambda v: repr(float(v)))
            )
            mean, var = _welford(col.astype(np.float64))
            data[name] = [
                str(len(col)),
                repr(float(mean)),
                repr(float(np.sqrt(var))),
                fmt(col.min()),
                fmt(col.max()),
            ]
        with pd.option_context(
            "display.width", 80,
            "display.max_columns", None,
            "display.max_rows", None,
            "display.expand_frame_repr", True,
        ):
            self.line(str(pd.DataFrame(data).transpose()))
        self.line()

    def pipeline_schema(self, table: Table) -> None:
        """MODELING PIPELINE printSchema block (result.txt:59-79): the
        transformed dataframe's columns — label + features vector +
        every original column the reference reselects (Main/main.py:74)."""
        self.banner("MODELING PIPELINE")
        self.line()
        self.header("Model Pipeline Schema")
        self.line("root")
        self.line(" |-- label: double (nullable = false)")
        self.line(" |-- features: vector (nullable = true)")
        for name, ctype in zip(table.schema.names, table.schema.types):
            self.line(f" |-- {name}: {ctype.spark_name} (nullable = true)")
        self.line()

    def sample_feature_data(
        self, table: Table, labels, features, n: int = 5
    ) -> None:
        """pandas-repr sample of the transformed frame (result.txt:81-101):
        the reference prints pd.DataFrame(df.take(5)) — label, the dense
        feature tuple (pandas-truncated), then the original columns."""
        import pandas as pd

        self.header("Sample Feature Data")
        data: dict[str, Any] = {
            "label": [float(v) for v in labels[:n]],
            "features": [
                "(" + ", ".join(repr(float(v)) for v in row) + ")"
                for row in np.asarray(features[:n])
            ],
        }
        for name in table.column_names:
            data[name] = list(table[name][:n])
        with pd.option_context(
            "display.width", 80,
            "display.max_colwidth", 50,
            "display.max_columns", None,  # wrap, don't elide columns
            "display.expand_frame_repr", True,
        ):
            self.line(str(pd.DataFrame(data)))
        self.line()

    @staticmethod
    def _sparse_vector_str(row: np.ndarray) -> str:
        """Spark SparseVector str: '(3100,[i...],[v...])' (result.txt:110)."""
        nz = np.nonzero(row)[0]
        idx = ",".join(str(int(i)) for i in nz)
        vals = ",".join(repr(float(row[i])) for i in nz)
        return f"({len(row)},[{idx}],[{vals}])"

    # columns the reference hides from the train/test sample tables
    # (minimized_view, Main/main.py:88) and the ones it drops from
    # test_data (skipped, Main/main.py:94-98)
    _MINIMIZED_VIEW = (
        "XPEAK", "YPEAK", "ZPEAK", "XABSDEV", "YABSDEV", "ZABSDEV",
    )

    def split_sample_tables(
        self, table: Table, features, labels, train_rows, test_rows, n=5
    ) -> None:
        """train/test/test_data show(5) tables (result.txt:107-138).

        ``train_rows``/``test_rows`` are original-table row indices in
        sampled-stream order, so with the spark-exact split the shown
        rows equal the reference's byte-for-byte."""
        shown_cols = [
            c for c in table.column_names if c not in self._MINIMIZED_VIEW
        ]

        def rows_for(indices, cols):
            out = []
            for i in indices[:n]:
                row = [
                    f"{float(labels[i]):.1f}",
                    self._sparse_vector_str(np.asarray(features[i])),
                ]
                for c in cols:
                    row.append(table[c][i])
                out.append(row)
            return out

        for indices, cols in (
            (train_rows, shown_cols),
            (test_rows, shown_cols),
            (test_rows, ["UID"]),  # test_data keeps label+features+UID
        ):
            self.line(
                show(
                    ["label", "features"] + list(cols),
                    rows_for(indices, cols),
                    max_rows=None,
                    truncate=20,
                )
                + (f"only showing top {n} rows" if len(indices) > n else "")
            )
            self.line()

    def split_counts(self, n_train: int, n_test: int) -> None:
        self.banner("TRAINING AND TESTING")
        self.line()
        self.line(f"Training Dataset Count : {n_train}")
        self.line(f"Test Dataset Count     : {n_test}")

    def prediction_sample(
        self, test, preds, class_id: int | None = None, n: int = 5
    ) -> str:
        """The reference's top-n predicted-class sample (Main/main.py:127-130):
        rows predicted as ``class_id`` (default: the last class, as the LR
        block filters prediction==5), ordered by descending probability,
        rendered as the Spark ``show()`` table in result.txt:144-153.
        Returns the table text for model_block to place after the timings.
        """
        probs = np.asarray(preds.probability, np.float64)
        pred = np.asarray(preds.prediction)
        k = int(probs.shape[1] - 1 if class_id is None else class_id)
        idx = np.nonzero(pred == k)[0]
        if idx.size == 0:  # class never predicted: fall back to all rows
            idx = np.arange(len(pred))
        truncated = idx.size > n
        # Spark's `.orderBy("probability", ascending=False).show(n)` is
        # planned as TakeOrderedAndProject over take(n+1): guava
        # Ordering.leastOf with a 2k buffer whose quickselect trims
        # permute TIED rows (equal probability vectors) away from stream
        # order — result.txt's DT sample order is that permutation, so
        # the faithful top-k replay is load-bearing (for distinct keys it
        # reduces to the lexicographic sort).  Vectors compare as their
        # struct, i.e. values arrays lexicographically, descending.
        def cmp(a: int, b: int) -> int:
            pa, pb = probs[a], probs[b]
            for x, y in zip(pa, pb):
                if x != y:
                    return -1 if x > y else 1
            return 0

        order = _guava_least_of(list(idx), n + 1, cmp)[:n]
        uid = getattr(test, "uid", None)
        rows = []
        for i in order:
            vec = "[" + ",".join(repr(float(v)) for v in probs[i]) + "]"
            rows.append(
                [
                    int(uid[i]) if uid is not None else int(i),
                    vec,
                    f"{float(test.label[i]):.1f}",
                    f"{float(pred[i]):.1f}",
                ]
            )
        table = show(
            ["UID", "probability", "label", "prediction"],
            rows,
            max_rows=None,
            truncate=30,
        )
        # Spark's show() prints the footer only when rows were cut off
        if truncated:
            table += f"only showing top {n} rows\n"
        return table

    def model_block(
        self, result: ModelResult, sample_text: str | None = None
    ) -> None:
        """One CLASSIFICATION AND EVALUATION block (result.txt LR block)."""
        if not self.results:
            if not self._buf.getvalue().endswith("\n\n"):
                self.line()  # result.txt:139 — blank before the banner
            self.banner("CLASSIFICATION AND EVALUATION")
        self.results.append(result)
        m = result.metrics
        self.line(result.display_name or result.name)
        self.line(f"Classifier trained in {result.train_time_s:.3f} seconds")
        self.line(f"Prediction made in {result.test_time_s:.3f} seconds")
        if sample_text is not None:
            self._buf.write(sample_text)
        self.line()
        self.line()  # result.txt:154-155 — two blanks after the sample
        self.line("-----------Binary Classification Evaluator-------------")
        self.line()
        # the reference evaluates the Binary evaluator's default metric
        # (areaUnderROC) under this label (result.txt:158,160 are equal)
        self.line(
            f"Binary Classifier Raw Prediction ------------: {m['areaUnderROC']:.6g}"
        )
        self.line(
            f"Binary Clasifier Area Under PR --------------: {m['areaUnderPR']:.6g}"
        )
        self.line(
            f"Binary Clasifier Area Under ROC -------------: {m['areaUnderROC']:.6g}"
        )
        self.line()
        self.line("-----------MultiClass Classification Evaluaton---------")
        self.line()
        self.line(f"MultiClass F1 -------------------------------: {m['f1']:.6g}")
        self.line(
            f"MultiClass Weighted Precision ---------------: {m['weightedPrecision']:.6g}"
        )
        self.line(
            f"MultiClass Weighted Recall ------------------: {m['weightedRecall']:.6g}"
        )
        self.line(
            f"MultiClass Accuracy -------------------------: {m['accuracy']:.6g}"
        )
        self.line()
        self.line("----------------Regression Evaluator-------------------")
        self.line()
        self.line(
            f"Root Mean Squared Error (RMSE) on test data -: {m['rmse']:.6g}"
        )
        # the reference prints the rmse variable under the MSE label
        # (Main/main.py:171 bug); we print the real mse unless the
        # caller asked for the byte-parity artifact
        mse_shown = m["rmse"] if self.reference_quirks else m["mse"]
        self.line(f"Mean Squared Error on test data -------------: {mse_shown:.6g}")
        self.line(f"R^2 metric on test data ---------------------: {m['r2']:.6g}")
        self.line(f"Mean Absolute Error on test data ------------: {m['mae']:.6g}")
        self.line()
        self.line("------------------Additional Factors--------------------")
        self.line()
        total, correct, wrong = result.counts
        self.line(f"Total Count          = {total}")
        self.line(f"Total Correct        = {correct}")
        self.line(f"Total Wrong          = {wrong}")
        self.line(f"Wrong Ratio          = {wrong / max(total, 1):.6g}")
        self.line(f"Right Ratio          = {correct / max(total, 1):.6g}")
        self.line()
        # the reference block ends here (result.txt:184); the per-class
        # extras are a framework addition placed after the terminator so
        # the block shape still diffs cleanly against the reference's
        self.line("*" * 57)
        self.line()
        if not self.reference_quirks:
            self._per_class_block(m)

    def _per_class_block(self, m: Mapping[str, Any]) -> None:
        """Per-class precision/recall/F1 + the confusion matrix — a
        framework extra beyond the reference's aggregate-only battery
        (its evaluators never expose per-class numbers)."""
        if "precision_per_class" not in m or "confusion_matrix" not in m:
            return
        cm = np.asarray(m["confusion_matrix"])
        k = len(cm)
        self.line("------------------Per-Class Metrics---------------------")
        self.line()
        names = (
            self.class_names
            if self.class_names and len(self.class_names) == k
            else [str(c) for c in range(k)]
        )
        rows = [
            [
                names[c],
                int(cm[c].sum()),
                f"{m['precision_per_class'][c]:.4f}",
                f"{m['recall_per_class'][c]:.4f}",
                f"{m['f1_per_class'][c]:.4f}",
            ]
            for c in range(k)
        ]
        self._buf.write(
            show(
                ["class", "support", "precision", "recall", "f1"],
                rows,
                max_rows=None,
            )
        )
        self._buf.write(
            show(
                ["true\\pred"] + list(names),
                [[names[c]] + [int(v) for v in cm[c]] for c in range(k)],
                max_rows=None,
            )
        )
        self.line()

    # --- artifacts -------------------------------------------------------
    def text(self) -> str:
        return self._buf.getvalue()

    def save(self) -> dict[str, str]:
        os.makedirs(self.output_dir, exist_ok=True)
        paths = {}
        paths["result"] = os.path.join(self.output_dir, "result.txt")
        with open(paths["result"], "w") as f:
            f.write(self.text())
        plain = [r for r in self.results if not r.is_cv]
        cv = [r for r in self.results if r.is_cv]
        if plain:
            paths["csv"] = os.path.join(self.output_dir, "additional_param.csv")
            self._write_csv(paths["csv"], CSV_HEADER, plain)
        if cv:
            paths["cv_csv"] = os.path.join(
                self.output_dir, "crossFold_additional_param.csv"
            )
            self._write_csv(paths["cv_csv"], CV_CSV_HEADER, cv)
        return paths

    @staticmethod
    def _write_csv(path, header, results):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            for r in results:
                total, correct, wrong = r.counts
                m = r.metrics
                w.writerow(
                    [
                        # the reference writes the model object's repr
                        # (Main/main.py:660: 'Classifier': lrModel) —
                        # display_name is our uid-stable equivalent
                        r.display_name or r.name,
                        total,
                        correct,
                        wrong,
                        wrong / max(total, 1),
                        correct / max(total, 1),
                        m["f1"],
                        r.train_time_s,
                        r.test_time_s,
                        m["accuracy"],
                    ]
                )
