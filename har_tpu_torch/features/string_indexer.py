"""StringIndexer: frequency-descending vocabulary → integer index.

Matches MLlib semantics used by the reference (Main/main.py:52-61): labels
ordered by descending frequency — for WISDM ACTIVITY the mapping is
Walking=0, Jogging=1, Upstairs=2, Downstairs=3, Sitting=4, Standing=5
(reference result.txt class counts).

Equal-count ties: MLlib keeps whatever order ``countByValue().toSeq``
yields — the scala immutable.HashMap trie iteration order.
``tie_break="spark_hash"`` reproduces it bit-for-bit (so one-hot indices
match the reference's feature vectors); ``"lexicographic"`` is the
readable default for standalone use.
"""

from __future__ import annotations

import numpy as np

from har_tpu_torch.features.pipeline import ColumnSpace, FrameLike, as_columns


class StringIndexer:
    def __init__(
        self,
        input_col: str,
        output_col: str,
        handle_invalid: str = "error",  # error | keep (extra bucket)
        tie_break: str = "lexicographic",  # lexicographic | spark_hash
    ):
        self.input_col = input_col
        self.output_col = output_col
        if handle_invalid not in ("error", "keep"):
            raise ValueError(f"handle_invalid={handle_invalid!r}")
        if tie_break not in ("lexicographic", "spark_hash"):
            raise ValueError(f"tie_break={tie_break!r}")
        self.handle_invalid = handle_invalid
        self.tie_break = tie_break

    def fit(self, frame: FrameLike) -> "StringIndexerModel":
        col = as_columns(frame)[self.input_col]
        if self.tie_break == "spark_hash":
            from har_tpu_torch.data.spark_split import mllib_vocab

            ranks = mllib_vocab([str(v) for v in col])
            vocab = tuple(
                v for v, _ in sorted(ranks.items(), key=lambda kv: kv[1])
            )
        else:
            values, counts = np.unique(col.astype(str), return_counts=True)
            order = np.lexsort((values, -counts))  # freq desc, then lex
            vocab = tuple(str(values[i]) for i in order)
        return StringIndexerModel(
            self.input_col, self.output_col, vocab, self.handle_invalid
        )


class StringIndexerModel:
    def __init__(
        self,
        input_col: str,
        output_col: str,
        vocab: tuple[str, ...],
        handle_invalid: str = "error",
    ):
        self.input_col = input_col
        self.output_col = output_col
        self.vocab = vocab
        self.handle_invalid = handle_invalid
        self._index = {v: i for i, v in enumerate(vocab)}

    @property
    def cardinality(self) -> int:
        return len(self.vocab)

    def transform(self, frame: FrameLike) -> ColumnSpace:
        columns = as_columns(frame)
        col = columns[self.input_col].astype(str)
        unseen_bucket = len(self.vocab)
        idx = np.fromiter(
            (self._index.get(v, unseen_bucket) for v in col),
            dtype=np.int32,
            count=len(col),
        )
        if self.handle_invalid == "error" and np.any(idx == unseen_bucket):
            bad = sorted(set(col[idx == unseen_bucket]))[:5]
            raise ValueError(
                f"unseen labels in column {self.input_col!r}: {bad}"
            )
        columns[self.output_col] = idx
        return columns
