"""UCI-HAR (smartphone) dataset adapter.

Port of ``har_tpu/data/ucihar.py`` (numpy, copied): the same loader,
fixture writer and synthetic stand-in, reading the same
``HAR_TPU_UCIHAR_ROOT`` variable in the same probe order, so both packages
find the same tree and build the same table from it.

The reference paper's second benchmark (paper §4: "KAGGLE Data-set" —
UCI-HAR smartphones, 561 precomputed features, 6 classes; BASELINE.md:
LR+CV reaches 91.9% accuracy there).  The repo itself ships only WISDM;
this adapter accepts the published "UCI HAR Dataset" layout so the same
pipeline runs both benchmarks:

  <root>/train/X_train.txt        561 fixed-width scientific-notation
                                  columns per row (3-digit exponents,
                                  e.g. " 2.8858451e-001")
  <root>/train/y_train.txt        labels 1..6, one per line
  <root>/train/subject_train.txt  subject ids 1..30, one per line
  <root>/test/...                 same three files
  <root>/features.txt             "1 tBodyAcc-mean()-X" … (561 rows,
                                  names NOT unique in the published file)
  <root>/activity_labels.txt      "1 WALKING" … "6 LAYING"

``root`` may be the directory that CONTAINS "UCI HAR Dataset" too (the
published zip's layout); subject/features/activity files are optional —
the loader degrades to the canonical defaults when they're absent.

Returned as a Table with FEAT_0..FEAT_560 double columns (+ SUBJECT when
shipped) + ACTIVITY string labels, so StringIndexer/VectorAssembler/
report layers treat it exactly like WISDM.  ``write_ucihar_fixture``
emits this exact byte format so tests exercise the real parser contract
without the published archive, which the repository does not ship.
"""

from __future__ import annotations

import os

import numpy as np

from har_tpu_torch.data.schema import ColumnType, Schema
from har_tpu_torch.data.table import Table

# canonical UCI-HAR activity names, label order 1..6
UCIHAR_ACTIVITIES = (
    "WALKING",
    "WALKING_UPSTAIRS",
    "WALKING_DOWNSTAIRS",
    "SITTING",
    "STANDING",
    "LAYING",
)

NUM_FEATURES = 561


def _to_table(
    x: np.ndarray,
    y: np.ndarray,
    subjects: np.ndarray | None = None,
    activities: tuple[str, ...] = UCIHAR_ACTIVITIES,
) -> Table:
    names = [f"FEAT_{i}" for i in range(x.shape[1])]
    types = [ColumnType.DOUBLE] * x.shape[1]
    cols = {f"FEAT_{i}": x[:, i] for i in range(x.shape[1])}
    if subjects is not None:
        names.append("SUBJECT")
        types.append(ColumnType.INT)
        cols["SUBJECT"] = np.asarray(subjects, np.int64)
    names.append("ACTIVITY")
    types.append(ColumnType.STRING)
    cols["ACTIVITY"] = np.asarray(
        [activities[int(lab) - 1] for lab in y], dtype=object
    )
    return Table(cols, Schema(tuple(names), tuple(types)))


def _resolve_root(root: str) -> str:
    """Accept the dir holding train/test or the published zip's nesting.

    The marker is train/X_train.txt, not a bare train/ directory — any
    ML-style checkout has a train/ folder, and a false positive here
    turns resolve_ucihar_root's graceful skip into a FileNotFoundError
    deep inside the parity lane.
    """
    for cand in (root, os.path.join(root, "UCI HAR Dataset")):
        if os.path.isfile(os.path.join(cand, "train", "X_train.txt")):
            return cand
    raise FileNotFoundError(
        f"no UCI-HAR train/X_train.txt under {root!r} "
        "(or its 'UCI HAR Dataset' subdirectory)"
    )


def _read_indexed_names(path: str) -> tuple[str, ...] | None:
    """'<index> <name>' files (features.txt / activity_labels.txt)."""
    if not os.path.exists(path):
        return None
    names = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                names.append(line.split(maxsplit=1)[1])
    return tuple(names)


def resolve_ucihar_root() -> str | None:
    """Locate a real 'UCI HAR Dataset' tree, or None.

    Probes $HAR_TPU_UCIHAR_ROOT first, then conventional data dirs.  The
    paper-parity lane (``har_tpu_torch.parity.ucihar_parity_lane``) keys
    off this: present → run LR+CV and check the published ≈0.91 accuracy;
    absent → skip with a clear message.
    """
    candidates = [
        os.environ.get("HAR_TPU_UCIHAR_ROOT"),
        ".",
        "./data",
        os.path.expanduser("~/data"),
    ]
    for cand in candidates:
        if not cand:
            continue
        try:
            return _resolve_root(cand)
        except FileNotFoundError:
            continue
    return None


def load_ucihar(root: str, split: str = "all") -> Table:
    """Load train/test/all splits from a published-layout UCI-HAR tree."""
    root = _resolve_root(root)
    parts = {"train": ["train"], "test": ["test"], "all": ["train", "test"]}[
        split
    ]
    activities = (
        _read_indexed_names(os.path.join(root, "activity_labels.txt"))
        or UCIHAR_ACTIVITIES
    )
    features = _read_indexed_names(os.path.join(root, "features.txt"))
    xs, ys, subs = [], [], []
    for part in parts:
        d = os.path.join(root, part)
        x = np.loadtxt(os.path.join(d, f"X_{part}.txt"), dtype=np.float64)
        if features is not None and x.shape[1] != len(features):
            raise ValueError(
                f"X_{part}.txt has {x.shape[1]} columns but features.txt "
                f"names {len(features)}"
            )
        xs.append(x)
        ys.append(
            np.loadtxt(os.path.join(d, f"y_{part}.txt"), dtype=np.int64)
        )
        sub_path = os.path.join(d, f"subject_{part}.txt")
        if os.path.exists(sub_path):
            subs.append(np.loadtxt(sub_path, dtype=np.int64))
    subjects = np.concatenate(subs) if len(subs) == len(parts) else None
    return _to_table(
        np.concatenate(xs), np.concatenate(ys), subjects, activities
    )


def format_ucihar_value(v: float) -> str:
    """One X_*.txt field: 7-decimal scientific notation with the published
    files' 3-digit exponent (' 2.8858451e-001' / '-9.9527860e-001')."""
    mantissa, exp = f"{float(v):.7e}".split("e")
    return f"{mantissa}e{exp[0]}{exp[1:].lstrip('0').zfill(3)}"


def write_ucihar_fixture(
    root: str,
    n_train: int = 64,
    n_test: int = 32,
    seed: int = 0,
    num_features: int = NUM_FEATURES,
) -> str:
    """Write a byte-faithful "UCI HAR Dataset" tree with synthetic data.

    Reproduces the published archive's on-disk contract: the nested
    directory name, fixed-width space-padded X columns with 3-digit
    exponents, per-line y/subject files, features.txt (561 indexed names,
    including the real file's duplicated-name quirk) and
    activity_labels.txt.  Returns the nested dataset root.
    """
    rng = np.random.default_rng((seed, 561))
    base = os.path.join(root, "UCI HAR Dataset")
    means = rng.normal(0.0, 1.5, size=(6, num_features))
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "activity_labels.txt"), "w") as f:
        for i, name in enumerate(UCIHAR_ACTIVITIES, start=1):
            f.write(f"{i} {name}\n")
    with open(os.path.join(base, "features.txt"), "w") as f:
        for i in range(1, num_features + 1):
            # the published file repeats names (fBodyAcc-bandsEnergy()
            # blocks); reproduce the quirk so loaders can't assume
            # uniqueness
            name = f"tBodyAcc-mean()-{'XYZ'[i % 3]}" if i % 7 == 0 else (
                f"feat-{i}()"
            )
            f.write(f"{i} {name}\n")
    for part, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(base, part)
        os.makedirs(d, exist_ok=True)
        y = rng.integers(1, 7, size=n)
        subjects = rng.integers(1, 31, size=n)
        x = np.clip(
            means[y - 1] + rng.normal(0.0, 1.0, size=(n, num_features)),
            -10,
            10,
        )
        with open(os.path.join(d, f"X_{part}.txt"), "w") as f:
            for row in x:
                f.write(
                    " ".join(
                        format_ucihar_value(v).rjust(16) for v in row
                    )
                    + "\n"
                )
        with open(os.path.join(d, f"y_{part}.txt"), "w") as f:
            f.writelines(f"{int(v)}\n" for v in y)
        with open(os.path.join(d, f"subject_{part}.txt"), "w") as f:
            f.writelines(f"{int(v)}\n" for v in subjects)
    return base


def synthetic_ucihar(n_rows: int = 2000, seed: int = 0) -> Table:
    """Synthetic stand-in with the UCI-HAR shape (tests / no-data envs)."""
    rng = np.random.default_rng((seed, 20907))
    y = rng.integers(1, 7, size=n_rows)
    means = rng.normal(0.0, 1.5, size=(6, NUM_FEATURES))
    x = means[y - 1] + rng.normal(0.0, 1.0, size=(n_rows, NUM_FEATURES))
    return _to_table(x, y)


def ucihar_feature_set(table: Table):
    """Table → FeatureSet (features already numeric; label via indexer)."""
    from har_tpu_torch.features.string_indexer import StringIndexer
    from har_tpu_torch.features.wisdm_pipeline import FeatureSet

    feat_cols = [c for c in table.column_names if c.startswith("FEAT_")]
    x = np.stack([np.asarray(table[c], np.float32) for c in feat_cols], 1)
    y = np.asarray(
        StringIndexer("ACTIVITY", "label").fit(table).transform(table)["label"],
        np.int32,
    )
    return FeatureSet(features=x, label=y)
