"""End-to-end pipeline runner: the reference's `main.py` flow on PyTorch.

Port of ``har_tpu/runner.py::run`` for every family of ``har train``:

- tabular WISDM: load the table → report its schema, samples and summary
  → each model's feature view, featurized once per view: the one-hot
  pipeline (LR, DT, RF) or the numeric view (GBDT and MLP: the 10 numeric
  columns and the parsed PEAK columns, plus the 30 histogram-bin columns
  for GBDT where the table kept them) → the Spark-exact 70/30 split → fit
  and score each model, then (CV on, the default) its 5-fold
  CrossValidator over the reference's grid (LR's 9 points; ``{}`` for
  the others);
- ``wisdm_raw``: raw windows → report their shape and class counts → the
  windows themselves for CNN1D, BiLSTM and the transformer, their 43
  WISDM features (``features/raw_features.py``, on ``device``) for the
  others → the Bernoulli 70/30 split → fit, score and CV as above;

then result.txt, the metrics CSV, the cross-fold CSV and timing.csv, and
with ``save_models_dir`` every fitted model as a saved artifact
(``checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import os

import numpy as np
import torch

from har_tpu_torch.config import RunConfig
from har_tpu_torch.data.raw_loader import load_raw_stream, stream_windows
from har_tpu_torch.data.raw_windows import WindowedDataset, synthetic_raw_stream
from har_tpu_torch.data.synthetic import synthetic_wisdm
from har_tpu_torch.data.wisdm import (
    ACTIVITIES,
    BINNED_COLUMNS,
    load_wisdm,
    numeric_feature_view,
)
from har_tpu_torch.device import resolve_device
from har_tpu_torch.features.raw_features import extract_features
from har_tpu_torch.features.string_indexer import StringIndexer
from har_tpu_torch.features.wisdm_pipeline import (
    FeatureSet,
    build_wisdm_pipeline,
    make_feature_set,
)
from har_tpu_torch.models.forest import RandomForestClassifier
from har_tpu_torch.models.gbdt import GradientBoostedTreesClassifier
from har_tpu_torch.models.logistic_regression import LogisticRegression
from har_tpu_torch.models.neural import MODEL_REGISTRY
from har_tpu_torch.models.neural_classifier import NeuralClassifier
from har_tpu_torch.models.tree import DecisionTreeClassifier
from har_tpu_torch.ops.metrics import evaluate
from har_tpu_torch.reporting import ModelResult, ReportWriter
from har_tpu_torch.train.trainer import TrainerConfig
from har_tpu_torch.tuning import CrossValidator, param_grid
from har_tpu_torch.utils.profiling import StepTimer, write_timing_csv

_ALIASES = {
    "lr": "logistic_regression",
    "dt": "decision_tree",
    "rf": "random_forest",
    "gbt": "gbdt",
}

_ESTIMATORS = {
    "logistic_regression": LogisticRegression,
    "decision_tree": DecisionTreeClassifier,
    "random_forest": RandomForestClassifier,
    "gbdt": GradientBoostedTreesClassifier,
}

_NEURAL = tuple(MODEL_REGISTRY)
# models that consume (n, T, 3) raw windows, not tabular feature vectors
_RAW_MODELS = ("cnn1d", "bilstm", "transformer")


def canonical_model_name(name: str) -> str:
    return _ALIASES.get(name, name)


def effective_synthetic_rows(data) -> int:
    """Row count a synthetic fallback generates for this config."""
    return data.synthetic_rows or (4000 if data.dataset == "wisdm_raw" else 5418)


def _neural_model_fields(name: str) -> set[str]:
    """Constructor arguments of a neural family's module (the flax
    fields): the input width is the data's, not a hyperparameter."""
    params = inspect.signature(MODEL_REGISTRY[name]).parameters
    return set(params) - {"self", "in_features"}


def _known_params() -> set[str]:
    """Every hyperparameter name a ported estimator accepts; a param
    outside this union is a typo and fails loudly."""
    known = {
        f.name for cls in _ESTIMATORS.values() for f in dataclasses.fields(cls)
    } | {f.name for f in dataclasses.fields(TrainerConfig)} | {"augment"}
    for name in _NEURAL:
        known |= _neural_model_fields(name)
    # infrastructure fields, not hyperparameters
    return known - {"device", "mesh"}


def build_estimator(name: str, params: dict | None = None, device="cuda"):
    """The estimator for ``name``; each keeps only the knobs it has from
    the shared ``params`` dict, and a knob no estimator has is an error."""
    name = canonical_model_name(name)
    if name not in _ESTIMATORS and name not in _NEURAL:
        raise ValueError(f"unknown model {name!r}")
    params = dict(params or {})
    unknown = set(params) - _known_params()
    if unknown:
        raise ValueError(
            f"unknown hyperparameter(s) {sorted(unknown)} — not accepted "
            "by any ported estimator"
        )
    if name in _NEURAL:
        train_keys = {f.name for f in dataclasses.fields(TrainerConfig)}
        cfg = TrainerConfig(
            **{k: params.pop(k) for k in list(params) if k in train_keys}
        )
        augment = params.pop("augment", None)
        fields = _neural_model_fields(name)
        return NeuralClassifier(
            name,
            config=cfg,
            model_kwargs={k: v for k, v in params.items() if k in fields},
            augment=augment,
            device=str(device),
        )
    cls = _ESTIMATORS[name]
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in params.items() if k in fields}
    return cls(**kwargs, device=str(device))


# The reference's LR grid (Main/main.py:202-207); DT/RF grids are empty.
REFERENCE_GRIDS = {
    "logistic_regression": dict(
        reg_param=[0.1, 0.3, 0.5], elastic_net_param=[0.0, 0.1, 0.2]
    ),
}


def load_dataset(config: RunConfig):
    """The WISDM table (the CSV when a path resolves, else the same-shape
    synthetic table), or for ``wisdm_raw`` the raw windows (of the stream
    at ``--data-path``, else synthetic)."""
    data = config.data
    if data.dataset == "wisdm_raw":
        if data.path is not None:
            return load_raw_windows(data.path)
        return synthetic_raw_stream(
            n_windows=effective_synthetic_rows(data), seed=data.seed
        )
    if data.dataset not in ("wisdm", "synthetic"):
        raise NotImplementedError(
            f"dataset {data.dataset!r} is not ported to har_tpu_torch yet: "
            "ROADMAP.md Queue 1 item 1"
        )
    path = data.resolved_path()
    if data.dataset == "wisdm" and path is not None:
        return load_wisdm(path, drop_binned=data.drop_binned)
    return synthetic_wisdm(n_rows=effective_synthetic_rows(data), seed=data.seed)


def load_raw_windows(path: str) -> WindowedDataset:
    """A real ``WISDM_ar_v1.1_raw.txt`` through the native parser, cut into
    200-sample windows per (user, activity) bout; labels follow the
    canonical WISDM order when the stream's activity names are WISDM's."""
    stream = load_raw_stream(path)
    ds = stream_windows(stream)
    # parser ids are first-appearance order
    if set(stream.activity_names) <= set(ACTIVITIES):
        remap = np.asarray(
            [ACTIVITIES.index(n) for n in stream.activity_names], np.int32
        )
        ds = WindowedDataset(ds.windows, remap[ds.labels], class_names=ACTIVITIES)
    return ds


def _feature_mode(config: RunConfig) -> str:
    """Which feature view this config's model trains on."""
    name = canonical_model_name(config.model.name)
    if config.data.dataset == "wisdm_raw":
        # raw-window models consume the windows; every other model the
        # 43-feature WISDM transform of them
        return "raw" if name in _RAW_MODELS else "raw_features"
    if name in _RAW_MODELS:
        raise ValueError(
            f"{name} trains on raw (T, 3) windows — use --dataset wisdm_raw, "
            f"not a tabular dataset ({config.data.dataset})"
        )
    return "numeric" if name in ("mlp", "gbdt") else "onehot"


def resolve_split_method(data) -> str:
    """"auto" replays the reference's randomSplit bit-for-bit on the tabular
    WISDM dataset and falls back to the plain Bernoulli draw elsewhere."""
    method = getattr(data, "split_method", "auto")
    if method == "auto":
        return "spark" if data.dataset == "wisdm" else "bernoulli"
    if method not in ("spark", "bernoulli"):
        raise ValueError(f"unknown split_method {method!r}")
    if method == "spark" and data.dataset != "wisdm":
        raise ValueError(
            "split_method='spark' replays the reference's WISDM randomSplit "
            f"and needs the WISDM sort columns; dataset {data.dataset!r} "
            "doesn't carry them"
        )
    return method


def derive_split(full: FeatureSet, table, data) -> tuple[FeatureSet, FeatureSet]:
    """THE train/test derivation for the tabular WISDM view."""
    if resolve_split_method(data) == "spark":
        from har_tpu_torch.data.spark_split import assemble_rows, spark_split_indices
        from har_tpu_torch.models.mllib_exact import DeferredExactDesign

        asm = assemble_rows(table)
        train_idx, test_idx = spark_split_indices(
            table, [data.train_fraction, 1.0 - data.train_fraction], data.seed,
            rows=asm,
        )
        # the float64 design of the bit-exact replays, packed only if one
        # runs; the dict shares the full table's CSR between the two sides
        shared: dict = {}
        return (
            dataclasses.replace(
                full.take(train_idx), rows=train_idx,
                exact=DeferredExactDesign(shared, asm, train_idx),
            ),
            dataclasses.replace(
                full.take(test_idx), rows=test_idx,
                exact=DeferredExactDesign(shared, asm, test_idx),
            ),
        )
    return full.train_test(data.train_fraction, data.seed)


def featurize(config: RunConfig, table, device: str | torch.device = "cuda"):
    """(train, test, fitted pipeline or None) for this config's model: the
    raw windows or their 43 features (computed on ``device``) split by a
    Bernoulli draw, or the numeric view or the one-hot pipeline and the
    split of the tabular table."""
    mode = _feature_mode(config)
    if mode in ("raw", "raw_features"):
        if mode == "raw":
            x = np.asarray(table.windows, np.float32)
        else:
            windows = torch.as_tensor(np.asarray(table.windows, np.float32))
            x = extract_features(windows.to(resolve_device(device))).cpu().numpy()
        full = FeatureSet(
            features=x,
            label=np.asarray(table.labels, np.int32),
            class_names=(
                tuple(table.class_names) if table.class_names else None
            ),
        )
        train, test = full.train_test(
            config.data.train_fraction, config.data.seed
        )
        return train, test, None
    if mode == "numeric":
        # GBDT takes the 30 histogram-bin columns where the loader kept
        # them; the MLP keeps the 13-column view
        has_bins = canonical_model_name(config.model.name) == "gbdt" and all(
            c in table.column_names for c in BINNED_COLUMNS
        )
        x, _ = numeric_feature_view(table, include_binned=has_bins)
        indexer = StringIndexer("ACTIVITY", "label").fit(table)
        y = np.asarray(indexer.transform(table)["label"], np.int32)
        uid = table["UID"] if "UID" in table.column_names else None
        full = FeatureSet(features=x, label=y, uid=uid, class_names=indexer.vocab)
        pipe_model = None
    else:
        pipe_model = build_wisdm_pipeline().fit(table)
        label_vocab = next(
            (
                s.vocab
                for s in pipe_model.stages
                if getattr(s, "output_col", None) == "label"
            ),
            None,
        )
        full = make_feature_set(
            pipe_model.transform(table), class_names=label_vocab
        )
    train, test = derive_split(full, table, config.data)
    return train, test, pipe_model


def _views_for(models, config: RunConfig, table, timer, device):
    """(modes, view_cache): each model's feature view, featurized once per
    view; ``view_cache[mode]`` is the (train, test, pipeline or None) every
    model of that view trains on."""
    modes = {name: _feature_mode(_model_config(config, name)) for name in models}
    view_cache: dict[str, tuple] = {}
    for name in models:
        if modes[name] not in view_cache:
            with timer("featurize"):
                view_cache[modes[name]] = featurize(
                    _model_config(config, name), table, device
                )
    return modes, view_cache


@dataclasses.dataclass
class RunOutcome:
    report_paths: dict[str, str]
    results: list[ModelResult]

    @property
    def accuracies(self) -> dict[str, float]:
        return {r.name: float(r.metrics["accuracy"]) for r in self.results}


# (estimator class, pretty name) per ported classical family, for the
# report's Spark-style model lines (result.txt:141,186,231,276)
_SPARK_NAMES = {
    "logistic_regression": ("LogisticRegression", "Logistic Regression"),
    "decision_tree": ("DecisionTreeClassifier", "Decision Tree"),
    "random_forest": ("RandomForestClassifier", "Random Forest"),
    "gbdt": ("GBTClassifier", "Gradient Boosted Trees"),
}


def _spark_display_name(name: str, model, is_cv: bool) -> str | None:
    """The model line Spark prints atop each block: the estimator uid for
    LR, the fitted model's repr for trees (result.txt:141,231,276) and
    "CrossValidatorModel_<uid> for <family>" for CV (result.txt:186).  The
    uid suffix is a deterministic hash of the job name, as in the JAX
    package.  None for the neural families."""
    base = name[: -len("_cv")] if name.endswith("_cv") else name
    entry = _SPARK_NAMES.get(base)
    if entry is None:
        return None  # the neural families keep their own names
    est_cls, pretty = entry
    uid = hashlib.sha1(name.encode()).hexdigest()[:20]
    if is_cv:
        return f"CrossValidatorModel_{uid} for {pretty}"
    if base == "decision_tree":
        return (
            f"DecisionTreeClassificationModel (uid={est_cls}_{uid}) of "
            f"depth {model.tree.max_depth} with {model.num_nodes} nodes"
        )
    if base == "random_forest":
        return (
            f"RandomForestClassificationModel (uid={est_cls}_{uid}) "
            f"with {model.num_trees} trees"
        )
    if base == "gbdt":
        return f"GBTClassificationModel (uid={est_cls}_{uid})"
    return f"{est_cls}_{uid}"


def _cross_validator(config: RunConfig, name: str, est) -> CrossValidator:
    """The CV pass after a plain fit: ``config.tuning``'s grid, folds and
    metric where given, else the reference's grid, 5 folds and accuracy."""
    tuning = config.tuning
    grid = dict(tuning.grid) if tuning and tuning.grid else REFERENCE_GRIDS.get(name, {})
    return CrossValidator(
        estimator=est,
        grid=param_grid(**grid),
        num_folds=tuning.num_folds if tuning else 5,
        selection_metric=tuning.selection_metric if tuning else "accuracy",
        seed=config.data.seed,
    )


def _fit_eval(est, name, train, test, report, timer, is_cv=False):
    with timer(f"{name}_fit") as fit_sec:
        model = est.fit(train)
    with timer(f"{name}_transform") as tf_sec:
        preds = model.transform(test)
    with timer("report"):
        metrics = evaluate(test.label, preds.raw, model.num_classes)
        result = ModelResult(
            name=name,
            metrics=metrics,
            train_time_s=fit_sec.seconds,
            test_time_s=tf_sec.seconds,
            is_cv=is_cv,
            display_name=_spark_display_name(name, model, is_cv),
        )
        report.model_block(
            result, sample_text=report.prediction_sample(test, preds)
        )
    return result, model


def _save_fitted(base_dir: str, job_name: str, model, est, config: RunConfig,
                 pipe_model, input_shape: tuple | None = None) -> str:
    """Persist one fitted model under ``base_dir/job_name``: a neural one
    as parameters and meta, a classical one as arrays and meta with the
    fitted one-hot pipeline's vocabularies where it trained on them."""
    from har_tpu_torch.checkpoint import save_classical_model, save_model
    from har_tpu_torch.models.neural_classifier import NeuralClassifierModel

    path = os.path.join(base_dir, job_name)
    synthetic_rows = None
    if config.data.resolved_path() is None:
        # the effective row count, so scoring's provenance guard fires
        # for runs that never set synthetic_rows
        synthetic_rows = effective_synthetic_rows(config.data)
    provenance = dict(
        dataset=config.data.dataset,
        synthetic_rows=synthetic_rows,
        drop_binned=config.data.drop_binned,
        split_method=resolve_split_method(config.data),
        split_seed=config.data.seed,
        train_fraction=config.data.train_fraction,
    )
    if isinstance(model, NeuralClassifierModel):
        return save_model(path, model, est.model_name, dict(est.model_kwargs),
                          input_shape=input_shape, **provenance)
    return save_classical_model(path, model, pipeline=pipe_model, **provenance)


def _model_config(config: RunConfig, name: str) -> RunConfig:
    return dataclasses.replace(
        config, model=dataclasses.replace(config.model, name=name)
    )


def run(
    config: RunConfig,
    models=None,
    with_cv: bool = True,
    device: str | torch.device = "cuda",
    save_models_dir: str | None = None,
) -> RunOutcome:
    """The reference pipeline for the ported families on ``device``: each
    model's fit and, with ``with_cv``, its CrossValidator; with
    ``save_models_dir``, every fitted model saved there as ``<name>`` and
    ``<name>_cv`` (the CV's refit, saved with the tuned estimator)."""
    device = resolve_device(device)
    models = [
        canonical_model_name(m)
        for m in (
            models or ["logistic_regression", "decision_tree", "random_forest"]
        )
    ]
    estimators = [
        build_estimator(name, config.model.params, device) for name in models
    ]
    if (config.mesh.dp, config.mesh.tp) != (1, 1) and any(
        name in _NEURAL or name == "logistic_regression" for name in models
    ):
        raise NotImplementedError(
            "data- and tensor-parallel neural training and the mesh-sharded "
            "LR sweep are not ported to har_tpu_torch yet: ROADMAP.md Queue 1 "
            "item 14 (the parallel layer)"
        )
    # every model's feature view, resolved before any work: it raises for a
    # model that cannot run on this dataset
    for name in models:
        _feature_mode(_model_config(config, name))

    # "report" accumulates every section that renders the report, so
    # timing.csv accounts for the whole run
    timer = StepTimer(device)
    with timer("load"):
        table = load_dataset(config)
    is_raw = isinstance(table, WindowedDataset)
    report = ReportWriter(config.output_dir)
    with timer("report"):
        report.line("Loading Data Set...")
        if is_raw:
            report.line(
                f"Raw windows: {tuple(table.windows.shape)} "
                f"({table.windows.shape[1]} steps, tri-axial)"
            )
            names = table.class_names or tuple(
                str(i) for i in range(int(table.labels.max()) + 1)
            )
            report.class_counts([names[i] for i in np.asarray(table.labels)])
        else:
            report.schema(table)
            report.sample(table)
            report.class_counts(table["ACTIVITY"])
            report.summary(table)

    modes, view_cache = _views_for(models, config, table, timer, device)
    train, test = view_cache[modes[models[0]]][:2]
    with timer("report"):
        report.class_names = (
            list(train.class_names) if train.class_names else None
        )
        oh_feats = None
        if "onehot" in view_cache:
            # MODELING PIPELINE + sample/table blocks (reference
            # result.txt:59-138): the design matrix reassembled from the
            # one-hot view's splits
            oh_train, oh_test, _ = view_cache["onehot"]
            report.pipeline_schema(table)
            oh_feats = np.empty((len(table), oh_train.num_features), np.float32)
            oh_labels = np.empty((len(table),), np.float64)
            for part in (oh_train, oh_test):
                oh_feats[part.rows] = part.features
                oh_labels[part.rows] = part.label
            report.sample_feature_data(table, oh_labels, oh_feats)
        report.split_counts(len(train), len(test))
        if oh_feats is not None:
            report.split_sample_tables(
                table, oh_feats, oh_labels, oh_train.rows, oh_test.rows
            )

    results = []
    for name, est in zip(models, estimators):
        train, test, pipe_model = view_cache[modes[name]]
        input_shape = np.asarray(train.features).shape[1:]
        result, model = _fit_eval(est, name, train, test, report, timer)
        results.append(result)
        if save_models_dir:
            _save_fitted(save_models_dir, name, model, est, config, pipe_model,
                         input_shape)
        if with_cv:
            cv = _cross_validator(config, name, est)
            result, cv_model = _fit_eval(cv, f"{name}_cv", train, test, report,
                                         timer, is_cv=True)
            results.append(result)
            if save_models_dir:
                # the tuned estimator, so a neural artifact's meta
                # describes the refit's architecture
                tuned = (est.copy_with(**cv_model.best_params)
                         if cv_model.best_params else est)
                _save_fitted(save_models_dir, f"{name}_cv", cv_model.best_model,
                             tuned, config, pipe_model, input_shape)
    with timer("report"):
        paths = report.save()
    paths["timing"] = write_timing_csv(
        os.path.join(config.output_dir, "timing.csv"), timer
    )
    return RunOutcome(report_paths=paths, results=results)
