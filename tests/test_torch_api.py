"""har_tpu's Python library surface on the port.

A ``har_tpu`` program runs on the port with its imports renamed
(``har_tpu`` → ``har_tpu_torch``) and ``device=`` given where the port
needs it.  The surface checks read ``har_tpu``'s sources with ``ast``:
every name a package ``__init__`` exports, and every public module-level
function, class, assigned name and public method of every module, must
resolve on the port's module of the same name, unless ``EXCLUDED`` names
it with its reason (ROADMAP Queue 3 repeats each).  A new ``har_tpu`` name
fails here until it is ported or excluded; an exclusion the port no
longer needs fails too.  The behaviour tests run both packages on the
same seeded inputs.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "har_tpu"

# "module" or "module:name" (har_tpu's dotted names) -> why the port has no
# counterpart
EXCLUDED = {
    "har_tpu:_shard_map_old": "jax's pre-0.5 shard_map, shimmed at import; "
    "the port has no jax",
    "har_tpu.ops.pallas_hist": "the Pallas histogram kernel; its port is "
    "ops/hist.py (K1, csrc/hist.cu)",
    "har_tpu.ops.flash_attention:pick_block": "the Pallas kernel's block "
    "size; K2's launch is planned by ops/flash_attention.py::flash_plan",
    "har_tpu.ops.flash_attention:MIN_HEAD_DIM": "the Pallas kernel's "
    "lane-width floor on the TPU; K2's plan takes the head dims it accepts",
    "har_tpu.models.tree:auto_pallas_hist": "picks the Pallas kernel or "
    "XLA's one-hot matmul from a TPU measurement; the port's trees always "
    "run K1 (ROADMAP's Speed rule: not copied)",
    "har_tpu.data.native_loader": "the C++ CSV parser; the port parses the "
    "5,418-row CSV in Python (data/csv_loader.py)",
    "har_tpu.parallel.rules:REFERENCE_TREES": "flax leaf trees that HL007 "
    "replays the JAX rule tables against; the port's HL007 audits DTensor "
    "placements and needs none",
    "har_tpu.parallel.data_parallel:Pytree": "a jax typing alias; the "
    "port's steps take tensors or dicts of them",
    "har_tpu.analyze.hotpath:is_jit_marked": "finds jax.jit decorators; the "
    "port's counterpart is hotpath.is_compile_marked",
    "har_tpu.export:make_predict_core": "jax-only internal of the export; "
    "the port's counterpart is export.PredictCore",
    "har_tpu.quantize:QuantizedModel.export_parts": "jax-only internal of "
    "the int8 export (weights as program inputs); the port's int8 weights "
    "are buffers of the exported program (export.PredictCore)",
}

# estimator fields of har_tpu the port's estimators leave out
EXCLUDED_FIELDS = {
    "DecisionTreeClassifier.use_pallas_hist": "chooses the Pallas kernel; "
    "the port's trees always run K1",
    "RandomForestClassifier.use_pallas_hist": "chooses the Pallas kernel; "
    "the port's trees always run K1",
}


def _modules() -> list[tuple[str, Path]]:
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        out.append((".".join(parts).removesuffix(".__init__"), path))
    return out


MODULES = _modules()


def _public_names(path: Path) -> list[str]:
    """Top-level defs, classes (and their public methods), assigned names
    and ``__all__`` of one source, the private ones left out."""
    tree = ast.parse(path.read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [
                    f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not sub.name.startswith("_")
                ]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names += [e.value for e in node.value.elts]
                elif isinstance(t, ast.Name) and not t.id.startswith("_"):
                    names.append(t.id)
    return list(dict.fromkeys(names))


def _resolve(module, dotted: str) -> bool:
    obj = module
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _port(name: str) -> str:
    return name.replace("har_tpu", "har_tpu_torch", 1)


@pytest.mark.parametrize("name,path", MODULES, ids=[m for m, _ in MODULES])
def test_every_public_name_has_a_counterpart(name, path):
    if name in EXCLUDED:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_port(name))
        return
    port = importlib.import_module(_port(name))
    missing = [
        n for n in _public_names(path)
        if not _resolve(port, n) and f"{name}:{n}" not in EXCLUDED
    ]
    assert not missing, f"{_port(name)} lacks {missing}"


def test_exclusions_are_still_needed():
    """Each excluded name is one har_tpu has and the port lacks."""
    sources = dict(MODULES)
    for key in EXCLUDED:
        module, _, name = key.partition(":")
        assert module in sources, key
        if name:
            assert name.split(".")[-1] in sources[module].read_text(), key
            assert not _resolve(importlib.import_module(_port(module)), name), key


@pytest.mark.parametrize("name", [m for m, p in MODULES if p.name == "__init__.py"])
def test_package_exports_resolve(name):
    """Every name in a har_tpu package's ``__all__`` is in the port's
    package ``__all__`` too, and imports from it."""
    tree = ast.parse((JAX_PKG.parent / name.replace(".", "/") / "__init__.py").read_text())
    exported = [
        e.value for node in tree.body if isinstance(node, ast.Assign)
        for t in node.targets if isinstance(t, ast.Name) and t.id == "__all__"
        for e in node.value.elts
    ]
    port = importlib.import_module(_port(name))
    for n in exported:
        assert hasattr(port, n), f"{_port(name)}.{n}"
    if exported:
        assert set(exported) <= set(port.__all__)


def test_estimator_fields_match():
    import har_tpu.models as jm
    import har_tpu_torch.models as tm

    for name in jm.__all__:
        a, b = getattr(jm, name), getattr(tm, name)
        if not (isinstance(a, type) and dataclasses.is_dataclass(a)):
            continue
        port_fields = {f.name: f for f in dataclasses.fields(b)}
        for f in dataclasses.fields(a):
            if f"{name}.{f.name}" in EXCLUDED_FIELDS:
                assert f.name not in port_fields
                continue
            assert f.name in port_fields, f"{name}.{f.name}"
            if f.default is not dataclasses.MISSING and not dataclasses.is_dataclass(f.default):
                assert port_fields[f.name].default == f.default, f"{name}.{f.name}"


def test_importing_the_package_loads_no_torch_or_numpy():
    code = (
        "import sys, har_tpu_torch as h; "
        "assert h.__version__ and h.DataConfig and h.MeshConfig; "
        "bad = {'torch', 'numpy', 'jax', 'har_tpu'} & set(sys.modules); "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_importing_every_package_builds_no_kernel():
    code = (
        "import har_tpu_torch.data, har_tpu_torch.features, har_tpu_torch.models, "
        "har_tpu_torch.train, har_tpu_torch.ops, har_tpu_torch.tuning, "
        "har_tpu_torch.utils, har_tpu_torch.serve\n"
        "from har_tpu_torch.ops import _build\n"
        "from har_tpu_torch.data import _native_build\n"
        "assert not _build._LOADED, _build._LOADED\n"
        "from har_tpu_torch.data import raw_loader\n"
        "from har_tpu_torch.models import _jvm_native\n"
        "assert raw_loader.NATIVE._lib is None and _jvm_native.NATIVE._lib is None\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


def test_version_and_reference_csv_match():
    import har_tpu
    import har_tpu.config
    import har_tpu_torch
    import har_tpu_torch.config

    assert har_tpu_torch.__version__ == har_tpu.__version__
    assert har_tpu.config.REFERENCE_WISDM_CSV.endswith(
        har_tpu_torch.config.REFERENCE_WISDM_CSV
    )


# -- behaviour against har_tpu on the same seeded inputs --------------------


@pytest.fixture(scope="module")
def tables():
    from har_tpu.data import synthetic_wisdm as jax_synthetic
    from har_tpu_torch.data import synthetic_wisdm

    return jax_synthetic(5418), synthetic_wisdm(5418)


def test_random_split_rows_equal(tables):
    from har_tpu.data import random_split as jax_split
    from har_tpu_torch.data import random_split

    want = jax_split(tables[0], [0.7, 0.3], seed=2018)
    got = random_split(tables[1], [0.7, 0.3], seed=2018)
    assert [t.num_rows for t in got] == [t.num_rows for t in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["UID"], b["UID"])
        np.testing.assert_array_equal(a["ACTIVITY"], b["ACTIVITY"])


def test_table_helpers_equal(tables):
    from har_tpu.data.schema import ColumnType as JaxColumnType
    from har_tpu_torch.data import ColumnType

    want, got = tables
    assert got.num_rows == want.num_rows == 5418
    idx = np.random.default_rng(4).permutation(5418)[:300]
    for name in want.schema.names:
        np.testing.assert_array_equal(got.take(idx)[name], want.take(idx)[name])
        np.testing.assert_array_equal(got.head(7)[name], want.head(7)[name])
        assert got.schema.numpy_dtype(name) is want.schema.numpy_dtype(name)
    for name in ("ACTIVITY", "XPEAK"):
        for descending in (True, False):
            assert got.group_count(name, descending) == want.group_count(name, descending)
    d_got, d_want = got.describe(), want.describe()
    assert list(d_got) == list(d_want)
    for col in d_want:
        for stat in d_want[col]:
            np.testing.assert_allclose(d_got[col][stat], d_want[col][stat], rtol=1e-12, atol=0)
    numeric = ["XAVG", "YAVG", "RESULTANT"]
    np.testing.assert_array_equal(got.numeric_matrix(numeric), want.numeric_matrix(numeric))
    values = np.arange(5418, dtype=np.int64)
    g = got.with_column("ROW", values, ColumnType.INT).with_column("XAVG", values, ColumnType.INT)
    w = want.with_column("ROW", values, JaxColumnType.INT).with_column("XAVG", values, JaxColumnType.INT)
    assert g.schema.names == w.schema.names
    assert [t.value for t in g.schema.types] == [t.value for t in w.schema.types]
    np.testing.assert_array_equal(g["ROW"], w["ROW"])


@pytest.mark.parametrize("kwargs", [{}, dict(n_rows=64, window=40, seed=3, n_classes=4)])
def test_synthetic_raw_windows_equal(kwargs):
    from har_tpu.data.synthetic import synthetic_raw_windows as jax_windows
    from har_tpu_torch.data.synthetic import synthetic_raw_windows

    for got, want in zip(synthetic_raw_windows(**kwargs), jax_windows(**kwargs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_fit_transform_feature_sets_bit_equal(tables):
    from har_tpu.data import random_split as jax_split
    from har_tpu.features import build_wisdm_pipeline as jax_pipeline
    from har_tpu.features.wisdm_pipeline import fit_transform as jax_fit_transform
    from har_tpu_torch.data import random_split
    from har_tpu_torch.features import build_wisdm_pipeline
    from har_tpu_torch.features.wisdm_pipeline import fit_transform

    _, want = jax_fit_transform(jax_pipeline(), *jax_split(tables[0], [0.7, 0.3], seed=2018))
    _, got = fit_transform(build_wisdm_pipeline(), *random_split(tables[1], [0.7, 0.3], seed=2018))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for field in ("features", "label", "uid"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b)


def test_step_timer_accessors():
    from har_tpu.utils import StepTimer as JaxTimer
    from har_tpu_torch.utils import StepTimer

    for timer in (StepTimer(), JaxTimer()):
        for _ in range(3):
            with timer("fit"):
                pass
        assert timer.calls("fit") == 3 and timer.calls("other") == 0
        assert set(timer.seconds) == {"fit"} and timer.seconds["fit"] >= 0.0
        assert timer.rate("other", 10) == 0.0
        if timer.seconds["fit"] > 0:
            assert timer.rate("fit", 10) == pytest.approx(10 / timer.seconds["fit"])


def test_native_libraries_report_availability():
    from har_tpu_torch.data.raw_loader import native_available
    from har_tpu_torch.models import _jvm_native

    assert isinstance(native_available(), bool)
    if _jvm_native.available():
        assert _jvm_native.jvm_exp(0.0) == 1.0


def test_load_raw_stream_engines(tmp_path):
    from har_tpu_torch.data.raw_loader import (
        load_raw_stream,
        native_available,
        write_raw_fixture,
    )

    path = str(tmp_path / "raw.txt")
    write_raw_fixture(path, 12)
    python = load_raw_stream(path, engine="python")
    if native_available():
        for engine in ("auto", "native"):
            got = load_raw_stream(path, engine=engine)
            np.testing.assert_array_equal(got.xyz, python.xyz)
            np.testing.assert_array_equal(got.timestamp, python.timestamp)
    with pytest.raises(ValueError):
        load_raw_stream(path, engine="jvm")


# -- the runner's class_weight warning ---------------------------------------


@pytest.mark.parametrize("name", ["decision_tree", "random_forest", "gbdt"])
def test_class_weight_warning_matches_har_tpu(name):
    from har_tpu.runner import build_estimator as jax_build
    from har_tpu_torch.runner import build_estimator

    messages = []
    for build, kwargs in ((jax_build, {}), (build_estimator, {"device": "cpu"})):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            est = build(name, {"class_weight": "balanced"}, **kwargs)
        assert est is not None
        user = [w for w in caught if issubclass(w.category, UserWarning)]
        assert len(user) == 1
        messages.append(str(user[0].message))
    assert messages[0] == messages[1]
    assert messages[1].startswith("class_weight is ignored by ")
    assert messages[1].endswith(" trains unweighted")


@pytest.mark.parametrize("name", ["logistic_regression", "mlp"])
def test_class_weight_is_silent_where_supported(name):
    from har_tpu_torch.runner import build_estimator

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        est = build_estimator(name, {"class_weight": "balanced"}, device="cpu")
    cfg = getattr(est, "config", est)
    assert cfg.class_weight == "balanced"


# -- the walkthrough (docs/index.md) and the protocols ------------------------


@pytest.fixture(scope="module")
def walkthrough(tables):
    """docs/index.md's walkthrough through each package's names."""
    import har_tpu.features as jf
    import har_tpu.models as jmodels
    from har_tpu.ops.metrics import evaluate as jax_evaluate
    import har_tpu_torch.features as tf
    import har_tpu_torch.models as tmodels
    from har_tpu_torch.ops.metrics import evaluate

    out = {}
    for key, table, f, models, ev, kw in (
        ("jax", tables[0], jf, jmodels, jax_evaluate, {}),
        ("port", tables[1], tf, tmodels, evaluate, {"device": "cpu"}),
    ):
        pipeline = f.build_wisdm_pipeline()
        full = f.make_feature_set(pipeline.fit(table).transform(table))
        train, test = full.split([0.7, 0.3], seed=2018)
        lr = models.LogisticRegression(max_iter=20, reg_param=0.3, **kw).fit(train)
        dt = models.DecisionTreeClassifier(**kw).fit(train)
        out[key] = dict(
            train=train, test=test, lr=lr, dt=dt,
            lr_eval=ev(test.label, lr.transform(test).raw, num_classes=6),
            dt_labels=dt.transform(test).prediction,
        )
    return out


def test_walkthrough_matches_har_tpu(walkthrough):
    got, want = walkthrough["port"], walkthrough["jax"]
    np.testing.assert_array_equal(got["test"].label, want["test"].label)
    assert set(got["lr_eval"]) == set(want["lr_eval"])
    for key, value in want["lr_eval"].items():
        np.testing.assert_allclose(got["lr_eval"][key], value, rtol=0, atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(got["dt_labels"], want["dt_labels"])


def test_models_satisfy_the_protocols(walkthrough, tmp_path):
    from har_tpu_torch.export import export_model, load_exported
    from har_tpu_torch.models import (
        Classifier,
        ClassifierModel,
        DecisionTreeClassifier,
        LogisticRegression,
        NeuralClassifier,
    )
    from har_tpu_torch.train import TrainerConfig

    run = walkthrough["port"]
    assert isinstance(run["lr"], ClassifierModel)
    assert isinstance(run["dt"], ClassifierModel)
    rng = np.random.default_rng(0)
    train = run["train"].take(rng.permutation(len(run["train"]))[:256])
    est = NeuralClassifier(
        "mlp", config=TrainerConfig(batch_size=64, epochs=1), device="cpu",
        model_kwargs=dict(hidden=(16,)),
    )
    for e in (est, LogisticRegression(device="cpu"), DecisionTreeClassifier(device="cpu")):
        assert isinstance(e, Classifier)
    neural = est.fit(train)
    assert isinstance(neural, ClassifierModel)
    artifact = load_exported(export_model(neural, str(tmp_path / "art")), "cpu")
    assert isinstance(artifact, ClassifierModel)
    np.testing.assert_array_equal(
        artifact.transform(run["test"]).prediction, neural.transform(run["test"]).prediction
    )
    assert not isinstance(object(), ClassifierModel)


# -- make_train_step / make_scan_fit against har_tpu's ------------------------


MODEL = dict(num_classes=4, embed_dim=16, num_heads=2, num_layers=1,
             dropout_rate=0.0, patch_size=4)


@pytest.mark.parametrize("route", ["step", "scan_fit"])
def test_step_factories_match_har_tpu(route):
    """Three steps of a float32 transformer (dropout 0) from the same
    parameters: losses and the trained model's logits within 1e-4 of
    ``har_tpu``'s ``make_train_step`` / ``make_scan_fit``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from har_tpu.models.transformer import Transformer1D as JaxTransformer1D
    from har_tpu.train import trainer as jax_trainer
    from har_tpu_torch.convert import transformer_params_from_flax
    from har_tpu_torch.models.transformer import Transformer1D
    from har_tpu_torch.train import TrainerConfig, make_optimizer, make_train_step
    from har_tpu_torch.train import trainer

    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=16).astype(np.int32)
    mask = np.ones(16, np.float32)
    mask[-3:] = 0.0
    cfg = dict(batch_size=16, epochs=3, learning_rate=1e-2, seed=1)
    steps = 3
    batch_idx = np.stack([rng.permutation(16) for _ in range(steps)]).astype(np.int32)

    jax_module = JaxTransformer1D(dtype=jnp.float32, **MODEL)
    params = jax.tree.map(
        np.array, jax_module.init(jax.random.PRNGKey(5), jnp.asarray(x[:2]))["params"]
    )
    module = Transformer1D(dtype="float32", **MODEL)
    module(torch.from_numpy(x[:2]))
    trainer._load_params(module, transformer_params_from_flax(params))

    jax_opt = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(**cfg), steps)
    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    opt = make_optimizer(TrainerConfig(**cfg), list(module.parameters()), steps)
    p, state, key = jax.tree.map(jnp.asarray, params), jax_opt.init(params), jax.random.PRNGKey(0)
    if route == "step":
        jax_step = jax_trainer.make_train_step(jax_module.apply, jax_opt, mesh)
        step = make_train_step(module, opt)
        want, got = [], []
        for idx in batch_idx:
            p, state, loss = jax_step(p, state, key, x[idx], y[idx], mask[idx])
            want.append(float(loss))
            got.append(float(step(torch.from_numpy(x[idx]), torch.from_numpy(y[idx]).long(),
                                  torch.from_numpy(mask[idx]))))
    else:
        fit = jax_trainer.make_scan_fit(jax_module.apply, jax_opt, mesh)
        p, state, losses = fit(p, state, key, jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(batch_idx), 0)
        want = np.asarray(losses).tolist()
        got = [float(v) for v in trainer.make_scan_fit(module, opt)(
            torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(batch_idx).long()
        )]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    module.eval()
    with torch.no_grad():
        logits = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        logits, np.asarray(jax_module.apply({"params": p}, jnp.asarray(x))), rtol=1e-4, atol=1e-4
    )
