"""The port's UCI-HAR lane against the JAX package.

Both packages write the same "UCI HAR Dataset" fixture tree byte for byte,
load the same table from it bit for bit, and derive the same features,
labels and Bernoulli split.  On a few hundred rows and 32 features,
``train --dataset ucihar --device cpu`` grows the same decision tree,
fits LR within the LR tests' tolerance, boosts trees whose labels agree on
all test rows but at most one, and writes a result.txt of the same
structure; the MLP's logits from ``har_tpu``'s fitted parameters agree
within 1e-5.  Saved UCI-HAR models score the same in either package.
"""

import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import har_tpu.runner as jax_runner
from har_tpu import checkpoint as jax_checkpoint
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import ModelConfig as JaxModelConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu.data import ucihar as jax_ucihar
from har_tpu.models.gbdt import GradientBoostedTreesClassifier as JaxGBDT
from har_tpu.models.logistic_regression import LogisticRegression as JaxLR
from har_tpu.models.neural_classifier import NeuralClassifier as JaxNeural
from har_tpu.models.tree import DecisionTreeClassifier as JaxTree
from har_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from har_tpu_torch import checkpoint, cli, convert
from har_tpu_torch import runner as port_runner
from har_tpu_torch.config import DataConfig, ModelConfig, RunConfig
from har_tpu_torch.data import ucihar
from har_tpu_torch.models.gbdt import GradientBoostedTreesClassifier
from har_tpu_torch.models.logistic_regression import LogisticRegression
from har_tpu_torch.models.neural import MLP
from har_tpu_torch.models.tree import DecisionTreeClassifier

torch.set_num_threads(1)

N_TRAIN, N_TEST, FEATURES = 200, 100, 32
# the LR tests' tolerance (tests/test_torch_logistic_regression.py)
LR_LOSS_RTOL, LR_COEF_ATOL = 1e-5, 1e-3
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
PARAMS = {"num_rounds": 5, "epochs": 2, "hidden": (16,), "num_trees": 8}


@pytest.fixture(scope="module")
def tree_root(tmp_path_factory):
    return ucihar.write_ucihar_fixture(
        str(tmp_path_factory.mktemp("uci")), n_train=N_TRAIN, n_test=N_TEST,
        seed=1, num_features=FEATURES,
    )


@pytest.fixture(scope="module")
def views(tree_root):
    """(JAX train, JAX test, port train, port test) from each package's
    runner on the fixture tree."""
    jax_cfg = JaxRunConfig(data=JaxDataConfig(dataset="ucihar", path=tree_root))
    port_cfg = RunConfig(data=DataConfig(dataset="ucihar", path=tree_root))
    jtr, jte, jpipe = jax_runner.featurize(jax_cfg, jax_runner.load_dataset(jax_cfg))
    ptr, pte, ppipe = port_runner.featurize(port_cfg, port_runner.load_dataset(port_cfg),
                                            "cpu")
    assert jpipe is None and ppipe is None
    return jtr, jte, ptr, pte


def _tree_files(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _, files in os.walk(root) for f in files
    )


@pytest.mark.parametrize("num_features", [561, 16])
def test_fixture_trees_byte_equal(tmp_path, num_features):
    theirs = jax_ucihar.write_ucihar_fixture(
        str(tmp_path / "jax"), n_train=12, n_test=6, seed=3, num_features=num_features)
    ours = ucihar.write_ucihar_fixture(
        str(tmp_path / "port"), n_train=12, n_test=6, seed=3, num_features=num_features)
    assert os.path.basename(ours) == os.path.basename(theirs) == "UCI HAR Dataset"
    files = _tree_files(theirs)
    assert files == _tree_files(ours) and len(files) == 8
    match, mismatch, errors = filecmp.cmpfiles(theirs, ours, files, shallow=False)
    assert mismatch == [] and errors == [] and match == files


def _assert_tables_equal(ours, theirs):
    assert ours.column_names == theirs.column_names
    assert [t.value for t in ours.schema.types] == [t.value for t in theirs.schema.types]
    for name in theirs.column_names:
        a, b = np.asarray(ours[name]), np.asarray(theirs[name])
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("split", ["all", "train", "test"])
def test_loaded_tables_bit_equal(tree_root, split):
    ours = ucihar.load_ucihar(os.path.dirname(tree_root), split)
    theirs = jax_ucihar.load_ucihar(os.path.dirname(tree_root), split)
    assert len(ours) == {"all": 300, "train": 200, "test": 100}[split]
    _assert_tables_equal(ours, theirs)


def test_synthetic_tables_bit_equal():
    _assert_tables_equal(ucihar.synthetic_ucihar(50, seed=4),
                         jax_ucihar.synthetic_ucihar(50, seed=4))


def test_feature_sets_equal(tree_root):
    ours = ucihar.ucihar_feature_set(ucihar.load_ucihar(tree_root))
    theirs = jax_ucihar.ucihar_feature_set(jax_ucihar.load_ucihar(tree_root))
    assert ours.features.dtype == np.float32 and ours.label.dtype == np.int32
    np.testing.assert_array_equal(ours.features, theirs.features)
    np.testing.assert_array_equal(ours.label, theirs.label)
    assert ours.class_names is None and theirs.class_names is None


def test_labels_on_tied_class_counts_equal():
    """Label ids follow the indexer's frequency order, ties broken by name:
    LAYING and WALKING have 3 rows, SITTING and WALKING_UPSTAIRS 2."""
    y = np.array([6, 6, 6, 1, 1, 1, 4, 4, 2, 2])
    x = np.arange(20, dtype=np.float64).reshape(10, 2)
    ours = ucihar.ucihar_feature_set(ucihar._to_table(x, y))
    theirs = jax_ucihar.ucihar_feature_set(jax_ucihar._to_table(x, y))
    np.testing.assert_array_equal(ours.label, theirs.label)
    assert ours.label.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 3, 3]


@pytest.mark.parametrize(
    "value", [0.28858451, -0.9952786, 1.0, 2.5e-12, 0.0, -0.0, 9.99999995, 1e100, -3.3e-101])
def test_value_format_equal(value):
    assert ucihar.format_ucihar_value(value) == jax_ucihar.format_ucihar_value(value)


def test_loader_refusals_match(tmp_path, monkeypatch):
    base = ucihar.write_ucihar_fixture(str(tmp_path), n_train=4, n_test=2,
                                       num_features=16)
    with open(f"{base}/features.txt", "a") as f:
        f.write("17 extra()\n")
    for module in (ucihar, jax_ucihar):
        with pytest.raises(ValueError, match="features.txt"):
            module.load_ucihar(base)
        with pytest.raises(FileNotFoundError, match="X_train.txt"):
            module.load_ucihar(str(tmp_path / "nowhere"))
    # the same probe order: the variable, then ./, ./data and ~/data
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("HAR_TPU_UCIHAR_ROOT", raising=False)
    assert ucihar.resolve_ucihar_root() == jax_ucihar.resolve_ucihar_root() == os.path.join(
        ".", "UCI HAR Dataset")
    monkeypatch.setenv("HAR_TPU_UCIHAR_ROOT", base)
    assert ucihar.resolve_ucihar_root() == jax_ucihar.resolve_ucihar_root() == base
    monkeypatch.chdir(tmp_path / "UCI HAR Dataset" / "train")
    monkeypatch.delenv("HAR_TPU_UCIHAR_ROOT")
    assert ucihar.resolve_ucihar_root() is None
    assert jax_ucihar.resolve_ucihar_root() is None


def test_split_and_features_equal(views):
    jtr, jte, ptr, pte = views
    assert (len(ptr), len(pte)) == (len(jtr), len(jte))
    assert len(ptr) + len(pte) == N_TRAIN + N_TEST
    for ours, theirs in ((ptr, jtr), (pte, jte)):
        np.testing.assert_array_equal(ours.features, theirs.features)
        np.testing.assert_array_equal(ours.label, theirs.label)


def test_decision_tree_bit_identical(views):
    jtr, jte, ptr, pte = views
    theirs = JaxTree(use_pallas_hist=False).fit(jtr)
    ours = DecisionTreeClassifier(device="cpu").fit(ptr)
    for field in ("feature", "threshold", "leaf_class", "leaf_probs", "leaf_counts"):
        np.testing.assert_array_equal(getattr(ours.tree, field),
                                      np.asarray(getattr(theirs.tree, field)), err_msg=field)
    np.testing.assert_array_equal(ours.transform(pte).prediction,
                                  np.asarray(theirs.transform(jte).prediction))


@pytest.mark.parametrize("kw", [{}, {"elastic_net_param": 0.2, "reg_param": 0.1}],
                         ids=["lbfgs", "fista"])
def test_logistic_regression_within_tolerance(views, kw):
    jtr, jte, ptr, pte = views
    theirs = JaxLR(**kw).fit(jtr)
    ours = LogisticRegression(device="cpu", **kw).fit(ptr)
    np.testing.assert_allclose(ours.losses, np.asarray(theirs.losses), rtol=LR_LOSS_RTOL)
    np.testing.assert_allclose(ours.coefficients, np.asarray(theirs.coefficients),
                               rtol=0, atol=LR_COEF_ATOL)
    np.testing.assert_array_equal(ours.transform(pte).prediction,
                                  np.asarray(theirs.transform(jte).prediction))


def test_gbdt_labels_agree(views):
    jtr, jte, ptr, pte = views
    theirs = JaxGBDT(num_rounds=10).fit(jtr).transform(jte).prediction
    ours = GradientBoostedTreesClassifier(num_rounds=10, device="cpu").fit(ptr)
    differ = int((ours.transform(pte).prediction != np.asarray(theirs)).sum())
    assert differ <= 1, differ


def test_mlp_logits_from_jax_parameters(views):
    jtr, jte, _, pte = views
    fitted = JaxNeural(
        "mlp", config=JaxTrainerConfig(epochs=2, batch_size=64),
        model_kwargs={"hidden": (16,), "dtype": jnp.float32},
    ).fit(jtr)
    x = fitted.scaler.transform(np.asarray(jte.features, np.float32))
    want = fitted.inner.predict_logits(x)
    port = MLP(num_classes=6, hidden=(16,), dtype="float32", in_features=FEATURES)
    port.load_state_dict(convert.mlp_params_from_flax(fitted.inner.params))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(np.asarray(x, np.float32))).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_array_equal(np.asarray(pte.features), np.asarray(jte.features))


def _report_parts(path):
    """result.txt up to the first model block, uid masked, and then each
    block's model line and metric names (a fit's digits may differ)."""
    import re

    def masked(line):
        return re.sub(r"(trained in|made in) \S+ seconds", r"\1 <t> seconds",
                      re.sub(r"_[0-9a-f]{20}\b", "_<uid>", line))

    lines = (path / "result.txt").read_text().splitlines()
    start = next(i for i, ln in enumerate(lines) if "CLASSIFICATION AND EVALUATION" in ln)
    models = [masked(lines[i - 1]) for i, ln in enumerate(lines)
              if ln.startswith("Classifier trained in")]
    metrics = [ln.split(":")[0] for ln in lines[start:] if "-: " in ln]
    return [masked(ln) for ln in lines[:start]], models, metrics


def test_train_run_matches_jax(tree_root, tmp_path):
    """`run(models=lr dt rf gbt mlp, with_cv=False)` on the tree: the same
    report structure, DT's and LR's accuracies (LR within one row)."""
    models = ["lr", "dt", "rf", "gbt", "mlp"]
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    theirs = jax_runner.run(
        JaxRunConfig(data=JaxDataConfig(dataset="ucihar", path=tree_root),
                     model=JaxModelConfig(params=dict(PARAMS)), output_dir=str(jax_out)),
        models=models, with_cv=False)
    ours = port_runner.run(
        RunConfig(data=DataConfig(dataset="ucihar", path=tree_root),
                  model=ModelConfig(params=dict(PARAMS)), output_dir=str(port_out)),
        models=models, with_cv=False, device="cpu")
    assert _report_parts(port_out) == _report_parts(jax_out)
    acc, want = ours.accuracies, theirs.accuracies
    assert set(acc) == set(want) == {"logistic_regression", "decision_tree",
                                     "random_forest", "gbdt", "mlp"}
    assert acc["decision_tree"] == want["decision_tree"]
    assert abs(acc["logistic_regression"] - want["logistic_regression"]) <= 1.0 / N_TEST
    text = (port_out / "result.txt").read_text()
    assert "MODELING PIPELINE" not in text and "FEAT_560" not in text


def test_cli_train_ucihar_with_cv_on_the_cpu(tree_root, tmp_path, capsys):
    rc = cli.main(["train", "--dataset", "ucihar", "--data-path", tree_root,
                   "--models", "dt", "--device", "cpu", "--output-dir", str(tmp_path)])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed["accuracies"]) == {"decision_tree", "decision_tree_cv"}
    for name in ("result.txt", "additional_param.csv",
                 "crossFold_additional_param.csv", "timing.csv"):
        assert (tmp_path / name).is_file()


def test_synthetic_ucihar_default_rows():
    """Without a path, ucihar is the 2,000-row synthetic table in both
    packages, and a saved model records that row count."""
    cfg = DataConfig(dataset="ucihar")
    assert port_runner.effective_synthetic_rows(cfg) == 2000
    assert jax_runner.effective_synthetic_rows(JaxDataConfig(dataset="ucihar")) == 2000
    table = port_runner.load_dataset(RunConfig(data=DataConfig(dataset="ucihar",
                                                               synthetic_rows=40)))
    _assert_tables_equal(table, jax_ucihar.synthetic_ucihar(40, seed=2018))


def test_spark_split_refused_on_ucihar(tmp_path):
    config = RunConfig(data=DataConfig(dataset="ucihar", synthetic_rows=40,
                                       split_method="spark"), output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="WISDM randomSplit"):
        port_runner.run(config, models=["dt"], with_cv=False, device="cpu")


@pytest.fixture(scope="module")
def saved(tree_root, tmp_path_factory):
    """DT and LR trained on the tree and saved by each package."""
    base = tmp_path_factory.mktemp("saved")
    jax_runner.run(
        JaxRunConfig(data=JaxDataConfig(dataset="ucihar", path=tree_root),
                     output_dir=str(base / "jax_out")),
        models=["dt", "lr"], with_cv=False, save_models_dir=str(base / "jax"))
    port_runner.run(
        RunConfig(data=DataConfig(dataset="ucihar", path=tree_root),
                  output_dir=str(base / "port_out")),
        models=["dt", "lr"], with_cv=False, device="cpu",
        save_models_dir=str(base / "port"))
    return base


@pytest.mark.parametrize("saver", ["jax", "port"])
@pytest.mark.parametrize("name", ["decision_tree", "logistic_regression"])
def test_saved_models_score_alike(saved, tree_root, saver, name):
    path = str(saved / saver / name)
    ours = checkpoint.evaluate_checkpoint(path, tree_root, device="cpu")
    theirs = jax_checkpoint.evaluate_checkpoint(path, tree_root)
    assert ours["n_test"] == theirs["n_test"] > 0
    assert ours["count_correct"] == theirs["count_correct"]
    meta = checkpoint.load_model_meta(path)
    assert meta["dataset"] == "ucihar" and meta["split_method"] == "bernoulli"
    assert meta.get("synthetic_rows") is None


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_dt_predictions_csv_byte_equal(saved, tree_root, tmp_path, saver):
    path = str(saved / saver / "decision_tree")
    rc = cli.main(["predict", "--checkpoint", path, "--data-path", tree_root,
                   "--dataset", "ucihar", "--device", "cpu",
                   "--output", str(tmp_path / "port.csv")])
    assert rc == 0
    jax_checkpoint.predict_checkpoint(path, str(tmp_path / "jax.csv"), tree_root)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_cli_evaluate_ucihar(saved, tree_root, capsys):
    rc = cli.main(["evaluate", "--checkpoint", str(saved / "port" / "decision_tree"),
                   "--dataset", "ucihar", "--data-path", tree_root, "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_checkpoint.evaluate_checkpoint(str(saved / "port" / "decision_tree"),
                                              tree_root)
    assert out["accuracy"] == want["accuracy"]
    with pytest.raises(ValueError, match="trained on dataset 'ucihar'"):
        cli.main(["evaluate", "--checkpoint", str(saved / "port" / "decision_tree"),
                  "--dataset", "wisdm", "--device", "cpu"])


def test_ucihar_entry_points_need_cuda_unless_cpu(tree_root, saved, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (
        ["train", "--dataset", "ucihar", "--data-path", tree_root, "--models", "dt",
         "--no-cv", "--output-dir", str(tmp_path)],
        ["evaluate", "--checkpoint", str(saved / "port" / "decision_tree"),
         "--data-path", tree_root],
        ["predict", "--checkpoint", str(saved / "port" / "decision_tree"),
         "--data-path", tree_root, "--output", str(tmp_path / "p.csv")],
    ):
        with pytest.raises(RuntimeError, match="is_available"):
            cli.main(argv)
    assert not (tmp_path / "result.txt").exists()


def test_cli_finetune_ucihar(tree_root, tmp_path, capsys):
    """An MLP trained on the tree, saved, then fine-tuned on it from the
    CLI: the scores before and after are on the recorded split."""
    rc = cli.main(["train", "--dataset", "ucihar", "--data-path", tree_root,
                   "--models", "mlp", "--no-cv", "--epochs", "1", "--device", "cpu",
                   "--output-dir", str(tmp_path / "out"),
                   "--save-models-dir", str(tmp_path / "models")])
    assert rc == 0
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rc = cli.main(["finetune", "--checkpoint", str(tmp_path / "models" / "mlp"),
                   "--dataset", "ucihar", "--data-path", tree_root, "--epochs", "1",
                   "--freeze", "Dense_0", "--device", "cpu",
                   "--output", str(tmp_path / "tuned")])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["accuracy_before"] == round(trained["accuracies"]["mlp"], 4)
    assert out["frozen"] == ["Dense_0"]
    assert checkpoint.load_model_meta(str(tmp_path / "tuned"))["dataset"] == "ucihar"
