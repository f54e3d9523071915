"""Saved models across both packages, and the trainer's resume and early stop.

``har_tpu_torch.checkpoint`` against ``har_tpu.checkpoint`` on the CPU:
classical artifacts (``arrays.npz``, ``har_meta.json``, ``pipeline.json``)
cross between the packages in both directions with equal arrays, meta and
predictions; ``predict`` CSVs are byte-equal for DT (LR, RF and GBDT:
equal predictions, probabilities within 1e-6); ``evaluate`` returns the
same counts.  A neural artifact's ``params.npz`` is flax's tree: loaded
back it gives bit-equal logits, unflattened into ``har_tpu``'s module
logits within 1e-5.  A crashed and resumed fit equals the unbroken one bit
for bit; early stopping picks the epochs ``har_tpu``'s Trainer picks.
"""

import json
import os

import numpy as np
import pytest
import torch

import har_tpu.checkpoint as jax_ckpt
import har_tpu.runner as jax_runner
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import ModelConfig as JaxModelConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu_torch import checkpoint, convert
from har_tpu_torch.checkpoint import TrainCheckpointer
from har_tpu_torch.config import DataConfig, ModelConfig, RunConfig
from har_tpu_torch.features.scaler import FittedScaler
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.neural import build_model
from har_tpu_torch.models.neural_classifier import NeuralClassifierModel
from har_tpu_torch.train import trainer
from har_tpu_torch.train.trainer import NeuralModel, Trainer, TrainerConfig

torch.set_num_threads(1)

ROWS = 300
CLASSICAL = ("logistic_regression", "decision_tree", "random_forest", "gbdt")
PARAMS = {"num_trees": 8, "num_rounds": 5}
PROB_ATOL = 1e-6


@pytest.fixture(scope="module")
def no_reference_csv(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HAR_TPU_WISDM_CSV", str(tmp_path_factory.mktemp("none") / "absent.csv"))
        yield


@pytest.fixture(scope="module")
def jax_onehot(no_reference_csv):
    """har_tpu's fits of the four classical families on the one-hot view
    of the synthetic table, with the view's fitted pipeline."""
    cfg = JaxRunConfig(data=JaxDataConfig(synthetic_rows=ROWS))
    train, test, pipe = jax_runner.featurize(cfg, jax_runner.load_dataset(cfg))
    models = {
        name: jax_runner.build_estimator(name, PARAMS).fit(train) for name in CLASSICAL
    }
    return models, pipe, test


@pytest.fixture(scope="module")
def jax_saved(no_reference_csv, tmp_path_factory):
    """`har_tpu` train --save-models-dir: the four families on their own
    views, with provenance."""
    base = tmp_path_factory.mktemp("jax_models")
    jax_runner.run(
        JaxRunConfig(data=JaxDataConfig(synthetic_rows=ROWS),
                     model=JaxModelConfig(params=dict(PARAMS)),
                     output_dir=str(base / "out")),
        models=list(CLASSICAL), with_cv=False, save_models_dir=str(base / "models"),
    )
    return base / "models"


def _arrays(path):
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        return {k: npz[k] for k in npz.files}


def _meta(path, drop=("created_unix",)):
    meta = json.loads(open(os.path.join(path, "har_meta.json")).read())
    return {k: v for k, v in meta.items() if k not in drop}


@pytest.mark.parametrize("with_pipeline", [False, True], ids=["bare", "pipeline"])
@pytest.mark.parametrize("name", CLASSICAL)
def test_classical_artifacts_cross_both_ways(jax_onehot, tmp_path, name, with_pipeline):
    models, pipe, test = jax_onehot
    jax_dir = jax_ckpt.save_classical_model(
        str(tmp_path / "jax"), models[name], dataset="wisdm", synthetic_rows=ROWS,
        split_seed=2018, train_fraction=0.7, pipeline=pipe if with_pipeline else None,
    )
    # har_tpu's artifact → the port
    port_model = checkpoint.load_classical_model(jax_dir, device="cpu")
    port_pred = port_model.transform(test).prediction
    np.testing.assert_array_equal(port_pred, np.asarray(models[name].transform(test).prediction))
    # the port's artifact → har_tpu, the pipeline through the port's loader
    port_pipe = (checkpoint.load_pipeline_model(os.path.join(jax_dir, "pipeline.json"))
                 if with_pipeline else None)
    port_dir = checkpoint.save_classical_model(
        str(tmp_path / "port"), port_model, dataset="wisdm", synthetic_rows=ROWS,
        split_seed=2018, train_fraction=0.7, pipeline=port_pipe,
    )
    back = jax_ckpt.load_classical_model(port_dir)
    np.testing.assert_array_equal(np.asarray(back.transform(test).prediction), port_pred)
    a, b = _arrays(jax_dir), _arrays(port_dir)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype
        np.testing.assert_array_equal(a[key], b[key])
    assert _meta(jax_dir) == _meta(port_dir)
    for d in (jax_dir, port_dir):
        assert os.path.exists(os.path.join(d, "pipeline.json")) == with_pipeline
    if with_pipeline:
        assert (open(os.path.join(jax_dir, "pipeline.json")).read()
                == open(os.path.join(port_dir, "pipeline.json")).read())


@pytest.mark.parametrize("name", CLASSICAL)
def test_predict_csv_matches_jax(jax_saved, tmp_path, name):
    """DT: byte-equal CSVs (its probabilities are stored leaf values).
    LR's float32 dot and exp, and RF's and GBDT's sums over trees, round
    otherwise than XLA's CPU code (by an ulp or two): equal predictions,
    probabilities within 1e-6 (byte-equal where they turn out so)."""
    path = str(jax_saved / name)
    jax_csv, port_csv = tmp_path / "jax.csv", tmp_path / "port.csv"
    want = jax_ckpt.predict_checkpoint(path, str(jax_csv))
    got = checkpoint.predict_checkpoint(path, str(port_csv), device="cpu")
    assert {k: v for k, v in got.items() if k != "output"} == {
        k: v for k, v in want.items() if k != "output"}
    jax_text, port_text = jax_csv.read_text(), port_csv.read_text()
    if name == "decision_tree" or jax_text == port_text:
        assert port_text == jax_text
        return
    jax_rows = [r.split(",") for r in jax_text.splitlines()]
    port_rows = [r.split(",") for r in port_text.splitlines()]
    assert jax_rows[0] == port_rows[0]
    assert [r[:3] for r in jax_rows] == [r[:3] for r in port_rows]
    np.testing.assert_allclose(
        np.asarray([r[3:] for r in port_rows[1:]], float),
        np.asarray([r[3:] for r in jax_rows[1:]], float), rtol=0, atol=PROB_ATOL)


@pytest.mark.parametrize("name", CLASSICAL)
def test_evaluate_checkpoint_matches_jax(jax_saved, name):
    path = str(jax_saved / name)
    want = jax_ckpt.evaluate_checkpoint(path)
    got = checkpoint.evaluate_checkpoint(path, device="cpu")
    assert got.keys() == want.keys()
    for key in ("count_correct", "count_wrong", "n_test"):
        assert got[key] == want[key]
    for key in ("accuracy", "f1", "weightedPrecision", "weightedRecall"):
        assert got[key] == pytest.approx(want[key], abs=1e-6)


def test_scoring_guards_raise_jax_messages(jax_saved):
    path = str(jax_saved / "decision_tree")
    for module in (jax_ckpt, checkpoint):
        kwargs = {} if module is jax_ckpt else {"device": "cpu"}
        with pytest.raises(ValueError, match="trained on dataset 'wisdm'"):
            module.evaluate_checkpoint(path, dataset="synthetic", **kwargs)
        with pytest.raises(ValueError, match=f"synthetic_rows={ROWS}"):
            module.evaluate_checkpoint(path, synthetic_rows=ROWS + 1, **kwargs)


def test_old_checkpoints_default_to_bernoulli_split():
    config = checkpoint.scoring_config_from_meta({"model_name": "decision_tree"})
    assert config.data.split_method == "bernoulli"
    assert (config.data.seed, config.data.train_fraction) == (2018, 0.7)


def test_loaders_refuse_cuda_without_a_gpu(jax_saved, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        checkpoint.load_classical_model(str(jax_saved / "decision_tree"))
    with pytest.raises(RuntimeError, match="is_available"):
        checkpoint.evaluate_checkpoint(str(jax_saved / "decision_tree"))


def test_train_saves_name_and_cv_artifacts(tmp_path, no_reference_csv):
    """`run(save_models_dir=)` saves each model and its CV refit; the
    artifacts score what the run scored."""
    from har_tpu_torch import runner

    outcome = runner.run(
        RunConfig(data=DataConfig(synthetic_rows=ROWS),
                  model=ModelConfig(params={"num_trees": 8}),
                  output_dir=str(tmp_path / "out")),
        models=["dt", "rf"], device="cpu", save_models_dir=str(tmp_path / "m"),
    )
    assert sorted(os.listdir(tmp_path / "m")) == [
        "decision_tree", "decision_tree_cv", "random_forest", "random_forest_cv"]
    for name, accuracy in outcome.accuracies.items():
        rep = checkpoint.evaluate_checkpoint(str(tmp_path / "m" / name), device="cpu")
        assert rep["accuracy"] == accuracy
        assert _meta(tmp_path / "m" / name)["split_method"] == "spark"


# --------------------------------------------------------------------------
# neural artifacts

NEURAL = {
    "mlp": (dict(hidden=(16, 8)), (13,)),
    "cnn1d": (dict(channels=(8, 8), norm="rms", pool="stride"), (32, 3)),
    "bilstm": (dict(hidden=8), (16, 3)),
    "transformer": (dict(embed_dim=16, num_heads=2, num_layers=2, patch_size=4,
                         scan_layers=True), (32, 3)),
}


def _random_neural(name, seed=0):
    kwargs, shape = NEURAL[name]
    module = build_model(name, 5, in_features=shape[-1], dtype="float32",
                         dropout_rate=0.0, **kwargs)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():  # nonzero biases and norms: the layouts show
        for p in module.parameters():
            p.add_(torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32)))
    scaler = FittedScaler(mean=rng.normal(size=shape).astype(np.float32),
                          std=rng.uniform(0.5, 2, shape).astype(np.float32))
    model = NeuralClassifierModel(
        inner=NeuralModel(module=module, num_classes=5), scaler=scaler, num_classes=5)
    x = rng.normal(size=(6, *shape)).astype(np.float32)
    return model, dict(kwargs, dtype="float32", dropout_rate=0.0), x


@pytest.mark.parametrize("name", list(NEURAL))
def test_neural_round_trip_bit_equal(tmp_path, name):
    model, kwargs, x = _random_neural(name)
    path = checkpoint.save_model(str(tmp_path / name), model, name, kwargs,
                                 input_shape=x.shape[1:], dataset="wisdm_raw")
    loaded = checkpoint.load_model(path, device="cpu")
    np.testing.assert_array_equal(loaded.transform(x).raw, model.transform(x).raw)
    np.testing.assert_array_equal(loaded.scaler.std, model.scaler.std)
    meta = checkpoint.load_model_meta(path)
    assert meta["input_shape"] == list(x.shape[1:])
    assert checkpoint.version_info(meta)["created_unix"] is not None


@pytest.mark.parametrize("name", list(NEURAL))
def test_neural_params_npz_is_flax_tree(tmp_path, name):
    """params.npz unflattened with numpy and flax.traverse_util alone is
    har_tpu's parameter tree: its module gives the port's logits."""
    import jax.numpy as jnp
    from flax import traverse_util

    from har_tpu.models.neural import build_model as flax_build

    model, kwargs, x = _random_neural(name, seed=1)
    path = checkpoint.save_model(str(tmp_path / name), model, name, kwargs,
                                 input_shape=x.shape[1:])
    with np.load(os.path.join(path, "params.npz")) as npz:
        params = traverse_util.unflatten_dict({k: npz[k] for k in npz.files}, sep="/")
    flax_kwargs = dict(kwargs, dtype=jnp.float32)
    module = flax_build(name, num_classes=5, **flax_kwargs)
    xs = model.scaler.transform(x)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(xs)))
    got = model.inner.predict_logits(xs)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_neural_meta_keys_match_jax(tmp_path):
    model, kwargs, x = _random_neural("mlp")
    path = checkpoint.save_model(
        str(tmp_path / "m"), model, "mlp", kwargs, dataset="wisdm",
        synthetic_rows=ROWS, drop_binned=True, split_method="spark",
        input_shape=x.shape[1:], split_seed=3, train_fraction=0.8, version=2,
        parent_sha256="ab" * 32,
    )
    assert set(checkpoint.load_model_meta(path)) == {
        "model_name", "model_kwargs", "num_classes", "version", "parent_sha256",
        "created_unix", "dataset", "synthetic_rows", "drop_binned", "split_method",
        "input_shape", "split_seed", "train_fraction", "scaler"}


def test_orbax_checkpoint_is_refused(tmp_path):
    os.makedirs(tmp_path / "params")
    (tmp_path / "har_meta.json").write_text(json.dumps(
        {"model_name": "mlp", "model_kwargs": {}, "num_classes": 6}))
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.load_model(str(tmp_path), device="cpu")


# --------------------------------------------------------------------------
# resume


def _resume_data(n=96, d=8, c=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(d, c))
    return x, (x @ w).argmax(1).astype(np.int32)


def _raw_data(n=48, t=16, c=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    x = rng.normal(size=(n, t, 3)).astype(np.float32) + y[:, None, None] * 0.5
    return x, y


RESUME_CASES = {
    "mlp": (lambda: build_model("mlp", 4, in_features=8, hidden=(16,),
                                dropout_rate=0.0, dtype="float32"), None, _resume_data),
    "mlp_dropout": (lambda: build_model("mlp", 4, in_features=8, hidden=(16,),
                                        dropout_rate=0.3, dtype="float32"), None,
                    _resume_data),
    "cnn1d_augment_dropout": (
        lambda: build_model("cnn1d", 4, in_features=3, channels=(8,),
                            dropout_rate=0.3, dtype="float32"),
        "raw_windows", _raw_data),
}


def _crash_after_first_save(monkeypatch):
    saves = []
    orig = TrainCheckpointer.save

    def crashing_save(self, epoch, params, opt_state, extra=None):
        orig(self, epoch, params, opt_state, extra)
        saves.append(epoch)
        raise RuntimeError("simulated crash")

    monkeypatch.setattr(TrainCheckpointer, "save", crashing_save)
    return saves


@pytest.mark.parametrize("case", list(RESUME_CASES))
def test_resumed_training_equals_uninterrupted(tmp_path, monkeypatch, case):
    """Crash the 6-epoch run right after its first 2-epoch snapshot, then
    resume: losses and parameters bit-equal to the unbroken run."""
    from har_tpu_torch.data.augment import build_augment

    make, augment, data = RESUME_CASES[case]
    x, y = data()
    mk = lambda **kw: Trainer(  # noqa: E731
        make(), TrainerConfig(batch_size=32, epochs=6, learning_rate=1e-2, seed=7, **kw),
        device="cpu", augment=build_augment(augment))
    straight = mk().fit(x, y)
    ckdir = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        saves = _crash_after_first_save(m)
        with pytest.raises(RuntimeError, match="simulated crash"):
            mk(checkpoint_dir=ckdir, save_every_epochs=2).fit(x, y)
    assert saves == [2]
    resumed = mk(checkpoint_dir=ckdir, save_every_epochs=2).fit(x, y)
    assert resumed.history["resumed_from_epoch"] == 2
    assert resumed.history["loss"] == straight.history["loss"][2:]
    for (k, a), b in zip(straight.module.state_dict().items(),
                         resumed.module.state_dict().values()):
        assert torch.equal(a, b), k


def test_chunked_run_equals_single_run(tmp_path):
    x, y = _resume_data(seed=1)
    mk = lambda **kw: Trainer(  # noqa: E731
        build_model("mlp", 4, in_features=8, hidden=(16,), dtype="float32"),
        TrainerConfig(batch_size=32, epochs=4, learning_rate=1e-2, seed=9, **kw),
        device="cpu")
    one = mk().fit(x, y)
    chunked = mk(checkpoint_dir=str(tmp_path / "ck"), save_every_epochs=2).fit(x, y)
    assert chunked.history["loss"] == one.history["loss"]
    for a, b in zip(one.module.state_dict().values(), chunked.module.state_dict().values()):
        assert torch.equal(a, b)
    slot = os.listdir(tmp_path / "ck")
    assert len(slot) == 1
    assert TrainCheckpointer(str(tmp_path / "ck" / slot[0])).epochs() == [2, 4]


def test_checkpoint_slots_keyed_by_data_config_and_model(tmp_path):
    ckdir = str(tmp_path / "shared")
    mk = lambda batch=32, dropout=0.0: Trainer(  # noqa: E731
        build_model("mlp", 4, in_features=8, hidden=(8,), dropout_rate=dropout),
        TrainerConfig(batch_size=batch, epochs=2, learning_rate=1e-2, seed=7,
                      checkpoint_dir=ckdir, save_every_epochs=2), device="cpu")
    x1, y1 = _resume_data(seed=0)
    x2, y2 = _resume_data(seed=9)
    assert mk().fit(x1, y1).history["resumed_from_epoch"] == 0
    assert mk().fit(x2, y2).history["resumed_from_epoch"] == 0  # other data
    again = mk().fit(x1, y1)  # the identical run resumes, trains nothing
    assert again.history["resumed_from_epoch"] == 2 and again.history["loss"] == []
    assert mk(batch=16).fit(x1, y1).history["resumed_from_epoch"] == 0  # schedule
    assert mk(dropout=0.3).fit(x1, y1).history["resumed_from_epoch"] == 0  # model


def test_checkpointer_keeps_newest_and_writes_atomically(tmp_path):
    ck = TrainCheckpointer(str(tmp_path), keep=3)
    for epoch in range(1, 6):
        ck.save(epoch, {"w": torch.full((2,), float(epoch))}, {"count": epoch},
                extra={"bad": epoch})
    assert ck.epochs() == [3, 4, 5]
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    epoch, params, opt_state, extra = ck.restore(with_extra=True)
    assert (epoch, opt_state, extra) == (5, {"count": 5}, {"bad": 5})
    assert torch.equal(params["w"], torch.full((2,), 5.0))
    assert ck.restore(3)[0] == 3
    assert TrainCheckpointer(str(tmp_path / "empty")).restore() is None


@pytest.mark.parametrize("cfg, match", [
    (dict(save_every_epochs=2), "checkpoint_dir"),
    (dict(checkpoint_dir="unused", save_every_epochs=-1), ">= 0"),
    (dict(early_stop_patience=-1), ">= 0"),
    (dict(early_stop_patience=2, validation_fraction=1.0), "validation_fraction"),
], ids=["save_every_without_dir", "negative_save_every", "negative_patience",
        "validation_fraction"])
def test_bad_checkpoint_options_raise(cfg, match):
    x, y = _resume_data()
    with pytest.raises(ValueError, match=match):
        Trainer(build_model("mlp", 4, in_features=8), TrainerConfig(**cfg),
                device="cpu").fit(x, y)


# --------------------------------------------------------------------------
# early stopping against har_tpu's Trainer


def _separable(n=160, d=6, c=3, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    centers = rng.normal(scale=3.0, size=(c, d))
    x = (centers[y] + rng.normal(scale=1.2, size=(n, d))).astype(np.float32)
    return x, y


EARLY = dict(batch_size=32, epochs=12, learning_rate=3e-2, seed=3,
             early_stop_patience=2, validation_fraction=0.25)


def test_early_stopping_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from har_tpu.models.neural import MLP as FlaxMLP
    from har_tpu.train.trainer import Trainer as JaxTrainer
    from har_tpu.train.trainer import TrainerConfig as JaxTrainerConfig

    x, y = _separable()
    flax_module = FlaxMLP(num_classes=3, hidden=(16,), dropout_rate=0.0, dtype=jnp.float32)
    init = flax_module.init(jax.random.PRNGKey(5), jnp.asarray(x[:2]))["params"]
    init_sd = convert.mlp_params_from_flax(init)  # before the JAX fit donates it
    jax_fit = JaxTrainer(flax_module, JaxTrainerConfig(**EARLY)).fit(
        x, y, num_classes=3, init_params=init)
    cfg = TrainerConfig(**EARLY)
    port_fit = Trainer(build_model("mlp", 3, in_features=6, hidden=(16,), dropout_rate=0.0,
                                   dtype="float32"), cfg, device="cpu").fit(
        x, y, num_classes=3, init_params=init_sd)
    h_jax, h_port = jax_fit.history, port_fit.history
    assert h_port["val_accuracy"] == h_jax["val_accuracy"]
    assert (h_port["best_epoch"], h_port["stopped_epoch"]) == (
        h_jax["best_epoch"], h_jax["stopped_epoch"])
    assert h_port["stopped_epoch"] < EARLY["epochs"]  # it did stop early
    want = convert.mlp_params_from_flax(jax.device_get(jax_fit.params))
    for k, v in port_fit.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5)


def test_early_stop_returns_best_epoch_and_resume_trains_nothing(tmp_path):
    x, y = _separable(seed=1)
    ckdir = str(tmp_path / "ck")
    snapshots = {}
    orig = TrainCheckpointer.save

    def recording_save(self, epoch, params, opt_state, extra=None):
        snapshots[epoch] = extra
        orig(self, epoch, params, opt_state, extra)

    mk = lambda: Trainer(  # noqa: E731
        build_model("mlp", 3, in_features=6, hidden=(16,), dropout_rate=0.0,
                    dtype="float32"),
        TrainerConfig(**EARLY, checkpoint_dir=ckdir), device="cpu")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(TrainCheckpointer, "save", recording_save)
        first = mk().fit(x, y)
    h = first.history
    assert h["stopped_epoch"] == h["best_epoch"] + EARLY["early_stop_patience"]
    assert h["val_accuracy"][h["best_epoch"] - 1] == max(h["val_accuracy"])
    best = snapshots[h["stopped_epoch"]]["best_params"]
    for k, v in first.module.state_dict().items():
        assert torch.equal(v, best[k])
    again = mk().fit(x, y)
    assert again.history["resumed_from_epoch"] == h["stopped_epoch"]
    assert again.history["loss"] == [] and again.history["val_accuracy"] == []
    assert again.history["best_epoch"] == h["best_epoch"]
    for a, b in zip(first.module.state_dict().values(), again.module.state_dict().values()):
        assert torch.equal(a, b)


def test_fingerprint_keys_warm_start_and_freeze():
    x, y = _resume_data()
    cfg = TrainerConfig(batch_size=32, epochs=2)
    module = build_model("mlp", 4, in_features=8, hidden=(8,))
    keys = {
        trainer._run_fingerprint(cfg, x, y, module),
        trainer._run_fingerprint(cfg, x, y, module, warm_start_digest="a"),
        trainer._run_fingerprint(cfg, x, y, module, warm_start_digest="b"),
        trainer._run_fingerprint(cfg, x, y, module, warm_start_digest="a",
                                 optimizer_tag="freeze:['ConvBlock_0']"),
        trainer._run_fingerprint(cfg, x, y, build_model("mlp", 4, in_features=8,
                                                        hidden=(8,), dropout_rate=0.3)),
    }
    assert len(keys) == 5
    assert trainer._run_fingerprint(cfg, x, y, module) == trainer._run_fingerprint(
        cfg, x.copy(), y.copy(), build_model("mlp", 4, in_features=8, hidden=(8,)))


def test_feature_set_round_trip_through_scaler(tmp_path):
    """A fitted NeuralClassifier saves and loads through the CLI's
    provenance: evaluate scores the saved model on its own rows."""
    from har_tpu_torch import runner

    cfg = RunConfig(data=DataConfig(dataset="synthetic", seed=5, synthetic_rows=200),
                    model=ModelConfig(name="mlp"))
    train, test, _ = runner.featurize(cfg, runner.load_dataset(cfg), "cpu")
    model = runner.build_estimator("mlp", {"epochs": 1, "batch_size": 64,
                                           "hidden": (8,)}, "cpu").fit(train)
    path = checkpoint.save_model(str(tmp_path / "ck"), model, "mlp", {"hidden": (8,)},
                                 dataset="synthetic", synthetic_rows=200,
                                 input_shape=train.features.shape[1:], split_seed=5)
    rep = checkpoint.evaluate_checkpoint(path, device="cpu")
    preds = model.transform(FeatureSet(features=test.features, label=test.label))
    assert rep["count_correct"] == int((preds.prediction == test.label).sum())
    with pytest.raises(ValueError, match="synthetic_rows=200"):
        checkpoint.evaluate_checkpoint(path, synthetic_rows=300, device="cpu")


@pytest.mark.parametrize("flags, drop_binned", [([], True), (["--keep-binned"], False)],
                         ids=["default", "keep_binned"])
def test_cli_records_the_feature_view(tmp_path, capsys, monkeypatch, flags, drop_binned):
    """`train --save-models-dir [--keep-binned]`: the artifact records
    the view, and `evaluate` re-derives it."""
    from har_tpu_torch import cli, runner

    monkeypatch.setenv("HAR_TPU_WISDM_CSV", str(tmp_path / "absent.csv"))
    monkeypatch.setattr(runner, "effective_synthetic_rows", lambda data: ROWS)
    assert cli.main(["train", "--models", "gbt", "--no-cv", "--device", "cpu",
                     "--save-models-dir", str(tmp_path / "m"),
                     "--output-dir", str(tmp_path / "o"), *flags]) == 0
    trained = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    meta = checkpoint.load_model_meta(str(tmp_path / "m" / "gbdt"))
    assert (meta["drop_binned"], meta["synthetic_rows"]) == (drop_binned, ROWS)
    rep = checkpoint.evaluate_checkpoint(str(tmp_path / "m" / "gbdt"), device="cpu")
    assert rep["accuracy"] == trained["accuracies"]["gbdt"]
