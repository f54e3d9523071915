"""Transfer learning in the port (``har_tpu_torch.transfer``).

Contracts, as ``tests/test_transfer.py`` holds them for ``har_tpu``:
frozen subtrees (named as flax names them) are bit-identical after
fine-tuning while the head moves, unknown names and out-of-range labels
raise, an architecture mismatch fails loudly, warm starts and freeze sets
key their own checkpoint slots; and three steps from parameters carried
over from flax lie within 1e-4 of ``har_tpu.transfer.fine_tune``.  The CLI
round trip trains, saves, evaluates, predicts and fine-tunes on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from har_tpu_torch import checkpoint, cli, convert, transfer
from har_tpu_torch.data.raw_windows import synthetic_raw_stream
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.neural import build_model
from har_tpu_torch.models.neural_classifier import NeuralClassifier, NeuralClassifierModel
from har_tpu_torch.train.trainer import NeuralModel, TrainerConfig

torch.set_num_threads(1)

CHANNELS = (8, 8)


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    raw = synthetic_raw_stream(n_windows=128, seed=0)
    model = NeuralClassifier(
        "cnn1d", config=TrainerConfig(batch_size=64, epochs=2, learning_rate=2e-3),
        model_kwargs={"channels": CHANNELS}, device="cpu",
    ).fit(FeatureSet(features=raw.windows, label=raw.labels.astype(np.int32)))
    ckpt = checkpoint.save_model(
        str(tmp_path_factory.mktemp("ckpt") / "cnn1d"), model, "cnn1d",
        model_kwargs={"channels": CHANNELS}, input_shape=(200, 3))
    return ckpt, model, raw


def _adapt(n=64, seed=4):
    new = synthetic_raw_stream(n_windows=n, seed=seed)
    return FeatureSet(features=new.windows * 1.3, label=new.labels.astype(np.int32))


def test_freeze_keeps_subtrees_bit_identical(pretrained):
    ckpt, _, _ = pretrained
    saved = checkpoint.load_model(ckpt, device="cpu").inner.module.state_dict()
    tuned = transfer.fine_tune(
        ckpt, _adapt(), TrainerConfig(batch_size=32, epochs=2, learning_rate=1e-3),
        freeze=("ConvBlock_0", "ConvBlock_1"), device="cpu")
    after = tuned.inner.module.state_dict()
    frozen = [k for k in after if k.startswith("blocks.")]
    assert frozen
    for k in frozen:
        assert torch.equal(after[k], saved[k]), k
    for k in ("head.weight", "fc.weight"):
        assert not torch.equal(after[k], saved[k])
    np.testing.assert_array_equal(tuned.scaler.mean, pretrained[1].scaler.mean)


def test_fine_tune_leaves_the_given_model_alone(pretrained):
    ckpt, model, _ = pretrained
    before = {k: v.clone() for k, v in model.inner.module.state_dict().items()}
    transfer.fine_tune(ckpt, _adapt(32), TrainerConfig(batch_size=32, epochs=1),
                       model=model, device="cpu")
    for k, v in model.inner.module.state_dict().items():
        assert torch.equal(v, before[k])


def test_freeze_mask_validation(pretrained):
    module = pretrained[1].inner.module
    with pytest.raises(ValueError, match="not in params"):
        transfer.freeze_mask(module, ("NoSuchBlock",))
    mask = transfer.freeze_mask(module, ("ConvBlock_0", "Dense_1"))
    assert [k for k, on in mask.items() if not on] == [
        "blocks.0.weight", "blocks.0.bias", "blocks.0.norm.weight", "blocks.0.norm.bias",
        "head.weight", "head.bias"]


@pytest.mark.parametrize("name, kwargs, frozen, want", [
    ("mlp", dict(hidden=(8, 8)), "Dense_2", ["head.weight", "head.bias"]),
    ("bilstm", dict(hidden=4), "FusedBiLSTMLayer_0",
     ["layers.0.wx", "layers.0.wh", "layers.0.bias"]),
    ("transformer", dict(embed_dim=8, num_heads=2, num_layers=2), "LayerNorm_0",
     ["norm.weight", "norm.bias"]),
    ("transformer", dict(embed_dim=8, num_heads=2, num_layers=2, scan_layers=True),
     "blocks", None),
], ids=["mlp_head", "bilstm_layer", "transformer_norm", "transformer_scanned_blocks"])
def test_freeze_names_follow_flax(name, kwargs, frozen, want):
    """Every name a family's flax tree has at its top is accepted, and no
    other: the table's names are the converter's."""
    module = build_model(name, 4, in_features=3, **kwargs)
    tree = convert.neural_params_to_flax(name, module)
    assert set(convert.flax_module_prefixes(name, module)) == set(tree)
    mask = transfer.freeze_mask(module, (frozen,))
    off = [k for k, on in mask.items() if not on]
    if want is None:
        want = [k for k in mask if k.startswith("blocks.")]
    assert off == want


def test_label_range_guard(pretrained):
    ckpt, model, raw = pretrained
    bad = FeatureSet(features=raw.windows[:32],
                     label=np.full(32, model.num_classes, np.int32))
    with pytest.raises(ValueError, match="classes"):
        transfer.fine_tune(ckpt, bad, TrainerConfig(batch_size=32, epochs=1),
                           device="cpu")


def test_architecture_mismatch_fails_loudly(pretrained, tmp_path):
    ckpt, model, raw = pretrained
    other = NeuralClassifier(
        "cnn1d", config=TrainerConfig(batch_size=64, epochs=1),
        model_kwargs={"channels": (4, 4)}, device="cpu",
    ).fit(FeatureSet(features=raw.windows[:64], label=raw.labels[:64].astype(np.int32)))
    from har_tpu_torch.train.trainer import Trainer

    with pytest.raises(ValueError, match="shapes"):
        Trainer(model.inner.module, TrainerConfig(batch_size=64, epochs=1),
                device="cpu").fit(
            raw.windows[:64], raw.labels[:64].astype(np.int32),
            num_classes=model.num_classes,
            init_params=other.inner.module.state_dict())


def test_slots_distinguish_warm_starts_and_freeze_sets(pretrained, tmp_path):
    ckpt, _, _ = pretrained
    cfg = TrainerConfig(batch_size=32, epochs=1, checkpoint_dir=str(tmp_path / "ck"))
    for freeze in ((), ("ConvBlock_0",), ("ConvBlock_0",)):
        tuned = transfer.fine_tune(ckpt, _adapt(32), cfg, freeze=freeze, device="cpu")
    assert tuned.history["resumed_from_epoch"] == 1  # the repeat resumed
    assert len(os.listdir(tmp_path / "ck")) == 2


@pytest.mark.parametrize("freeze", [(), ("ConvBlock_0",)], ids=["all", "frozen_block"])
def test_three_steps_match_jax_fine_tune(freeze):
    """From the same flax parameters and scaler, three steps of the port's
    fine_tune (one batch an epoch) lie within 1e-4 of har_tpu's."""
    import jax
    import jax.numpy as jnp

    from har_tpu.features.scaler import FittedScaler as JaxScaler
    from har_tpu.models.neural import CNN1D
    from har_tpu.models.neural_classifier import NeuralClassifierModel as JaxModel
    from har_tpu.train.trainer import NeuralModel as JaxNeural
    from har_tpu.train.trainer import TrainerConfig as JaxConfig
    from har_tpu.transfer import fine_tune as jax_fine_tune

    from har_tpu_torch.features.scaler import FittedScaler

    data = _adapt(32, seed=6)
    x = np.asarray(data.features[:, :64], np.float32)
    mean, std = x.mean(0), x.std(0) + 0.5
    flax_module = CNN1D(num_classes=6, channels=CHANNELS, dropout_rate=0.0,
                        dtype=jnp.float32)
    params = flax_module.init(jax.random.PRNGKey(1), jnp.asarray(x[:2]))["params"]
    port_module = build_model("cnn1d", 6, in_features=3, channels=CHANNELS,
                              dropout_rate=0.0, dtype="float32")
    port_module.load_state_dict(convert.cnn1d_params_from_flax(params))
    port_model = NeuralClassifierModel(
        inner=NeuralModel(module=port_module, num_classes=6),
        scaler=FittedScaler(mean=mean, std=std), num_classes=6)
    jax_model = JaxModel(inner=JaxNeural(module=flax_module, params=params, num_classes=6),
                         scaler=JaxScaler(mean=mean, std=std), num_classes=6)
    kw = dict(batch_size=32, epochs=3, learning_rate=1e-2, seed=2)
    port = transfer.fine_tune(None, (x, data.label), TrainerConfig(**kw),
                              freeze=freeze, model=port_model, device="cpu")
    want = jax_fine_tune(None, (x, data.label), JaxConfig(**kw), freeze=freeze,
                         model=jax_model)
    want_sd = convert.cnn1d_params_from_flax(jax.device_get(want.inner.params))
    for k, v in port.inner.module.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(port.history["loss"], want.history["loss"], rtol=1e-4)


def test_cli_round_trip(tmp_path, capsys, monkeypatch):
    """train --save-models-dir → evaluate → predict → finetune --output →
    evaluate of the fine-tuned artifact, on the CPU."""
    monkeypatch.setenv("HAR_TPU_WISDM_CSV", str(tmp_path / "absent.csv"))

    def run(argv):
        assert cli.main(argv) == 0
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    models = tmp_path / "models"
    trained = run(["train", "--dataset", "synthetic", "--models", "mlp", "dt",
                   "--epochs", "3", "--no-cv", "--save-models-dir", str(models),
                   "--device", "cpu", "--output-dir", str(tmp_path / "out")])
    for name in ("mlp", "decision_tree"):
        ev = run(["evaluate", "--checkpoint", str(models / name), "--device", "cpu"])
        assert ev["accuracy"] == trained["accuracies"][name]
        pred = run(["predict", "--checkpoint", str(models / name), "--output",
                    str(tmp_path / f"{name}.csv"), "--device", "cpu"])
        assert pred["n_rows"] == ev["n_test"]
    tuned = tmp_path / "tuned"
    out = run(["finetune", "--checkpoint", str(models / "mlp"), "--epochs", "2",
               "--learning-rate", "1e-3", "--freeze", "Dense_0", "--output", str(tuned),
               "--device", "cpu"])
    assert set(out) == {"accuracy_before", "accuracy_after", "frozen", "checkpoint"}
    assert out["frozen"] == ["Dense_0"] and out["checkpoint"] == str(tuned)
    assert out["accuracy_before"] == round(trained["accuracies"]["mlp"], 4)
    ev = run(["evaluate", "--checkpoint", str(tuned), "--device", "cpu"])
    assert round(ev["accuracy"], 4) == out["accuracy_after"]
    meta = checkpoint.load_model_meta(str(tuned))
    assert (meta["dataset"], meta["input_shape"]) == ("synthetic", [13])
    with pytest.raises(SystemExit, match="classical"):
        cli.main(["finetune", "--checkpoint", str(models / "decision_tree"),
                  "--device", "cpu"])


def test_cli_resume_and_early_stop_options(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("HAR_TPU_WISDM_CSV", str(tmp_path / "absent.csv"))
    argv = ["train", "--dataset", "synthetic", "--models", "mlp", "--no-cv",
            "--epochs", "4", "--checkpoint-dir", str(tmp_path / "ck"),
            "--early-stop-patience", "2", "--device", "cpu",
            "--output-dir", str(tmp_path / "out")]
    accuracies = []
    for _ in range(2):
        assert cli.main(argv) == 0
        accuracies.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert accuracies[0] == accuracies[1]
    with pytest.raises(SystemExit, match="set both or neither"):
        cli.main(["train", "--models", "mlp", "--validation-fraction", "0.2",
                  "--device", "cpu"])
