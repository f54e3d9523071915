"""The trainer's FLOP count (``TrainerConfig.compute_flops``) against
har_tpu's.

The port counts one training step with ``torch.utils.flop_counter``
(matmuls and convolutions; K2's op by its registered formula) where
har_tpu reads XLA's cost analysis, which adds the elementwise work and
the optimizer: for an MLP of widths 64→256→128→6 in float32 at batch 128
the port's count is 0.887 of XLA's, and the test holds it in [0.80, 1.0].
The transformer's count equals a closed form with K2's 4·B·H·T²·D in it;
a run with ``compute_flops`` ends with the parameters of the run without
it, bit for bit; the fields appear on exactly the runs where har_tpu
records them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from har_tpu.models.neural import MLP as JaxMLP
from har_tpu.train import trainer as jax_trainer
from har_tpu_torch.config import DataConfig, ModelConfig, RunConfig
from har_tpu_torch import runner
from har_tpu_torch.data.augment import build_augment
from har_tpu_torch.models.neural import build_model
from har_tpu_torch.models.transformer import Transformer1D
from har_tpu_torch.train import trainer

torch.set_num_threads(1)

FIELDS = ("program_flops", "program_flops_raw", "program_flops_steps")


def _mlp_data(n=128, d=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, 6, n).astype(np.int32)
    y[:6] = np.arange(6)
    return x, y


def _windows(n=16, t=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, 3)).astype(np.float32)
    y = rng.integers(0, 6, n).astype(np.int32)
    y[:6] = np.arange(6)
    return x, y


def test_mlp_count_is_the_matmul_share_of_xla_count():
    x, y = _mlp_data()
    cfg = dict(batch_size=128, epochs=1, compute_flops=True)
    jax_h = jax_trainer.Trainer(
        JaxMLP(num_classes=6, hidden=(256, 128), dtype=jnp.float32),
        jax_trainer.TrainerConfig(**cfg),
    ).fit(x, y, num_classes=6).history
    port_h = trainer.Trainer(
        build_model("mlp", 6, hidden=(256, 128), dtype="float32", in_features=64),
        trainer.TrainerConfig(**cfg), device="cpu",
    ).fit(x, y, num_classes=6).history
    # forward 2·128·(64·256 + 256·128 + 128·6); weight gradients the same;
    # input gradients of the two upper layers
    assert port_h["program_flops_raw"] == 34_144_256
    ratio = port_h["program_flops_raw"] / jax_h["program_flops_raw"]
    assert 0.80 <= ratio <= 1.0, (port_h["program_flops_raw"], jax_h["program_flops_raw"])
    assert port_h["program_flops_steps"] == jax_h["program_flops_steps"] == 1


def _transformer_closed_form(b, t, c, embed, heads, layers, classes, patch=1):
    """Per layer 12·E² a token in projections; c·patch·E a token to embed,
    E·C a window for the head; × 3 (forward, weight and input gradients)
    less the embedding's input gradient; attention 16·B·H·T²·D a layer:
    K2's formula 4, the backward's recompute 4 and its gradients 8."""
    tokens, t, cin, d = b * (t // patch), t // patch, c * patch, embed // heads
    forward = 2 * tokens * (12 * layers * embed * embed + cin * embed) + 2 * b * embed * classes
    return 3 * forward - 2 * tokens * cin * embed + 16 * layers * b * heads * t * t * d


@pytest.mark.parametrize(
    "kwargs",
    [dict(embed_dim=16, num_heads=2, num_layers=2),
     dict(embed_dim=32, num_heads=4, num_layers=1, patch_size=4),
     dict(embed_dim=16, num_heads=2, num_layers=2, patch_size=4, window_pack=4)],
)
def test_transformer_count_equals_the_closed_form(kwargs):
    from torch.utils.flop_counter import FlopCounterMode

    module = Transformer1D(num_classes=6, dtype="float32", **kwargs)
    got = trainer.step_flops(module, (8, 32, 3), torch.device("cpu"))
    want = _transformer_closed_form(8, 32, 3, kwargs["embed_dim"], kwargs["num_heads"],
                                    kwargs["num_layers"], 6, kwargs.get("patch_size", 1))
    assert got == want
    # K2's share is its formula, once a layer: without it the count
    # would drop the forward's attention
    t = 32 // kwargs.get("patch_size", 1)
    d = kwargs["embed_dim"] // kwargs["num_heads"]
    with FlopCounterMode(display=False) as counter:
        module(torch.zeros(8, 32, 3))
    flash = [v for k, v in counter.get_flop_counts()["Global"].items()
             if "flash_attention_fwd" in str(k)]
    assert flash == [4 * 8 * kwargs["num_heads"] * t * t * d * kwargs["num_layers"]]


def test_count_of_a_bf16_transformer_and_a_cnn():
    """The count does not depend on the dtype, and convolutions count."""
    f32 = trainer.step_flops(Transformer1D(num_classes=6, embed_dim=16, num_heads=2,
                                           num_layers=1, dtype="float32"),
                             (4, 16, 3), torch.device("cpu"))
    bf16 = trainer.step_flops(Transformer1D(num_classes=6, embed_dim=16, num_heads=2,
                                            num_layers=1), (4, 16, 3), torch.device("cpu"))
    assert f32 == bf16 == _transformer_closed_form(4, 16, 3, 16, 2, 1, 6)
    cnn = build_model("cnn1d", 6, channels=(8, 8), dtype="float32")
    assert trainer.step_flops(cnn, (4, 32, 3), torch.device("cpu")) > 0


@pytest.mark.parametrize("family", ["mlp", "transformer"])
def test_counting_leaves_the_run_bit_equal(family):
    """Dropout, augmentation and the optimizer run as without the count:
    the fits end with equal parameters and losses, bit for bit."""
    if family == "mlp":
        x, y = _mlp_data(n=96, d=12)
        make = lambda: build_model("mlp", 6, hidden=(16, 8), in_features=12)  # noqa: E731
        augment = None
    else:
        x, y = _windows(n=24, t=32)
        make = lambda: Transformer1D(num_classes=6, embed_dim=16, num_heads=2,  # noqa: E731
                                     num_layers=1, dropout_rate=0.2, patch_size=4)
        augment = build_augment("raw_windows")
    runs = []
    for flops in (False, True):
        cfg = trainer.TrainerConfig(batch_size=16, epochs=2, compute_flops=flops)
        model = trainer.Trainer(make(), cfg, device="cpu", augment=augment).fit(x, y, 6)
        runs.append(model)
    assert "program_flops" in runs[1].history and "program_flops" not in runs[0].history
    assert runs[0].history["loss"] == runs[1].history["loss"]
    a, b = runs[0].module.state_dict(), runs[1].module.state_dict()
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize(
    "option",
    ["plain", "checkpoint", "early_stop", "streamed", "checkpoint_early_stop"],
)
def test_fields_recorded_where_har_tpu_records_them(option, tmp_path):
    x, y = _mlp_data(n=64, d=8)
    cfg = dict(batch_size=32, epochs=2, compute_flops=True)
    if "checkpoint" in option:
        cfg.update(checkpoint_dir=str(tmp_path / option))
    if "early_stop" in option:
        cfg.update(early_stop_patience=1)
    scan = option != "streamed"
    want = jax_trainer.Trainer(
        JaxMLP(num_classes=6, hidden=(16,), dtype=jnp.float32),
        jax_trainer.TrainerConfig(**cfg), scan=scan,
    ).fit(x, y, num_classes=6).history
    if "checkpoint_dir" in cfg:
        cfg["checkpoint_dir"] += "_port"
    got = trainer.Trainer(
        build_model("mlp", 6, hidden=(16,), dtype="float32", in_features=8),
        trainer.TrainerConfig(**cfg), device="cpu", scan=scan,
    ).fit(x, y, num_classes=6).history
    assert [k in got for k in FIELDS] == [k in want for k in FIELDS]
    assert all(k in got for k in FIELDS) == (option == "plain")
    if option == "plain":
        assert got["program_flops_steps"] == want["program_flops_steps"] == 4
        assert got["program_flops"] == 4 * got["program_flops_raw"]


def test_runner_passes_compute_flops_to_the_trainer(tmp_path):
    """`run(params={"compute_flops": True})` trains with the count on:
    the option `train` once refused."""
    seen = []
    fit = trainer.Trainer.fit

    def record(self, *args, **kwargs):
        model = fit(self, *args, **kwargs)
        seen.append(model.history)
        return model

    config = RunConfig(
        data=DataConfig(synthetic_rows=300),
        model=ModelConfig(params=dict(compute_flops=True, epochs=1)),
        output_dir=str(tmp_path),
    )
    trainer.Trainer.fit = record
    try:
        outcome = runner.run(config, models=["mlp"], with_cv=False, device="cpu")
    finally:
        trainer.Trainer.fit = fit
    assert set(outcome.accuracies) == {"mlp"}
    (history,) = seen
    assert history["program_flops"] == history["program_flops_raw"] * history[
        "program_flops_steps"] > 0
