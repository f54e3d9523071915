"""The port's MLP, CNN1D and BiLSTM against the JAX package's flax modules.

Flax-initialised parameters go through ``convert.*_params_from_flax`` into
the port's modules: float32 logits agree within 1e-5 (every CNN pool/norm
pair; the BiLSTM with ``bf16_stream``, ``remat`` and two layers), a
bfloat16 forward within 1e-2 of the JAX bfloat16 forward, and three
float32 training steps with dropout 0 give the JAX trainer's losses,
parameters and logits within 1e-4.  Fresh parameters follow flax's
initializers in shape and distribution.  Augmentation runs inside the
step with its own generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from har_tpu.models import neural as jax_neural
from har_tpu.train import trainer as jax_trainer
from har_tpu_torch import convert
from har_tpu_torch.data.augment import WindowAugment
from har_tpu_torch.models import neural
from har_tpu_torch.models.neural import (
    BiLSTM,
    CNN1D,
    MLP,
    build_model,
    same_padding,
)
from har_tpu_torch.train import trainer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)

FAMILIES = {
    "mlp": (jax_neural.MLP, MLP, convert.mlp_params_from_flax, dict(hidden=(32, 16))),
    "cnn1d": (jax_neural.CNN1D, CNN1D, convert.cnn1d_params_from_flax,
              dict(channels=(8, 16, 16))),
    "bilstm": (jax_neural.BiLSTM, BiLSTM, convert.bilstm_params_from_flax,
               dict(hidden=16)),
}
CASES = {
    "mlp": ("mlp", {}),
    **{f"cnn1d_{pool}_{norm}": ("cnn1d", dict(pool=pool, norm=norm))
       for pool in ("max", "stride") for norm in ("layer", "rms", "none")},
    "bilstm": ("bilstm", {}),
    "bilstm_bf16_stream": ("bilstm", dict(bf16_stream=True)),
    "bilstm_remat": ("bilstm", dict(remat=True)),
    "bilstm_two_layers": ("bilstm", dict(num_layers=2)),
}


def _x(family, rows=8, t=64, seed=0):
    rng = np.random.default_rng(seed)
    shape = (rows, 13) if family == "mlp" else (rows, t, 3)
    return rng.normal(size=shape).astype(np.float32)


def _pair(family, x, dtype=jnp.float32, **kw):
    """(flax module, its params, port module loaded with them)."""
    jax_cls, port_cls, conv, base = FAMILIES[family]
    kw = {**base, **kw}
    jax_model = jax_cls(dtype=dtype, **kw)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = port_cls(dtype="float32" if dtype == jnp.float32 else "bfloat16",
                    in_features=x.shape[-1], **kw)
    port.load_state_dict(conv(params))
    return jax_model, params, port


def _logits(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_float32_logits_match(case):
    family, kw = CASES[case]
    x = _x(family)
    jax_model, params, port = _pair(family, x, **kw)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    got = _logits(port, x)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("t", [61, 200])
def test_cnn_odd_and_cli_lengths(t):
    """An odd length floors in the max pool; at T = 200 the stride-2 SAME
    convolution pads (1, 2)."""
    assert same_padding(200, 5, 2) == (1, 2) and same_padding(200, 5, 1) == (2, 2)
    for pool in ("max", "stride"):
        x = _x("cnn1d", rows=4, t=t, seed=1)
        jax_model, params, port = _pair("cnn1d", x, pool=pool)
        want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
        np.testing.assert_allclose(_logits(port, x), want, **TOL)


@pytest.mark.parametrize("case", ["mlp", "cnn1d_max_layer", "bilstm_bf16_stream"])
def test_bfloat16_forward_within_bf16_of_jax(case):
    family, kw = CASES[case]
    x = _x(family, seed=2)
    jax_model, params, port = _pair(family, x, dtype=jnp.bfloat16, **kw)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    got = _logits(port, x)
    assert got.dtype == np.float32  # logits leave the model in f32
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("case", ["mlp", "cnn1d_stride_rms", "bilstm_remat"])
def test_three_steps_match_jax_trainer(case):
    """Three epochs of one wrapped batch (the first at learning rate 0),
    float32, dropout 0: losses, parameters and logits within 1e-4."""
    family, kw = CASES[case]
    x = _x(family, rows=24, t=32, seed=3)
    y = np.random.default_rng(4).integers(0, 6, 24).astype(np.int32)
    kw = dict(kw, dropout_rate=0.0)
    cfg = dict(batch_size=32, epochs=3, learning_rate=1e-2, seed=1)
    jax_model, init, port = _pair(family, x, **kw)
    init = jax.tree.map(np.array, init)  # the JAX fit donates its inputs
    want = jax_trainer.Trainer(jax_model, jax_trainer.TrainerConfig(**cfg)).fit(
        x, y, num_classes=6, init_params=init
    )
    conv = FAMILIES[family][2]
    got = trainer.Trainer(port, trainer.TrainerConfig(**cfg), device="cpu").fit(
        x, y, num_classes=6, init_params=conv(init)
    )
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], **STEP_TOL)
    want_sd = conv(want.params)
    got_sd = got.module.state_dict()
    assert set(got_sd) == set(want_sd)
    for key, value in want_sd.items():
        np.testing.assert_allclose(got_sd[key].numpy(), value.numpy(), **STEP_TOL,
                                   err_msg=key)
    assert not torch.allclose(got_sd["head.weight"], conv(init)["head.weight"])
    np.testing.assert_allclose(got.predict_logits(x), want.predict_logits(x), **STEP_TOL)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fresh_init_follows_flax_initializers(family):
    """Parameter shapes equal flax's; biases zero, norm scales one;
    kernels lecun-normal (std √(1/fan_in), truncated at 2 std) with the
    flax fan-in (a conv kernel's k·in, the BiLSTM's wx 2·I); wh's
    flattened (2H, 4H) matrix has orthonormal rows."""
    x = _x(family, rows=2)
    _, params, _ = _pair(family, x)
    kw = FAMILIES[family][3]
    port = FAMILIES[family][1](dtype="float32", in_features=x.shape[-1], **kw)
    port.reset_parameters(torch.Generator().manual_seed(7))
    fresh = port.state_dict()
    flax_sd = FAMILIES[family][2](params)
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in flax_sd.items()}
    for key, value in fresh.items():
        if key.endswith("bias"):
            assert torch.equal(value, torch.zeros_like(value)), key
        elif ".norm." in key:
            assert torch.equal(value, torch.ones_like(value)), key

    def lecun(w, fan_in):
        std = (1 / fan_in) ** 0.5
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978
        assert abs(float(w.std()) - std) < 0.15 * std

    if family == "mlp":
        lecun(fresh["layers.0.weight"], 13)
    elif family == "cnn1d":
        lecun(fresh["blocks.1.weight"], 8 * 5)
    else:
        lecun(fresh["layers.0.wx"], 2 * 3)
        wh = fresh["layers.0.wh"].reshape(32, 64)
        torch.testing.assert_close(wh @ wh.T, torch.eye(32), rtol=0, atol=1e-5)


def test_registry_and_build_model():
    assert set(neural.MODEL_REGISTRY) == set(jax_neural.MODEL_REGISTRY)
    for name in ("mlp", "cnn1d", "bilstm", "transformer"):
        module = build_model(name, num_classes=5)
        assert isinstance(module, torch.nn.Module)
    with pytest.raises(ValueError, match="unknown neural model"):
        build_model("gru", num_classes=5)
    with pytest.raises(ValueError, match="pool"):
        CNN1D(pool="avg")
    with pytest.raises(ValueError, match="norm"):
        CNN1D(norm="batch")


def test_constructor_arguments_are_the_flax_fields():
    import dataclasses
    import inspect

    for name in ("mlp", "cnn1d", "bilstm"):
        flax_fields = {
            f.name for f in dataclasses.fields(jax_neural.MODEL_REGISTRY[name])
            if f.name not in ("parent", "name")
        }
        port_args = set(inspect.signature(neural.MODEL_REGISTRY[name]).parameters)
        assert port_args == flax_fields | {"in_features"}, name


def _fit(module, augment=None, **cfg):
    x = _x("cnn1d", rows=16, t=32, seed=5)
    y = np.arange(16, dtype=np.int32) % 6
    cfg = trainer.TrainerConfig(batch_size=8, epochs=2, **cfg)
    fit = trainer.Trainer(module, cfg, device="cpu", augment=augment).fit(x, y, num_classes=6)
    return fit.module.state_dict()


def test_augmentation_runs_in_the_step_with_its_own_generator():
    """A policy that draws from its generator and returns the batch as it
    was leaves a dropout run unchanged (the dropout draws come from their
    own generator); the default policy moves the fit and is seeded."""
    kw = dict(channels=(8, 8), dtype="float32", dropout_rate=0.3)
    plain = _fit(CNN1D(**kw))
    seen = []

    def draws_only(generator, xb):
        seen.append(torch.rand(3, generator=generator))
        return xb

    same = _fit(CNN1D(**kw), augment=draws_only)
    assert len(seen) == 4  # 2 batches x 2 epochs
    for key in plain:
        assert torch.equal(plain[key], same[key]), key
    aug = [_fit(CNN1D(**kw), augment=WindowAugment()) for _ in range(2)]
    assert all(torch.equal(aug[0][k], aug[1][k]) for k in aug[0])
    assert not torch.equal(aug[0]["head.weight"], plain["head.weight"])


def test_mlp_with_augment_raises():
    x = _x("mlp", rows=8)
    with pytest.raises(ValueError, match="cannot train with --augment"):
        trainer.Trainer(MLP(dtype="float32"), trainer.TrainerConfig(batch_size=8, epochs=1),
                        device="cpu", augment=WindowAugment()).fit(x, np.zeros(8, np.int32))
