"""The port's trainer against the JAX package's.

The learning-rate schedule equals optax's value by value (to a few float32
ulps: XLA's cosine and numpy's differ in the last bit), the batch schedule
is identical, and three training steps of a float32 transformer from the
same injected parameters (dropout 0) give the JAX trainer's losses,
parameters and predictions within 1e-4, with and without
``class_weight="balanced"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from har_tpu.models.transformer import Transformer1D as JaxTransformer1D
from har_tpu.train import trainer as jax_trainer
from har_tpu_torch.convert import transformer_params_from_flax
from har_tpu_torch.models.transformer import Transformer1D
from har_tpu_torch.train import trainer

torch.set_num_threads(1)


@pytest.mark.parametrize(
    "args", [(0.0, 1e-3, 2, 10), (0.0, 3e-3, 36, 360), (0.0, 1e-3, 2, 26)]
)
def test_schedule_matches_optax_value_by_value(args):
    want = optax.warmup_cosine_decay_schedule(*args)
    got = trainer.warmup_cosine_decay_schedule(*args)
    for step in range(args[3] + 3):
        np.testing.assert_allclose(
            got(step), float(want(step)), rtol=1e-6, atol=0, err_msg=str(step)
        )
    if args == (0.0, 1e-3, 2, 10):
        assert [got(i) for i in range(3)] == [0.0, np.float32(5e-4), np.float32(1e-3)]
        np.testing.assert_allclose(got(3), 9.62e-4, rtol=1e-3)


@pytest.mark.parametrize("n,batch", [(100, 32), (64, 64), (10, 512)])
def test_batch_iterator_identical(n, batch):
    a = list(trainer.batch_iterator(n, batch, np.random.default_rng(3)))
    b = list(jax_trainer.batch_iterator(n, batch, np.random.default_rng(3)))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


MODEL = dict(num_classes=4, embed_dim=32, num_heads=2, num_layers=1,
             dropout_rate=0.0, patch_size=4)


def _data(n=24, t=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, t, 3)).astype(np.float32)
    y = rng.integers(0, 4, size=n).astype(np.int32)
    y[:4] = np.arange(4)  # every class present
    return x, y


@pytest.mark.parametrize("class_weight", [None, "balanced"])
def test_three_steps_match_jax_trainer(class_weight):
    """n=24 rows, batch 32 (one wrapped batch per epoch), three epochs:
    the first step has learning rate 0, the next two move the params."""
    x, y = _data()
    cfg = dict(batch_size=32, epochs=3, learning_rate=1e-2,
               class_weight=class_weight, seed=1)
    jax_module = JaxTransformer1D(dtype=jnp.float32, **MODEL)
    init = jax_module.init(jax.random.PRNGKey(5), jnp.asarray(x[:2]))["params"]
    init = jax.tree.map(np.array, init)  # the JAX fit donates its inputs
    want = jax_trainer.Trainer(jax_module, jax_trainer.TrainerConfig(**cfg)).fit(
        x, y, num_classes=4, init_params=init
    )
    got = trainer.Trainer(
        Transformer1D(dtype="float32", **MODEL), trainer.TrainerConfig(**cfg),
        device="cpu",
    ).fit(x, y, num_classes=4, init_params=transformer_params_from_flax(init))
    np.testing.assert_allclose(got.history["loss"], want.history["loss"], rtol=1e-4, atol=1e-4)
    want_sd = transformer_params_from_flax(want.params)
    got_sd = got.module.state_dict()
    assert set(got_sd) == set(want_sd)
    for key, value in want_sd.items():
        got_v, want_v = got_sd[key].numpy(), value.numpy()
        if key.endswith("qkv.bias"):
            # the key bias has an exactly zero gradient (softmax ignores a
            # constant added to every score of a row): Adam normalizes the
            # float noise left in it into full-size steps, different in
            # each package, so only the query and value biases compare
            e = MODEL["embed_dim"]
            got_v, want_v = np.delete(got_v, np.s_[e : 2 * e]), np.delete(want_v, np.s_[e : 2 * e])
        np.testing.assert_allclose(got_v, want_v, rtol=1e-4, atol=1e-4, err_msg=key)
    # the init moved: steps 2 and 3 had a nonzero learning rate
    init_sd = transformer_params_from_flax(init)
    assert not torch.allclose(got_sd["head.weight"], init_sd["head.weight"])
    # predict_logits chunks (10, 10, 4 padded to 10) as the JAX model does
    np.testing.assert_allclose(
        got.predict_logits(x, batch_size=10), want.predict_logits(x, batch_size=10),
        rtol=1e-4, atol=1e-4,
    )


def test_balanced_weights_are_the_jax_formula():
    """n / (classes · count): the loss of one step with all weights 1 and
    with balanced weights differ as the per-class reweighting predicts."""
    x, y = _data(n=12, seed=2)
    counts = np.bincount(y, minlength=4).astype(np.float32)
    weights = 12 / (4 * np.maximum(counts, 1.0))
    losses = {}
    for cw in (None, "balanced"):
        fit = trainer.Trainer(
            Transformer1D(dtype="float32", **MODEL),
            trainer.TrainerConfig(batch_size=12, epochs=1, class_weight=cw),
            device="cpu",
        ).fit(x, y, num_classes=4)
        losses[cw] = fit.history["loss"][0]
    module = Transformer1D(dtype="float32", **MODEL)
    module.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        ce = torch.nn.functional.cross_entropy(
            module(torch.from_numpy(x)),
            torch.from_numpy(y).long(), reduction="none",
        ).numpy()
    # the first step's loss is taken before any update (learning rate 0)
    idx = next(trainer.batch_iterator(12, 12, np.random.default_rng(0)))
    np.testing.assert_allclose(losses[None], ce[idx].mean(), rtol=1e-5)
    w = weights[y[idx]]
    np.testing.assert_allclose(losses["balanced"], (ce[idx] * w).sum() / w.sum(), rtol=1e-5)


@pytest.mark.parametrize(
    "option",
    [dict(checkpoint_dir="/nonexistent", compute_flops=True),
     dict(early_stop_patience=2, compute_flops=True),
     dict(compute_flops=True), dict(save_every_epochs=1, compute_flops=True)],
)
def test_unported_options_raise(option):
    x, y = _data(n=8)
    t = trainer.Trainer(Transformer1D(dtype="float32", **MODEL),
                        trainer.TrainerConfig(**option), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t.fit(x, y)


def test_trainer_config_fields_match_jax():
    import dataclasses

    assert [f.name for f in dataclasses.fields(trainer.TrainerConfig)] == [
        f.name for f in dataclasses.fields(jax_trainer.TrainerConfig)
    ]
    assert repr(trainer.TrainerConfig()) == repr(jax_trainer.TrainerConfig())
