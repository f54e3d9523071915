"""Pipeline parallelism of the port (``parallel.pipeline_parallel``)
against the JAX package's.

Ports ``tests/test_pipeline_parallel.py``.  The ranks run in CPU ``gloo``
groups of 2 and 4 processes, one stage a rank (``tests/_torch_ranks.py``,
started once for the file); ``har_tpu``'s GPipe schedule runs here in
``shard_map`` on as many of the 8 virtual CPU devices, on the same
arrays:

- the pipelined forward equals the stages applied one after another and
  ``har_tpu``'s (rtol 1e-5, atol 1e-6 / atol 1e-5) on every rank;
- gradients, summed over the ranks, equal the sequential ones and
  ``har_tpu``'s (rtol 1e-4, atol 1e-6 / atol 1e-5);
- a training run (in-proj → pipeline → head, Adam, 60 steps) learns;
- ``stack_stage_params`` stacks, and a stack of 4 stages on a 2-rank
  mesh is refused with JAX's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from har_tpu.parallel import pipeline_parallel as jax_pp
from har_tpu_torch.parallel.pipeline_parallel import stack_stage_params

torch.set_num_threads(1)

WORLDS = [2, 4]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    groups = ranks.run_groups([(["pipeline"], w, {}) for w in WORLDS],
                              tmp_path_factory.mktemp("ranks"))
    return {w: [r["pipeline"] for r in g] for w, g in zip(WORLDS, groups)}


def _sequential(stacked, x):
    y = x
    for i in range(stacked["w"].shape[0]):
        y = ranks.stage_fn({k: v[i] for k, v in stacked.items()}, y)
    return y


def _jax_stage(params, a):
    return jax.nn.relu(a @ params["w"] + params["b"])


def _jax_fn(s):
    return jax_pp.make_pipeline_fn(_jax_stage, jax_pp.pipeline_mesh(s, devices=jax.devices()[:s]))


def _jax(tree):
    return {k: jnp.asarray(v.detach().numpy()) for k, v in tree.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_matches_sequential(results, world):
    rng = np.random.default_rng(0)
    stacked = ranks.stage_params(rng, world, 16)
    x = torch.from_numpy(rng.normal(size=(6, 8, 16)).astype(np.float32))
    ref = _sequential(stacked, x).numpy()
    for r in results[world]:
        np.testing.assert_allclose(r["y"].numpy(), ref, rtol=1e-5, atol=1e-6)
    want = jax.jit(_jax_fn(world))(_jax(stacked), jnp.asarray(x.numpy()))
    np.testing.assert_allclose(results[world][0]["y"].numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_gradients_match_sequential(results, world):
    rng = np.random.default_rng(1)
    stacked = {k: v.requires_grad_() for k, v in ranks.stage_params(rng, world, 8).items()}
    x = torch.from_numpy(rng.normal(size=(5, 4, 8)).astype(np.float32))
    (_sequential(stacked, x) ** 2).mean().backward()
    f = _jax_fn(world)
    xj = jnp.asarray(x.numpy())
    jg = jax.jit(jax.grad(lambda p: (f(p, xj) ** 2).mean()))(_jax(stacked))
    for k, v in stacked.items():
        got = results[world][0]["grads"][k].numpy()
        np.testing.assert_allclose(got, v.grad.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got, np.asarray(jg[k]), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_training_step_learns(results, world):
    losses = results[world][0]["losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7
    # every rank took the same steps
    for r in results[world][1:]:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-6)


def test_stack_stage_params():
    a = {"w": torch.ones((2, 3))}
    b = {"w": torch.zeros((2, 3))}
    stacked = stack_stage_params([a, b])
    assert stacked["w"].shape == (2, 2, 3)
    np.testing.assert_array_equal(stacked["w"][1].numpy(), 0.0)


def test_stage_count_must_match_mesh(results):
    for r in results[2]:
        assert r["mismatch"] == (
            "ValueError: stage count 4 != pp mesh size 2 — stack exactly one stage "
            "per pipeline device")
