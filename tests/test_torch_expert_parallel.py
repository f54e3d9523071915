"""Expert parallelism of the port (``parallel.expert_parallel``) against
the JAX package's.

Ports ``tests/test_expert_parallel.py``.  The ranks run in CPU ``gloo``
groups of 2 and 4 processes, one expert a rank (``tests/_torch_ranks.py``,
started once for the file); ``har_tpu``'s layer runs here in
``shard_map`` on as many of the 8 virtual CPU devices, on the same
arrays (the port's ``init_moe_params``, numpy draws from the seed):

- at dropless capacity the output equals ``moe_dense_reference`` and
  ``har_tpu``'s (rtol 1e-5, atol 1e-6 / atol 1e-5), the expert fractions
  sum to 1 and the balance loss is at least 1;
- capacity 1 drops tokens to exactly zero, and the kept ones equal the
  reference;
- gradients, summed over the ranks, are finite, reach the router, and
  equal the dense reference's (no balance loss) and ``har_tpu``'s (with
  it), atol 1e-5;
- a stack of 4 experts on a 2-rank mesh is refused with JAX's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from har_tpu.parallel import expert_parallel as jax_ep
from har_tpu_torch.parallel.expert_parallel import moe_dense_reference

torch.set_num_threads(1)

WORLDS = [2, 4]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    groups = ranks.run_groups([(["moe"], w, {}) for w in WORLDS],
                              tmp_path_factory.mktemp("ranks"))
    return {w: [r["moe"] for r in g] for w, g in zip(WORLDS, groups)}


def _jax(params):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params)


def _jax_moe(e, capacity, n=32):
    params, x = ranks.moe_problem(e, n=n)
    mesh = jax_ep.expert_mesh(e, devices=jax.devices()[:e])
    return jax.jit(jax_ep.make_moe_fn(mesh, capacity=capacity))(_jax(params), jnp.asarray(x.numpy()))


@pytest.mark.parametrize("world", WORLDS)
def test_moe_matches_dense_reference(results, world):
    params, x = ranks.moe_problem(world)
    ref = moe_dense_reference(params, x).numpy()
    for r in results[world]:  # every rank holds the whole output
        np.testing.assert_allclose(r["y"].numpy(), ref, rtol=1e-5, atol=1e-6)
    got = results[world][0]
    jy, jaux = _jax_moe(world, capacity=x.shape[0] // world)
    np.testing.assert_allclose(got["y"].numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(float(got["aux"]["expert_fraction"].sum()), 1.0, rtol=1e-6)
    assert float(got["aux"]["load_balance_loss"]) >= 1.0 - 1e-6
    np.testing.assert_allclose(float(got["aux"]["load_balance_loss"]),
                               float(jaux["load_balance_loss"]), atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_moe_tight_capacity_drops_tokens(results, world):
    params, x = ranks.moe_problem(world, n=64)
    y = results[world][0]["tight"].numpy()
    ref = moe_dense_reference(params, x).numpy()
    dropped = np.all(y == 0.0, axis=-1)
    assert dropped.any(), "capacity=1 on 64 tokens must drop some"
    np.testing.assert_allclose(y[~dropped], ref[~dropped], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y, np.asarray(_jax_moe(world, 1, n=64)[0]), atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_moe_gradients_flow(results, world):
    params, x = ranks.moe_problem(world)
    got = results[world][0]
    for g in got["grads"].values():
        assert torch.isfinite(g).all()
    # the router receives gradient (through the gates and the balance loss)
    assert float(got["grads"]["router"].abs().max()) > 0
    # the dense reference's gradient of the same loss without the balance term
    dense = ranks._with_grad(params)
    (moe_dense_reference(dense, x) ** 2).mean().backward()
    want = {"router": dense["router"].grad,
            **{f"experts/{k}": v.grad for k, v in dense["experts"].items()}}
    for name, g in got["grads_plain"].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
    # har_tpu's gradient with it
    mesh = jax_ep.expert_mesh(world, devices=jax.devices()[:world])
    f = jax_ep.make_moe_fn(mesh, capacity=x.shape[0] // world)
    xj = jnp.asarray(x.numpy())

    def loss(p):
        y, aux = f(p, xj)
        return (y ** 2).mean() + 0.01 * aux["load_balance_loss"]

    jg = jax.jit(jax.grad(loss))(_jax(params))
    np.testing.assert_allclose(got["grads"]["router"].numpy(), np.asarray(jg["router"]),
                               atol=1e-5)
    for k, v in jg["experts"].items():
        np.testing.assert_allclose(got["grads"][f"experts/{k}"].numpy(), np.asarray(v),
                                   atol=1e-5, err_msg=k)


def test_moe_rejects_mismatched_expert_count(results):
    for r in results[2]:
        assert r["mismatch"] == (
            "ValueError: expert count 4 != ep mesh size 2 — stack exactly one "
            "expert per device")
