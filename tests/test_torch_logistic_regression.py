"""The port's logistic regression (fast lane) against the JAX package's.

Both packages fit the same seeded noisy class-conditional table (300 rows,
40 features, 6 classes; about one training row in six misclassified).
In float32 the 20-step trajectory depends on the order of float
arithmetic, so the port is held to stated tolerances, measured on this
table at a margin:

- ``losses`` and the final objective within relative 1e-5 (measured
  2.5e-7 at most);
- coefficients within 1e-3 absolute (measured 4.1e-5 at most);
- predicted labels equal.

In float64 both packages run the same algorithm to rounding: both LR
solvers within 1e-9, and the L-BFGS solver against optax on the
Rosenbrock function (zoom, interpolation and safe steps exercised) within
1e-7 over 30 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from har_tpu.features.wisdm_pipeline import FeatureSet as JaxFeatureSet
from har_tpu.models import logistic_regression as jax_lr
from har_tpu_torch import convert
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models import lbfgs
from har_tpu_torch.models import logistic_regression as port_lr

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
COEF_ATOL = 1e-3
F64_TOL = 1e-9


def noisy_table(n=300, d=40, classes=6, seed=0):
    """Class-conditional Gaussians under heavy noise, five sparse binary
    columns in front (a one-hot block's shape)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.int32)
    x = rng.normal(0.0, 1.0, (classes, d))[y] + rng.normal(0.0, 3.0, (n, d))
    x[:, :5] = rng.random((n, 5)) < 0.1
    return x.astype(np.float32), y


X, Y = noisy_table()
CASES = {
    "lbfgs": {},
    "lbfgs_weak_reg": {"reg_param": 0.01},
    "fista": {"elastic_net_param": 0.1},
    "balanced": {"class_weight": "balanced"},
}


@pytest.fixture(scope="module")
def jax_fits():
    """Each JAX fit once."""
    return {
        name: jax_lr.LogisticRegression(**kw).fit(JaxFeatureSet(X, Y))
        for name, kw in CASES.items()
    }


@pytest.mark.parametrize("case", CASES)
def test_fit_matches_jax(case, jax_fits):
    kw = CASES[case]
    want = jax_fits[case]
    got = port_lr.LogisticRegression(**kw, device="cpu").fit(FeatureSet(X, Y))
    np.testing.assert_allclose(got.losses, np.asarray(want.losses), rtol=LOSS_RTOL)
    reg = kw.get("reg_param", 0.3)
    enp = kw.get("elastic_net_param", 0.0)
    if case != "balanced":  # the yardstick has unit row weights
        np.testing.assert_allclose(
            port_lr.objective(got, FeatureSet(X, Y), reg, enp),
            port_lr.objective(want, FeatureSet(X, Y), reg, enp),
            rtol=LOSS_RTOL,
        )
    np.testing.assert_allclose(
        got.coefficients, np.asarray(want.coefficients), rtol=0, atol=COEF_ATOL
    )
    np.testing.assert_allclose(
        got.intercept, np.asarray(want.intercept), rtol=0, atol=COEF_ATOL
    )
    labels = got.transform(FeatureSet(X, Y)).prediction
    want_labels = np.asarray(want.transform(JaxFeatureSet(X, Y)).prediction)
    np.testing.assert_array_equal(labels, want_labels)
    assert 0.6 < (labels == Y).mean() < 0.95  # noisy: not every row is easy


def test_lanes_follow_the_unbatched_fit():
    """A (fold, reg) lane of a batch gives what that fit gives alone: a lane
    whose line search ends early keeps its state while the others go on.
    In float64, where a batched matmul's other summation order stays far
    below the tolerance."""
    x = torch.as_tensor(X, dtype=torch.float64)
    y = torch.as_tensor(Y, dtype=torch.int64)
    rows = [np.arange(0, 240), np.arange(60, 300)]
    regs = torch.tensor([0.01, 0.5], dtype=torch.float64)
    xs = torch.stack([x[r] for r in rows])
    ys = torch.stack([y[r] for r in rows])
    ones = torch.ones((2, 240), dtype=torch.float64)
    w, b, losses = port_lr._train_lanes(xs, ys, ones, regs, 6, 20, 0.0, True, True)
    for f, r in np.ndindex(2, 2):
        w1, b1, losses1 = port_lr._train_lanes(
            xs[f : f + 1], ys[f : f + 1], ones[:1], regs[r : r + 1],
            6, 20, 0.0, True, True,
        )
        torch.testing.assert_close(losses[:, f, r], losses1[:, 0, 0], rtol=F64_TOL, atol=0)
        torch.testing.assert_close(w[f, r], w1[0, 0], rtol=0, atol=F64_TOL)
        torch.testing.assert_close(b[f, r], b1[0, 0], rtol=0, atol=F64_TOL)


def _rosenbrock_optax(starts, steps):
    """optax.lbfgs() on Rosenbrock from each start (vmapped): per-step
    values and params."""

    def f(p):
        return (1 - p[0]) ** 2 + 100.0 * (p[1] - p[0] ** 2) ** 2

    def run(p0):
        opt = optax.lbfgs()
        value_and_grad = optax.value_and_grad_from_state(f)

        def step(carry, _):
            p, st = carry
            v, g = value_and_grad(p, state=st)
            u, st = opt.update(g, st, p, value=v, grad=g, value_fn=f)
            p = optax.apply_updates(p, u)
            return (p, st), (v, p)

        return jax.lax.scan(step, (p0, opt.init(p0)), length=steps)[1]

    values, params = jax.jit(jax.vmap(run))(jnp.asarray(starts))
    return np.asarray(values), np.asarray(params)


def _rosenbrock_port(starts, steps):
    def value_and_grad(params):
        (p,) = params
        a, c = p[:, 0], p[:, 1]
        value = (1 - a) ** 2 + 100.0 * (c - a * a) ** 2
        grad = torch.stack(
            [-2.0 * (1 - a) - 400.0 * a * (c - a * a), 200.0 * (c - a * a)], -1
        )
        return value, (grad,)

    solver = lbfgs.LBFGS(value_and_grad, lane_ndim=1)
    params = (torch.as_tensor(starts),)
    state = solver.init(params)
    values, trail = [], []
    for _ in range(steps):
        value, grad = solver.value_and_grad_from_state(params, state)
        params, state = solver.update(params, value, grad, state)
        values.append(value.numpy())
        trail.append(params[0].numpy())
    return np.stack(values, 1), np.stack(trail, 1)


def test_lbfgs_is_optax_lbfgs_in_float64():
    starts = np.array([[-1.2, 1.0], [0.5, -0.7], [2.0, 2.0], [-0.3, 0.9]])
    syncs = lbfgs.HOST_SYNCS
    with jax.enable_x64(True):
        want_values, want_params = _rosenbrock_optax(starts, 30)
    values, params = _rosenbrock_port(starts, 30)
    # rounding grows along the valley, to 1.4e-8 by step 30 (measured); a
    # step that takes another branch moves the iterate by far more
    np.testing.assert_allclose(params, want_params, rtol=0, atol=1e-7)
    np.testing.assert_allclose(values, want_values, rtol=1e-7, atol=1e-7)
    # two lanes reach the minimum; one line-search read per step taken
    assert np.allclose(params[1:3, -1], 1.0)
    assert 30 <= lbfgs.HOST_SYNCS - syncs <= 30 * 20


@pytest.mark.parametrize("enp", [0.0, 0.1])
def test_lr_solvers_are_the_jax_solvers_in_float64(enp):
    with jax.enable_x64(True):
        w, b, losses = jax_lr._train_weighted(
            jnp.asarray(X, jnp.float64), jnp.asarray(Y), jnp.ones(len(Y), jnp.float64),
            num_classes=6, max_iter=20, reg_param=0.3, elastic_net_param=enp,
            fit_intercept=True, standardize=True,
        )
        want = [np.asarray(a) for a in (w, b, losses)]
    w, b, losses = port_lr._train_lanes(
        torch.as_tensor(X, dtype=torch.float64)[None],
        torch.as_tensor(Y, dtype=torch.int64)[None],
        torch.ones((1, len(Y)), dtype=torch.float64),
        torch.tensor([0.3], dtype=torch.float64), 6, 20, enp, True, True,
    )
    np.testing.assert_allclose(w[0, 0].numpy(), want[0], rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(b[0, 0].numpy(), want[1], rtol=0, atol=F64_TOL)
    np.testing.assert_allclose(losses[:, 0, 0].numpy(), want[2], rtol=F64_TOL)


def test_convert_carries_jax_weights(jax_fits):
    want = jax_fits["lbfgs"]
    model = convert.logistic_regression_from_arrays(
        want.coefficients, want.intercept, want.num_classes, device="cpu"
    )
    got = model.transform(FeatureSet(X, Y))
    ref = want.transform(JaxFeatureSet(X, Y))
    np.testing.assert_allclose(got.raw, np.asarray(ref.raw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got.probability, np.asarray(ref.probability), rtol=0, atol=1e-6
    )
    np.testing.assert_array_equal(got.prediction, np.asarray(ref.prediction))


def test_mesh_sweep_and_missing_gpu_raise(monkeypatch):
    est = port_lr.LogisticRegression(mesh=object(), device="cpu")
    folds = [(np.arange(100, 300), np.arange(100))]
    with pytest.raises(NotImplementedError, match="item 14"):
        est.cv_scores(FeatureSet(X, Y), folds, [{"reg_param": 0.1}], "accuracy")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_lr.LogisticRegression().fit(FeatureSet(X, Y))
