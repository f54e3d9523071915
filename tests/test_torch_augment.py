"""The port's window augmentation against the JAX package's.

``WindowAugment.apply`` is a pure function of the windows and the draws;
fed the draws ``jax.random`` makes from a key (split as the JAX package
splits it), it equals ``har_tpu``'s ``WindowAugment()(key, x)`` within
1e-6 for the default policy and each transform alone.  The port's own
draws come from a ``torch.Generator``: seeded, with the JAX package's
shapes and ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from har_tpu.data.augment import WindowAugment as JaxWindowAugment
from har_tpu.data.augment import build_augment as jax_build_augment
from har_tpu_torch.data.augment import WindowAugment, build_augment, rotations

torch.set_num_threads(1)

POLICIES = {
    "default": {},
    "jitter": dict(scale_std=0.0, max_rotation=0.0, time_mask_fraction=0.0),
    "scale": dict(jitter_std=0.0, max_rotation=0.0, time_mask_fraction=0.0),
    "rotation": dict(jitter_std=0.0, scale_std=0.0, time_mask_fraction=0.0),
    "time_mask": dict(jitter_std=0.0, scale_std=0.0, max_rotation=0.0),
    "identity": dict(jitter_std=0.0, scale_std=0.0, max_rotation=0.0,
                     time_mask_fraction=0.0),
}


def jax_draws(policy: JaxWindowAugment, key, x: np.ndarray) -> dict:
    """The random numbers har_tpu's WindowAugment draws from ``key``."""
    b, t, c = x.shape
    kj, ks, kr, km = jax.random.split(key, 4)
    k_axis, k_angle = jax.random.split(kr)
    span = max(1, int(round(t * policy.time_mask_fraction)))
    draws = dict(
        jitter=jax.random.normal(kj, x.shape),
        scale=jax.random.normal(ks, (b, 1, c)),
        axis=jax.random.normal(k_axis, (b, 3)),
        angle=jax.random.uniform(k_angle, (b,), minval=0.0, maxval=policy.max_rotation),
        start=jax.random.randint(km, (b, 1), 0, t - span + 1),
    )
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("name", list(POLICIES))
def test_apply_equals_jax_on_its_draws(name):
    x = np.random.default_rng(0).normal(size=(16, 50, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jax_policy = JaxWindowAugment(**POLICIES[name])
    want = np.asarray(jax_policy(key, jnp.asarray(x)))
    got = WindowAugment(**POLICIES[name]).apply(
        torch.from_numpy(x), jax_draws(jax_policy, key, x)
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_rotations_are_rotations():
    g = torch.Generator().manual_seed(0)
    rot = rotations(torch.randn((32, 3), generator=g), torch.rand(32, generator=g))
    torch.testing.assert_close(rot @ rot.transpose(1, 2), torch.eye(3).expand(32, 3, 3),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.linalg.det(rot), torch.ones(32), rtol=0, atol=1e-6)


def test_own_draws_are_seeded_with_jax_shapes_and_ranges():
    x = torch.zeros((64, 200, 3))
    policy = WindowAugment()
    a = policy.draw(torch.Generator().manual_seed(1), x)
    b = policy.draw(torch.Generator().manual_seed(1), x)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "jitter": (64, 200, 3), "scale": (64, 1, 3), "axis": (64, 3),
        "angle": (64,), "start": (64, 1),
    }
    assert 0 <= float(a["angle"].min()) and float(a["angle"].max()) < 0.2
    assert 0 <= int(a["start"].min()) and int(a["start"].max()) <= 200 - 20
    out = policy(torch.Generator().manual_seed(1), x + 1.0)
    assert out.shape == x.shape
    # the time mask zeroes one 20-step span a window
    assert ((out == 0).all(dim=2).sum(dim=1) == 20).all()


def test_disabled_transforms_draw_nothing():
    x = torch.ones((2, 10, 3))
    assert WindowAugment(**POLICIES["identity"]).draw(torch.Generator(), x) == {}
    assert torch.equal(WindowAugment(**POLICIES["identity"])(torch.Generator(), x), x)


def test_two_dimensional_input_raises():
    with pytest.raises(ValueError, match="tabular feature"):
        WindowAugment()(torch.Generator(), torch.zeros((4, 13)))


def test_build_augment_matches_jax():
    for name in (None, "none"):
        assert build_augment(name) is None and jax_build_augment(name) is None
    assert build_augment("raw_windows") == WindowAugment()
    for build in (build_augment, jax_build_augment):
        with pytest.raises(ValueError, match="unknown augmentation"):
            build("mixup")
