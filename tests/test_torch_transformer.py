"""The port's Transformer1D against the JAX package's, on the same
parameters.

Flax-initialised parameters go through ``convert.transformer_params_from_flax``
into the port's module; float32 logits must agree within 1e-4 on the
unpacked model, the patched and window-packed model (batches the pack does
and does not divide), the scanned layout, and the JAX package's explicit
flash routes at head dim 32.  A bfloat16 port forward stays within the
JAX package's own bf16 bound (7e-2) of the float32 JAX forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from har_tpu.models.transformer import Transformer1D as JaxTransformer1D
from har_tpu.models.transformer import sinusoidal_positions as jax_positions
from har_tpu_torch.convert import transformer_params_from_flax
from har_tpu_torch.models.neural import build_model
from har_tpu_torch.models.transformer import Transformer1D, sinusoidal_positions

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(rows=8, t=64, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, t, 3)).astype(np.float32)


def _pair(x, dtype=jnp.float32, **kw):
    """(JAX module, its params, port module loaded with the same params)."""
    jax_model = JaxTransformer1D(dtype=dtype, **kw)
    params = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    port = Transformer1D(dtype="float32", **kw)
    port.load_state_dict(transformer_params_from_flax(params))
    return jax_model, params, port


def _logits(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x)).numpy()


SMALL = dict(num_classes=6, embed_dim=32, num_heads=2, num_layers=2)


def test_unpacked_logits_match():
    x = _x()
    jax_model, params, port = _pair(x, **SMALL)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    got = _logits(port, x)
    assert got.shape == (8, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("rows", [8, 6])
def test_patched_window_packed_logits_match(rows):
    """patch 8 (T 64 → 8 tokens) and window_pack 4: 8 rows fill two packs,
    6 rows are zero-padded to 8 and sliced back."""
    x = _x(rows=rows, seed=1)
    jax_model, params, port = _pair(x, patch_size=8, window_pack=4, **SMALL)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    got = _logits(port, x)
    assert got.shape == (rows, 6)
    np.testing.assert_allclose(got, want, **TOL)
    # packing is per-window attention: the unpacked port agrees too
    unpacked = Transformer1D(dtype="float32", patch_size=8, **SMALL)
    unpacked.load_state_dict(port.state_dict())
    np.testing.assert_allclose(_logits(unpacked, x), want, **TOL)


def test_scan_layers_layout_converts():
    x = _x(rows=4, seed=2)
    jax_model, params, port = _pair(x, scan_layers=True, **SMALL)
    assert "blocks" in params
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_logits(port, x), want, **TOL)


@pytest.mark.parametrize(
    "kw",
    [
        # unpacked, D = 32, T = 64: the JAX kernel with block 64
        dict(num_classes=6, embed_dim=64, num_heads=2, num_layers=1),
        # packed, D = 32, seg 16: the segment-folded JAX kernel
        dict(num_classes=6, embed_dim=64, num_heads=2, num_layers=1,
             patch_size=4, window_pack=2),
    ],
)
def test_jax_flash_route_matches(kw):
    x = _x(rows=4, seed=3)
    jax_model, params, port = _pair(x, use_flash=True, **kw)
    want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(_logits(port, x), want, **TOL)


def test_plain_routes_when_flash_is_off():
    """use_flash=False keeps the JAX meaning: full_attention, or the masked
    segment_attention when packed."""
    for kw in (dict(SMALL), dict(SMALL, patch_size=8, window_pack=4)):
        x = _x(rows=8, seed=4)
        jax_model, params, port = _pair(x, use_flash=False, **kw)
        want = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
        np.testing.assert_allclose(_logits(port, x), want, **TOL)


def test_bf16_port_within_bound_of_f32_jax():
    x = _x(rows=8, seed=5)
    kw = dict(SMALL, patch_size=8, window_pack=4)
    jax_model, params, _ = _pair(x, **kw)
    ref = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x)))
    port = Transformer1D(dtype=torch.bfloat16, **kw)
    port.load_state_dict(transformer_params_from_flax(params))
    out = _logits(port, x)
    assert out.dtype == np.float32  # logits leave the model in f32
    assert np.abs(out - ref).max() < 7e-2, np.abs(out - ref).max()


def test_positions_match():
    want = np.asarray(jax_positions(25, 64, 0.0))
    got = sinusoidal_positions(25, 64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_fresh_init_follows_flax_initializers():
    """Same parameter shapes as flax; LayerNorm ones/zeros, zero biases,
    lecun_normal kernels (std √(1/fan_in), truncated at 2 std)."""
    x = _x(rows=2, seed=6)
    _, params, port = _pair(x, patch_size=8, **SMALL)
    fresh = Transformer1D(dtype="float32", patch_size=8, **SMALL).state_dict()
    flax_sd = transformer_params_from_flax(params)
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in flax_sd.items()}
    assert torch.equal(fresh["norm.weight"], torch.ones(32))
    assert torch.equal(fresh["blocks.0.qkv.bias"], torch.zeros(96))
    w = fresh["blocks.0.mlp_out.weight"]  # fan_in 128
    bound = 2 * (1 / 128) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= bound
    assert abs(float(w.std()) - (1 / 128) ** 0.5) < 0.1 * (1 / 128) ** 0.5


def test_unported_options_raise():
    """sp_axis is ported (tests/test_torch_ring_attention.py): the module
    builds, its forward needs the axis bound by a mesh, and it refuses
    window packing, as the JAX module does."""
    model = Transformer1D(sp_axis="sp")
    with pytest.raises(ValueError, match="not bound"):
        model(torch.zeros((1, 8, 3)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        Transformer1D(sp_axis="sp", window_pack=2)
    # the other neural families are ported: each builds
    for name in ("mlp", "cnn1d", "bilstm"):
        assert isinstance(build_model(name, num_classes=6), torch.nn.Module)
    with pytest.raises(ValueError, match="divisible"):
        Transformer1D(patch_size=8)(torch.zeros((1, 60, 3)))
