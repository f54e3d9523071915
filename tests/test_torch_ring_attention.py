"""Ring attention of the port against full attention and the JAX ring.

Ports ``tests/test_ring_attention.py``.  The port's rings run in CPU
``gloo`` groups of 2 and 4 processes (``tests/_torch_ranks.py``, started
once for the file), where each hop of ``ring_flash_attention`` takes K2's
plain version; ``har_tpu``'s ring runs here in ``shard_map`` on the 8
virtual CPU devices:

- sp 2 and 4, and dp 2 × sp 2: the plain ring equals full attention and
  JAX's ring (rtol 2e-5, atol 2e-6); extreme logits stay finite (rtol 1e-4);
- ring-flash equals the plain ring and full attention (rtol 3e-5);
- gradients of q, k and v flow through the rotation and K2's backward
  and equal full attention's (rtol 2e-4, atol 2e-5);
- ``Transformer1D(sp_axis=...)``: its ring-flash forward equals its plain
  ring (rtol 3e-4, atol 3e-5) and the unsharded module (atol 1e-4); a
  head dim outside K2's envelope raises K2's error as the unsharded
  module does, and only ``use_flash=False`` takes the plain ring;
- the hop body alone, driven over sequence chunks as the ranks of a ring
  would meet them, equals full attention (as ``chip_smoke.py`` drives it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_ranks as ranks
from har_tpu.parallel import create_mesh as jax_create_mesh
from har_tpu.parallel.ring_attention import ring_attention as jax_ring
from har_tpu_torch.parallel.ring_attention import full_attention, ring_hop

torch.set_num_threads(1)

NAMES = ["ring", "sp_transformer"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    two, four = ranks.run_groups([(NAMES, 2, {}), (NAMES, 4, {})],
                                 tmp_path_factory.mktemp("ranks"))
    return {2: two, 4: four}


def _cat(results, world, key, sub):
    return torch.cat([results[world][r][key][sub] for r in range(world)], 1)


def _jax_ring(q, k, v, sp, dp=1):
    mesh = jax_create_mesh(dp=dp, tp=sp, devices=jax.devices()[: dp * sp])
    spec = P("dp" if dp > 1 else None, "tp")
    f = jax.shard_map(lambda q, k, v: jax_ring(q, k, v, "tp"), mesh=mesh,
                      in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(f)(*(jnp.asarray(z.numpy()) for z in (q, k, v))))


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_full_and_jax(results, sp):
    q, k, v = ranks.qkv()
    got = _cat(results, sp, "ring", "ring").numpy()
    np.testing.assert_allclose(got, full_attention(q, k, v).numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, _jax_ring(q, k, v, sp), rtol=2e-5, atol=2e-6)


def test_ring_matches_full_sp2_dp2(results):
    q, k, v = ranks.qkv(b=4, t=32)
    four = results[4]
    got = torch.cat([torch.cat([four[2 * b + s]["ring"]["dp_sp"] for s in range(2)], 1)
                     for b in range(2)], 0).numpy()
    np.testing.assert_allclose(got, full_attention(q, k, v).numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, _jax_ring(q, k, v, 2, dp=2), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_extreme_logits_stable(results, sp):
    q, k, v = ranks.qkv(t=16)
    got = _cat(results, sp, "ring", "extreme").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, full_attention(q * 30.0, k, v).numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_flash_matches_ring_and_full(results, sp):
    q, k, v = ranks.qkv(b=2, t=128, h=2, d=32)
    got = _cat(results, sp, "ring", "flash").numpy()
    np.testing.assert_allclose(got, full_attention(q, k, v).numpy(), rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(got, _cat(results, sp, "ring", "flash_ring").numpy(),
                               rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_flash_gradients_flow(results, sp):
    q, k, v = (z.requires_grad_() for z in ranks.qkv(b=1, t=64, h=2, d=32, seed=5))
    (full_attention(q, k, v) ** 2).sum().backward()
    for i, want in enumerate((q.grad, k.grad, v.grad)):
        got = torch.cat([results[sp][r]["ring"]["grads"][i] for r in range(sp)], 1)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("sp", [2, 4])
def test_transformer_sp_ring_flash_matches_plain_ring(results, sp):
    for r in results[sp]:
        got = r["sp_transformer"]
        np.testing.assert_allclose(got["flash"], got["plain"], rtol=3e-4, atol=3e-5)
        np.testing.assert_allclose(got["flash"], got["single"], atol=1e-4)


@pytest.mark.parametrize("sp", [2, 4])
def test_transformer_sp_head_dim_outside_k2_raises(results, sp):
    """The ring's route follows use_flash as the unsharded route does: a
    head dim K2 cannot take is K2's own ValueError, not the plain ring."""
    from har_tpu_torch.models.transformer import Transformer1D

    kw = dict(num_classes=6, embed_dim=24, num_heads=2, num_layers=1, dtype="float32")
    x = torch.zeros((2, 128 // sp, 3))
    with pytest.raises(ValueError) as unsharded:
        Transformer1D(**kw)(x)
    for r in results[sp]:
        got = r["sp_transformer"]
        assert got["odd_flash"] == f"ValueError: {unsharded.value}"
        assert "multiple of 8" in got["odd_flash"]
        assert got["odd_plain"].shape == (2, 6) and torch.isfinite(got["odd_plain"]).all()


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_hop_body_over_chunks_equals_full(sp):
    """Rank r of an sp ring meets K/V chunk (r - hop) mod sp at each hop:
    the hop body alone, driven so on one device, is full attention, and
    its gradients are full attention's."""
    q, k, v = (z.requires_grad_() for z in ranks.qkv(b=2, t=64, h=2, d=16, seed=3))
    t = 64 // sp
    blocks = []
    for r in range(sp):
        out = torch.zeros((2, t, 2, 16))
        lse = torch.full((2, 2, t), float("-inf"))
        for hop in range(sp):
            c = (r - hop) % sp
            out, lse = ring_hop(q[:, r * t:(r + 1) * t], k[:, c * t:(c + 1) * t],
                                v[:, c * t:(c + 1) * t], out, lse)
        blocks.append(out)
    got = torch.cat(blocks, 1)
    want = full_attention(q, k, v)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=3e-5, atol=3e-6)
    g = torch.autograd.grad((got ** 2).sum(), (q, k, v))
    w = torch.autograd.grad((want ** 2).sum(), (q, k, v))
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)
