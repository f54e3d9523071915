"""The port's attention (kernel K2's plain version, its autograd and the
segment routes) against the JAX package.

``har_tpu_torch.ops.flash_attention`` on CPU tensors runs the kernel's
plain version; it must match ``har_tpu.ops.flash_attention`` (the Pallas
kernel, in interpret mode here) within the JAX package's own flash-vs-XLA
bound, rtol/atol 2e-5, forward and lse alike.  Gradients go through the
plain-PyTorch backward (full recompute, or the chunked one) and must match
``jax.grad`` through the JAX kernel's custom VJP.  The forward is the
registered op ``har_tpu_torch::flash_attention_fwd``: ``torch.library.
opcheck`` passes on CPU tensors (schema, fake and autograd registrations),
and its gradients equal those of the ``torch.autograd.Function`` it
replaced, kept below as ``_OldFlashAttention``.  The CUDA kernel itself
is held against the plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import har_tpu.ops.flash_attention as jfa
from har_tpu.parallel.ring_attention import full_attention as jax_full_attention
from har_tpu_torch.ops import flash_attention as fa
from har_tpu_torch.parallel.ring_attention import full_attention

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b=2, t=64, h=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3)]


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("t,block_q,block_k", [(64, 32, 32), (96, 32, 48)])
def test_forward_and_lse_match_jax_kernel(t, block_q, block_k):
    q, k, v = _qkv(t=t)
    want_out, want_lse = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), block_q, block_k
    )
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), block_q, block_k)
    out, lse = fa.flash_attention_with_lse(*_torch(q, k, v))
    plain_out, plain_lse = fa.attention_with_lse_plain(*_torch(q, k, v))
    assert out.shape == (2, t, 2, 32) and lse.shape == (2, 2, t)
    assert lse.dtype == torch.float32
    for got in (out, plain_out, fa.flash_attention(*_torch(q, k, v))):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_out), **TOL)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for got in (lse, plain_lse):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_lse), **TOL)


def test_ragged_t_and_small_head_dim_match_full_attention():
    """T = 25 and D = 16, the packed and the CLI head dim, which the JAX
    kernel's TPU guards refuse: the port holds them to XLA attention."""
    for t, d in ((25, 16), (200, 16), (7, 8)):
        q, k, v = _qkv(b=3, t=t, h=2, d=d, seed=t)
        want = jax_full_attention(*map(jnp.asarray, (q, k, v)))
        out = fa.flash_attention(*_torch(q, k, v))
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_bf16_inputs_keep_dtype_and_f32_lse():
    q, k, v = _qkv(seed=3)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out, lse = fa.flash_attention_with_lse(qb, kb, vb)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    want = jax_full_attention(
        *(jnp.asarray(x.float().numpy()) for x in (qb, kb, vb))
    )
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


def test_strided_views_of_a_fused_projection():
    """q, k, v as views of one (B, T, 3E) tensor give the same result as
    contiguous copies (the kernel reads them through their strides)."""
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(2, 40, 3 * 64)).astype(np.float32))
    q, k, v = (z.view(2, 40, 4, 16) for z in qkv.split(64, dim=-1))
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_misaligned_views_are_copied_for_the_kernel():
    """The kernel's 16-byte loads need strides in multiples of 8 elements:
    views of the fused projection qualify and pass through; a projection
    widened by 4 columns does not and is handed over as a copy."""
    aligned = torch.zeros((2, 25, 3 * 32)).split(32, dim=-1)[1].unflatten(-1, (2, 16))
    assert fa._aligned(aligned) is aligned
    padded = torch.zeros((2, 25, 3 * 32 + 4))[..., 32:64].unflatten(-1, (2, 16))
    copied = fa._aligned(padded)
    assert copied is not padded and copied.is_contiguous()
    torch.testing.assert_close(copied, padded, rtol=0, atol=0)


@pytest.mark.parametrize("seg", [8, 16])
def test_segment_routes_match_jax(seg):
    q, k, v = _qkv(t=64, seed=5)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_flash = jfa.segment_flash_attention(jq, jk, jv, seg)
    want_masked = jfa.segment_attention(jq, jk, jv, seg)
    got_flash = fa.segment_flash_attention(*_torch(q, k, v), seg)
    got_masked = fa.segment_attention(*_torch(q, k, v), seg)
    for got in (got_flash, got_masked):
        np.testing.assert_allclose(got.numpy(), np.asarray(want_flash), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_masked), **TOL)


def test_segment_length_must_divide_t():
    q, k, v = _torch(*_qkv(t=30))
    for route in (fa.segment_flash_attention, fa.segment_attention):
        with pytest.raises(ValueError, match="must divide"):
            route(q, k, v, 8)


def test_full_attention_matches_jax():
    q, k, v = _qkv(t=48, seed=6)
    want = jax_full_attention(*map(jnp.asarray, (q, k, v)))
    got = full_attention(*_torch(q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_lse", [False, True])
def test_gradients_match_jax_grad(with_lse):
    q, k, v = _qkv(t=32, seed=7)
    rng = np.random.default_rng(8)
    w_out = rng.normal(size=q.shape).astype(np.float32)
    w_lse = rng.normal(size=(2, 2, 32)).astype(np.float32)

    def jax_loss(q, k, v):
        if with_lse:
            out, lse = jfa.flash_attention_with_lse(q, k, v, 16, 16)
            return (out * w_out).sum() + (lse * w_lse).sum()
        return (jfa.flash_attention(q, k, v, 16, 16) * w_out).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _torch(q, k, v, grad=True)
    if with_lse:
        out, lse = fa.flash_attention_with_lse(tq, tk, tv)
        loss = (out * torch.from_numpy(w_out)).sum() + (lse * torch.from_numpy(w_lse)).sum()
    else:
        loss = (fa.flash_attention(tq, tk, tv) * torch.from_numpy(w_out)).sum()
    loss.backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_lse", [False, True])
def test_chunked_backward_matches_jax(with_lse):
    """The O(T·block) backward (used past _BWD_FULL_T) against the JAX
    package's _chunked_attention_bwd, with the lse cotangent, at T = 32
    and block 8."""
    q, k, v = _qkv(t=32, seed=9)
    rng = np.random.default_rng(10)
    g = rng.normal(size=q.shape).astype(np.float32)
    g_lse = rng.normal(size=(2, 2, 32)).astype(np.float32) if with_lse else None
    out, lse = jfa._attention_with_lse_ref(*map(jnp.asarray, (q, k, v)))
    want = jfa._chunked_attention_bwd(
        *map(jnp.asarray, (q, k, v)), out, jnp.asarray(g), 8,
        g_lse=None if g_lse is None else jnp.asarray(g_lse),
        lse=lse if with_lse else None,
    )
    got = fa.chunked_attention_bwd(
        *_torch(q, k, v), torch.from_numpy(np.array(out)), torch.from_numpy(g), 8,
        g_lse=None if g_lse is None else torch.from_numpy(g_lse),
        lse=torch.from_numpy(np.array(lse)) if with_lse else None,
    )
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_autograd_takes_the_chunked_backward_past_the_threshold(monkeypatch):
    q, k, v = _qkv(t=40, seed=11)
    grads = []
    for full_t in (fa._BWD_FULL_T, 0):
        monkeypatch.setattr(fa, "_BWD_FULL_T", full_t)
        monkeypatch.setattr(fa, "_BWD_BLOCK_K", 16)  # ragged last block
        tq, tk, tv = _torch(q, k, v, grad=True)
        out, lse = fa.flash_attention_with_lse(tq, tk, tv)
        ((out**2).sum() + lse.sum()).backward()
        grads.append((tq.grad, tk.grad, tv.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_no_kernel_launch_on_cpu():
    before = fa.FLASH_LAUNCHES
    q, k, v = _torch(*_qkv(t=16), grad=True)
    out, lse = fa.flash_attention_with_lse(q, k, v)
    (out.sum() + lse.sum()).backward()
    fa.segment_flash_attention(q, k, v, 8)
    assert fa.FLASH_LAUNCHES == before


@pytest.mark.parametrize(
    "shape,dtype,error",
    [
        ((2, 16, 2, 12), torch.float32, ValueError),  # D not a multiple of 8
        ((2, 16, 1, 136), torch.float32, ValueError),  # D past 128
        ((2, 16, 2, 16), torch.float16, TypeError),
        ((16, 2, 16), torch.float32, ValueError),  # not (B, T, H, D)
    ],
)
def test_wrapper_guards_raise(shape, dtype, error):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(error):
        fa.flash_attention(x, x, x)


def test_wrapper_rejects_mismatched_inputs():
    q = torch.zeros((2, 16, 2, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, torch.zeros((2, 8, 2, 16)))
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q.bfloat16())


class _OldFlashAttention(torch.autograd.Function):
    """The wrapper the registered op replaced (its forward here the plain
    version, as the old one took on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, with_lse: bool):
        out, lse = fa.attention_with_lse_plain(q, k, v)
        lse = lse if with_lse else None
        ctx.with_lse = with_lse
        ctx.save_for_backward(q, k, v, out, lse)
        return (out, lse) if with_lse else out

    @staticmethod
    def backward(ctx, g_out, g_lse=None):
        q, k, v, out, lse = ctx.saved_tensors
        if not ctx.with_lse:
            g_lse = None
        if q.shape[1] <= fa._BWD_FULL_T:
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                o, l = fa.attention_with_lse_plain(*leaves)
                outputs, grads = [o], [g_out]
                if g_lse is not None:
                    outputs.append(l)
                    grads.append(g_lse)
                dq, dk, dv = torch.autograd.grad(outputs, leaves, grads)
        else:
            dq, dk, dv = fa.chunked_attention_bwd(
                q, k, v, out, g_out, fa._BWD_BLOCK_K, g_lse=g_lse, lse=lse
            )
        return dq, dk, dv, None


@pytest.mark.parametrize("with_lse", [False, True])
def test_registered_op_passes_opcheck(with_lse):
    q, k, v = _torch(*_qkv(b=2, t=16, h=2, d=8, seed=12), grad=True)
    result = torch.library.opcheck(fa.flash_attention_fwd, (q, k, v, with_lse))
    assert set(result.values()) == {"SUCCESS"}, result


@pytest.mark.parametrize("route", ["recompute", "chunked"])
@pytest.mark.parametrize("with_lse", [False, True])
def test_op_gradients_equal_the_old_autograd_function(monkeypatch, route, with_lse):
    """The recompute and the chunked backward (a ragged last key block),
    with the lse cotangent: the op's gradients are the old wrapper's, bit
    for bit, and so are its outputs."""
    if route == "chunked":
        monkeypatch.setattr(fa, "_BWD_FULL_T", 0)
        monkeypatch.setattr(fa, "_BWD_BLOCK_K", 16)
    q, k, v = _qkv(t=40, seed=13)
    rng = np.random.default_rng(14)
    w_out = torch.from_numpy(rng.normal(size=q.shape).astype(np.float32))
    w_lse = torch.from_numpy(rng.normal(size=(2, 2, 40)).astype(np.float32))
    results = []
    for apply in (
        lambda a, b, c: (fa.flash_attention_with_lse(a, b, c) if with_lse
                         else fa.flash_attention(a, b, c)),
        lambda a, b, c: _OldFlashAttention.apply(a, b, c, with_lse),
    ):
        tq, tk, tv = _torch(q, k, v, grad=True)
        got = apply(tq, tk, tv)
        out, lse = got if with_lse else (got, None)
        loss = (out * w_out).sum() + ((lse * w_lse).sum() if with_lse else 0)
        loss.backward()
        results.append((out.detach(), tq.grad, tk.grad, tv.grad))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
