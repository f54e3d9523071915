"""The port's histogram (kernel K1's plain version) against the JAX package.

``har_tpu_torch.ops.hist.hist_plain`` must equal ``hist_matmul`` (the Pallas
kernel, in interpret mode here) and the XLA one-hot matmul the JAX tree
grower uses, on the shapes of tests/test_pallas_hist.py.  Integer weights
(the trees' ones and Poisson counts) must agree exactly; random float32
weights within rtol 1e-5, since the order of summation differs.  The CUDA
kernel itself is held against hist_plain on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from har_tpu.ops.pallas_hist import hist_matmul
from har_tpu_torch.ops import hist as hist_ops

torch.set_num_threads(1)

# (n, d, max_bins, wc): the JAX kernel tests' shapes, padded rows and
# features included, and the tree grower's (DT depth 2, 3 classes)
SHAPES = [(300, 7, 8, 12), (513, 130, 4, 6), (257, 9, 32, 12)]


def _inputs(n, d, max_bins, wc, trees=1, integer=True, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, max_bins, size=(n, d)).astype(np.int32)
    if integer:
        m = rng.poisson(1.0, size=(trees, n, wc)).astype(np.float32)
    else:
        m = rng.random((trees, n, wc)).astype(np.float32)
    return bins, m


def _xla_onehot(bins, m2d, max_bins):
    """The JAX grower's XLA path (har_tpu/models/tree.py:248-286)."""
    n, d = bins.shape
    onehot = jax.nn.one_hot(jnp.asarray(bins), max_bins, dtype=jnp.bfloat16)
    return np.asarray(
        jax.lax.dot_general(
            jnp.asarray(m2d, jnp.bfloat16),
            onehot.reshape(n, d * max_bins),
            (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
    )


def _plain(bins, m, max_bins):
    return hist_ops.hist_plain(
        torch.from_numpy(bins), torch.from_numpy(m), max_bins
    ).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_equals_pallas_and_xla_exactly_for_integer_weights(shape):
    n, d, max_bins, wc = shape
    bins, m = _inputs(n, d, max_bins, wc)
    out = _plain(bins, m, max_bins)
    assert out.shape == (1, wc, d * max_bins)
    pallas = np.asarray(hist_matmul(jnp.asarray(bins), jnp.asarray(m[0]), max_bins))
    np.testing.assert_array_equal(out[0], pallas)
    np.testing.assert_array_equal(out[0], _xla_onehot(bins, m[0], max_bins))


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_plain_matches_pallas_for_float_weights(shape):
    n, d, max_bins, wc = shape
    bins, m = _inputs(n, d, max_bins, wc, integer=False, seed=1)
    out = _plain(bins, m, max_bins)
    pallas = np.asarray(hist_matmul(jnp.asarray(bins), jnp.asarray(m[0]), max_bins))
    np.testing.assert_allclose(out[0], pallas, rtol=1e-5)


def test_tree_axis_is_one_histogram_per_tree():
    bins, m = _inputs(300, 7, 8, 12, trees=3, seed=2)
    out = _plain(bins, m, 8)
    assert out.shape == (3, 12, 7 * 8)
    for t in range(3):
        np.testing.assert_array_equal(out[t], _xla_onehot(bins, m[t], 8))


def test_out_of_range_bins_contribute_nothing():
    bins, m = _inputs(40, 3, 4, 5, seed=3)
    bins[::3, 1] = 4  # one past the last bin, as one_hot ignores it
    out = _plain(bins, m, 4)
    np.testing.assert_array_equal(out[0], _xla_onehot(bins, m[0], 4))


def test_wrapper_takes_plain_version_on_cpu_tensors_only():
    bins, m = _inputs(64, 5, 8, 6, trees=2, seed=4)
    before = hist_ops.HIST_LAUNCHES
    out = hist_ops.hist(torch.from_numpy(bins), torch.from_numpy(m), 8)
    np.testing.assert_array_equal(out.numpy(), _plain(bins, m, 8))
    assert hist_ops.HIST_LAUNCHES == before  # the kernel did not run


def test_wrapper_rejects_wrong_types_and_shapes():
    bins, m = _inputs(16, 3, 4, 6)
    with pytest.raises(TypeError):
        hist_ops.hist(torch.from_numpy(bins).long(), torch.from_numpy(m), 4)
    with pytest.raises(ValueError):
        hist_ops.hist(torch.from_numpy(bins), torch.from_numpy(m[0]), 4)


@pytest.mark.parametrize(
    "wc,max_bins", [(48, 32), (96, 32), (6, 8), (384, 32), (96, 512)]
)
def test_tile_fits_hopper_shared_memory(wc, max_bins):
    wc_tile, f_tile = hist_ops.tile_shape(wc, max_bins)
    assert 1 <= wc_tile * f_tile <= 1024
    assert max_bins * (wc_tile * f_tile + 1) * 4 <= 232_448


def test_tile_raises_past_the_envelope():
    with pytest.raises(ValueError):
        hist_ops.tile_shape(96, 4096)


# --- the row-sparse entry: m row one-hot, as a tree level builds it ---


def _row_inputs(n, d, max_bins, wc, trees=3, integer=True, seed=5):
    """bins with some ids outside [0, max_bins); slot and weight (T, n)
    with zero weights and slots outside [0, wc)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, max_bins, size=(n, d)).astype(np.int32)
    bins[::7, d // 2] = max_bins
    bins[::11, 0] = -1
    slot = rng.integers(-2, wc + 2, size=(trees, n)).astype(np.int32)
    if integer:
        weight = rng.poisson(1.0, size=(trees, n)).astype(np.float32)
    else:
        weight = rng.random((trees, n)).astype(np.float32)
        weight[:, ::5] = 0.0
    return bins, slot, weight


def _densify(slot, weight, wc):
    """The dense m of a row one-hot: weight at (t, r, slot), if in range."""
    m = np.zeros(slot.shape + (wc,), np.float32)
    t, r = np.nonzero((slot >= 0) & (slot < wc))
    m[t, r, slot[t, r]] = weight[t, r]
    return m


def _rows_plain(bins, slot, weight, wc, max_bins):
    return hist_ops.hist_rows_plain(
        *(torch.from_numpy(a) for a in (bins, slot, weight)), wc, max_bins
    ).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_rows_plain_equals_dense_plain_and_pallas_exactly(shape):
    n, d, max_bins, wc = shape
    bins, slot, weight = _row_inputs(n, d, max_bins, wc)
    out = _rows_plain(bins, slot, weight, wc, max_bins)
    assert out.shape == (3, wc, d * max_bins)
    m = _densify(slot, weight, wc)
    np.testing.assert_array_equal(out, _plain(bins, m, max_bins))
    # the three trees' columns side by side: one Pallas call
    m_cols = np.ascontiguousarray(m.transpose(1, 0, 2).reshape(n, 3 * wc))
    pallas = np.asarray(hist_matmul(jnp.asarray(bins), jnp.asarray(m_cols), max_bins))
    np.testing.assert_array_equal(out.reshape(3 * wc, -1), pallas)


def test_rows_plain_matches_dense_plain_for_float_weights():
    n, d, max_bins, wc = SHAPES[0]
    bins, slot, weight = _row_inputs(n, d, max_bins, wc, integer=False, seed=6)
    out = _rows_plain(bins, slot, weight, wc, max_bins)
    want = _plain(bins, _densify(slot, weight, wc), max_bins)
    np.testing.assert_allclose(out, want, rtol=1e-5)


def test_rows_wrapper_takes_plain_version_on_cpu_tensors_only():
    bins, slot, weight = _row_inputs(64, 5, 8, 6, trees=2, seed=7)
    before = (hist_ops.HIST_ROWS_LAUNCHES, hist_ops.HIST_LAUNCHES)
    out = hist_ops.hist_rows(
        *(torch.from_numpy(a) for a in (bins, slot, weight)), 6, 8
    )
    np.testing.assert_array_equal(out.numpy(), _rows_plain(bins, slot, weight, 6, 8))
    # neither kernel ran
    assert (hist_ops.HIST_ROWS_LAUNCHES, hist_ops.HIST_LAUNCHES) == before


def test_rows_wrapper_rejects_wrong_types_and_shapes():
    bins, slot, weight = (torch.from_numpy(a) for a in _row_inputs(16, 3, 4, 6))
    for args in ((bins.long(), slot, weight), (bins, slot.long(), weight),
                 (bins, slot, weight.double())):
        with pytest.raises(TypeError):
            hist_ops.hist_rows(*args, 6, 4)
    for args in ((bins, slot[0], weight[0]), (bins, slot, weight[:2]),
                 (bins[:8], slot, weight), (bins[0], slot, weight)):
        with pytest.raises(ValueError):
            hist_ops.hist_rows(*args, 6, 4)
    with pytest.raises(ValueError):
        hist_ops.hist_rows(bins, slot, weight, 6, 0)


# the tree path's launches: (n, d, B, wc, T) of DT levels 0-2, an RF
# chunk's levels 0-3, the last chunk's level 3, and a wide level (depth 5)
@pytest.mark.parametrize(
    "n,d,max_bins,wc,trees",
    [(3793, 730, 32, 6 * 2**level, 1) for level in range(3)]
    + [(3793, 730, 32, 6 * 2**level, 8) for level in range(4)]
    + [(3793, 730, 32, 48, 4), (3793, 730, 32, 96, 8), (300, 7, 8, 12, 3)],
)
def test_rows_plan_fits_hopper_and_covers_every_row(n, d, max_bins, wc, trees):
    wc_tile, slot_tiles, chunk_rows, chunks = hist_ops.rows_plan(
        n, d, max_bins, wc, trees
    )
    assert (slot_tiles - 1) * wc_tile < wc <= slot_tiles * wc_tile  # none empty
    smem = wc_tile * 32 * (max_bins | 1) * 4
    assert smem <= 232_448 // 2
    assert chunk_rows % 32 == 0 and (chunks - 1) * chunk_rows < n <= chunks * chunk_rows
    # about two blocks per SM, unless chunks would fall under 256 rows
    blocks = trees * slot_tiles * -(-d // 32) * chunks
    assert blocks >= 2 * 132 or chunks == max(1, n // 256)


@pytest.mark.parametrize("sms", [16, 66, 114, 132])
def test_rows_plan_follows_the_sm_count(sms):
    # DT's first level: 23 blocks before the rows are split into the
    # fewest chunks that give two blocks per SM
    _, _, chunk_rows, chunks = hist_ops.rows_plan(3793, 730, 32, 6, 1, sms)
    assert chunks == -(-2 * sms // 23)
    assert (chunks - 1) * chunk_rows < 3793 <= chunks * chunk_rows


def test_rows_of_an_empty_table_are_zeros():
    bins = torch.zeros((0, 3), dtype=torch.int32)
    slot, weight = torch.zeros((2, 0), dtype=torch.int32), torch.zeros((2, 0))
    out = hist_ops.hist_rows(bins, slot, weight, 6, 4)
    assert out.shape == (2, 6, 12) and not out.any()
    assert hist_ops.rows_plan(0, 3, 4, 6, 2) == (6, 1, 32, 1)


def test_rows_plan_raises_past_the_envelope():
    with pytest.raises(ValueError):
        hist_ops.rows_plan(100, 3, 4096, 6, 1)
