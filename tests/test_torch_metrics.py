"""The port's device metric battery against `har_tpu.ops.metrics`.

``classification_report`` and its parts (confusion matrix, multiclass,
binary and regression metrics) on torch tensors equal the JAX battery on
the same predictions within float32 tolerance 1e-6: with tied scores,
with classes never predicted, with a mask, and batched over a leading
dimension.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from har_tpu.ops import metrics as jax_metrics
from har_tpu_torch.ops import metrics as port_metrics

torch.set_num_threads(1)

ATOL = 1e-6
C = 5


def _inputs(seed: int, n: int = 97, ties: bool = False, skip_class: bool = False):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, n).astype(np.int32)
    raw = rng.random((n, C)).astype(np.float32)
    if ties:  # few distinct scores: argmax ties and sort ties
        raw = np.round(raw * 3) / 3
    if skip_class:  # class 4 is never predicted
        raw[:, 4] = -1.0
    mask = rng.random(n) < 0.8
    return labels, raw, mask


def _assert_close(got: dict, want: dict):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(value), rtol=0, atol=ATOL, err_msg=key
        )


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize(
    "ties,skip_class", [(False, False), (True, False), (False, True)],
    ids=["plain", "ties", "never_predicted"],
)
def test_classification_report_matches_jax(ties, skip_class, use_mask):
    labels, raw, mask = _inputs(0, ties=ties, skip_class=skip_class)
    jax_mask = jnp.asarray(mask) if use_mask else None
    port_mask = torch.from_numpy(mask) if use_mask else None
    want = jax_metrics.classification_report(
        jnp.asarray(labels), jnp.asarray(raw), num_classes=C, mask=jax_mask
    )
    got = port_metrics.classification_report(
        torch.from_numpy(labels), torch.from_numpy(raw), C, mask=port_mask
    )
    _assert_close(got, want)
    if skip_class:
        assert float(got["precision_per_class"][4]) == 0.0


def test_parts_match_jax():
    labels, raw, mask = _inputs(1, ties=True)
    pred = raw.argmax(-1)
    tl, tp, tm = (torch.from_numpy(a) for a in (labels, pred, mask))
    jl, jp, jm = (jnp.asarray(a) for a in (labels, pred, mask))
    cm = port_metrics.confusion_matrix(tl, tp, C, tm)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jax_metrics.confusion_matrix(jl, jp, C, jm)))
    _assert_close(port_metrics.multiclass_metrics(cm),
                  jax_metrics.multiclass_metrics(jax_metrics.confusion_matrix(jl, jp, C, jm)))
    pos = (labels == 1).astype(np.float32)
    _assert_close(
        port_metrics.binary_metrics(torch.from_numpy(raw[:, 1]), torch.from_numpy(pos), tm),
        jax_metrics.binary_metrics(jnp.asarray(raw[:, 1]), jnp.asarray(pos), jm),
    )
    _assert_close(port_metrics.regression_metrics(tl, tp, tm),
                  jax_metrics.regression_metrics(jl, jp, jm))


def test_batched_equals_each():
    """A leading batch dimension: one battery per row of the batch, each
    equal to the unbatched call and to the JAX battery."""
    items = [_inputs(seed, n=64, ties=seed % 2 == 0) for seed in range(4)]
    labels = torch.from_numpy(np.stack([i[0] for i in items]))
    raw = torch.from_numpy(np.stack([i[1] for i in items]))
    mask = torch.from_numpy(np.stack([i[2] for i in items]))
    batched = port_metrics.classification_report(labels, raw, C, mask=mask)
    for b, (lab, r, m) in enumerate(items):
        one = port_metrics.classification_report(labels[b], raw[b], C, mask=mask[b])
        want = jax_metrics.classification_report(
            jnp.asarray(lab), jnp.asarray(r), num_classes=C, mask=jnp.asarray(m)
        )
        _assert_close({k: v[b] for k, v in batched.items()}, want)
        _assert_close({k: v[b] for k, v in batched.items()}, {k: v.numpy() for k, v in one.items()})
