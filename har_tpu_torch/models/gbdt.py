"""Gradient-boosted trees on tensors, each level's histogram from kernel K1.

Port of ``har_tpu/models/gbdt.py``: second-order multiclass boosting
(XGBoost-style).  Per round, softmax gradients ``g = p − onehot(y)`` and
hessians ``h = max(p·(1−p), 1e-6)`` are taken from the running raw scores;
one regression tree per class fits (g_k, h_k) with the gain

    0.5·[G_L²/(H_L+λ) + G_R²/(H_R+λ) − G²/(H+λ)]

and the leaf value ``−G/(H+λ)``, scaled by the learning rate into the
scores.  The JAX package compiles the whole run into one program
(``lax.scan`` over rounds, ``vmap`` over the K class trees, a one-hot
``dot_general`` a level); here the rounds and levels are a Python loop
with the K trees on a leading axis, and each level's (g, h) histogram is
ONE launch of the row-sparse kernel
(:func:`har_tpu_torch.ops.hist.hist_rows`): the level's weight matrix is
row one-hot per channel, so its 2K channels hold g_k (channel 2k) and h_k
(channel 2k+1), each row in the slot of its node in tree k.

Level L works on its live width 2**L nodes; the JAX package works on the
static width 2**max_depth (its slots past 2**L hold no rows and split
nothing), so the trees are the same.  The gain's ``min_child_weight``
mask, ``-inf`` for a masked split, ``best_gain > 1e-12``, the flat
argmax's first maximum and the children's (G, H) written at 2i+1 and 2i+2
follow the JAX package step for step; a row's contribution is the leaf
value of the node it lands in, so no second walk is needed.

``subsample`` below 1.0 draws each round's row mask from a
``torch.Generator`` seeded by ``seed`` (the JAX package draws from
``jax.random``, so the masks differ); :func:`_gbdt_fit` takes the masks
as an argument, so the tests inject the JAX package's.  At the default
1.0 every row is kept and the fit draws nothing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from har_tpu_torch.device import resolve_device
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.base import Predictions
from har_tpu_torch.models.tree import binize, quantile_thresholds
from har_tpu_torch.ops import hist as hist_ops


def _split_gain(gl, hl, gr, hr, lam):
    """XGBoost structure-score gain (without the constant parent term)."""
    return 0.5 * (gl * gl / (hl + lam) + gr * gr / (hr + lam))


def _grow_reg_trees(
    bins: torch.Tensor,  # (n, d) int32 bin ids
    g: torch.Tensor,  # (K, n) f32 gradients, one row per class tree
    h: torch.Tensor,  # (K, n) f32 hessians
    max_depth: int,
    max_bins: int,
    lam: float,
    min_child_weight: float,
):
    """K second-order regression trees on (g, h), grown level by level.

    Returns (feature, split_bin, leaf_value), each (K, nodes), and the
    (K, n) leaf value of the node every row lands in."""
    device = bins.device
    trees, n = g.shape
    d = bins.shape[1]
    n_nodes = 2 ** (max_depth + 1) - 1
    feature = torch.full((trees, n_nodes), -1, dtype=torch.int32, device=device)
    split_bin = torch.zeros((trees, n_nodes), dtype=torch.int32, device=device)
    node_g = torch.zeros((trees, n_nodes), dtype=torch.float32, device=device)
    node_h = torch.zeros((trees, n_nodes), dtype=torch.float32, device=device)
    node_g[:, 0] = g.sum(1)
    node_h[:, 0] = h.sum(1)
    node_of_row = torch.zeros((trees, n), dtype=torch.int64, device=device)
    gh = torch.stack([g, h], dim=1).reshape(2 * trees, n)  # channel 2k+s
    rows = torch.arange(n, device=device)

    for level in range(max_depth):
        wl = 2**level  # live nodes at this level
        first = wl - 1
        local = node_of_row - first
        valid = (local >= 0) & (local < wl)
        local = local.clamp(0, wl - 1)

        slot = torch.where(valid, local, -1).to(torch.int32)
        slot = slot.repeat_interleave(2, dim=0)  # (2K, n): g and h of tree k
        hist = hist_ops.hist_rows(bins, slot, gh, wl, max_bins)
        hist = hist.reshape(trees, 2, wl, d, max_bins)
        gcum = torch.cumsum(hist[:, 0], dim=3)  # (K, wl, d, B)
        hcum = torch.cumsum(hist[:, 1], dim=3)
        gl, hl = gcum[..., : max_bins - 1], hcum[..., : max_bins - 1]
        gt, ht = gcum[..., -1:], hcum[..., -1:]
        gr, hr = gt - gl, ht - hl

        gain = _split_gain(gl, hl, gr, hr, lam) - 0.5 * (gt * gt) / (ht + lam)
        ok = (hl >= min_child_weight) & (hr >= min_child_weight)
        gain = torch.where(ok, gain, -torch.inf)

        flat = gain.reshape(trees, wl, -1)
        best = torch.argmax(flat, dim=-1)  # first maximum, as jnp.argmax
        best_gain = torch.gather(flat, 2, best[:, :, None])[:, :, 0]
        best_feat = best // (max_bins - 1)
        best_bin = best % (max_bins - 1)
        # every node of a level below max_depth is internal-eligible
        is_internal = torch.isfinite(best_gain) & (best_gain > 1e-12)

        node_ids = first + torch.arange(wl, device=device)
        feat_upd = torch.where(is_internal, best_feat, -1)
        feature[:, node_ids] = feat_upd.to(torch.int32)
        split_bin[:, node_ids] = torch.where(is_internal, best_bin, 0).to(torch.int32)

        tree_idx = torch.arange(trees, device=device)[:, None]
        slots = torch.arange(wl, device=device)[None, :]
        glc = gl[tree_idx, slots, best_feat, best_bin]  # (K, wl)
        hlc = hl[tree_idx, slots, best_feat, best_bin]
        gtot, htot = gt[:, :, 0, 0], ht[:, :, 0, 0]
        for child_ids, cg, ch in (
            (2 * node_ids + 1, glc, hlc),
            (2 * node_ids + 2, gtot - glc, htot - hlc),
        ):
            node_g[:, child_ids] = torch.where(is_internal, cg, 0.0)
            node_h[:, child_ids] = torch.where(is_internal, ch, 0.0)

        row_feat = torch.gather(feat_upd, 1, local)  # (K, n)
        row_bin = torch.gather(best_bin, 1, local)
        row_vals = bins[rows[None, :], row_feat.clamp(min=0)]
        goes_left = row_vals <= row_bin
        split_here = valid & (row_feat >= 0)
        child = 2 * node_of_row + torch.where(goes_left, 1, 2)
        node_of_row = torch.where(split_here, child, node_of_row)

    leaf_value = -node_g / (node_h + lam)
    return feature, split_bin, leaf_value, torch.gather(leaf_value, 1, node_of_row)


def _gbdt_fit(
    bins: torch.Tensor,  # (n, d) int32
    y: torch.Tensor,  # (n,) int64
    masks: torch.Tensor | None,  # (rounds, n) f32 row masks, None → all rows
    num_classes: int,
    num_rounds: int,
    max_depth: int,
    max_bins: int,
    learning_rate: float,
    lam: float,
    min_child_weight: float,
):
    """(feature, split_bin, leaf_value), each (rounds, K, nodes)."""
    n = bins.shape[0]
    y1h = torch.nn.functional.one_hot(y, num_classes).to(torch.float32)
    raw = torch.zeros((n, num_classes), dtype=torch.float32, device=bins.device)
    out = []
    for r in range(num_rounds):
        p = torch.softmax(raw, dim=-1)
        g = p - y1h  # (n, K)
        h = torch.clamp(p * (1.0 - p), min=1e-6)
        if masks is not None:
            g, h = g * masks[r, :, None], h * masks[r, :, None]
        feature, split_bin, leaf_value, contrib = _grow_reg_trees(
            bins, g.T.contiguous(), h.T.contiguous(), max_depth, max_bins,
            lam, min_child_weight,
        )
        raw = raw + learning_rate * contrib.T
        out.append((feature, split_bin, leaf_value))
    return tuple(torch.stack(parts) for parts in zip(*out))


def subsample_masks(n: int, num_rounds: int, subsample: float, seed: int,
                    device: torch.device) -> torch.Tensor | None:
    """(rounds, n) float32 row masks, each row kept with probability
    ``subsample``, from a CPU generator seeded by ``seed`` (so every
    device draws the same masks); None at subsample 1.0, which keeps
    every row."""
    if subsample >= 1.0:
        return None
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((num_rounds, n), generator=gen)
    return (u < subsample).to(torch.float32).to(device)


def _gbdt_predict(feature, split_bin, leaf_value, bins, learning_rate, max_depth):
    """(n, K) raw scores: every (round, class) tree walked ``max_depth``
    steps (left when ``bin <= split_bin``), its leaf values summed over the
    rounds and scaled by the learning rate."""
    rounds, classes, nodes = feature.shape
    n = bins.shape[0]
    feat = feature.reshape(rounds * classes, nodes).long()
    sbin = split_bin.reshape(rounds * classes, nodes)
    leaf = leaf_value.reshape(rounds * classes, nodes)
    node = torch.zeros((rounds * classes, n), dtype=torch.int64, device=bins.device)
    rows = torch.arange(n, device=bins.device)[None, :]
    for _ in range(max_depth):
        f = torch.gather(feat, 1, node)
        val = bins[rows, f.clamp(min=0)]
        child = 2 * node + torch.where(val <= torch.gather(sbin, 1, node), 1, 2)
        node = torch.where(f < 0, node, child)
    contrib = torch.gather(leaf, 1, node).reshape(rounds, classes, n)
    return learning_rate * contrib.sum(0).T


@dataclasses.dataclass(frozen=True)
class GradientBoostedTreesClassifier:
    """Multiclass second-order boosted trees (see the module doc)."""

    num_rounds: int = 100
    max_depth: int = 5
    max_bins: int = 32
    learning_rate: float = 0.2
    reg_lambda: float = 1.0
    min_child_weight: float = 1e-3
    subsample: float = 1.0
    seed: int = 0
    num_classes: int | None = None
    device: str = "cuda"

    def copy_with(self, **params) -> "GradientBoostedTreesClassifier":
        return dataclasses.replace(self, **params)

    def fit(self, data: FeatureSet, masks=None) -> "GradientBoostedTreesModel":
        """Fit on ``data``; ``masks`` ((rounds, n) row masks) replaces the
        subsample draw."""
        device = resolve_device(self.device)
        x = torch.as_tensor(np.asarray(data.features, np.float32)).to(device)
        y = torch.as_tensor(np.asarray(data.label), dtype=torch.int64).to(device)
        num_classes = self.num_classes or int(data.label.max()) + 1
        thresholds = quantile_thresholds(x, self.max_bins)
        bins = binize(x, thresholds)
        if masks is None:
            masks = subsample_masks(
                len(y), self.num_rounds, self.subsample, self.seed, device
            )
        else:
            masks = torch.as_tensor(np.asarray(masks, np.float32)).to(device)
        feature, split_bin, leaf_value = _gbdt_fit(
            bins, y, masks,
            num_classes=num_classes,
            num_rounds=self.num_rounds,
            max_depth=self.max_depth,
            max_bins=self.max_bins,
            learning_rate=self.learning_rate,
            lam=self.reg_lambda,
            min_child_weight=self.min_child_weight,
        )
        return GradientBoostedTreesModel(
            feature=feature.cpu().numpy(),
            split_bin=split_bin.cpu().numpy(),
            leaf_value=leaf_value.cpu().numpy(),
            thresholds=thresholds.cpu().numpy(),
            learning_rate=self.learning_rate,
            max_depth=self.max_depth,
            num_classes=num_classes,
            device=self.device,
        )


@dataclasses.dataclass(frozen=True)
class GradientBoostedTreesModel:
    feature: np.ndarray  # (rounds, K, nodes) int32, -1 for leaves
    split_bin: np.ndarray  # (rounds, K, nodes) int32
    leaf_value: np.ndarray  # (rounds, K, nodes) f32
    thresholds: np.ndarray  # (d, B-1) f32
    learning_rate: float
    max_depth: int
    num_classes: int
    device: str = "cuda"

    def predict_raw(self, x: np.ndarray) -> np.ndarray:
        device = resolve_device(self.device)
        bins = binize(
            torch.as_tensor(np.asarray(x, np.float32)).to(device),
            torch.as_tensor(self.thresholds).to(device),
        )
        raw = _gbdt_predict(
            torch.as_tensor(self.feature).to(device),
            torch.as_tensor(self.split_bin).to(device),
            torch.as_tensor(self.leaf_value).to(device),
            bins,
            self.learning_rate,
            self.max_depth,
        )
        return raw.cpu().numpy()

    def transform(self, data: FeatureSet) -> Predictions:
        raw = self.predict_raw(np.asarray(data.features, np.float32))
        probs = torch.softmax(torch.from_numpy(raw), dim=-1).numpy()
        return Predictions.from_raw(raw, probs)
