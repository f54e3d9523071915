"""Multinomial logistic regression, trained full-batch on the device.

Port of the fast lane of ``har_tpu/models/logistic_regression.py``
(reference Main/main.py:115-117 — maxIter=20, regParam=0.3,
elasticNetParam=0).  Objective, as MLlib documents it:

    (1/n) Σ softmax-cross-entropy
  + reg_param * [ (1-α)/2 ||W||₂² + α ||W||₁ ]

over features standardized to unit variance (weighted mean and variance
with Bessel's correction), the intercept unregularized and started at the
log of the class priors, and coefficients returned in the original
feature space.  α = elastic_net_param.

Solvers: optax's L-BFGS (:mod:`har_tpu_torch.models.lbfgs`) for α = 0;
FISTA with a soft-threshold prox for α > 0.  Both keep the best iterate
seen; L-BFGS returns the final iterate when it scores at least as low.

**Lanes.** One fit is one lane; a CV sweep fits every (fold, reg_param)
pair of an elastic_net_param group at once, as the JAX package's nested
``vmap`` does: lanes are ``(F, R)``, each fold's standardized rows are
built once, and the R fits of a fold share one batched matmul.  Every
matmul runs in full float32 (no TF32), as the JAX package's "highest"
precision does.  The JAX docstring's caveat holds: the iterate after 20
steps depends on the order of float arithmetic, so the port agrees with
it within a tolerance (tests/test_torch_logistic_regression.py), not bit
for bit.

With a ``mesh`` (``parallel.mesh``), ``cv_scores`` splits the lanes of
its (reg × fold) sweep over the data ranks, padded to a multiple of the
shard count by repeating the last reg, and all-gathers the score matrix,
so every rank returns the same scores.

Not ported here: the bit-exact MLlib replay lane (item 4, exact lane).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from har_tpu_torch.device import resolve_device
from har_tpu_torch.features.wisdm_pipeline import FeatureSet
from har_tpu_torch.models.base import Predictions
from har_tpu_torch.models.lbfgs import LBFGS
from har_tpu_torch.parallel.data_parallel import gather_data_shards
from har_tpu_torch.parallel.mesh import data_shard_count, linear_data_shard_index

# in-program validation metrics of the vectorized CV sweep; the reference's
# quirky MAE over label indices included
_CV_METRICS = ("accuracy", "mae", "mse", "rmse")


@contextlib.contextmanager
def full_f32():
    """float32 matmuls at full precision (no TF32) inside the block only."""
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(previous)


class _Objective:
    """The smooth loss of every lane: lanes ``(F, R)``, F design matrices
    ``xs (F, m, d)`` (standardized) shared by R penalties ``l2 (R,)``.
    Params are ``w (F, R, d, C)`` and ``b (F, R, C)``."""

    def __init__(self, xs, y1h, row_w, n_eff, l2):
        self.xs, self.y1h, self.n_eff, self.l2 = xs, y1h, n_eff, l2
        self.row_w = row_w[:, :, None]  # (F, m, 1): broadcast over R

    def _logits(self, w, b):
        f, r, d, c = w.shape
        wide = w.permute(0, 2, 1, 3).reshape(f, d, r * c)
        return torch.bmm(self.xs, wide).view(f, -1, r, c) + b[:, None]

    def _value(self, w, logits):
        ce = -(self.y1h[:, :, None, :] * torch.log_softmax(logits, -1)).sum(-1)
        data = (ce * self.row_w).sum(1) / self.n_eff[:, None]
        return data + 0.5 * self.l2 * (w * w).sum((2, 3))

    def value(self, params):
        w, b = params
        return self._value(w, self._logits(w, b))

    def value_and_grad(self, params):
        w, b = params
        f, r, d, c = w.shape
        logits = self._logits(w, b)
        # d/dlogits of the weighted mean cross-entropy: (p - y) w_i / n_eff
        g = (torch.softmax(logits, -1) - self.y1h[:, :, None, :]) * (
            self.row_w[..., None] / self.n_eff[:, None, None, None]
        )
        gw = torch.bmm(self.xs.transpose(1, 2), g.reshape(f, -1, r * c))
        gw = gw.view(f, d, r, c).permute(0, 2, 1, 3) + self.l2[:, None, None] * w
        return self._value(w, logits), (gw, g.sum(1))


def _train_lanes(
    x: torch.Tensor,  # (F, m, d) each fold's rows
    y: torch.Tensor,  # (F, m) int64
    row_w: torch.Tensor,  # (F, m) 0 = padding; class weights otherwise
    reg: torch.Tensor,  # (R,) float32
    num_classes: int,
    max_iter: int,
    elastic_net_param: float,
    fit_intercept: bool,
    standardize: bool,
):
    """Fit every (fold, reg) lane: ``w (F, R, d, C)``, ``b (F, R, C)`` in
    the unscaled feature space and the losses ``(max_iter, F, R)``; the
    body of ``_train_core_impl`` (har_tpu/models/logistic_regression.py:79)
    with lanes in front."""
    f, m, d = x.shape
    r = reg.shape[0]
    y1h = torch.nn.functional.one_hot(y, num_classes).to(x.dtype)
    n_eff = torch.clamp_min(row_w.sum(1), 1.0)  # (F,)

    if standardize:
        # weighted mean and variance with Bessel's correction: np.std(ddof=1)
        # on unit weights, blind to zero-weight padding rows
        mean = (x * row_w[:, :, None]).sum(1) / n_eff[:, None]
        var = ((x - mean[:, None]) ** 2 * row_w[:, :, None]).sum(1) / torch.clamp_min(
            n_eff - 1.0, 1.0
        )[:, None]
        std = torch.sqrt(var)
        inv_std = torch.where(std > 0, 1.0 / torch.clamp_min(std, 1e-30), 0.0)
    else:
        inv_std = torch.ones((f, d), dtype=x.dtype, device=x.device)
    xs = x * inv_std[:, None]  # the penalty applies in this space

    l2 = reg * (1.0 - elastic_net_param)
    l1 = reg * elastic_net_param
    objective = _Objective(xs, y1h, row_w, n_eff, l2)

    w0 = torch.zeros((f, r, d, num_classes), dtype=x.dtype, device=x.device)
    if fit_intercept:
        # MLlib starts the intercepts at the log of the class priors
        prior = (y1h * row_w[:, :, None]).sum(1) / n_eff[:, None]
        b0 = torch.log(torch.clamp_min(prior, 1e-12))[:, None].expand(
            f, r, num_classes
        ).contiguous()
    else:
        b0 = torch.zeros((f, r, num_classes), dtype=x.dtype, device=x.device)

    # both solvers are non-monotone, so each keeps its best-seen iterate
    best_loss = torch.full((f, r), torch.inf, dtype=x.dtype, device=x.device)
    best = (w0, b0)

    def keep_best(value, params):
        nonlocal best_loss, best
        improved = value < best_loss
        best_loss = torch.where(improved, value, best_loss)
        best = tuple(
            torch.where(improved.view(f, r, *(1,) * (p.dim() - 2)), p, q)
            for p, q in zip(params, best)
        )

    losses = []
    if elastic_net_param == 0.0:  # no L1 term: the smooth solver
        solver = LBFGS(objective.value_and_grad, lane_ndim=2)
        params = (w0, b0)
        state = solver.init(params)
        for _ in range(max_iter):
            value, grad = solver.value_and_grad_from_state(params, state)
            keep_best(value, params)
            params, state = solver.update(params, value, grad, state)
            losses.append(value)
        # final iterate against the best seen: keep whichever scores lower
        take_final = objective.value(params) <= best_loss
        w, b = (
            torch.where(take_final.view(f, r, *(1,) * (p.dim() - 2)), p, q)
            for p, q in zip(params, best)
        )
    else:
        # FISTA, step 1/L with L >= ||Xs||² / (2n) + l2
        lip = (xs * xs * row_w[:, :, None]).sum((1, 2)) / n_eff
        lip = lip[:, None] * 0.5 + l2 + 1e-6  # (F, R)
        lr = (1.0 / lip)[:, :, None, None]
        thresh = lr * l1[:, None, None]
        # the momentum sequence is the same for every lane: host scalars
        # of the design's float type
        real = np.float64 if x.dtype == torch.float64 else np.float32
        t_prev = real(1.0)
        w, b = zw, zb = w0, b0
        for _ in range(max_iter):
            _, (g_w, g_b) = objective.value_and_grad((zw, zb))
            w_new = zw - lr * g_w
            w_new = torch.sign(w_new) * torch.clamp_min(torch.abs(w_new) - thresh, 0.0)
            b_new = zb - lr[..., 0] * g_b
            t_new = real(0.5) * (real(1.0) + np.sqrt(real(1.0) + real(4.0) * t_prev**2))
            beta = float((t_prev - real(1.0)) / t_new)
            zw = w_new + beta * (w_new - w)
            zb = b_new + beta * (b_new - b)
            w, b, t_prev = w_new, b_new, t_new
            value = objective.value((w, b)) + l1 * torch.abs(w).sum((2, 3))
            keep_best(value, (w, b))
            losses.append(value)
        w, b = best  # every iterate's value went through keep_best

    if not fit_intercept:
        b = torch.zeros_like(b)
    return w * inv_std[:, None, :, None], b, torch.stack(losses)


def _pad_fold_indices(folds):
    """Equal-length index/mask arrays from ragged (train, val) folds."""
    tmax = max(len(t) for t, _ in folds)
    vmax = max(len(v) for _, v in folds)

    def pad(idx, m):
        out = np.zeros((len(folds), m), np.int32)
        w = np.zeros((len(folds), m), np.float32)
        for i, a in enumerate(idx):
            out[i, : len(a)] = a
            w[i, : len(a)] = 1.0
        return out, w

    tidx, tw = pad([t for t, _ in folds], tmax)
    vidx, vw = pad([v for _, v in folds], vmax)
    return tidx, tw, vidx, vw


def _cv_scores_group(
    x, y, train_idx, train_w, val_idx, val_w, reg_params, num_classes,
    max_iter, elastic_net_param, fit_intercept, standardize, metric,
):
    """(R, F) validation scores of one elastic_net_param group, every
    (reg, fold) fit as one lane; scored in float32 as the JAX program
    scores them, so tied grid points stay tied."""
    w, b, _ = _train_lanes(
        x[train_idx], y[train_idx], train_w, reg_params, num_classes,
        max_iter, elastic_net_param, fit_intercept, standardize,
    )
    f, r, d, c = w.shape
    wide = w.permute(0, 2, 1, 3).reshape(f, d, r * c)
    logits = torch.bmm(x[val_idx], wide).view(f, -1, r, c) + b[:, None]
    pred = torch.argmax(logits, -1).to(torch.float32)  # (F, v, R)
    yv = y[val_idx].to(torch.float32)[:, :, None]
    vw = val_w[:, :, None]
    n_eff = torch.clamp_min(val_w.sum(1), 1.0)[:, None]
    if metric == "accuracy":
        scores = ((pred == yv) * vw).sum(1) / n_eff
    else:
        err = (yv - pred) * vw
        if metric == "mae":
            scores = torch.abs(err).sum(1) / n_eff
        else:
            scores = (err * err).sum(1) / n_eff
            if metric == "rmse":
                scores = torch.sqrt(scores)
    return scores.T  # (R, F)


def objective(model, data: FeatureSet, reg_param: float,
              elastic_net_param: float = 0.0) -> float:
    """A fitted model's objective on ``data`` in float64, with unit row
    weights and standardization: mean cross-entropy plus the penalty on
    the coefficients in the standardized space.  A yardstick for the
    tests and chip_smoke.py; no fit calls it."""
    x = np.asarray(data.features, np.float64)
    y = np.asarray(data.label)
    logits = x @ np.asarray(model.coefficients, np.float64) + np.asarray(
        model.intercept, np.float64
    )
    top = logits.max(-1, keepdims=True)
    lse = top[:, 0] + np.log(np.exp(logits - top).sum(-1))
    ce = (lse - logits[np.arange(len(y)), y]).mean()
    scaled = np.asarray(model.coefficients, np.float64) * x.std(0, ddof=1)[:, None]
    return float(
        ce
        + reg_param * (1.0 - elastic_net_param) / 2.0 * (scaled**2).sum()
        + reg_param * elastic_net_param * np.abs(scaled).sum()
    )


@dataclasses.dataclass(frozen=True)
class LogisticRegression:
    """Estimator with the reference's default hyperparameters
    (maxIter=20, regParam=0.3, elasticNetParam=0 — Main/main.py:115)."""

    max_iter: int = 20
    reg_param: float = 0.3
    elastic_net_param: float = 0.0
    fit_intercept: bool = True
    standardize: bool = True
    # None → every row weighs 1 (MLlib default); "balanced" reweighs rows
    # by n / (num_classes * count(class))
    class_weight: str | None = None
    num_classes: int | None = None  # inferred from labels when None
    # a parallel.mesh mesh of ranks: cv_scores splits the grid's lanes over
    # its data axes and gathers the scores; fit() ignores it
    mesh: object | None = dataclasses.field(default=None, compare=False, repr=False)
    device: str = "cuda"

    def copy_with(self, **params) -> "LogisticRegression":
        return dataclasses.replace(self, **params)

    def cv_scores(self, data: FeatureSet, folds, grid, metric: str):
        """Vectorized grid×fold sweep; (len(grid), len(folds)) scores.

        Returns None when a grid key or the metric falls outside the
        vectorizable set, or rows are class-weighted — the CrossValidator
        then takes its generic fit-per-cell path.
        """
        allowed = {"reg_param", "elastic_net_param"}
        if (
            metric not in _CV_METRICS
            or any(set(g) - allowed for g in grid)
            or self.class_weight is not None
        ):
            return None
        device = resolve_device(self.device)
        num_classes = self.num_classes or int(data.label.max()) + 1
        x = torch.as_tensor(data.features, dtype=torch.float32).to(device)
        y = torch.as_tensor(data.label, dtype=torch.int64).to(device)
        tidx, tw, vidx, vw = (
            torch.as_tensor(a).to(device) for a in _pad_fold_indices(folds)
        )

        # one batch of lanes per elastic_net_param (it picks the solver)
        scores = np.zeros((len(grid), len(folds)), np.float64)
        by_enp: dict[float, list[int]] = {}
        for i, g in enumerate(grid):
            enp = float(g.get("elastic_net_param", self.elastic_net_param))
            by_enp.setdefault(enp, []).append(i)
        with full_f32():
            for enp, idxs in by_enp.items():
                reg_vals = [float(grid[i].get("reg_param", self.reg_param)) for i in idxs]
                lanes = slice(None)
                if self.mesh is not None:
                    # this data shard's lanes of the (reg × fold) sweep; the
                    # padding lanes repeat the last reg and are dropped
                    shards = data_shard_count(self.mesh)
                    reg_vals += reg_vals[-1:] * ((-len(reg_vals)) % shards)
                    per = len(reg_vals) // shards
                    s = linear_data_shard_index(self.mesh)
                    lanes = slice(s * per, (s + 1) * per)
                regs = torch.tensor(reg_vals[lanes], dtype=torch.float32, device=device)
                out = _cv_scores_group(
                    x, y, tidx.long(), tw, vidx.long(), vw, regs, num_classes,
                    self.max_iter, enp, self.fit_intercept, self.standardize,
                    metric,
                )
                if self.mesh is not None:
                    # every rank returns the whole score matrix
                    out = gather_data_shards(out, self.mesh)
                scores[idxs] = out[: len(idxs)].cpu().numpy().astype(np.float64)
        return scores

    def fit(self, data: FeatureSet) -> "LogisticRegressionModel":
        if self.class_weight not in (None, "balanced"):
            raise ValueError(
                f"class_weight={self.class_weight!r}; use None or 'balanced'"
            )
        device = resolve_device(self.device)
        num_classes = self.num_classes or int(data.label.max()) + 1
        y_np = np.asarray(data.label)
        if self.class_weight == "balanced":
            counts = np.bincount(y_np, minlength=num_classes).astype(np.float32)
            per_class = len(y_np) / (num_classes * np.maximum(counts, 1.0))
            row_w = torch.as_tensor(per_class[y_np])
        else:
            row_w = torch.ones((len(y_np),), dtype=torch.float32)
        x = torch.as_tensor(data.features, dtype=torch.float32).to(device)
        y = torch.as_tensor(y_np, dtype=torch.int64).to(device)
        with full_f32():
            w, b, losses = _train_lanes(
                x[None], y[None], row_w.to(device)[None],
                torch.tensor([float(self.reg_param)], dtype=torch.float32, device=device),
                num_classes, self.max_iter, float(self.elastic_net_param),
                self.fit_intercept, self.standardize,
            )
        return LogisticRegressionModel(
            coefficients=w[0, 0].cpu().numpy(),
            intercept=b[0, 0].cpu().numpy(),
            num_classes=num_classes,
            losses=losses[:, 0, 0].cpu().numpy(),
            device=self.device,
        )


@dataclasses.dataclass(frozen=True)
class LogisticRegressionModel:
    coefficients: np.ndarray  # (d, C)
    intercept: np.ndarray  # (C,)
    num_classes: int
    # per-iteration loss trajectory: the pre-update point's loss for
    # L-BFGS, the accepted point's for FISTA; the coefficients are the
    # best point seen, so the model's own loss can sit below min(losses)
    losses: np.ndarray | None = None
    device: str = "cuda"

    def transform(self, data: FeatureSet) -> Predictions:
        device = resolve_device(self.device)
        with full_f32():
            logits = torch.as_tensor(data.features, dtype=torch.float32).to(
                device
            ) @ torch.as_tensor(self.coefficients).to(device) + torch.as_tensor(
                self.intercept
            ).to(device)
            probs = torch.softmax(logits, -1)
        return Predictions.from_raw(logits.cpu().numpy(), probs.cpu().numpy())
