"""L-BFGS with a zoom line search, batched over independent lanes.

A port of the solver ``har_tpu/models/logistic_regression.py`` runs:
optax 0.2.6's ``lbfgs()``, that is

  - ``scale_by_lbfgs`` (optax/_src/transform.py): memory 10, the initial
    inverse-Hessian scale ``<dw, du> / <du, du>`` (``scale_init_precond``),
    and a first step scaled by ``min(1, 1 / ||grad||)``;
  - ``scale(-1)``;
  - ``scale_by_zoom_linesearch`` (optax/_src/linesearch.py) with at most
    20 steps, an initial guess of 1 each iteration, slope_rtol 1e-4,
    curv_rtol 0.9, approx_dec_rtol 1e-6, stepsize_precision 1e-5 and
    increase_factor 2;
  - ``value_and_grad_from_state``: each iteration reuses the value and
    gradient the line search ended on, unless it is not finite.

``torch.optim.LBFGS`` is another algorithm (a strong-Wolfe search of its
own, another initial step) and lands elsewhere after 20 iterations.

**Lanes.** Every tensor carries ``lane_ndim`` leading lane dimensions; a
lane is one independent problem (one (reg_param, fold) fit of a CV
sweep).  The JAX package runs its lanes under ``vmap``, where the line
search's ``while_loop`` goes on until every lane is done and a lane that
is done keeps its state; here every step is computed for all lanes and a
lane's state changes only while it is still searching, so each lane
follows the unbatched algorithm.  Whether any lane is still searching is
read on the host once per line-search step: ``HOST_SYNCS`` counts those
reads.

Under ``vmap`` each ``lax.cond`` of the line search computes both
branches and selects; here the step first picks each lane's trial
stepsize (the interval search's or the zoom's), evaluates the objective
once there, and then applies the branch the lane is in.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# host reads of "is any lane still searching" (one per line-search step),
# summed over every solver in the process; chip_smoke.py reports them
HOST_SYNCS = 0

# optax 0.2.6's lbfgs() defaults, the JAX package's solver
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5
INCREASE_FACTOR = 2.0

Params = tuple[torch.Tensor, ...]
# params -> (value per lane, gradient with the params' shapes)
ValueAndGrad = Callable[[Params], tuple[torch.Tensor, Params]]


def _lanes(s: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A per-lane value shaped to broadcast against ``leaf``."""
    return s.reshape(s.shape + (1,) * (leaf.dim() - s.dim()))


def _vdot(xs: Params, ys: Params, lane_ndim: int) -> torch.Tensor:
    """Per-lane inner product of two parameter tuples."""
    total = None
    for x, y in zip(xs, ys):
        v = (x * y).flatten(lane_ndim).sum(-1)
        total = v if total is None else total + v
    return total


def _add_scale(xs: Params, s: torch.Tensor, ys: Params) -> Params:
    """xs + s * ys, with s per lane."""
    return tuple(x + _lanes(s, y) * y for x, y in zip(xs, ys))


def _where(cond: torch.Tensor, a, b):
    """Per-lane select between two tensors or two parameter tuples."""
    if isinstance(a, tuple):
        return tuple(torch.where(_lanes(cond, x), x, y) for x, y in zip(a, b))
    return torch.where(_lanes(cond, a), a, b)


class LineSearch(NamedTuple):
    """One line search's state per lane (optax's ZoomLinesearchState)."""

    count: torch.Tensor
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: Params
    slope: torch.Tensor
    value_init: torch.Tensor
    slope_init: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: Params

    def select(self, cond: torch.Tensor, other: "LineSearch") -> "LineSearch":
        """Per lane: this state where ``cond``, else ``other``."""
        return LineSearch(*(_where(cond, a, b) for a, b in zip(self, other)))


class State(NamedTuple):
    """The solver's state: the L-BFGS memory and the last line search's
    stepsize, value and gradient."""

    count: int
    params: Params
    updates: Params
    diff_params: tuple[torch.Tensor, ...]  # (memory, *leaf) per leaf
    diff_updates: tuple[torch.Tensor, ...]
    rhos: torch.Tensor  # (memory, *lanes)
    value: torch.Tensor  # (*lanes,) the line search's last value
    grad: Params
    value_is_finite: bool  # every lane's ``value`` is finite


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none (optax's ``_cubicmin``)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * dc * dc) * v0 + db * db * db * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


class LBFGS:
    """optax 0.2.6 ``lbfgs()`` over ``lane_ndim`` leading lane dimensions.

    One iteration, as the JAX package's scan body runs it::

        value, grad = solver.value_and_grad_from_state(params, state)
        params, state = solver.update(params, value, grad, state)
    """

    def __init__(self, value_and_grad: ValueAndGrad, lane_ndim: int):
        self.value_and_grad = value_and_grad
        self.lane_ndim = lane_ndim

    def init(self, params: Params) -> State:
        lanes = params[0].shape[: self.lane_ndim]
        zeros = tuple(torch.zeros_like(p) for p in params)
        memory = tuple(
            torch.zeros((MEMORY_SIZE,) + p.shape, dtype=p.dtype, device=p.device)
            for p in params
        )
        return State(
            count=0,
            params=zeros,
            updates=zeros,
            diff_params=memory,
            diff_updates=memory,
            rhos=torch.zeros(
                (MEMORY_SIZE,) + lanes, dtype=params[0].dtype,
                device=params[0].device,
            ),
            value=torch.full(lanes, torch.inf, dtype=params[0].dtype,
                             device=params[0].device),
            grad=zeros,
            value_is_finite=False,
        )

    def value_and_grad_from_state(
        self, params: Params, state: State
    ) -> tuple[torch.Tensor, Params]:
        """The line search's last value and gradient, or a fresh evaluation
        for the lanes where that value is not finite."""
        if state.value_is_finite:
            return state.value, state.grad
        value, grad = self.value_and_grad(params)
        keep = torch.isfinite(state.value)
        return _where(keep, state.value, value), _where(keep, state.grad, grad)

    # --- scale_by_lbfgs -------------------------------------------------
    def _direction(self, grad: Params, params: Params, state: State):
        """The L-BFGS direction P_k grad and the updated memory."""
        m, k, lane_ndim = MEMORY_SIZE, state.count, self.lane_ndim
        memory_idx, prev_idx = k % m, (k - 1) % m
        diff_params = [dp.clone() for dp in state.diff_params]
        diff_updates = [du.clone() for du in state.diff_updates]
        rhos = state.rhos.clone()
        if k > 0:
            dw = tuple(p - q for p, q in zip(params, state.params))
            du = tuple(g - h for g, h in zip(grad, state.updates))
            vdot = _vdot(du, dw, lane_ndim)
            rhos[prev_idx] = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
            for mem, new in zip(diff_params, dw):
                mem[prev_idx] = new
            for mem, new in zip(diff_updates, du):
                mem[prev_idx] = new
            denominator = _vdot(du, du, lane_ndim)
            identity_scale = torch.where(
                denominator > 0.0, vdot / denominator, 1.0
            )
        else:
            # optax writes zeros into slot (k - 1) % m here: init left them
            identity_scale = torch.minimum(
                torch.ones_like(state.value),
                1.0 / torch.sqrt(_vdot(grad, grad, lane_ndim)),
            )

        # two-loop recursion over the filled slots, newest first; an empty
        # slot (rho 0, differences 0) leaves the vector unchanged
        order = [(memory_idx + i) % m for i in range(m)][m - min(k, m):]
        vec, alphas = grad, {}
        for idx in reversed(order):
            dwi = tuple(mem[idx] for mem in diff_params)
            dui = tuple(mem[idx] for mem in diff_updates)
            alphas[idx] = rhos[idx] * _vdot(dwi, vec, lane_ndim)
            vec = _add_scale(vec, -alphas[idx], dui)
        vec = tuple(_lanes(identity_scale, v) * v for v in vec)
        for idx in order:
            dwi = tuple(mem[idx] for mem in diff_params)
            dui = tuple(mem[idx] for mem in diff_updates)
            beta = rhos[idx] * _vdot(dui, vec, lane_ndim)
            vec = _add_scale(vec, alphas[idx] - beta, dwi)
        return vec, tuple(diff_params), tuple(diff_updates), rhos

    # --- zoom line search ----------------------------------------------
    def _decrease_error(self, stepsize, value, slope, value_init, slope_init):
        error = value - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta_values = value - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
        error = torch.minimum(torch.maximum(approx, delta_values), error)
        error = torch.clamp_min(error, 0.0)
        return torch.where(torch.isnan(error), torch.inf, error)

    def _curvature_error(self, slope, slope_init):
        error = torch.clamp_min(
            torch.abs(slope) - CURV_RTOL * torch.abs(slope_init), 0.0
        )
        return torch.where(torch.isnan(error), torch.inf, error)

    def _init_search(self, params, updates, value, grad) -> LineSearch:
        slope = _vdot(updates, grad, self.lane_ndim)
        zero = torch.zeros_like(value)
        inf = torch.full_like(value, torch.inf)
        false = torch.zeros_like(value, dtype=torch.bool)
        return LineSearch(
            count=torch.zeros_like(value, dtype=torch.int32),
            stepsize=zero, value=value, grad=grad, slope=slope,
            value_init=value, slope_init=slope,
            decrease_error=inf, curvature_error=inf,
            interval_found=false, done=false, failed=false,
            low=zero, value_low=value, slope_low=slope,
            high=zero, value_high=value, slope_high=slope,
            cubic_ref=zero, value_cubic_ref=value,
            safe_stepsize=zero, safe_value=value, safe_grad=grad,
        )

    def _search_step(self, s: LineSearch, params, updates) -> LineSearch:
        """One step of every lane: the interval search (Nocedal and Wright
        Algorithm 3.5) where no interval is found yet, else the zoom
        (Algorithm 3.6), then the safe step where the search failed."""
        # the zoom's trial point: cubic, else quadratic, else bisection
        delta = torch.abs(s.high - s.low)
        left = torch.minimum(s.high, s.low)
        right = torch.maximum(s.high, s.low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        middle_cubic = _cubicmin(
            s.low, s.value_low, s.slope_low, s.high, s.value_high,
            s.cubic_ref, s.value_cubic_ref,
        )
        use_cubic = (middle_cubic > left + cubic_chk) & (middle_cubic < right - cubic_chk)
        middle_quad = _quadmin(s.low, s.value_low, s.slope_low, s.high, s.value_high)
        use_quad = (~use_cubic) & (middle_quad > left + quad_chk) & (
            middle_quad < right - quad_chk
        )
        middle = torch.where(use_cubic, middle_cubic, s.cubic_ref)
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(
            (~use_cubic) & (~use_quad), (s.low + s.high) / 2.0, middle
        )
        # the interval search's trial point
        larger = torch.where(
            s.count == 0, torch.ones_like(s.stepsize),
            INCREASE_FACTOR * s.stepsize,
        )
        stepsize = torch.where(s.interval_found, middle, larger)

        value, grad = self.value_and_grad(_add_scale(params, stepsize, updates))
        slope = _vdot(grad, updates, self.lane_ndim)
        decrease_error = self._decrease_error(
            stepsize, value, slope, s.value_init, s.slope_init
        )
        curvature_error = self._curvature_error(slope, s.slope_init)
        done = torch.maximum(decrease_error, curvature_error) <= 0.0
        safe_decrease = decrease_error <= 0.0
        last_step = s.count + 1 >= MAX_LINESEARCH_STEPS
        new = dict(
            count=s.count + 1, stepsize=stepsize, value=value, grad=grad,
            slope=slope, value_init=s.value_init, slope_init=s.slope_init,
            decrease_error=decrease_error, curvature_error=curvature_error,
            done=done,
        )

        # interval search
        set_high = (decrease_error > 0.0) | ((value >= s.value) & (s.count > 0))
        set_low = (slope >= 0.0) & ~set_high
        low, value_low, slope_low, high, value_high, slope_high = (
            _where(set_low, a, b)
            for a, b in zip(
                (stepsize, value, slope, s.stepsize, s.value, s.slope),
                (s.stepsize, s.value, s.slope, stepsize, value, slope),
            )
        )
        searched = LineSearch(
            **new,
            interval_found=set_high | set_low | done,
            failed=last_step & ~done,
            low=low, value_low=value_low, slope_low=slope_low,
            high=high, value_high=value_high, slope_high=slope_high,
            cubic_ref=low, value_cubic_ref=value_low,
            safe_stepsize=_where(safe_decrease, stepsize, s.safe_stepsize),
            safe_value=_where(safe_decrease, value, s.safe_value),
            safe_grad=_where(safe_decrease, grad, s.safe_grad),
        )

        # zoom
        update_safe = safe_decrease & (value < s.safe_value)
        safe_stepsize = _where(update_safe, stepsize, s.safe_stepsize)
        high_to_middle = (decrease_error > 0.0) | (value >= s.value_low)
        high_to_low = (slope * (s.high - s.low) >= 0.0) & ~high_to_middle
        high, value_high, slope_high = (
            _where(high_to_low, lo, _where(high_to_middle, mid, hi))
            for lo, mid, hi in zip(
                (s.low, s.value_low, s.slope_low),
                (stepsize, value, slope),
                (s.high, s.value_high, s.slope_high),
            )
        )
        low, value_low, slope_low = (
            _where(~high_to_middle, mid, lo)
            for mid, lo in zip(
                (stepsize, value, slope), (s.low, s.value_low, s.slope_low)
            )
        )
        moved_high = high_to_middle | high_to_low
        too_small = delta <= STEPSIZE_PRECISION
        zoomed = LineSearch(
            **new,
            interval_found=s.interval_found,
            failed=(last_step | (too_small & (safe_stepsize > 0.0))) & ~done,
            low=low, value_low=value_low, slope_low=slope_low,
            high=high, value_high=value_high, slope_high=slope_high,
            cubic_ref=_where(moved_high, s.high, s.low),
            value_cubic_ref=_where(moved_high, s.value_high, s.value_low),
            safe_stepsize=safe_stepsize,
            safe_value=_where(update_safe, value, s.safe_value),
            safe_grad=_where(update_safe, grad, s.safe_grad),
        )

        out = zoomed.select(s.interval_found, searched)
        # a failed search takes its safe point, if it has one
        use_safe = out.failed & (
            (out.safe_stepsize > 0.0) | torch.isinf(out.decrease_error)
        )
        return out._replace(
            stepsize=_where(use_safe, out.safe_stepsize, out.stepsize),
            value=_where(use_safe, out.safe_value, out.value),
            grad=_where(use_safe, out.safe_grad, out.grad),
        )

    def _line_search(self, params, updates, value, grad):
        """The line search's final state, and whether every lane's final
        value is finite (read with the last "still searching" flag)."""
        global HOST_SYNCS
        s = self._init_search(params, updates, value, grad)
        for step in range(MAX_LINESEARCH_STEPS):
            searching = ~(s.done | s.failed)
            s = self._search_step(s, params, updates).select(searching, s)
            # after the last step every lane has failed or is done
            last = step + 1 == MAX_LINESEARCH_STEPS
            flags = torch.stack([
                torch.zeros((), dtype=torch.bool, device=s.done.device)
                if last else (~(s.done | s.failed)).any(),
                torch.isfinite(s.value).all(),
            ])
            HOST_SYNCS += 1
            still_searching, finite = flags.tolist()
            if not still_searching:
                break
        return s, finite

    def update(
        self, params: Params, value: torch.Tensor, grad: Params, state: State
    ) -> tuple[Params, State]:
        """One L-BFGS iteration from ``params``, whose value and gradient
        are ``value`` and ``grad``: the new params and state."""
        direction, diff_params, diff_updates, rhos = self._direction(
            grad, params, state
        )
        updates = tuple(-1.0 * d for d in direction)
        s, finite = self._line_search(params, updates, value, grad)
        new_params = tuple(
            p + _lanes(s.stepsize, u) * u for p, u in zip(params, updates)
        )
        return new_params, State(
            count=state.count + 1,
            params=params,
            updates=grad,
            diff_params=diff_params,
            diff_updates=diff_updates,
            rhos=rhos,
            value=s.value,
            grad=s.grad,
            value_is_finite=finite,
        )
