"""Clean-room port of Breeze 0.13.2's LBFGS / OWLQN optimizer stack.

MLlib's LogisticRegression (the engine behind reference Main/main.py:115,
202-222) optimizes with ``breeze.optimize.LBFGS`` (elasticNetParam == 0) or
``breeze.optimize.OWLQN`` (elasticNet > 0), both built on
``FirstOrderMinimizer``.  The reference's published numbers are the iterate
these optimizers reach at maxIter=20 — far from the optimum — so matching
them requires replaying the exact trajectory: the same two-loop recursion,
the same Strong Wolfe / backtracking line searches, the same convergence
checks, the same failure/retry semantics, in the same IEEE-754 operation
order.

Bit-exactness notes (each deliberate, each breaks the replay if "fixed"):
  - All dot products (and the norms derived from them — Breeze's
    ``InnerProductModule`` defines norm(v) = sqrt(v dot v)) go through a
    strict left-to-right accumulator (`_jvm_native.ddot`), the order
    netlib-java's F2J ``ddot`` reduces in.  numpy.dot's pairwise/BLAS
    orders differ in the last ulp.
  - Elementwise vector arithmetic uses numpy float64, which matches the
    JVM's per-element semantics exactly (no FMA, no reassociation).
  - Scalar arithmetic happens in Python floats = IEEE doubles, written in
    the same association order as the Scala source.

The port covers exactly what MLlib exercises; it is not a general Breeze
replacement.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from har_tpu_torch.models._jvm_native import ddot


class FirstOrderException(Exception):
    """breeze.optimize.FirstOrderException and subclasses."""


def _norm(v: np.ndarray) -> float:
    """Breeze norm(v) via InnerProductModule: sqrt(v dot v), F2J order."""
    return math.sqrt(ddot(v, v))


# ---------------------------------------------------------------------------
# Line searches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Bracket:
    t: float
    dd: float
    fval: float


class StrongWolfeLineSearch:
    """breeze.optimize.StrongWolfeLineSearch (c1=1e-4, c2=0.9)."""

    def __init__(self, max_zoom_iter: int = 10, max_line_search_iter: int = 10):
        self.max_zoom_iter = max_zoom_iter
        self.max_line_search_iter = max_line_search_iter
        self.c1 = 1e-4
        self.c2 = 0.9

    @staticmethod
    def _interp(l: _Bracket, r: _Bracket) -> float:
        # CubicLineSearch.interp (N&W p57), incl. the 10%/90% clamping
        d1 = l.dd + r.dd - 3 * (l.fval - r.fval) / (l.t - r.t)
        d2 = math.sqrt(d1 * d1 - l.dd * r.dd) if d1 * d1 - l.dd * r.dd >= 0 else float("nan")
        multipler = r.t - l.t
        t = r.t - multipler * (r.dd + d2 - d1) / (r.dd - l.dd + 2 * d2)
        lw_bound = l.t + 0.1 * (r.t - l.t)
        up_bound = l.t + 0.9 * (r.t - l.t)
        if t < lw_bound:
            return lw_bound
        if t > up_bound:
            return up_bound
        return t

    def minimize(self, f: Callable[[float], tuple[float, float]], init: float) -> float:
        def phi(t: float) -> _Bracket:
            pval, pdd = f(t)
            return _Bracket(t=t, dd=pdd, fval=pval)

        t = init
        low = phi(0.0)
        fval = low.fval
        dd = low.dd

        if dd > 0:
            raise FirstOrderException(
                "Line search invoked with non-descent direction: " + str(dd)
            )

        c1, c2 = self.c1, self.c2

        def zoom(linit: _Bracket, rinit: _Bracket) -> float:
            lo = linit
            hi = rinit
            for _ in range(self.max_zoom_iter):
                # Interp assumes left less than right in t value; flip if needed
                if lo.t > hi.t:
                    t = self._interp(hi, lo)
                else:
                    t = self._interp(lo, hi)
                c = phi(t)
                if c.fval > fval + c1 * c.t * dd or c.fval >= lo.fval:
                    # sufficient decrease not satisfied: shrink at right
                    hi = c
                else:
                    if abs(c.dd) <= c2 * abs(dd):
                        return c.t
                    if c.dd * (hi.t - lo.t) >= 0:
                        hi = lo
                    lo = c
            raise FirstOrderException("Line search zoom failed")

        for i in range(self.max_line_search_iter):
            c = phi(t)
            if math.isinf(c.fval) or math.isnan(c.fval):
                t /= 2.0
            else:
                # Zoom if "sufficient decrease" condition is not satisfied
                if (c.fval > fval + c1 * t * dd) or (c.fval >= low.fval and i > 0):
                    return zoom(low, c)
                # No zoom needed if the strong wolfe condition already holds
                if abs(c.dd) <= c2 * abs(dd):
                    return c.t
                # If c.dd is positive, zoom on the inverted interval
                if c.dd >= 0:
                    return zoom(c, low)
                low = c
                t *= 1.5
        raise FirstOrderException("Line search failed")


class BacktrackingLineSearch:
    """breeze.optimize.BacktrackingLineSearch with OWLQN's parameters
    (enforce[Strong]WolfeConditions = true)."""

    def __init__(
        self,
        max_iterations: int = 20,
        shrink_step: float = 0.5,
        grow_step: float = 2.1,
        c_armijo: float = 1e-4,
        c_wolfe: float = 0.9,
        min_alpha: float = 1e-10,
        max_alpha: float = 1e10,
    ):
        self.max_iterations = max_iterations
        self.shrink_step = shrink_step
        self.grow_step = grow_step
        self.c_armijo = c_armijo
        self.c_wolfe = c_wolfe
        self.min_alpha = min_alpha
        self.max_alpha = max_alpha

    def minimize(self, f: Callable[[float], tuple[float, float]], init: float) -> float:
        f0, df0 = f(0.0)
        alpha = init
        fval, fderiv = f(init)
        it = 0
        while True:
            if fval > f0 + alpha * df0 * self.c_armijo:
                multiplier = self.shrink_step
            elif fderiv < self.c_wolfe * df0:
                multiplier = self.grow_step
            elif fderiv > -self.c_wolfe * df0:
                multiplier = self.shrink_step
            else:
                multiplier = 1.0
            if multiplier == 1.0:
                return alpha
            new_alpha = alpha * multiplier
            if it >= self.max_iterations:
                raise FirstOrderException("Too many iterations.")
            if new_alpha < self.min_alpha:
                raise FirstOrderException("Step size underflow")
            if new_alpha > self.max_alpha:
                raise FirstOrderException("Step size overflow")
            alpha = new_alpha
            fval, fderiv = f(alpha)
            it += 1


# ---------------------------------------------------------------------------
# L-BFGS history (two-loop recursion)
# ---------------------------------------------------------------------------


class _History:
    """LBFGS.ApproximateInverseHessian: memStep/memGradDelta deques
    (newest first), * = two-loop recursion returning the NEGATED direction."""

    def __init__(self, m: int, mem_step=None, mem_grad_delta=None):
        self.m = m
        self.mem_step: list[np.ndarray] = mem_step or []
        self.mem_grad_delta: list[np.ndarray] = mem_grad_delta or []

    def updated(self, step: np.ndarray, grad_delta: np.ndarray) -> "_History":
        return _History(
            self.m,
            ([step] + self.mem_step)[: self.m],
            ([grad_delta] + self.mem_grad_delta)[: self.m],
        )

    @property
    def history_length(self) -> int:
        return len(self.mem_step)

    def times(self, grad: np.ndarray) -> np.ndarray:
        hl = self.history_length
        if hl > 0:
            prev_step = self.mem_step[0]
            prev_grad_step = self.mem_grad_delta[0]
            sy = ddot(prev_step, prev_grad_step)
            yy = ddot(prev_grad_step, prev_grad_step)
            if sy < 0 or math.isnan(sy):
                raise FirstOrderException("NaN history")
            diag = sy / yy
        else:
            diag = 1.0

        dir = grad.copy()
        as_ = [0.0] * self.m
        rho = [0.0] * self.m
        for i in range(hl):
            rho[i] = ddot(self.mem_step[i], self.mem_grad_delta[i])
            as_[i] = ddot(self.mem_step[i], dir) / rho[i]
            if math.isnan(as_[i]):
                raise FirstOrderException("NaN history")
            # axpy(-as(i), memGradDelta(i), dir)
            dir += (-as_[i]) * self.mem_grad_delta[i]
        dir *= diag
        for i in range(hl - 1, -1, -1):
            beta = ddot(self.mem_grad_delta[i], dir) / rho[i]
            dir += (as_[i] - beta) * self.mem_step[i]
        dir *= -1.0
        return dir


# ---------------------------------------------------------------------------
# FirstOrderMinimizer state machine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class State:
    x: np.ndarray
    value: float
    grad: np.ndarray
    adjusted_value: float
    adjusted_gradient: np.ndarray
    iter: int
    initial_adj_val: float
    history: _History
    fval_info: tuple[float, ...]  # FunctionValuesConverged window
    search_failed: bool = False
    converged_reason: str | None = None


class LBFGS:
    """breeze.optimize.LBFGS with MLlib's construction
    (maxIter, m=10, tolerance) → defaultConvergenceCheck(maxIter, tol)
    [relative=false, fvalMemory=20]."""

    FVAL_MEMORY = 20

    def __init__(self, max_iter: int, m: int = 10, tolerance: float = 1e-6):
        self.max_iter = max_iter
        self.m = m
        self.tolerance = tolerance

    # --- hooks the OWLQN subclass overrides --------------------------------

    def adjust(
        self, new_x: np.ndarray, new_grad: np.ndarray, new_val: float
    ) -> tuple[float, np.ndarray]:
        return new_val, new_grad

    def choose_descent_direction(self, state: State) -> np.ndarray:
        return state.history.times(state.grad)

    def take_step(self, state: State, dir: np.ndarray, step_size: float) -> np.ndarray:
        return state.x + dir * step_size

    def determine_step_size(self, state: State, f, dir: np.ndarray) -> float:
        x = state.x
        grad = state.grad

        def ff(alpha: float) -> tuple[float, float]:
            v, g = f(x + dir * alpha)
            return v, ddot(g, dir)

        search = StrongWolfeLineSearch(max_zoom_iter=10, max_line_search_iter=10)
        alpha = search.minimize(ff, 1.0 / _norm(dir) if state.iter == 0.0 else 1.0)
        if alpha * _norm(grad) < 1e-10:
            raise FirstOrderException("Step size underflow")
        return alpha

    def update_history(
        self,
        new_x: np.ndarray,
        new_grad: np.ndarray,
        new_val: float,
        old_state: State,
    ) -> _History:
        return old_state.history.updated(
            new_x - old_state.x, new_grad - old_state.grad
        )

    # --- convergence (FirstOrderMinimizer.defaultConvergenceCheck) ---------

    def _converged(self, state: State) -> str | None:
        if state.iter >= self.max_iter and self.max_iter >= 0:
            return "max iterations"
        info = state.fval_info
        if len(info) >= 2 and abs(state.adjusted_value - max(info)) <= self.tolerance:
            return "function values converged"
        if _norm(state.adjusted_gradient) <= max(self.tolerance, 1e-8):
            return "gradient converged"
        if state.search_failed:
            return "line search failed"
        return None

    # --- the iteration loop ------------------------------------------------

    def _initial_state(self, f, init: np.ndarray) -> State:
        x = init
        history = _History(self.m)
        value, grad = f(x)
        adj_value, adj_grad = self.adjust(x, grad, value)
        return State(
            x=x,
            value=value,
            grad=grad,
            adjusted_value=adj_value,
            adjusted_gradient=adj_grad,
            iter=0,
            initial_adj_val=adj_value,
            history=history,
            fval_info=(),
        )

    def iterations(self, f, init: np.ndarray):
        """Yields the State sequence (initial state first), stopping
        inclusively at the first converged state — Breeze's
        ``iterations(...).takeUpToWhere`` consumed the way MLlib does
        (`while (states.hasNext) state = states.next()`)."""
        state = self._initial_state(f, init)
        failed_once = False
        while True:
            reason = self._converged(state)
            if reason is not None:
                state.converged_reason = reason
                yield state
                return
            yield state
            try:
                dir = self.choose_descent_direction(state)
                step_size = self.determine_step_size(state, f, dir)
                x = self.take_step(state, dir, step_size)
                value, grad = f(x)
                adj_value, adj_grad = self.adjust(x, grad, value)
                history = self.update_history(x, grad, value, state)
                new_info = (state.fval_info + (adj_value,))[-self.FVAL_MEMORY:]
                state = State(
                    x=x,
                    value=value,
                    grad=grad,
                    adjusted_value=adj_value,
                    adjusted_gradient=adj_grad,
                    iter=state.iter + 1,
                    initial_adj_val=state.initial_adj_val,
                    history=history,
                    fval_info=new_info,
                )
                failed_once = False
            except FirstOrderException:
                if not failed_once:
                    # "Failure! Resetting history"
                    failed_once = True
                    state = dataclasses.replace(
                        state, history=_History(self.m)
                    )
                else:
                    # "Failure again! Giving up and returning."
                    state = dataclasses.replace(state, search_failed=True)

    def minimize_state(self, f, init: np.ndarray) -> State:
        state = None
        for state in self.iterations(f, init):
            pass
        return state

    def minimize(self, f, init: np.ndarray) -> np.ndarray:
        return self.minimize_state(f, init).x


def _signum(x: float) -> float:
    if x > 0:
        return 1.0
    if x < 0:
        return -1.0
    return x  # preserves ±0.0 / NaN like scala math.signum


class OWLQN(LBFGS):
    """breeze.optimize.OWLQN[Int, DenseVector[Double]] as MLlib builds it:
    l1reg(index) = regParamL1 for coefficient entries, 0.0 for intercepts
    (standardization=true path)."""

    def __init__(
        self,
        max_iter: int,
        m: int,
        l1reg: np.ndarray,  # per-index L1 weight (>= 0)
        tolerance: float = 1e-6,
    ):
        super().__init__(max_iter, m, tolerance)
        self.l1reg = np.ascontiguousarray(l1reg, np.float64)

    def choose_descent_direction(self, state: State) -> np.ndarray:
        # super's two-loop, run on the ADJUSTED gradient
        pseudo_state = dataclasses.replace(state, grad=state.adjusted_gradient)
        descent_dir = super().choose_descent_direction(pseudo_state)
        # correct the direction into the same orthant as the adjusted grad
        d, g = descent_dir, state.adjusted_gradient
        return np.where(d * g < 0, d, 0.0)

    def determine_step_size(self, state: State, f, dir: np.ndarray) -> float:
        it = state.iter

        def ff(alpha: float) -> tuple[float, float]:
            new_x = self.take_step(state, dir, alpha)
            v, new_g = f(new_x)
            adj_v, adj_g = self.adjust(new_x, new_g, v)
            return adj_v, ddot(adj_g, dir)

        search = BacktrackingLineSearch(
            shrink_step=0.1 if it < 1 else 0.5
        )
        return search.minimize(ff, 0.5 / _norm(state.grad) if it < 1 else 1.0)

    def take_step(self, state: State, dir: np.ndarray, step_size: float) -> np.ndarray:
        stepped = state.x + dir * step_size
        # computeOrthant(x, adjustedGradient)
        x, g = state.x, state.adjusted_gradient
        orthant = np.where(x != 0, np.sign(x), -np.sign(g))
        # v * I(signum(v) == signum(orthant)); ±0.0 compare equal, NaN never
        sv = np.sign(stepped)
        keep = sv == orthant
        nan_mask = np.isnan(sv) | np.isnan(orthant)
        return stepped * np.where(keep & ~nan_mask, 1.0, 0.0)

    def adjust(
        self, new_x: np.ndarray, new_grad: np.ndarray, new_val: float
    ) -> tuple[float, np.ndarray]:
        l1 = self.l1reg
        x, v = new_x, new_grad
        # adjValue += Σ |l1reg(i) * x(i)| over active entries, index order —
        # a strict sequential accumulation (mapActive walks ascending)
        contrib = np.abs(l1 * x)
        mask = l1 != 0.0
        # Breeze folds each |l1*x_i| into an accumulator INITIALIZED at
        # newVal ((newVal+c0)+c1...), not newVal + (0+c0+c1...): start the
        # sequential fold at new_val so the FP association matches exactly.
        # Zero contributions leave the accumulator bit-identical (x+0.0==x
        # for any finite non-negative x; new_val is a loss, never -0.0), so
        # only nonzeros are folded — in index order, like mapActive's walk.
        nz = contrib[mask]
        adj_value = _sequential_sum(nz[nz != 0.0], init=new_val)
        delta_plus = v + l1
        delta_minus = v - l1
        at_zero = np.where(
            delta_minus > 0,
            delta_minus,
            np.where(delta_plus < 0, delta_plus, 0.0),
        )
        sgn = np.sign(x)
        nonzero = v + sgn * l1
        res = np.where(mask, np.where(x == 0.0, at_zero, nonzero), v)
        return adj_value, res


def _sequential_sum(values: np.ndarray, init: float = 0.0) -> float:
    """Strict left-to-right sum starting at init (JVM accumulation order)."""
    acc = float(init)
    for v in values:
        acc += float(v)
    return acc
