"""ctypes bridge to the JVM-parity math (csrc/mllibmath.cpp), on the host.

Built on first use into ``har_tpu_torch/_build/native/libharjvm.so`` with
``-ffp-contract=off``: the JVM never fuses a*b+c into an FMA, and GCC's
default contraction would silently fork the bit-exact L-BFGS trajectory
the MLlib LogisticRegression replay reproduces.  A failed build raises;
the replays have no other path.
"""

from __future__ import annotations

import ctypes

import numpy as np

from har_tpu_torch.data._native_build import NativeLib

_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _configure(lib: ctypes.CDLL) -> None:
    lib.set_math_backend.restype = None
    lib.set_math_backend.argtypes = [ctypes.c_int]
    lib.dnrm2_f2j.restype = ctypes.c_double
    lib.dnrm2_f2j.argtypes = [_F64P, ctypes.c_int64]
    lib.jvm_exp.restype = ctypes.c_double
    lib.jvm_exp.argtypes = [ctypes.c_double]
    lib.jvm_log.restype = ctypes.c_double
    lib.jvm_log.argtypes = [ctypes.c_double]
    lib.ddot_seq.restype = ctypes.c_double
    lib.ddot_seq.argtypes = [_F64P, _F64P, ctypes.c_int64]
    lib.lr_loss_grad.restype = ctypes.c_double
    lib.lr_loss_grad.argtypes = [
        _F64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, _I32P, _F64P, _I64P, _F64P, _F64P,
        ctypes.c_double, _F64P,
    ]
    lib.lr_predict.restype = None
    lib.lr_predict.argtypes = [
        _F64P, _F64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I32P, _F64P, _I64P, _F64P, _F64P,
    ]
    lib.rf_poisson_weights.restype = None
    lib.rf_poisson_weights.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, _F64P,
    ]
    lib.reservoir_sample_range.restype = None
    lib.reservoir_sample_range.argtypes = [
        ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64, _I32P,
    ]


NATIVE = NativeLib(
    "mllibmath.cpp", "libharjvm.so", _configure,
    extra_flags=("-ffp-contract=off",),
)


def load():
    return NATIVE.load()


def available() -> bool:
    return NATIVE.available()


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def set_math_backend(backend: int) -> None:
    """Transcendental family for the replay kernels; oracle arbiter.

    0 = fdlibm (JDK StrictMath — the production default), 1 = platform
    libm, 2 = long-double round-trip (x87-style double rounding on x86
    only).  Anything else clamps to 0."""
    load().set_math_backend(int(backend))


def dnrm2_f2j(a: np.ndarray) -> float:
    assert a.dtype == np.float64 and a.flags.c_contiguous
    return load().dnrm2_f2j(_ptr(a, _F64P), a.size)


def jvm_exp(x: float) -> float:
    return load().jvm_exp(float(x))


def jvm_log(x: float) -> float:
    return load().jvm_log(float(x))


def ddot(a: np.ndarray, b: np.ndarray) -> float:
    """Strict left-to-right dot (F2J ddot order; Breeze norm = sqrt of it)."""
    assert a.dtype == np.float64 and b.dtype == np.float64
    assert a.flags.c_contiguous and b.flags.c_contiguous
    return load().ddot_seq(_ptr(a, _F64P), _ptr(b, _F64P), a.size)


def rf_poisson_weights(
    seed: int, n_rows: int, num_trees: int, subsample: float = 1.0
) -> np.ndarray:
    """(n_rows, num_trees) BaggedPoint bootstrap counts; pass the already
    partition-adjusted seed (seed + partitionIndex + 1)."""
    out = np.empty((n_rows, num_trees), np.float64)
    load().rf_poisson_weights(
        int(seed), n_rows, num_trees, float(subsample), _ptr(out, _F64P)
    )
    return out


def reservoir_sample_range(
    xorshift_state: int, n_items: int, k: int
) -> np.ndarray:
    """SamplingUtils.reservoirSampleAndCount over range(n_items)."""
    out = np.empty(k, np.int32)
    load().reservoir_sample_range(
        int(xorshift_state) & (2**64 - 1), n_items, k, _ptr(out, _I32P)
    )
    return out


class CsrMatrix:
    """Row-major sparse matrix in MLlib active-iteration order."""

    def __init__(
        self,
        indices: np.ndarray,
        values: np.ndarray,
        indptr: np.ndarray,
        n_cols: int,
    ):
        self.indices = np.ascontiguousarray(indices, np.int32)
        self.values = np.ascontiguousarray(values, np.float64)
        self.indptr = np.ascontiguousarray(indptr, np.int64)
        self.n_cols = int(n_cols)
        self.n_rows = len(self.indptr) - 1

    @classmethod
    def from_rows(cls, rows, n_cols: int) -> "CsrMatrix":
        """rows: iterable of (indices, values) pairs, active order."""
        indptr = [0]
        idx: list[int] = []
        val: list[float] = []
        for ri, rv in rows:
            idx.extend(int(i) for i in ri)
            val.extend(float(v) for v in rv)
            indptr.append(len(idx))
        return cls(
            np.asarray(idx, np.int32),
            np.asarray(val, np.float64),
            np.asarray(indptr, np.int64),
            n_cols,
        )

    def take(self, row_ids) -> "CsrMatrix":
        indptr = [0]
        idx: list[np.ndarray] = []
        val: list[np.ndarray] = []
        total = 0
        for r in row_ids:
            lo, hi = int(self.indptr[r]), int(self.indptr[r + 1])
            idx.append(self.indices[lo:hi])
            val.append(self.values[lo:hi])
            total += hi - lo
            indptr.append(total)
        return CsrMatrix(
            np.concatenate(idx) if idx else np.empty(0, np.int32),
            np.concatenate(val) if val else np.empty(0, np.float64),
            np.asarray(indptr, np.int64),
            self.n_cols,
        )


def lr_loss_grad(
    coef: np.ndarray,
    x: CsrMatrix,
    labels: np.ndarray,
    feat_std: np.ndarray,
    num_classes: int,
    fit_intercept: bool,
    reg_l2: float,
    grad_out: np.ndarray,
) -> float:
    lib = load()
    return lib.lr_loss_grad(
        _ptr(coef, _F64P),
        x.n_rows,
        x.n_cols,
        num_classes,
        1 if fit_intercept else 0,
        _ptr(x.indices, _I32P),
        _ptr(x.values, _F64P),
        _ptr(x.indptr, _I64P),
        _ptr(labels, _F64P),
        _ptr(feat_std, _F64P),
        float(reg_l2),
        _ptr(grad_out, _F64P),
    )


def lr_predict(
    coef_matrix: np.ndarray,  # (k, d) row-major, original feature space
    intercepts: np.ndarray,  # (k,)
    x: CsrMatrix,
) -> tuple[np.ndarray, np.ndarray]:
    lib = load()
    k, d = coef_matrix.shape
    raw = np.empty((x.n_rows, k), np.float64)
    prob = np.empty((x.n_rows, k), np.float64)
    lib.lr_predict(
        _ptr(np.ascontiguousarray(coef_matrix, np.float64), _F64P),
        _ptr(np.ascontiguousarray(intercepts, np.float64), _F64P),
        x.n_rows,
        d,
        k,
        _ptr(x.indices, _I32P),
        _ptr(x.values, _F64P),
        _ptr(x.indptr, _I64P),
        _ptr(raw, _F64P),
        _ptr(prob, _F64P),
    )
    return raw, prob
