"""Raw WISDM v1.1 accelerometer stream ingestion (native C++ and Python).

The reference consumes the *transformed* WISDM CSV; the transform's input
is the raw stream ``WISDM_ar_v1.1_raw.txt`` — records of the form
``user,activity,timestamp,x,y,z;`` separated by ';' and/or newlines.  This
module loads that format into columnar arrays:

  - :func:`read_raw_native` — threaded C++ parser (csrc/rawloader.cpp,
    ctypes ABI, built with g++ on first use into
    ``har_tpu_torch/_build/native/libharraw.so``);
  - :func:`read_raw_python` — pure-Python parser with the same tolerant
    semantics (malformed records skipped + counted);
  - :func:`load_raw_stream` — the front door (the native parser; a
    failed build raises);
  - :func:`stream_windows` — group the stream into contiguous
    (user, activity) bouts and segment each into fixed-length windows
    (a :class:`har_tpu_torch.data.raw_windows.WindowedDataset` for the
    neural models).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from har_tpu_torch.data._native_build import NativeLib
from har_tpu_torch.data.raw_windows import WindowedDataset


@dataclasses.dataclass(frozen=True)
class RawStream:
    """Columnar raw accelerometer stream."""

    user: np.ndarray        # (n,) int32
    activity: np.ndarray    # (n,) int32 ids into activity_names
    activity_names: tuple[str, ...]   # first-appearance order
    timestamp: np.ndarray   # (n,) int64 (nanoseconds in the public file)
    xyz: np.ndarray         # (n, 3) float32
    skipped: int = 0        # malformed records dropped during parse

    def __len__(self) -> int:
        return len(self.user)


def _configure(lib: ctypes.CDLL) -> None:
    lib.raw_load.restype = ctypes.c_void_p
    lib.raw_load.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.raw_error.restype = ctypes.c_char_p
    lib.raw_error.argtypes = [ctypes.c_void_p]
    lib.raw_nrows.restype = ctypes.c_int64
    lib.raw_nrows.argtypes = [ctypes.c_void_p]
    lib.raw_skipped.restype = ctypes.c_int64
    lib.raw_skipped.argtypes = [ctypes.c_void_p]
    lib.raw_num_activities.restype = ctypes.c_int
    lib.raw_num_activities.argtypes = [ctypes.c_void_p]
    lib.raw_activity_name.restype = ctypes.c_char_p
    lib.raw_activity_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for fn, ctype in (
        ("raw_users", ctypes.c_int32),
        ("raw_activities", ctypes.c_int32),
        ("raw_timestamps", ctypes.c_int64),
        ("raw_xyz", ctypes.c_float),
    ):
        getattr(lib, fn).restype = None
        getattr(lib, fn).argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctype)
        ]
    lib.raw_free.restype = None
    lib.raw_free.argtypes = [ctypes.c_void_p]


NATIVE = NativeLib("rawloader.cpp", "libharraw.so", _configure)


def read_raw_native(path: str) -> RawStream:
    lib = NATIVE.load()
    handle = lib.raw_load(path.encode(), 0)  # 0: one thread a core
    try:
        err = lib.raw_error(handle)
        if err:
            raise FileNotFoundError(err.decode())
        n = lib.raw_nrows(handle)
        names = tuple(
            lib.raw_activity_name(handle, i).decode()
            for i in range(lib.raw_num_activities(handle))
        )
        user = np.empty(n, np.int32)
        act = np.empty(n, np.int32)
        ts = np.empty(n, np.int64)
        xyz = np.empty((n, 3), np.float32)
        lib.raw_users(handle, user.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        lib.raw_activities(
            handle, act.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        )
        lib.raw_timestamps(
            handle, ts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        lib.raw_xyz(handle, xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return RawStream(
            user=user, activity=act, activity_names=names,
            timestamp=ts, xyz=xyz, skipped=int(lib.raw_skipped(handle)),
        )
    finally:
        lib.raw_free(handle)


def read_raw_python(path: str) -> RawStream:
    """Pure-Python reference parser with identical semantics."""
    with open(path, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")
    users, acts, tss, xs, ys, zs = [], [], [], [], [], []
    names: list[str] = []
    vocab: dict[str, int] = {}
    skipped = 0
    for rec in text.replace("\n", ";").split(";"):
        rec = rec.strip()
        if not rec:
            continue
        parts = rec.split(",")
        if len(parts) != 6:
            skipped += 1
            continue
        try:
            uid = int(parts[0])
            ts = int(parts[2])
            fx, fy, fz = float(parts[3]), float(parts[4]), float(parts[5])
        except ValueError:
            skipped += 1
            continue
        act = parts[1]
        if act not in vocab:
            vocab[act] = len(names)
            names.append(act)
        users.append(uid)
        acts.append(vocab[act])
        tss.append(ts)
        xs.append(fx)
        ys.append(fy)
        zs.append(fz)
    return RawStream(
        user=np.asarray(users, np.int32),
        activity=np.asarray(acts, np.int32),
        activity_names=tuple(names),
        timestamp=np.asarray(tss, np.int64),
        xyz=np.stack(
            [np.asarray(xs, np.float32), np.asarray(ys, np.float32),
             np.asarray(zs, np.float32)],
            axis=1,
        ) if users else np.empty((0, 3), np.float32),
        skipped=skipped,
    )


def load_raw_stream(path: str) -> RawStream:
    return read_raw_native(path)


def stream_windows(
    stream: RawStream, window: int = 200, step: int | None = None
):
    """Segment the stream into per-bout fixed windows.

    A *bout* is a maximal run of consecutive samples sharing (user,
    activity); each bout is windowed independently so no window straddles
    a user or activity change (the WISDM transform's segmentation rule).
    Returns a :class:`har_tpu_torch.data.raw_windows.WindowedDataset`.
    """

    step = step or window
    n = len(stream)
    if n == 0:
        return WindowedDataset(
            windows=np.empty((0, window, 3), np.float32),
            labels=np.empty((0,), np.int32),
            class_names=stream.activity_names,
        )
    key = stream.user.astype(np.int64) << 32 | stream.activity.astype(np.int64)
    boundaries = np.flatnonzero(np.diff(key)) + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [n]])
    wins, labels = [], []
    for s, e in zip(starts, ends):
        m = (e - s - window) // step + 1
        if m <= 0:
            continue
        idx = s + np.arange(m)[:, None] * step + np.arange(window)[None, :]
        wins.append(stream.xyz[idx])
        labels.append(np.full(m, stream.activity[s], np.int32))
    if not wins:
        return WindowedDataset(
            windows=np.empty((0, window, 3), np.float32),
            labels=np.empty((0,), np.int32),
            class_names=stream.activity_names,
        )
    return WindowedDataset(
        windows=np.concatenate(wins, axis=0),
        labels=np.concatenate(labels),
        class_names=stream.activity_names,
    )
