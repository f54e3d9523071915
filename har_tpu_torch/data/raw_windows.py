"""Raw tri-axial accelerometer streams → fixed-length windows.

Port of ``har_tpu/data/raw_windows.py`` (numpy, copied): the raw-window
view the transformer trains on.

  - :func:`make_windows` — sliding-window segmentation of an (n, 3)
    stream (the host-side analogue of WISDM's 10-s segmentation).
  - :func:`synthetic_raw_stream` — a class-conditional signal generator
    (distinct gait frequencies/amplitudes/orientations per activity), the
    ``wisdm_raw`` dataset when no raw file is given.  Its windows are
    bit-identical to the JAX package's for the same seed.
  - :func:`calibrated_raw_stream` — windows whose per-class statistics
    replay a WISDM table's summary columns; bit-identical to the JAX
    package's for the same table and seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from har_tpu_torch.data.wisdm import ACTIVITIES

SAMPLE_HZ = 20
WINDOW_STEPS = 200  # 10 s @ 20 Hz, the WISDM window


@dataclasses.dataclass(frozen=True)
class WindowedDataset:
    """(n, T, 3) float32 windows with integer labels.

    ``class_names[i]`` names label id i (None when the source carries no
    names — e.g. hand-built test fixtures)."""

    windows: np.ndarray
    labels: np.ndarray
    class_names: tuple[str, ...] | None = None

    def __len__(self) -> int:
        return len(self.windows)

    def split(self, fractions, seed: int):
        from har_tpu_torch.data.split import split_indices

        return [
            WindowedDataset(
                self.windows[idx], self.labels[idx], self.class_names
            )
            for idx in split_indices(len(self), fractions, seed)
        ]


def make_windows(
    stream: np.ndarray,
    labels: np.ndarray,
    window: int = WINDOW_STEPS,
    step: int | None = None,
) -> WindowedDataset:
    """Segment an (n, 3) stream into (m, window, 3) windows.

    A window is kept only if every sample in it has the same label (the
    WISDM transform likewise segments within one activity bout).
    """
    step = step or window
    n = (len(stream) - window) // step + 1
    if n <= 0:
        raise ValueError("stream shorter than one window")
    idx = np.arange(window)[None, :] + step * np.arange(n)[:, None]
    wins = stream[idx]  # (n, window, 3)
    labs = labels[idx]
    pure = (labs == labs[:, :1]).all(axis=1)
    return WindowedDataset(
        windows=np.ascontiguousarray(wins[pure], np.float32),
        labels=labs[pure, 0].astype(np.int32),
    )


# (freq Hz, amplitude, gravity orientation xyz) per activity — crude but
# distinct dynamics so models have real signal to learn.
_CLASS_DYNAMICS = {
    "Walking": (2.0, 3.0, (0.0, 9.8, 0.0)),
    "Jogging": (2.8, 7.0, (0.0, 9.8, 0.0)),
    "Upstairs": (1.6, 3.5, (1.5, 9.3, 1.0)),
    "Downstairs": (1.8, 4.0, (-1.5, 9.3, -1.0)),
    "Sitting": (0.0, 0.2, (4.9, 4.9, 6.9)),
    "Standing": (0.0, 0.15, (0.0, 9.8, 0.5)),
}


def _class_axis_stats(table) -> dict[str, dict[str, tuple[float, ...]]]:
    """Per-activity (mean, std, peak-interval-ms) per axis from the
    transformed WISDM table.

    Pulls the reference's own summary columns ({X,Y,Z}AVG / {X,Y,Z}STDDEV /
    {X,Y,Z}PEAK, Main/main.py's feature space): medians per class, ignoring
    the '?' sentinels the shipped CSV uses in the PEAK columns (XAVG is
    all-zero there — that IS the statistic, so x oscillates around 0).
    """
    activity = np.asarray(table["ACTIVITY"], object)
    out: dict[str, dict[str, tuple[float, ...]]] = {}

    def med(col: str, mask) -> float | None:
        try:
            raw = np.asarray(table[col], object)[mask]
        except KeyError:
            return None
        vals = []
        for v in raw:
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            if np.isfinite(f):
                vals.append(f)
        return float(np.median(vals)) if vals else None

    for name in np.unique(activity):
        mask = activity == name
        stats = {}
        for key, suffix, default in (
            ("mean", "AVG", 0.0),
            ("std", "STDDEV", 1.0),
            ("peak_ms", "PEAK", 0.0),
        ):
            vals = tuple(
                m if (m := med(f"{axis}{suffix}", mask)) is not None
                else default
                for axis in "XYZ"
            )
            stats[key] = vals
        out[str(name)] = stats
    return out


def calibrated_raw_stream(
    table,
    n_windows: int = 8192,
    seed: int = 0,
    window: int = WINDOW_STEPS,
) -> WindowedDataset:
    """Raw windows whose per-class statistics replay the WISDM table's.

    The reference drops the raw 20 Hz stream (Main/main.py:22-26 keeps
    only the 43 summary features), so the accuracy a raw-window model can
    reach is unobservable on shipped data.  This generator closes the
    loop: each class's windows are synthesized so their per-axis mean,
    standard deviation and dominant peak interval match the medians the
    reference's own transform measured on that class — gravity
    components from {X,Y,Z}AVG, oscillation frequency from {X,Y,Z}PEAK
    (ms between peaks), and amplitude/noise split so the per-axis std
    equals {X,Y,Z}STDDEV (noise takes 35% of the variance).
    Class priors are the table's empirical activity distribution.
    """
    stats = _class_axis_stats(table)
    activity = np.asarray(table["ACTIVITY"], object)
    names, counts = np.unique(activity, return_counts=True)
    names = [str(n) for n in names]
    priors = counts / counts.sum()

    rng = np.random.default_rng((seed, 20824))
    labels = rng.choice(len(names), size=n_windows, p=priors).astype(np.int32)
    t = np.arange(window, dtype=np.float32) / SAMPLE_HZ
    windows = np.empty((n_windows, window, 3), np.float32)
    for i, lab in enumerate(labels):
        s = stats[names[lab]]
        phase = rng.uniform(0, 2 * np.pi, size=3)
        for axis in range(3):
            mean = s["mean"][axis]
            std = max(s["std"][axis], 1e-3) * rng.uniform(0.9, 1.1)
            peak_ms = s["peak_ms"][axis]
            sigma = np.sqrt(0.35) * std
            amp = np.sqrt(2.0 * (std * std - sigma * sigma))
            if peak_ms and peak_ms > 0:
                freq = 1000.0 / peak_ms * rng.uniform(0.95, 1.05)
                osc = amp * np.sin(2 * np.pi * freq * t + phase[axis])
            else:  # static activity: all variance is noise
                sigma, osc = std, 0.0
            windows[i, :, axis] = (
                mean + osc + rng.normal(0, sigma, size=window)
            )
    return WindowedDataset(
        windows=windows, labels=labels, class_names=tuple(names)
    )


def synthetic_raw_stream(
    n_windows: int = 1000,
    seed: int = 0,
    window: int = WINDOW_STEPS,
    class_weights: tuple[float, ...] = (0.38, 0.30, 0.12, 0.10, 0.06, 0.04),
) -> WindowedDataset:
    """Directly generate labeled windows of synthetic accelerometer data."""
    rng = np.random.default_rng((seed, 20823))
    labels = rng.choice(
        len(ACTIVITIES), size=n_windows, p=np.asarray(class_weights)
    ).astype(np.int32)
    t = np.arange(window, dtype=np.float32) / SAMPLE_HZ
    windows = np.empty((n_windows, window, 3), np.float32)
    for i, lab in enumerate(labels):
        freq, amp, gravity = _CLASS_DYNAMICS[ACTIVITIES[lab]]
        phase = rng.uniform(0, 2 * np.pi, size=3)
        f = freq * rng.uniform(0.9, 1.1)
        a = amp * rng.uniform(0.8, 1.2)
        for axis in range(3):
            osc = a * np.sin(2 * np.pi * f * t + phase[axis]) if f > 0 else 0.0
            # axis-dependent harmonic gives stairs asymmetry
            if f > 0 and axis == 2:
                osc = osc + 0.4 * a * np.sin(2 * np.pi * 2 * f * t)
            windows[i, :, axis] = (
                gravity[axis] + osc + rng.normal(0, 0.4, size=window)
            )
    return WindowedDataset(
        windows=windows, labels=labels, class_names=ACTIVITIES
    )
