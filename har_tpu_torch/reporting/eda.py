"""EDA plots: hexbin feature-pair grid + scatter matrix.

Port of ``har_tpu/reporting/eda.py`` (matplotlib on the host, copied): the
same sample, the same files in the same order.

Reproduces the reference's plot tail (Main/main.py:686-710, standalone in
matplot.py): a 10% sample of the numeric features, hexbin plots for every
ordered feature pair saved as ``Fig <X>_<Y>.png``, plus a scatter matrix
(the reference's `Scatter_Matrix.png` step never completed in the shipped
artifacts — SURVEY §2 Q — but the code path exists, so ours does too).
"""

from __future__ import annotations

import os

import numpy as np


def save_eda_plots(
    table,
    numeric_columns,
    output_dir: str,
    sample_fraction: float = 0.1,
    seed: int = 2018,
    pairs: str = "distinct",
) -> list[str]:
    """Write hexbin pair plots + scatter matrix; returns saved paths.

    ``pairs='distinct'`` writes only X≠Y pairs like the reference's loop
    effectively does (identical-pair hexbins are degenerate diagonals).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = len(table)
    take = rng.random(n) <= sample_fraction
    data = {c: np.asarray(table[c], np.float64)[take] for c in numeric_columns}

    paths = []
    for xcol in numeric_columns:
        for ycol in numeric_columns:
            if pairs == "distinct" and xcol == ycol:
                continue
            fig, ax = plt.subplots(figsize=(4, 3))
            ax.hexbin(data[xcol], data[ycol], gridsize=25, cmap="viridis")
            ax.set_xlabel(xcol)
            ax.set_ylabel(ycol)
            path = os.path.join(output_dir, f"Fig {xcol}_{ycol}.png")
            fig.savefig(path, dpi=72)
            plt.close(fig)
            paths.append(path)

    # scatter matrix over the sampled numeric features
    k = len(numeric_columns)
    fig, axes = plt.subplots(k, k, figsize=(2 * k, 2 * k))
    for i, ycol in enumerate(numeric_columns):
        for j, xcol in enumerate(numeric_columns):
            ax = axes[i, j] if k > 1 else axes
            if i == j:
                ax.hist(data[xcol], bins=20)
            else:
                ax.plot(data[xcol], data[ycol], ".", markersize=1)
            ax.set_xticks([])
            ax.set_yticks([])
            if j == 0:
                ax.set_ylabel(ycol, fontsize=6)
            if i == k - 1:
                ax.set_xlabel(xcol, fontsize=6)
    path = os.path.join(output_dir, "Scatter_Matrix.png")
    fig.savefig(path, dpi=72)
    plt.close(fig)
    paths.append(path)
    return paths
