#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero without the final ``ok`` line:

1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: every kernel of har_tpu_torch/csrc compiled with nvcc (one
   process per source, started together), timed, with ptxas's report;
3. hist: kernel K1's two entries against their plain PyTorch versions on
   the card: the dense kernel at the test shapes and the static-width
   shapes it served before the tree path moved to the row-sparse kernel,
   and the row-sparse kernel at the test shapes and every level shape of
   the main path (each level at its live width; at the full training
   split and at a CV fold's 3,034 rows) and of the UCI-HAR paths (7,209
   rows, d = 561); exact for integer
   weights, rtol 1e-5 for random float32 weights; kernel, plain and
   one-hot-matmul times from CUDA events and the least time the card
   could take (and apart from it, the time of the output's zeroing where
   a launch merges row chunks);
4. flash: kernel K2 (launched through its registered op
   ``har_tpu_torch::flash_attention_fwd``) against its plain PyTorch
   version on the card, at the CPU tests' shapes (a ragged T, D = 16), the
   raw path's training, prediction and packed shapes, ``stream``'s hop
   (batch 1) and largest burst (256) (the resident route) and one long T
   (the streamed route), with and without lse, read through the fused-qkv
   strides: float32 out and lse within rtol 1e-5 (atol 1e-6), bfloat16 out
   within 1e-2 (it is rounded to bf16; both sides accumulate in f32) and
   lse within rtol 1e-5; then, at the six main-path shapes, each launch's
   plan, kernel times from CUDA events and from a CUDA graph's replay,
   plain and scaled_dot_product_attention times and the card's bound;
5. agree: the port's DT and RF grown on the card equal the same trees grown
   on the CPU with the plain histogram (600 rows, 8 trees);
6. transformer_agree: three float32 training steps of the CLI-width
   transformer (dropout 0) on the card and on the CPU, from the same
   initial values and batches: losses, parameters and logits within 1e-4;
7. main: ``har_tpu_torch.cli train --models dt rf --no-cv --device cuda`` on
   the 5,418-row synthetic WISDM table at the reference's widths (DT depth
   3; RF 100 trees, depth 4, seed 3), with the row-sparse kernel's launch
   count (one per tree level, 55) and none of the dense kernel's;
8. raw_main: ``cli train --dataset wisdm_raw --models transformer --no-cv
   --device cuda`` at the CLI defaults, with K2's launch count
   (num_layers x (training steps + prediction chunks)) and an accuracy
   floor below har_tpu's own band;
9. raw_packed: ``runner.run`` at the raw bench lane's widths (embed 256, 8
   heads, patch 8, window_pack 8, scanned layers, batch 4096, 25 epochs),
   with K2's launch count and its accuracy floor;
10. lr_agree: logistic regression's fit and its 9-point 5-fold sweep on a
    noisy seeded table at the main path's width (3,793 x 730, 6 classes),
    on the card and on the CPU: losses and objective within rtol 1e-5,
    labels equal but for at most 0.1% of rows (the count printed),
    avg_metrics within one validation row per fold, best_params equal;
    the sweep's time from CUDA events and the line search's host reads;
11. cv_agree: DT and RF (12 trees: one chunk of 8 and one of 4, the main
    forest's launch shapes) CrossValidators over the default table's
    training split, on the card and on the CPU: avg_metrics equal exactly
    (K1 at the fold shapes);
12. default_main: ``cli train --device cuda`` with no model flags (LR, DT
    and RF, each with its 5-fold CrossValidator), with K1's launch count (7
    fits a family: 385), its four artifacts, DT and DT-CV exactly
    1494/1625, RF and RF-CV equal to main's RF, LR and LR-CV at or above
    har_tpu's accuracy on the CPU for the same table;
13. parity_main: ``cli parity --device cuda`` (the bit-exact LR, LR-CV and
    RF replays on the host, DT grown on the card), after building the
    three host C++ libraries with g++ (its version and each build's time
    printed): K1's launch count (DT's 3 levels), its three artifacts, the
    accuracies har_tpu's parity run reaches on the CPU for the same table,
    result.txt equal to a ``--device cpu`` run's outside the uid and timing
    lines, and native/*.so byte-identical before and after the run;
14. gbdt_hist: K1's row-sparse kernel at every boosted-tree level shape
    (2K = 12 channels: g and h of 6 class trees; live width 1-16; d 13,
    43 and UCI-HAR's 561; B 32) against its plain version: small integer weights bit
    for bit (the int32 path), signed float gradients and hessians within
    rtol 1e-5 plus 1e-5 times each element's sum of |w| (the float path);
    kernel times (CUDA events and graph), plain and one-call index_add_
    times, the byte bound and the zeroing;
15. gbdt_main: ``cli train --models gbt --no-cv --device cuda`` (K1
    launches: rounds x depth = 500, none of the dense kernel or K2, an
    accuracy floor below har_tpu's), the same with ``--device cpu`` (card
    labels against CPU labels, an agreement floor), then ``--models gbt``
    with its CV (7 fits, 3,500 launches);
16. raw_features_main: the 43 features of the raw path's 4,000 windows on
    the card against the CPU (histogram columns exact), then ``cli train
    --dataset wisdm_raw --models dt gbt --no-cv`` (503 launches, floors);
17. neural_agree: three float32 steps (dropout 0) of the MLP, the CNN1D
    (max/layer and stride/rms) and the BiLSTM (bf16_stream) at the CLI's
    widths on the card and on the CPU: losses within rtol 1e-5, logits
    within 1e-4;
18. neural_main: ``cli train --models mlp --no-cv`` (the numeric view),
    and on ``--dataset wisdm_raw`` the CNN1D (with and without ``--augment
    raw_windows``) and the BiLSTM, at the CLI's widths and 60 epochs: no
    K1 or K2 launch, accuracy floors below har_tpu's, train time and peak
    memory;
19. lifecycle_main: the saved models' life on the card.  Phases 8, 12,
    15 (its ``--no-cv`` run) and 18 (its plain CNN1D run) pass
    ``--save-models-dir``, which launches nothing: LR, DT, RF and their
    CVs, GBDT, the transformer and the CNN1D.  ``cli evaluate`` of each
    on the card scores exactly its train run's accuracy; ``cli predict``
    of each on the card and with ``--device cpu`` gives equal prediction
    columns, and its probabilities on the two devices agree within 1e-6
    (float32 models) or 1e-2 (the bfloat16 neural defaults); K1 launches 0 times and K2 layers x
    prediction chunks a transformer scoring.  Then an MLP at the CLI's
    widths (dropout 0.2), 6 epochs with a snapshot every 2, crashed after
    its first snapshot and resumed, against the unbroken run (losses
    within rtol 1e-4, parameters within rtol 1e-3 / atol 1e-6, exactness
    printed); ``train --models mlp --no-cv --early-stop-patience 3
    --checkpoint-dir`` twice (best and stopped epochs; the second run
    trains nothing and scores the same); and ``finetune`` of the CNN1D
    with ``--freeze ConvBlock_0 ConvBlock_1 --output`` (frozen tensors
    bit-identical to the checkpoint's, accuracy after at the CNN1D floor);
20. serving_main: single-stream serving from phase 19's saved transformer
    (bf16, 2 layers) and CNN1D.  ``cli stream --device cuda`` on the demo
    recording (111 hops of 20 samples), plain and with ``--monitor``: K2
    exactly (111 hops + 17 calibration calls) x 2 layers a run; against
    ``--device cpu``: events, raw and smoothed labels equal, probabilities
    within 1e-2, drift blocks equal; per-hop steady, device and host
    milliseconds printed.  The stream with smoothing ``none`` against
    ``classify_session`` of the recording in one batch: raw labels equal,
    the largest probability difference printed.  ``cli export`` of the
    transformer and of the CNN1D, float and ``--quantize int8`` (traced on
    the CPU, no launch), then ``evaluate`` and ``predict --artifact`` on
    the card: the float artifacts score their checkpoints' accuracies, the
    int8 one within 0.01; predictions equal a ``--device cpu`` run's; K2
    2 x layers x prediction chunks for the loaded transformer program (0
    would mean the export left the kernel out); artifact bytes and the
    int8 ratio;
21. ucihar_main: a UCI-HAR fixture tree at the published size (7,352 +
    2,947 rows, 561 features; written once), then ``cli train --dataset
    ucihar --data-path <tree> --device cuda`` with no model flags (K1 as
    on the default run, 385; DT and DT-CV exactly har_tpu's accuracy on
    the same tree, LR and RF floors; its models saved), the host's split
    candidates over the 561 features timed once, and ``cli evaluate`` of
    the saved DT (the train run's accuracy exactly, no launch); K1 is
    held against its plain version and timed at every UCI-HAR level
    shape in phases 3 and 14;
22. ucihar_gbt_main: ``--models gbt mlp --no-cv`` on the tree (K1 500,
    floors below har_tpu's);
23. ucihar_parity_lane: ``parity.ucihar_parity_lane`` on the tree (LR's
    9-point 5-fold CV on the card): har_tpu's split, best grid point and
    accuracy within one test row, no launch;
24. sweep_main: ``cli sweep --device cuda`` at its defaults (LR, DT, RF at
    70/80/90 % train, LR's CV): K1 three tree paths (165), 12 rows in
    sweep.csv and sweep.txt, DT equal to har_tpu's at each split;
25. raw_lane_main: ``cli parity --raw`` on a raw-format file of
    ``synthetic_raw_stream(5418)`` (1,083,600 lines, written once): all
    5,418 windows, the lane's CNN1D at or above a floor below har_tpu's,
    no launch;
26. with ``--profile`` only: one DT, one RF and one transformer fit, one
    default run, one parity run, one GBDT fit and a 2-epoch BiLSTM fit
    under torch.profiler, with K1's and K2's shares of the device time;
27. the kernels line (K1's launches over every path that grows trees),
    a short ``summary`` line, then ``{"ok": true, "device": {...}}``.

``train --eda`` (host matplotlib, no kernel) is not driven here: the card's
machine has no matplotlib; the CPU tests hold it to har_tpu's files.

``--flash-only`` runs phases 1, 2 and 4 and stops there, without the last
two lines: the quick way to time K2, or to time another checkout's K2 by
running a copy of this script from that checkout's root (a package that
predates ``flash_plan`` reports no plan).

It needs one CUDA card and the repository beside it; it writes the main
paths' artifacts and saved models under har_tpu_torch/_build/chip_smoke/
(git-ignored).
"""

from __future__ import annotations

import contextlib
import csv
import hashlib
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from har_tpu_torch import checkpoint, cli, parity, runner, serving  # noqa: E402
from har_tpu_torch.config import DataConfig, ModelConfig, RunConfig  # noqa: E402
from har_tpu_torch.data import raw_loader  # noqa: E402
from har_tpu_torch.data.split import split_indices  # noqa: E402
from har_tpu_torch.data.ucihar import write_ucihar_fixture  # noqa: E402
from har_tpu_torch.features.scaler import StandardScaler  # noqa: E402
from har_tpu_torch.features.wisdm_pipeline import FeatureSet  # noqa: E402
from har_tpu_torch.models import lbfgs  # noqa: E402
from har_tpu_torch.models import _jvm_native  # noqa: E402
from har_tpu_torch.models import logistic_regression as lr_ops  # noqa: E402
from har_tpu_torch.features.raw_features import extract_features  # noqa: E402
from har_tpu_torch.models.forest import TREE_BATCH, RandomForestClassifier  # noqa: E402
from har_tpu_torch.models.gbdt import GradientBoostedTreesClassifier  # noqa: E402
from har_tpu_torch.models.neural import build_model  # noqa: E402
from har_tpu_torch.models.transformer import Transformer1D  # noqa: E402
from har_tpu_torch.models.tree import DecisionTreeClassifier  # noqa: E402
from har_tpu_torch.models.tree import mllib_split_candidates  # noqa: E402
from har_tpu_torch.ops import _build  # noqa: E402
from har_tpu_torch.ops import flash_attention as flash_ops  # noqa: E402
from har_tpu_torch.ops import hist as hist_ops  # noqa: E402
from har_tpu_torch.runner import featurize, load_dataset  # noqa: E402
from har_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from har_tpu_torch.tuning import CrossValidator, kfold_indices, param_grid  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s,
# and float32 adds/s outside the tensor cores (67 TFLOP/s counts an FMA
# as two operations; an add takes the same issue slot as an FMA)
HBM_BYTES_PER_S = 3.35e12
F32_ADDS_PER_S = 67e12 / 2

# the main path's histogram shapes (n train rows, d one-hot features, B
# bins, WC = 2**depth nodes * 6 classes, T trees per launch); DT_SHAPE and
# RF_SHAPE are the static widths the dense kernel served at every level
N, D, B, C = 3793, 730, 32, 6
DT_DEPTH = DecisionTreeClassifier().max_depth
RF_DEPTH, RF_TREES = RandomForestClassifier().max_depth, RandomForestClassifier().num_trees
DT_SHAPE = dict(n=N, d=D, bins=B, wc=2**DT_DEPTH * C, trees=1)
RF_SHAPE = dict(n=N, d=D, bins=B, wc=2**RF_DEPTH * C, trees=TREE_BATCH)
CHECK_SHAPES = {
    "test_300x7_b8_wc12": dict(n=300, d=7, bins=8, wc=12, trees=1),
    "test_513x130_b4_wc6": dict(n=513, d=130, bins=4, wc=6, trees=1),
    "tree_axis_300x7_b8_wc12_t3": dict(n=300, d=7, bins=8, wc=12, trees=3),
    "dt": DT_SHAPE,
    "rf_chunk": RF_SHAPE,
    "rf_last_chunk": dict(RF_SHAPE, trees=100 % TREE_BATCH),
}
# the row-sparse kernel's launches on the main path: level L of a tree
# (or of an RF chunk) at its live width 2**L nodes * C classes
ROW_LEVEL_SHAPES = {
    **{f"dt_L{level}": dict(n=N, d=D, bins=B, wc=2**level * C, trees=1)
       for level in range(DT_DEPTH)},
    **{f"rf_chunk_L{level}": dict(n=N, d=D, bins=B, wc=2**level * C, trees=TREE_BATCH)
       for level in range(RF_DEPTH)},
    f"rf_last_chunk_L{RF_DEPTH - 1}": dict(
        n=N, d=D, bins=B, wc=2 ** (RF_DEPTH - 1) * C, trees=RF_TREES % TREE_BATCH
    ),
}
# the kernels line's headline shape: an RF chunk's deepest level
RF_HEADLINE = f"rf_chunk_L{RF_DEPTH - 1}"
# UCI-HAR (the ucihar_* phases): a fixture tree of the published
# archive's 7,352 + 2,947 rows and 561 features; the seed-2018 Bernoulli
# 70/30 split trains on UCIHAR_N of them, each tree level at d = 561
UCIHAR_TRAIN, UCIHAR_TEST, UCIHAR_D = 7352, 2947, 561
UCIHAR_N = len(split_indices(UCIHAR_TRAIN + UCIHAR_TEST, [0.7, 0.3], 2018)[0])
UCIHAR_ROW_LEVEL_SHAPES = {
    f"ucihar_{name}": dict(s, n=UCIHAR_N, d=UCIHAR_D) for name, s in ROW_LEVEL_SHAPES.items()
}
# the default run's CV fold fits: a 5-fold split of the training rows
# leaves 3,034 or 3,035 rows a fold fit
CV_FOLDS = 5
FOLD_N = N - math.ceil(N / CV_FOLDS)
ROW_CHECK_SHAPES = {
    "test_300x7_b8_wc12_t3": dict(n=300, d=7, bins=8, wc=12, trees=3),
    "test_513x130_b4_wc6_t3": dict(n=513, d=130, bins=4, wc=6, trees=3),
    "test_257x9_b32_wc12_t3": dict(n=257, d=9, bins=32, wc=12, trees=3),
    **ROW_LEVEL_SHAPES,
    **{f"fold_{name}": dict(s, n=FOLD_N) for name, s in ROW_LEVEL_SHAPES.items()},
    **UCIHAR_ROW_LEVEL_SHAPES,
}
# har_tpu on the CPU, same synthetic table and split: 1494 of 1625 right
DT_EXPECTED_CORRECT, TEST_ROWS = 1494, 1625
RF_MIN_ACCURACY = 0.75

# H100 SXM at 700 W: dense bf16 tensor-core rate, and the special-function
# units' exponentials (16 per SM per clock x 132 SMs x 1.98 GHz)
BF16_FLOPS_PER_S = 989e12
SFU_EXP_PER_S = 16 * 132 * 1.98e9

# the raw path (`train --dataset wisdm_raw`): 4,000 synthetic windows split
# 2,818 / 1,182 by the seed-2018 Bernoulli draw; the CLI transformer is
# embed 64, 4 heads (D = 16), T = 200, batch 512; the bench lane's packed
# transformer folds each 25-token window of 8 heads (D = 32) into the batch
RAW_PACKED_PARAMS = dict(
    embed_dim=256, num_heads=8, patch_size=8, window_pack=8, scan_layers=True,
    batch_size=4096, learning_rate=1e-3, epochs=25,
)
FLASH_TRAIN = dict(b=512, t=200, h=4, d=16)
FLASH_PREDICT = dict(b=1182, t=200, h=4, d=16)
FLASH_PACKED = dict(b=4096, t=25, h=8, d=32)
FLASH_PACKED_PREDICT = dict(b=1184, t=25, h=8, d=32)
# a T whose K and V pass the kernel's shared-memory budget: flash_plan
# takes the streamed route
FLASH_STREAMED = dict(b=2, t=4096, h=2, d=64)
# `stream`: one window a hop, and a catch-up burst at the serving path's
# largest padded batch (StreamingClassifier._MAX_BATCH)
FLASH_STREAM_HOP = dict(b=1, t=200, h=4, d=16)
FLASH_STREAM_BURST = dict(b=serving.StreamingClassifier._MAX_BATCH, t=200, h=4, d=16)
FLASH_CHECK_SHAPES = {
    "test_2x64x2x32": dict(b=2, t=64, h=2, d=32),
    "test_2x96x2x32": dict(b=2, t=96, h=2, d=32),
    "test_ragged_3x25x2x16": dict(b=3, t=25, h=2, d=16),
    "test_3x7x2x8": dict(b=3, t=7, h=2, d=8),
    # a time stride off 8 elements: the wrapper hands the kernel a copy
    "misaligned_2x25x2x16": dict(b=2, t=25, h=2, d=16, pad=4),
    "cli_train": FLASH_TRAIN,
    "cli_predict": FLASH_PREDICT,
    "packed_train": FLASH_PACKED,
    "packed_predict": FLASH_PACKED_PREDICT,
    "streamed_2x4096x2x64": FLASH_STREAMED,
    "stream_hop": FLASH_STREAM_HOP,
    "stream_burst": FLASH_STREAM_BURST,
}
FLASH_TIME_SHAPES = {
    "cli_train": FLASH_TRAIN,
    "cli_predict": FLASH_PREDICT,
    "packed_train": FLASH_PACKED,
    "packed_predict": FLASH_PACKED_PREDICT,
    "stream_hop": FLASH_STREAM_HOP,
    "stream_burst": FLASH_STREAM_BURST,
}
# accuracy floors 0.05 below har_tpu's own band on the CPU for the same
# command over trainer seeds 0-2 (1.0 at both widths, PERF.md §2): the
# port's initial values and dropout come from other draws
RAW_MAIN_MIN_ACCURACY = 0.95
RAW_PACKED_MIN_ACCURACY = 0.95

# har_tpu on the CPU, same table and split, `run(models=["lr"],
# with_cv=True)`: LR and LR-CV both 1625/1625
LR_MIN_ACCURACY = 1.0
# lr_agree: card against CPU on the noisy table
LR_LOSS_RTOL = 1e-5
LR_MAX_LABEL_FLIPS = 0.001  # share of rows
# cv_agree's forest: one chunk of TREE_BATCH trees and one of 4
CV_AGREE_TREES = TREE_BATCH + 4

# boosted trees: each level of a round is one hist_rows launch with 2K
# channels (g and h of each class tree) at the level's live width; d is 13
# on the synthetic table's numeric view, 43 on the raw windows' features
# (and on the real CSV's view with its binned columns)
GBDT = GradientBoostedTreesClassifier()
GBDT_CHANNELS = 2 * C
GBDT_LAUNCHES = GBDT.num_rounds * GBDT.max_depth
GBDT_LEVEL_SHAPES = {
    **{f"gbdt_d{d}_L{level}": dict(n=N, d=d, bins=GBDT.max_bins, wc=2**level,
                                  trees=GBDT_CHANNELS)
       for d in (13, 43) for level in range(GBDT.max_depth)},
    **{f"ucihar_gbdt_L{level}": dict(n=UCIHAR_N, d=UCIHAR_D, bins=GBDT.max_bins,
                                    wc=2**level, trees=GBDT_CHANNELS)
       for level in range(GBDT.max_depth)},
}
# the kernel against its plain version at float weights: each element
# within rtol 1e-5 plus 1e-5 times its own sum of |w| (the float atomics
# add in any order; an element of k rows rounds by about sqrt(k) ulps of
# that sum)
GBDT_HIST_RTOL, GBDT_HIST_ATOL_PER_ABS_SUM = 1e-5, 1e-5
# har_tpu on the CPU (raw_accuracy_band.py, PERF.md §2): gbt 1.0 on the
# synthetic table; on the raw windows' features dt 0.92978 (1,099/1,182)
# and gbt 1.0; the floors sit below
GBT_MIN_ACCURACY = 0.995
RAW_DT_MIN_ACCURACY = 0.9
# card against CPU: the card's float atomics sum the level histograms in
# another order, so an exact tie between two splits may break the other way
GBT_MIN_LABEL_AGREEMENT = 0.99
# the neural paths' floors, below har_tpu's own accuracy for the same
# command on the CPU (raw_accuracy_band.py, PERF.md §2)
MLP_MIN_ACCURACY = 0.95
CNN1D_MIN_ACCURACY = 0.95
BILSTM_MIN_ACCURACY = 0.95

# where the main paths save their models, and the lifecycle's tolerances:
# card against CPU probabilities of a saved float32 model, and of the
# neural defaults, whose bfloat16 matmuls round on the two devices apart
OUT = ROOT / "har_tpu_torch" / "_build" / "chip_smoke"
MODELS_DIR = OUT / "models"
PREDICT_PROB_ATOL = 1e-6
PREDICT_PROB_ATOL_BF16 = 1e-2
SAVE = ["--save-models-dir", str(MODELS_DIR)]

# the UCI-HAR phases: the fixture tree and the default run's saved models;
# har_tpu on the CPU, the same tree (raw_accuracy_band.py ucihar, ucihar_rf
# and ucihar_gbt_mlp, PERF.md §2): DT and DT-CV 0.9799352750809062, LR,
# LR-CV, GBDT and MLP 1.0, RF 1.0 over RF seeds 0-2 (the port's CPU runs:
# 1.0 over seeds 0-3); the floors sit below
UCIHAR_DIR = OUT / "ucihar"
UCIHAR_MODELS_DIR = OUT / "ucihar_models"
UCIHAR_DT_ACCURACY = 0.9799352750809062
UCIHAR_LR_MIN_ACCURACY = 1.0
UCIHAR_RF_MIN_ACCURACY = 0.99
UCIHAR_GBT_MIN_ACCURACY = 0.99
UCIHAR_MLP_MIN_ACCURACY = 0.99
# har_tpu's ucihar_parity_lane on the tree (raw_accuracy_band.py
# ucihar_parity): the split, the CV's best grid point and the accuracy
UCIHAR_LANE = dict(n_train=7209, n_test=3090,
                   best_params={"elastic_net_param": 0.0, "reg_param": 0.1}, accuracy=1.0)
# sweep at its defaults on the default table (raw_accuracy_band.py sweep):
# har_tpu's DT accuracy per split, and its LR and LR-CV ones
SWEEP_SPLITS = ("70-30", "80-20", "90-10")
SWEEP_DT_ACCURACY = {"70-30": 0.919385, "80-20": 0.929368, "90-10": 0.918216}
SWEEP_LR_MIN_ACCURACY = 1.0
# parity --raw on a raw-format file of synthetic_raw_stream(5418, seed 0);
# its floor is the CNN1D paths' 0.95: har_tpu's lane at its defaults
# (raw_accuracy_band.py raw_lane) has not finished on a CPU, so the floor
# is not yet checked against har_tpu's result (PERF.md §2)
RAW_LANE_WINDOWS = 5418
RAW_LANE_FILE = OUT / "WISDM_ar_v1.1_raw.txt"
RAW_LANE_MIN_ACCURACY = 0.95


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int = 25, rounds: int = 5, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn``: ``reps`` calls back to back
    between two CUDA events, the median over ``rounds`` such runs (so the
    host's launch overhead hides behind the device's work, as it does on
    the path)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def tree_level_inputs(n, d, bins, wc, trees, integer=True, seed=0):
    """bins and m as a tree level builds them: each row's weight (1, or a
    Poisson count for a forest) in one (node, class) column per tree; or,
    with integer=False, dense uniform float32 weights."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = torch.randint(0, bins, (n, d), generator=g, device="cuda", dtype=torch.int32)
    if not integer:
        return b, torch.rand((trees, n, wc), generator=g, device="cuda")
    slot = torch.randint(0, wc, (trees, n, 1), generator=g, device="cuda")
    w = torch.ones((trees, n, 1), device="cuda")
    if trees > 1:
        w = torch.poisson(w, generator=g)
    m = torch.zeros((trees, n, wc), device="cuda").scatter_(2, slot, w)
    return b, m


def graph_ms(fn, reps: int = 25, rounds: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, whose replay is timed between two CUDA events (median
    of ``rounds``).  Unlike :func:`cuda_ms` it leaves out the host's time
    between launches, which decides back-to-back calls of a kernel whose
    device time is shorter than its wrapper's Python."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=1, rounds=rounds) / reps


def tree_row_inputs(n, d, bins, wc, trees, integer=True, seed=0):
    """bins, slot and weight as a tree level hands them to the row-sparse
    kernel: each row in one (node, class) slot per tree with weight 1 (a
    tree) or a Poisson count (a forest, zeros included), every 13th row's
    slot past the level; or, with integer=False, uniform float32 weights
    with every 5th row 0."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = torch.randint(0, bins, (n, d), generator=g, device="cuda", dtype=torch.int32)
    slot = torch.randint(0, wc, (trees, n), generator=g, device="cuda", dtype=torch.int32)
    slot[:, ::13] = wc
    if not integer:
        w = torch.rand((trees, n), generator=g, device="cuda")
        w[:, ::5] = 0.0
    elif trees > 1:
        w = torch.poisson(torch.ones((trees, n), device="cuda"), generator=g)
    else:
        w = torch.ones((trees, n), device="cuda")
    return b, slot, w


def dense_m(slot, w, wc):
    """The row one-hot ``m`` of (slot, weight), for the dense yardstick."""
    keep = (slot >= 0) & (slot < wc)
    m = torch.zeros(slot.shape + (wc,), device=slot.device)
    return m.scatter_(2, torch.where(keep, slot, 0).long()[..., None],
                      torch.where(keep, w, 0.0)[..., None])


def library_hist(b, m, bins):
    """One PyTorch call chain computing the same function, as a yardstick:
    the materialized one-hot and a batched matmul."""
    n, d = b.shape
    onehot = torch.nn.functional.one_hot(b.long(), bins).to(torch.float32)
    return torch.matmul(m.transpose(1, 2), onehot.reshape(n, d * bins))


def bound(b, m, out) -> tuple[float, str]:
    """Least milliseconds for the card: each input read once, the output
    written once, and one add per nonzero weight and feature."""
    nbytes = sum(t.numel() * t.element_size() for t in (b, m, out))
    adds = int(torch.count_nonzero(m)) * b.shape[1]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = adds / F32_ADDS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def rows_bound(b, slot, w, out) -> tuple[float, str]:
    """Least milliseconds for the card, for the row-sparse function: the
    bins of every row some tree keeps, slot and weight read once, the
    output written once, and one add per kept row and feature.  The
    zeroing a launch of several row chunks needs is its design's cost,
    not the function's: :func:`rows_memset` reports it apart."""
    n, d = b.shape
    wc = out.shape[1]
    kept = (w != 0) & (slot >= 0) & (slot < wc)
    rows_read = int(kept.any(dim=0).sum())
    nbytes = (
        rows_read * d * b.element_size()
        + sum(t.numel() * t.element_size() for t in (slot, w, out))
    )
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = int(kept.sum()) * d / F32_ADDS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def rows_memset(out, chunks: int) -> dict:
    """The zeroing of the output that a launch of several row chunks
    makes before its blocks merge into it: its CUDA-event time and its
    byte bound (the output written once), or None for both where the
    launch has one chunk and writes its output without it."""
    if chunks == 1:
        return dict(memset_ms=None, memset_bound_ms=None)
    nbytes = out.numel() * out.element_size()
    return dict(memset_ms=cuda_ms(out.zero_),
                memset_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = nvidia_smi()
    print(smi, flush=True)
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    emit(
        "device", nvidia_smi=smi, capability=list(torch.cuda.get_device_capability(0)),
        torch=torch.__version__, cuda=torch.version.cuda, **device,
    )
    return device


# the kernels of har_tpu_torch/csrc, in a mangled name: base name and
# template argument
KERNEL_NAME = re.compile(
    r"(flash_fwd_bf16_streamed|flash_fwd_bf16|flash_fwd_f32|hist_rows_kernel|hist_kernel)"
    r"(?:ILi(\d+)E)?"
)


def ptxas_report(log: str) -> dict:
    """ptxas's ``-v`` report per kernel instance: registers, spill stores
    and loads (bytes) and static shared memory, keyed by the kernel's name
    and template argument (``flash_fwd_bf16<16>``)."""
    report, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = KERNEL_NAME.search(entry.group(1))
            name = entry.group(1) if kernel is None else (
                kernel.group(1) + (f"<{kernel.group(2)}>" if kernel.group(2) else "")
            )
            report[name] = {}
        elif name and "spill stores" in line:
            stores, loads = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line).groups()
            report[name].update(spill_stores=int(stores), spill_loads=int(loads))
        elif name and "Used" in line and "registers" in line:
            report[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            report[name]["static_smem"] = int(smem.group(1)) if smem else 0
    return report


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {name: ptxas_report(_build.PTXAS_LOG.get(name, "")) for name in libs}
    emit("build", seconds=seconds, libraries=[p.name for p in libs.values()],
         ptxas=ptxas)


def phase_hist() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err = 0.0
    for name, s in CHECK_SHAPES.items():
        shape = (s["n"], s["d"], s["bins"], s["wc"], s["trees"])
        b, m = tree_level_inputs(*shape, integer=True, seed=1)
        got, want = hist_ops.hist(b, m, s["bins"]), hist_ops.hist_plain(b, m, s["bins"])
        torch.cuda.synchronize()
        int_diff = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"hist {name}: integer weights differ by {int_diff}")
        b, m = tree_level_inputs(*shape, integer=False, seed=2)
        got, want = hist_ops.hist(b, m, s["bins"]), hist_ops.hist_plain(b, m, s["bins"])
        f32_diff = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
        max_err = max(max_err, int_diff, f32_diff)
        emit("hist_check", shape=name, **s, max_abs_diff_int=int_diff,
             max_abs_diff_f32=f32_diff, max_rel_diff_f32=rel)

    timings = {}
    for name, s in (("dt", DT_SHAPE), ("rf_chunk", RF_SHAPE)):
        b, m = tree_level_inputs(s["n"], s["d"], s["bins"], s["wc"], s["trees"], seed=3)
        out = hist_ops.hist(b, m, s["bins"])
        if not torch.equal(library_hist(b, m, s["bins"]), out):
            raise AssertionError(f"one-hot matmul disagrees with hist at {name}")
        bound_ms, bound_by = bound(b, m, out)
        timings[name] = dict(
            shape=s,
            kernel_ms=cuda_ms(lambda: hist_ops.hist(b, m, s["bins"])),
            plain_ms=cuda_ms(lambda: hist_ops.hist_plain(b, m, s["bins"])),
            library_ms=cuda_ms(lambda: library_hist(b, m, s["bins"])),
            bound_ms=bound_ms,
            bound_by=bound_by,
        )
        emit("hist_time", name=name, **timings[name])
    return dict(max_abs_err=max_err, timings=timings)


def phase_hist_rows() -> dict:
    """The row-sparse kernel against ``hist_rows_plain`` at the test
    shapes and every main-path level shape: integer weights bit for bit,
    float32 weights within rtol 1e-5 (its merges add in any order); then
    kernel, plain, one-hot-matmul and one-call index_add_ times at each
    level shape, the matmul's dense ``m`` and the index_add_'s index
    built outside the timed region."""
    torch.backends.cuda.matmul.allow_tf32 = False
    max_err = 0.0
    for name, s in ROW_CHECK_SHAPES.items():
        wc, bins = s["wc"], s["bins"]
        diffs = {}
        for integer, seed in ((True, 1), (False, 2)):
            b, slot, w = tree_row_inputs(**s, integer=integer, seed=seed)
            got = hist_ops.hist_rows(b, slot, w, wc, bins)
            want = hist_ops.hist_rows_plain(b, slot, w, wc, bins)
            torch.cuda.synchronize()
            diffs[integer] = float((got - want).abs().max())
            if integer and not torch.equal(got, want):
                raise AssertionError(
                    f"hist_rows {name}: integer weights differ by {diffs[integer]}"
                )
            if not integer:
                rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
                torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
        max_err = max(max_err, *diffs.values())
        emit("hist_rows_check", shape=name, **s, max_abs_diff_int=diffs[True],
             max_abs_diff_f32=diffs[False], max_rel_diff_f32=rel)

    timings = {}
    for name, s in {**ROW_LEVEL_SHAPES, **UCIHAR_ROW_LEVEL_SHAPES}.items():
        wc, bins = s["wc"], s["bins"]
        b, slot, w = tree_row_inputs(**s, seed=3)
        out = hist_ops.hist_rows(b, slot, w, wc, bins)
        m = dense_m(slot, w, wc)
        if not torch.equal(library_hist(b, m, bins), out):
            raise AssertionError(f"one-hot matmul disagrees with hist_rows at {name}")
        index, values = index_add_inputs(b, slot, w, wc, bins)
        if not torch.equal(library_index_add(index, values, out.numel()).view_as(out), out):
            raise AssertionError(f"index_add_ disagrees with hist_rows at {name}")
        bound_ms, bound_by = rows_bound(b, slot, w, out)
        plan = hist_ops.rows_plan(s["n"], s["d"], bins, wc, s["trees"],
                                  hist_ops.sm_count(b.device.index))
        timings[name] = dict(
            shape=s,
            plan=plan,
            kernel_ms=cuda_ms(lambda: hist_ops.hist_rows(b, slot, w, wc, bins)),
            kernel_graph_ms=graph_ms(lambda: hist_ops.hist_rows(b, slot, w, wc, bins)),
            plain_ms=cuda_ms(lambda: hist_ops.hist_rows_plain(b, slot, w, wc, bins)),
            library_ms=cuda_ms(lambda: library_hist(b, m, bins)),
            index_add_ms=cuda_ms(lambda: library_index_add(index, values, out.numel())),
            bound_ms=bound_ms,
            bound_by=bound_by,
            **rows_memset(out, plan[3]),
        )
        emit("hist_rows_time", name=name, **timings[name])
        del m, index, values
    return dict(max_abs_err=max_err, timings=timings)


def qkv_inputs(b, t, h, d, dtype, seed=0, pad=0):
    """q, k, v as an encoder block hands them to K2: (B, T, H, D) views of
    one fused (B, T, 3·H·D) projection, standard normal; ``pad`` extra
    columns widen the projection's time stride."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d + pad), generator=g, device="cuda").to(dtype)
    return tuple(
        z.unflatten(-1, (h, d)) for z in qkv[..., : 3 * h * d].split(h * d, dim=-1)
    )


def library_attention(q, k, v):
    """One PyTorch call computing the same function, as a yardstick the
    port never calls: scaled_dot_product_attention in (B, H, T, D)."""
    out = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    )
    return out.transpose(1, 2)


def flash_bound(q, out, lse=None) -> tuple[float, str]:
    """Least milliseconds for the card: q, k and v read once and out (and
    lse) written once over the HBM rate, or 4·BH·T²·D flops over the bf16
    tensor-core rate, or BH·T² exponentials over the special-function
    units' rate, whichever is largest."""
    b, t, h, d = q.shape
    nbytes = 3 * q.numel() * q.element_size() + out.numel() * out.element_size()
    if lse is not None:
        nbytes += lse.numel() * lse.element_size()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(
        4 * b * h * t * t * d / BF16_FLOPS_PER_S, b * h * t * t / SFU_EXP_PER_S
    ) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def phase_flash() -> dict:
    """K2 against its plain version on the card.  float32: out and lse
    within rtol 1e-5 (atol 1e-6 for outputs that cancel to near zero);
    bfloat16: out within 1e-2, since it is rounded to bf16 (3 significant
    digits) after both sides accumulate in f32 at other places; lse, an
    f32 output of the same f32 scores, within rtol 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_tol = {
        torch.float32: dict(rtol=1e-5, atol=1e-6),
        torch.bfloat16: dict(rtol=1e-2, atol=1e-2),
    }
    max_err = 0.0
    with torch.no_grad():
        for name, s in FLASH_CHECK_SHAPES.items():
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = qkv_inputs(**s, dtype=dtype, seed=1)
                want_out, want_lse = flash_ops.attention_with_lse_plain(q, k, v)
                for with_lse in (False, True):
                    if with_lse:
                        out, lse = flash_ops.flash_attention_with_lse(q, k, v)
                    else:
                        out, lse = flash_ops.flash_attention(q, k, v), None
                    torch.cuda.synchronize()
                    diff = (out.float() - want_out.float()).abs()
                    fields = dict(out_max_abs_diff=float(diff.max()))
                    torch.testing.assert_close(out, want_out, **out_tol[dtype])
                    if lse is not None:
                        lse_diff = (lse - want_lse).abs()
                        fields.update(
                            lse_max_abs_diff=float(lse_diff.max()),
                            lse_max_rel_diff=float((lse_diff / want_lse.abs()).max()),
                        )
                        torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-6)
                    max_err = max(max_err, *fields.values())
                    emit("flash_check", shape=name, **s, dtype=str(dtype)[6:],
                         with_lse=with_lse, **fields)

        timings = {}
        plan = getattr(flash_ops, "flash_plan", None)
        for name, s in FLASH_TIME_SHAPES.items():
            q, k, v = qkv_inputs(**s, dtype=torch.bfloat16, seed=3)
            out = flash_ops.flash_attention(q, k, v)
            torch.testing.assert_close(library_attention(q, k, v), out, rtol=1e-2, atol=1e-2)
            bound_ms, bound_by = flash_bound(q, out)
            timings[name] = dict(
                shape=s,
                dtype="bfloat16",
                plan=None if plan is None else vars(
                    plan(**s, sm_count=hist_ops.sm_count(q.device.index))
                ),
                kernel_ms=cuda_ms(lambda: flash_ops.flash_attention(q, k, v)),
                kernel_graph_ms=graph_ms(lambda: flash_ops.flash_attention(q, k, v)),
                plain_ms=cuda_ms(lambda: flash_ops.attention_with_lse_plain(q, k, v)),
                library_ms=cuda_ms(lambda: library_attention(q, k, v)),
                bound_ms=bound_ms,
                bound_by=bound_by,
            )
            emit("flash_time", name=name, **timings[name])
            del q, k, v, out
    return dict(max_abs_err=max_err, timings=timings)


def _tree_arrays(model):
    if hasattr(model, "tree"):
        t = model.tree
        return [t.feature, t.threshold, t.leaf_class, t.leaf_probs, t.leaf_counts]
    return [model.feature, model.threshold, model.leaf_probs]


def phase_agree() -> None:
    """Trees grown on the card equal the same trees grown on the CPU: the
    bootstrap and feature draws come from one CPU generator and the
    histograms are exact, so every split must be the same."""
    config = RunConfig(data=DataConfig(synthetic_rows=600))
    train, _, _ = featurize(config, load_dataset(config))
    for est in (DecisionTreeClassifier(), RandomForestClassifier(num_trees=8)):
        on_card = _tree_arrays(est.fit(train))
        on_cpu = _tree_arrays(est.copy_with(device="cpu").fit(train))
        for a, b in zip(on_card, on_cpu):
            if not (a.shape == b.shape and (a == b).all()):
                raise AssertionError(f"{type(est).__name__}: card and CPU trees differ")
    emit("agree", rows=600, models=["decision_tree", "random_forest"], equal=True)


def phase_transformer_agree() -> None:
    """Three float32 training steps of the CLI-width transformer (dropout
    0) on the card and on the CPU from the same initial values (drawn from
    one CPU generator) and the same batches.  Losses, parameters and
    logits agree within 1e-4: the card's sums run in other orders.  The
    key bias is left out of the parameter check: its gradient is exactly
    zero (softmax ignores a constant added to a row's scores), and Adam
    normalizes the float noise left in it into full-size steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = load_dataset(RunConfig(data=DataConfig(dataset="wisdm_raw", synthetic_rows=64)))
    x = StandardScaler().fit(raw.windows).transform(raw.windows)
    cfg = TrainerConfig(batch_size=64, epochs=3, learning_rate=1e-3)
    fits = {
        device: Trainer(Transformer1D(dtype="float32", dropout_rate=0.0), cfg, device=device)
        .fit(x, raw.labels, num_classes=6)
        for device in ("cuda", "cpu")
    }
    card, cpu = fits["cuda"], fits["cpu"]
    loss_diff = max(abs(a - b) for a, b in zip(card.history["loss"], cpu.history["loss"]))
    param_diff = 0.0
    e = card.module.embed_dim
    cpu_sd = cpu.module.state_dict()
    for key, value in card.module.state_dict().items():
        a, b = value.cpu(), cpu_sd[key]
        if key.endswith("qkv.bias"):
            a, b = torch.cat([a[:e], a[2 * e :]]), torch.cat([b[:e], b[2 * e :]])
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=key)
        param_diff = max(param_diff, float((a - b).abs().max()))
    logits = [f.predict_logits(x[:32]) for f in (card, cpu)]
    logit_diff = float(abs(logits[0] - logits[1]).max())
    emit("transformer_agree", steps=3, losses_card=card.history["loss"],
         losses_cpu=cpu.history["loss"], max_loss_diff=loss_diff,
         max_param_diff=param_diff, max_logit_diff=logit_diff)
    if not (loss_diff <= 1e-4 and logit_diff <= 1e-4):
        raise AssertionError("the card's transformer steps disagree with the CPU's")


# NeuralModel.predict_logits scores in chunks of this many windows
PREDICT_CHUNK = 8192


def expected_flash_launches(config: RunConfig) -> int:
    """K2 launches of one raw run: every encoder layer attends once per
    training step and once per prediction chunk."""
    train, test, _ = featurize(config, load_dataset(config))
    est = runner.build_estimator("transformer", config.model.params, "cpu")
    layers = len(Transformer1D(**est.model_kwargs).blocks)
    steps = est.config.epochs * math.ceil(len(train) / est.config.batch_size)
    return layers * (steps + math.ceil(len(test) / PREDICT_CHUNK))


def run_cli_json(argv: list[str]) -> dict:
    """``cli.main(argv)`` with its printout captured: the JSON it prints."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}")
    return json.loads(printed.getvalue().strip().splitlines()[-1])


def run_cli(argv: list[str]) -> dict:
    """``cli.main(argv)`` with its printout captured: the accuracies."""
    return run_cli_json(argv)["accuracies"]


ARTIFACTS = ("result.txt", "additional_param.csv", "timing.csv")


def drive_path(name: str, out_dir: Path, drive, hist_rows: int = 0,
               flash: int = 0, artifacts=ARTIFACTS) -> dict:
    """Drive one main path with every launch count set to 0 just before
    it and read just after: each kernel must launch exactly as often as
    expected (0 for a kernel off the path: the dense hist kernel is off
    every path), and the run must write its artifacts.  ``drive``
    returns the accuracies."""
    torch.cuda.reset_peak_memory_stats()
    hist_ops.HIST_LAUNCHES = 0
    hist_ops.HIST_ROWS_LAUNCHES = 0
    flash_ops.FLASH_LAUNCHES = 0
    t0 = time.perf_counter()
    accuracies = drive()
    seconds = time.perf_counter() - t0
    launches = dict(hist=hist_ops.HIST_LAUNCHES, hist_rows=hist_ops.HIST_ROWS_LAUNCHES,
                    flash_attention=flash_ops.FLASH_LAUNCHES)
    expected = dict(hist=0, hist_rows=hist_rows, flash_attention=flash)
    for artifact in artifacts:
        if not (out_dir / artifact).is_file():
            raise AssertionError(f"{name} wrote no {artifact}")
    timing = None  # parity writes no timing.csv
    if "timing.csv" in artifacts:
        with open(out_dir / "timing.csv", newline="") as f:
            timing = {row["section"]: float(row["seconds"]) for row in csv.DictReader(f)}
    emit(name, seconds=seconds, launches=launches, expected_launches=expected,
         accuracies=accuracies, timing=timing,
         peak_device_bytes=torch.cuda.max_memory_allocated())
    if launches != expected:
        raise AssertionError(f"{name}: launches {launches}, expected {expected}")
    return dict(launches=launches, accuracies=accuracies, seconds=seconds, timing=timing,
                peak_device_bytes=torch.cuda.max_memory_allocated())


def check_floor(name: str, accuracy: float, floor: float) -> None:
    if not accuracy >= floor:
        raise AssertionError(f"{name}: accuracy {accuracy} < {floor}")


def phase_main() -> dict:
    """The tree path: ``train --models dt rf --no-cv`` at the reference's
    widths."""
    out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke"
    dt, rf = DecisionTreeClassifier(), RandomForestClassifier()
    argv = ["train", "--models", "dt", "rf", "--no-cv", "--device", "cuda",
            "--output-dir", str(out_dir)]
    path = drive_path(
        "main", out_dir, lambda: run_cli(argv),
        hist_rows=dt.max_depth + math.ceil(rf.num_trees / TREE_BATCH) * rf.max_depth,
    )
    acc = path["accuracies"]
    if acc["decision_tree"] != DT_EXPECTED_CORRECT / TEST_ROWS:
        raise AssertionError(f"DT accuracy {acc['decision_tree']} != 1494/1625")
    check_floor("random_forest", acc["random_forest"], RF_MIN_ACCURACY)
    return path


def phase_raw_main() -> dict:
    """The CLI's raw path at its defaults, as a user runs it."""
    out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "raw_main"
    config = RunConfig(
        data=DataConfig(dataset="wisdm_raw"),
        model=ModelConfig(name="transformer"),
        output_dir=str(out_dir),
    )
    argv = ["train", "--dataset", "wisdm_raw", "--models", "transformer",
            "--no-cv", "--device", "cuda", "--output-dir", str(out_dir)] + SAVE
    path = drive_path("raw_main", out_dir, lambda: run_cli(argv),
                      flash=expected_flash_launches(config))
    check_floor("raw_main", path["accuracies"]["transformer"], RAW_MAIN_MIN_ACCURACY)
    return path


def phase_raw_packed() -> dict:
    """runner.run at the raw bench lane's widths: patch 8, window_pack 8
    (the segment-folded kernel route), scanned layers, batch 4096."""
    out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "raw_packed"
    config = RunConfig(
        data=DataConfig(dataset="wisdm_raw"),
        model=ModelConfig(name="transformer", params=RAW_PACKED_PARAMS),
        output_dir=str(out_dir),
    )
    path = drive_path(
        "raw_packed", out_dir,
        lambda: runner.run(
            config, models=["transformer"], with_cv=False, device="cuda"
        ).accuracies,
        flash=expected_flash_launches(config),
    )
    check_floor("raw_packed", path["accuracies"]["transformer"], RAW_PACKED_MIN_ACCURACY)
    return path


def noisy_table(n: int, d: int, classes: int = 6, seed: int = 0,
                noise: float = 8.0) -> FeatureSet:
    """Class-conditional Gaussians under noise, the first half of the
    columns sparse 0/1 (a one-hot block's shape): LR fits about 92% of
    its training rows and its grid points stay apart."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n).astype(np.int32)
    x = rng.normal(0.0, 1.0, (classes, d))[y] + rng.normal(0.0, noise, (n, d))
    x[:, : d // 2] = rng.random((n, d // 2)) < 0.05
    return FeatureSet(x.astype(np.float32), y)


def phase_lr_agree() -> dict:
    """LR's fit and its 9-point CV sweep on the card and on the CPU, at the
    main path's width on a noisy table; the sweep timed from CUDA events
    with the line search's host reads counted.  Both fits run the same
    algorithm; only the order of float sums differs."""
    data = noisy_table(N, D)
    grid = param_grid(**runner.REFERENCE_GRIDS["logistic_regression"])
    fits = {dev: lr_ops.LogisticRegression(device=dev).fit(data) for dev in ("cuda", "cpu")}
    card, cpu = fits["cuda"], fits["cpu"]
    loss_rel = float(np.max(np.abs(card.losses - cpu.losses) / np.abs(cpu.losses)))
    objectives = [lr_ops.objective(m, data, 0.3) for m in (card, cpu)]
    objective_rel = abs(objectives[0] - objectives[1]) / abs(objectives[1])
    flips = int((card.transform(data).prediction != cpu.transform(data).prediction).sum())

    folds = kfold_indices(len(data), CV_FOLDS, 2018)
    sweeps, cv = {}, {}
    for dev in ("cuda", "cpu"):
        est = lr_ops.LogisticRegression(device=dev)
        cv[dev] = CrossValidator(est, grid).fit(data)
        if dev == "cuda":  # warm, then time one sweep alone
            syncs = lbfgs.HOST_SYNCS
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            sweeps[dev] = est.cv_scores(data, folds, grid, "accuracy")
            end.record()
            end.synchronize()
            sweep_ms, sweep_syncs = start.elapsed_time(end), lbfgs.HOST_SYNCS - syncs
    one_row = float(np.mean([1.0 / len(v) for _, v in folds]))
    avg_diff = float(np.max(np.abs(np.subtract(cv["cuda"].avg_metrics, cv["cpu"].avg_metrics))))
    emit("lr_agree", rows=len(data), features=data.num_features,
         losses_card=card.losses.tolist(), losses_cpu=cpu.losses.tolist(),
         max_loss_rel_diff=loss_rel, objective_card=objectives[0],
         objective_cpu=objectives[1], objective_rel_diff=objective_rel,
         label_flips=flips, train_accuracy=float((cpu.transform(data).prediction == data.label).mean()),
         avg_metrics_card=cv["cuda"].avg_metrics, avg_metrics_cpu=cv["cpu"].avg_metrics,
         max_avg_metric_diff=avg_diff, one_validation_row=one_row,
         best_params_card=cv["cuda"].best_params, best_params_cpu=cv["cpu"].best_params,
         sweep_ms=sweep_ms, sweep_host_syncs=sweep_syncs, lanes_per_group=len(folds) * 3)
    if not (loss_rel <= LR_LOSS_RTOL and objective_rel <= LR_LOSS_RTOL):
        raise AssertionError("the card's LR fit disagrees with the CPU's")
    if flips > LR_MAX_LABEL_FLIPS * len(data):
        raise AssertionError(f"LR labels: {flips} of {len(data)} differ")
    if avg_diff > one_row + 1e-6 or cv["cuda"].best_params != cv["cpu"].best_params:
        raise AssertionError("the card's LR sweep disagrees with the CPU's")
    return dict(sweep_ms=sweep_ms, sweep_host_syncs=sweep_syncs)


def phase_cv_agree() -> None:
    """DT and RF CrossValidators (5 fold fits and a refit each) on the card
    and on the CPU over the default table's training split: K1 at the
    fold shapes, so every fold's score must be equal."""
    config = RunConfig()
    train, _, _ = featurize(config, load_dataset(config))
    out = {}
    for est in (DecisionTreeClassifier(), RandomForestClassifier(num_trees=CV_AGREE_TREES)):
        name = type(est).__name__
        card = CrossValidator(est).fit(train)
        cpu = CrossValidator(est.copy_with(device="cpu")).fit(train)
        out[name] = dict(card=card.avg_metrics, cpu=cpu.avg_metrics)
        if card.avg_metrics != cpu.avg_metrics:
            raise AssertionError(f"{name} CV: card {card.avg_metrics} != CPU {cpu.avg_metrics}")
    emit("cv_agree", rows=len(train), folds=CV_FOLDS, rf_trees=CV_AGREE_TREES,
         avg_metrics=out, equal=True)


def default_launches() -> int:
    """K1 launches of the default run: each family fits once, once a fold
    and once more to refit, each tree (or chunk of a forest) one launch a
    level."""
    dt, rf = DecisionTreeClassifier(), RandomForestClassifier()
    fits = 1 + CV_FOLDS + 1
    return fits * (dt.max_depth + math.ceil(rf.num_trees / TREE_BATCH) * rf.max_depth)


def phase_default_main(rf_accuracy: float) -> dict:
    """The reference's default command, ``train`` with no model flags: LR,
    DT and RF, each followed by its 5-fold CrossValidator."""
    out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "default_main"
    argv = ["train", "--device", "cuda", "--output-dir", str(out_dir)] + SAVE
    path = drive_path(
        "default_main", out_dir, lambda: run_cli(argv), hist_rows=default_launches(),
        artifacts=ARTIFACTS + ("crossFold_additional_param.csv",),
    )
    acc = path["accuracies"]
    for name in ("decision_tree", "decision_tree_cv"):
        if acc[name] != DT_EXPECTED_CORRECT / TEST_ROWS:
            raise AssertionError(f"{name} accuracy {acc[name]} != 1494/1625")
    for name in ("random_forest", "random_forest_cv"):
        if acc[name] != rf_accuracy:
            raise AssertionError(f"{name} accuracy {acc[name]} != main's {rf_accuracy}")
    for name in ("logistic_regression", "logistic_regression_cv"):
        check_floor(name, acc[name], LR_MIN_ACCURACY)
    return path


# har_tpu's parity run on the CPU: synthetic_wisdm(5418), and the reference
# CSV (the reference's printed accuracies, to the digits it prints)
PARITY_SYNTHETIC = {
    "logistic_regression": 1.0,
    "logistic_regression_cv": 1.0,
    "decision_tree": DT_EXPECTED_CORRECT / TEST_ROWS,
    "random_forest": 1364 / TEST_ROWS,
}
PARITY_REFERENCE_CSV = {
    "logistic_regression": 0.61477,
    "logistic_regression_cv": 0.71446,
    "decision_tree": 0.73046,
    "random_forest": 0.632,
}
PARITY_ARTIFACTS = ("result.txt", "additional_param.csv", "crossFold_additional_param.csv")
_UID = re.compile(r"_[0-9a-f]{20}\b")
_TIMING = re.compile(r"(trained in|made in) -?[\d.eE-]+ seconds")


def native_hashes() -> dict:
    """sha256 of every library of the JAX package's native/ directory."""
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((ROOT / "native").glob("*.so"))}


def _uid_and_timing_masked(path: Path) -> list[str]:
    """Every line of the file, each uid and each timing replaced by a
    fixed token, so the model lines (a tree's depth and node count) are
    still compared."""
    return [_TIMING.sub(r"\1 <t> seconds", _UID.sub("_<uid>", ln))
            for ln in path.read_text().splitlines()]


def _block_seconds(out_dir: Path) -> dict:
    """Each parity block's training and testing seconds, from its CSVs."""
    times = {}
    for name in PARITY_ARTIFACTS[1:]:
        with open(out_dir / name, newline="") as f:
            for row in csv.DictReader(f):
                train, test = (v for k, v in row.items() if k.endswith(("Training Time",
                                                                         "Testing Time")))
                times[row["Classifier"][:40]] = dict(train_s=float(train), test_s=float(test))
    return times


def phase_parity_main(native_before: dict) -> dict:
    """``parity``: the host libraries built first (g++'s version and each
    build's time), then the run on the card with K1's launches counted,
    then the same command with ``--device cpu`` for the file comparison."""
    gpp = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.splitlines()[0]
    builds = {}
    for lib in (raw_loader.NATIVE, _jvm_native.NATIVE):
        lib.load()
        builds[lib.path.name] = dict(seconds=lib.build_seconds, command=lib.command)
    emit("native_build", gpp=gpp, libraries=builds)

    out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "parity_main"
    cpu_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "parity_cpu"
    argv = ["parity", "--output-dir"]
    path = drive_path("parity_main", out_dir, lambda: run_cli(argv + [str(out_dir)]),
                      hist_rows=DT_DEPTH, artifacts=PARITY_ARTIFACTS)
    t0 = time.perf_counter()
    cpu_accuracies = run_cli(argv + [str(cpu_dir), "--device", "cpu"])
    cpu_seconds = time.perf_counter() - t0
    expected = PARITY_SYNTHETIC if DataConfig().resolved_path() is None else PARITY_REFERENCE_CSV
    acc = path["accuracies"]
    rounded = acc if expected is PARITY_SYNTHETIC else {k: round(v, 5) for k, v in acc.items()}
    same_file = _uid_and_timing_masked(out_dir / "result.txt") == _uid_and_timing_masked(
        cpu_dir / "result.txt")
    native_after = native_hashes()
    emit("parity_main_checks", expected_accuracies=expected, cpu_accuracies=cpu_accuracies,
         cpu_seconds=cpu_seconds, blocks_card=_block_seconds(out_dir),
         blocks_cpu=_block_seconds(cpu_dir), result_txt_equal_to_cpu=same_file,
         native_so_sha256=native_after, native_so_unchanged=native_after == native_before)
    if rounded != expected or cpu_accuracies != acc:
        raise AssertionError(f"parity accuracies {acc} (CPU {cpu_accuracies}) != {expected}")
    if not same_file:
        raise AssertionError("the card's parity result.txt differs from the CPU run's")
    if native_after != native_before:
        raise AssertionError(f"native/*.so changed: {native_before} -> {native_after}")
    return dict(path, cpu_seconds=cpu_seconds, result_txt_equal_to_cpu=same_file,
                native_so_unchanged=True,
                build_seconds={name: b["seconds"] for name, b in builds.items()})


def gbdt_row_inputs(n, d, bins, wc, trees, integer=False, seed=0):
    """bins, slot and weight as a boosted-tree level hands them to the
    row-sparse kernel: channels 2k and 2k+1 share tree k's node of each
    row (every 11th row out of the level, slot -1); weights are the
    gradient (p − onehot, of both signs) and the hessian (p·(1−p)) of a
    random p, or with ``integer`` small counts in [0, 3], which the
    kernel sums in int32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = torch.randint(0, bins, (n, d), generator=g, device="cuda", dtype=torch.int32)
    node = torch.randint(0, wc, (trees // 2, n), generator=g, device="cuda")
    node[:, ::11] = -1
    slot = node.repeat_interleave(2, dim=0).to(torch.int32)
    if integer:
        w = torch.randint(0, 4, (trees, n), generator=g, device="cuda").float()
    else:
        p = torch.rand((trees // 2, n), generator=g, device="cuda")
        onehot = (torch.rand((trees // 2, n), generator=g, device="cuda") < 1 / 6).float()
        h = torch.clamp(p * (1 - p), min=1e-6)
        w = torch.stack([p - onehot, h], dim=1).reshape(trees, n)
    return b, slot, w


def index_add_inputs(b, slot, w, wc, bins):
    """The flattened (T·wc·d·B) output index and the value of every (kept
    row, feature) pair: the one-call yardstick's inputs, built outside
    its timed region."""
    d = b.shape[1]
    keep = (w != 0) & (slot >= 0) & (slot < wc)
    t_idx, r_idx = keep.nonzero(as_tuple=True)
    features = torch.arange(d, device=b.device)
    row_slot = t_idx * wc + slot[t_idx, r_idx].long()
    index = ((row_slot[:, None] * d + features) * bins + b[r_idx].long()).reshape(-1)
    values = w[t_idx, r_idx][:, None].expand(-1, d).reshape(-1)
    return index, values


def library_index_add(index, values, size: int):
    """One PyTorch call computing the row-sparse histogram, as a
    yardstick the port never calls: index_add_ into a zeroed output."""
    return torch.zeros(size, device=values.device).index_add_(0, index, values)


def assert_float_hist_close(name, got, want, abs_sum) -> float:
    """The float tolerance of the row-sparse kernel (GBDT_HIST_*); returns
    the largest difference over the allowed one."""
    allowed = GBDT_HIST_RTOL * want.abs() + GBDT_HIST_ATOL_PER_ABS_SUM * abs_sum
    excess = float(((got - want).abs() / allowed.clamp(min=1e-30)).max())
    if not excess <= 1.0:
        raise AssertionError(f"{name}: float histogram off by {excess} of its tolerance")
    return excess


def phase_gbdt_hist() -> dict:
    """The row-sparse kernel at every boosted-tree level shape (2K = 12
    channels, live width 1-16, d 13 and 43): small integer weights bit
    for bit (the int32 path), signed float weights within the stated
    tolerance (the float path); then kernel (CUDA events and a CUDA
    graph), plain and one-call index_add_ times, the byte bound and the
    output's zeroing."""
    max_err = 0.0
    timings = {}
    for name, s in GBDT_LEVEL_SHAPES.items():
        wc, bins = s["wc"], s["bins"]
        b, slot, w = gbdt_row_inputs(**s, integer=True, seed=1)
        got = hist_ops.hist_rows(b, slot, w, wc, bins)
        want = hist_ops.hist_rows_plain(b, slot, w, wc, bins)
        torch.cuda.synchronize()
        int_diff = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"hist_rows {name}: integer weights differ by {int_diff}")
        b, slot, w = gbdt_row_inputs(**s, seed=2)
        got = hist_ops.hist_rows(b, slot, w, wc, bins)
        want = hist_ops.hist_rows_plain(b, slot, w, wc, bins)
        abs_sum = hist_ops.hist_rows_plain(b, slot, w.abs(), wc, bins)
        excess = assert_float_hist_close(f"hist_rows {name}", got, want, abs_sum)
        f32_diff = float((got - want).abs().max())
        max_err = max(max_err, int_diff, f32_diff)
        emit("gbdt_hist_check", shape=name, **s, max_abs_diff_int=int_diff,
             max_abs_diff_f32=f32_diff, share_of_tolerance_f32=excess)

        b, slot, w = gbdt_row_inputs(**s, seed=3)
        out = hist_ops.hist_rows(b, slot, w, wc, bins)
        index, values = index_add_inputs(b, slot, w, wc, bins)
        library = library_index_add(index, values, out.numel()).view_as(out)
        assert_float_hist_close(f"index_add_ {name}", library, out,
                                hist_ops.hist_rows_plain(b, slot, w.abs(), wc, bins))
        bound_ms, bound_by = rows_bound(b, slot, w, out)
        plan = hist_ops.rows_plan(s["n"], s["d"], bins, wc, s["trees"],
                                  hist_ops.sm_count(b.device.index))
        timings[name] = dict(
            shape=s,
            plan=plan,
            kernel_ms=cuda_ms(lambda: hist_ops.hist_rows(b, slot, w, wc, bins)),
            kernel_graph_ms=graph_ms(lambda: hist_ops.hist_rows(b, slot, w, wc, bins)),
            plain_ms=cuda_ms(lambda: hist_ops.hist_rows_plain(b, slot, w, wc, bins)),
            library_ms=cuda_ms(lambda: library_index_add(index, values, out.numel())),
            bound_ms=bound_ms,
            bound_by=bound_by,
            **rows_memset(out, plan[3]),
        )
        emit("gbdt_hist_time", name=name, **timings[name])
    return dict(max_abs_err=max_err, timings=timings)


@contextlib.contextmanager
def recorded_labels():
    """The predicted labels of every model a run scores, in its order
    (``runner.evaluate`` wrapped)."""
    seen = []
    evaluate = runner.evaluate

    def record(label, raw, num_classes):
        seen.append(np.asarray(raw).argmax(-1))
        return evaluate(label, raw, num_classes)

    runner.evaluate = record
    try:
        yield seen
    finally:
        runner.evaluate = evaluate


def phase_gbdt_main() -> dict:
    """``train --models gbt --no-cv`` on the card (every level one
    hist_rows launch: rounds x depth), the same command on the CPU (card
    labels against CPU labels), then the default CV pass (7 fits)."""
    out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "gbdt_main"
    cpu_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "gbdt_cpu"
    cv_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "gbdt_cv_main"
    argv = ["train", "--models", "gbt", "--output-dir"]
    with recorded_labels() as card_labels:
        path = drive_path("gbdt_main", out_dir,
                          lambda: run_cli(argv + [str(out_dir), "--no-cv", "--device", "cuda"]
                                          + SAVE),
                          hist_rows=GBDT_LAUNCHES)
    t0 = time.perf_counter()
    with recorded_labels() as cpu_labels:
        cpu_accuracies = run_cli(argv + [str(cpu_dir), "--no-cv", "--device", "cpu"])
    cpu_seconds = time.perf_counter() - t0
    agreement = float((card_labels[0] == cpu_labels[0]).mean())
    emit("gbdt_main_checks", cpu_accuracies=cpu_accuracies, cpu_seconds=cpu_seconds,
         label_agreement=agreement, test_rows=len(card_labels[0]))
    check_floor("gbdt", path["accuracies"]["gbdt"], GBT_MIN_ACCURACY)
    if agreement < GBT_MIN_LABEL_AGREEMENT:
        raise AssertionError(f"GBDT labels: card and CPU agree on {agreement}")
    cv = drive_path("gbdt_cv_main", cv_dir,
                    lambda: run_cli(argv + [str(cv_dir), "--device", "cuda"]),
                    hist_rows=(1 + CV_FOLDS + 1) * GBDT_LAUNCHES,
                    artifacts=ARTIFACTS + ("crossFold_additional_param.csv",))
    for name in ("gbdt", "gbdt_cv"):
        check_floor(name, cv["accuracies"][name], GBT_MIN_ACCURACY)
    return dict(path, cpu_seconds=cpu_seconds, label_agreement=agreement, cv=cv)


def phase_raw_features_main() -> dict:
    """The 43 features of the raw path's 4,000 windows on the card against
    the CPU (histogram columns exact, the rest within 1e-5), then ``train
    --dataset wisdm_raw --models dt gbt --no-cv``: DT's and GBDT's levels
    on hist_rows."""
    windows = torch.as_tensor(
        load_dataset(RunConfig(data=DataConfig(dataset="wisdm_raw"))).windows
    )
    card = extract_features(windows.cuda())
    cpu = extract_features(windows)
    card_host = card.cpu()
    hist_equal = torch.equal(card_host[:, :30], cpu[:, :30])
    rest_diff = float((card_host[:, 30:] - cpu[:, 30:]).abs().max())
    windows_cuda = windows.cuda()
    emit("raw_features_check", windows=list(windows.shape), histogram_columns_equal=hist_equal,
         max_abs_diff_other=rest_diff,
         extract_ms=cuda_ms(lambda: extract_features(windows_cuda)))
    if not hist_equal:
        raise AssertionError("raw features: the card's histogram columns differ")
    torch.testing.assert_close(card_host[:, 30:], cpu[:, 30:], rtol=1e-5, atol=1e-5)
    out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "raw_features_main"
    argv = ["train", "--dataset", "wisdm_raw", "--models", "dt", "gbt", "--no-cv",
            "--device", "cuda", "--output-dir", str(out_dir)]
    path = drive_path("raw_features_main", out_dir, lambda: run_cli(argv),
                      hist_rows=DT_DEPTH + GBDT_LAUNCHES)
    check_floor("raw decision_tree", path["accuracies"]["decision_tree"], RAW_DT_MIN_ACCURACY)
    check_floor("raw gbdt", path["accuracies"]["gbdt"], GBT_MIN_ACCURACY)
    return path


NEURAL_AGREE_CASES = {
    "mlp": ("mlp", {}),
    "cnn1d_max_layer": ("cnn1d", dict(pool="max", norm="layer")),
    "cnn1d_stride_rms": ("cnn1d", dict(pool="stride", norm="rms")),
    "bilstm_bf16_stream": ("bilstm", dict(bf16_stream=True)),
}


def phase_neural_agree() -> dict:
    """Three float32 training steps (dropout 0) of each family at the
    CLI's widths on the card and on the CPU from the same initial values
    and batches: losses within rtol 1e-5, logits within 1e-4 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    raw = load_dataset(RunConfig(data=DataConfig(dataset="wisdm_raw", synthetic_rows=64)))
    inputs = {
        "raw": (StandardScaler().fit(raw.windows).transform(raw.windows), raw.labels),
    }
    config = RunConfig(model=ModelConfig(name="mlp"), data=DataConfig(synthetic_rows=600))
    tab, _, _ = featurize(config, load_dataset(config))
    inputs["tabular"] = (StandardScaler().fit(tab.features).transform(tab.features)[:64],
                         tab.label[:64])
    cfg = TrainerConfig(batch_size=64, epochs=3, learning_rate=1e-3)
    out = {}
    for case, (family, kw) in NEURAL_AGREE_CASES.items():
        x, y = inputs["tabular" if family == "mlp" else "raw"]
        kw = dict(kw, dtype="float32", dropout_rate=0.0, in_features=x.shape[-1])
        init = build_model(family, 6, **kw).state_dict()
        fits = {
            device: Trainer(build_model(family, 6, **kw), cfg, device=device).fit(
                x, y, num_classes=6, init_params=init)
            for device in ("cuda", "cpu")
        }
        card, cpu = fits["cuda"], fits["cpu"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card.history["loss"],
                                                          cpu.history["loss"]))
        logits = [f.predict_logits(x[:32]) for f in (card, cpu)]
        logit_diff = float(abs(logits[0] - logits[1]).max())
        out[case] = dict(max_loss_rel_diff=loss_rel, max_logit_diff=logit_diff)
        emit("neural_agree", case=case, steps=3, losses_card=card.history["loss"],
             losses_cpu=cpu.history["loss"], **out[case])
        if not (loss_rel <= 1e-5 and logit_diff <= 1e-4):
            raise AssertionError(f"{case}: the card's steps disagree with the CPU's")
    return out


# the neural paths at the CLI's widths and 60 epochs: (name, argv, model,
# accuracy floor)
NEURAL_PATHS = (
    ("mlp_main", ["train", "--models", "mlp", "--no-cv"], "mlp", MLP_MIN_ACCURACY),
    ("cnn1d_main", ["train", "--dataset", "wisdm_raw", "--models", "cnn1d", "--no-cv"]
     + SAVE, "cnn1d", CNN1D_MIN_ACCURACY),
    ("cnn1d_augment_main", ["train", "--dataset", "wisdm_raw", "--models", "cnn1d",
                            "--no-cv", "--augment", "raw_windows"],
     "cnn1d", CNN1D_MIN_ACCURACY),
    ("bilstm_main", ["train", "--dataset", "wisdm_raw", "--models", "bilstm", "--no-cv"],
     "bilstm", BILSTM_MIN_ACCURACY),
)


def phase_neural_main() -> dict:
    """The MLP on the table's numeric view, the CNN1D (with and without
    augmentation) and the BiLSTM on the raw windows, each through the CLI
    on the card: no K1 or K2 launch, an accuracy floor, the train time
    and peak memory."""
    out = {}
    for name, argv, model, floor in NEURAL_PATHS:
        out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / name
        full = argv + ["--device", "cuda", "--output-dir", str(out_dir)]
        path = drive_path(name, out_dir, lambda: run_cli(full))
        check_floor(name, path["accuracies"][model], floor)
        out[name] = dict(accuracy=path["accuracies"][model], seconds=path["seconds"],
                         fit_s=path["timing"][f"{model}_fit"],
                         peak_device_bytes=path["peak_device_bytes"])
    return out


@contextlib.contextmanager
def launch_counts():
    """Every kernel's launches inside the block (each count set to 0 on
    entry, read on exit)."""
    hist_ops.HIST_LAUNCHES = 0
    hist_ops.HIST_ROWS_LAUNCHES = 0
    flash_ops.FLASH_LAUNCHES = 0
    counts: dict = {}
    yield counts
    counts.update(hist=hist_ops.HIST_LAUNCHES, hist_rows=hist_ops.HIST_ROWS_LAUNCHES,
                  flash_attention=flash_ops.FLASH_LAUNCHES)


@contextlib.contextmanager
def recorded_histories():
    """The history of every neural fit inside the block (``Trainer.fit``
    wrapped)."""
    seen = []
    fit = Trainer.fit

    def record(self, *args, **kwargs):
        model = fit(self, *args, **kwargs)
        seen.append(model.history)
        return model

    Trainer.fit = record
    try:
        yield seen
    finally:
        Trainer.fit = fit


def _csv_rows(path: Path) -> list:
    """The UID, label and prediction columns of a predictions CSV."""
    with open(path, newline="") as f:
        return [r[:3] for r in csv.reader(f)]


def _probabilities(path: str, device: str) -> np.ndarray:
    """A saved model's probabilities on its held-out rows, unrounded (the
    CSV prints 6 digits, so its strings differ where a value sits at a
    rounding boundary)."""
    model, test = checkpoint._load_checkpoint_for_scoring(
        path, None, None, None, None, None, device)
    return np.asarray(model.transform(test).probability, np.float64)


def lifecycle_scoring(trained: dict) -> dict:
    """``evaluate`` and ``predict`` of every saved model on the card
    (counted: K1 never, K2 once a layer a prediction chunk of a
    transformer), then ``predict`` with ``--device cpu``: its CSV's
    prediction columns against the card's, and the model's probabilities
    on the two devices."""
    out, expected_flash = {}, 0
    with launch_counts() as launches:
        for name in trained:
            path = str(MODELS_DIR / name)
            t0 = time.perf_counter()
            scored = run_cli_json(["evaluate", "--checkpoint", path, "--device", "cuda"])
            t1 = time.perf_counter()
            run_cli_json(["predict", "--checkpoint", path, "--device", "cuda",
                          "--output", str(OUT / "predict" / f"{name}_cuda.csv")])
            t2 = time.perf_counter()
            meta = checkpoint.load_model_meta(path)
            if meta["model_name"] == "transformer":
                layers = len(checkpoint.load_model(path, "cpu").inner.module.blocks)
                expected_flash += 2 * layers * math.ceil(scored["n_test"] / PREDICT_CHUNK)
            out[name] = dict(accuracy=scored["accuracy"], trained=trained[name],
                             n_test=scored["n_test"], evaluate_s=t1 - t0,
                             predict_s=t2 - t1)
    for name in trained:
        path = str(MODELS_DIR / name)
        t0 = time.perf_counter()
        run_cli_json(["predict", "--checkpoint", path, "--device", "cpu",
                      "--output", str(OUT / "predict" / f"{name}_cpu.csv")])
        cpu_s = time.perf_counter() - t0
        card_rows = _csv_rows(OUT / "predict" / f"{name}_cuda.csv")
        cpu_rows = _csv_rows(OUT / "predict" / f"{name}_cpu.csv")
        prob_diff = np.abs(_probabilities(path, "cuda") - _probabilities(path, "cpu")).max()
        meta = checkpoint.load_model_meta(path)
        bf16 = (meta.get("format") != "classical"
                and meta["model_kwargs"].get("dtype", "bfloat16") == "bfloat16")
        out[name].update(
            predictions_equal=card_rows == cpu_rows,
            max_prob_diff=float(prob_diff),
            prob_atol=PREDICT_PROB_ATOL_BF16 if bf16 else PREDICT_PROB_ATOL,
            cpu_predict_s=cpu_s,
        )
    expected = dict(hist=0, hist_rows=0, flash_attention=expected_flash)
    emit("lifecycle_scoring", models=out, launches=launches, expected_launches=expected)
    if launches != expected:
        raise AssertionError(f"lifecycle scoring: launches {launches}, expected {expected}")
    for name, r in out.items():
        if r["accuracy"] != r["trained"]:
            raise AssertionError(f"evaluate {name}: {r['accuracy']} != train's {r['trained']}")
        if not (r["predictions_equal"] and r["max_prob_diff"] <= r["prob_atol"]):
            raise AssertionError(f"predict {name}: card and CPU disagree: {r}")
    return dict(models=out, launches=launches)


def lifecycle_resume() -> dict:
    """An MLP at the CLI's widths on the table's numeric view, 6 epochs
    with a snapshot every 2: crashed after its first snapshot, resumed,
    and held to the unbroken run."""
    config = RunConfig(model=ModelConfig(name="mlp"))
    train, _, _ = featurize(config, load_dataset(config), "cuda")
    x = StandardScaler().fit(train.features).transform(train.features)
    ckdir = OUT / "resume_checkpoints"
    shutil.rmtree(ckdir, ignore_errors=True)

    def fit(**kw):
        module = build_model("mlp", C, in_features=x.shape[-1])
        return Trainer(module, TrainerConfig(epochs=6, **kw), device="cuda").fit(
            x, train.label, num_classes=C)

    t0 = time.perf_counter()
    straight = fit()
    save = checkpoint.TrainCheckpointer.save

    def crashing_save(self, epoch, params, opt_state, extra=None):
        save(self, epoch, params, opt_state, extra)
        raise RuntimeError("simulated crash")

    checkpoint.TrainCheckpointer.save = crashing_save
    try:
        fit(checkpoint_dir=str(ckdir), save_every_epochs=2)
        raise AssertionError("the crashing run did not crash")
    except RuntimeError as err:
        if "simulated crash" not in str(err):
            raise
    finally:
        checkpoint.TrainCheckpointer.save = save
    resumed = fit(checkpoint_dir=str(ckdir), save_every_epochs=2)
    seconds = time.perf_counter() - t0
    want, got = straight.history["loss"][2:], resumed.history["loss"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    pairs = list(zip(resumed.module.state_dict().values(),
                     straight.module.state_dict().values()))
    exact = got == want and all(torch.equal(a, b) for a, b in pairs)
    param_diff = max(float((a - b).abs().max()) for a, b in pairs)
    out = dict(resumed_from_epoch=resumed.history["resumed_from_epoch"], exact=exact,
               max_loss_rel_diff=loss_rel, max_param_diff=param_diff, seconds=seconds)
    emit("lifecycle_resume", losses_unbroken=want, losses_resumed=got, **out)
    if out["resumed_from_epoch"] != 2 or len(got) != len(want):
        raise AssertionError(f"resume: {out}")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)
    return out


def lifecycle_early_stop() -> dict:
    """``train --models mlp --no-cv --early-stop-patience 3
    --checkpoint-dir`` twice: the second run resumes the finished search,
    trains nothing and scores the same."""
    ckdir = OUT / "early_stop_checkpoints"
    shutil.rmtree(ckdir, ignore_errors=True)
    argv = ["train", "--models", "mlp", "--no-cv", "--early-stop-patience", "3",
            "--checkpoint-dir", str(ckdir), "--device", "cuda",
            "--output-dir", str(OUT / "early_stop")]
    runs, seconds = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        with recorded_histories() as histories:
            runs.append((run_cli(argv), histories[0]))
        seconds.append(time.perf_counter() - t0)
    (first_acc, first), (second_acc, second) = runs
    out = dict(seconds=seconds, best_epoch=first["best_epoch"],
               stopped_epoch=first["stopped_epoch"],
               val_accuracy=first["val_accuracy"], accuracy=first_acc["mlp"],
               second_resumed_from_epoch=second.get("resumed_from_epoch"),
               second_epochs_trained=len(second["loss"]),
               second_accuracy=second_acc["mlp"])
    emit("lifecycle_early_stop", **out)
    if not (out["second_epochs_trained"] == 0
            and out["second_resumed_from_epoch"] == out["stopped_epoch"]
            and second["best_epoch"] == out["best_epoch"]
            and out["second_accuracy"] == out["accuracy"]):
        raise AssertionError(f"early stop: the second run differs: {out}")
    check_floor("early-stopped mlp", out["accuracy"], MLP_MIN_ACCURACY)
    return out


FROZEN = ("ConvBlock_0", "ConvBlock_1")


def lifecycle_finetune() -> dict:
    """``finetune`` of the saved CNN1D on the card with its first two
    blocks frozen: those tensors bit-identical to the checkpoint's."""
    ft_dir = OUT / "finetuned_cnn1d"
    shutil.rmtree(ft_dir, ignore_errors=True)
    t0 = time.perf_counter()
    with launch_counts() as launches:
        out = run_cli_json(["finetune", "--checkpoint", str(MODELS_DIR / "cnn1d"),
                            "--freeze", *FROZEN, "--output", str(ft_dir),
                            "--device", "cuda"])
    seconds = time.perf_counter() - t0
    with np.load(MODELS_DIR / "cnn1d" / "params.npz") as a, np.load(ft_dir / "params.npz") as b:
        frozen = {k: bool(np.array_equal(a[k], b[k])) for k in a.files
                  if k.split("/")[0] in FROZEN}
        head_moved = not np.array_equal(a["Dense_1/kernel"], b["Dense_1/kernel"])
    out.update(frozen_equal=all(frozen.values()), frozen_tensors=len(frozen),
               head_moved=head_moved, launches=launches, seconds=seconds)
    emit("lifecycle_finetune", **out)
    if not (frozen and out["frozen_equal"] and head_moved):
        raise AssertionError(f"finetune: frozen tensors moved or the head did not: {out}")
    if launches != dict(hist=0, hist_rows=0, flash_attention=0):
        raise AssertionError(f"finetune launched {launches}")
    check_floor("finetuned cnn1d", out["accuracy_after"], CNN1D_MIN_ACCURACY)
    return out


def phase_lifecycle_main(trained: dict) -> dict:
    """The saved models of the main paths, scored and predicted on the
    card against the CPU; resume, early stopping and fine-tuning."""
    t0 = time.perf_counter()
    scoring = lifecycle_scoring(trained)
    resume = lifecycle_resume()
    early_stop = lifecycle_early_stop()
    finetune = lifecycle_finetune()
    return dict(scoring=scoring, resume=resume, early_stop=early_stop,
                finetune=finetune, seconds=time.perf_counter() - t0)


# `stream` replays at the live cadence: one forward a hop, then the batch-1
# device calibration (serving.measure_device_latency: one warm call and
# StreamingClassifier.device_latency_ms's 16 timed ones)
STREAM_HOP = 20
STREAM_CALIBRATION_CALLS = 1 + 16
INT8_MAX_ACCURACY_DROP = 0.01
SERVING_DIR = OUT / "serving"


def _events(path: Path) -> tuple[list, np.ndarray]:
    """(t_index, label, raw_label) rows and the probabilities of a
    ``stream --events-csv`` file."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    return ([tuple(int(v) for v in r[:3]) for r in rows],
            np.array([[float(v) for v in r[4:]] for r in rows]))


def serving_stream(path: str, layers: int, hops: int) -> dict:
    """``stream`` of the saved transformer on the demo recording, plain
    and with ``--monitor``: on the card (K2 exactly (hops + calibration
    calls) x layers a run), then with ``--device cpu``: events, raw and
    smoothed labels equal, probabilities within the bf16 tolerance, the
    drift blocks equal."""
    out = {}
    for tag, extra in (("plain", []), ("monitor", ["--monitor"])):
        runs = {}
        for device in ("cuda", "cpu"):
            csv_path = SERVING_DIR / f"events_{tag}_{device}.csv"
            argv = ["stream", "--checkpoint", path, "--device", device,
                    "--events-csv", str(csv_path), *extra]
            t0 = time.perf_counter()
            with launch_counts() as launches:
                printed = run_cli_json(argv)
            runs[device] = dict(printed=printed, seconds=time.perf_counter() - t0,
                                launches=launches, events=_events(csv_path))
        card, cpu = runs["cuda"], runs["cpu"]
        expected = dict(hist=0, hist_rows=0,
                        flash_attention=(hops + STREAM_CALIBRATION_CALLS) * layers)
        prob_diff = float(np.abs(card["events"][1] - cpu["events"][1]).max())
        latency = card["printed"]["latency"]
        out[tag] = dict(
            n_events=card["printed"]["n_events"], launches=card["launches"],
            expected_launches=expected, labels_equal=card["events"][0] == cpu["events"][0],
            max_prob_diff=prob_diff, drift=card["printed"]["drift"],
            drift_equal=card["printed"]["drift"] == cpu["printed"]["drift"],
            timeline=card["printed"]["timeline"],
            latency={k: latency.get(k) for k in (
                "count", "p50_ms", "p95_ms", "max_ms", "steady_p50_ms", "device_p50_ms",
                "host_overhead_p50_ms")},
            cpu_latency={k: cpu["printed"]["latency"].get(k) for k in (
                "steady_p50_ms", "device_p50_ms", "host_overhead_p50_ms")},
            seconds=card["seconds"], cpu_seconds=cpu["seconds"],
        )
        emit("serving_stream", run=tag, **out[tag])
        r = out[tag]
        if r["n_events"] != hops or r["launches"] != expected:
            raise AssertionError(f"stream {tag}: {r['n_events']} events, launches "
                                 f"{r['launches']}, expected {hops} and {expected}")
        if not (r["labels_equal"] and prob_diff <= PREDICT_PROB_ATOL_BF16 and r["drift_equal"]):
            raise AssertionError(f"stream {tag}: card and CPU disagree: {r}")
    return out


def serving_offline(path: str, layers: int, hops: int) -> dict:
    """The same recording streamed on the card with smoothing ``none``,
    and ``classify_session`` of it in one batch: raw labels equal (a
    batch of 1 and one of 111 may take different GEMM kernels, so the
    probabilities are compared, not required equal)."""
    rec = cli.demo_recording()
    sc = serving.StreamingClassifier.from_checkpoint(path, device="cuda", smoothing="none",
                                                     hop=STREAM_HOP)
    with launch_counts() as launches:
        events = sc.replay(rec)
        offline = serving.classify_session(sc.model, rec, window=sc.window, hop=STREAM_HOP)
    expected = dict(hist=0, hist_rows=0,
                    flash_attention=(hops + STREAM_CALIBRATION_CALLS + 1) * layers)
    online = np.stack([e.probability for e in events])
    out = dict(
        n_windows=len(offline), launches=launches, expected_launches=expected,
        labels_equal=[e.raw_label for e in events] == offline.labels.tolist(),
        max_prob_diff=float(np.abs(online - offline.probability).max()),
    )
    emit("serving_offline", **out)
    if out["launches"] != expected or not out["labels_equal"]:
        raise AssertionError(f"classify_session against the stream: {out}")
    return out


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.iterdir())


def serving_artifacts(trained: dict, layers: int) -> dict:
    """``export`` of the saved transformer and CNN1D (float and int8), then
    ``evaluate`` and ``predict --artifact`` on the card: the float
    artifacts score the checkpoints' accuracies, the int8 one within
    0.01; predictions equal a ``--device cpu`` run's; K2 launches layers
    x prediction chunks a transformer scoring, and none elsewhere."""
    exports, out = {}, {}
    with launch_counts() as export_launches:
        for tag, name, extra in (("transformer", "transformer", []),
                                 ("cnn1d", "cnn1d", []),
                                 ("cnn1d_int8", "cnn1d", ["--quantize", "int8"])):
            t0 = time.perf_counter()
            exports[tag] = run_cli_json(["export", "--checkpoint", str(MODELS_DIR / name),
                                         "--output", str(SERVING_DIR / tag), *extra])
            exports[tag]["seconds"] = time.perf_counter() - t0
    if export_launches != dict(hist=0, hist_rows=0, flash_attention=0):
        raise AssertionError(f"export launched {export_launches}")
    for tag, name in (("transformer", "transformer"), ("cnn1d", "cnn1d"),
                      ("cnn1d_int8", "cnn1d")):
        art = str(SERVING_DIR / tag)
        with launch_counts() as launches:
            t0 = time.perf_counter()
            scored = run_cli_json(["evaluate", "--artifact", art, "--device", "cuda"])
            t1 = time.perf_counter()
            run_cli_json(["predict", "--artifact", art, "--device", "cuda",
                          "--output", str(SERVING_DIR / f"{tag}_cuda.csv")])
            t2 = time.perf_counter()
        run_cli_json(["predict", "--artifact", art, "--device", "cpu",
                      "--output", str(SERVING_DIR / f"{tag}_cpu.csv")])
        flash = (2 * layers * math.ceil(scored["n_test"] / PREDICT_CHUNK)
                 if name == "transformer" else 0)
        out[tag] = dict(
            accuracy=scored["accuracy"], checkpoint_accuracy=trained[name],
            quantized=scored["quantized"], n_test=scored["n_test"],
            launches=launches, expected_launches=dict(hist=0, hist_rows=0, flash_attention=flash),
            predictions_equal=(_csv_rows(SERVING_DIR / f"{tag}_cuda.csv")
                               == _csv_rows(SERVING_DIR / f"{tag}_cpu.csv")),
            bytes=exports[tag]["bytes"], export_s=exports[tag]["seconds"],
            evaluate_s=t1 - t0, predict_s=t2 - t1,
        )
    out["int8_artifact_ratio"] = out["cnn1d_int8"]["bytes"] / out["cnn1d"]["bytes"]
    out["int8_weight_ratio"] = exports["cnn1d_int8"]["quantized"]["ratio"]
    emit("serving_artifacts", **out)
    for tag in ("transformer", "cnn1d", "cnn1d_int8"):
        r = out[tag]
        if r["launches"] != r["expected_launches"] or not r["predictions_equal"]:
            raise AssertionError(f"artifact {tag}: {r}")
        if tag == "cnn1d_int8":
            if abs(r["accuracy"] - r["checkpoint_accuracy"]) > INT8_MAX_ACCURACY_DROP:
                raise AssertionError(f"int8 artifact accuracy {r['accuracy']} vs "
                                     f"{r['checkpoint_accuracy']}")
        elif r["accuracy"] != r["checkpoint_accuracy"]:
            raise AssertionError(f"artifact {tag} accuracy {r['accuracy']} != the "
                                 f"checkpoint's {r['checkpoint_accuracy']}")
    return out


def phase_serving_main(trained: dict) -> dict:
    """Single-stream serving on the card from lifecycle_main's saved CLI
    transformer (bf16) and CNN1D: `stream`, `classify_session`, `export`
    and the artifacts' `evaluate` / `predict`."""
    shutil.rmtree(SERVING_DIR, ignore_errors=True)
    SERVING_DIR.mkdir(parents=True)
    path = str(MODELS_DIR / "transformer")
    layers = len(checkpoint.load_model(path, "cpu").inner.module.blocks)
    window = checkpoint.load_model_meta(path)["input_shape"][0]
    hops = (len(cli.demo_recording()) - window) // STREAM_HOP + 1
    t0 = time.perf_counter()
    stream = serving_stream(path, layers, hops)
    offline = serving_offline(path, layers, hops)
    artifacts = serving_artifacts(trained, layers)
    launches = {
        "flash_attention": sum(r["launches"]["flash_attention"] for r in stream.values())
        + offline["launches"]["flash_attention"]
        + sum(artifacts[t]["launches"]["flash_attention"]
              for t in ("transformer", "cnn1d", "cnn1d_int8")),
    }
    return dict(stream=stream, offline=offline, artifacts=artifacts, launches=launches,
                seconds=time.perf_counter() - t0)


def ucihar_fixture() -> str:
    """The UCI-HAR fixture tree at the published size, written once (its
    test subjects are the writer's last file); returns its root."""
    base = UCIHAR_DIR / "UCI HAR Dataset"
    if not (base / "test" / "subject_test.txt").is_file():
        t0 = time.perf_counter()
        write_ucihar_fixture(str(UCIHAR_DIR), n_train=UCIHAR_TRAIN, n_test=UCIHAR_TEST,
                             seed=0)
        emit("ucihar_fixture", rows=UCIHAR_TRAIN + UCIHAR_TEST, features=UCIHAR_D,
             seconds=time.perf_counter() - t0,
             bytes=sum(p.stat().st_size for p in base.rglob("*") if p.is_file()))
    return str(base)


def phase_ucihar_main(root: str) -> dict:
    """``train --dataset ucihar`` with no model flags (LR, DT, RF and their
    CVs) on the fixture tree, saving its models: K1 as on the default run
    (the level loop never stops early), DT and DT-CV exactly har_tpu's,
    LR and RF floors; the host's split candidates over 561 features timed
    once; then ``evaluate`` of the saved DT on the card scores exactly the
    train run's accuracy without a launch."""
    out_dir = OUT / "ucihar_main"
    shutil.rmtree(UCIHAR_MODELS_DIR, ignore_errors=True)
    argv = ["train", "--dataset", "ucihar", "--data-path", root, "--device", "cuda",
            "--output-dir", str(out_dir), "--save-models-dir", str(UCIHAR_MODELS_DIR)]
    path = drive_path(
        "ucihar_main", out_dir, lambda: run_cli(argv), hist_rows=default_launches(),
        artifacts=ARTIFACTS + ("crossFold_additional_param.csv",),
    )
    acc = path["accuracies"]
    for name in ("decision_tree", "decision_tree_cv"):
        if acc[name] != UCIHAR_DT_ACCURACY:
            raise AssertionError(f"ucihar {name} accuracy {acc[name]} != {UCIHAR_DT_ACCURACY}")
    for name in ("logistic_regression", "logistic_regression_cv"):
        check_floor(f"ucihar {name}", acc[name], UCIHAR_LR_MIN_ACCURACY)
    for name in ("random_forest", "random_forest_cv"):
        check_floor(f"ucihar {name}", acc[name], UCIHAR_RF_MIN_ACCURACY)

    config = RunConfig(data=DataConfig(dataset="ucihar", path=root))
    train, _, _ = featurize(config, load_dataset(config), "cuda")
    t0 = time.perf_counter()
    mllib_split_candidates(train.features, B)
    candidates_s = time.perf_counter() - t0
    with launch_counts() as launches:
        t0 = time.perf_counter()
        scored = run_cli_json(["evaluate", "--checkpoint", str(UCIHAR_MODELS_DIR / "decision_tree"),
                               "--data-path", root, "--device", "cuda"])
        evaluate_s = time.perf_counter() - t0
    emit("ucihar_main_checks", train_rows=len(train), features=train.num_features,
         split_candidates_s=candidates_s, dt_fit_s=path["timing"]["decision_tree_fit"],
         evaluate=scored, evaluate_s=evaluate_s, evaluate_launches=launches)
    if (len(train), train.num_features) != (UCIHAR_N, UCIHAR_D):
        raise AssertionError(f"ucihar training view {len(train)} x {train.num_features}")
    if scored["accuracy"] != acc["decision_tree"] or any(launches.values()):
        raise AssertionError(f"ucihar evaluate: {scored['accuracy']}, launches {launches}")
    return dict(path, split_candidates_s=candidates_s, evaluate_s=evaluate_s)


def phase_ucihar_gbt_main(root: str) -> dict:
    """``train --dataset ucihar --models gbt mlp --no-cv``: one K1 launch a
    boosting level (rounds x depth, d = 561), none of K2, floors below
    har_tpu's."""
    out_dir = OUT / "ucihar_gbt_main"
    argv = ["train", "--dataset", "ucihar", "--data-path", root, "--models", "gbt", "mlp",
            "--no-cv", "--device", "cuda", "--output-dir", str(out_dir)]
    path = drive_path("ucihar_gbt_main", out_dir, lambda: run_cli(argv),
                      hist_rows=GBDT_LAUNCHES)
    check_floor("ucihar gbdt", path["accuracies"]["gbdt"], UCIHAR_GBT_MIN_ACCURACY)
    check_floor("ucihar mlp", path["accuracies"]["mlp"], UCIHAR_MLP_MIN_ACCURACY)
    return path


def phase_ucihar_parity_lane(root: str) -> dict:
    """``parity.ucihar_parity_lane`` on the fixture tree (LR's 9-point
    5-fold CV on the card): har_tpu's split and best grid point, its
    accuracy within one test row; no K1 or K2 launch."""
    lane = {}

    def drive():
        lane.update(parity.ucihar_parity_lane(root, device="cuda"))
        return {"logistic_regression_cv": lane["accuracy"]}

    path = drive_path("ucihar_parity_lane", OUT, drive, artifacts=())
    emit("ucihar_parity_lane_checks", lane=lane, expected=UCIHAR_LANE)
    if (lane["n_train"], lane["n_test"], lane["best_params"]) != (
            UCIHAR_LANE["n_train"], UCIHAR_LANE["n_test"], UCIHAR_LANE["best_params"]):
        raise AssertionError(f"ucihar lane {lane} != {UCIHAR_LANE}")
    if abs(lane["accuracy"] - UCIHAR_LANE["accuracy"]) > 1.0 / lane["n_test"]:
        raise AssertionError(f"ucihar lane accuracy {lane['accuracy']}")
    return dict(path, lane=lane)


def phase_sweep_main() -> dict:
    """``sweep`` at its defaults (LR, DT, RF at 70/80/90 % train, LR's CV)
    on the default table: K1 as three tree paths (LR launches none), 12
    rows in sweep.csv and sweep.txt, DT's accuracies equal to har_tpu's at
    each split, LR floors, RF at the tree path's floor."""
    out_dir = OUT / "sweep_main"
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["sweep", "--device", "cuda", "--output-dir", str(out_dir)]

    def drive():
        with contextlib.redirect_stdout(io.StringIO()):
            if cli.main(argv) != 0:
                raise AssertionError(f"cli {argv} failed")
        with open(out_dir / "sweep.csv", newline="") as f:
            return {f"{r['split']} {r['model']}": float(r["accuracy"])
                    for r in csv.DictReader(f)}

    tree_path = DT_DEPTH + math.ceil(RF_TREES / TREE_BATCH) * RF_DEPTH
    path = drive_path("sweep_main", out_dir, drive, hist_rows=len(SWEEP_SPLITS) * tree_path,
                      artifacts=("sweep.csv", "sweep.txt"))
    acc = path["accuracies"]
    models = ("logistic_regression", "logistic_regression_cv", "decision_tree",
              "random_forest")
    if list(acc) != [f"{split} {m}" for split in SWEEP_SPLITS for m in models]:
        raise AssertionError(f"sweep rows {list(acc)}")
    for split in SWEEP_SPLITS:
        if acc[f"{split} decision_tree"] != SWEEP_DT_ACCURACY[split]:
            raise AssertionError(f"sweep {split} DT {acc[f'{split} decision_tree']} != "
                                 f"{SWEEP_DT_ACCURACY[split]}")
        for m in models[:2]:
            check_floor(f"sweep {split} {m}", acc[f"{split} {m}"], SWEEP_LR_MIN_ACCURACY)
        check_floor(f"sweep {split} random_forest", acc[f"{split} random_forest"],
                    RF_MIN_ACCURACY)
    return path


def phase_raw_lane_main() -> dict:
    """``parity --raw`` on a raw-format file of the published stream's size
    (written once): the lane's CNN1D at its defaults on the card, all
    5,418 windows, an accuracy floor below har_tpu's; no K1 or K2
    launch."""
    if not RAW_LANE_FILE.is_file():
        t0 = time.perf_counter()
        raw_loader.write_raw_fixture(str(RAW_LANE_FILE), n_windows=RAW_LANE_WINDOWS, seed=0)
        emit("raw_lane_file", windows=RAW_LANE_WINDOWS, lines=RAW_LANE_WINDOWS * 200,
             bytes=RAW_LANE_FILE.stat().st_size, seconds=time.perf_counter() - t0)
    lane = {}

    def drive():
        lane.update(run_cli_json(["parity", "--raw", "--data-path", str(RAW_LANE_FILE),
                                  "--device", "cuda"]))
        return {"cnn1d": lane["accuracy"]}

    path = drive_path("raw_lane_main", OUT, drive, artifacts=())
    emit("raw_lane_main_checks", lane=lane)
    if (lane["n_windows"], lane["n_used"]) != (RAW_LANE_WINDOWS, RAW_LANE_WINDOWS):
        raise AssertionError(f"raw lane windows {lane['n_windows']}, {lane['n_used']}")
    check_floor("raw lane", lane["accuracy"], RAW_LANE_MIN_ACCURACY)
    return dict(path, lane=lane)


def _profile_fit(label: str, fit) -> None:
    """One warm fit, one timed fit and one fit under torch.profiler:
    kernel time by name, the device's busy share, K1's row-sparse
    kernel's launches, device time and share of it, and K2's share."""
    from torch.profiler import ProfilerActivity, profile

    fit()  # warm: the kernels are loaded, caches are filled
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t0
    # device-side events only (kernels, copies, memsets): the aten ops
    # that launched them carry the same time again
    events = [
        e
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
        and not e.key.startswith("Activity Buffer")
    ]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_us = sum(e.self_device_time_total for e in events)

    def share(tag: str) -> float:
        return sum(e.self_device_time_total for e in events if tag in e.key) / max(
            device_us, 1e-9
        )

    rows = [e for e in events if "hist_rows_kernel" in e.key]
    rows_launches = sum(e.count for e in rows)

    emit(
        "profile",
        model=label,
        fit_s=fit_s,
        profiled_fit_s=profiled_s,
        device_s=device_us / 1e6,
        device_busy_share=device_us / 1e6 / profiled_s,
        hist_rows_share_of_device=share("hist_rows_kernel"),
        hist_rows_launches=rows_launches,
        hist_rows_device_ms=sum(e.self_device_time_total for e in rows) / 1e3,
        flash_share_of_device=share("flash_fwd_"),
        top=[
            dict(name=e.key[:80], device_ms=e.self_device_time_total / 1e3,
                 calls=e.count)
            for e in events[:8]
        ],
    )


def phase_profile() -> None:
    """A DT and an RF fit at full width, a 5-epoch fit of the CLI
    transformer on the raw path's training windows (30 steps), the default
    run, the parity run, a GBDT fit on the table's numeric view and a
    2-epoch BiLSTM fit (12 steps)."""
    config = RunConfig()
    train, _, _ = featurize(config, load_dataset(config))
    for est in (DecisionTreeClassifier(), RandomForestClassifier()):
        _profile_fit(type(est).__name__, lambda: est.fit(train))
    config = RunConfig(data=DataConfig(dataset="wisdm_raw"), model=ModelConfig(name="transformer"))
    train, _, _ = featurize(config, load_dataset(config))
    est = runner.build_estimator("transformer", {"epochs": 5}, "cuda")
    _profile_fit("Transformer1D (5 epochs)", lambda: est.fit(train))
    out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "default_profile"
    argv = ["train", "--device", "cuda", "--output-dir", str(out_dir)]
    _profile_fit("default train (lr dt rf, CV)", lambda: run_cli(argv))
    out_dir = ROOT / "har_tpu_torch" / "_build" / "chip_smoke" / "parity_profile"
    argv = ["parity", "--device", "cuda", "--output-dir", str(out_dir)]
    _profile_fit("parity (lr lr_cv dt rf)", lambda: run_cli(argv))
    config = RunConfig(model=ModelConfig(name="gbdt"))
    train, _, _ = featurize(config, load_dataset(config))
    _profile_fit("GradientBoostedTrees (numeric view)", lambda: GBDT.fit(train))
    config = RunConfig(data=DataConfig(dataset="wisdm_raw"), model=ModelConfig(name="bilstm"))
    train, _, _ = featurize(config, load_dataset(config))
    est = runner.build_estimator("bilstm", {"epochs": 2}, "cuda")
    _profile_fit("BiLSTM (2 epochs)", lambda: est.fit(train))


def kernel_entry(name: str, source: str, replaces: str, launches: int,
                 checked: dict, shape: str, library: str = "library_ms",
                 **extra) -> dict:
    """One kernel's entry of the kernels line: its main-path launches, its
    largest difference from the plain version and its times at ``shape``
    (``library`` names the timing of the one PyTorch call)."""
    t = checked["timings"][shape]
    return dict(
        name=name, route="cuda", source=f"har_tpu_torch/csrc/{source}",
        replaces=replaces, launches=launches, max_abs_err=checked["max_abs_err"],
        max_abs_diff=checked["max_abs_err"], ms=t["kernel_ms"],
        kernel_ms=t["kernel_ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=t[library], shape=shape,
        per_shape=checked["timings"], **extra,
    )


def main(argv: list[str]) -> int:
    native_before = native_hashes()
    shutil.rmtree(MODELS_DIR, ignore_errors=True)
    device = phase_device()
    phase_build()
    if "--flash-only" in argv:
        phase_flash()
        return 0
    hist = phase_hist()
    hist_rows = phase_hist_rows()
    flash = phase_flash()
    phase_agree()
    phase_transformer_agree()
    main_path = phase_main()
    raw_main = phase_raw_main()
    raw_packed = phase_raw_packed()
    lr_agree = phase_lr_agree()
    phase_cv_agree()
    default_main = phase_default_main(main_path["accuracies"]["random_forest"])
    parity_main = phase_parity_main(native_before)
    gbdt_hist = phase_gbdt_hist()
    gbdt_main = phase_gbdt_main()
    raw_features_main = phase_raw_features_main()
    neural_agree = phase_neural_agree()
    neural_main = phase_neural_main()
    trained = dict(default_main["accuracies"], gbdt=gbdt_main["accuracies"]["gbdt"],
                   transformer=raw_main["accuracies"]["transformer"],
                   cnn1d=neural_main["cnn1d_main"]["accuracy"])
    lifecycle = phase_lifecycle_main(trained)
    serving_main = phase_serving_main(trained)
    ucihar_root = ucihar_fixture()
    ucihar_main = phase_ucihar_main(ucihar_root)
    ucihar_gbt_main = phase_ucihar_gbt_main(ucihar_root)
    ucihar_lane = phase_ucihar_parity_lane(ucihar_root)
    sweep_main = phase_sweep_main()
    raw_lane_main = phase_raw_lane_main()
    if "--profile" in argv:
        phase_profile()
    flash_launches = {
        name: path["launches"]["flash_attention"]
        for name, path in (("raw_main", raw_main), ("raw_packed", raw_packed),
                           ("lifecycle_main", lifecycle["scoring"]),
                           ("serving_main", serving_main))
    }
    hist_rows_launches = {
        name: path["launches"]["hist_rows"]
        for name, path in (("main", main_path), ("default_main", default_main),
                           ("parity_main", parity_main), ("gbdt_main", gbdt_main),
                           ("gbdt_cv_main", gbdt_main["cv"]),
                           ("raw_features_main", raw_features_main),
                           ("lifecycle_main", lifecycle["scoring"]),
                           ("ucihar_main", ucihar_main), ("ucihar_gbt_main", ucihar_gbt_main),
                           ("ucihar_parity_lane", ucihar_lane), ("sweep_main", sweep_main),
                           ("raw_lane_main", raw_lane_main))
    }
    rows_checked = dict(
        max_abs_err=max(hist_rows["max_abs_err"], gbdt_hist["max_abs_err"]),
        timings={**hist_rows["timings"], **gbdt_hist["timings"]},
    )
    kernels = [
        kernel_entry(
            "hist_rows", "hist.cu", "har_tpu/ops/pallas_hist.py:56",
            sum(hist_rows_launches.values()), rows_checked, RF_HEADLINE,
            library="index_add_ms",
            onehot_matmul_ms=hist_rows["timings"][RF_HEADLINE]["library_ms"],
            graph_ms=hist_rows["timings"][RF_HEADLINE]["kernel_graph_ms"],
            launches_per_path=hist_rows_launches,
        ),
        kernel_entry(
            "hist", "hist.cu", "har_tpu/ops/pallas_hist.py:56",
            main_path["launches"]["hist"], hist, "rf_chunk",
        ),
        kernel_entry(
            "flash_attention", "flash_attention.cu", "har_tpu/ops/flash_attention.py:56",
            sum(flash_launches.values()), flash, "cli_train",
            graph_ms=flash["timings"]["cli_train"]["kernel_graph_ms"],
            launches_per_path=flash_launches,
        ),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    # the newest paths' numbers once more, short, where a log that keeps
    # only the end of the output still holds them
    emit("summary", nvidia_smi=nvidia_smi(),
         default_main={k: default_main[k] for k in ("launches", "accuracies", "seconds")},
         parity_main={k: parity_main[k] for k in ("launches", "accuracies", "seconds")},
         gbdt_main=dict(launches=gbdt_main["launches"], accuracies=gbdt_main["accuracies"],
                        seconds=gbdt_main["seconds"], cpu_seconds=gbdt_main["cpu_seconds"],
                        label_agreement=gbdt_main["label_agreement"],
                        cv_launches=gbdt_main["cv"]["launches"],
                        cv_seconds=gbdt_main["cv"]["seconds"]),
         raw_features_main={k: raw_features_main[k] for k in ("launches", "accuracies")},
         neural_agree=neural_agree, neural_main=neural_main,
         lifecycle_main=dict(
             seconds=lifecycle["seconds"],
             scoring={name: {k: r[k] for k in ("accuracy", "max_prob_diff")}
                      for name, r in lifecycle["scoring"]["models"].items()},
             scoring_launches=lifecycle["scoring"]["launches"],
             resume={k: lifecycle["resume"][k] for k in
                     ("exact", "max_loss_rel_diff", "max_param_diff")},
             early_stop={k: lifecycle["early_stop"][k] for k in
                         ("best_epoch", "stopped_epoch", "second_epochs_trained")},
             finetune={k: lifecycle["finetune"][k] for k in
                       ("accuracy_before", "accuracy_after", "frozen_equal")}),
         **{name: {k: path[k] for k in ("launches", "accuracies", "seconds")}
            for name, path in (("ucihar_main", ucihar_main),
                               ("ucihar_gbt_main", ucihar_gbt_main),
                               ("ucihar_parity_lane", ucihar_lane),
                               ("sweep_main", sweep_main), ("raw_lane_main", raw_lane_main))},
         serving_main=dict(
             seconds=serving_main["seconds"], launches=serving_main["launches"],
             stream={tag: {k: r[k] for k in ("n_events", "max_prob_diff", "latency")}
                     for tag, r in serving_main["stream"].items()},
             offline_max_prob_diff=serving_main["offline"]["max_prob_diff"],
             artifacts={tag: {k: r[k] for k in ("accuracy", "bytes")}
                        for tag, r in serving_main["artifacts"].items()
                        if isinstance(r, dict)},
             int8_artifact_ratio=serving_main["artifacts"]["int8_artifact_ratio"],
             stream_hop=flash["timings"]["stream_hop"],
             stream_burst=flash["timings"]["stream_burst"]),
         ucihar_split_candidates_s=ucihar_main["split_candidates_s"],
         ucihar_parity_lane_result=ucihar_lane["lane"], raw_lane_result=raw_lane_main["lane"])
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
