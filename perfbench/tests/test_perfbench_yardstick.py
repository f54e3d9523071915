"""The benchmark's yardstick at tiny sizes: the open-loop schedule, the
closed-form FLOPs, K2's bound, the whole-name import check, and the plain
reference against the port (this test may import both; the reference
imports nothing of the port)."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from drivers import fleet
from harness import inputs, yardstick
from harness.result import forbidden_modules
from reference import precision, train_check, transformer1d

BENCH = Path(__file__).resolve().parents[1]
CLI = json.loads((BENCH / "configs" / "cli_tfm.json").read_text())
TINY = dict(CLI, hidden_size=16, num_attention_heads=2, intermediate_size=64,
            num_hidden_layers=1, window=12)


def test_open_loop_schedule_repeats_by_seed_and_offers_its_rate():
    a = fleet.poisson_schedule(2**33 + 5, 64, 20.0, 10.0)
    b = fleet.poisson_schedule(2**33 + 5, 64, 20.0, 10.0)
    c = fleet.poisson_schedule(2**33 + 6, 64, 20.0, 10.0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0][:50], c[0][:50])
    times, sessions, index, due = a
    assert np.all(np.diff(times) >= 0) and times[-1] < 10.0
    # 64 sessions × 20 chunks/s × 10 s: the count is Poisson(12,800)
    assert abs(len(times) - 12_800) < 5 * np.sqrt(12_800)
    # each session's chunks in order, indexed 0, 1, 2, ...
    for s in range(64):
        mine = index[sessions == s]
        np.testing.assert_array_equal(np.sort(mine), np.arange(len(mine)))


def test_arrival_ranks_split_a_round_into_distinct_sessions():
    ranks = fleet.arrival_ranks(np.array([3, 1, 3, 3, 2, 1]))
    np.testing.assert_array_equal(ranks, [0, 0, 1, 2, 0, 1])


def test_closed_form_flops_match_a_hand_count():
    # E 16, H 2, L 1, I 64, T 12, C 3, K 6, by hand, multiply-adds:
    # embed 12·3·16 = 576; qkv 12·16·48 = 9,216; proj 12·16·16 = 3,072;
    # MLP 2·12·16·64 = 24,576; head 16·6 = 96; attention 2·12²·16 = 4,608
    macs = 576 + 9_216 + 3_072 + 24_576 + 96 + 4_608
    assert transformer1d.flops_per_window(TINY, train=False) == 2 * macs
    assert transformer1d.flops_per_window(TINY, train=True) == 6 * macs


def test_flash_bound_reproduces_the_kernel_table():
    # PERF.md's K2 row: 0.0196 ms at cli_train (512, 200, 4, 16), bf16,
    # bound by the exponentials
    ms = yardstick.flash_bound_s(512, 200, 4, 16, 2) * 1e3
    assert round(ms, 4) == 0.0196


def test_peak_is_the_data_sheet_s():
    assert yardstick.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert yardstick.peak_bf16_flops("cpu") is None


def test_import_check_compares_whole_top_level_names():
    loaded = {"har_tpu_torch": 1, "har_tpu_torch.ops": 1, "jaxtyping": 1, "numpy": 1,
              "flax_like": 1, "har_tpu.models": 1, "jax": 1, "jaxlib.xla": 1}
    assert forbidden_modules(loaded) == ["har_tpu.models", "jax", "jaxlib.xla"]


def test_reference_imports_nothing_of_the_program_or_jax():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "har_tpu",
                                                  "har_tpu_torch"), (path, name)


def _port_module(cfg, weights, dtype):
    from drivers.train_fits import build_module

    module = build_module(dict(cfg, program={"model": "transformer", "kwargs": {
        "embed_dim": cfg["hidden_size"], "num_heads": cfg["num_attention_heads"],
        "num_layers": cfg["num_hidden_layers"], "dropout_rate": 0.0, "dtype": dtype}}),
        transformer1d)
    module.load_state_dict(weights)
    return module.eval()


def test_reference_agrees_with_the_port_in_float32():
    cpu = torch.device("cpu")
    weights = inputs.initial_weights(transformer1d.state_shapes(TINY), 11, cpu)
    x, _ = inputs.raw_windows(11, 8, TINY["window"], 3, 6, cpu)
    port = _port_module(TINY, weights, "float32")
    with torch.no_grad():
        want = transformer1d.forward(weights, x, TINY)
        got = port(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_reference_weights_follow_the_state_dict_of_the_port():
    from har_tpu_torch.models.neural import build_model

    for cfg in (CLI, json.loads((BENCH / "configs" / "wide_tfm.json").read_text())):
        with torch.device("meta"):
            module = build_model(cfg["program"]["model"], num_classes=cfg["num_classes"],
                                 in_features=cfg["channels"], **cfg["program"]["kwargs"])
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} \
            == transformer1d.state_shapes(cfg)
        assert list(module.state_dict()) == list(transformer1d.state_shapes(cfg))


def test_fp8_control_reads_far_from_the_reference():
    """The control at a test's size: the reference in fp8 in the
    program's place reads several times the program's bf16 gap."""
    cpu = torch.device("cpu")
    cfg = dict(TINY, window=20)
    traffic = {"batch_size": 32, "epochs": 1, "learning_rate": 3e-3, "weight_decay": 1e-4,
               "warmup_fraction": 0.1}
    x, y = inputs.raw_windows(5, 128, 20, 3, 6, cpu)
    weights = inputs.initial_weights(transformer1d.state_shapes(cfg), 5, cpu)
    want = train_check.follow(transformer1d, cfg, traffic, x, y, weights, 9,
                              precision.matmul_f32)
    control = train_check.follow(transformer1d, cfg, traffic, x, y, weights, 9,
                                 precision.matmul_fp8)
    control["start"] = weights
    numbers = train_check.readings(control, want, weights)
    assert numbers["grad_gap"] > 5e-3 and numbers["loss_gap"] > 5e-4


def test_round_fp8_is_e4m3_under_a_per_tensor_scale():
    x = torch.tensor([1.0, 0.5, -448.0, 3.3])
    r = precision.round_fp8(x)
    assert r[2] == -448.0 and r[0] == 1.0
    assert abs(float(r[3]) - 3.3) <= 3.3 / 16


@pytest.mark.parametrize("t_index", [[20, 40, 60], [40, 60]])
def test_windows_at_reads_the_stream_cyclically(t_index):
    from reference import fleet_check

    pool = torch.arange(4 * 20 * 3, dtype=torch.float32).reshape(4, 20, 3)
    got = fleet_check.windows_at(pool, 3, np.asarray(t_index), 20)
    for row, t in zip(got, t_index):
        k = t // 20 - 1
        torch.testing.assert_close(row, pool[(3 + k) % 4])
