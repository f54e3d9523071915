"""The port stands alone: no file of har_tpu_torch/ and not chip_smoke.py
imports JAX, its libraries or the JAX package, so a CUDA machine without
JAX runs it."""

import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "har_tpu")
# the package's sources; _build/ holds generated files, not sources
FILES = sorted(
    p
    for p in (ROOT / "har_tpu_torch").rglob("*.py")
    if "_build" not in p.relative_to(ROOT).parts
) + [ROOT / "chip_smoke.py"]


def _imported_roots(source: str) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_has_files():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for required in (
        "chip_smoke.py",
        "har_tpu_torch/ops/hist.py",
        "har_tpu_torch/ops/flash_attention.py",
        "har_tpu_torch/models/tree.py",
        "har_tpu_torch/models/transformer.py",
        "har_tpu_torch/train/trainer.py",
        "har_tpu_torch/runner.py",
        "har_tpu_torch/parity.py",
        "har_tpu_torch/models/mllib_exact.py",
        "har_tpu_torch/data/_native_build.py",
        "har_tpu_torch/models/gbdt.py",
        "har_tpu_torch/models/ensemble.py",
        "har_tpu_torch/models/neural.py",
        "har_tpu_torch/features/raw_features.py",
        "har_tpu_torch/data/augment.py",
        "har_tpu_torch/checkpoint.py",
        "har_tpu_torch/transfer.py",
        "har_tpu_torch/data/ucihar.py",
        "har_tpu_torch/reporting/eda.py",
        "har_tpu_torch/serving.py",
        "har_tpu_torch/monitoring.py",
        "har_tpu_torch/quantize.py",
        "har_tpu_torch/export.py",
        "har_tpu_torch/ops/calibration.py",
    ):
        assert required in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_har_tpu_import(path):
    bad = _imported_roots(path.read_text()) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_sees_forbidden_imports():
    src = "import jax.numpy\nfrom har_tpu.models import tree\nimport har_tpu_torch\n"
    assert _imported_roots(src) & set(FORBIDDEN) == {"jax", "har_tpu"}
