"""The port's walkthrough notebook must stay executable.

The port's counterpart of ``tests/test_notebook.py``: nbconvert isn't in
this image, so the end-to-end test executes the notebook the way a kernel
would (code cells exec'd in order in one namespace), on the CPU
(``HAR_TPU_TORCH_DEVICE=cpu``).  Like the JAX notebook's, it is marked
``slow``: its CrossValidator fits 45 logistic regressions.
"""

import json
import os

import pytest

NB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "notebooks",
    "walkthrough_torch.ipynb",
)


def _load():
    with open(NB_PATH) as f:
        return json.load(f)


def test_notebook_is_valid_nbformat4():
    nb = _load()
    assert nb["nbformat"] == 4
    kinds = {c["cell_type"] for c in nb["cells"]}
    assert kinds == {"markdown", "code"}
    for cell in nb["cells"]:
        assert isinstance(cell["source"], list)
        if cell["cell_type"] == "code":
            assert cell["outputs"] == []  # committed clean
            assert "har_tpu." not in "".join(cell["source"])  # the port only


@pytest.mark.slow
def test_notebook_executes_end_to_end(capsys, monkeypatch):
    monkeypatch.setenv("HAR_TPU_TORCH_DEVICE", "cpu")
    nb = _load()
    ns: dict = {}
    for i, cell in enumerate(nb["cells"]):
        if cell["cell_type"] != "code":
            continue
        src = "".join(cell["source"])
        try:
            exec(compile(src, f"{NB_PATH}:cell{i}", "exec"), ns)
        except Exception as e:  # pragma: no cover - failure reporting
            pytest.fail(f"cell {i} raised {type(e).__name__}: {e}\n{src}")
    out = capsys.readouterr().out
    assert "accuracy=" in out  # the model lanes actually ran
    assert "device=cpu" in out
