"""The port's host C++ libraries: build, provenance and the parsers.

The port builds rawloader and mllibmath from its own copies of the
sources (``har_tpu_torch/csrc/*.cpp``, equal to ``native/*.cpp``) into
``har_tpu_torch/_build/native/`` with `har_tpu`'s g++ flags, and leaves
the JAX package's libraries in ``native/`` untouched.  Its CSV reader
(Python only) and its raw-stream parser return what `har_tpu`'s do.
"""

import ctypes
import hashlib
import pathlib

import numpy as np
import pytest
import torch

import har_tpu.runner as jax_runner
from har_tpu.config import DataConfig as JaxDataConfig
from har_tpu.config import RunConfig as JaxRunConfig
from har_tpu.data import csv_loader as jax_csv
from har_tpu.data import raw_loader as jax_raw
from har_tpu.data.synthetic import synthetic_wisdm
from har_tpu_torch import runner as port_runner
from har_tpu_torch.config import DataConfig, RunConfig
from har_tpu_torch.data import _native_build
from har_tpu_torch.data import csv_loader as port_csv
from har_tpu_torch.data import raw_loader
from har_tpu_torch.models import _jvm_native

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
LIBRARIES = {
    "rawloader.cpp": raw_loader.NATIVE,
    "mllibmath.cpp": _jvm_native.NATIVE,
}
JAX_FLAGS = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def _sha256(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.mark.parametrize("source", sorted(LIBRARIES))
def test_port_sources_equal_jax_sources(source):
    assert (ROOT / "har_tpu_torch" / "csrc" / source).read_bytes() == (
        ROOT / "native" / source
    ).read_bytes()


def test_libraries_build_under_port_cache_with_jax_flags():
    """Every library lands under _build/native with har_tpu's flags
    (mllibmath with -ffp-contract=off), and the committed native/*.so are
    byte-identical before and after."""
    committed = [ROOT / "native" / n for n in ("libharjvm.so", "libharraw.so")]
    before = [_sha256(p) for p in committed]
    build_dir = ROOT / "har_tpu_torch" / "_build" / "native"
    assert _native_build.BUILD_DIR == build_dir
    for source, lib in LIBRARIES.items():
        lib.load()
        assert lib.path.parent == build_dir and lib.path.is_file()
        extra = ["-ffp-contract=off"] if source == "mllibmath.cpp" else []
        assert lib.command == [*JAX_FLAGS, *extra, str(ROOT / "har_tpu_torch" / "csrc" / source)]
    assert sorted(p.name for p in build_dir.glob("*.so")) == [
        "libharjvm.so", "libharraw.so"
    ]
    assert [_sha256(p) for p in committed] == before


def test_failed_build_raises_with_gcc_message(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int f() { return undeclared_name; }\n')
    lib = _native_build.NativeLib(src, tmp_path / "libbroken.so", lambda lib: None)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        lib.load()
    assert not (tmp_path / "libbroken.so").exists()


def test_stale_library_is_rebuilt(tmp_path):
    """A library built from an earlier source is rebuilt from the present
    one: the embedded source hash decides, not the file's age."""
    src = tmp_path / "answer.cpp"
    so = tmp_path / "libanswer.so"

    def configure(lib):
        lib.answer.restype = ctypes.c_int

    src.write_text('extern "C" int answer() { return 1; }\n')
    first = _native_build.NativeLib(src, so, configure)
    first._build()  # built, not loaded: a loaded path would shadow its rebuild
    assert so.is_file() and first.build_seconds is not None
    src.write_text('extern "C" int answer() { return 2; }\n')
    second = _native_build.NativeLib(src, so, configure)
    assert second.load().answer() == 2 and second.build_seconds is not None
    third = _native_build.NativeLib(src, so, configure)
    assert third.load().answer() == 2 and third.build_seconds is None  # current


def _assert_tables_equal(a, b):
    assert a.schema.names == b.schema.names
    assert [t.value for t in a.schema.types] == [t.value for t in b.schema.types]
    for name in a.schema.names:
        x, y = a[name], b[name]
        assert x.dtype == y.dtype, name
        if x.dtype == object:
            assert x.tolist() == y.tolist(), name
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


def _write_synthetic_csv(path, rows=300):
    table = synthetic_wisdm(n_rows=rows, seed=5)
    names = list(table.schema.names)
    lines = [",".join(names)]
    for i in range(rows):
        lines.append(",".join(
            repr(float(table[n][i])) if table[n].dtype.kind == "f" else str(table[n][i])
            for n in names
        ))
    path.write_text("\n".join(lines) + "\n")


def test_csv_engines_equal(tmp_path):
    """The port's CSV reader equals both of har_tpu's engines, native and
    Python: column order, types and values."""
    path = tmp_path / "wisdm.csv"
    _write_synthetic_csv(path)
    port = port_csv.read_csv(str(path))
    _assert_tables_equal(port, jax_csv.read_csv(str(path), engine="native"))
    _assert_tables_equal(port, jax_csv.read_csv(str(path), engine="python"))
    assert {t.value for t in port.schema.types} == {"int", "double", "string"}


@pytest.mark.parametrize("header", [True, False], ids=["header", "no_header"])
@pytest.mark.parametrize("infer", [True, False], ids=["infer", "strings"])
def test_csv_reader_options_equal_jax(tmp_path, header, infer):
    """Quoted fields with commas, negative and exponent numbers, and
    each header/inference option read as har_tpu's Python engine reads
    them."""
    path = tmp_path / "q.csv"
    path.write_text(
        'user,activity,x,note\n'
        '33,Jogging,-1.5e-3,"a, b"\n'
        '17,"Walking",2,plain\n'
        '5,Sitting,0.25,""\n'
    )
    got = port_csv.read_csv(str(path), header=header, infer=infer)
    want = jax_csv.read_csv(str(path), header=header, infer=infer, engine="python")
    _assert_tables_equal(got, want)


def _write_raw(path, n_per_bout=450, seed=0):
    """A raw stream in the WISDM v1.1 text format, with its quirks: blank
    and malformed records, two records on one line, padded fields."""
    rng = np.random.default_rng(seed)
    lines = []
    ts = 49105962326000
    for uid, act in ((33, "Jogging"), (33, "Walking"), (17, "Walking"), (17, "Sitting")):
        for _ in range(n_per_bout):
            x, y, z = rng.normal(0, 5, 3)
            lines.append(f"{uid},{act},{ts},{x:.2f},{y:.2f},{z:.2f};")
            ts += 50_000_000
    text = "\n".join(lines[:10]) + "\n" + lines[10] + lines[11] + "\n;;\n"
    text += "33,Jogging,,0.1,0.2;\n33,Jogging,12,a,b,c;\n"
    text += "\n".join(lines[12:]) + "\n17,Sitting, 12 ,1e-42, 0.5 ,-3;\n"
    path.write_text(text)


def _assert_streams_equal(a, b):
    assert a.activity_names == b.activity_names and a.skipped == b.skipped
    for field in ("user", "activity", "timestamp", "xyz"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)


def test_raw_loader_equals_jax(tmp_path):
    path = tmp_path / "raw.txt"
    _write_raw(path, n_per_bout=700, seed=3)
    native = raw_loader.load_raw_stream(str(path))
    assert native.skipped == 2 and len(native) == 4 * 700 + 1
    _assert_streams_equal(native, jax_raw.load_raw_stream(str(path), engine="native"))
    _assert_streams_equal(native, raw_loader.read_raw_python(str(path)))
    _assert_streams_equal(native, jax_raw.read_raw_python(str(path)))
    got, want = raw_loader.stream_windows(native), jax_raw.stream_windows(native)
    np.testing.assert_array_equal(got.windows, want.windows)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.class_names == want.class_names


def test_raw_loader_empty_stream_equals_jax(tmp_path):
    """A stream with no valid record: nothing parsed, every record
    counted as skipped, and no windows."""
    path = tmp_path / "raw.txt"
    path.write_text(";\n33,Jogging,1,2;\n\n")
    got = raw_loader.load_raw_stream(str(path))
    assert len(got) == 0 and got.skipped == 1
    _assert_streams_equal(got, jax_raw.load_raw_stream(str(path), engine="native"))
    windows = raw_loader.stream_windows(got)
    assert windows.windows.shape == (0, 200, 3) and windows.labels.shape == (0,)


def test_runner_reads_raw_stream(tmp_path):
    """``--dataset wisdm_raw --data-path``: the same windows and canonical
    WISDM labels as har_tpu's runner."""
    path = tmp_path / "raw.txt"
    _write_raw(path, n_per_bout=650, seed=4)
    got = port_runner.load_dataset(RunConfig(data=DataConfig(dataset="wisdm_raw", path=str(path))))
    want = jax_runner.load_dataset(
        JaxRunConfig(data=JaxDataConfig(dataset="wisdm_raw", path=str(path)))
    )
    np.testing.assert_array_equal(got.windows, want.windows)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.class_names == tuple(want.class_names)
    assert len(got) == 4 * 3  # three 200-sample windows a bout
