"""Accuracy band of the JAX reference on the commands ``chip_smoke.py`` gates.

Runs ``har_tpu``'s own ``runner.run`` (or lane) on the CPU for one command,
at one seed, and prints one JSON line with each model's test accuracy.
``chip_smoke.py`` sets the port's accuracy floors below the band these runs
give over the seeds, and pins the numbers the port must equal.

    JAX_PLATFORMS=cpu python raw_accuracy_band.py main 0 /tmp/band_main_0
    JAX_PLATFORMS=cpu python raw_accuracy_band.py packed 0 /tmp/band_packed_0
    JAX_PLATFORMS=cpu python raw_accuracy_band.py cnn1d 0 /tmp/band_cnn1d_0
    JAX_PLATFORMS=cpu python raw_accuracy_band.py ucihar_rf 1 /tmp/band_rf_1
    JAX_PLATFORMS=cpu python raw_accuracy_band.py ucihar_rf 1 /tmp/band_rf_1 port

A fifth argument ``port`` runs the same command through ``har_tpu_torch``
on the CPU instead (``runner.run`` and the lanes with ``device="cpu"``).

The configurations (``COMMANDS``), each a ``har train ... --no-cv`` at the
CLI defaults unless it says otherwise; the seed goes to every model that
has one (RF, GBDT, the neural trainers):

- ``main``: ``--dataset wisdm_raw --models transformer``;
- ``packed``: the same at the bench lane's r6 widths (the same
  ``RAW_PACKED_PARAMS`` as ``chip_smoke.py``);
- ``gbt``: ``--models gbt`` (the 13-column numeric view of the table);
- ``mlp``: ``--models mlp`` (the same view);
- ``cnn1d``: ``--dataset wisdm_raw --models cnn1d``;
- ``cnn1d_augment``: the same with ``--augment raw_windows``;
- ``bilstm``: ``--dataset wisdm_raw --models bilstm``;
- ``raw_dt_gbt``: ``--dataset wisdm_raw --models dt gbt`` (the 43 features
  of the windows);
- ``ucihar``: ``--dataset ucihar --data-path <fixture>`` with CV (LR, DT,
  RF and their CrossValidators) on the published-size fixture tree
  (``write_ucihar_fixture(root, 7352, 2947, seed=0)``, 561 features);
- ``ucihar_rf``: the same tree, ``--models rf`` (the RF band);
- ``ucihar_gbt_mlp``: the same tree, ``--models gbt mlp``;

and three that are not ``train`` runs (``LANES``):

- ``ucihar_parity``: ``parity.ucihar_parity_lane`` on the same tree;
- ``sweep``: ``sweep`` at its defaults (LR, DT, RF at 70/80/90 % train,
  LR's CV) on the 5,418-row synthetic table (``--dataset wisdm`` without
  the CSV, so the Spark split);
- ``raw_lane``: ``parity.wisdm_raw_lane`` at its defaults on a
  WISDM-format file of ``synthetic_raw_stream(5418, seed=0)`` (1,083,600
  lines, ``raw_loader.write_raw_fixture``); the seed is the lane's.

The UCI-HAR tree is ``$HAR_TPU_UCIHAR_ROOT`` where it is set, else written
under the output directory; the raw file likewise ``$HAR_TPU_WISDM_RAW``.

A ``main`` run takes about 40 minutes and a ``packed`` run about 20 on one
CPU host; ``bilstm`` about 40 on one core, ``gbt``, ``mlp`` and
``raw_dt_gbt`` under a minute.
"""

import json
import os
import resource
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

from har_tpu.config import DataConfig, ModelConfig, RunConfig  # noqa: E402

PACKED_PARAMS = dict(embed_dim=256, num_heads=8, patch_size=8, window_pack=8,
                     scan_layers=True, batch_size=4096, learning_rate=1e-3,
                     epochs=25)
# name -> (dataset, models, extra params, with CV)
COMMANDS = {
    "main": ("wisdm_raw", ["transformer"], {}, False),
    "packed": ("wisdm_raw", ["transformer"], PACKED_PARAMS, False),
    "gbt": ("wisdm", ["gbt"], {}, False),
    "mlp": ("wisdm", ["mlp"], {}, False),
    "cnn1d": ("wisdm_raw", ["cnn1d"], {}, False),
    "cnn1d_augment": ("wisdm_raw", ["cnn1d"], {"augment": "raw_windows"}, False),
    "bilstm": ("wisdm_raw", ["bilstm"], {}, False),
    "raw_dt_gbt": ("wisdm_raw", ["dt", "gbt"], {}, False),
    "ucihar": ("ucihar", ["lr", "dt", "rf"], {}, True),
    "ucihar_rf": ("ucihar", ["rf"], {}, False),
    "ucihar_gbt_mlp": ("ucihar", ["gbt", "mlp"], {}, False),
}
LANES = ("ucihar_parity", "sweep", "raw_lane")
# the published UCI HAR Dataset's train and test rows
UCIHAR_TRAIN, UCIHAR_TEST = 7352, 2947
RAW_WINDOWS = 5418


def ucihar_root(output_dir: str) -> str:
    root = os.environ.get("HAR_TPU_UCIHAR_ROOT")
    if root:
        return root
    from har_tpu.data.ucihar import write_ucihar_fixture

    return write_ucihar_fixture(os.path.join(output_dir, "fixture"),
                                n_train=UCIHAR_TRAIN, n_test=UCIHAR_TEST, seed=0)


def raw_file(output_dir: str) -> str:
    path = os.environ.get("HAR_TPU_WISDM_RAW")
    if path:
        return path
    from har_tpu_torch.data.raw_loader import write_raw_fixture

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "WISDM_ar_v1.1_raw.txt")
    write_raw_fixture(path, n_windows=RAW_WINDOWS, seed=0)
    return path


def run_lane(which: str, seed: int, output_dir: str, port: bool):
    if port:
        from har_tpu_torch import parity, runner
        from har_tpu_torch.config import DataConfig as Data, RunConfig as Run
        device = {"device": "cpu"}
    else:
        from har_tpu import parity, runner
        Data, Run, device = DataConfig, RunConfig, {}
    if which == "ucihar_parity":
        return parity.ucihar_parity_lane(ucihar_root(output_dir), **device)
    if which == "raw_lane":
        return parity.wisdm_raw_lane(raw_file(output_dir), **device)
    # the wisdm dataset without its CSV: the synthetic table, Spark split
    rows = runner.sweep(Run(data=Data(dataset="wisdm"), output_dir=output_dir), **device)
    return {f"{r['split']} {r['model']}": r for r in rows}


def main(argv):
    which, seed, output_dir = argv[0], int(argv[1]), argv[2]
    port = argv[3:] == ["port"]
    t0 = time.time()
    if which in LANES:
        out = run_lane(which, seed, output_dir, port)
        acc = out
    elif which in COMMANDS:
        dataset, models, extra, with_cv = COMMANDS[which]
        path = ucihar_root(output_dir) if dataset == "ucihar" else None
        params = {"seed": seed, **extra}
        if port:
            from har_tpu_torch import config as port_config
            from har_tpu_torch.runner import run
            cfg = port_config.RunConfig(
                data=port_config.DataConfig(dataset=dataset, path=path),
                model=port_config.ModelConfig(name=models[0], params=params),
                output_dir=output_dir)
            out = run(cfg, models=models, with_cv=with_cv, device="cpu")
        else:
            from har_tpu.runner import run
            cfg = RunConfig(data=DataConfig(dataset=dataset, path=path),
                            model=ModelConfig(name=models[0], params=params),
                            output_dir=output_dir)
            out = run(cfg, models=models, with_cv=with_cv)
        accs = out.accuracies
        acc = next(iter(accs.values())) if len(accs) == 1 else accs
    else:
        raise SystemExit(f"unknown configuration {which!r}: "
                         f"{sorted(COMMANDS) + list(LANES)}")
    print(json.dumps({
        "which": which, "seed": seed, "package": "har_tpu_torch" if port else "har_tpu",
        "acc": acc, "s": time.time() - t0,
        "maxrss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
    }, default=str), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
