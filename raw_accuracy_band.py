"""Accuracy band of the JAX reference on the commands ``chip_smoke.py`` gates.

Runs ``har_tpu``'s own ``runner.run`` on the CPU for one command, at one
trainer seed, and prints one JSON line with each model's test accuracy.
``chip_smoke.py`` sets the port's accuracy floors below the band these runs
give over the seeds.

    JAX_PLATFORMS=cpu python raw_accuracy_band.py main 0 /tmp/band_main_0
    JAX_PLATFORMS=cpu python raw_accuracy_band.py packed 0 /tmp/band_packed_0
    JAX_PLATFORMS=cpu python raw_accuracy_band.py cnn1d 0 /tmp/band_cnn1d_0

The configurations (``COMMANDS``), each a ``har train ... --no-cv`` at the
CLI defaults unless it says otherwise:

- ``main``: ``--dataset wisdm_raw --models transformer``;
- ``packed``: the same at the bench lane's r6 widths (the same
  ``RAW_PACKED_PARAMS`` as ``chip_smoke.py``);
- ``gbt``: ``--models gbt`` (the 13-column numeric view of the table);
- ``mlp``: ``--models mlp`` (the same view);
- ``cnn1d``: ``--dataset wisdm_raw --models cnn1d``;
- ``cnn1d_augment``: the same with ``--augment raw_windows``;
- ``bilstm``: ``--dataset wisdm_raw --models bilstm``;
- ``raw_dt_gbt``: ``--dataset wisdm_raw --models dt gbt`` (the 43 features
  of the windows).

A ``main`` run takes about 40 minutes and a ``packed`` run about 20 on one
CPU host; ``bilstm`` about 40 on one core, ``gbt``, ``mlp`` and
``raw_dt_gbt`` under a minute.
"""

import json
import resource
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

from har_tpu.config import DataConfig, ModelConfig, RunConfig  # noqa: E402
from har_tpu.runner import run  # noqa: E402

PACKED_PARAMS = dict(embed_dim=256, num_heads=8, patch_size=8, window_pack=8,
                     scan_layers=True, batch_size=4096, learning_rate=1e-3,
                     epochs=25)
# name -> (dataset, models, extra params)
COMMANDS = {
    "main": ("wisdm_raw", ["transformer"], {}),
    "packed": ("wisdm_raw", ["transformer"], PACKED_PARAMS),
    "gbt": ("wisdm", ["gbt"], {}),
    "mlp": ("wisdm", ["mlp"], {}),
    "cnn1d": ("wisdm_raw", ["cnn1d"], {}),
    "cnn1d_augment": ("wisdm_raw", ["cnn1d"], {"augment": "raw_windows"}),
    "bilstm": ("wisdm_raw", ["bilstm"], {}),
    "raw_dt_gbt": ("wisdm_raw", ["dt", "gbt"], {}),
}


def main(argv):
    which, seed, output_dir = argv[0], int(argv[1]), argv[2]
    if which not in COMMANDS:
        raise SystemExit(f"unknown configuration {which!r}: {sorted(COMMANDS)}")
    dataset, models, extra = COMMANDS[which]
    params = {"seed": seed, **extra}
    cfg = RunConfig(data=DataConfig(dataset=dataset),
                    model=ModelConfig(name=models[0], params=params),
                    output_dir=output_dir)
    t0 = time.time()
    out = run(cfg, models=models, with_cv=False)
    accs = out.accuracies
    print(json.dumps({
        "which": which, "seed": seed,
        "acc": next(iter(accs.values())) if len(accs) == 1 else accs,
        "s": time.time() - t0,
        "maxrss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
    }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
