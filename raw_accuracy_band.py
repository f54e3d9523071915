"""Accuracy band of the JAX reference on the raw transformer commands.

Runs ``har_tpu``'s own ``runner.run`` on the CPU for ``wisdm_raw`` with the
transformer, at one trainer seed, and prints one JSON line with the test
accuracy. ``chip_smoke.py`` sets the port's accuracy floors below the band
these runs give over seeds 0-2.

    JAX_PLATFORMS=cpu python raw_accuracy_band.py main 0 /tmp/band_main_0
    JAX_PLATFORMS=cpu python raw_accuracy_band.py packed 0 /tmp/band_packed_0

``main`` is ``har train --dataset wisdm_raw --models transformer --no-cv`` at
the CLI defaults; ``packed`` sets the bench lane's r6 widths (the same
``RAW_PACKED_PARAMS`` as ``chip_smoke.py``). A ``main`` run takes about 40
minutes and a ``packed`` run about 20 on one CPU host.
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


def main(argv):
    which, seed, output_dir = argv[0], int(argv[1]), argv[2]
    params = {"seed": seed}
    if which == "packed":
        params.update(PACKED_PARAMS)
    elif which != "main":
        raise SystemExit(f"unknown configuration {which!r}: main or packed")
    cfg = RunConfig(data=DataConfig(dataset="wisdm_raw"),
                    model=ModelConfig(name="transformer", params=params),
                    output_dir=output_dir)
    t0 = time.time()
    out = run(cfg, models=["transformer"], with_cv=False)
    print(json.dumps({
        "which": which, "seed": seed,
        "acc": out.accuracies["transformer"],
        "s": time.time() - t0,
        "maxrss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
    }), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
