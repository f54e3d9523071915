"""`har` command-line interface of the PyTorch/CUDA port.

Mirrors ``har_tpu/cli.py``'s ``train`` for the ported families and its
``parity``:

  python -m har_tpu_torch.cli train                # lr dt rf, each with CV
  python -m har_tpu_torch.cli train --device cpu
  python -m har_tpu_torch.cli train --models dt rf --no-cv
  python -m har_tpu_torch.cli train --dataset wisdm_raw --models transformer --no-cv
  python -m har_tpu_torch.cli train --models gbt mlp
  python -m har_tpu_torch.cli train --dataset wisdm_raw --models cnn1d bilstm dt gbt
  python -m har_tpu_torch.cli train --dataset wisdm_raw --models cnn1d --augment raw_windows
  python -m har_tpu_torch.cli parity               # the bit-exact replays
  python -m har_tpu_torch.cli parity --blocks dt --device cpu

``train`` writes result.txt, additional_param.csv,
crossFold_additional_param.csv (with CV) and timing.csv into
``--output-dir``; ``parity`` writes the first three.  Both print the
accuracies and artifact paths as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys

from har_tpu_torch.config import DataConfig, ModelConfig, RunConfig, TuningConfig
from har_tpu_torch.parity import BLOCKS


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="har_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train + evaluate models, write report")
    t.add_argument("--dataset", default="wisdm",
                   choices=["wisdm", "wisdm_raw", "synthetic"],
                   help="wisdm_raw = raw tri-axial windows (the view the "
                        "cnn1d/bilstm/transformer models train on; the "
                        "others train on their 43 WISDM features)")
    t.add_argument("--data-path", default=None)
    t.add_argument("--models", nargs="+", default=["lr", "dt", "rf"],
                   help="lr dt rf gbt mlp cnn1d bilstm transformer")
    t.add_argument("--train-fraction", type=float, default=0.7)
    t.add_argument("--seed", type=int, default=2018)
    t.add_argument("--split-method", default="auto",
                   choices=["auto", "spark", "bernoulli"],
                   help="train/test draw: spark replays the reference's "
                        "randomSplit row-for-row (WISDM only); auto picks "
                        "it for the wisdm dataset")
    t.add_argument("--no-cv", action="store_true",
                   help="skip the 5-fold CrossValidator pass")
    t.add_argument("--cv-metric", default="accuracy",
                   help="model-selection metric; 'mae' replicates the "
                        "reference's evaluator quirk (SURVEY §2 N)")
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--learning-rate", type=float, default=None)
    t.add_argument("--augment", default=None, choices=["raw_windows", "none"],
                   help="augmentation inside the train step (raw (T,3) "
                        "window models): jitter, per-axis scale, 3-D "
                        "rotation, time masking")
    t.add_argument("--class-weight", default=None, choices=["balanced"],
                   help="reweigh the neural loss by inverse class "
                        "frequency (minority activities pull equally)")
    t.add_argument("--output-dir", default="main_result")
    t.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")

    pa = sub.add_parser(
        "parity",
        help="reproduce the reference's result.txt byte-for-byte "
             "(bit-exact MLlib replays: LR, LR-CV, DT, RF)",
    )
    pa.add_argument("--data-path", default=None)
    pa.add_argument("--output-dir", default="parity_result")
    pa.add_argument("--blocks", nargs="+", default=list(BLOCKS), choices=BLOCKS,
                    help="which reference blocks to run (default: all four)")
    pa.add_argument("--device", default="cuda",
                    help="where DT grows: cuda (default) or cpu")
    return p


def _parity(args) -> int:
    from har_tpu_torch.parity import parity_run

    config = None
    if args.data_path is not None:
        config = RunConfig(data=DataConfig(dataset="wisdm", path=args.data_path))
    out = parity_run(args.output_dir, config=config, blocks=tuple(args.blocks),
                     device=args.device)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.command == "parity":
        return _parity(args)
    from har_tpu_torch.runner import canonical_model_name, run

    models = [canonical_model_name(m) for m in args.models]
    neural_params = {
        k: getattr(args, k)
        for k in ("epochs", "batch_size", "learning_rate", "class_weight",
                  "augment")
        if getattr(args, k) is not None
    }
    config = RunConfig(
        data=DataConfig(
            dataset=args.dataset,
            path=args.data_path,
            train_fraction=args.train_fraction,
            seed=args.seed,
            split_method=args.split_method,
        ),
        model=ModelConfig(name=models[0], params=neural_params),
        tuning=TuningConfig(selection_metric=args.cv_metric),
        output_dir=args.output_dir,
    )
    outcome = run(config, models=models, with_cv=not args.no_cv, device=args.device)
    print(json.dumps({"accuracies": outcome.accuracies,
                      "artifacts": outcome.report_paths}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
