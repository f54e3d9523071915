"""`har` command-line interface of the PyTorch/CUDA port.

Mirrors ``har_tpu/cli.py``'s ``train`` for the ported families, its
``parity``, ``evaluate``, ``predict`` and ``finetune`` (the exported
``--artifact`` waits for the port of ``export``):

  python -m har_tpu_torch.cli train                # lr dt rf, each with CV
  python -m har_tpu_torch.cli train --device cpu
  python -m har_tpu_torch.cli train --models dt rf --no-cv
  python -m har_tpu_torch.cli train --dataset wisdm_raw --models transformer --no-cv
  python -m har_tpu_torch.cli train --models gbt mlp
  python -m har_tpu_torch.cli train --dataset wisdm_raw --models cnn1d bilstm dt gbt
  python -m har_tpu_torch.cli train --dataset wisdm_raw --models cnn1d --augment raw_windows
  python -m har_tpu_torch.cli parity               # the bit-exact replays
  python -m har_tpu_torch.cli parity --blocks dt --device cpu

  python -m har_tpu_torch.cli train --models lr dt --save-models-dir models
  python -m har_tpu_torch.cli evaluate --checkpoint models/decision_tree
  python -m har_tpu_torch.cli predict --checkpoint models/decision_tree --output p.csv
  python -m har_tpu_torch.cli train --models mlp --no-cv --checkpoint-dir ckpt \
      --save-every-epochs 5 --early-stop-patience 3
  python -m har_tpu_torch.cli finetune --checkpoint models/cnn1d --freeze ConvBlock_0

``train`` writes result.txt, additional_param.csv,
crossFold_additional_param.csv (with CV) and timing.csv into
``--output-dir``; ``parity`` writes the first three.  Both print the
accuracies and artifact paths as JSON; ``evaluate``, ``predict`` and
``finetune`` print their results as JSON.
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
    t.add_argument("--checkpoint-dir", default=None,
                   help="snapshot neural training here and resume from the "
                        "newest snapshot")
    t.add_argument("--save-models-dir", default=None,
                   help="persist every fitted model (plain and CV-best) "
                        "under this directory; classical artifacts bundle "
                        "the fitted pipeline's vocabularies")
    t.add_argument("--save-every-epochs", type=int, default=None)
    t.add_argument("--early-stop-patience", type=int, default=None,
                   help="stop neural training after N epochs without "
                        "val-accuracy improvement, keep the best epoch")
    t.add_argument("--validation-fraction", type=float, default=None,
                   help="rows carved out of training for early stopping")
    t.add_argument("--keep-binned", action="store_true",
                   help="keep the 30 histogram-bin columns X0..Z9 the "
                        "reference drops (gbt's widest view)")
    t.add_argument("--output-dir", default="main_result")
    t.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")

    for command, help_text in (
        ("evaluate", "score a saved checkpoint on its held-out rows"),
        ("predict", "batch inference from a saved checkpoint → predictions CSV"),
    ):
        c = sub.add_parser(command, help=help_text)
        c.add_argument("--checkpoint", required=True)
        if command == "predict":
            c.add_argument("--output", default="predictions.csv")
        _scoring_arguments(c)

    ft = sub.add_parser(
        "finetune",
        help="adapt a saved neural checkpoint to new data (warm start, "
             "the checkpoint's own scaler, optional layer freezing); "
             "reports held-out accuracy before/after",
    )
    ft.add_argument("--checkpoint", required=True)
    _scoring_arguments(ft)
    ft.add_argument("--epochs", type=int, default=20)
    ft.add_argument("--learning-rate", type=float, default=3e-4)
    ft.add_argument("--batch-size", type=int, default=256)
    ft.add_argument("--freeze", nargs="+", default=None,
                    help="top-level flax param modules to freeze "
                         "(e.g. ConvBlock_0 ConvBlock_1)")
    ft.add_argument("--output", default=None,
                    help="save the fine-tuned model as a new checkpoint")

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


def _scoring_arguments(c) -> None:
    """The data a saved model is scored on: the recorded dataset, seed and
    train fraction unless given."""
    c.add_argument("--dataset", default=None,
                   choices=["wisdm", "wisdm_raw", "synthetic"],
                   help="defaults to the dataset recorded in the checkpoint")
    c.add_argument("--data-path", default=None)
    c.add_argument("--train-fraction", type=float, default=None,
                   help="defaults to the training run's recorded value")
    c.add_argument("--seed", type=int, default=None,
                   help="split seed; defaults to the training run's "
                        "recorded value")
    c.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _evaluate_or_predict(args) -> int:
    from har_tpu_torch import checkpoint

    scoring = dict(dataset=args.dataset, train_fraction=args.train_fraction,
                   seed=args.seed, device=args.device)
    if args.command == "predict":
        out = checkpoint.predict_checkpoint(args.checkpoint, args.output,
                                            args.data_path, **scoring)
    else:
        out = checkpoint.evaluate_checkpoint(args.checkpoint, args.data_path,
                                             **scoring)
    print(json.dumps(out))
    return 0


def _finetune(args) -> int:
    from har_tpu_torch.checkpoint import (
        load_model,
        load_model_meta,
        save_model,
        scoring_config_from_meta,
    )
    from har_tpu_torch.ops.metrics import evaluate
    from har_tpu_torch.runner import featurize, load_dataset
    from har_tpu_torch.train.trainer import TrainerConfig
    from har_tpu_torch.transfer import fine_tune

    meta = load_model_meta(args.checkpoint)
    if meta.get("format") == "classical":
        raise SystemExit(
            "finetune covers the neural families; classical models "
            "retrain in seconds — use `har train`"
        )
    # the recorded split and the same contradiction guards as evaluate
    config = scoring_config_from_meta(
        meta, args.data_path, args.dataset, args.train_fraction, args.seed,
    )
    train, test, _ = featurize(config, load_dataset(config), args.device)
    model = load_model(args.checkpoint, args.device)
    before = evaluate(test.label, model.transform(test.features).raw,
                      model.num_classes)["accuracy"]
    tuned = fine_tune(
        args.checkpoint,
        train,
        TrainerConfig(batch_size=args.batch_size, epochs=args.epochs,
                      learning_rate=args.learning_rate, seed=config.data.seed),
        freeze=tuple(args.freeze or ()),
        model=model,
        device=args.device,
    )
    after = evaluate(test.label, tuned.transform(test.features).raw,
                     tuned.num_classes)["accuracy"]
    saved = None
    if args.output:
        saved = save_model(
            args.output, tuned, meta["model_name"], meta.get("model_kwargs"),
            dataset=config.data.dataset,
            synthetic_rows=meta.get("synthetic_rows"),
            drop_binned=meta.get("drop_binned"),
            split_method=meta.get("split_method"),
            input_shape=tuple(meta["input_shape"]) if meta.get("input_shape") else None,
            split_seed=config.data.seed,
            train_fraction=config.data.train_fraction,
        )
    print(json.dumps({
        "accuracy_before": round(float(before), 4),
        "accuracy_after": round(float(after), 4),
        "frozen": list(args.freeze or []),
        "checkpoint": saved,
    }))
    return 0


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
    if args.command in ("evaluate", "predict"):
        return _evaluate_or_predict(args)
    if args.command == "finetune":
        return _finetune(args)
    if args.validation_fraction is not None and not args.early_stop_patience:
        raise SystemExit(
            "--validation-fraction only takes effect with "
            "--early-stop-patience; set both or neither"
        )
    from har_tpu_torch.runner import canonical_model_name, run

    models = [canonical_model_name(m) for m in args.models]
    neural_params = {
        k: getattr(args, k)
        for k in ("epochs", "batch_size", "learning_rate", "checkpoint_dir",
                  "save_every_epochs", "early_stop_patience",
                  "validation_fraction", "class_weight", "augment")
        if getattr(args, k) is not None
    }
    config = RunConfig(
        data=DataConfig(
            dataset=args.dataset,
            path=args.data_path,
            drop_binned=not args.keep_binned,
            train_fraction=args.train_fraction,
            seed=args.seed,
            split_method=args.split_method,
        ),
        model=ModelConfig(name=models[0], params=neural_params),
        tuning=TuningConfig(selection_metric=args.cv_metric),
        output_dir=args.output_dir,
    )
    outcome = run(config, models=models, with_cv=not args.no_cv, device=args.device,
                  save_models_dir=args.save_models_dir)
    print(json.dumps({"accuracies": outcome.accuracies,
                      "artifacts": outcome.report_paths}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
