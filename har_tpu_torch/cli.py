"""`har` command-line interface of the PyTorch/CUDA port.

Mirrors ``har_tpu/cli.py``'s ``train`` for the ported families, its
``sweep``, ``parity`` (and ``parity --raw``), ``evaluate``, ``predict``
(of a checkpoint or an exported ``--artifact``), ``finetune``, ``stream``
and ``export``:

  python -m har_tpu_torch.cli train                # lr dt rf, each with CV
  python -m har_tpu_torch.cli train --device cpu
  python -m har_tpu_torch.cli train --models dt rf --no-cv
  python -m har_tpu_torch.cli train --dataset wisdm_raw --models transformer --no-cv
  python -m har_tpu_torch.cli train --models gbt mlp
  python -m har_tpu_torch.cli train --dataset wisdm_raw --models cnn1d bilstm dt gbt
  python -m har_tpu_torch.cli train --dataset wisdm_raw --models cnn1d --augment raw_windows
  python -m har_tpu_torch.cli train --dataset ucihar --data-path "UCI HAR Dataset"
  python -m har_tpu_torch.cli train --models dt --no-cv --eda
  python -m har_tpu_torch.cli sweep                # lr dt rf at 70/80/90 % train
  python -m har_tpu_torch.cli parity               # the bit-exact replays
  python -m har_tpu_torch.cli parity --blocks dt --device cpu
  python -m har_tpu_torch.cli parity --raw --data-path WISDM_ar_v1.1_raw.txt

  python -m har_tpu_torch.cli train --models lr dt --save-models-dir models
  python -m har_tpu_torch.cli evaluate --checkpoint models/decision_tree
  python -m har_tpu_torch.cli predict --checkpoint models/decision_tree --output p.csv
  python -m har_tpu_torch.cli train --models mlp --no-cv --checkpoint-dir ckpt \
      --save-every-epochs 5 --early-stop-patience 3
  python -m har_tpu_torch.cli finetune --checkpoint models/cnn1d --freeze ConvBlock_0
  python -m har_tpu_torch.cli train --models dt --no-cv --trace-dir trace

  python -m har_tpu_torch.cli stream --checkpoint models/transformer --monitor \
      --events-csv events.csv
  python -m har_tpu_torch.cli export --checkpoint models/cnn1d --output art --quantize int8
  python -m har_tpu_torch.cli evaluate --artifact art
  python -m har_tpu_torch.cli predict --artifact art --output p.csv

  python -m har_tpu_torch.cli serve --sessions 1000
  python -m har_tpu_torch.cli serve --checkpoint models/transformer \
      --pipeline-depth 3 --fused --smoothing vote
  python -m har_tpu_torch.cli serve --checkpoint models/transformer --tier int8
  python -m har_tpu_torch.cli serve --journal wal --kill-after-polls 5
  python -m har_tpu_torch.cli serve --journal wal --resume
  python -m har_tpu_torch.cli serve --adapt --inject-drift 0.5 --registry reg
  python -m har_tpu_torch.cli serve --adapt --journal wal --resume --registry reg
  python -m har_tpu_torch.cli serve --trace diurnal --autoscale
  HAR_TPU_BENCH_SMOKE=1 python -m har_tpu_torch.cli bench --device cpu
  python -m har_tpu_torch.cli lint --check --json   # harlint; imports no torch

``train`` writes result.txt, additional_param.csv,
crossFold_additional_param.csv (with CV) and timing.csv into
``--output-dir`` (with ``--eda``, the plots under ``plot/``); ``parity``
writes the first three.  Both print the accuracies and artifact paths as
JSON; ``sweep`` writes sweep.csv and sweep.txt and prints the table;
``parity --raw``, ``evaluate``, ``predict``, ``finetune``, ``stream``,
``export`` and ``serve`` print their results as JSON (``bench`` runs
``har_tpu_torch.bench`` and prints its one line; ``lint`` runs
``har_tpu_torch.analyze`` and exits 1 on a finding outside the baseline) (``stream`` replays a recording,
or a synthetic demo one, through ``serving.StreamingClassifier`` at the
live cadence; ``export`` writes ``predict.pt2`` and ``export_meta.json``).  Without ``--data-path``, ``ucihar`` is a synthetic
table of its shape, and ``parity --raw`` reads the file
``$HAR_TPU_WISDM_RAW`` names (or skips).
"""

from __future__ import annotations

import argparse
import json
import sys

from har_tpu_torch.config import (
    PARITY_BLOCKS,
    DataConfig,
    MeshConfig,
    ModelConfig,
    RunConfig,
    TuningConfig,
)

DATASETS = ["wisdm", "wisdm_raw", "ucihar", "synthetic"]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="har_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="train + evaluate models, write report")
    t.add_argument("--dataset", default="wisdm", choices=DATASETS,
                   help="wisdm_raw = raw tri-axial windows (the view the "
                        "cnn1d/bilstm/transformer models train on; the "
                        "others train on their 43 WISDM features); "
                        "ucihar = the 561 UCI-HAR features")
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
    t.add_argument("--eda", action="store_true",
                   help="write hexbin pair plots + scatter matrix")
    t.add_argument("--trace-dir", default=None,
                   help="write a TensorBoard-loadable torch.profiler trace "
                        "of the whole run to this directory")
    t.add_argument("--distributed", action="store_true",
                   help="multi-process run, one rank per device: join the "
                        "process group before any device use (every rank "
                        "runs the same command; the flags below, or "
                        "torchrun's environment)")
    t.add_argument("--coordinator", default=None,
                   help="coordinator host:port (with --distributed)")
    t.add_argument("--num-processes", type=int, default=None,
                   help="total process count (with --distributed)")
    t.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (with --distributed)")
    t.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh axis for neural training and "
                        "LR's CV sweep (-1 = every rank; the batch is "
                        "sharded over dp, gradients all-reduced)")
    t.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh axis (Megatron placements "
                        "over hidden dims, as DTensors)")
    t.add_argument("--output-dir", default="main_result")
    t.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")

    for command, help_text in (
        ("evaluate", "score a saved checkpoint (or an exported artifact) "
                     "on its held-out rows"),
        ("predict", "batch inference from a saved checkpoint (or exported "
                    "artifact) → predictions CSV"),
    ):
        c = sub.add_parser(command, help=help_text)
        src = c.add_mutually_exclusive_group(required=True)
        src.add_argument("--checkpoint")
        src.add_argument("--artifact",
                         help="an exported artifact directory (har export "
                              "output) instead of a checkpoint: the "
                              "deployed program itself, no model classes "
                              "in the loop")
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

    st = sub.add_parser(
        "stream",
        help="real-time sliding-window inference: replay a recorded "
             "tri-axial stream (CSV: x,y,z per row) through a saved "
             "checkpoint and emit the activity timeline",
    )
    st.add_argument("--checkpoint", required=True,
                    help="neural checkpoint trained on raw windows")
    st.add_argument("--input", default=None,
                    help="recording CSV (one x,y,z row per 20 Hz sample); "
                         "omit for a synthetic demo recording")
    st.add_argument("--window", type=int, default=None,
                    help="defaults to the checkpoint's recorded training "
                         "window; when the checkpoint records its shape, "
                         "an explicit mismatch is rejected")
    st.add_argument("--hop", type=int, default=20)
    st.add_argument("--smoothing", default="ema",
                    choices=["ema", "vote", "none"])
    st.add_argument("--events-csv", default=None,
                    help="write per-event rows (t_index,label,raw_label,"
                         "latency_ms,probabilities...)")
    st.add_argument("--monitor", action="store_true",
                    help="input-drift detection against the checkpoint's "
                         "training statistics; events are stamped and the "
                         "summary carries the final drift report")
    st.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    _serve_arguments(sub)

    ex = sub.add_parser(
        "export",
        help="export a saved neural checkpoint as a self-contained "
             "torch.export predict artifact (params inside, symbolic "
             "batch dim)",
    )
    ex.add_argument("--checkpoint", required=True)
    ex.add_argument("--output", required=True,
                    help="artifact directory (predict.pt2 + meta)")
    ex.add_argument("--platforms", nargs="+", default=["cuda", "cpu"],
                    help="devices the artifact may load on (default: cuda "
                         "cpu); traced on the CPU either way")
    ex.add_argument("--example-shape", nargs="+", type=int, default=None,
                    help="per-example feature shape (e.g. 200 3) for "
                         "checkpoints that record neither a scaler nor "
                         "input_shape")
    ex.add_argument("--quantize", default=None, choices=["int8"],
                    help="weight-only int8 quantization before export "
                         "(per-output-channel scales; weights stay int8 "
                         "in the artifact)")

    s = sub.add_parser(
        "sweep",
        help="split-ratio sweep (the paper's Table 1/2 experiment): "
             "models × {70-30, 80-20, 90-10}",
    )
    s.add_argument("--dataset", default="wisdm", choices=DATASETS)
    s.add_argument("--data-path", default=None)
    s.add_argument("--models", nargs="+", default=["lr", "dt", "rf"])
    s.add_argument("--fractions", nargs="+", type=float, default=[0.7, 0.8, 0.9])
    s.add_argument("--seed", type=int, default=2018)
    s.add_argument("--no-cv", action="store_true")
    s.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh axis (LR's CV sweep and the "
                        "neural trainers; dp x tp ranks, torchrun)")
    s.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh axis of the neural trainers")
    s.add_argument("--output-dir", default="main_result")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    pa = sub.add_parser(
        "parity",
        help="reproduce the reference's result.txt byte-for-byte "
             "(bit-exact MLlib replays: LR, LR-CV, DT, RF)",
    )
    pa.add_argument("--data-path", default=None)
    pa.add_argument("--output-dir", default="parity_result")
    pa.add_argument("--blocks", nargs="+", default=list(PARITY_BLOCKS),
                    choices=PARITY_BLOCKS,
                    help="which reference blocks to run (default: all four)")
    pa.add_argument("--device", default="cuda",
                    help="where DT grows (with --raw: where the CNN "
                         "trains): cuda (default) or cpu")
    pa.add_argument("--raw", action="store_true",
                    help="instead of the result.txt replay, run the "
                         "raw-WISDM accuracy lane: window a real "
                         "WISDM_ar_v1.1_raw.txt (HAR_TPU_WISDM_RAW / "
                         "./data, or --data-path), train the CNN, report "
                         "held-out accuracy against the 0.97 target")

    b = sub.add_parser(
        "bench",
        help="run the port's headline benchmark (har_tpu_torch.bench): "
             "every lane, one JSON line last",
    )
    b.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the lanes run (default cuda)")

    # the fleet's process entry points: main() forwards each before this
    # parser runs (the real parsers live in har_tpu_torch.serve.net), so
    # these stubs only list them in the help
    sub.add_parser(
        "serve-worker",
        add_help=False,
        help="one FleetServer worker process on a loopback TCP socket "
             "(har_tpu_torch.serve.net.worker), the subprocess behind "
             "`serve --workers N --net`; `serve-worker --help` for flags",
    )
    sub.add_parser(
        "serve-gateway",
        add_help=False,
        help="the fleet's ingest front door "
             "(har_tpu_torch.serve.net.gateway): one process clients "
             "speak the wire protocol to, batched push frames with "
             "header-only edge admission, multiplexed onto running "
             "`serve-worker` processes; two with one --ha-root form an "
             "elected pair; `serve-gateway --help` for flags",
    )
    sub.add_parser(
        "serve-agent",
        add_help=False,
        help="one journal-ship agent per worker host "
             "(har_tpu_torch.serve.net.ship): serves that host's "
             "journal directories to an adopting controller as chunked, "
             "digest-manifested, resumable transfers; with `--follow "
             "WID=HOST:PORT` a warm standby that tails live workers; "
             "`serve-agent --help` for flags",
    )
    _lint_arguments(sub)
    return p


def _lint_arguments(sub) -> None:
    """``lint``: har_tpu's flags and return codes over the port's tree."""
    ln = sub.add_parser(
        "lint",
        help="harlint over the port's fleet stack (HL001 hot-path host "
             "sync via call-graph reachability, HL002 state "
             "completeness, HL003 journal/replay exhaustiveness, HL004 "
             "determinism, HL005 durability, HL006 trace purity, HL007 "
             "placement coverage, HL008 stale suppressions); rc 1 on "
             "any finding outside the baseline.  Imports no torch",
    )
    ln.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (repo-relative); "
                         "default is the fleet-stack fileset "
                         "(har_tpu_torch/serve, adapt, parallel, "
                         "serving.py, utils/durable.py, utils/backoff.py)")
    ln.add_argument("--json", action="store_true", dest="as_json",
                    help="one JSON report line (the release gate's "
                         "format) instead of text findings")
    ln.add_argument("--baseline", default=None,
                    help="baseline suppression file (default: "
                         "har_tpu_torch/harlint_baseline.json)")
    ln.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current findings "
                         "(reviewed-debt admission; keep it near-empty)")
    ln.add_argument("--check", action="store_true",
                    help="summary only (no per-finding lines); rc is "
                         "the verdict — the release-gate invocation")
    ln.add_argument("--changed", nargs="?", const="HEAD", default=None,
                    metavar="REF",
                    help="lint only fileset files changed vs a git ref "
                         "(default HEAD); HL003 and HL008 are skipped "
                         "(they only hold over the full fileset)")
    ln.add_argument("--rule", action="append", default=None,
                    metavar="HL00X",
                    help="run only the named rule (repeatable)")
    ln.add_argument("--stats", action="store_true",
                    help="print per-rule timing and the file count after "
                         "the report; with --json the timings ride the "
                         "report's rule_ms/callgraph_ms/lint_ms keys")


def _lint(args) -> int:
    """The pure-stdlib path: ``har_tpu_torch.analyze`` and nothing that
    imports torch, so the release gate's lint stays inside its budget."""
    from har_tpu_torch.analyze import (
        LintReport,
        changed_fileset_paths,
        default_rules,
        repo_root,
        run_harlint,
    )

    rules = None
    if args.rule:
        known = {r.rule_id: r for r in default_rules()}
        bad = [r for r in args.rule if r not in known]
        if bad:
            raise SystemExit(
                f"unknown rule id(s) {', '.join(bad)} — "
                f"available: {', '.join(sorted(known))}"
            )
        # deduplicated, order kept: a repeated --rule must not run twice
        rules = [known[r] for r in dict.fromkeys(args.rule)]
    paths = args.paths or None
    if args.changed is not None:
        if paths is not None:
            raise SystemExit(
                "--changed computes its own path subset; drop the "
                "explicit paths (or drop --changed)"
            )
        paths = changed_fileset_paths(repo_root(), args.changed)
        if not paths:
            if args.as_json:
                # one parseable report line even for the cleanest commit
                print(json.dumps(LintReport(
                    findings=[], baselined=0, annotation_suppressed=0,
                    rules_run=[], files=0, baseline_path="",
                    baseline_size=0,
                ).to_json()))
            else:
                print(f"harlint: no fileset files changed vs "
                      f"{args.changed} — nothing to lint")
            return 0
    report = run_harlint(
        paths=paths,
        baseline=args.baseline,
        update_baseline=args.update_baseline,
        rules=rules,
    )
    if args.as_json:
        print(json.dumps(report.to_json()))
    elif args.check:
        print(f"harlint: {len(report.findings)} finding(s), "
              f"{report.suppressed} suppressed")
    else:
        print(report.render())
    if args.stats and not args.as_json:
        print(report.render_stats())
    return 0 if report.ok else 1


def _serve_arguments(sub) -> None:
    """``serve``: har_tpu's flags, plus ``--device``."""
    sv = sub.add_parser(
        "serve",
        help="fleet serving smoke: multiplex N concurrent synthetic "
             "20 Hz sessions through the continuous-batching engine "
             "(har_tpu_torch.serve) and report FleetStats + p50/p99 "
             "event latency",
    )
    sv.add_argument("--sessions", type=int, default=1000,
                    help="concurrent sessions to admit and drive")
    sv.add_argument("--windows-per-session", type=int, default=2,
                    help="10 s windows each session streams")
    sv.add_argument("--checkpoint", default=None,
                    help="serve a saved neural checkpoint; default is "
                         "the training-free analytic demo model "
                         "(scheduler-overhead baseline)")
    sv.add_argument("--hop", type=int, default=200,
                    help="emission stride in samples (200 = one "
                         "decision per 10 s window)")
    sv.add_argument("--smoothing", default="ema",
                    choices=["ema", "vote", "none"])
    sv.add_argument("--target-batch", type=int, default=256,
                    help="micro-batcher dispatch size (power-of-two "
                         "padded: at most log2+1 batch shapes)")
    sv.add_argument("--pipeline-depth", type=int, default=1,
                    help="dispatch batches in flight on the device "
                         "before the host blocks on a retire: 1 = "
                         "synchronous engine, 2 = double-buffered, >=3 "
                         "= the ticket ring (events, smoothing and "
                         "journal acks stay in the synchronous order at "
                         "any depth)")
    sv.add_argument("--fused", action="store_true",
                    help="fused device hot loop: scale + score + argmax "
                         "+ top-prob in ONE device function, retire "
                         "fetching only (labels, top_probs).  Needs a "
                         "device model (--checkpoint, or the demo MLP "
                         "that --fused / --tier int8 pick) and vote/none "
                         "smoothing; labels are unchanged, off-label "
                         "event probabilities become the compact "
                         "surrogate")
    sv.add_argument("--tier", default="f32", choices=["f32", "int8"],
                    help="serving tier: int8 = weight-only quantized "
                         "serving (har_tpu_torch.quantize."
                         "quantize_serving; weights stay int8 on the "
                         "device, dequantized inside the forward)")
    sv.add_argument("--mesh", type=int, default=0,
                    help="shard each dispatch batch over this many "
                         "devices (distinct visible cards; with --device "
                         "cpu, the CPU repeated as a dry-run mesh; "
                         "batches pad to devices x pow2).  0 = single "
                         "device.  A host model (the analytic demo) "
                         "falls back to host scoring")
    sv.add_argument("--mesh-shape", type=str, default=None,
                    help="2D BxM (batch x model) serving mesh, e.g. "
                         "2x4: batch rows shard over B devices while the "
                         "model's weights place model-parallel over M by "
                         "the partition-rule tables (har_tpu_torch."
                         "parallel.rules) — serves models bigger than one "
                         "device.  Mutually exclusive with --mesh; needs "
                         "B*M devices, as --mesh does")
    sv.add_argument("--workers", type=int, default=0,
                    help="multi-worker fleet cluster (har_tpu_torch."
                         "serve.cluster): sessions partition across N "
                         "journaled FleetServers behind a consistent-"
                         "hash router; 0/1 = the single-process engine")
    sv.add_argument("--net", action="store_true",
                    help="with --workers: the real transport "
                         "(har_tpu_torch.serve.net) — each worker is an "
                         "OS subprocess (`serve-worker`) on a loopback "
                         "TCP socket, real clocks, CRC-framed RPCs")
    sv.add_argument("--kill-worker", default=None,
                    help="with --workers: SIGKILL this worker (e.g. w1) "
                         "once windows are flowing — the lease protocol "
                         "detects it and journal hand-off migrates its "
                         "sessions live")
    sv.add_argument("--trace", default=None,
                    choices=["diurnal", "bursty", "storm"],
                    help="elastic traffic mode (har_tpu_torch.serve."
                         "traffic): instead of N flat sessions, drive a "
                         "seeded arrival process with session connect/"
                         "disconnect churn — a 10x diurnal swing "
                         "(--sessions is the PEAK), Poisson-modulated "
                         "bursts, or a mid-run overnight-cohort "
                         "disconnect storm; slow-client stalls and "
                         "mixed per-session rates included.  The trace "
                         "spec is printed in the summary (replayable "
                         "by seed+params)")
    sv.add_argument("--trace-rounds", type=int, default=96,
                    help="delivery rounds (= one diurnal period) for "
                         "--trace")
    sv.add_argument("--autoscale", action="store_true",
                    help="with --trace: attach the load-adaptive "
                         "capacity controller (serve.traffic.autoscale) "
                         "— a hysteresis/cooldown policy loop resizing "
                         "target_batch and pipeline_depth online at "
                         "dispatch boundaries (zero-drop, journaled) "
                         "as the swing loads and unloads the engine")
    sv.add_argument("--max-delay-ms", type=float, default=50.0,
                    help="deadline: max time a due window waits for "
                         "batch coalescing")
    sv.add_argument("--monitor", action="store_true",
                    help="attach a per-session DriftMonitor (synthetic "
                         "training stats); drift verdicts flow into "
                         "the multiplexed event stream")
    sv.add_argument("--adapt", action="store_true",
                    help="close the drift loop (har_tpu_torch.adapt): "
                         "per-session monitors feed a fleet-level "
                         "retrain trigger; a candidate shadow-scores "
                         "mirrored live batches and is hot-swapped in "
                         "(zero dropped windows) when the gates pass, "
                         "with automatic rollback on post-swap "
                         "regression.  Implies --monitor.")
    sv.add_argument("--inject-drift", type=float, default=0.0,
                    help="fraction of sessions whose streams shift "
                         "mid-recording (a population-scale sensor "
                         "re-mount) — with --adapt this exercises the "
                         "full retrain→shadow→swap loop")
    sv.add_argument("--registry", default=None,
                    help="model-registry root for --adapt (versioned "
                         "lineage + promotions log); default is a "
                         "temp dir discarded after the run")
    sv.add_argument("--profile-host", action="store_true",
                    help="per-poll host-time breakdown (ingest / "
                         "due-select / gather / retire / journal stage "
                         "histograms, serve.stats.HostProfile) stamped "
                         "into the summary JSON")
    sv.add_argument("--calibrate-device", action="store_true",
                    help="measure device p50 per dispatched batch "
                         "shape (device models only) so the stats "
                         "attribute p99 spikes to host vs device")
    sv.add_argument("--journal", default=None,
                    help="write-ahead journal directory "
                         "(har_tpu_torch.serve.journal): session state, "
                         "pushed samples and scored-event acks become "
                         "crash-recoverable; pair with --resume after a "
                         "kill")
    sv.add_argument("--resume", action="store_true",
                    help="recover the fleet from --journal DIR "
                         "(snapshot + journal-suffix replay) and resume "
                         "delivery from each session's recovered "
                         "watermark — acked events are never re-emitted")
    sv.add_argument("--journal-flush-every", type=int, default=64,
                    help="journal records buffered between fsync "
                         "batches (acks always flush at poll "
                         "boundaries); bounds the crash loss window")
    sv.add_argument("--journal-snapshot-every", type=int, default=4096,
                    help="journal records between state snapshots; "
                         "bounds recovery replay cost")
    sv.add_argument("--kill-after-polls", type=int, default=0,
                    help="TESTING: os._exit(17) after N scheduler polls "
                         "— a SIGKILL stand-in for crash-recovery "
                         "drills (nothing is flushed beyond what the "
                         "journal already made durable)")
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--inject-drop", type=float, default=0.0,
                    help="probability a delivery chunk is lost")
    sv.add_argument("--inject-delay", type=float, default=0.0,
                    help="probability a chunk is held one round "
                         "(catch-up burst)")
    sv.add_argument("--inject-stall-ms", type=float, default=0.0,
                    help="with --inject-stall-every: dispatch stall "
                         "length (exercises the SLO/degradation "
                         "ladder)")
    sv.add_argument("--inject-stall-every", type=int, default=0,
                    help="stall every Nth dispatch by "
                         "--inject-stall-ms")
    sv.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _scoring_arguments(c) -> None:
    """The data a saved model is scored on: the recorded dataset, seed and
    train fraction unless given."""
    c.add_argument("--dataset", default=None, choices=DATASETS,
                   help="defaults to the dataset recorded in the checkpoint")
    c.add_argument("--data-path", default=None)
    c.add_argument("--train-fraction", type=float, default=None,
                   help="defaults to the training run's recorded value")
    c.add_argument("--seed", type=int, default=None,
                   help="split seed; defaults to the training run's "
                        "recorded value")
    c.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def _evaluate_or_predict(args) -> int:
    from har_tpu_torch import checkpoint, export

    scoring = dict(dataset=args.dataset, train_fraction=args.train_fraction,
                   seed=args.seed, device=args.device)
    if args.artifact is not None:
        src, evaluate, predict = (args.artifact, export.evaluate_artifact,
                                  export.predict_artifact)
    else:
        src, evaluate, predict = (args.checkpoint, checkpoint.evaluate_checkpoint,
                                  checkpoint.predict_checkpoint)
    if args.command == "predict":
        out = predict(src, args.output, args.data_path, **scoring)
    else:
        out = evaluate(src, args.data_path, **scoring)
    print(json.dumps(out))
    return 0


def demo_recording():
    """``stream``'s synthetic demo recording: three activity stretches
    (classes 0, 1, 0, four windows each) of the calibrated generator,
    (2400, 3) float32."""
    import numpy as np

    from har_tpu_torch.data.raw_windows import synthetic_raw_stream

    raw = synthetic_raw_stream(n_windows=24, seed=0)
    return np.concatenate([
        raw.windows[raw.labels == c][:4].reshape(-1, 3) for c in (0, 1, 0)
    ])


def _stream(args) -> int:
    import csv

    import numpy as np

    from har_tpu_torch.serving import SessionResult, StreamingClassifier

    try:
        sc = StreamingClassifier.from_checkpoint(
            args.checkpoint,
            device=args.device,
            window=args.window,
            hop=args.hop,
            smoothing=args.smoothing,
            monitor="auto" if args.monitor else None,
        )
    except ValueError as e:
        raise SystemExit(str(e))  # clean message, not a traceback
    if args.input is not None:
        rec = np.loadtxt(args.input, delimiter=",", dtype=np.float32)
    else:
        rec = demo_recording()
    # live cadence + device-vs-host latency split: see
    # StreamingClassifier.replay
    events = sc.replay(rec)
    if args.events_csv:
        with open(args.events_csv, "w", newline="") as f:
            w = csv.writer(f)
            n_probs = len(events[0].probability) if events else 0
            w.writerow(["t_index", "label", "raw_label", "latency_ms"]
                       + [f"p{i}" for i in range(n_probs)])
            for e in events:
                w.writerow([e.t_index, e.label, e.raw_label, round(e.latency_ms, 3)]
                           + [round(float(p), 6) for p in e.probability])
    # one run-length merge for both surfaces: a SessionResult over the
    # (smoothed) event labels
    sr = SessionResult(
        t_index=np.array([e.t_index for e in events], np.int64),
        labels=np.array([e.label for e in events], np.int32),
        probability=(np.stack([e.probability for e in events]) if events
                     else np.zeros((0, 0), np.float64)),
    )
    timeline = [{"from_t": a, "to_t": b, "label": lab} for a, b, lab in sr.segments()]
    drift = None
    if args.monitor and sc.drift_report is not None:
        rep = sc.drift_report
        drift = {
            "drifting": rep.drifting,
            "events_flagged": sum(1 for e in events if e.drift),
            "location_z": [round(float(z), 3) for z in rep.location_z],
            "scale_log_ratio": [round(float(r), 3) for r in rep.scale_log_ratio],
        }
    print(json.dumps({
        "n_samples": int(len(rec)),
        "n_events": len(events),
        "timeline": timeline,
        "latency": sc.latency_stats(),
        "drift": drift,
        "events_csv": args.events_csv,
    }))
    return 0


def _serve(args) -> int:
    """``serve``: the single-process fleet of ``har_tpu``'s ``serve``,
    with its summary keys: the steady N-session load (with ``--adapt``,
    the drift loop over it) or, with ``--trace``, the churn fleet."""
    import dataclasses

    import numpy as np

    from har_tpu_torch.device import resolve_device
    from har_tpu_torch.serve import (
        AnalyticDemoModel,
        DeliveryFaults,
        DispatchFaults,
        FleetConfig,
        FleetServer,
        JitDemoModel,
        JournalConfig,
        drive_fleet,
        synthetic_sessions,
    )

    device = resolve_device(args.device)
    mesh = _serving_mesh(args, device)
    window, channels = 200, 3
    if args.checkpoint is not None:
        from har_tpu_torch.checkpoint import load_model, load_model_meta

        model = load_model(args.checkpoint, device)
        # serve at the checkpoint's recorded geometry (the guard
        # StreamingClassifier.from_checkpoint enforces)
        try:
            shape = load_model_meta(args.checkpoint).get("input_shape")
        except OSError:
            shape = None
        if shape and len(shape) == 2:
            window, channels = int(shape[0]), int(shape[1])
        if channels != 3:
            raise SystemExit(
                f"checkpoint records input_shape={shape}; the "
                "synthetic fleet load generator emits tri-axial "
                "(n, 3) streams — serve this checkpoint behind a "
                "matching transport instead"
            )
    elif args.tier == "int8" or args.fused:
        # --tier int8 / --fused need a device program: the demo MLP
        model = JitDemoModel(window=window, channels=channels, device=device)
    else:
        # training-free analytic model: the scheduler-overhead baseline
        model = AnalyticDemoModel()
    if args.tier == "int8":
        from har_tpu_torch.quantize import quantize_serving

        try:
            model = quantize_serving(model)
        except ValueError as exc:
            raise SystemExit(
                f"--tier int8: {exc} — serve a device model "
                "(--checkpoint with a neural family)"
            )
    if args.fused and args.smoothing == "ema":
        raise SystemExit(
            "--fused needs a fused-eligible smoothing mode "
            "(--smoothing vote|none): EMA smoothing consumes the "
            "full probability vector the fused retire never fetches"
        )
    fault_hook = None
    if args.inject_stall_every:
        fault_hook = DispatchFaults(
            stall_every=args.inject_stall_every,
            stall_ms=args.inject_stall_ms,
        )
    journal_cfg = None
    if args.journal:
        journal_cfg = JournalConfig(
            flush_every=args.journal_flush_every,
            snapshot_every=args.journal_snapshot_every,
        )
    if args.trace:
        return _serve_trace(args, model, window, channels, fault_hook, journal_cfg,
                            mesh)
    recordings, class_names = synthetic_sessions(
        args.sessions,
        windows_per_session=args.windows_per_session,
        window=window,
        seed=args.seed,
    )
    # reference stats from the CLEAN pool (before the drift mutation),
    # and only when a monitor needs them
    monitor_ref = None
    if args.monitor or args.adapt:
        pool = np.concatenate(recordings)
        monitor_ref = (pool.mean(axis=0), pool.std(axis=0))
        del pool
    n_drifted = int(args.sessions * min(max(args.inject_drift, 0.0), 1.0))
    for i in range(n_drifted):
        # population-scale sensor re-mount: the second half shifts far
        # out of distribution
        rec = recordings[i].copy()
        rec[len(rec) // 2:] += 25.0
        recordings[i] = rec
    if args.net and not (args.workers and args.workers > 1):
        raise SystemExit(
            "--net is the multi-worker transport; pair it with "
            "--workers N (N >= 2)"
        )
    if args.workers and args.workers > 1:
        return _serve_cluster(args, model, window, channels, class_names,
                              recordings, monitor_ref, journal_cfg)

    recovered_events = []
    if args.resume:
        if not args.journal:
            raise SystemExit("--resume requires --journal DIR")
        if args.adapt and args.registry is None:
            raise SystemExit(
                "--resume --adapt needs a durable --registry DIR "
                "(the registry pointer is what recovery reconciles "
                "the fleet against)"
            )
        # snapshot + journal-suffix replay rebuilds the sessions (their
        # monitors included) and the pending queue; the transport then
        # re-delivers from each session's recovered watermark
        server = FleetServer.restore(
            args.journal,
            lambda ver: model,
            fault_hook=fault_hook,
            journal_config=journal_cfg,
            mesh=mesh,
        )
        recovered_events = server.poll(force=True)
        recordings = [
            rec[server.watermark(i):] if i in server._sessions else rec
            for i, rec in enumerate(recordings)
        ]
    else:
        from har_tpu_torch.monitoring import DriftMonitor

        server = FleetServer(
            model,
            window=window,
            channels=channels,
            hop=args.hop,
            smoothing=args.smoothing,
            class_names=class_names,
            config=FleetConfig.for_sessions(
                args.sessions,
                target_batch=args.target_batch,
                max_delay_ms=args.max_delay_ms,
                pipeline_depth=args.pipeline_depth,
                fused=args.fused,
                profile_host=args.profile_host,
            ),
            fault_hook=fault_hook,
            journal=args.journal,
            journal_config=journal_cfg,
            mesh=mesh,
        )
        # --adapt tightens the monitor (faster EWMA, shorter debounce)
        # so the demo loop closes within a short synthetic drive; plain
        # --monitor keeps the defaults (20 s halflife, patience 3)
        mon_kwargs = {"halflife": 100.0, "patience": 2} if args.adapt else {}
        for i in range(args.sessions):
            server.add_session(
                i,
                monitor=(
                    DriftMonitor(*monitor_ref, **mon_kwargs)
                    if monitor_ref is not None else None
                ),
            )
    engine = None
    registry_tmp = None
    try:
        if args.adapt:
            import tempfile

            from har_tpu_torch.adapt import (
                AdaptationConfig,
                AdaptationEngine,
                ModelRegistry,
                ShadowConfig,
                TriggerConfig,
            )

            registry_root = args.registry
            if registry_root is None:
                registry_tmp = registry_root = tempfile.mkdtemp(prefix="har_registry_")

            # demo retrainer: a deterministic same-family refit — the
            # loop's plumbing (trigger → shadow → swap → probation) is
            # what this subcommand demonstrates; a real deployment
            # passes a retrainer that fits on job.replay + its seed set
            def retrainer(job):
                return AnalyticDemoModel() if args.checkpoint is None else model

            engine = AdaptationEngine(
                server,
                ModelRegistry(registry_root),
                retrainer,
                config=AdaptationConfig(probation_dispatches=2),
                trigger_config=TriggerConfig(
                    min_sessions=max(2, n_drifted // 2) if n_drifted else 3,
                    window_s=1e9,
                    cooldown_s=1e9,
                ),
                shadow_config=ShadowConfig(sample_every=1, min_windows=16),
                resume=args.resume,
                # the CLI's registry holds metadata-only versions: every
                # one of them serves the model built above on --device
                loader=lambda ver: retrainer(None),
            )
        polls = {"n": 0}

        def on_poll(srv, rnd):
            if engine is not None:
                engine.step()
            polls["n"] += 1
            if args.kill_after_polls and polls["n"] >= args.kill_after_polls:
                # SIGKILL stand-in: no flush, no cleanup — only what the
                # journal already fsynced survives
                import os

                print(f"kill-after-polls: exiting hard at poll {polls['n']}",
                      file=sys.stderr)
                sys.stdout.flush()
                os._exit(17)

        events, report = drive_fleet(
            server,
            recordings,
            seed=args.seed,
            faults=DeliveryFaults(
                drop_prob=args.inject_drop, delay_prob=args.inject_delay
            ),
            on_poll=(
                on_poll if (engine is not None or args.kill_after_polls) else None
            ),
        )
        events = recovered_events + events
        _raise_device_faults(server)
        if args.calibrate_device:
            try:
                server.calibrate_device()
            except ValueError as e:
                print(f"warning: device calibration skipped: {e}", file=sys.stderr)
        snap = server.stats_snapshot()
        acct = snap["accounting"]
        print(json.dumps({
            "sessions": args.sessions,
            "n_events": len(events),
            "enqueued": acct["enqueued"],
            "scored": acct["scored"],
            "dropped": acct["dropped"],
            "windows_per_sec": (
                round(acct["scored"] / report.duration_s, 1)
                if report.duration_s else None
            ),
            "event_p50_ms": snap["stages"]["event_ms"].get("p50_ms"),
            "event_p99_ms": snap["stages"]["event_ms"].get("p99_ms"),
            "degraded_events": snap["degraded_events"],
            "pipeline_depth": snap["pipeline_depth"],
            "devices": snap["devices"],
            "overlap_pct": snap["overlap_pct"],
            "drift_events": sum(1 for ev in events if ev.event.drift),
            "adapt": None if engine is None else engine.status(),
            "journal": args.journal,
            "resumed": bool(args.resume),
            "recoveries": snap["recoveries"],
            "lost_in_crash": acct["lost_in_crash"],
            "host_profile": snap.get("host_profile"),
            "load": dataclasses.asdict(report),
            "stats": snap,
        }))
    finally:
        # the throwaway registry must not survive a failed drive
        # (KeyboardInterrupt included) any more than a clean one
        if registry_tmp is not None:
            import shutil

            shutil.rmtree(registry_tmp, ignore_errors=True)
    return 0


def _serve_cluster(args, model, window, channels, class_names, recordings,
                   monitor_ref, journal_cfg) -> int:
    """``serve --workers N [--net] [--kill-worker W]``: sessions
    partition across N journaled FleetServers behind the consistent-hash
    router — in-process on a FakeClock, or (``--net``) N ``serve-worker``
    subprocesses on loopback sockets.  ``--kill-worker`` kills one once
    windows are flowing; the lease protocol detects it and journal
    hand-off migrates its partition.  ``har_tpu``'s refusals and summary
    keys."""
    import shutil
    import tempfile
    import time

    if args.resume or args.adapt or args.mesh or args.mesh_shape or args.checkpoint:
        raise SystemExit(
            "--workers drives the analytic demo fleet; it does not combine "
            "with --resume/--adapt/--mesh/--mesh-shape/--checkpoint (each "
            "worker is an unmodified FleetServer — run those modes "
            "single-process)"
        )
    if args.net:
        return _serve_net_cluster(args, window, channels, recordings)
    from har_tpu_torch.monitoring import DriftMonitor
    from har_tpu_torch.serve import DispatchFaults, FakeClock, FleetConfig
    from har_tpu_torch.serve.chaos import _drive_cluster
    from har_tpu_torch.serve.cluster import ClusterConfig, FleetCluster

    cluster_tmp = None
    root = args.journal
    if root is None:
        cluster_tmp = root = tempfile.mkdtemp(prefix="har_cluster_")
    clock = FakeClock()
    # the single-server --inject-stall-* flags apply per worker here (each
    # worker gets its own fault hook on the shared fake clock) — requested
    # fault injection must never be silently dropped
    fault_hook_for = None
    if args.inject_stall_every:
        fault_hook_for = lambda wid: DispatchFaults(  # noqa: E731
            stall_every=args.inject_stall_every,
            stall_ms=args.inject_stall_ms,
            fake_clock=clock,
        )
    cluster = FleetCluster(
        model,
        root,
        workers=args.workers,
        fault_hook_for=fault_hook_for,
        window=window,
        hop=args.hop,
        channels=channels,
        smoothing=args.smoothing,
        class_names=class_names,
        fleet_config=FleetConfig.for_sessions(
            args.sessions,
            target_batch=args.target_batch,
            max_delay_ms=args.max_delay_ms,
            pipeline_depth=args.pipeline_depth,
            fused=args.fused,
            profile_host=args.profile_host,
        ),
        config=ClusterConfig(lease_s=0.5, probe_base_ms=20.0, probe_cap_ms=200.0),
        journal_config=journal_cfg,
        clock=clock,
    )
    try:
        for i in range(args.sessions):
            cluster.add_session(
                i,
                monitor=(
                    DriftMonitor(*monitor_ref) if monitor_ref is not None else None
                ),
            )
        if args.kill_worker is not None and args.kill_worker not in cluster.workers:
            raise SystemExit(
                f"--kill-worker {args.kill_worker!r}: cluster workers are "
                f"{list(cluster.workers)}"
            )
        events = []
        killed = {"done": False}

        def on_round(c):
            # SIGKILL the named worker once windows are flowing — the
            # failure detector + journal hand-off then migrate its
            # partition live
            if (
                args.kill_worker is not None
                and not killed["done"]
                and c.accounting()["scored"] > 0
                and args.kill_worker in c._workers
            ):
                c._workers[args.kill_worker].kill()
                killed["done"] = True

        t0 = time.perf_counter()
        _drive_cluster(
            cluster, recordings, [0] * args.sessions,
            max(map(len, recordings)), args.hop, clock, events, on_round,
        )
        duration = time.perf_counter() - t0
        for w in cluster._workers.values():
            _raise_device_faults(w.server)
        stats = cluster.cluster_stats()
        acct = stats["accounting"]
        print(json.dumps({
            "sessions": args.sessions,
            "workers": stats["workers"],
            "n_events": len(events),
            "enqueued": acct["enqueued"],
            "scored": acct["scored"],
            "dropped": acct["dropped"],
            "pending": acct["pending"],
            "balanced": acct["balanced"],
            "windows_per_sec": (
                round(acct["scored"] / duration, 1) if duration else None
            ),
            "failovers": stats["failovers"],
            "migrated_sessions": stats["migrated_sessions"],
            "migration_ms": stats["migration_ms"],
            "per_worker_sessions": stats["per_worker_sessions"],
            "retired": stats["retired"],
            "killed_worker": args.kill_worker if killed["done"] else None,
            "cluster_root": root,
        }))
        cluster.close()
    finally:
        if cluster_tmp is not None:
            shutil.rmtree(cluster_tmp, ignore_errors=True)
    return 0


def _serve_net_cluster(args, window, channels, recordings) -> int:
    """``serve --workers N --net``: N ``serve-worker`` OS subprocesses on
    loopback sockets behind a ``NetCluster``; ``--kill-worker`` is a real
    SIGKILL of that process.  A worker that does not start ends the run
    (``launch_workers`` raises); nothing falls back to the in-process
    cluster."""
    import shutil
    import tempfile
    import time

    if args.inject_stall_every or args.monitor:
        raise SystemExit(
            "--net workers run in their own processes; --inject-stall-*/"
            "--monitor are in-process harness hooks (run them without --net)"
        )
    if args.fused or args.tier != "f32":
        raise SystemExit(
            "--net workers serve their own named model pool (`serve-worker "
            "--model demo`); --fused/--tier are per-worker serving knobs the "
            "wire does not carry yet — run them without --net"
        )
    if args.pipeline_depth != 1 or args.profile_host:
        # refuse, never silently ignore: launch_workers does not forward
        # these per-worker knobs
        raise SystemExit(
            "--net does not carry --pipeline-depth/--profile-host to the "
            "worker processes yet; run them without --net (or start workers "
            "directly with `serve-worker`)"
        )
    from har_tpu_torch.serve.net.chaos import _drive_net_cluster, _net_cluster_config
    from har_tpu_torch.serve.net.controller import NetCluster, launch_workers
    from har_tpu_torch.serve.net.worker import model_pool

    # the controller's failover restores score with THE SAME pool the
    # workers serve (version -> model), so re-derived windows stay
    # bit-identical to acked ones
    pool = model_pool("demo")
    cluster_tmp = None
    root = args.journal
    if root is None:
        cluster_tmp = root = tempfile.mkdtemp(prefix="har_netcluster_")
    procs = {}
    try:
        net_workers = launch_workers(
            root,
            args.workers,
            window=window,
            hop=args.hop,
            channels=channels,
            smoothing=args.smoothing,
            max_sessions=max(args.sessions, 64),
            target_batch=args.target_batch,
            max_delay_ms=args.max_delay_ms,
            flush_every=args.journal_flush_every,
            snapshot_every=args.journal_snapshot_every,
        )
        procs.update({w.worker_id: w.process for w in net_workers})
        cluster = NetCluster(
            pool["A"],
            root,
            _workers=net_workers,
            config=_net_cluster_config(),
            loader=lambda ver: pool.get(ver, pool["A"]),
        )
        if args.kill_worker is not None and args.kill_worker not in cluster.workers:
            raise SystemExit(
                f"--kill-worker {args.kill_worker!r}: cluster workers are "
                f"{list(cluster.workers)}"
            )
        for i in range(args.sessions):
            cluster.add_session(i)
        events = []
        killed = {"done": False}

        def on_round(c):
            # a REAL SIGKILL of the named worker process once windows are
            # flowing — detection, restore and migration then run on the
            # protocol alone
            if args.kill_worker is not None and not killed["done"]:
                try:
                    scored = c.accounting()["scored"]
                except Exception:
                    return
                if scored > 0:
                    procs[args.kill_worker].kill()
                    killed["done"] = True

        t0 = time.perf_counter()
        _drive_net_cluster(
            cluster, recordings, [0] * args.sessions,
            max(map(len, recordings)), args.hop, events, on_round,
        )
        duration = time.perf_counter() - t0
        stats = cluster.cluster_stats()
        acct = stats["accounting"]
        print(json.dumps({
            "sessions": args.sessions,
            "workers": stats["workers"],
            "transport": "tcp",
            "n_events": len(events),
            "enqueued": acct["enqueued"],
            "scored": acct["scored"],
            "dropped": acct["dropped"],
            "pending": acct["pending"],
            "balanced": acct["balanced"],
            "windows_per_sec": (
                round(acct["scored"] / duration, 1) if duration else None
            ),
            "failovers": stats["failovers"],
            "failover_ms": stats["failover_ms"],
            "migrated_sessions": max(
                stats["migrated_sessions"], stats["migrations"]
            ),
            "per_worker_sessions": stats["per_worker_sessions"],
            "rpc": cluster.transport_stats(),
            "killed_worker": args.kill_worker if killed["done"] else None,
            "cluster_root": root,
        }))
        cluster.shutdown_workers()
        cluster.close()
    finally:
        # a failed drive must not leak worker processes — and the journal
        # root is deleted only once none of them can still write to it
        # (kill is a no-op on an exited process)
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        if cluster_tmp is not None:
            shutil.rmtree(cluster_tmp, ignore_errors=True)
    return 0


def _serving_mesh(args, device):
    """The serving mesh ``--mesh N`` (N × 1) or ``--mesh-shape BxM`` names
    (``har_tpu``'s checks and messages; the hint is the port's own), or
    None."""
    import re

    from har_tpu_torch.parallel.mesh import create_serving_mesh, serving_devices

    if args.mesh_shape and args.mesh:
        raise SystemExit(
            "--mesh-shape and --mesh both name a serving mesh; pass one "
            "(--mesh-shape BxM covers the 1D case as Bx1)"
        )
    if args.mesh:
        flag, (b, m) = f"--mesh {args.mesh}", (args.mesh, 1)
    elif args.mesh_shape:
        match = re.fullmatch(r"(\d+)x(\d+)", args.mesh_shape.strip())
        if not match or int(match.group(1)) < 1 or int(match.group(2)) < 1:
            raise SystemExit(
                f"--mesh-shape {args.mesh_shape!r} is not BxM (two positive "
                "integers, e.g. 2x4)"
            )
        b, m = int(match.group(1)), int(match.group(2))
        flag = f"--mesh-shape {b}x{m}"
    else:
        return None
    try:
        devices = serving_devices(b * m, device)
    except ValueError as exc:
        raise SystemExit(
            f"{flag} {exc}; on a CPU host pass --device cpu for a dry-run "
            f"mesh of {b * m} (the CPU repeated)"
        ) from None
    return create_serving_mesh(dp=b, tp=m, devices=devices)


def _raise_device_faults(server) -> None:
    """``serve`` injects no dispatch failures and its shadow scoring has
    no reason to fail: a failed dispatch or a raising dispatch tap is a
    fault of the device path (a kernel that refuses or fails), so it
    ends the run instead of counting as shed windows or shadow errors."""
    if server.stats.dispatch_failures:
        err = server.last_dispatch_error
        raise RuntimeError(
            f"{server.stats.dispatch_failures} dispatch(es) failed after "
            f"their retries; the last error: {err!r}"
        ) from err
    if server.stats.shadow_errors:
        err = server.last_shadow_error
        raise RuntimeError(
            f"{server.stats.shadow_errors} shadow-scored batch(es) "
            f"raised; the last error: {err!r}"
        ) from err


def _serve_trace(args, model, window, channels, fault_hook, journal_cfg,
                 mesh) -> int:
    """``serve --trace``: instead of N flat sessions, drive a seeded
    arrival process with session churn — and, with ``--autoscale``, let
    the capacity controller walk target_batch / pipeline_depth (/ the
    mesh, when ``--mesh N`` names a ladder ceiling) up the swing and back
    down through ``FleetServer.resize``'s zero-drop dispatch-boundary
    path.  ``har_tpu``'s spec, floor and ceiling, and summary keys."""
    import time

    if (
        args.resume
        or args.adapt
        or args.kill_after_polls
        or (args.workers and args.workers > 1)
        or args.net
        or args.monitor
        or args.inject_drift
        or args.inject_drop
        or args.inject_delay
        or args.calibrate_device
    ):
        # refuse, never silently ignore: every one of these flags is
        # serviced only by the steady N-session path
        raise SystemExit(
            "--trace drives its own churn fleet; it does not combine "
            "with --workers/--net/--resume/--adapt/--kill-after-polls/"
            "--monitor/--inject-drift/--inject-drop/--inject-delay/"
            "--calibrate-device (run those modes against the steady "
            "N-session load)"
        )
    from har_tpu_torch.data.raw_windows import synthetic_raw_stream
    from har_tpu_torch.serve import FleetConfig, FleetServer
    from har_tpu_torch.serve.traffic import (
        AutoscaleConfig,
        CapacityController,
        TraceSpec,
        TrafficTrace,
        drive_trace,
        undeclared_drops,
    )

    # label names only — drive_trace builds its own sample pool
    class_names = synthetic_raw_stream(
        n_windows=1, seed=args.seed, window=window
    ).class_names
    rounds = args.trace_rounds
    spec = TraceSpec(
        kind=args.trace,
        peak_sessions=args.sessions,
        swing=10.0,
        rounds=rounds,
        period=rounds,
        # the overnight cohort leaves on the downslope
        storms=((int(rounds * 0.65), 0.5),) if args.trace == "storm" else (),
        burst_prob=0.15 if args.trace == "bursty" else 0.0,
        burst_size=max(2, args.sessions // 8),
        slow_prob=0.02,
        slow_rounds=3,
        rate_mix=(1, 1, 2),
        seed=args.seed,
    )
    trace = TrafficTrace(spec)
    # autoscaled runs START at the controller's floor; static runs serve
    # the configured batch throughout.  A --target-batch below the
    # default floor LOWERS the floor; above it, it is the ceiling.
    floor_tb = min(16, args.target_batch)
    server = FleetServer(
        model,
        window=window,
        channels=channels,
        hop=args.hop,
        smoothing=args.smoothing,
        class_names=class_names,
        config=FleetConfig.for_sessions(
            # churn can hold leavers through their settle while arrivals
            # admit: headroom over the peak
            max(2 * args.sessions, 64),
            target_batch=floor_tb if args.autoscale else args.target_batch,
            max_delay_ms=args.max_delay_ms,
            pipeline_depth=1 if args.autoscale else args.pipeline_depth,
            fused=args.fused,
            profile_host=args.profile_host,
        ),
        fault_hook=fault_hook,
        journal=args.journal,
        journal_config=journal_cfg,
        mesh=None if args.autoscale else mesh,
    )
    controller = None
    if args.autoscale:
        ladder, mesh_for = (1,), None
        if args.mesh and args.mesh > 1:
            from har_tpu_torch.parallel.mesh import create_serving_mesh

            ladder = (1, args.mesh)
            grid = list(mesh.devices.flat)
            mesh_for = lambda d: create_serving_mesh(dp=d, tp=1, devices=grid[:d])  # noqa: E731
        controller = CapacityController(
            server,
            config=AutoscaleConfig(
                min_target_batch=floor_tb,
                # the operator's --target-batch IS the ceiling: the
                # controller may batch smaller, never bigger
                max_target_batch=args.target_batch,
                min_depth=1,
                max_depth=max(args.pipeline_depth, 2),
                mesh_ladder=ladder,
                up_after=1,
                down_after=3,
                cooldown_s=0.0,
            ),
            mesh_for=mesh_for,
        )
    t0 = time.perf_counter()
    events, report = drive_trace(
        server, trace,
        on_round=controller.on_round if controller is not None else None,
    )
    duration = time.perf_counter() - t0
    _raise_device_faults(server)
    snap = server.stats_snapshot()
    acct = snap["accounting"]
    print(json.dumps({
        "trace": spec.kind,
        "trace_spec": trace.spec(),
        "rounds": report.rounds,
        "peak_active": report.peak_active,
        "trough_active": report.trough_active,
        "connects": report.connects,
        "disconnects": report.disconnects,
        "storm_disconnects": report.storm_disconnects,
        "slow_stalls": report.slow_stalls,
        "n_events": len(events),
        "enqueued": acct["enqueued"],
        "scored": acct["scored"],
        "dropped": acct["dropped"],
        "undeclared_drops": undeclared_drops(snap),
        "balanced": acct["balanced"],
        "windows_per_sec": round(acct["scored"] / duration, 1) if duration else None,
        "event_p99_ms": snap["stages"]["event_ms"].get("p99_ms"),
        "autoscale": None if controller is None else controller.status(),
        "resizes": snap["resizes"],
        "scale_ups": snap["scale_ups"],
        "scale_downs": snap["scale_downs"],
        "target_batch_final": server.config.target_batch,
        "pipeline_depth_final": server.config.pipeline_depth,
        "host_profile": snap.get("host_profile"),
        "journal": args.journal,
    }))
    return 0


def _export(args) -> int:
    import os

    from har_tpu_torch.export import _META, _PROGRAM, export_checkpoint

    try:
        out = export_checkpoint(
            args.checkpoint, args.output,
            platforms=tuple(args.platforms),
            example_shape=tuple(args.example_shape) if args.example_shape else None,
            quantize=args.quantize,
        )
    except ValueError as e:
        raise SystemExit(str(e))
    with open(os.path.join(out, _META)) as f:
        art_meta = json.load(f)
    print(json.dumps({
        "artifact": out,
        "bytes": sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out)),
        "program_bytes": os.path.getsize(os.path.join(out, _PROGRAM)),
        "platforms": args.platforms,
        "quantized": art_meta.get("quantization"),
    }))
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


def _sweep(args) -> int:
    from har_tpu_torch.runner import sweep

    config = RunConfig(
        data=DataConfig(dataset=args.dataset, path=args.data_path, seed=args.seed),
        mesh=MeshConfig(dp=args.dp, tp=args.tp),
        output_dir=args.output_dir,
    )
    sweep(config, models=args.models, fractions=tuple(args.fractions),
          with_cv=not args.no_cv, device=args.device)
    return 0


def _parity(args) -> int:
    from har_tpu_torch.parity import parity_run, wisdm_raw_lane

    if args.raw:
        # a skip is rc 0 (nothing to measure), and so is a run that misses
        # the target: the JSON verdict is the result
        print(json.dumps(wisdm_raw_lane(args.data_path, device=args.device)))
        return 0

    config = None
    if args.data_path is not None:
        config = RunConfig(data=DataConfig(dataset="wisdm", path=args.data_path))
    out = parity_run(args.output_dir, config=config, blocks=tuple(args.blocks),
                     device=args.device)
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv[:1] == ["serve-worker"]:
        # forwarded verbatim: the worker subprocess parses its own flags
        # (har_tpu_torch.serve.net.worker) and must not pay for — or
        # depend on — the rest of the CLI surface
        from har_tpu_torch.serve.net.worker import main as _worker_main

        return _worker_main(argv[1:])
    if argv[:1] == ["serve-gateway"]:
        # the same forwarding contract: the gateway fronts workers, parses
        # its own flags and starts without the CLI surface
        from har_tpu_torch.serve.net.gateway import main as _gateway_main

        return _gateway_main(argv[1:])
    if argv[:1] == ["serve-agent"]:
        # the same again: the ship agent is a byte server, no model
        from har_tpu_torch.serve.net.ship import main as _agent_main

        return _agent_main(argv[1:])
    args = _parser().parse_args(argv)
    if args.command == "lint":
        return _lint(args)
    if args.command == "bench":
        from har_tpu_torch.bench import run as _bench

        return _bench(["--device", args.device])
    if args.command == "parity":
        return _parity(args)
    if args.command in ("evaluate", "predict"):
        return _evaluate_or_predict(args)
    if args.command == "finetune":
        return _finetune(args)
    if args.command == "sweep":
        return _sweep(args)
    if args.command == "stream":
        return _stream(args)
    if args.command == "export":
        return _export(args)
    if args.command == "serve":
        from har_tpu_torch.serve.model_parallel import NoTensorParallelForward

        try:
            return _serve(args)
        except NoTensorParallelForward as exc:
            raise SystemExit(
                f"--mesh-shape {args.mesh_shape}: {exc}; serve it batch-sharded "
                "with --mesh N"
            )
    if args.validation_fraction is not None and not args.early_stop_patience:
        raise SystemExit(
            "--validation-fraction only takes effect with "
            "--early-stop-patience; set both or neither"
        )
    from har_tpu_torch.runner import canonical_model_name, run
    from har_tpu_torch.utils.profiling import trace

    device = args.device
    if args.distributed:
        # before the first device use, on every rank
        import os

        import torch.distributed as dist

        from har_tpu_torch.parallel.mesh import initialize_distributed

        device = str(initialize_distributed(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            device=args.device,
        ))
        # every rank writes its report and saved models, rank r > 0 under
        # <dir>/rank_<r>, so ranks that share a directory never write one
        # file together (the training snapshots stay shared: rank 0 writes)
        if dist.get_rank() > 0:
            sub = f"rank_{dist.get_rank()}"
            args.output_dir = os.path.join(args.output_dir, sub)
            if args.save_models_dir:
                args.save_models_dir = os.path.join(args.save_models_dir, sub)
    elif any(getattr(args, k) is not None
             for k in ("coordinator", "num_processes", "process_id")):
        raise SystemExit(
            "--coordinator/--num-processes/--process-id require --distributed"
        )

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
        mesh=MeshConfig(dp=args.dp, tp=args.tp),
        tuning=TuningConfig(selection_metric=args.cv_metric),
        output_dir=args.output_dir,
    )
    try:
        with trace(args.trace_dir, device):
            outcome = run(config, models=models, with_cv=not args.no_cv, device=device,
                          save_models_dir=args.save_models_dir, with_eda=args.eda)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(json.dumps({"accuracies": outcome.accuracies,
                      "artifacts": outcome.report_paths}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
