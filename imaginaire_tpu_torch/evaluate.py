"""Evaluation entry point (port of the repository's ``evaluate.py``).

    python -m imaginaire_tpu_torch.evaluate --config CONFIG
        (--checkpoint_logdir DIR | --checkpoint PATH) [--logdir DIR]
        [--seed N] [--metrics fid[,kid,prdc]] [--device cuda|cpu]

Builds the loaders and the trainer (the training loader feeds the
averaged copy's BatchNorm re-estimation, the validation loader the
metrics), then walks the checkpoints of ``--checkpoint_logdir`` oldest
first (committed checkpoint directories only: quarantined ``*.corrupt``
ones, temporaries and sidecars never enter the sweep), or the one
``--checkpoint``. Each is restored through the verified path
(``utils/checkpoint.py``); one whose bytes fail to verify or load is
quarantined and skipped, and the sweep goes on (an error that says
nothing about the checkpoint, such as a device fault, propagates). Each
restored checkpoint gets FID and FID_ema (``trainer.write_metrics``)
and, when asked, KID and PRDC (``trainer.compute_extra_metrics``), all
into ``<logdir>/meters.jsonl`` at the checkpoint's iteration.

FID runs through ``write_metrics``, the JAX entry's fallback path: its
continuous-evaluation plane and reference-feature store
(``imaginaire_tpu/evaluation/plane.py``, ``feature_store.py``) are not in
the port (ROADMAP.md A.8). Without ``weights/inception_v3.npz`` the
metrics need ``trainer.fid_random_init``, and then measure nothing about
image quality.

``main`` returns one dict a evaluated checkpoint: its path, epoch,
iteration and metrics.
"""

from __future__ import annotations

import argparse
import os

from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data import get_train_and_val_dataloader
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.train import default_logdir, refuse_unported_runtime
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib

METRICS = ("fid", "kid", "prdc")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="imaginaire-tpu (PyTorch port) evaluation")
    parser.add_argument("--config", required=True)
    parser.add_argument("--logdir", default=None,
                        help="dir for the evaluation's meters and caches")
    parser.add_argument("--checkpoint_logdir", default=None,
                        help="dir whose checkpoints are each evaluated")
    parser.add_argument("--checkpoint", default=None,
                        help="evaluate one specific checkpoint")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--metrics", default="fid",
                        help="comma list of metrics: fid[,kid,prdc]")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when asked)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    metrics = [m.strip().lower() for m in args.metrics.split(",") if m.strip()]
    unknown = set(metrics) - set(METRICS)
    if unknown:
        raise SystemExit(f"unknown --metrics {sorted(unknown)}; supported: "
                         f"{', '.join(METRICS)}")
    if not args.checkpoint and not args.checkpoint_logdir:
        raise SystemExit("pass --checkpoint or --checkpoint_logdir")
    cfg = Config(args.config)
    refuse_unported_runtime(cfg)
    logdir = args.logdir or default_logdir(args.config)
    os.makedirs(logdir, exist_ok=True)
    cfg.logdir = logdir

    train_loader, val_loader = get_train_and_val_dataloader(cfg, seed=args.seed)
    trainer = resolve(cfg.trainer.type, "Trainer")(
        cfg, device=args.device, train_data_loader=train_loader,
        val_data_loader=val_loader)
    trainer.init_state(seed=args.seed)
    if args.checkpoint:
        checkpoints = [args.checkpoint]
    else:
        checkpoints = [path for _, _, path in
                       ckpt_lib.scan_checkpoints(args.checkpoint_logdir)]

    results = []
    for checkpoint in checkpoints:
        try:
            trainer.load_checkpoint(checkpoint)
        except Exception as e:  # noqa: BLE001 -- sorted by is_corrupt_checkpoint_error
            if not ckpt_lib.is_corrupt_checkpoint_error(e):
                raise
            print(f"WARNING: skipping {checkpoint}: restore failed "
                  f"({type(e).__name__}: {str(e)[:200]}); quarantining")
            ckpt_lib.quarantine_checkpoint(checkpoint,
                                           reason=f"eval restore failed: {type(e).__name__}")
            continue
        trainer.current_epoch, trainer.current_iteration = \
            ckpt_lib.parse_checkpoint_name(checkpoint)
        print(f"Evaluating {checkpoint} (epoch {trainer.current_epoch}, "
              f"iteration {trainer.current_iteration})")
        row = {"checkpoint": str(checkpoint), "epoch": trainer.current_epoch,
               "iteration": trainer.current_iteration}
        if "fid" in metrics:
            fid = trainer.write_metrics()
            if fid is not None:
                row.update(FID=fid, best_FID=trainer.best_fid)
                if trainer.fid_ema is not None:
                    row["FID_ema"] = trainer.fid_ema
        extra_requested = [m for m in metrics if m != "fid"]
        extra = trainer.compute_extra_metrics(extra_requested)
        if extra_requested and not extra:
            raise SystemExit(
                f"--metrics {','.join(extra_requested)} requested but "
                f"{type(trainer).__module__} produced none (unsupported for "
                "this trainer, or no Inception-v3 weights)")
        row.update(extra)
        for name, value in row.items():
            if isinstance(value, float):
                print(f"  {name}: {value:.5f}")
        results.append(row)
    print("Done with evaluation!!!")
    return results


if __name__ == "__main__":
    main()
