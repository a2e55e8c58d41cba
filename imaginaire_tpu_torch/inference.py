"""Inference entry point (port of the repository's ``inference.py``).

    python -m imaginaire_tpu_torch.inference --config CONFIG --output_dir DIR
        [--checkpoint PATH] [--logdir DIR] [--seed N] [--device cuda|cpu]

Builds the test loader and the trainer, restores the weights through
the verified path (the logdir's pointer with fallback, or an explicit
``--checkpoint``, which is quarantined when it fails to verify and the
newest verifiable checkpoint beside it loads instead), and writes one
PNG a test item through ``trainer.test``. Routing through the serving
engine is not in the port yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os

from imaginaire_tpu_torch.config import Config, cfg_get
from imaginaire_tpu_torch.data import get_test_dataloader
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.train import default_logdir, refuse_unported_runtime


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="imaginaire-tpu (PyTorch port) inference")
    parser.add_argument("--config", required=True)
    parser.add_argument("--checkpoint", default="",
                        help="checkpoint path; default: the logdir's "
                             "latest_checkpoint.txt")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--logdir", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when asked)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = Config(args.config)
    refuse_unported_runtime(cfg)
    logdir = args.logdir or default_logdir(args.config)
    os.makedirs(logdir, exist_ok=True)
    cfg.logdir = logdir

    test_loader = get_test_dataloader(cfg)
    trainer = resolve(cfg.trainer.type, "Trainer")(cfg, device=args.device)
    trainer.init_state(seed=args.seed)
    loaded = trainer.load_checkpoint(args.checkpoint or None,
                                     fallback=bool(args.checkpoint))
    if not loaded:
        print("WARNING: no checkpoint found; running with fresh weights.")
    trainer.current_epoch = trainer.current_iteration = -1
    inference_args = cfg_get(cfg, "inference_args", None)
    trainer.test(test_loader, args.output_dir,
                 dict(inference_args) if inference_args else None)
    print(f"Done with inference. Outputs in {args.output_dir}")
    return trainer


if __name__ == "__main__":
    main()
