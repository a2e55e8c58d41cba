"""Training entry point (port of the repository's ``train.py``).

    python -m imaginaire_tpu_torch.train --config CONFIG [--logdir DIR]
        [--checkpoint PATH] [--seed N] [--max_iter N] [--device cuda|cpu]

Config, loaders, trainer (``iters_per_epoch = len(train_loader)``), the
first batch, ``init_state``, then the checkpoint: an explicit
``--checkpoint`` loads its weights; otherwise the logdir's
``latest_checkpoint.txt`` resumes the run (verified, falling back to the
newest checkpoint that verifies), and the first resumed epoch
fast-forwards the loader past the batches the interrupted run already
trained on. Then the epoch loop of D and G steps; a checkpoint is saved
at ``max_iter``.

With ``trainer.speed_benchmark`` set, each iteration appends to
``trainer.timings`` the host's ``loader_wait`` (for the loader's next
batch), ``data_wait`` (that plus ``start_of_iteration``: the host hook,
pinning and the copies' launch) and the iteration's host time; ``main``
returns the trainer.

The validation loader goes to the trainer: at each ``snapshot_save_iter``
checkpoint ``write_metrics`` computes FID over it (``evaluation/``).

The JAX package's mesh, elastic pods, cluster coordination, chaos
injection, preemption guard, telemetry, continuous evaluation
(``evaluation.every_n_iter``) and vid2vid's whole-rollout scan
(``trainer.rollout_scan``) are not in the port: a config that enables
one of them raises. vid2vid's pipelined rollout (``trainer.pipeline``)
runs as the sequential rollout, which the JAX package defines as
bit-identical to it. Each epoch starts with ``trainer.start_of_epoch``
(vid2vid's sequence-length curriculum sets the dataset's length there)
and only then iterates the loader, whose read-ahead starts with the
iteration.
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import datetime

from imaginaire_tpu_torch.config import Config, cfg_get
from imaginaire_tpu_torch.data import get_train_and_val_dataloader
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.utils.meters import add_hparams


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="imaginaire-tpu (PyTorch port) training")
    parser.add_argument("--config", required=True)
    parser.add_argument("--logdir", default=None)
    parser.add_argument("--checkpoint", default="")
    parser.add_argument("--seed", type=int, default=2)
    parser.add_argument("--max_iter", type=int, default=None,
                        help="override the config's max_iter")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu only when asked)")
    return parser.parse_args(argv)


def default_logdir(config_path, root="logs"):
    stem = os.path.splitext(os.path.basename(config_path))[0]
    return os.path.join(root, f"{datetime.now().strftime('%Y_%m%d_%H%M_%S')}_{stem}")


def refuse_unported_runtime(cfg):
    """Raise for each runtime plane of the JAX package that the config
    enables and the port lacks, and for the integrity checks it turns
    off, which the port does not."""
    def enabled(section, key="enabled"):
        return cfg_get(cfg_get(cfg, section, None) or {}, key, None)

    resilience = cfg_get(cfg, "resilience", None) or {}
    guarded = bool(cfg_get(resilience, "enabled", True))
    checks = {
        "parallel.mesh_shape": enabled("parallel", "mesh_shape") is not None,
        "runtime.mesh.shape": cfg_get(cfg_get(cfg_get(cfg, "runtime", None) or {},
                                              "mesh", None) or {}, "shape", None) is not None,
        "resilience.elastic.enabled": bool(cfg_get(cfg_get(resilience, "elastic", None)
                                                   or {}, "enabled", False)),
        "resilience.cluster.enabled": cfg_get(cfg_get(resilience, "cluster", None) or {},
                                              "enabled", "auto") not in ("auto", False),
        "resilience.emergency_checkpoint": guarded and bool(
            cfg_get(resilience, "emergency_checkpoint", False)),
        "chaos.enabled": bool(enabled("chaos")),
        "telemetry.enabled": bool(enabled("telemetry")),
        "evaluation.every_n_iter": bool(enabled("evaluation", "every_n_iter")),
        "trainer.rollout_scan": bool(cfg_get(cfg_get(cfg, "trainer", None) or {},
                                             "rollout_scan", False)),
    }
    bad = [key for key, on in checks.items() if on]
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: not in the port yet (ROADMAP.md); disable "
            "them to train with imaginaire_tpu_torch")
    unchecked = [key for key, on in (
        ("resilience.enabled", not guarded),
        ("resilience.checksum", not cfg_get(resilience, "checksum", True)),
        ("resilience.verify_on_load", not cfg_get(resilience, "verify_on_load", True)),
    ) if on]
    if unchecked:
        raise NotImplementedError(
            f"{', '.join(unchecked)} set false: the port always checksums a "
            "checkpoint when it saves one and verifies it when it loads; "
            "remove these settings")


def main(argv=None):
    args = parse_args(argv)
    cfg = Config(args.config)
    if args.max_iter is not None:
        cfg.max_iter = args.max_iter
    refuse_unported_runtime(cfg)
    logdir = args.logdir or default_logdir(args.config)
    os.makedirs(logdir, exist_ok=True)
    cfg.logdir = logdir

    train_loader, val_loader = get_train_and_val_dataloader(cfg, seed=args.seed)
    trainer = resolve(cfg.trainer.type, "Trainer")(
        cfg, device=args.device, train=True, iters_per_epoch=len(train_loader),
        train_data_loader=train_loader, val_data_loader=val_loader)
    add_hparams(trainer.writer, {
        "trainer": str(cfg.trainer.type),
        "gen": str(cfg.gen.type),
        "gen_lr": float(cfg_get(cfg.gen_opt, "lr", 0)),
        "dis_lr": float(cfg_get(cfg.dis_opt, "lr", 0)),
        "batch_size": int(cfg_get(cfg.data.train, "batch_size", 1)),
        "compute_dtype": str(trainer.compute_dtype).removeprefix("torch."),
        "seed": args.seed,
    }, {"metrics/placeholder": 0.0})

    sample = next(iter(train_loader))
    trainer.start_of_iteration(sample, 0)
    trainer.init_state(seed=args.seed)
    if args.checkpoint:
        trainer.load_checkpoint(args.checkpoint)
    else:
        trainer.load_checkpoint()  # resume from the pointer file if present

    current_iteration = trainer.current_iteration
    current_epoch = trainer.current_epoch
    resume_offset = int(trainer.resume_batch_in_epoch or 0)
    max_iter = cfg_get(cfg, "max_iter", 1000000)
    max_epoch = cfg_get(cfg, "max_epoch", 200)
    dis_steps = cfg_get(cfg.trainer, "dis_step", 1)
    gen_steps = cfg_get(cfg.trainer, "gen_step", 1)
    for epoch in range(current_epoch, max_epoch):
        print(f"Epoch {epoch} ...")
        train_loader.set_epoch(epoch)
        trainer.start_of_epoch(epoch)
        if resume_offset:
            train_loader.fast_forward(resume_offset)
            print(f"Resume: fast-forwarding {resume_offset} already-consumed "
                  f"batch(es) of epoch {epoch}")
            resume_offset = 0
        last = None
        t0 = time.perf_counter()
        for data in train_loader:
            loader_wait = time.perf_counter() - t0
            data = trainer.start_of_iteration(data, current_iteration)
            if trainer.speed_benchmark:
                trainer.timings["loader_wait"].append(loader_wait)
                trainer.timings["data_wait"].append(time.perf_counter() - t0)
            for _ in range(dis_steps):
                trainer.dis_update(data)
            for _ in range(gen_steps):
                trainer.gen_update(data)
            current_iteration += 1
            trainer.end_of_iteration(data, epoch, current_iteration)
            if current_iteration >= max_iter:
                print("Done with training!!!")
                trainer.save_checkpoint(epoch, current_iteration)
                return trainer
            last = data
            t0 = time.perf_counter()
        if last is None:
            # resumed exactly at an epoch boundary: nothing to replay
            continue
        trainer.end_of_epoch(last, epoch, current_iteration)
    print("Done with training!!!")
    return trainer


if __name__ == "__main__":
    main()
