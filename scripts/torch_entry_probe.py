#!/usr/bin/env python3
"""Where the training entry's host time goes, on one CUDA card.

    python3 scripts/torch_entry_probe.py [--iters N] [--items N] [--json PATH]
    python3 scripts/torch_entry_probe.py --entry-phase [--json PATH]

Builds the port's SPADE trainer at COCO-Stuff width (the config and
overrides of ``chip_smoke.py`` phase 8, batch 4, 256x256, bf16) over a
seeded packed dataset of ``--items`` 300x320 items, then times D+G
iterations (host clock, each ending in a device sync) in turns:

- ``idle``: the steps on one batch already on the card, no loader;
- ``workers_8`` / ``workers_2``: the loop of ``imaginaire_tpu_torch.train``
  (next batch from the loader, ``start_of_iteration``, the steps) with the
  loader's read-ahead on 8 (the config's) or 2 threads;
- ``workers_0``: the same loop with the items loaded on the calling
  thread, nothing overlapped.

Each mode runs twice, in the order idle, 8, 2, 0, 0, 2, 8, idle, after
two warm-up iterations. It prints one JSON line a mode (median
iteration, data wait and step time) and the card's name and power limit.

``--entry-phase`` instead runs ``chip_smoke.py``'s phase 8 on its own in
a fresh process (none of phases 1-7 before it) and prints its row, to
hold against the same phase inside the whole script.
GPU only; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=8, help="iterations a turn")
    parser.add_argument("--items", type=int, default=64)
    parser.add_argument("--json", type=Path, default=None)
    parser.add_argument("--entry-phase", action="store_true",
                        help="run chip_smoke.py's phase 8 alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_entry_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke
    if args.entry_phase:
        from imaginaire_tpu_torch.ops import spade_modulation as spade_mod

        row = chip_smoke.spade_train_entry(spade_mod)
        smi = chip_smoke.nvidia_smi()
        print(smi)
        if args.json is not None:
            args.json.parent.mkdir(parents=True, exist_ok=True)
            args.json.write_text(json.dumps({"nvidia_smi": smi, "entry": row}, indent=1))
        return 0
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.data import get_train_and_val_dataloader
    from imaginaire_tpu_torch.trainers.spade import Trainer

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    with tempfile.TemporaryDirectory(prefix="torch_entry_probe_") as tmp:
        tmp = Path(tmp)
        packed = chip_smoke.write_entry_dataset(tmp, items=args.items)
        cfg = Config(chip_smoke.entry_config(tmp, packed))
        trainer = Trainer(cfg, device="cuda", train=True)
        trainer.init_state(seed=0)
        loaders = {}
        for workers in (8, 2, 0):
            loader, _ = get_train_and_val_dataloader(cfg, seed=0)
            loader.num_workers = workers
            loaders[workers] = loader

        def epochs(loader):
            epoch = 0
            while True:
                loader.set_epoch(epoch)
                yield from loader
                epoch += 1

        feeds = {w: epochs(loader) for w, loader in loaders.items()}
        fixed = trainer.start_of_iteration(next(feeds[0]), 0)

        def iteration(mode):
            t0 = time.perf_counter()
            if mode == "idle":
                data = fixed
            else:
                data = trainer.start_of_iteration(next(feeds[int(mode.split("_")[1])]), 0)
            t1 = time.perf_counter()
            trainer.dis_update(data)
            trainer.gen_update(data)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            return (t2 - t0) * 1e3, (t1 - t0) * 1e3, (t2 - t1) * 1e3

        for mode in ("idle", "workers_8", "workers_2", "workers_0"):
            for _ in range(2):
                iteration(mode)  # warm up every feed
        order = ["idle", "workers_8", "workers_2", "workers_0"]
        results = {mode: [] for mode in order}
        for mode in order + order[::-1]:
            results[mode] += [iteration(mode) for _ in range(args.iters)]
        for mode, samples in results.items():
            wall, wait, step = (np.asarray(x) for x in zip(*samples))
            rows.append({"mode": mode, "iterations": len(samples),
                         "median_iteration_ms": float(np.median(wall)),
                         "images_per_s": 4 / (float(np.median(wall)) / 1e3),
                         "median_data_wait_ms": float(np.median(wait)),
                         "median_step_ms": float(np.median(step)),
                         "iteration_ms": wall.tolist()})
            print(json.dumps({k: v for k, v in rows[-1].items() if k != "iteration_ms"}))
    smi = chip_smoke.nvidia_smi()
    print(smi)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
