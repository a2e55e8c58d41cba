#!/usr/bin/env python3
"""The port's checkpoint save and verified load, timed for two source trees
on one CUDA card.

    python3 scripts/torch_checkpoint_io.py --trees OLD . . OLD \\
        [--gib 3.0 7.3] [--repeats 2] [--json PATH]

Each ``--trees`` entry is the root of a checkout of this repository (for
example a ``git archive`` of an older commit); each runs in a fresh
process that imports ``imaginaire_tpu_torch`` from that root, so two
versions of ``utils/checkpoint.py`` and ``resilience/integrity.py`` are
compared on the same card, disk and host. Name a tree twice, in the order
old, new, new, old, to see the drift between turns.

For each ``--gib`` size a process builds a seeded state on the card (fp32
tensors of 3x3 convolution weights between 64 and 1024 channels and
their biases, one bf16 tensor, two int64 counters and a generator's RNG
state), then ``--repeats`` times:

- ``save_s``: ``save_checkpoint`` of the device state (its host copies,
  the file, its digest and the tensors' records), as a trainer calls it;
- ``load_s``: ``load_checkpoint`` (files' digests, the load, the tensors'
  records) and a ``copy_`` of every tensor into the device state, as
  ``load_state_tensors`` does; a tree whose ``load_checkpoint`` takes
  ``map_location`` is handed the card, as its trainer did.

Then, once, the parts: the host copies (``to_host_s``), ``tree_checksums``
of them (``tree_checksums_s``), reading the saved file back to digest it
(``file_digests_s``) and ``verify_tree`` over the device tensors and over
the host copies (``verify_tree_device_s`` / ``verify_tree_host_s``). The
file's reads are warm: the page cache is not dropped. Prints one JSON
line a tree and size, and the card's name and power limit. GPU only; it
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

CHANNELS = (64, 128, 256, 512, 1024)


def seeded_state(gib, seed=0):
    """About ``gib`` GiB of tensors on the card, from ``seed``."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    state, total, i = {}, 0, 0
    while total < gib * 2**30:
        cin, cout = (int(c) for c in rng.choice(CHANNELS, 2))
        for name, shape in (("weight", (cout, cin, 3, 3)), ("bias", (cout,))):
            t = torch.randn(shape, generator=gen, device="cuda")
            state[f"net/{i}/{name}"] = t
            total += t.numel() * 4
        i += 1
    state["net/bf16"] = torch.randn((1024, 1024), generator=gen,
                                    device="cuda").bfloat16()
    state["opt/count"] = torch.tensor(7)
    state["num_updates"] = torch.tensor(11)
    state["rng"] = torch.Generator().manual_seed(seed).get_state()
    return state


def timed(fn, *args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def one_tree(tree, sizes, repeats):
    sys.path.insert(0, str(Path(tree).resolve()))
    from imaginaire_tpu_torch.resilience import integrity
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib

    root = Path(ckpt_lib.__file__).resolve().parents[2]
    if root != Path(tree).resolve():
        raise RuntimeError(f"imported {ckpt_lib.__file__}, not from {tree}")
    hands_device = "map_location" in inspect.signature(ckpt_lib.load_checkpoint).parameters

    def load_into(path, state):
        if hands_device:
            payload = ckpt_lib.load_checkpoint(path, map_location="cuda")
        else:
            payload = ckpt_lib.load_checkpoint(path)
        for key, dst in state.items():
            if dst.is_cuda:
                dst.copy_(payload["state"][key])

    rows = []
    for gib in sizes:
        state = seeded_state(gib)
        nbytes = sum(t.numel() * t.element_size() for t in state.values())
        row = {"tree": str(tree), "gib": gib, "state_bytes": nbytes,
               "tensors": len(state), "load_takes_map_location": hands_device,
               "save_s": [], "load_s": []}
        with tempfile.TemporaryDirectory(prefix="torch_checkpoint_io_") as logdir:
            for r in range(repeats):
                path, s = timed(ckpt_lib.save_checkpoint, logdir, state, {"epoch": 0},
                                0, r + 1, max_to_keep=1)
                row["save_s"].append(s)
                row["load_s"].append(timed(load_into, path, state)[1])
            row["file_bytes"] = sum(f.stat().st_size for f in Path(path).rglob("*")
                                    if f.is_file())
            host, row["to_host_s"] = timed(lambda: {k: v.detach().cpu()
                                                    for k, v in state.items()})
            record, row["tree_checksums_s"] = timed(integrity.tree_checksums, host)
            row["file_digests_s"] = timed(integrity.file_digests, path)[1]
            row["verify_tree_device_s"] = timed(integrity.verify_tree, state, record)[1]
            row["verify_tree_host_s"] = timed(integrity.verify_tree, host, record)[1]
        del state, host
        torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def nvidia_smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", default=["."])
    parser.add_argument("--gib", type=float, nargs="+", default=[3.0, 7.3])
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--json", type=Path, default=None)
    parser.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_checkpoint_io: no CUDA device available", file=sys.stderr)
        return 2
    if args.one is not None:
        one_tree(args.one, args.gib, args.repeats)
        return 0
    rows = []
    for tree in args.trees:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", tree, "--repeats",
             str(args.repeats), "--gib", *map(str, args.gib)],
            capture_output=True, text=True)
        if run.returncode:
            print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        for line in run.stdout.splitlines():
            if line.startswith("{"):
                rows.append(json.loads(line))
                print(line, flush=True)
    smi = nvidia_smi()
    print(smi)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
