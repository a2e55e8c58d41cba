"""Warm the teacher's on-disk flow cache for a whole dataset, offline
(port of the repository's ``scripts/precompute_flow.py``).

    python -m imaginaire_tpu_torch.precompute_flow --config CONFIG
        [--split train|val] [--dir DIR] [--limit N] [--chunk PAIRS]
        [--json] [--device cuda|cpu]

Runs the frozen FlowNet2 teacher on every adjacent frame pair of every
sequence of the config's split at the canonical resolution (after the
config's deterministic resizes, before any crop or flip), and writes
the content-addressed ``(flow, conf)`` shards (``flow/cache.py``) that a
training run in the cache's disk or auto mode then hits from its first
epoch. A present shard is skipped, so a second run is all hits and runs
no teacher. The keys and shards are the JAX package's: either package
reads the other's. The teacher runs on the card unless ``--device cpu``.

Refused with exit code 2, as in the JAX script: no cache directory
resolves, the config has no ``flow_network``, the dataset has no frame
sequences, or the augmentations draw a random resize per item
(``random_resize_h_w_aspect``, or ``random_scale_limit`` with
``resize_smallest_side``), which leaves no canonical resolution to warm.
The last line printed is the summary (one JSON object with ``--json``).

A teacher without weights (``flow_network.allow_random_init``) is
identified by its process in the keys: its shards hit only in the
process that wrote them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from imaginaire_tpu_torch.config import Config, cfg_get
from imaginaire_tpu_torch.data.augment import Augmentor, deterministic_resize_chain
from imaginaire_tpu_torch.flow import FlowNet
from imaginaire_tpu_torch.flow.cache import (
    FlowCacheStore,
    _to_nhwc_host,
    flow_cache_settings,
    pair_key,
    resolve_cache_dir,
    teacher_id,
)
from imaginaire_tpu_torch.registry import resolve


def canonicalize_frames(frames, resize_ops, interpolator, normalize):
    """Decoded frames -> (T, Hc, Wc, C) float32 teacher inputs, equal to
    the augmentor's canonical capture (the same resize chain, the same
    /255 and normalize as the dataset)."""
    out = []
    for arr in frames:
        arr = Augmentor._apply(np.asarray(arr), resize_ops, interpolator)
        was_uint8 = arr.dtype == np.uint8
        arr = arr.astype(np.float32)
        if was_uint8:
            arr = arr / 255.0
        if normalize:
            arr = arr * 2.0 - 1.0
        out.append(arr)
    return np.stack(out, axis=0)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Precompute the FlowNet2 teacher flow cache (PyTorch port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--split", choices=("train", "val"), default="train")
    ap.add_argument("--dir", default=None,
                    help="cache directory (default: flow_cache.dir or "
                         "<logdir>/flow_cache)")
    ap.add_argument("--limit", type=int, default=None,
                    help="only the first N sequences")
    ap.add_argument("--chunk", type=int, default=8,
                    help="teacher batch size in frame pairs")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as one JSON line only")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    return ap.parse_args(argv)


def refuse(message):
    print(f"precompute_flow: {message}", file=sys.stderr)
    return 2


def main(argv=None):
    args = parse_args(argv)
    cfg = Config(args.config)
    if args.dir:
        cfg.flow_cache = dict(cfg_get(cfg, "flow_cache", None) or {}, dir=args.dir)
    cache_dir = resolve_cache_dir(cfg)
    if cache_dir is None:
        return refuse("no cache directory resolves: pass --dir or set "
                      "flow_cache.dir / logdir in the config")
    fn_cfg = cfg_get(cfg, "flow_network", None)
    if fn_cfg is None:
        return refuse("the config has no flow_network section (no FlowNet2 "
                      "teacher to amortize)")

    dataset = resolve(cfg.data.type, "Dataset")(cfg, is_inference=(args.split == "val"))
    if not hasattr(dataset, "sequences"):
        return refuse(f"dataset type {cfg.data.type} has no frame sequences")
    image_type = dataset.input_image[0]
    first_root, first_seq, first_stems = dataset.sequences[0]
    probe = dataset.backends[image_type][first_root].getitem(
        f"{first_seq}/{first_stems[0]}")
    resize_ops, canonical_hw, deterministic = deterministic_resize_chain(
        dataset.augmentor.cfg, np.asarray(probe).shape[:2])
    if not deterministic:
        return refuse("the augmentation config draws a random resize per "
                      "sample (random_resize_h_w_aspect / random_scale_limit): "
                      "there is no canonical resolution to warm; drop those "
                      "keys or use producer mode")

    wrapper = FlowNet(weights_path=cfg_get(fn_cfg, "weights_path", None),
                      allow_random_init=cfg_get(fn_cfg, "allow_random_init", False),
                      device=args.device)
    wrapper.init_params(0)
    teacher = teacher_id(wrapper.weights_path)
    store = FlowCacheStore(cache_dir, flow_cache_settings(cfg).store_dtype)
    interpolator = dataset.interpolators.get(image_type)
    normalize = dataset.normalize.get(image_type, False)
    chunk_pairs = max(args.chunk, 1)

    t0 = time.time()
    hits = misses = 0
    sequences = dataset.sequences[:args.limit] if args.limit else dataset.sequences
    for root_idx, seq, stems in sequences:
        todo = []  # (pair index, key)
        for p in range(len(stems) - 1):
            key = pair_key(dataset.name, root_idx, seq, stems[p + 1], stems[p],
                           canonical_hw, teacher)
            if store.has(key):
                hits += 1
            else:
                todo.append((p, key))
        if not todo:
            continue
        misses += len(todo)
        backend = dataset.backends[image_type][root_idx]
        needed = sorted({stems[p] for p, _ in todo} | {stems[p + 1] for p, _ in todo})
        canon = dict(zip(needed, canonicalize_frames(
            [backend.getitem(f"{seq}/{s}") for s in needed], resize_ops,
            interpolator, normalize)))
        for start in range(0, len(todo), chunk_pairs):
            chunk = todo[start:start + chunk_pairs]
            # NHWC frames -> the wrapper's NCHW, target frame first
            im_a = np.stack([canon[stems[p + 1]] for p, _ in chunk]).transpose(0, 3, 1, 2)
            im_b = np.stack([canon[stems[p]] for p, _ in chunk]).transpose(0, 3, 1, 2)
            flow, conf = (_to_nhwc_host(t) for t in wrapper(
                np.ascontiguousarray(im_a), np.ascontiguousarray(im_b)))
            for j, (_, key) in enumerate(chunk):
                store.put(key, flow[j], conf[j])

    total = hits + misses
    summary = {
        "dir": cache_dir,
        "sequences": len(sequences),
        "pairs": total,
        "hits": hits,
        "misses": misses,
        "hit_rate": round(hits / total, 4) if total else 0.0,
        "canonical_hw": list(canonical_hw),
        "duration_s": round(time.time() - t0, 3),
    }
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"precompute_flow: {total} pairs at {canonical_hw[0]}x{canonical_hw[1]} "
              f"-> {cache_dir} ({hits} already cached, {misses} computed, "
              f"{summary['duration_s']}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
