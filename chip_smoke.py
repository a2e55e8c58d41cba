#!/usr/bin/env python3
"""Run the PyTorch/H100 port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json PATH]   # from the repository root, one CUDA card

``--json`` also writes the per-shape kernel rows, the main path's
numbers and its profile to PATH.

Phases, one line each; any failure exits non-zero:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compile every kernel of the main path from csrc/ (nvcc, sm_90a);
3. kernels: hold each kernel against its plain PyTorch version at every
   shape the main path gives it, and time both (CUDA events, L2 flushed
   before each launch) beside the card's bound for the same work;
4. main path: the SPADE serving engine at full COCO-Stuff width
   (configs/projects/spade/cocostuff/base128_bs4.yaml with the base norm
   of the SPADE blocks overridden to ``instance``, fresh seeded weights)
   warms bs 1 and 4 and serves 7 requests; the launch counters are reset
   just before and read just after, and the outputs are checked;
5. a ``kernels`` JSON line, the nvidia-smi line, and the final JSON line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs/projects/spade/cocostuff/base128_bs4.yaml"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# (non-tensor-core) flop/s, the rates the modulation kernel can use.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# kernel vs plain version: fp32 max-abs (the reduction order differs);
# bf16 max-abs over the plain output's max magnitude (the plain version
# rounds to bf16 between its steps, the kernel once at the end)
TOL_FP32 = 1e-4
TOL_BF16_REL = 2e-2
# the served image against the same model with the modulation unfused
# (TF32 off): the kernel's rounding carried through ~20 layers
TOL_FUSED_VS_UNFUSED = 1e-3
# a request served alone (bs 1) against its lane in a bs-4 chunk (TF32
# off): cuDNN may pick other algorithms for the two batch sizes
TOL_LANE = 2e-3

# (B, C, H, W) of the 19 SPADE modulations of one bs-4 forward of the
# 256x256 generator at num_filters 128, with their call counts
MODULATION_SHAPES = [
    ((4, 2048, 16, 16), 4),   # head_1, head_2
    ((4, 2048, 32, 32), 2),   # up_0a conv_0 / conv_s
    ((4, 1024, 32, 32), 3),   # up_0a conv_1, up_0b
    ((4, 1024, 64, 64), 2),   # up_1a conv_0 / conv_s
    ((4, 512, 64, 64), 3),    # up_1a conv_1, up_1b
    ((4, 512, 128, 128), 4),  # up_2a, up_2b conv_0 / conv_s
    ((4, 256, 128, 128), 1),  # up_2b conv_1
]
CALLS_PER_FORWARD = sum(n for _, n in MODULATION_SHAPES)
NUM_LABELS = 185  # 183 COCO-Stuff classes + dont-care + edge map
N_REQUESTS = 7


def phase(label, **fields):
    print(json.dumps({"phase": label, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of fn(), L2 flushed (a 64 MiB write) before each
    launch so every call finds its inputs in device memory."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def modulation_bound_ms(shape, n_pairs, elem_bytes):
    """Least time for one call: x, each gamma/beta read once and out
    written once at HBM rate, against ~(7 + 2 n_pairs) fp32 flops per
    element (mean, centred square, normalize, sums, fma) at the fp32
    peak; the larger of the two."""
    numel = int(np.prod(shape))
    bytes_ms = (2 + 2 * n_pairs) * numel * elem_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (7 + 2 * n_pairs) * numel / FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_modulation(spade_mod):
    """Phase 3: kernel vs plain at every main-path shape, n_pairs 1 and 2,
    fp32 and bf16; times at n_pairs 1 fp32 (the main path's case)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows, max_err = [], 0.0
    for shape, calls in MODULATION_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for n_pairs in (1, 2):
                x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
                gs = [(torch.randn(shape, generator=gen, device="cuda") * 0.3).to(dtype)
                      for _ in range(n_pairs)]
                bs = [(torch.randn(shape, generator=gen, device="cuda") * 0.3).to(dtype)
                      for _ in range(n_pairs)]
                got = spade_mod.spade_modulation(x, gs, bs)
                want = spade_mod.spade_modulation_plain(x, gs, bs)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if dtype == torch.float32:
                    max_err = max(max_err, err)
                    ok = err <= TOL_FP32
                else:
                    err = err / want.float().abs().max().item()
                    ok = err <= TOL_BF16_REL
                if not ok:
                    raise AssertionError(f"spade_modulation {shape} {dtype} "
                                         f"n_pairs={n_pairs}: error {err}")
                if dtype == torch.float32 and n_pairs == 1:
                    bound, bound_by = modulation_bound_ms(shape, 1, 4)
                    row = {"shape": list(shape), "calls": calls,
                           "ms": time_ms(lambda: spade_mod.spade_modulation(x, gs, bs)),
                           "plain_ms": time_ms(lambda: spade_mod.spade_modulation_plain(x, gs, bs)),
                           "bound_ms": bound, "bound_by": bound_by,
                           "max_abs_err": err}
                    row["bound_share"] = row["bound_ms"] / row["ms"]
                    rows.append(row)
                    phase("kernel", name="spade_modulation", **row)
                del x, gs, bs, got, want
    torch.cuda.empty_cache()
    return rows, max_err


def one_hot_request(rng, seed):
    from imaginaire_tpu_torch.serving.engine import ServeRequest

    idx = rng.randint(0, NUM_LABELS, (1, 256, 256))
    label = np.zeros((1, 256, 256, NUM_LABELS), np.float32)
    np.put_along_axis(label, idx[..., None], 1.0, axis=-1)
    return ServeRequest({"label": label}, seed=seed)


def set_fused(engine, value):
    from imaginaire_tpu_torch.layers.activation_norm import SpatiallyAdaptiveNorm

    for m in engine.trainer.net_G.modules():
        if isinstance(m, SpatiallyAdaptiveNorm):
            m.fused_modulation = value


def main_path(spade_mod):
    """Phase 4: the serving engine at COCO-Stuff width on the card."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.serving.engine import engine_from_config

    torch.backends.cudnn.allow_tf32 = True  # serving runs the defaults
    cfg = Config(CONFIG)
    cfg.gen.activation_norm_params.activation_norm_type = "instance"
    rng = np.random.RandomState(0)

    spade_mod.launches = 0
    t0 = time.perf_counter()
    engine = engine_from_config(cfg, device="cuda")
    engine.initialize({"label": np.zeros((1, 256, 256, NUM_LABELS), np.float32)},
                      seed=0)
    warm = engine.warm()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    warm_launches = spade_mod.launches
    requests = [one_hot_request(rng, seed=1000 + i) for i in range(N_REQUESTS)]
    t0 = time.perf_counter()
    images = engine.serve(requests)
    serve_s = time.perf_counter() - t0
    launches = spade_mod.launches
    stats = engine.stats()

    chunks = stats["batches"]
    if warm_launches != CALLS_PER_FORWARD * len(warm):
        raise AssertionError(f"warm: {warm_launches} launches for {len(warm)} "
                             f"forwards, expected {CALLS_PER_FORWARD} each")
    if launches - warm_launches != CALLS_PER_FORWARD * chunks or chunks != 2:
        raise AssertionError(f"serve: {launches - warm_launches} launches over "
                             f"{chunks} chunks, expected 2 x {CALLS_PER_FORWARD}")
    for img in images:
        if img.shape != (256, 256, 3) or not np.isfinite(img).all() \
                or np.abs(img).max() > 1.0:
            raise AssertionError(f"bad output {img.shape}, "
                                 f"max {np.abs(img).max()}")

    # correctness on the card, TF32 off: the fused kernel against the
    # plain composition on one chunk, and a lone request against its lane
    torch.backends.cudnn.allow_tf32 = False
    chunk = requests[4:]
    host = {"label": np.concatenate(
        [r.data["label"] for r in chunk]
        + [np.zeros_like(chunk[0].data["label"])])}
    seeds = [r.seed for r in chunk] + [None]
    fused = engine._run(host, seeds)
    set_fused(engine, "none")
    try:
        unfused = engine._run(host, seeds)
    finally:
        set_fused(engine, "auto")
    fused_err = float(np.abs(fused - unfused).max())
    alone = engine._run({"label": chunk[1].data["label"]}, [chunk[1].seed])
    lane_err = float(np.abs(alone[0] - fused[1]).max())
    torch.backends.cudnn.allow_tf32 = True
    breakdown = profile_forward(engine, host, seeds)
    if fused_err > TOL_FUSED_VS_UNFUSED or lane_err > TOL_LANE:
        raise AssertionError(f"fused vs unfused {fused_err} (tol "
                             f"{TOL_FUSED_VS_UNFUSED}), lane {lane_err} "
                             f"(tol {TOL_LANE})")
    row = {"setup_s": setup_s, "warm_ms": warm, "requests": N_REQUESTS,
           "chunks": chunks, "serve_s": serve_s,
           "requests_per_s": N_REQUESTS / serve_s,
           "chunk_ms": stats["exec_ms"], "p50_ms": stats["p50_ms"],
           "p99_ms": stats["p99_ms"], "launches": launches,
           "launches_per_forward": CALLS_PER_FORWARD,
           "fused_vs_unfused_max_abs": fused_err, "lane_max_abs": lane_err,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "forward": breakdown}
    phase("main_path", **row)
    return row


_FAMILIES = (("spade_modulation", ("spade_modulation",)),
             ("copies", ("Memcpy", "Memset")),
             ("conv", ("conv", "xmma", "cudnn", "implicit", "winograd", "fprop",
                       "cutlass", "sm90")),
             ("gemv/gemm", ("gemv", "gemm", "dot")))


def profile_forward(engine, host, seeds, repeats=5):
    """Where one bs-4 serving forward's time goes (TF32 on, as served):
    host-clock ms of ``repeats`` forwards (each ends in a device sync and
    the copy back), then one forward under torch.profiler with its
    device time summed by kernel family; idle share = 1 - device / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        engine._run(host, seeds)
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine._run(host, seeds)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            kernels[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    families = {}
    for name, (ms, _) in kernels.items():
        family = next((f for f, keys in _FAMILIES
                       if any(k.lower() in name.lower() for k in keys)), "other")
        families[family] = families.get(family, 0.0) + ms
    device_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"wall_ms": walls, "profiled_wall_ms": wall_ms,
            "device_ms": device_ms if kernels else "not measured",
            "idle_share": 1 - device_ms / wall_ms if kernels else "not measured",
            "families_ms": families,
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                            for n, (ms, c) in top]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None,
                        help="also write the detailed results here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from imaginaire_tpu_torch.ops import build
    from imaginaire_tpu_torch.ops import spade_modulation as spade_mod

    smi = nvidia_smi()
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    libs = build.build_all([spade_mod.KERNEL])
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for line in
             Path(f"{libs[spade_mod.KERNEL]}.log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    phase("build", seconds=build_s, libraries=[str(p) for p in libs.values()],
          ptxas=ptxas)

    rows, max_err = check_modulation(spade_mod)
    main = main_path(spade_mod)

    per_forward = {key: sum(r[key] * r["calls"] for r in rows)
                   for key in ("ms", "plain_ms", "bound_ms")}
    kernels = [{
        "name": "spade_modulation", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/spade_modulation.cu",
        "replaces": "imaginaire_tpu/ops/pallas/spade_modulation_kernel.py:87",
        "launches": main["launches"], "max_abs_err": max_err,
        # the 19 calls of one bs-4 generator forward, fp32, n_pairs 1
        "ms": per_forward["ms"], "plain_ms": per_forward["plain_ms"],
        "bound_ms": per_forward["bound_ms"],
        "bound_by": max(rows, key=lambda r: r["bound_ms"] * r["calls"])["bound_by"],
        "library_ms": None}]
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"nvidia_smi": smi, "build_s": build_s, "ptxas": ptxas,
             "modulation": rows, "main_path": main, "kernels": kernels},
            indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
