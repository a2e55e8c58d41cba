#!/usr/bin/env python3
"""Where the port's flow kernels spend their time, on one NVIDIA GPU.

    python3 scripts/torch_kernel_probe.py [--json PATH]

Two measurements, each timed in turns (the cases in order, then in
reverse) with chip_smoke.py's timer:

1. The timer's own cost: channelnorm and torch.linalg.vector_norm at one
   frame pair (C = 3 and 2, fp32), each under chip_smoke.time_ms (the L2
   flushed by a 64 MiB write before each launch) and under the same timer
   with a read flush (a reduction over the buffer, which leaves the L2
   clean).
2. Variants of the correlation kernel at FlowNetC's shapes (one frame
   pair and the teacher attach's six, fp32). The variants that edit
   ``imaginaire_tpu_torch/csrc/correlation.cu`` compute wrong outputs by
   design, except ``cvt_round``; that one and those that change only the
   tile plan are held to the plain version:

   - as_built: the kernel as it is, under ``tile_plan``'s plan;
   - cvt_round: the TF32 rounding by ``cvt.rna.tf32.f32`` instead of the
     kernel's two integer ops (the same rounding);
   - one_product: plain TF32, one product instead of the 3xTF32 split;
   - no_mma: every fragment loaded and split, no tensor-core product;
   - staging_only: the cp.async staging and the epilogue, no fragment
     loads and no products;
   - one_row: the kernel as it is under a plan of one row a block (8
     warps) and a ring of 3 stages of 8 channels, so two blocks share an
     SM;
   - ring_3x8, ring_2x8: the kernel as it is with a ring of 3 or 2
     stages of 8 channels.

   A variant whose edit no longer matches the source raises. The plans
   are launched through the kernel's C interface, which checks them.

Imports nothing of JAX. Needs nvcc and a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the timer, the shapes and the card's line)
from imaginaire_tpu_torch.ops import build  # noqa: E402
from imaginaire_tpu_torch.ops import channelnorm as cn  # noqa: E402
from imaginaire_tpu_torch.ops import correlation as corr  # noqa: E402

SHAPES = [chip_smoke.CORR_PAIR_SHAPE, chip_smoke.CORR_PATH_SHAPE]
MD, S2 = chip_smoke.FLOWNETC["max_displacement"], chip_smoke.FLOWNETC["stride2"]
THREE = """            mma_tf32(acc[g][t], a_lo, b0h, b1h);
            mma_tf32(acc[g][t], a_hi, b0l, b1l);
            mma_tf32(acc[g][t], a_hi, b0h, b1h);"""
# name -> (edits of the source, changes to tile_plan's free choices)
VARIANTS = {
    "as_built": ([], {}),
    "cvt_round": ([(
        "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
        """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(v));
  return r;""")], {}),
    "one_product": ([(THREE, "            mma_tf32(acc[g][t], a_hi, b0h, b1h);")], {}),
    "no_mma": ([(THREE, """            acc[g][t][0] += __uint_as_float(a_lo[0] ^ a_hi[1] ^ b0h ^ b0l);
            acc[g][t][1] += __uint_as_float(a_lo[2] ^ a_hi[3] ^ b1h ^ b1l);""")], {}),
    "staging_only": ([(
        "    if (!(unit_ok[0] || unit_ok[1] || unit_ok[2])) continue;",
        "    continue;")], {}),
    "one_row": ([], {"rows": 1, "stages": 3, "chunk": 8}),
    "ring_3x8": ([], {"stages": 3, "chunk": 8}),
    "ring_2x8": ([], {"stages": 2, "chunk": 8}),
}


def time_ms_read_flush(fn, iters=50, warmup=3):
    """chip_smoke.time_ms with the L2 flushed by a read of the buffer."""
    words = torch.empty(16 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        words.sum()
        torch.cuda._sleep(chip_smoke.SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def probe_timer(gen):
    timers = {"write": lambda fn: chip_smoke.time_ms(fn, iters=50),
              "read": time_ms_read_flush}
    rows = []
    for c in (3, 2):
        x = torch.randn((1, c, 512, 1024), generator=gen, device="cuda")
        fns = {"channelnorm": lambda: cn.channelnorm(x),
               "vector_norm": lambda: torch.linalg.vector_norm(
                   x, 2, dim=1, keepdim=True)}
        for name, fn in fns.items():
            times = {"write": [], "read": []}
            for mode in ("write", "read", "read", "write"):
                times[mode].append(timers[mode](fn))
            rows.append({"probe": "timer", "kernel": name,
                         "shape": [1, c, 512, 1024], "ms": times})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def variant_plan(shape, free):
    """tile_plan's plan with some of its free choices (rows, stages,
    chunk) replaced, and the fields that follow from them recomputed."""
    plan = corr.tile_plan(shape, MD, S2)
    if not free:
        return plan
    plan.update(free)
    h = shape[2]
    per_channel = 4 * (plan["rows"] * plan["stride_x1"]
                       + (plan["rows"] + plan["dys"] - 1) * plan["stride_x2"])
    epilogue = 4 * plan["rows"] * plan["dys"] * plan["dx_per_group"] * plan["tile_w"]
    plan["threads"] = 32 * plan["rows"] * S2 * plan["m_tiles"]
    plan["smem_bytes"] = max(plan["stages"] * plan["chunk"] * per_channel, epilogue)
    plan["y_blocks"] = S2 * corr._ceil(corr._ceil(h, S2), plan["rows"])
    plan["grid_x"] = (plan["x_tiles"] * plan["dx_groups"] * plan["dy_groups"]
                      * plan["y_blocks"])
    return plan


def build_variant(name, edits, out_dir):
    source = build.source_path(corr.KERNEL).read_text()
    for old, new in edits:
        if source.count(old) != 1:
            raise RuntimeError(f"variant {name}: the kernel source no longer "
                               f"holds {old!r} once")
        source = source.replace(old, new)
    src = out_dir / f"{name}.cu"
    lib = out_dir / f"lib{name}.so"
    src.write_text(source)
    done = subprocess.run(build.nvcc_command(build.find_nvcc(), src, lib),
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"variant {name} did not build:\n{done.stdout}{done.stderr}")
    regs = [line.strip() for line in (done.stdout + done.stderr).splitlines()
            if "registers" in line or "spill" in line]
    lib = ctypes.CDLL(str(lib))
    lib.correlation_fwd.restype = ctypes.c_int
    return lib, regs


def launch(lib, x1, x2, out, plan):
    """One call of the kernel's C interface (fp32) under ``plan``."""
    b, c, h, w = x1.shape
    fields = (ctypes.c_int * len(corr.PLAN_FIELDS))(
        *(plan[k] for k in corr.PLAN_FIELDS))
    err = lib.correlation_fwd(
        ctypes.c_void_p(x1.data_ptr()), ctypes.c_void_p(x2.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_longlong(b),
        ctypes.c_longlong(c), ctypes.c_longlong(h), ctypes.c_longlong(w),
        MD, S2, 0, fields,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"correlation variant launch failed: CUDA error {err}")


def probe_correlation(gen, out_dir):
    libs = {name: build_variant(name, edits, out_dir)
            for name, (edits, _) in VARIANTS.items()}
    order = list(VARIANTS) + list(reversed(VARIANTS))
    rows = []
    for shape in SHAPES:
        x1 = torch.randn(shape, generator=gen, device="cuda")
        x2 = torch.randn(shape, generator=gen, device="cuda")
        want = corr.correlation_plain(x1, x2, **chip_smoke.FLOWNETC)
        out = torch.empty_like(want)
        plans = {name: variant_plan(shape, free)
                 for name, (_, free) in VARIANTS.items()}
        times = {name: [] for name in VARIANTS}
        for name in order:
            lib = libs[name][0]
            times[name].append(chip_smoke.time_ms(
                lambda: launch(lib, x1, x2, out, plans[name])))
        for name, (edits, free) in VARIANTS.items():
            row = {"probe": "correlation", "variant": name, "shape": list(shape),
                   "ms": times[name], "plan": {k: plans[name][k] for k in
                                               ("rows", "stages", "chunk", "smem_bytes")},
                   "ptxas": libs[name][1]}
            if name == "cvt_round" or not edits:  # held to the plain version
                launch(libs[name][0], x1, x2, out, plans[name])
                row["max_abs_err"] = (out - want).abs().max().item()
                if row["max_abs_err"] > chip_smoke.TOL_CORR_FP32:
                    raise AssertionError(f"variant {name} disagrees with the "
                                         f"plain version: {row}")
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2468)
    with torch.no_grad(), tempfile.TemporaryDirectory() as tmp:
        rows = probe_timer(gen) + probe_correlation(gen, Path(tmp))
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
