#!/usr/bin/env python3
"""Where the port's kernels spend their time, on one NVIDIA GPU.

    python3 scripts/torch_kernel_probe.py [--json PATH] [--probes NAMES]
        [--resample-baseline SOURCE] [--correlation-baseline SOURCE]
        [--modulation-baseline SOURCE]

Five measurements (``--probes``, default all five: timer, correlation,
resample2d, resample2d_bwd, modulation), each timed in turns (the cases
in order, then in reverse) with chip_smoke.py's timer:

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
     stages of 8 channels;
   - baseline: an earlier kernel source under the same plan, given by
     ``--correlation-baseline`` (its C interface must read the plan's
     fields in the order of ``PLAN_FIELDS``; it may read fewer of them,
     as PR 4's 18-field kernel does); skipped without it.

   A variant whose edit no longer matches the source raises. The plans
   are launched through the kernel's C interface, which checks them.
3. Variants of the resample2d kernel at the vid2vid warp (1, 3, 512,
   1024) and the teacher's warps (6, 3, 512, 1024), fp32, under
   chip_smoke's mixed and smooth flows; each but the floor is held to
   the plain version (fp32 bit for bit, gate 1e-5). Each variant is
   built from an edited copy of ``csrc/resample2d.cu``; beside its card
   time stands its host time (``host_us``: one call enqueued behind a
   spin kernel, so that the card runs nothing while the host is timed),
   and the wrapper ``resample2d`` gets a host time of its own:

   - as_built: ``csrc/resample2d.cu`` as it is;
   - baseline: an earlier kernel source with the same C interface
     ``resample2d_fwd(x, flow, out, b, c, h, w, x_dtype, flow_dtype,
     stream)``, given by ``--resample-baseline`` (for example
     ``git show <rev>:imaginaire_tpu_torch/csrc/resample2d.cu >
     chip_copies/resample2d_baseline.cu``); skipped without it;
   - px2_planes2: the corners of 2 channel planes in flight (16 gathers
     a thread), not all 3 (24);
   - px2_neighbours: each thread's 2 pixels neighbours (columns 2 l and
     2 l + 1 of the tile) instead of 32 columns apart;
   - px1_planes3: one pixel a thread (12 gathers in flight);
   - px4_planes1, px4_neighbours: 4 pixels a thread with one plane's 16
     gathers in flight, 32 columns apart or neighbours (the layout of
     16-byte vectors, loaded by scalars here);
   - regs_128: up to 128 registers a thread (2 blocks an SM, not 4);
   - plain_loads: the corner gathers by plain loads, not ``__ldg``;
   - default_caching: the flow loaded and the output stored by plain
     loads and stores, not with the evict-first hints (``__ldcs``,
     ``__stcs``);
   - tile_rows_4, tile_rows_1: tiles of 4 rows (128 x 4) or of one row
     (512 x 1), the block's 8 warps laid across the row;
   - block_per_tile: one block a tile, several waves, no grid-stride;
   - stream_floor: a coalesced streaming kernel that moves the warp's
     bytes (reads x and the flow with 16-byte loads, writes out) and
     gathers nothing: the card's floor for those bytes;
   - empty_kernel: one block that does nothing: what the timer and a
     launch cost by themselves;
   - grid_sample: ``F.grid_sample`` (bilinear, border, align_corners) of
     the same warp, the library call chip_smoke.py times beside the
     kernel (not held to the plain version: it rounds otherwise).
4. Variants of the resample2d backward at the vid2vid training warp
   (2, 3, 512, 1024), fp32 and bf16 (x, flow and g of one type), under
   chip_smoke's mixed, smooth, border and all-corners flows, dflow alone
   (the path's call) and with dx; each variant is built from an edited
   copy of ``csrc/resample2d.cu`` and held to the plain version as
   chip_smoke.py holds the kernel (dflow bit for bit, dx within its
   gate). The dx variants are timed with dx only:

   - as_built: ``csrc/resample2d.cu`` as it is;
   - baseline: the backward of ``--resample-baseline`` (the same C
     interface ``resample2d_bwd(x, flow, g, dflow, dx, b, c, h, w,
     x_dtype, flow_dtype, stream)``; the first, one-thread-a-pixel
     kernel is ``git show 01e6139:imaginaire_tpu_torch/csrc/resample2d.cu``);
     skipped without it;
   - px1: dflow one pixel a thread, not 2; planes_2, planes_3: 2 or 3
     planes' corners and g in flight for dflow, not 1;
   - dx_px2: dx two pixels a thread, not 1; dx_planes_3: 3 planes in
     flight with dx, not 1; dx_no_merge: a pixel's coincident corners not
     merged; dx_no_warp_sum: one atomic a lane, no sum over the lanes on
     one address; dx_no_neighbours: a lane's corners 01 and 11 not added
     into the next lane's 00 and 10; dx_none: all three off;
     dx_match_all: every lane matched and summed with its group, not
     only the lanes whose corners lie on the frame's border ring;
   - stream_floor (dflow alone): a coalesced kernel of 16-byte loads
     that moves the backward's bytes (reads x, g and the flow, writes
     dflow) and gathers nothing: the card's floor for those bytes;
   - empty_kernel: one block that does nothing;
   - library: ``torch.autograd.grad`` through ``F.grid_sample``
     (bilinear, border, align_corners) in the same type, the grid's
     gradient alone or the input's too (not held to the plain version).
5. The spade_modulation forward and backward at the 19 calls' 7 shapes
   of a bs-4 SPADE forward (chip_smoke.MODULATION_SHAPES), fp32 and bf16,
   n_pairs 1, each case held to the plain version as chip_smoke.py holds
   the kernels (``modulation_errors``):

   - as_built: the kernels under ``modulation_plan``'s plan;
   - baseline: an earlier ``csrc/spade_modulation.cu`` bound with the C
     interface that had no plan argument (that of commit 26063d5:
     ``spade_modulation_fwd(x, gammas, betas, n_pairs, out, mean, rstd,
     n_planes, plane, eps, dtype, stream)`` and
     ``spade_modulation_bwd(x, gammas, n_pairs, mean, rstd, g, dx,
     dgamma, n_planes, plane, dtype, stream)``), given by
     ``--modulation-baseline`` (for example ``git show
     26063d5:imaginaire_tpu_torch/csrc/spade_modulation.cu >
     chip_copies/spade_modulation_baseline.cu``); skipped without it;
   - warp_N_Tt, block_xC, stream: the kernels under another plan
     through the C interface: at planes a warp can hold (at most 1024
     bf16 or 512 fp32 elements) the warp path, N vectors a lane, in
     blocks of T threads (4 or 8 planes a block); the block path over a
     cluster of C blocks (every C of ``block_clusters`` that can hold the
     plane; at most 1024 elements only C = 1); above 1024 elements the
     re-reading path;
   - empty_kernel: one block that does nothing, what the timer and a
     launch cost by themselves; addcmul (forward only):
     ``torch.addcmul(beta, x, gamma)``, one elementwise call that moves
     the n_pairs-1 forward's bytes (reads three tensors, writes one),
     what a streaming kernel of those bytes takes. Neither computes the
     modulation: both are timed, not held to the plain version.

   Beside them, the host time of one call (``host_us``: the as-built C
   interface with a prebuilt plan, the wrapper ``_launch_fwd``, and the
   baseline's C interface) at the largest shape.

Imports nothing of JAX. Needs nvcc and a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the timer, the shapes and the card's line)
from imaginaire_tpu_torch.ops import build  # noqa: E402
from imaginaire_tpu_torch.ops import channelnorm as cn  # noqa: E402
from imaginaire_tpu_torch.ops import correlation as corr  # noqa: E402
from imaginaire_tpu_torch.ops import resample2d as rs  # noqa: E402
from imaginaire_tpu_torch.ops import spade_modulation as spade_mod  # noqa: E402

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
    epilogue = (4 * plan["rows"] * plan["dys"] * plan["dx_per_group"] * 16
                * plan["phases"] * plan["m_tiles"])
    plan["threads"] = 32 * plan["rows"] * plan["phases"] * plan["m_tiles"]
    plan["smem_bytes"] = max(plan["stages"] * plan["chunk"] * per_channel, epilogue)
    plan["y_blocks"] = S2 * corr._ceil(corr._ceil(h, S2), plan["rows"])
    plan["grid_x"] = (plan["x_tiles"] * plan["phase_groups"] * plan["dx_groups"]
                      * plan["dy_groups"] * plan["y_blocks"])
    return plan


def build_variants(kernel, variants, out_dir):
    """Build {name: (edits, source or None)} of ``kernel``, one nvcc a
    variant, all started together; returns {name: (library, ptxas lines)}.
    ``source`` None means the kernel's source in csrc/; each edit must
    match it once."""
    nvcc, procs = build.find_nvcc(), {}
    for name, (edits, source) in variants.items():
        if source is None:
            source = build.source_path(kernel).read_text()
        for old, new in edits:
            if source.count(old) != 1:
                raise RuntimeError(f"variant {name}: the kernel source no "
                                   f"longer holds {old!r} once")
            source = source.replace(old, new)
        src = out_dir / f"{kernel}_{name}.cu"  # one file a kernel and variant:
        lib = out_dir / f"lib{kernel}_{name}.so"  # dlopen caches by path
        src.write_text(source)
        procs[name] = (lib, subprocess.Popen(
            build.nvcc_command(nvcc, src, lib), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "spill" in line]
        built[name] = (ctypes.CDLL(str(lib)), regs)
    return built


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


def probe_correlation(gen, out_dir, baseline):
    variants = dict(VARIANTS)
    specs = {name: (edits, None) for name, (edits, _) in variants.items()}
    if baseline is not None:
        variants["baseline"] = ([], {})
        specs["baseline"] = ([], baseline.read_text())
    libs = build_variants(corr.KERNEL, specs, out_dir)
    order = list(variants) + list(reversed(variants))
    rows = []
    for shape in SHAPES:
        x1 = torch.randn(shape, generator=gen, device="cuda")
        x2 = torch.randn(shape, generator=gen, device="cuda")
        want = corr.correlation_plain(x1, x2, **chip_smoke.FLOWNETC)
        out = torch.empty_like(want)
        plans = {name: variant_plan(shape, free)
                 for name, (_, free) in variants.items()}
        times = {name: [] for name in variants}
        for name in order:
            lib = libs[name][0]
            times[name].append(chip_smoke.time_ms(
                lambda: launch(lib, x1, x2, out, plans[name])))
        for name, (edits, free) in variants.items():
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


RS_SHAPES = [chip_smoke.RESAMPLE_PATH_SHAPE, chip_smoke.RESAMPLE_TEACHER_SHAPE]
RS_COLUMN = "  *x0 = (rt - ty * tiles_x) * tile_w + lane;"


def rs_edits(**values):
    """Edits of csrc/resample2d.cu's #define constants, by name: for
    example pixels=4 sets RESAMPLE_PIXELS to 4."""
    lines = build.source_path(rs.KERNEL).read_text().splitlines()
    edits = []
    for name, value in values.items():
        line = next(line for line in lines
                    if line.startswith(f"#define RESAMPLE_{name.upper()} "))
        edits.append((line, f"#define RESAMPLE_{name.upper()} {value}"))
    return edits


# each thread's pixels neighbours (columns PIXELS l, PIXELS l + 1, ... of
# the tile) instead of 32 columns apart
RS_NEIGHBOURS = rs_edits(stride=1) + [
    (RS_COLUMN, RS_COLUMN.replace("+ lane;", "+ lane * RESAMPLE_PIXELS;"))]


def rs_tile(rows):
    """Edits that give csrc/resample2d.cu tiles of ``rows`` rows with its
    8 warps laid across them (8 / rows warps a row): 128 x 4 at 4 rows,
    512 x 1 at one."""
    per_row = 8 // rows
    return rs_edits(tile_rows=rows) + [
        ("#define RESAMPLE_THREADS (32 * RESAMPLE_TILE_ROWS)",
         "#define RESAMPLE_THREADS 256"),
        ("#define RESAMPLE_TILE_W (32 * RESAMPLE_PIXELS)  // columns of a tile",
         f"#define RESAMPLE_TILE_W ({32 * per_row} * RESAMPLE_PIXELS)"),
        ("  const int row = threadIdx.x >> 5, lane = threadIdx.x & 31;",
         f"  const int row = (threadIdx.x >> 5) / {per_row};\n"
         f"  const int lane = (threadIdx.x >> 5) % {per_row} * 32 * RESAMPLE_PIXELS"
         f" + (threadIdx.x & 31);")]


# name -> edits of csrc/resample2d.cu (as built: 2 pixels a thread 32
# columns apart, 3 planes' 24 gathers in flight, 4 blocks an SM, 64 x 8
# tiles, one wave)
RS_VARIANTS = {
    "as_built": [],
    "px2_planes2": rs_edits(planes=2),
    "px2_neighbours": RS_NEIGHBOURS,
    "px1_planes3": rs_edits(pixels=1),
    "px4_planes1": rs_edits(pixels=4, planes=1),
    "px4_neighbours": rs_edits(pixels=4, planes=1) + RS_NEIGHBOURS,
    "regs_128": rs_edits(min_blocks=2),
    "plain_loads": [(
        "__device__ __forceinline__ float gather_f(const float* p) { return __ldg(p); }",
        "__device__ __forceinline__ float gather_f(const float* p) { return *p; }")],
    "default_caching": [
        ("__device__ __forceinline__ float load_f(const float* p) { return __ldcs(p); }",
         "__device__ __forceinline__ float load_f(const float* p) { return *p; }"),
        ("__device__ __forceinline__ void store_f(float* p, float v) { __stcs(p, v); }",
         "__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }")],
    "tile_rows_4": rs_tile(4),
    "tile_rows_1": rs_tile(1),
    "block_per_tile": [("  if (tiles < blocks) blocks = tiles;",
                        "  blocks = tiles;")],
}
STREAM_FLOOR = r"""
#include <cuda_runtime.h>
// out = x * dx + dy, plane by plane: the warp's bytes, coalesced, no gather
// (32-bit indices: the probe's shapes are small)
__global__ void __launch_bounds__(256) stream_kernel(
    const float4* __restrict__ x, const float4* __restrict__ flow,
    float4* __restrict__ out, int batch, int channels, int plane4) {
  const int n = batch * plane4;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n; i += gridDim.x * 256) {
    const int b = i / plane4, r = i - b * plane4;
    const float4 fx = flow[b * 2 * plane4 + r];
    const float4 fy = flow[(b * 2 + 1) * plane4 + r];
    for (int c = 0; c < channels; ++c) {
      const int o = (b * channels + c) * plane4 + r;
      const float4 v = x[o];
      out[o] = make_float4(v.x * fx.x + fy.x, v.y * fx.y + fy.y,
                           v.z * fx.z + fy.z, v.w * fx.w + fy.w);
    }
  }
}
extern "C" int stream_fwd(const void* x, const void* flow, void* out,
                          long long batch, long long channels, long long plane,
                          void* stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_kernel, 256, 0);
  long long blocks = (batch * plane / 4 + 255) / 256;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  stream_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (const float4*)flow, (float4*)out, (int)batch,
      (int)channels, (int)(plane / 4));
  return (int)cudaGetLastError();
}
__global__ void empty_kernel() {}
extern "C" int empty_fwd(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def rs_launcher(name, lib, x, flow, out):
    """fn() that runs variant ``name`` once on fp32 x and flow into out."""
    b, c, h, w = x.shape
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    ptrs = (x.data_ptr(), flow.data_ptr(), out.data_ptr())

    def check(err):
        if err != 0:
            raise RuntimeError(f"resample2d variant {name}: CUDA error {err}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if name == "stream_floor":
        fn = lib.stream_fwd
        fn.argtypes, fn.restype = [ptr] * 3 + [i64] * 3 + [ptr], i32
        return lambda: check(fn(*ptrs, b, c, h * w, stream()))
    if name == "empty_kernel":
        fn = lib.empty_fwd
        fn.argtypes, fn.restype = [ptr], i32
        return lambda: check(fn(stream()))
    fn = lib.resample2d_fwd  # every variant and the baseline: one interface
    fn.argtypes, fn.restype = [ptr] * 3 + [i64] * 4 + [i32] * 2 + [ptr], i32
    return lambda: check(fn(*ptrs, b, c, h, w, 0, 0, stream()))


def host_us(fn, calls=200):
    """Host time of one call of fn: the calls are enqueued behind a spin
    kernel long enough that the card runs none of them while the host's
    clock runs, so the time is the host's alone (us)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100 * chip_smoke.SPIN_CYCLES)
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - start
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def probe_resample(gen, out_dir, baseline):
    specs = {name: (edits, None) for name, edits in RS_VARIANTS.items()}
    if baseline is not None:
        specs["baseline"] = ([], baseline.read_text())
    specs["stream_floor"] = ([], STREAM_FLOOR)
    libs = build_variants(rs.KERNEL, specs, out_dir)
    libs["empty_kernel"] = libs["stream_floor"]
    names = list(libs) + ["grid_sample"]
    order = names + names[::-1]
    rows = []
    for shape in RS_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
        flows = {"mixed": chip_smoke.mixed_flow(shape, gen),
                 "smooth": chip_smoke.smooth_flow(shape)}
        bound, _ = chip_smoke.resample_bound_ms(shape, 4)
        for flow_name, flow in flows.items():
            want = rs.resample2d_plain(x, flow)
            outs = {name: torch.empty_like(x) for name in names}
            fns = {name: rs_launcher(name, libs[name][0], x, flow, outs[name])
                   for name in libs}
            grid = chip_smoke.border_grid(flow)
            fns["grid_sample"] = lambda: F.grid_sample(
                x, grid, mode="bilinear", padding_mode="border",
                align_corners=True)
            fns["wrapper"] = lambda: rs.resample2d(x, flow)  # host time only
            times = {name: [] for name in names}
            for name in order:
                times[name].append(chip_smoke.time_ms(fns[name], iters=50))
            for name in names + ["wrapper"]:
                row = {"probe": "resample2d", "variant": name, "shape": list(shape),
                       "flow": flow_name, "host_us": host_us(fns[name]),
                       "ptxas": libs[name][1] if name in libs else None}
                if name in times:
                    ms = sum(times[name]) / len(times[name])
                    row.update(ms=times[name], bound_ms=bound,
                               bound_share=bound / ms)
                if name in specs and name != "stream_floor":  # held to plain
                    fns[name]()
                    torch.cuda.synchronize()
                    row["max_abs_err"] = (outs[name] - want).abs().max().item()
                    if row["max_abs_err"] > chip_smoke.TOL_RESAMPLE_FP32:
                        raise AssertionError(f"variant {name} disagrees with "
                                             f"the plain version: {row}")
                rows.append(row)
                print(json.dumps(row), flush=True)
    return rows


# name -> edits of csrc/resample2d.cu for the backward (as built: dflow
# in the forward's layout, 2 pixels a thread, one plane's corners and g
# in flight; dx one pixel a thread, one plane, coincident corners merged,
# one atomic a group of lanes on one address, neighbours' shared corners
# added in by shuffles)
RSB_VARIANTS = {
    "as_built": [],
    "px1": rs_edits(pixels=1),
    "planes_2": rs_edits(bwd_planes=2),
    "planes_3": rs_edits(bwd_planes=3),
    "dx_px2": rs_edits(dx_pixels=2),
    "dx_planes_3": rs_edits(dx_planes=3),
    "dx_no_merge": rs_edits(dx_merge=0),
    "dx_no_warp_sum": rs_edits(dx_warp_sum=0),
    "dx_no_neighbours": rs_edits(dx_neighbours=0),
    "dx_none": rs_edits(dx_merge=0, dx_warp_sum=0, dx_neighbours=0),
    "dx_match_all": [("      const bool edge = s[i].x0 == 0 || s[i].y0 == 0 ||",
                      "      const bool edge = true || s[i].y0 == 0 ||")],
}
RSB_DX_ONLY = tuple(name for name in RSB_VARIANTS if name.startswith("dx_"))
RSB_FLOWS = ("mixed", "smooth", "border", "corners")
STREAM_FLOOR_BWD = r"""
#include <cuda_runtime.h>
// the backward's bytes, coalesced 16-byte units, no gather: reads x and g
// (C planes each) and the flow (2 planes), writes dflow (2 planes)
// (32-bit indices: the probe's shapes are small)
__global__ void __launch_bounds__(256) stream_bwd_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ g,
    const uint4* __restrict__ flow, uint4* __restrict__ dflow, int batch,
    int channels, int plane16) {
  const int n = batch * plane16;
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n; i += gridDim.x * 256) {
    const int b = i / plane16, r = i - b * plane16;
    uint4 fx = flow[b * 2 * plane16 + r];
    uint4 fy = flow[(b * 2 + 1) * plane16 + r];
    for (int c = 0; c < channels; ++c) {
      const int o = (b * channels + c) * plane16 + r;
      const uint4 v = x[o], w = g[o];
      fx.x ^= v.x & w.x; fx.y ^= v.y & w.y; fx.z ^= v.z & w.z; fx.w ^= v.w & w.w;
      fy.x ^= v.x | w.x; fy.y ^= v.y | w.y; fy.z ^= v.z | w.z; fy.w ^= v.w | w.w;
    }
    dflow[b * 2 * plane16 + r] = fx;
    dflow[(b * 2 + 1) * plane16 + r] = fy;
  }
}
extern "C" int stream_bwd(const void* x, const void* g, const void* flow,
                          void* dflow, long long batch, long long channels,
                          long long plane16, void* stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_bwd_kernel, 256, 0);
  long long blocks = (batch * plane16 + 255) / 256;
  if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
  stream_bwd_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (const uint4*)g, (const uint4*)flow, (uint4*)dflow,
      (int)batch, (int)channels, (int)plane16);
  return (int)cudaGetLastError();
}
__global__ void empty_kernel() {}
extern "C" int empty_fwd(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def rsb_launcher(name, lib, x, flow, g, dflow, dx):
    """fn() that runs backward variant ``name`` once (dx None: dflow
    alone; else dx is added into the fp32 buffer ``dx``)."""
    b, c, h, w = x.shape
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

    def check(err):
        if err != 0:
            raise RuntimeError(f"resample2d_bwd variant {name}: CUDA error {err}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    if name == "stream_floor":
        fn = lib.stream_bwd
        fn.argtypes, fn.restype = [ptr] * 4 + [i64] * 3 + [ptr], i32
        plane16 = h * w * x.element_size() // 16
        ptrs = (x.data_ptr(), g.data_ptr(), flow.data_ptr(), dflow.data_ptr())
        return lambda: check(fn(*ptrs, b, c, plane16, stream()))
    if name == "empty_kernel":
        fn = lib.empty_fwd
        fn.argtypes, fn.restype = [ptr], i32
        return lambda: check(fn(stream()))
    fn = lib.resample2d_bwd  # every variant and the baseline: one interface
    fn.argtypes, fn.restype = [ptr] * 5 + [i64] * 4 + [i32] * 2 + [ptr], i32
    code = rs._DTYPE_CODES
    ptrs = (x.data_ptr(), flow.data_ptr(), g.data_ptr(), dflow.data_ptr(),
            None if dx is None else dx.data_ptr())
    return lambda: check(fn(*ptrs, b, c, h, w, code[x.dtype], code[flow.dtype],
                            stream()))


def probe_resample_bwd(gen, out_dir, baseline):
    """The backward's variants at the training warp (2, 3, 512, 1024), fp32
    and bf16, under chip_smoke's mixed, smooth, border and all-corners
    flows, dflow alone and with dx, timed in turns beside the library
    call; each variant held to the plain version as chip_smoke.py holds
    the kernel (dflow bit for bit, dx within its gate)."""
    specs = {name: (edits, None) for name, edits in RSB_VARIANTS.items()}
    if baseline is not None:
        specs["baseline"] = ([], baseline.read_text())
    specs["stream_floor"] = ([], STREAM_FLOOR_BWD)
    libs = build_variants(rs.KERNEL, {f"bwd_{k}": v for k, v in specs.items()}, out_dir)
    libs = {name[len("bwd_"):]: lib for name, lib in libs.items()}
    libs["empty_kernel"] = libs["stream_floor"]
    shape = chip_smoke.RESAMPLE_BWD_PATH_SHAPE
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        dflow = torch.empty((shape[0], 2) + shape[2:], dtype=dtype, device="cuda")
        dx = torch.zeros(shape, device="cuda")
        for flow_name in RSB_FLOWS:
            flow = chip_smoke.resample_bwd_flow(flow_name, shape, gen).to(dtype)
            for need_dx in (False, True):
                names = [n for n in libs if need_dx or n not in RSB_DX_ONLY]
                if need_dx:
                    names.remove("stream_floor")  # the floor of dflow's bytes
                fns = {n: rsb_launcher(n, libs[n][0], x, flow, g, dflow,
                                       dx if need_dx else None) for n in names}
                fns["library"] = chip_smoke.grid_sample_bwd(x, flow, g, need_dx)
                names.append("library")
                times = {n: [] for n in names}
                for n in names + names[::-1]:
                    times[n].append(chip_smoke.time_ms(fns[n], iters=20))
                bound, _ = chip_smoke.resample_bwd_bound_ms(shape, x.element_size(),
                                                            need_dx)
                for n in names:
                    ms = sum(times[n]) / len(times[n])
                    row = {"probe": "resample2d_bwd", "variant": n,
                           "shape": list(shape), "dtype": str(dtype).split(".")[-1],
                           "flow": flow_name, "need_dx": need_dx, "ms": times[n],
                           "bound_ms": bound, "bound_share": bound / ms,
                           "ptxas": libs[n][1] if n in libs else None}
                    if n in specs and n != "stream_floor":  # held to plain
                        dx.zero_()
                        fns[n]()
                        got_dx = dx.to(dtype) if need_dx else None
                        bitwise, dx_err, ok = chip_smoke.resample_bwd_errors(
                            rs, x, flow, g, got_dx, dflow)
                        row.update(dflow_bitwise=bitwise, dx_error=dx_err)
                        if not ok:
                            raise AssertionError(f"resample2d_bwd variant {n} "
                                                 f"disagrees with the plain "
                                                 f"version: {row}")
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    return rows


def baseline_modulation(lib):
    """fwd(x, gs, bs) and bwd(x, gs, mean, rstd, g) of a kernel source
    whose C interface takes no plan (that of commit 26063d5)."""
    ptr, ptrs, i64, i32 = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                           ctypes.c_longlong, ctypes.c_int)
    lib.spade_modulation_fwd.argtypes = [
        ptr, ptrs, ptrs, i32, ptr, ptr, ptr, i64, i64, ctypes.c_float, i32, ptr]
    lib.spade_modulation_fwd.restype = i32
    lib.spade_modulation_bwd.argtypes = [
        ptr, ptrs, i32, ptr, ptr, ptr, ptr, ptr, i64, i64, i32, ptr]
    lib.spade_modulation_bwd.restype = i32
    pointers = spade_mod._pointers
    code = spade_mod._DTYPE_CODES

    def check(err):
        if err != 0:
            raise RuntimeError(f"baseline spade_modulation: CUDA error {err}")

    def fwd(x, gs, bs):
        b, c, h, w = x.shape
        out = torch.empty_like(x)
        mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
        check(lib.spade_modulation_fwd(
            x.data_ptr(), pointers(gs), pointers(bs), len(gs), out.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), b * c, h * w, 1e-5, code[x.dtype],
            torch.cuda.current_stream().cuda_stream))
        return out, mean, rstd

    def bwd(x, gs, mean, rstd, g):
        b, c, h, w = x.shape
        dx, dgamma = torch.empty_like(x), torch.empty_like(x)
        check(lib.spade_modulation_bwd(
            x.data_ptr(), pointers(gs), len(gs), mean.data_ptr(), rstd.data_ptr(),
            g.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), b * c, h * w,
            code[x.dtype], torch.cuda.current_stream().cuda_stream))
        return dx, dgamma

    def host_fwd(x, gs, bs):
        """fn() of one raw C call into preallocated outputs."""
        b, c, h, w = x.shape
        out, mean = torch.empty_like(x), torch.empty((b, c), device=x.device)
        rstd = torch.empty_like(mean)
        args = (x.data_ptr(), pointers(gs), pointers(bs), len(gs), out.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), b * c, h * w, 1e-5, code[x.dtype],
                torch.cuda.current_stream().cuda_stream)
        return lambda: check(lib.spade_modulation_fwd(*args))

    return fwd, bwd, host_fwd


def modulation_variants(shape, dtype, backward):
    """{name: plan} of the as-built kernels at ``shape``: the plan's own
    and the other plans the design weighs."""
    b, c, h, w = shape
    n, plane = b * c, h * w
    plans = {"as_built": spade_mod.modulation_plan(n, plane, dtype, 1, True, backward)}
    native = 16 // dtype.itemsize
    small = plane <= 1024  # 16x16 and 32x32: a warp against a block
    if small and plane <= spade_mod.WARP_MAX_VECTORS * native:
        per_thread = next(n for n in spade_mod.WARP_PER_THREAD
                          if 32 * n * native >= plane)
        for threads in (128, 256):  # 4 or 8 planes a block
            plans[f"warp_{per_thread}_{threads}t"] = dict(
                plans["as_built"], route="warp", path=spade_mod.PATHS["warp"],
                per_thread=per_thread, cluster=1, threads=threads,
                planes_per_block=threads // 32, grid=-(-n // (threads // 32)))
    for cluster in spade_mod.block_clusters(dtype, backward):
        if small and cluster > 1:
            continue
        try:
            plans[f"block_x{cluster}"] = spade_mod.modulation_plan(
                n, plane, dtype, 1, True, backward, cluster=cluster)
        except ValueError:
            pass  # cannot hold the plane
    if not small:
        plans["stream"] = dict(
            plans["as_built"], route="stream", path=spade_mod.PATHS["stream"],
            per_thread=0, cluster=1, planes_per_block=1, grid=n,
            threads=min(spade_mod.STREAM_THREADS, 32 * -(-plane // native // 32)))
    return plans


def probe_modulation(gen, out_dir, baseline):
    specs = {"floor": ([], STREAM_FLOOR)}
    if baseline is not None:
        specs["baseline"] = ([], baseline.read_text())
    libs = build_variants(spade_mod.KERNEL, specs, out_dir)
    base = baseline_modulation(libs["baseline"][0]) if baseline is not None else None
    empty_fwd = libs["floor"][0].empty_fwd
    empty_fwd.argtypes, empty_fwd.restype = [ctypes.c_void_p], ctypes.c_int
    empty = lambda: empty_fwd(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    rows = []
    for shape, calls in chip_smoke.MODULATION_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, gs, bs, g = chip_smoke.modulation_inputs(shape, 1, dtype, gen)
            mean_p, rstd_p = spade_mod.spade_modulation_stats_plain(x)
            for backward in (False, True):
                fns = {}
                for name, plan in modulation_variants(shape, dtype, backward).items():
                    if backward:
                        fns[name] = (plan, lambda plan=plan: spade_mod._launch_bwd(
                            x, gs, mean_p, rstd_p, g, plan))
                    else:
                        fns[name] = (plan, lambda plan=plan: spade_mod._launch_fwd(
                            x, gs, bs, 1e-5, plan))
                if base is not None:
                    fns["baseline"] = (None, (lambda: base[1](x, gs, mean_p, rstd_p, g))
                                       if backward else (lambda: base[0](x, gs, bs)))
                floors = {"empty_kernel": empty}
                if not backward:  # one elementwise call of the forward's bytes
                    floors["addcmul"] = lambda: torch.addcmul(bs[0], x, gs[0])
                fns.update((name, (None, fn)) for name, fn in floors.items())
                names = list(fns)
                times = {name: [] for name in names}
                for name in names + names[::-1]:
                    times[name].append(chip_smoke.time_ms(fns[name][1]))
                size = x.element_size()
                bound, _ = (chip_smoke.modulation_bwd_bound_ms(shape, 1, size) if backward
                            else chip_smoke.modulation_bound_ms(shape, 1, size))
                for name in names:
                    plan, fn = fns[name]
                    ms = sum(times[name]) / len(times[name])
                    row = {"probe": "modulation", "variant": name, "shape": list(shape),
                           "calls": calls, "dtype": str(dtype).split(".")[-1],
                           "direction": "backward" if backward else "forward",
                           "plan": None if plan is None else
                           {k: plan[k] for k in ("route",) + spade_mod.PLAN_FIELDS},
                           "ms": times[name], "bound_ms": bound, "bound_share": bound / ms}
                    if name in floors:  # not the function: timed, not held
                        rows.append(row)
                        print(json.dumps(row), flush=True)
                        continue
                    launch = (lambda *a, fn=fn: fn())
                    errs = chip_smoke.modulation_errors(
                        spade_mod, x, gs, bs, g,
                        fwd=None if backward else launch, bwd=launch if backward else None)
                    row.update(errs)
                    rows.append(row)
                    print(json.dumps(row), flush=True)
                    if not errs["ok"]:
                        raise AssertionError(f"modulation variant {name} disagrees "
                                             f"with the plain version: {row}")
    # host time of one C call at the largest shape, bf16 forward
    shape = max((s for s, _ in chip_smoke.MODULATION_SHAPES), key=lambda s: s[1] * s[2] * s[3])
    x, gs, bs, _ = chip_smoke.modulation_inputs(shape, 1, torch.bfloat16, gen)
    b, c, h, w = shape
    lib = spade_mod._library()
    out, mean = torch.empty_like(x), torch.empty((b, c), device=x.device)
    rstd = torch.empty_like(mean)
    fields = spade_mod._plan_fields(spade_mod.modulation_plan(b * c, h * w, x.dtype))
    args = (x.data_ptr(), spade_mod._pointers(gs), spade_mod._pointers(bs), 1,
            out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b * c, h * w, 1e-5, 1,
            fields, torch.cuda.current_stream().cuda_stream)
    hosts = {"as_built_c_call": lambda: lib.spade_modulation_fwd(*args),
             "wrapper": lambda: spade_mod._launch_fwd(x, gs, bs, 1e-5)}
    if base is not None:
        hosts["baseline_c_call"] = base[2](x, gs, bs)
    for name, fn in hosts.items():
        row = {"probe": "modulation_host", "variant": name, "shape": list(shape),
               "dtype": "bfloat16", "host_us": [host_us(fn) for _ in range(3)]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", type=Path, default=None)
    parser.add_argument("--probes",
                        default="timer,correlation,resample2d,resample2d_bwd,modulation",
                        help="comma-separated: timer, correlation, resample2d, "
                             "resample2d_bwd, modulation")
    parser.add_argument("--resample-baseline", type=Path, default=None,
                        help="an earlier csrc/resample2d.cu to time beside "
                             "the kernels as built (forward and backward)")
    parser.add_argument("--correlation-baseline", type=Path, default=None,
                        help="an earlier csrc/correlation.cu to time beside "
                             "the kernel as built")
    parser.add_argument("--modulation-baseline", type=Path, default=None,
                        help="an earlier csrc/spade_modulation.cu (a C "
                             "interface without a plan) to time beside the "
                             "kernels as built")
    args = parser.parse_args()
    probes = set(args.probes.split(","))
    if not probes <= {"timer", "correlation", "resample2d", "resample2d_bwd",
                      "modulation"}:
        parser.error(f"unknown probes in {args.probes!r}")
    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.nvidia_smi()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(2468)
    rows = []
    with torch.no_grad(), tempfile.TemporaryDirectory() as tmp:
        if "timer" in probes:
            rows += probe_timer(gen)
        if "correlation" in probes:
            rows += probe_correlation(gen, Path(tmp), args.correlation_baseline)
        if "resample2d" in probes:
            rows += probe_resample(gen, Path(tmp), args.resample_baseline)
        if "resample2d_bwd" in probes:
            rows += probe_resample_bwd(gen, Path(tmp), args.resample_baseline)
        if "modulation" in probes:
            rows += probe_modulation(gen, Path(tmp), args.modulation_baseline)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
