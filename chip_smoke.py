#!/usr/bin/env python3
"""Run the PyTorch/H100 port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json PATH]   # from the repository root, one CUDA card

``--json`` also writes the per-shape kernel rows, the main paths'
numbers and their profiles to PATH.

Phases, one line each; any failure exits non-zero:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compile every kernel of the main paths from csrc/ (one nvcc per
   source, all started together; sm_90a), with ptxas registers and spills;
   it fails if a spade_modulation kernel spills;
3. kernels: hold each kernel against its plain PyTorch version at every
   shape the main paths give it (and at edge shapes: for
   spade_modulation every path of its plan and the plan's boundaries,
   forward and backward in fp32 and bf16, the bf16 forward to one ulp
   given the same statistics),
   and time both (CUDA events, L2 flushed before each launch) beside the
   card's bound for the same work and, where one exists, the PyTorch
   call that computes the same function; resample2d is timed at both
   paths' shapes under a mixed and a smooth flow, and (in phase 5) on
   the frame and flow the vid2vid path gives it;
4. SPADE path: the SPADE serving engine at full COCO-Stuff width
   (configs/projects/spade/cocostuff/base128_bs4.yaml with the base norm
   of the SPADE blocks overridden to ``instance``, fresh seeded weights)
   warms bs 1 and 4 and serves 7 requests; the launch counters are reset
   just before and read just after, and the outputs are checked;
5. vid2vid path: the vid2vid serving engine at full Cityscapes width
   (configs/projects/vid2vid/cityscapes/bf16.yaml, unchanged, fresh
   seeded weights) warms a throwaway stream and serves two interleaved
   streams of 512x1024 frames (5 and 3 frames); the launch counters are
   reset just before and read just after; the frames, the warp against
   the plain version and the isolation of the streams are checked, and
   one warp frame is profiled;
6. FlowNet2 teacher path: the port's vid2vid trainer built from the same
   config (``flow_network.allow_random_init`` on, ``weights_path``
   dropped, ``flow_cache: {enabled: True, mode: producer}``) attaches the
   teacher's flow to two seeded clips of (2, 4, 3, 512, 1024) frames (6
   frame pairs per attach) through ``_start_of_iteration``; the launch
   counters are reset just before and read just after (correlation 1,
   channelnorm 6, resample2d 5 per teacher forward); the outputs, the
   confidence map against the plain warp, the card's flow against the
   port's CPU run at (1, 2, 3, 128, 256) (TF32 off) and a disk-cache
   round trip are checked, and one attach is profiled;
7. SPADE training path: the port's SPADE trainer on the same COCO-Stuff
   config with the ``instance`` override and
   ``trainer.perceptual_loss.allow_random_init`` (the repository has no
   VGG19 weights), fresh seeded weights, takes 10 bf16 D+G steps at batch
   4, 256x256, on seeded one-hot labels and images made on the card; the
   launch counters are reset just before and read just after (forward 57,
   backward 19 a step); the losses are finite and the parameters and
   ``u`` move; the median step, images/s, peak memory and one profiled
   step are printed; one fp32 step (TF32 off) through the kernels is held
   to the same step through the plain composition, and the unmodified
   config (``sync_batch``: BatchNorm batch statistics, no kernel) takes
   two steps;
8. SPADE training entry (``spade_train_entry``): a seeded dataset of 8
   items of the fixtures' size (300x320 RGB images, seg maps in 0..182,
   edge maps) written as PNG through the port's encoder into a temporary
   directory and packed by the port's builder; the same config and
   overrides, its splits pointed there (a test split added like the val
   split). ``imaginaire_tpu_torch.train.main`` trains 6 iterations
   in-process (batch 4, 256x256, bf16, ``remat: blocks``; the launch
   counters are reset just before and read just after: 57 forward and 19
   backward an iteration, plus 19 forward for each generator forward of
   the image snapshots), the losses in ``meters.jsonl`` are finite and
   the checkpoint's files verify; a second ``main`` resumes to 8, every
   restored tensor equal to the saved state bit for bit and its first
   batch equal to an unbroken run's; one byte of the newest checkpoint is
   flipped, ``load_latest_verified`` quarantines it and restores the
   older (mid-epoch) one, and a third ``main`` resumes from that with the
   same checks; ``imaginaire_tpu_torch.inference.main`` writes one
   256x256 PNG a test item through the kernel. The median iteration (the
   config's ``speed_benchmark``: each step ends in a device sync), images/s
   over the loop's wall time data waits included, the host's data wait,
   the main thread's and the other threads' CPU time and the garbage
   collector's time an iteration, peak memory and the checkpoints' sizes
   and times are printed;
9. a ``kernels`` JSON line, the nvidia-smi line, and the final JSON line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "configs/projects/spade/cocostuff/base128_bs4.yaml"
V2V_CONFIG = REPO / "configs/projects/vid2vid/cityscapes/bf16.yaml"

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, fp32
# (non-tensor-core) flop/s and dense TF32 tensor-core flop/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# ~0.5 ms of spin at the H100's clock: longer than the host takes to
# enqueue one call of any timed function (the plain versions' dozen ops)
SPIN_CYCLES = 1_000_000

# kernel vs plain version: fp32 max-abs (the reduction order differs);
# bf16: at most one bf16 ulp element by element against the plain
# version given the kernel's statistics (both round at the same steps),
# whose mean and rstd are held to the plain ones within TOL_STATS_REL
TOL_FP32 = 1e-4
TOL_BF16_ULPS = 1.0
TOL_STATS_REL = 1e-5
# the backward kernel vs spade_modulation_bwd_plain on the same
# statistics: fp32 max-abs over the plain output's max magnitude (dx sums
# two spatial means in another order; dgamma is the same products);
# bf16 at most one ulp element by element (both round once): dgamma one
# ulp of its value, dx one ulp of the magnitude of the terms it sums
# (dx_term_scale), since where they cancel dx carries the two means'
# fp32 rounding (a first run measured 60 ulps of dx's own value at
# (4, 2048, 16, 16), at an element near zero)
TOL_BWD_DX_REL = 1e-5
TOL_BWD_DGAMMA_REL = 1e-6
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
# the modulation kernels' other paths and plan boundaries, checked in
# phase 3 in fp32 and bf16: (shape, n_pairs, bytes x starts past a 16-byte
# boundary); the routes the plan gives each are printed beside it
MODULATION_EDGE = [
    ((3, 5, 7, 9), 4, 0),        # ragged plane, most pairs: scalar path
    ((2, 8, 32, 32), 1, 4),      # a view 4 bytes past 16: scalar path
    ((1, 8, 256, 256), 2, 0),    # past every block capacity: stream path
    ((1, 3, 128, 136), 1, 0),    # just past the fp32 forward's and both
                                 # backwards' block capacity (16384)
    ((1, 2, 128, 264), 1, 0),    # just past the bf16 forward's (32768)
    ((1, 4, 128, 128), 4, 0),    # most pairs at 128x128
]
NUM_LABELS = 185  # 183 COCO-Stuff classes + dont-care + edge map
N_REQUESTS = 7
# SPADE training: D+G steps at batch 4; per step the modulation runs 19
# times in the D step's G forward (no grad), 19 in the G step's forward
# and 19 again when the rematted blocks recompute it in the backward, and
# its backward 19 times
TRAIN_BATCH = 4
TRAIN_STEPS = 10
TRAIN_FWD_LAUNCHES = 3 * CALLS_PER_FORWARD
TRAIN_BWD_LAUNCHES = CALLS_PER_FORWARD
# the fp32 D+G step (TF32 off) through the kernels against the same step
# through the plain composition: each loss and grad norm, relative
TOL_TRAIN_REL = 1e-3

# resample2d: the vid2vid path's warp of the previous (1, 3, 512, 1024)
# output frame and the teacher's warps of an attach's 6 frame pairs, and
# edge cases (shape, byte offsets of x and of the flow past a 16-byte
# boundary, flow): one channel, two samples, odd sizes, W not a multiple
# of the kernel's 64-column tile, H = 1, C = 2 and 5, views 4 bytes past
# 16, flows far larger than a tile
RESAMPLE_PATH_SHAPE = (1, 3, 512, 1024)
RESAMPLE_TEACHER_SHAPE = (6, 3, 512, 1024)
RESAMPLE_CASES = [(RESAMPLE_PATH_SHAPE, 0, 0, "mixed"),
                  (RESAMPLE_TEACHER_SHAPE, 0, 0, "mixed"),
                  ((1, 1, 37, 53), 0, 0, "mixed"),
                  ((2, 3, 37, 53), 0, 0, "mixed"),
                  ((2, 1, 64, 64), 0, 0, "mixed"),
                  ((1, 2, 9, 1027), 0, 0, "mixed"),
                  ((3, 5, 1, 7), 0, 0, "mixed"),
                  ((2, 3, 40, 300), 4, 4, "mixed"),
                  ((1, 3, 64, 256), 0, 4, "mixed"),
                  ((2, 2, 48, 520), 0, 0, "wide")]
# kernel vs plain version: fp32 max-abs (both compute the same fp32
# steps; the kernel avoids contracted multiply-adds); bf16 max-abs over
# the plain output's max magnitude
TOL_RESAMPLE_FP32 = 1e-5
TOL_RESAMPLE_BF16_REL = 1e-2
# the generator's warped frame against the plain warp of the same
# previous frame by the same flow (TF32 off): max-abs, and max-abs over
# the frame's max magnitude (the fresh generator's frames are small)
TOL_WARP = 1e-5
TOL_WARP_REL = 1e-5
# a stream's frames against the same labels stepped alone in a fresh
# session: max-abs, and max-abs over the frames' max magnitude (the
# fresh seeded generator's frames are small, so the relative check is
# the one a leaked history would fail)
TOL_STREAM = 2e-3
TOL_STREAM_REL = 1e-2
V2V_LABELS = 35  # Cityscapes label classes
V2V_HW = (512, 1024)
STREAM_FRAMES = {"A": 5, "B": 3}

# correlation: FlowNetC's cost volume of the attach's 6 frame pairs at
# 512x1024 (conv3 maps), timed per frame pair; and edge shapes (an odd
# map, stride2 2, a map smaller than the displacement window)
FLOWNETC = dict(pad_size=20, max_displacement=20, stride2=2)
CORR_PATH_SHAPE = (6, 256, 64, 128)
CORR_PAIR_SHAPE = (1, 256, 64, 128)
def _disp(md, s2):
    return dict(pad_size=md, max_displacement=md, stride2=s2)


CORR_EDGE = [((1, 8, 7, 9), _disp(2, 1)),
             ((2, 16, 13, 17), _disp(4, 2)),
             ((1, 256, 8, 12), FLOWNETC),
             ((1, 40, 9, 130), FLOWNETC),  # W not a multiple of the tile
             ((1, 16, 6, 5), _disp(2, 1)),  # W smaller than one m16 tile
             ((1, 1, 7, 20), _disp(2, 1)),  # C = 1
             ((2, 33, 5, 24), _disp(4, 2)),  # C = 33: a partial chunk
             ((2, 8, 5, 21), _disp(0, 1)),  # max_displacement 0: n_d = 1
             ((1, 16, 9, 37), _disp(8, 4)),  # stride2 4
             ((3, 16, 6, 20), _disp(4, 2)),  # B = 3
             ((1, 8, 6, 40), _disp(17, 17)),  # stride2 17: two phase groups
             ((2, 5, 7, 70), _disp(34, 17)),  # stride2 17, 5 displacements
             ((1, 8, 5, 70), _disp(64, 32)),  # stride2 32: a ring of 2 stages
             ((2, 6, 6, 11), _disp(5, 2)),  # md 5, s2 2: 6 steps, -5 .. 5
             # stride2 65 and 91: fp32 tiles past shared memory take the
             # kernel's direct path
             ((1, 8, 4, 2048), _disp(650, 65)),
             ((2, 16, 6, 300), _disp(182, 91))]
# channelnorm: FlowNet2's 3-channel image differences (4 calls per
# forward) and 2-channel flows (2 calls), 6 pairs, timed per frame pair;
# edge shapes (shape, p, byte offset of the data past a 16-byte boundary):
# p = 2, 1 and 3, an H W that is not a multiple of 4, and contiguous
# inputs that start 4 bytes past a 16-byte boundary
CN_PATH = [((6, 3, 512, 1024), 4), ((6, 2, 512, 1024), 2)]
CN_EDGE = [((1, 1, 5, 7), 2, 0), ((2, 5, 3, 3), 1, 0), ((2, 5, 3, 3), 3, 0),
           ((2, 3, 5, 7), 2, 0), ((2, 3, 8, 16), 2, 4), ((1, 3, 512, 1024), 2, 4)]
# kernel vs plain version: fp32 max-abs (the same fp32 products summed
# in another order, with fused multiply-adds; outputs of magnitude < 40);
# bf16 max-abs over the plain output's max magnitude (both round once)
TOL_CORR_FP32 = 1e-5
TOL_CN_FP32 = 1e-5
TOL_FLOW_BF16_REL = 1e-2
# the teacher path
TEACHER_CLIP = (2, 4, 3, 512, 1024)  # train batch 2 x initial_sequence_length 4
TEACHER_LAUNCHES = {"correlation": 1, "channelnorm": 6, "resample2d": 5}
TEACHER_CHECK_HW = (128, 256)
# the card's flow against the port's CPU run of the same weights (TF32
# off), max-abs over the flow's max magnitude: cuDNN's and the CPU's fp32
# convolutions sum in other orders through ~100 layers
TOL_TEACHER_REL = 1e-3
TEACHER_PARAMS = 162_518_834

# the training entry (phase 8): a seeded packed dataset of the fixtures'
# size (rows, columns) trains 6 iterations, resumes to 8, survives a
# corrupted checkpoint and feeds inference; snapshots every 7 iterations
# (7 is mid-epoch: 8 items at batch 4 make 2 iterations an epoch), images
# every 3 (each image snapshot runs G and its averaged copy once)
ENTRY_ITEMS = 8
ENTRY_HW = (300, 320)
ENTRY_NUM_CLASSES = 183
ENTRY_SEED = 0
ENTRY_RUNS = (6, 8)
ENTRY_OVERRIDES = {"snapshot_save_iter": 7, "logging_iter": 2,
                   "image_save_iter": 3, "checkpoints_to_keep": 2}


def phase(label, **fields):
    print(json.dumps({"phase": label, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of fn(), L2 flushed (a 64 MiB write) before each
    launch so every call finds its inputs in device memory. A spin
    kernel queued before each start event keeps the card busy while the
    host enqueues fn's launches, so the events time the device work and
    not the host's Python overhead (which, without the spin, shows in
    the times of the small shapes)."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bf16_ulps(got, want, scale=None):
    """Largest |got - want| in units of the bf16 spacing at |scale|
    (default |want|), over the elements."""
    w = (want if scale is None else scale).float().abs().clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def dx_term_scale(x, gammas, mean, rstd, g):
    """rstd (|g_hat| + |mean(g_hat)| + |x_hat mean(g_hat x_hat)|): the
    magnitude of the terms whose sum is the backward's dx, element by
    element (the plain version's arithmetic)."""
    mean, rstd = mean[..., None, None], rstd[..., None, None]
    xhat = (x.float() - mean) * rstd
    ghat = g.float() * sum((gm.float() for gm in gammas), 1.0)
    m1 = ghat.mean(dim=(2, 3), keepdim=True)
    m2 = (ghat * xhat).mean(dim=(2, 3), keepdim=True)
    return rstd * (ghat.abs() + m1.abs() + (xhat * m2).abs())


def modulation_bound_ms(shape, n_pairs, elem_bytes):
    """Least time for one call: x, each gamma/beta read once and out
    written once at HBM rate, against ~(7 + 2 n_pairs) fp32 flops per
    element (mean, centred square, normalize, sums, fma) at the fp32
    peak; the larger of the two."""
    numel = int(np.prod(shape))
    bytes_ms = (2 + 2 * n_pairs) * numel * elem_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (7 + 2 * n_pairs) * numel / FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def modulation_bwd_bound_ms(shape, n_pairs, elem_bytes):
    """Least time for one backward call: x, g and each gamma read once
    and dx and dgamma written once at HBM rate, against ~(10 + n_pairs)
    fp32 flops per element (x_hat, g_hat, two products, two sums, dx) at
    the fp32 peak; the larger of the two."""
    numel = int(np.prod(shape))
    bytes_ms = (4 + n_pairs) * numel * elem_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (10 + n_pairs) * numel / FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def ptxas_kernels(log):
    """Each kernel of an ``nvcc -Xptxas=-v`` log: its (mangled) name,
    registers and spill bytes (stores + loads)."""
    kernels, current = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = {"name": m.group(1), "registers": None, "spill_bytes": None}
            kernels.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return [k for k in kernels if k["registers"] is not None]


def modulation_inputs(shape, n_pairs, dtype, gen, offset=0):
    """x (starting ``offset`` bytes past a 16-byte boundary), the gammas,
    the betas and an output gradient g, seeded from ``gen``."""
    def draw(scale, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)

    x = at_offset(draw(2.0, 0.5), offset)
    gs = [draw(0.3) for _ in range(n_pairs)]
    bs = [draw(0.3) for _ in range(n_pairs)]
    return x, gs, bs, draw(1.0)


def modulation_errors(spade_mod, x, gs, bs, g, fwd=None, bwd=None):
    """Hold one forward launch ``fwd(x, gs, bs) -> (out, mean, rstd)``
    and one backward launch ``bwd(x, gs, mean, rstd, g) -> (dx, dgamma)``
    (default: the wrapper's kernels under their plans; None skips it)
    against the plain versions on the same inputs, the backward on the
    plain statistics. Returns the errors, their bounds and ``ok``."""
    out = {"ok": True}
    if fwd is not None:
        got, mean, rstd = fwd(x, gs, bs)
        mean_p, rstd_p = spade_mod.spade_modulation_stats_plain(x)
        torch.cuda.synchronize()
        stats_err = max(((mean - mean_p).abs().max() / mean_p.abs().max()).item(),
                        ((rstd - rstd_p).abs().max() / rstd_p.abs().max()).item())
        if x.dtype == torch.float32:
            want = spade_mod.spade_modulation_plain(x, gs, bs)
            err, bound = (got - want).abs().max().item(), TOL_FP32
        else:
            want = spade_mod.spade_modulation_plain(x, gs, bs, stats=(mean, rstd))
            err, bound = bf16_ulps(got, want), TOL_BF16_ULPS
        out.update(forward_error=err, forward_bound=bound,
                   statistics_error=stats_err)
        out["ok"] &= err <= bound and stats_err <= TOL_STATS_REL
    if bwd is not None:
        mean_p, rstd_p = spade_mod.spade_modulation_stats_plain(x)
        dx, dgamma = bwd(x, gs, mean_p, rstd_p, g)
        dx_p, dgamma_p = spade_mod.spade_modulation_bwd_plain(x, gs, mean_p, rstd_p, g)
        torch.cuda.synchronize()
        if x.dtype == torch.float32:
            errs = [((dx - dx_p).abs().max() / dx_p.abs().max()).item(),
                    ((dgamma - dgamma_p).abs().max() / dgamma_p.abs().max()).item()]
            bounds = [TOL_BWD_DX_REL, TOL_BWD_DGAMMA_REL]
        else:
            errs = [bf16_ulps(dx, dx_p, dx_term_scale(x, gs, mean_p, rstd_p, g)),
                    bf16_ulps(dgamma, dgamma_p)]
            bounds = [TOL_BF16_ULPS, TOL_BF16_ULPS]
        out["ok"] &= all(e <= b for e, b in zip(errs, bounds))
        if x.dtype != torch.float32:
            errs.append(bf16_ulps(dx, dx_p))  # of dx's own value
        out.update(backward_errors=errs, backward_bounds=bounds)
    return out


def modulation_routes(spade_mod, x, n_pairs):
    """The plan routes of the forward and the backward for x."""
    b, c, h, w = x.shape
    aligned = x.data_ptr() % 16 == 0
    return [spade_mod.modulation_plan(b * c, h * w, x.dtype, n_pairs, aligned,
                                      backward)["route"]
            for backward in (False, True)]


def check_modulation(spade_mod):
    """Phase 3: forward and backward kernels vs their plain versions at
    every main-path shape, n_pairs 1 and 2, and at MODULATION_EDGE, fp32
    and bf16; times at the main-path shapes at n_pairs 1 (the main paths'
    case), fp32 and bf16. Returns the forward rows, the backward rows,
    and the forward's and the backward's fp32 errors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    fwd = lambda x, gs, bs: spade_mod._launch_fwd(x, gs, bs, 1e-5)  # noqa: E731
    bwd = spade_mod._launch_bwd
    rows, bwd_rows, max_err, bwd_err = [], [], 0.0, 0.0
    cases = [(shape, calls, n_pairs, 0) for shape, calls in MODULATION_SHAPES
             for n_pairs in (1, 2)]
    cases += [(shape, 0, n_pairs, offset) for shape, n_pairs, offset in MODULATION_EDGE]
    for shape, calls, n_pairs, offset in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, gs, bs, g = modulation_inputs(shape, n_pairs, dtype, gen, offset)
            name = f"{str(dtype).split('.')[-1]} n_pairs={n_pairs}"
            errs = modulation_errors(spade_mod, x, gs, bs, g, fwd, bwd)
            routes = modulation_routes(spade_mod, x, n_pairs)
            phase("kernel_check", name="spade_modulation", shape=list(shape),
                  case=name, offset=offset, routes=routes, **errs)
            if not errs["ok"]:
                raise AssertionError(f"spade_modulation {shape} {name} offset "
                                     f"{offset}: {errs}")
            if dtype == torch.float32:
                max_err = max(max_err, errs["forward_error"])
                bwd_err = max(bwd_err, *errs["backward_errors"])
            if n_pairs == 1 and calls:
                mean_p, rstd_p = spade_mod.spade_modulation_stats_plain(x)
                size = x.element_size()
                bound, bound_by = modulation_bound_ms(shape, 1, size)
                row = {"shape": list(shape), "calls": calls, "dtype": name,
                       "route": routes[0],
                       "ms": time_ms(lambda: fwd(x, gs, bs)),
                       "plain_ms": time_ms(lambda: spade_mod.spade_modulation_plain(x, gs, bs)),
                       "bound_ms": bound, "bound_by": bound_by,
                       "max_abs_err": errs["forward_error"]}
                row["bound_share"] = row["bound_ms"] / row["ms"]
                rows.append(row)
                phase("kernel", name="spade_modulation", **row)
                bound, bound_by = modulation_bwd_bound_ms(shape, 1, size)
                row = {"shape": list(shape), "calls": calls, "dtype": name,
                       "route": routes[1],
                       "ms": time_ms(lambda: bwd(x, gs, mean_p, rstd_p, g)),
                       "plain_ms": time_ms(lambda: spade_mod.spade_modulation_bwd_plain(
                           x, gs, mean_p, rstd_p, g)),
                       "bound_ms": bound, "bound_by": bound_by,
                       "errors": errs["backward_errors"]}
                row["bound_share"] = row["bound_ms"] / row["ms"]
                bwd_rows.append(row)
                phase("kernel", name="spade_modulation_bwd", **row)
            del x, gs, bs, g
    torch.cuda.empty_cache()
    return rows, bwd_rows, max_err, bwd_err


def resample_bound_ms(shape, elem_bytes, flow_bytes=4):
    """Least time for one warp: x and flow read once and out written
    once at HBM rate, against ~(12 + 7 C) fp32 flops per pixel
    (coordinates, floors, weights; 4 products and 3 sums per channel)
    at the fp32 peak; the larger of the two."""
    b, c, h, w = shape
    pixels = b * h * w
    bytes_ms = (2 * c * elem_bytes + 2 * flow_bytes) * pixels / HBM_BYTES_PER_S * 1e3
    ops_ms = (12 + 7 * c) * pixels / FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def mixed_flow(shape, gen):
    """(B, 2, H, W) pixel flow whose pixels are, at random, fractional,
    integer-valued, zero or 1.5 frame sizes out of the frame."""
    b, _, h, w = shape
    kind = torch.randint(0, 4, (b, 1, h, w), generator=gen, device="cuda")
    frac = torch.rand((b, 2, h, w), generator=gen, device="cuda") * 6 - 3
    integer = torch.randint(-4, 5, (b, 2, h, w), generator=gen,
                            device="cuda").float()
    sign = torch.randint(0, 2, (b, 2, h, w), generator=gen, device="cuda") * 2 - 1
    outside = sign * 1.5 * torch.tensor([w, h], device="cuda").view(1, 2, 1, 1)
    return torch.where(kind == 0, frac, torch.where(
        kind == 1, integer, torch.where(kind == 2, torch.zeros_like(frac), outside)))


def wide_flow(shape, gen):
    """(B, 2, H, W) fractional flow of up to 300 pixels: corners far from
    their pixel's tile, many of them outside the frame."""
    b, _, h, w = shape
    return torch.rand((b, 2, h, w), generator=gen, device="cuda") * 600 - 300


def smooth_flow(shape):
    """A smooth flow field of a few pixels, as optical flow is."""
    b, _, h, w = shape
    ys = torch.linspace(0, 6.283, h, device="cuda").view(1, h, 1)
    xs = torch.linspace(0, 6.283, w, device="cuda").view(1, 1, w)
    return torch.stack([3.3 * torch.sin(ys + 2 * xs), 2.1 * torch.cos(3 * ys - xs)],
                       dim=1).expand(b, 2, h, w).contiguous()


def border_grid(flow):
    """grid_sample's grid for the same warp: align_corners=True maps
    pixel centres 0 .. W-1 onto -1 .. 1."""
    _, _, h, w = flow.shape
    xs = torch.arange(w, device=flow.device).view(1, 1, w) + flow[:, 0]
    ys = torch.arange(h, device=flow.device).view(1, h, 1) + flow[:, 1]
    return torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], dim=-1)


def check_resample(rs):
    """Phase 3b: resample2d kernel vs plain at the paths' shapes and the
    edge cases, in the four combinations of fp32 and bf16 x and flow;
    times at the paths' shapes, fp32, under the mixed and the smooth flow,
    beside the plain version, the bytes bound and F.grid_sample."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4321)
    rows, max_err = [], 0.0
    for shape, x_offset, flow_offset, kind in RESAMPLE_CASES:
        x32 = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
        flow = (mixed_flow if kind == "mixed" else wide_flow)(shape, gen)
        for x_dtype in (torch.float32, torch.bfloat16):
            for flow_dtype in (torch.float32, torch.bfloat16):
                x = at_offset(x32.to(x_dtype), x_offset)
                f = at_offset(flow.to(flow_dtype), flow_offset)
                with torch.no_grad():
                    got = rs.resample2d(x, f)
                want = rs.resample2d_plain(x, f)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if x_dtype == torch.float32:
                    max_err = max(max_err, err)
                    ok = err <= TOL_RESAMPLE_FP32
                else:
                    err = err / want.float().abs().max().item()
                    ok = err <= TOL_RESAMPLE_BF16_REL
                label = (f"{str(x_dtype).split('.')[-1]}/flow-"
                         f"{str(flow_dtype).split('.')[-1]}")
                if not ok:
                    raise AssertionError(f"resample2d {shape} {label} offsets "
                                         f"{x_offset}/{flow_offset}: error {err}")
                phase("kernel_check", name="resample2d", shape=list(shape),
                      dtype=label, offsets=[x_offset, flow_offset], flow=kind,
                      error=err)
        if shape in (RESAMPLE_PATH_SHAPE, RESAMPLE_TEACHER_SHAPE):
            bound, bound_by = resample_bound_ms(shape, 4)
            row = {"shape": list(shape), "calls": 1,
                   "plain_ms": time_ms(lambda: rs.resample2d_plain(x32, flow)),
                   "bound_ms": bound, "bound_by": bound_by, "flows": {}}
            for name, f in (("mixed", flow), ("smooth", smooth_flow(shape))):
                row["flows"][name] = time_resample(rs, x32, f)
            # the kernels line reads the mixed flow's times
            row["ms"] = row["flows"]["mixed"]["ms"]
            row["library_ms"] = row["flows"]["mixed"]["library_ms"]
            row["bound_share"] = bound / row["ms"]
            rows.append(row)
            phase("kernel", name="resample2d", **row)
    for row in rows:
        row["max_abs_err"] = max_err
    torch.cuda.empty_cache()
    return rows, max_err


def time_resample(rs, x, flow):
    """The kernel's and F.grid_sample's times for one warp of x by flow,
    and the kernel's share of its bytes bound."""
    import torch.nn.functional as F

    grid = border_grid(flow.float())
    ms = time_ms(lambda: rs.resample2d(x, flow))
    bound, _ = resample_bound_ms(tuple(x.shape), x.element_size(),
                                 flow.element_size())
    return {"ms": ms, "bound_share": bound / ms,
            "library_ms": time_ms(lambda: F.grid_sample(
                x.float(), grid, mode="bilinear", padding_mode="border",
                align_corners=True))}


def one_hot_request(rng, seed):
    from imaginaire_tpu_torch.serving.engine import ServeRequest

    idx = rng.randint(0, NUM_LABELS, (1, 256, 256))
    label = np.zeros((1, 256, 256, NUM_LABELS), np.float32)
    np.put_along_axis(label, idx[..., None], 1.0, axis=-1)
    return ServeRequest({"label": label}, seed=seed)


def set_fused(net, value):
    from imaginaire_tpu_torch.layers.activation_norm import SpatiallyAdaptiveNorm

    for m in net.modules():
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
    set_fused(engine.trainer.net_G, "none")
    try:
        unfused = engine._run(host, seeds)
    finally:
        set_fused(engine.trainer.net_G, "auto")
    fused_err = float(np.abs(fused - unfused).max())
    alone = engine._run({"label": chunk[1].data["label"]}, [chunk[1].seed])
    lane_err = float(np.abs(alone[0] - fused[1]).max())
    torch.backends.cudnn.allow_tf32 = True
    breakdown = profile_call(lambda: engine._run(host, seeds))
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


def train_batch(gen, batch=TRAIN_BATCH):
    """Seeded one-hot labels (185 channels) and images in [-1, 1], made
    on the card."""
    idx = torch.randint(0, NUM_LABELS, (batch, 256, 256), generator=gen,
                        device="cuda")
    label = torch.nn.functional.one_hot(idx, NUM_LABELS).permute(0, 3, 1, 2)
    images = torch.rand((batch, 3, 256, 256), generator=gen, device="cuda") * 2 - 1
    return {"label": label.float().contiguous(), "images": images}


def train_config(instance=True):
    from imaginaire_tpu_torch.config import Config

    cfg = Config(CONFIG)
    if instance:
        cfg.gen.activation_norm_params.activation_norm_type = "instance"
    # no VGG19 weights in the repository: the perceptual loss draws them
    cfg.trainer.perceptual_loss.allow_random_init = True
    return cfg


def dg_step(trainer, data):
    """One D step then one G step; returns both steps' losses as floats."""
    d = trainer.dis_update(data)
    g = trainer.gen_update(data)
    return {**{f"D/{k}": float(v) for k, v in d.items()},
            **{f"G/{k}": float(v) for k, v in g.items()}}


def _snapshot(trainer):
    nets = (trainer.net_G, trainer.net_D)
    return ([{k: v.clone() for k, v in n.state_dict().items()} for n in nets],
            [([t.clone() for t in o.state_tensors()], o.count)
             for o in (trainer.opt_G, trainer.opt_D)],
            {k: v.clone() for k, v in trainer.ema_G.items()},
            trainer.num_ema_updates)


def _restore(trainer, snap):
    nets, opts, ema, n_ema = snap
    for net, sd in zip((trainer.net_G, trainer.net_D), nets):
        net.load_state_dict(sd)
    with torch.no_grad():
        for opt, (tensors, count) in zip((trainer.opt_G, trainer.opt_D), opts):
            for t, v in zip(opt.state_tensors(), tensors):
                t.copy_(v)
            opt.count = count
        for k, v in ema.items():
            trainer.ema_G[k].copy_(v)
    trainer.num_ema_updates = n_ema


def spade_train_path(spade_mod):
    """Phase 7: SPADE training, the D+G step, at COCO-Stuff width on the
    card (batch 4, 256x256, bf16 with fp32 masters, remat blocks)."""
    from imaginaire_tpu_torch.trainers.spade import Trainer

    torch.backends.cudnn.allow_tf32 = True  # training runs the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(train_config(), device="cuda", train=True)
    trainer.init_state(seed=0)
    setup_s = time.perf_counter() - t0
    if trainer.compute_dtype != torch.bfloat16:
        raise AssertionError(f"compute dtype {trainer.compute_dtype}, expected bf16")
    gen = torch.Generator(device="cuda").manual_seed(7)
    data = train_batch(gen)
    watch = {"G": next(p for n, p in trainer.net_G.named_parameters()
                       if n.endswith("head_0.conv.weight")),
             "D": next(p for n, p in trainer.net_D.named_parameters()
                       if n.endswith("layer0.conv.weight"))}
    watch_u = {"G": trainer.net_G.spade_generator.head_0.conv.u,
               "D": trainer.net_D.patch_d_0.layer0.conv.u}
    before = {k: v.detach().clone() for k, v in {**watch, **{
        f"u_{k}": v for k, v in watch_u.items()}}.items()}

    spade_mod.launches = spade_mod.bwd_launches = 0
    step_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(dg_step(trainer, data))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"forward": spade_mod.launches, "backward": spade_mod.bwd_launches}
    expected = {"forward": TRAIN_STEPS * TRAIN_FWD_LAUNCHES,
                "backward": TRAIN_STEPS * TRAIN_BWD_LAUNCHES}
    if launches != expected:
        raise AssertionError(f"training launches {launches}, expected {expected}")
    bad = [(i, k, v) for i, step in enumerate(losses) for k, v in step.items()
           if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"non-finite training losses {bad[:5]}")
    after = {**watch, **{f"u_{k}": v for k, v in watch_u.items()}}
    moved = {k: (after[k] - before[k]).abs().max().item() for k in before}
    if not all(v > 0 for v in moved.values()):
        raise AssertionError(f"parameters or u did not move: {moved}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    median_ms = float(np.median(step_ms))

    def one_step():
        dg_step(trainer, data)
        torch.cuda.synchronize()

    breakdown = profile_call(one_step, repeats=2)

    # in situ: one fp32 D+G step (TF32 off) through the kernels against the
    # same step through the plain composition, from the same state
    torch.backends.cudnn.allow_tf32 = False
    trainer.compute_dtype = torch.float32
    noise = {"D": torch.randn((TRAIN_BATCH, trainer.net_G.style_dims),
                              generator=gen, device="cuda"),
             "G": torch.randn((TRAIN_BATCH, trainer.net_G.style_dims),
                              generator=gen, device="cuda")}
    snap = _snapshot(trainer)

    def fp32_step():
        d = trainer.dis_update(data, noise=noise["D"])
        g = trainer.gen_update(data, noise=noise["G"])
        return {**{f"D/{k}": float(v) for k, v in d.items()},
                **{f"G/{k}": float(v) for k, v in g.items()}}

    spade_mod.launches = spade_mod.bwd_launches = 0
    fused = fp32_step()
    fused_launches = {"forward": spade_mod.launches, "backward": spade_mod.bwd_launches}
    _restore(trainer, snap)
    set_fused(trainer.net_G, "none")
    try:
        spade_mod.launches = spade_mod.bwd_launches = 0
        plain = fp32_step()
        plain_launches = {"forward": spade_mod.launches,
                          "backward": spade_mod.bwd_launches}
    finally:
        set_fused(trainer.net_G, "auto")
        trainer.compute_dtype = torch.bfloat16
        torch.backends.cudnn.allow_tf32 = True
    rel = {k: abs(fused[k] - plain[k]) / max(abs(plain[k]), 1e-30)
           for k in plain if not k.endswith("_acc")}
    worst = max(rel, key=rel.get)
    if fused_launches != {"forward": TRAIN_FWD_LAUNCHES,
                          "backward": TRAIN_BWD_LAUNCHES} \
            or plain_launches != {"forward": 0, "backward": 0} \
            or rel[worst] > TOL_TRAIN_REL:
        raise AssertionError(
            f"fp32 step through the kernels vs the composition: {worst} "
            f"differs by {rel[worst]} (tol {TOL_TRAIN_REL}); launches "
            f"{fused_launches} / {plain_launches}")
    del trainer, snap
    torch.cuda.empty_cache()

    # the unmodified config: sync_batch base norms, BatchNorm batch
    # statistics, no modulation kernel
    trainer = Trainer(train_config(instance=False), device="cuda", train=True)
    trainer.init_state(seed=1)
    spade_mod.launches = spade_mod.bwd_launches = 0
    bn = trainer.net_G.spade_generator.head_1.conv_0.norm.BatchNorm_0
    bn_before = bn.mean.clone()
    sync_losses = [dg_step(trainer, data) for _ in range(2)]
    sync_launches = spade_mod.launches + spade_mod.bwd_launches
    if sync_launches or not all(np.isfinite(v) for step in sync_losses
                                for v in step.values()) \
            or torch.equal(bn.mean, bn_before):
        raise AssertionError(f"unmodified config: losses {sync_losses}, "
                             f"modulation launches {sync_launches}, running "
                             f"mean moved {not torch.equal(bn.mean, bn_before)}")
    del trainer
    torch.cuda.empty_cache()
    row = {"setup_s": setup_s, "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
           "step_ms": step_ms, "median_step_ms": median_ms,
           "images_per_s": TRAIN_BATCH / (median_ms / 1e3),
           "peak_mem_gib": peak, "launches": launches,
           "launches_per_step": {"forward": TRAIN_FWD_LAUNCHES,
                                 "backward": TRAIN_BWD_LAUNCHES},
           "first_losses": losses[0], "last_losses": losses[-1],
           "moved": moved, "fp32_fused": fused, "fp32_plain": plain,
           "fp32_worst_rel": [worst, rel[worst]],
           "sync_batch_losses": sync_losses, "step": breakdown}
    phase("spade_train_path", **row)
    return row


def write_entry_dataset(root, items=ENTRY_ITEMS, hw=ENTRY_HW, seed=ENTRY_SEED):
    """Seeded RGB images, seg maps (0..182) and edge maps (0/255) as PNG
    through the port's encoder, packed by the port's builder."""
    from imaginaire_tpu_torch.data.backends import build_packed_dataset
    from imaginaire_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    raw = root / "raw"
    for i in range(items):
        arrays = {"images": rng.randint(0, 256, hw + (3,)),
                  "seg_maps": rng.randint(0, ENTRY_NUM_CLASSES, hw),
                  "edge_maps": (rng.rand(*hw) < 0.1) * 255}
        for data_type, arr in arrays.items():
            (raw / data_type / "seq0001").mkdir(parents=True, exist_ok=True)
            write_png(raw / data_type / "seq0001" / f"{i:05d}.png", arr.astype(np.uint8))
    return build_packed_dataset(str(raw), str(root / "packed"),
                                ["images", "seg_maps", "edge_maps"])


def entry_config(root, packed, overrides=None):
    """The COCO-Stuff config with phase 7's two overrides, its splits
    pointed at the packed dataset, a test split like its val split, the
    short cadences and ``speed_benchmark``; written as YAML for
    ``--config``."""
    import yaml

    from imaginaire_tpu_torch.config import load_yaml, recursive_update

    cfg = load_yaml(CONFIG)
    cfg["gen"]["activation_norm_params"]["activation_norm_type"] = "instance"
    cfg["trainer"]["perceptual_loss"]["allow_random_init"] = True
    for split in ("train", "val"):
        cfg["data"][split]["roots"] = [packed]
    cfg["test_data"] = {key: cfg["data"][key] for key in
                        ("name", "type", "num_workers", "input_types",
                         "input_image", "input_labels")}
    cfg["test_data"]["test"] = dict(cfg["data"]["val"], roots=[packed])
    cfg.update(ENTRY_OVERRIDES)
    # the loop records its timings (each step ends in a device sync)
    cfg["trainer"]["speed_benchmark"] = True
    recursive_update(cfg, overrides or {})
    path = root / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def unbroken_batch(cfg_path, epoch, offset):
    """The batch an uninterrupted run takes ``offset`` batches into
    ``epoch`` (an offset past the epoch rolls into the next one)."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.data import get_train_and_val_dataloader

    loader, _ = get_train_and_val_dataloader(Config(cfg_path), seed=ENTRY_SEED)
    epoch, offset = epoch + offset // len(loader), offset % len(loader)
    loader.set_epoch(epoch)
    for i, batch in enumerate(loader):
        if i == offset:
            return batch
    raise AssertionError(f"epoch {epoch} has no batch {offset}")


def same_batch(a, b):
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k]
        for k in a)


def resumed_run(trainer_cls, args, saved, cfg_path):
    """``train.main(args)`` resuming from the logdir, recording what it
    restored and the first batch it trains on. ``saved``: {path: tensor}
    the restored state must equal bit for bit."""
    from imaginaire_tpu_torch import train

    record = {}
    load, start = trainer_cls.load_checkpoint, trainer_cls.start_of_iteration

    def load_and_compare(self, *a, **k):
        loaded = load(self, *a, **k)
        state = self.state_tensors()
        record.update(iteration=self.current_iteration, epoch=self.current_epoch,
                      offset=self.resume_batch_in_epoch,
                      compared=len(saved), keys_differ=sorted(set(state) ^ set(saved)),
                      mismatched=[key for key, v in saved.items() if key in state
                                  and not torch.equal(state[key].cpu(), v.cpu())])
        return loaded

    def first_batch(self, data, it):
        if it == record.get("iteration") and "batch" not in record:
            record["batch"] = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                               for k, v in data.items()}
        return start(self, data, it)

    trainer_cls.load_checkpoint, trainer_cls.start_of_iteration = load_and_compare, first_batch
    try:
        trainer = train.main(args)
    finally:
        trainer_cls.load_checkpoint, trainer_cls.start_of_iteration = load, start
    want = unbroken_batch(cfg_path, record["epoch"], record["offset"])
    if record["keys_differ"] or record["mismatched"] or "batch" not in record \
            or not same_batch(record["batch"], want):
        raise AssertionError(
            f"resume from iteration {record.get('iteration')}: keys differ "
            f"{record['keys_differ'][:5]}, tensors differ {record['mismatched'][:5]} "
            f"of {len(saved)}, first batch {record.get('batch', {}).get('key')} "
            f"vs an unbroken run's {want['key']}")
    return trainer, record


class HostClocks:
    """Per-iteration host accounting of the training loop: wall time,
    the main thread's CPU time, the whole process's CPU time (the loader
    threads and any other thread) and the time in Python's garbage
    collector, each from the end of ``start_of_iteration`` (the batch's
    copies queued) to the start of ``end_of_iteration``. Installed on the
    trainer class for the ``with`` block."""

    def __init__(self, trainer_cls):
        self.cls, self.steps, self.gc_s, self._gc_t0 = trainer_cls, [], 0.0, None

    def now(self):
        return (time.perf_counter(), time.thread_time(), time.process_time(), self.gc_s)

    def _gc(self, stage, info):
        if stage == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0

    def __enter__(self):
        import gc

        start, end = self.cls.start_of_iteration, self.cls.end_of_iteration
        self._saved, begun = (start, end), []

        def timed_start(trainer, *a, **k):
            data = start(trainer, *a, **k)
            begun.append(self.now())
            return data

        def timed_end(trainer, *a, **k):
            t = self.now()
            if begun:
                self.steps.append([y - x for x, y in zip(begun.pop(), t)])
            return end(trainer, *a, **k)

        self.cls.start_of_iteration, self.cls.end_of_iteration = timed_start, timed_end
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._gc)
        self.cls.start_of_iteration, self.cls.end_of_iteration = self._saved

    def table(self):
        wall, main, process, gc_s = (np.asarray(x) * 1e3 for x in zip(*self.steps))
        return {"step_wall_ms": wall.tolist(), "main_thread_cpu_ms": main.tolist(),
                "other_threads_cpu_ms": (process - main).tolist(),
                "gc_ms": gc_s.tolist()}


def spade_train_entry(spade_mod, device="cuda", overrides=None, items=ENTRY_ITEMS,
                      hw=ENTRY_HW, out_hw=(256, 256)):
    """Phase 8: ``python -m imaginaire_tpu_torch.train`` and ``.inference``
    in-process on a seeded packed dataset of the COCO-Stuff config's
    shapes: train, resume, a corrupted checkpoint, inference."""
    from imaginaire_tpu_torch import inference, train
    from imaginaire_tpu_torch.data.png import decode_png
    from imaginaire_tpu_torch.resilience.integrity import verify_files
    from imaginaire_tpu_torch.trainers import base as trainer_base
    from imaginaire_tpu_torch.trainers.spade import Trainer
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # training runs the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="spade_train_entry_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        packed = write_entry_dataset(tmp, items, hw)
        data_s = time.perf_counter() - t0
        cfg_path = entry_config(tmp, packed, overrides)
        logdir = tmp / "log"
        args = ["--config", str(cfg_path), "--logdir", str(logdir),
                "--seed", str(ENTRY_SEED), "--device", device]

        # 1. train
        saves = []
        save = Trainer.save_checkpoint

        def timed_save(self, *a, **k):
            t = time.perf_counter()
            path = save(self, *a, **k)
            saves.append(time.perf_counter() - t)
            return path

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        import gc
        import threading

        # the profiles of phases 4-7 leave ~0.9 M objects, most of them
        # cyclic garbage that only a full collection frees: left alone, the
        # first one lands inside an entry iteration (1.18 s of 1.82 s on
        # the H100), a cost of this script and not of the entry
        gc.collect()
        census = {"threads": threading.active_count(), "gc_objects": len(gc.get_objects())}
        spade_mod.launches = spade_mod.bwd_launches = 0
        Trainer.save_checkpoint = timed_save
        try:
            with HostClocks(Trainer) as clocks:
                t0 = time.perf_counter()
                trainer = train.main(args + ["--max_iter", str(ENTRY_RUNS[0])])
                train_s = time.perf_counter() - t0
        finally:
            Trainer.save_checkpoint = save
        launches = {"forward": spade_mod.launches, "backward": spade_mod.bwd_launches}
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
        n_images = len(list((logdir / "images").glob("*.png")))
        want = {"forward": ENTRY_RUNS[0] * TRAIN_FWD_LAUNCHES
                + n_images * 2 * CALLS_PER_FORWARD,
                "backward": ENTRY_RUNS[0] * TRAIN_BWD_LAUNCHES}
        if launches != want or trainer.compute_dtype != torch.bfloat16 \
                or n_images != ENTRY_RUNS[0] // ENTRY_OVERRIDES["image_save_iter"]:
            raise AssertionError(f"training entry launches {launches}, expected "
                                 f"{want} ({n_images} image snapshots); compute "
                                 f"dtype {trainer.compute_dtype}")
        scalars = [r for r in ScalarWriter(logdir).read() if r["kind"] == "counter"
                   and r["name"].split("/")[0] in ("gen_update", "dis_update")]
        bad = [r for r in scalars if not np.isfinite(r["value"])
               or r["name"].endswith("nonfinite_count")]
        if len(scalars) < 2 or bad:
            raise AssertionError(f"meters.jsonl: {len(scalars)} loss scalars, "
                                 f"non-finite {bad[:5]}")
        saved = {k: v.detach().cpu().clone() for k, v in trainer.state_tensors().items()}
        timings = {k: list(v) for k, v in trainer.timings.items()}
        del trainer
        if cuda:
            torch.cuda.empty_cache()
        # the pointed checkpoint's files verify against its sidecar (the
        # resume below holds its tensors to the final state bit for bit)
        path6 = ckpt_lib.latest_checkpoint_path(str(logdir))
        integrity = ckpt_lib.read_integrity_sidecar(path6)
        t0 = time.perf_counter()
        verify_files(path6, integrity["files"], context=path6)
        verify_s = time.perf_counter() - t0
        if ckpt_lib.parse_checkpoint_name(path6)[1] != ENTRY_RUNS[0] \
                or integrity["n_leaves"] != len(saved):
            raise AssertionError(f"checkpoint {path6}: {integrity['n_leaves']} "
                                 f"tensor records for {len(saved)} tensors")

        # 2. resume: every restored tensor bit for bit, the next batch
        spade_mod.launches = spade_mod.bwd_launches = 0
        t0 = time.perf_counter()
        trainer, resume = resumed_run(Trainer, args + ["--max_iter", str(ENTRY_RUNS[1])],
                                      saved, cfg_path)
        resume_s = time.perf_counter() - t0
        resume_launches = {"forward": spade_mod.launches,
                           "backward": spade_mod.bwd_launches}
        n = ENTRY_RUNS[1] - ENTRY_RUNS[0]
        if resume["iteration"] != ENTRY_RUNS[0] or trainer.current_iteration != ENTRY_RUNS[1] \
                or resume_launches != {"forward": n * TRAIN_FWD_LAUNCHES,
                                       "backward": n * TRAIN_BWD_LAUNCHES}:
            raise AssertionError(f"resume at {resume['iteration']} to "
                                 f"{trainer.current_iteration}, launches {resume_launches}")
        del trainer, saved
        if cuda:
            torch.cuda.empty_cache()

        # 3. a corrupted newest checkpoint: quarantined, the older one loads
        newest = ckpt_lib.latest_checkpoint_path(str(logdir))
        older = ckpt_lib.scan_checkpoints(str(logdir))[-2][2]
        with open(Path(newest) / ckpt_lib.STATE_FILE, "r+b") as f:
            f.seek(f.seek(0, 2) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        payload, restored, fallbacks = ckpt_lib.load_latest_verified(str(logdir))
        if fallbacks != 1 or restored != os.path.abspath(older) or Path(newest).exists() \
                or not Path(newest + ".corrupt").is_dir():
            raise AssertionError(f"corrupted {newest}: restored {restored} after "
                                 f"{fallbacks} fallbacks, expected {older}")
        # ... and the run resumes from it, mid-epoch
        trainer, fallback_resume = resumed_run(
            Trainer, args + ["--max_iter", str(ENTRY_RUNS[1])], payload["state"], cfg_path)
        if fallback_resume["offset"] == 0 or trainer.current_iteration != ENTRY_RUNS[1]:
            raise AssertionError(f"fallback resume {fallback_resume}")
        del trainer, payload
        if cuda:
            torch.cuda.empty_cache()

        # 4. inference over the test split: one PNG an item
        out_dir = tmp / "inference"
        images = []
        to_image = trainer_base.tensor2im

        def recording(img, *a, **k):
            images.append(np.asarray(img))
            return to_image(img, *a, **k)

        spade_mod.launches = 0
        trainer_base.tensor2im = recording
        try:
            t0 = time.perf_counter()
            inference.main(["--config", str(cfg_path), "--logdir", str(logdir),
                            "--output_dir", str(out_dir), "--device", device])
            inference_s = time.perf_counter() - t0
        finally:
            trainer_base.tensor2im = to_image
        pngs = sorted(out_dir.rglob("*.png"))
        batches = -(-items // 4)
        shapes = {decode_png(p.read_bytes()).shape for p in pngs}
        if len(pngs) != items or len(images) != items or spade_mod.launches != \
                batches * CALLS_PER_FORWARD or shapes != {tuple(out_hw) + (3,)} \
                or not all(np.isfinite(i).all() and np.abs(i).max() <= 1 for i in images):
            raise AssertionError(f"inference: {len(pngs)} PNGs of {shapes}, "
                                 f"{spade_mod.launches} launches")
    ms = {k: [t * 1e3 for t in v] for k, v in timings.items()}
    median_ms = float(np.median(ms["iteration"]))
    # the loop's wall time after the first iteration (kernel build, cuDNN's
    # picks): each batch's data wait and its iteration, less only the
    # image snapshots and meter flushes that end_of_iteration runs after
    # its clock (every 3 and 2 iterations here, far above a real run's)
    window_s = sum(ms["data_wait"][1:] + ms["iteration"][1:]) / 1e3
    row = {"items": items, "hw": list(hw), "batch": 4, "data_s": data_s,
           "train_s": train_s, "iterations": ENTRY_RUNS[0],
           "iteration_ms": ms["iteration"], "median_iteration_ms": median_ms,
           "images_per_s": 4 * (ENTRY_RUNS[0] - 1) / window_s, "window_s": window_s,
           "step_only_images_per_s": 4 / (median_ms / 1e3),
           "dis_step_ms": ms["dis_step"], "gen_step_ms": ms["gen_step"],
           "data_wait_ms": ms["data_wait"], "loader_wait_ms": ms["loader_wait"],
           "median_data_wait_ms": float(np.median(ms["data_wait"])),
           "host": dict(census, **clocks.table()),
           "peak_mem_gib": peak, "launches": launches, "image_snapshots": n_images,
           "launches_per_iteration": {"forward": TRAIN_FWD_LAUNCHES,
                                      "backward": TRAIN_BWD_LAUNCHES},
           "checkpoint_bytes": sum(integrity["files"][f]["size"] for f in integrity["files"]),
           "checkpoint_save_s": saves, "checkpoint_files_verify_s": verify_s,
           "resume_s": resume_s, "resumed_at": resume["iteration"],
           "resume_launches": resume_launches, "tensors_compared": resume["compared"],
           "corrupted": Path(newest).name, "fell_back_to": Path(restored).name,
           "fallback_resume_offset": fallback_resume["offset"],
           "inference_s": inference_s, "inference_images": len(pngs),
           "inference_launches": spade_mod.launches}
    phase("spade_train_entry", **row)
    return row


def one_hot_frame(rng):
    idx = rng.randint(0, V2V_LABELS, (1,) + V2V_HW)
    label = np.zeros((1,) + V2V_HW + (V2V_LABELS,), np.float32)
    np.put_along_axis(label, idx[..., None], 1.0, axis=-1)
    return {"label": label}


def vid2vid_path(rs, spade_mod):
    """Phase 5: vid2vid streams at Cityscapes width on the card."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.serving.engine import engine_from_config

    torch.backends.cudnn.allow_tf32 = True  # serving runs the defaults
    rng = np.random.RandomState(1)
    frames = {sid: [one_hot_frame(rng) for _ in range(n)]
              for sid, n in STREAM_FRAMES.items()}
    torch.cuda.reset_peak_memory_stats()

    spade_mod.launches = 0
    rs.launches = 0
    t0 = time.perf_counter()
    engine = engine_from_config(Config(V2V_CONFIG), device="cuda")
    engine.initialize(seed=0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = engine.warm()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_launches = rs.launches
    streams = {sid: engine.stream(sid) for sid in STREAM_FRAMES}
    outputs = {sid: [] for sid in STREAM_FRAMES}
    frame_ms = {"first": [], "continuation": [], "warp": []}
    stream_launches = {sid: 0 for sid in STREAM_FRAMES}
    for t in range(max(STREAM_FRAMES.values())):
        for sid, session in streams.items():
            if t >= STREAM_FRAMES[sid]:
                continue
            before = rs.launches
            t1 = time.perf_counter()
            outputs[sid].append(session.step(frames[sid][t]))
            kind = ("first", "continuation")[t] if t < 2 else "warp"
            frame_ms[kind].append((time.perf_counter() - t1) * 1e3)
            stream_launches[sid] += rs.launches - before
    launches = rs.launches
    spade_launches = spade_mod.launches
    stats = engine.stats()

    history = engine.trainer.num_frames_G - 1
    warp_frames = {sid: max(n - history, 0) for sid, n in STREAM_FRAMES.items()}
    if warm_launches != 1 or len(next(iter(warm.values()))) != history + 1:
        raise AssertionError(f"warm: {warm_launches} resample2d launches over "
                             f"{warm}, expected 1 warp frame")
    if stream_launches != warp_frames:
        raise AssertionError(f"resample2d launches per stream {stream_launches}, "
                             f"expected one per warp frame {warp_frames}")
    for sid, outs in outputs.items():
        for img in outs:
            if img.shape != (1,) + V2V_HW + (3,) or not np.isfinite(img).all() \
                    or np.abs(img).max() > 1.0:
                raise AssertionError(f"stream {sid}: bad frame {img.shape}, "
                                     f"max {np.abs(img).max()}")

    # stream isolation (TF32 on, as served): B's labels alone in a fresh
    # session give B's frames
    alone = engine.stream("B-alone")
    iso_abs = iso_rel = 0.0
    for t, frame in enumerate(frames["B"]):
        diff = np.abs(alone.step(frame) - outputs["B"][t]).max()
        iso_abs = max(iso_abs, float(diff))
        iso_rel = max(iso_rel, float(diff / np.abs(outputs["B"][t]).max()))
    engine.close_stream("B-alone")

    # the warp on the card, TF32 off: the generator's warped frame
    # against the plain warp of stream A's previous frame by its flow
    torch.backends.cudnn.allow_tf32 = False
    trainer, session = engine.trainer, streams["A"]
    with torch.inference_mode():
        data_t = trainer._get_data_t(engine._to_device(frames["A"][0]), 0,
                                     session.prev_labels, session.prev_images)
        out = trainer._apply_G(engine._variables, data_t)
        prev, flow = session.prev_images[:, -1], out["fake_flow_maps"]
        plain = rs.resample2d_plain(prev, flow)
        warp_err = (out["warped_images"] - plain).abs().max().item()
        warp_rel = warp_err / plain.abs().max().item()
        flow_max = flow.abs().max().item()
        # the kernel on the frame and the flow this path gives it
        captured = time_resample(rs, prev.contiguous(), flow.contiguous())
        captured.update(x_dtype=str(prev.dtype), flow_dtype=str(flow.dtype),
                        shape=list(prev.shape))
    torch.backends.cudnn.allow_tf32 = True
    profile = profile_call(lambda: session._advance(frames["A"][0]))
    if warp_err > TOL_WARP or warp_rel > TOL_WARP_REL \
            or iso_abs > TOL_STREAM or iso_rel > TOL_STREAM_REL:
        raise AssertionError(f"warp vs plain {warp_err} / {warp_rel} of the "
                             f"frame (tol {TOL_WARP} / {TOL_WARP_REL}), "
                             f"isolation {iso_abs} / {iso_rel} of the frame "
                             f"(tol {TOL_STREAM} / {TOL_STREAM_REL})")
    params = sum(p.numel() for p in engine.trainer.net_G.parameters())
    row = {"setup_s": setup_s, "warm_s": warm_s, "warm_ms": warm,
           "frames": {sid: len(o) for sid, o in outputs.items()},
           "frame_ms": frame_ms, "exec_ms": stats["exec_ms"],
           "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
           "launches": launches, "stream_launches": stream_launches,
           "warm_launches": warm_launches,
           "spade_modulation_launches": spade_launches,
           "generator_params": params, "warp_vs_plain_max_abs": warp_err,
           "warp_vs_plain_rel": warp_rel,
           "flow_max_abs": flow_max, "resample2d_path_flow": captured,
           "isolation_max_abs": iso_abs,
           "isolation_rel": iso_rel,
           "frame_max_abs": max(float(np.abs(o).max()) for outs in outputs.values()
                                for o in outs),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "warp_frame": profile}
    phase("vid2vid_path", **row)
    return row


def correlation_bound_ms(shape, n_dd, elem_bytes):
    """Least time for one call: x1 and x2 read once and out written once
    at HBM rate, against the faster of the two exact routes for one
    multiply-add (2 flops) per channel of every output: fp32 on the CUDA
    cores at the fp32 peak, or 3xTF32 (three products each) on the tensor
    cores at the TF32 peak; the larger of bytes and operations. Returns
    (ms, "bytes" or "operations", the operations' route)."""
    b, c, h, w = shape
    pixels = b * h * w
    bytes_ms = (2 * c + n_dd) * pixels * elem_bytes / HBM_BYTES_PER_S * 1e3
    flops = 2 * c * n_dd * pixels
    ops_ms, route = min((flops / FP32_FLOPS * 1e3, "fp32 CUDA cores"),
                        (3 * flops / TF32_FLOPS * 1e3, "3xTF32 tensor cores"))
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", route
    return ops_ms, "operations", route


def channelnorm_bound_ms(shape, elem_bytes):
    """Least time for one call: x read once and out written once at HBM
    rate, against a multiply-add per element and a root per pixel at the
    fp32 peak; the larger of the two."""
    b, c, h, w = shape
    pixels = b * h * w
    bytes_ms = (c + 1) * pixels * elem_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (2 * c + 1) * pixels / FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def check_against_plain(name, got, want, dtype, tol_fp32, **fields):
    """Raise unless got equals want within the stated tolerance; returns
    the error (max-abs in fp32, relative to the output in bf16)."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        ok = err <= tol_fp32
    else:
        err = err / max(want.float().abs().max().item(), 1e-30)
        ok = err <= TOL_FLOW_BF16_REL
    if not ok:
        raise AssertionError(f"{name} {fields} {dtype}: error {err}")
    phase("kernel_check", name=name, dtype=str(dtype).split(".")[-1],
          error=err, **fields)
    return err


def check_correlation(corr):
    """Phase 3c: correlation kernel vs plain at the path's shape and the
    edge shapes, fp32 and bf16; times per frame pair (and for the path's
    6 pairs), fp32, beside the plain version and the operations bound.
    No single PyTorch call computes the cost volume."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2468)
    rows, max_err = [], 0.0
    for shape, kw in [(CORR_PATH_SHAPE, FLOWNETC)] + CORR_EDGE:
        x1 = torch.randn(shape, generator=gen, device="cuda")
        x2 = torch.randn(shape, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            a, b = x1.to(dtype), x2.to(dtype)
            with torch.no_grad():
                got = corr.correlation(a, b, **kw)
            err = check_against_plain("correlation", got,
                                      corr.correlation_plain(a, b, **kw), dtype,
                                      TOL_CORR_FP32, shape=list(shape), **kw)
            if dtype == torch.float32:
                max_err = max(max_err, err)
    for shape in (CORR_PAIR_SHAPE, CORR_PATH_SHAPE):
        x1 = torch.randn(shape, generator=gen, device="cuda")
        x2 = torch.randn(shape, generator=gen, device="cuda")
        n_d = corr.num_displacements(FLOWNETC["max_displacement"],
                                     FLOWNETC["stride2"])
        bound, bound_by, route = correlation_bound_ms(shape, n_d * n_d, 4)
        row = {"shape": list(shape), "calls": 1, "bound_route": route,
               "ms": time_ms(lambda: corr.correlation(x1, x2, **FLOWNETC)),
               "plain_ms": time_ms(lambda: corr.correlation_plain(x1, x2, **FLOWNETC),
                                   iters=5, warmup=1),
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
               "max_abs_err": max_err}
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        phase("kernel", name="correlation", **row)
    torch.cuda.empty_cache()
    return rows, max_err


def at_offset(x, offset_bytes):
    """x itself, or a contiguous copy whose data starts ``offset_bytes``
    past a 16-byte boundary (a view into a larger buffer)."""
    if not offset_bytes:
        return x
    pad = offset_bytes // x.element_size()
    view = torch.zeros(x.numel() + pad, dtype=x.dtype, device=x.device)[pad:]
    view = view.view(x.shape).copy_(x)
    if not view.is_contiguous() or view.data_ptr() % 16 != offset_bytes:
        raise AssertionError(f"no contiguous view at offset {offset_bytes}")
    return view


def check_channelnorm(cn):
    """Phase 3d: channelnorm kernel vs plain at the path's shapes and the
    edge shapes, fp32 and bf16; times per frame pair (and for the path's
    6 pairs), fp32, beside the plain version, the bytes bound and
    torch.linalg.vector_norm."""
    gen = torch.Generator(device="cuda").manual_seed(1357)
    rows, max_err = [], 0.0
    for shape, p, offset in [(shape, 2, 0) for shape, _ in CN_PATH] + CN_EDGE:
        x = torch.randn(shape, generator=gen, device="cuda") * 10
        for dtype in (torch.float32, torch.bfloat16):
            xd = at_offset(x.to(dtype), offset)
            with torch.no_grad():
                got = cn.channelnorm(xd, p)
            err = check_against_plain("channelnorm", got,
                                      cn.channelnorm_plain(xd, p), dtype,
                                      TOL_CN_FP32, shape=list(shape), p=p,
                                      offset_bytes=offset)
            if dtype == torch.float32:
                max_err = max(max_err, err)
    for shape, calls in CN_PATH:
        for batch in (1, shape[0]):
            bshape = (batch,) + shape[1:]
            x = torch.randn(bshape, generator=gen, device="cuda") * 10
            bound, bound_by = channelnorm_bound_ms(bshape, 4)
            row = {"shape": list(bshape), "calls": calls,
                   "ms": time_ms(lambda: cn.channelnorm(x)),
                   "plain_ms": time_ms(lambda: cn.channelnorm_plain(x)),
                   "library_ms": time_ms(lambda: torch.linalg.vector_norm(
                       x, 2, dim=1, keepdim=True)),
                   "bound_ms": bound, "bound_by": bound_by,
                   "max_abs_err": max_err}
            row["bound_share"] = row["bound_ms"] / row["ms"]
            rows.append(row)
            phase("kernel", name="channelnorm", **row)
    torch.cuda.empty_cache()
    return rows, max_err


def moving_clip(shape, gen):
    """(B, T, 3, H, W) frames in [-1, 1]: a few smooth random waves
    drifting by a pixel or two a frame, plus noise of std 0.05, so that
    the squared warp error of a pixel falls on either side of the
    confidence threshold (0.02; the noise alone gives 0.005 chi2(3)) and
    the confidence check sees both values."""
    b, t, c, h, w = shape
    ys = torch.arange(h, device="cuda", dtype=torch.float32).view(1, 1, 1, h, 1)
    xs = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, 1, 1, w)
    ts = torch.arange(t, device="cuda", dtype=torch.float32).view(1, t, 1, 1, 1)
    frames = torch.zeros(shape, device="cuda")
    for _ in range(4):
        freq = torch.rand((b, 1, c, 1, 2), generator=gen, device="cuda") * 0.05
        phase0 = torch.rand((b, 1, c, 1, 1), generator=gen, device="cuda") * 6.283
        drift = torch.rand((b, 1, 1, 1, 2), generator=gen, device="cuda") * 4 - 2
        frames += torch.sin((xs + drift[..., :1] * ts) * freq[..., :1]
                            + (ys + drift[..., 1:] * ts) * freq[..., 1:] + phase0)
    frames = frames / 4 + 0.05 * torch.randn(shape, generator=gen, device="cuda")
    return frames.clamp(-1, 1).contiguous()


def teacher_path(corr, cn, rs):
    """Phase 6: the FlowNet2 teacher at Cityscapes width on the card."""
    import tempfile

    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.flow.cache import TeacherFlowCache, flow_cache_settings
    from imaginaire_tpu_torch.flow.flow_net import FlowNet
    from imaginaire_tpu_torch.ops import build
    from imaginaire_tpu_torch.trainers.vid2vid import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # the teacher runs the defaults
    cfg = Config(V2V_CONFIG)
    cfg.flow_network.allow_random_init = True
    cfg.flow_network.pop("weights_path", None)
    cfg.flow_cache = {"enabled": True, "mode": "producer"}
    gen = torch.Generator(device="cuda").manual_seed(97531)
    clips = [moving_clip(TEACHER_CLIP, gen) for _ in range(2)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    teacher = trainer.flow_cache
    if teacher is None or teacher.mode != "producer":
        raise AssertionError("the trainer built no producer-mode teacher")
    params = sum(p.numel() for p in teacher.wrapper.model.parameters())

    corr.launches = cn.launches = rs.launches = 0
    outs, attach_ms = [], []
    for clip in clips:
        t1 = time.perf_counter()
        outs.append(trainer._start_of_iteration({"images": clip}, 0))
        torch.cuda.synchronize()
        attach_ms.append((time.perf_counter() - t1) * 1e3)
    launches = {"correlation": corr.launches, "channelnorm": cn.launches,
                "resample2d": rs.launches}

    b, t = TEACHER_CLIP[:2]
    pairs = b * (t - 1)
    expected = {k: n * len(clips) for k, n in TEACHER_LAUNCHES.items()}
    if launches != expected:
        raise AssertionError(f"teacher launches {launches}, expected "
                             f"{TEACHER_LAUNCHES} per forward x {len(clips)}")
    conf_err = 0
    for clip, out in zip(clips, outs):
        flow, conf = out["flow_gt"], out["conf_gt"]
        if tuple(flow.shape) != (b, t - 1, 2) + V2V_HW \
                or tuple(conf.shape) != (b, t - 1, 1) + V2V_HW:
            raise AssertionError(f"teacher shapes {tuple(flow.shape)}, "
                                 f"{tuple(conf.shape)}")
        if not torch.isfinite(flow).all() or not ((conf == 0) | (conf == 1)).all():
            raise AssertionError("teacher flow not finite or conf not in {0, 1}")
        # conf against the threshold of the plain warp by the card's flow
        im_a = clip[:, 1:].reshape((-1, 3) + V2V_HW)
        im_b = clip[:, :-1].reshape((-1, 3) + V2V_HW)
        plain = rs.resample2d_plain(im_b, flow.reshape((-1, 2) + V2V_HW))
        want = (((im_a - plain) ** 2).sum(1, keepdim=True) < 0.02).float()
        conf_err += int((want != conf.reshape(want.shape)).sum().item())
    if conf_err:
        raise AssertionError(f"conf differs from the plain-warp threshold at "
                             f"{conf_err} pixels")
    flow_max = max(o["flow_gt"].abs().max().item() for o in outs)
    conf_mean = sum(o["conf_gt"].mean().item() for o in outs) / len(outs)
    if not 0 < conf_mean < 1:
        raise AssertionError(f"conf is {conf_mean} everywhere: the check "
                             f"above saw one value only")
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the card's flow (TF32 off) against the port's CPU run, same weights
    torch.backends.cudnn.allow_tf32 = False
    small = moving_clip((1, 2, 3) + TEACHER_CHECK_HW, gen)
    card_flow, _ = teacher.wrapper(small[:, 1], small[:, 0])
    cpu = FlowNet(weights_path=teacher.wrapper.weights_path,
                  allow_random_init=True, device="cpu")
    cpu.model.to_empty(device="cpu")
    cpu.model.load_state_dict(teacher.wrapper.model.state_dict())
    cpu.initialized = True
    cpu_flow, _ = cpu(small[:, 1].cpu(), small[:, 0].cpu())
    cpu_scale = cpu_flow.abs().max().item()
    cpu_err = (card_flow.cpu() - cpu_flow).abs().max().item() / max(cpu_scale, 1e-30)
    torch.backends.cudnn.allow_tf32 = True
    if not cpu_scale > 0 or cpu_err > TOL_TEACHER_REL:
        raise AssertionError(f"card flow vs CPU flow: {cpu_err} of the flow's "
                             f"magnitude {cpu_scale} (tol {TOL_TEACHER_REL})")

    # a disk-mode attach: the first call misses and writes, the second
    # hits every pair and returns the same arrays (float16 flow)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        disk = TeacherFlowCache(teacher.wrapper, flow_cache_settings(
            {"flow_cache": {"enabled": True, "mode": "disk"}}), cache_dir=tmp)
        miss = disk.attach({"images": clips[0]})
        hit = disk.attach({"images": clips[0]})
        scale = miss["flow_gt"].abs().max().item()
        disk_err = (hit["flow_gt"] - miss["flow_gt"]).abs().max().item()
        if (disk.pair_misses, disk.pair_hits) != (pairs, pairs) \
                or disk_err > scale * 2.0 ** -10 \
                or not torch.equal(hit["conf_gt"], miss["conf_gt"]):
            raise AssertionError(f"disk cache: misses {disk.pair_misses}, hits "
                                 f"{disk.pair_hits}, flow error {disk_err} "
                                 f"of {scale}")
        disk_stats = disk.drain_stats()

    profile = profile_call(lambda: trainer._start_of_iteration({"images": clips[0]}, 0))
    if params != TEACHER_PARAMS:
        raise AssertionError(f"teacher has {params} parameters, expected "
                             f"{TEACHER_PARAMS}")
    row = {"setup_s": setup_s, "clip": list(TEACHER_CLIP), "pairs_per_attach": pairs,
           "attach_ms": attach_ms, "pair_ms": [ms / pairs for ms in attach_ms],
           "launches": launches, "launches_per_forward": TEACHER_LAUNCHES,
           "teacher_params": params, "flow_max_abs": flow_max,
           "conf_mean": conf_mean, "conf_vs_plain_warp_mismatches": conf_err,
           "card_vs_cpu_rel": cpu_err, "cpu_flow_max_abs": cpu_scale,
           "disk_flow_max_abs_err": disk_err, "disk_stats": disk_stats,
           "peak_mem_gib": peak, "attach": profile}
    phase("teacher_path", **row)
    return row


_FAMILIES = (("spade_modulation_bwd", ("spade_modulation_bwd",)),
             ("spade_modulation", ("spade_modulation",)),
             ("resample2d", ("resample2d",)),
             ("correlation", ("correlation",)),
             ("channelnorm", ("channelnorm",)),
             ("copies", ("Memcpy", "Memset")),
             ("conv", ("conv", "xmma", "cudnn", "implicit", "winograd", "fprop",
                       "cutlass", "sm90")),
             ("gemv/gemm", ("gemv", "gemm", "dot")),
             ("elementwise/reduce", ("elementwise", "reduce", "foreach")))


def profile_call(fn, repeats=5):
    """Where one serving forward's time goes (TF32 on, as served): host-
    clock ms of ``repeats`` calls of ``fn`` (each ends in a device sync
    and the copy back), then one call under torch.profiler with its
    device time summed by kernel family; idle share = 1 - device / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    host = sorted((evt for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CPU),
                  key=lambda evt: -evt.self_cpu_time_total)[:10]
    return {"wall_ms": walls, "profiled_wall_ms": wall_ms,
            "device_ms": device_ms if kernels else "not measured",
            "idle_share": 1 - device_ms / wall_ms if kernels else "not measured",
            "families_ms": families,
            "top_kernels": [{"name": n[:120], "ms": ms, "count": c}
                            for n, (ms, c) in top],
            "top_host_ops": [{"name": evt.key[:80],
                              "self_ms": evt.self_cpu_time_total / 1e3,
                              "count": evt.count} for evt in host]}


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
    from imaginaire_tpu_torch.ops import channelnorm as cn
    from imaginaire_tpu_torch.ops import correlation as corr
    from imaginaire_tpu_torch.ops import resample2d as rs
    from imaginaire_tpu_torch.ops import spade_modulation as spade_mod

    smi = nvidia_smi()
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    libs = build.build_all([spade_mod.KERNEL, rs.KERNEL, corr.KERNEL, cn.KERNEL])
    build_s = time.perf_counter() - t0
    ptxas = {name: [line.strip() for line in
                    Path(f"{lib}.log").read_text().splitlines()
                    if "registers" in line or "spill" in line]
             for name, lib in libs.items()}
    mod_kernels = ptxas_kernels(Path(f"{libs[spade_mod.KERNEL]}.log").read_text())
    phase("build", seconds=build_s, libraries=[str(p) for p in libs.values()],
          ptxas={k: v for k, v in ptxas.items() if k != spade_mod.KERNEL},
          modulation_kernels=mod_kernels)
    spilled = [k for k in mod_kernels if k["spill_bytes"] != 0]
    if not mod_kernels or spilled:
        raise AssertionError(f"spade_modulation kernels spill registers: {spilled}")

    rows, bwd_rows, max_err, bwd_err = check_modulation(spade_mod)
    rs_rows, rs_err = check_resample(rs)
    corr_rows, corr_err = check_correlation(corr)
    cn_rows, cn_err = check_channelnorm(cn)
    main = main_path(spade_mod)
    v2v = vid2vid_path(rs, spade_mod)
    rs_rows[0]["flows"]["vid2vid"] = v2v["resample2d_path_flow"]
    teacher = teacher_path(corr, cn, rs)
    train = spade_train_path(spade_mod)
    entry = spade_train_entry(spade_mod)

    def per_call_set(table, dtype):
        sel = [r for r in table if r["dtype"].startswith(dtype)]
        out = {key: sum(r[key] * r["calls"] for r in sel)
               for key in ("ms", "plain_ms", "bound_ms")}
        out["bound_by"] = max(sel, key=lambda r: r["bound_ms"] * r["calls"])["bound_by"]
        return out

    per_forward = per_call_set(rows, "float32")
    per_backward = per_call_set(bwd_rows, "bfloat16")
    cn_per_pair = [r for r in cn_rows if r["shape"][0] == 1]
    kernels = [{
        "name": "spade_modulation", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/spade_modulation.cu",
        "replaces": "imaginaire_tpu/ops/pallas/spade_modulation_kernel.py:87",
        "launches": main["launches"], "max_abs_err": max_err,
        # the 19 calls of one bs-4 generator forward, fp32, n_pairs 1
        **per_forward, "library_ms": None}, {
        "name": "spade_modulation_bwd", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/spade_modulation.cu",
        "replaces": "imaginaire_tpu/ops/spade_modulation.py:119",
        "launches": train["launches"]["backward"], "max_abs_err": bwd_err,
        # the 19 calls of one G step's backward, bf16 (the training path's
        # type), n_pairs 1; max_abs_err is the fp32 checks' worst error
        # over the plain output's max magnitude
        **per_backward, "library_ms": None}, {
        "name": "resample2d", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/resample2d.cu",
        "replaces": "imaginaire_tpu/ops/pallas/resample2d_kernel.py:87",
        "launches": v2v["launches"], "max_abs_err": rs_err,
        # one warp of the previous (1, 3, 512, 1024) frame, fp32, mixed flow
        **{key: rs_rows[0][key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}, {
        "name": "correlation", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/correlation.cu",
        "replaces": "imaginaire_tpu/ops/pallas/correlation_kernel.py:76",
        "launches": teacher["launches"]["correlation"], "max_abs_err": corr_err,
        # the one call of a FlowNet2 forward of one frame pair, fp32
        **{key: corr_rows[0][key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}, {
        "name": "channelnorm", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/channelnorm.cu",
        "replaces": "imaginaire_tpu/ops/pallas/channelnorm_kernel.py:32",
        "launches": teacher["launches"]["channelnorm"], "max_abs_err": cn_err,
        # the 6 calls (4 of 3 channels, 2 of 2) of a FlowNet2 forward of
        # one frame pair, fp32
        **{key: sum(r[key] * r["calls"] for r in cn_per_pair)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": cn_per_pair[0]["bound_by"]}]
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {"nvidia_smi": smi, "build_s": build_s, "ptxas": ptxas,
             "modulation": rows, "resample2d": rs_rows,
             "correlation": corr_rows, "channelnorm": cn_rows,
             "main_path": main, "vid2vid_path": v2v, "teacher_path": teacher,
             "modulation_bwd": bwd_rows, "spade_train_path": train,
             "spade_train_entry": entry,
             "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
