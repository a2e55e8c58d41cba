#!/usr/bin/env python3
"""Run the PyTorch/H100 port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json PATH]   # from the repository root, one CUDA card

``--json`` also writes the per-shape kernel rows, the main paths'
numbers and their profiles to PATH.

Phases, one line each; any failure exits non-zero:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: compile every kernel of the main paths from csrc/ (one nvcc per
   source, all started together; sm_90a), with ptxas registers and spills;
   it fails if a spade_modulation or a resample2d kernel spills;
3. kernels: hold each kernel against its plain PyTorch version at every
   shape the main paths give it (and at edge shapes: for
   spade_modulation every path of its plan and the plan's boundaries,
   forward and backward in fp32 and bf16, the bf16 forward to one ulp
   given the same statistics, and fs-vid2vid's hyper-route planes up to
   512x512),
   and time both (CUDA events, L2 flushed before each launch) beside the
   card's bound for the same work and, where one exists, the PyTorch
   call that computes the same function; resample2d is timed at both
   paths' shapes under a mixed and a smooth flow, and (in phase 5) on
   the frame and flow the vid2vid path gives it; resample2d's backward
   at the training path's (2, 3, 512, 1024) in fp32 and bf16 under a
   mixed, a smooth, a border, a wide and an all-corners flow, dflow alone
   and with dx (dflow bit for bit, dx element by element within 1e-5 /
   one bf16 ulp of the magnitude of the terms summed), timed beside
   ``torch.autograd.grad`` through ``F.grid_sample`` in the same type and
   in fp32;
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
   split). ``imaginaire_tpu_torch.train.main`` trains 1 iteration
   in-process (batch 4, 256x256, bf16, ``remat: blocks``; the launch
   counters are reset just before and read just after: 57 forward and 19
   backward an iteration, plus 19 forward for each generator forward of
   the image snapshots: G, the averaged copy, and the re-estimation of
   the averaged copy's BatchNorm statistics over the training loader's 2
   batches before it), the losses in ``meters.jsonl`` are finite and
   the checkpoint's files verify; a second ``main`` resumes to 2, every
   restored tensor equal to the saved state bit for bit and its first
   batch equal to an unbroken run's; one byte of the newest checkpoint is
   flipped, ``load_latest_verified`` quarantines it and restores the
   older (mid-epoch, iteration 1) one, and a third ``main`` resumes from
   that with the
   same checks; ``imaginaire_tpu_torch.inference.main`` writes one
   256x256 PNG a test item through the kernel. Over the three runs'
   iterations, the median iteration (the config's ``speed_benchmark``:
   each step ends in a device sync), images/s
   over the loop's wall time data waits included, the host's data wait,
   the main thread's and the other threads' CPU time and the garbage
   collector's time an iteration, peak memory and the checkpoints' sizes
   and times are printed;
9. vid2vid training entry (``vid2vid_train_entry``): a seeded dataset of 4
   sequences of 6 frames (540x1080 RGB frames, 35-class seg maps) written
   as PNG through the port's encoder and packed by ``build_packed_dataset``;
   configs/projects/vid2vid/cityscapes/bf16.yaml with
   ``trainer.perceptual_loss.allow_random_init`` and
   ``flow_network.allow_random_init`` (no VGG19 or FlowNet2 weights in
   the repository), its splits pointed there. ``imaginaire_tpu_torch.
   train.main`` trains 4 iterations in-process (2 epochs, batch 2,
   512x1024 crops, sequence length 4, bf16, ``remat: blocks``, the
   teacher in the G step; the launch counters are reset just before and
   read just after: a warp frame's D and G steps warp once each, its G
   step runs the teacher (5 warps, 1 correlation, 6 channelnorms) and
   one warp backward); the losses in ``meters.jsonl`` are finite, the
   generator's flow network moves and the checkpoint's files verify; one
   iteration is profiled; one fp32 warp-frame G step (TF32 off) through
   the kernels is held within 1e-3 to the same step through their plain
   versions (``fp32_warp_g_step``: the teacher's flow and conf held on
   their own first, then both steps on the kernels' teacher output, as
   the flow cache hands it over). The median iteration and frames/s (``speed_benchmark``), D
   and G step ms by frame type, peak memory, the host's data wait and
   the checkpoint's bytes and save seconds are printed;
10. SPADE evaluation (``spade_eval_entry``): Inception-v3 at its real
   width (21.8 M parameters, seeded random-init weights: the repository
   has no converted ones) on a (2, 3, 299, 299) batch on the card against
   the port's CPU run (TF32 off), and its images/s at batch 4; phase 8's
   dataset and config plus ``trainer.fid_random_init``:
   ``imaginaire_tpu_torch.train.main`` trains 2 iterations with an image
   snapshot at each and a checkpoint at the second, whose
   ``write_metrics`` computes FID and FID_ema in the loop; a corrupt copy
   of the checkpoint (one byte flipped) is put first in the sweep's
   order; ``imaginaire_tpu_torch.evaluate.main`` sweeps the logdir
   (``--metrics fid,kid,prdc``): the copy is quarantined and skipped, the
   checkpoint gets FID, FID_ema, best_FID, KID and PRDC, all finite and
   in ``meters.jsonl``; a second sweep of the checkpoint alone agrees.
   The launch counters are reset just before and read just after each
   run (the loop: 2 D+G steps, the 2 image snapshots' and the in-loop
   metrics' forwards, 342 launches; a sweep: 8 bs-4 forwards, 152). The
   averaged copy's re-estimation through the kernel is held to the plain
   composition (TF32 off), the live network unchanged bit for bit, and
   ``ServingEngine.load_weights`` serves the checkpoint's averaged
   weights and statistics bit for bit (and raises on an empty logdir).
   The sweeps' seconds, the re-estimation's seconds and batches and peak
   memory are printed;
11. vid2vid inference and evaluation from disk (``vid2vid_eval_entry``,
   run right after phase 9 on its packed sequences and checkpoint, before
   phase 10): the config with phase 9's overrides,
   ``trainer.fid_random_init``, ``num_videos_to_test: 2`` and a test split
   on the sequences (512x1024). ``imaginaire_tpu_torch.inference.main``
   writes every frame of every sequence (finite, in [-1, 1]; resample2d
   once a frame from the third on), and the first sequence equals the
   serving engine's stream of the same checkpoint bit for bit; two
   ``imaginaire_tpu_torch.evaluate.main`` sweeps (``--metrics
   fid,kid,prdc``) give finite video FID, KID and PRDC, the second equal
   to the first, with resample2d's launches predicted. The teacher
   cache's dataset half, on the config with ``flow_cache`` in disk mode
   and ``random_scale_limit`` and ``horizontal_flip`` dropped (the
   committed config is refused, exit code 2): ``precompute_flow`` runs
   twice (every pair computed in the predicted teacher forwards, then
   all hits and no teacher launch), and one training iteration from the
   disk cache attaches every pair (hit rate 1.0, no teacher launch), its
   ``flow_gt`` within the float16 store's tolerance of the teacher run
   on the same frames in producer mode. Seconds by part (load, rollout,
   PNG, Inception, ``sqrtm``), rollout frames/s, launches, peak memory
   and the card are printed;
12. fs-vid2vid (``fs_vid2vid_entry``, after phase 10): a seeded dataset of
   4 sequences of 6 frames (540x960 RGB frames as PNG, dlib-68 landmark
   JSON: the repository fixture's face placed in the frame and jittered
   frame to frame) packed by ``build_packed_dataset``;
   configs/projects/fs_vid2vid/faceForensics/bf16.yaml with the forced
   overrides (the two ``allow_random_init``, ``ext: png``), its splits and
   a test split pointed there. The serving engine (fresh seeded weights)
   serves two interleaved 6-frame streams at 512x512, each driven by one
   sequence with another's frame as its reference (resample2d 11 a
   stream, the modulation 0: the config's SPADE norms have a BatchNorm
   base), each within 2e-3 of itself served alone; with
   ``gen.activation_norm_type: hyper_spatially_adaptive`` a 3-frame
   stream runs the modulation kernel 12 times a forward, and one fp32
   frame and one fp32 G step (TF32 off) through the kernels are held
   within 1e-3 of the same through their plain versions;
   ``imaginaire_tpu_torch.train.main`` trains 4 iterations in-process
   (batch 3, sequence length 4, bf16; resample2d 14 and its backward 7 an
   iteration, the others 0), the losses are finite, the weight
   generator's FC stacks and the flow network move and the checkpoint
   verifies; one fp32 G step (TF32 off) is held within 1e-3 of its plain
   version; ``imaginaire_tpu_torch.inference.main`` writes the 6 frames of
   driving sequence 1 with sequence 0's first frame as the reference
   (resample2d 11), equal bit for bit to ``ServingEngine.load_weights()``
   and a stream of the same frames. The generator's parameters, the
   median iteration, frames/s, D and G step ms by frame type, stream
   frame ms at p50 and p99, peak memory and the checkpoint's bytes and
   save seconds are printed;
13. wc-vid2vid (``wc_vid2vid_entry``, after phase 12): a seeded folder
   dataset of 2 sequences of 6 frames at 512x1024 (RGB frames and the
   five label types of the mannequin config as PNG, 35 label channels,
   and a frame's pickled unprojections: a seeded 100,000-point cloud seen
   through a z-buffer by a moving camera, under the reference's
   ``w1024xh512`` key); configs/projects/wc_vid2vid/mannequin/hed_bf16.yaml
   with the forced overrides (the three ``allow_random_init``: VGG19,
   FlowNet2, the single-image model; ``ext: png``), its splits and a test
   split pointed there. ``imaginaire_tpu_torch.train.main`` trains 3
   iterations in-process (batch 1, sequence length 4, bf16): frames 0 and
   1 come from the frozen single-image SPADE model with no D or G step,
   frames 2 and 3 take D and G steps with the splat-rendered guidance
   (resample2d 14, its backward 2, correlation 2 and channelnorm 12 an
   iteration, the modulation 0); the losses are finite with a nonzero
   ``Guidance``, the point cloud grows within each clip, the flow network
   moves and the checkpoint verifies; one fp32 warp-frame G step with
   guidance (TF32 off) through the kernels is held within 1e-3 of the
   same step through their plain versions (as in phase 9), and under
   ``gen.guidance.partial_conv`` (with ``partial`` SPADE norms) one fp32
   warp-frame forward likewise; ``imaginaire_tpu_torch.inference.main``
   writes every frame of both sequences (finite, in [-1, 1]; resample2d
   8), twice, the second run equal to the first bit for bit. The
   generator's parameters, the median iteration, frames/s, D and G step
   ms of a warp frame, the takeover's, the host's guidance rendering's
   and the readback's ms a frame, the loader's wait, peak memory and the
   checkpoint's bytes and save seconds are printed;
14. pix2pixHD (``pix2pixHD_entry``, after phase 13): a seeded packed
   dataset of 4 training and 2 validation items at 512x1024 (RGB images,
   35-class seg maps and 16-bit instance maps with Cityscapes ids: stuff
   below 1000, things label x 1000 + k, neighbouring cells of one label
   one id apart) written as PNG through the port's encoder;
   configs/projects/pix2pixHD/cityscapes/bf16.yaml with
   ``trainer.perceptual_loss.allow_random_init`` (no VGG19 weights),
   ``max_iter`` 2 and a checkpoint at iteration 2, its splits and a test
   split pointed there. ``imaginaire_tpu_torch.train.main`` trains 2
   iterations in-process (batch 2, 512x1024 crops, bf16; the generator
   182,589,507 parameters, D 3,156,482); the edges each bf16 step reads
   equal ``get_edges`` of its int32 ids; the losses (GAN, feature
   matching, perceptual) are finite and the checkpoint verifies;
   ``imaginaire_tpu_torch.inference.main`` writes one 512x1024 PNG a
   validation item from a verified load of it (finite, in [-1, 1]). Then
   the encoder path of configs/unit_test/pix2pixHD.yaml with PNG images
   on a seeded 128x128 folder dataset: 2 iterations, and the checkpoint
   carries nonzero ``cluster_centers`` from the port's K-means. No kernel
   runs: the launch counters are reset just before and read just after
   each run, and every count must be 0. D and G step ms, iteration ms,
   the first iteration apart from the warm ones and the warm iterations'
   images/s, the data wait, peak memory, the checkpoint's bytes and save
   seconds, the inference and K-means seconds and the phase's seconds
   are printed;
15. UNIT and MUNIT (``unpaired_entry``, after phase 14): for each of
   configs/projects/munit/afhq_dog2cat/bf16.yaml (nf 64, a 256-wide MLP,
   the residual D; bf16, the averaged copy) and
   configs/projects/unit/winter2summer/base48_bs1.yaml (nf 48, the
   3-scale weight-shared patch D, least_square; fp32) a seeded packed
   unpaired dataset (RGB PNG, 288x320, 4 + 3 training and 2 + 2
   validation images in domains A + B, each domain's own file list),
   ``ext: png``, ``max_iter`` 2 and a checkpoint at 2, a test split
   copied from the val split. ``imaginaire_tpu_torch.train.main`` trains
   2 iterations in-process (batch 1, 256x256 crops; parameter counts as
   the CPU tests count them), the losses are finite and the checkpoint
   verifies; ``imaginaire_tpu_torch.inference.main`` translates each test
   item A into B from a verified load of it (the config's
   ``inference_args``): finite outputs, and PNGs that are the outputs
   clipped to [-1, 1] (the configs set no output nonlinearity, in both
   packages). Then one fp32 MUNIT generator forward at full width, batch
   1, 256x256, every output of the training forward with injected style
   codes, on the card (TF32 off) against the port's CPU forward at the
   same weights (relative L2 per output, gate 1e-4). No kernel runs:
   the six launch counters are reset just before and read just after
   each run, and every count must be 0. Parameters, the first and warm
   iteration ms, D and G step ms, peak memory, the checkpoint's bytes and
   save seconds, the inference seconds and the phase's seconds are
   printed;
16. FUNIT and COCO-FUNIT (``funit_entry``, after phase 15): a seeded
   packed few-shot dataset (RGB PNG, 288x320; 3 content and 3 style
   classes of 6 training images each, 2 validation images a class, each
   type its own file list), ``ext: png``, a test split copied from the
   val split, phase 15's forced cadences.
   configs/projects/coco_funit/mammals/base64_bs8_class305.yaml (batch 8,
   bf16, the averaged copy, 305 classes in D; a 270 resize, a rotation of
   up to 4 degrees and a 256 crop) trains 2 iterations through
   ``imaginaire_tpu_torch.train.main`` with a checkpoint at 2 that
   verifies, then ``imaginaire_tpu_torch.inference.main`` translates each
   test item from a verified load of it: finite outputs within [-1, 1]
   (the tanh), and each PNG its item's output within one 8-bit level.
   configs/projects/funit/animal_faces/base64_bs8_class119.yaml trains 2
   iterations through ``train.main``. Then one fp32 forward of each
   generator at full width (batch 1, 256x256, both outputs) on the card
   (TF32 off) against the port's CPU forward at the same seeded weights
   (relative L2 per output, gate 1e-4). No kernel runs: the six launch
   counters are reset just before and read just after each run, and
   every count must be 0. Parameters, the first and warm iteration ms, D
   and G step ms, peak memory, the checkpoint's bytes and save seconds,
   the inference seconds and the phase's seconds are printed;
17. vid2vid dancing (``check_pose_kernels``, then ``pose_vid2vid_entry``,
   after phase 16): resample2d, its backward (dflow), correlation and
   channelnorm held against their plain versions at the dancing path's
   512x512 shapes (G's and the teacher's (2, 3, 512, 512) warps, FlowNet2C's
   (2, 256, 64, 64) features, the teacher's (2, 3 | 2, 512, 512)
   differences and flows), fp32 and bf16, and timed beside their plain
   versions, bounds and library calls; then a seeded folder dataset of 4
   sequences of 6 frames (512x640 RGB PNG; OpenPose JSON in the
   repository fixture's layout: a moving dancer, frames with one or both
   hands missing, one frame with a second, smaller dancer beside a main
   one with no hands) and a one-sequence test split;
   configs/projects/vid2vid/dancing/bf16.yaml with the override its loader
   needs (``data.for_pose_dataset.pose_one_hot: True``: ROADMAP.md §C,
   C12), the two ``allow_random_init`` and ``ext: png``.
   ``imaginaire_tpu_torch.train.main`` trains 2 iterations in-process
   (batch 2, 512x512 crops, sequence length 4, bf16, the image, face and
   hand Ds, the teacher in the G step; resample2d 14, its backward 2,
   correlation 2 and channelnorm 12 an iteration, the modulation 0: the
   SPADE norms have a BatchNorm base); the losses, ``GAN_face`` and
   ``GAN_hand`` among them, are finite, the hands each G step's hand D
   weighs equal those the seeded skeletons show in its frames (the
   second dancer's hands not among them), and the checkpoint verifies;
   one fp32 warp-frame G step (TF32 off) with its region losses is held
   within 1e-3 of the same step through the plain versions
   (``fp32_warp_g_step``); ``imaginaire_tpu_torch.inference.main`` writes
   the test sequence's 4 frames (finite, in [-1, 1]; resample2d 2). The
   parameters, the first and warm iteration ms, D and G step ms by frame
   type, the data wait, peak memory, the region losses, the hands
   counted, the checkpoint's bytes and save seconds, the inference
   seconds and the phase's seconds are printed;
18. fs-vid2vid YouTubeDancing (``pose_fs_vid2vid_entry``, after phase
   17): a seeded folder dataset of 12 sequences of 5 frames at the
   config's 540x960 (RGB PNG, DensePose IUV PNG with the part index in
   channel 2, face parts included, OpenPose JSON of a walking dancer and
   a bystander, DensePose instance maps with a different id each);
   configs/projects/fs_vid2vid/YouTubeDancing/bf16.yaml with the forced
   overrides (``ext: png``, the two ``allow_random_init``, the finetune's
   ``finetune_iter``). ``imaginaire_tpu_torch.train.main`` trains 2
   iterations (batch 6, 512x256 person crops, sequence length 4, bf16,
   6 label channels, the few-shot face D; resample2d 14, its backward 7
   an iteration, the rest 0); the losses, ``GAN_face`` among them, are
   finite, the weight generator and the flow network move, the
   checkpoint verifies; one fp32 warp-frame G step (TF32 off) is held
   within 1e-3 of the same step through the plain versions
   (``fp32_warp_g_step``, two warps); ``imaginaire_tpu_torch.inference.main``
   finetunes (only the parameters under the finetune prefixes move) and
   writes the driving sequence's 5 frames, every one cropped with its
   first frame's box, each PNG equal to G's clipped frame; resample2d
   and its backward (dflow) are held and timed at the path's (6, 3, 512,
   256) warp; the hyper route (``configs/unit_test/fs_vid2vid_pose.yaml``)
   holds one fp32 G step and one fp32 forward through the kernels (the
   modulation 8 a forward, 8 backwards a G step) against their plain
   versions. The parameters, the first and warm iteration ms, frames/s,
   D and G step ms of a warp frame, the person crop's host ms an item,
   the data wait, peak memory, the checkpoint's bytes and save seconds,
   the finetune's and the inference's seconds and the phase's seconds
   are printed;
19. a ``phase_seconds`` line, a ``kernels`` JSON line, the nvidia-smi
   line, and the final JSON line.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import pickle
import re
import shutil
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
# resample2d's backward: the vid2vid training warp of the previous
# (2, 3, 512, 1024) frames (batch 2) under the mixed, the smooth, a
# border, the wide (up to 300 pixels) and an all-corners flow (every
# sample clamps to one of the frame's four corner pixels: the most
# atomics onto one address), fp32 and bf16 (x and flow of one type, as
# on the path), dflow alone (the path: the previous frame is detached)
# and with dx; and edge shapes (an odd W, B > 1, C = 5, H = 1). dflow: bit for bit
# with the plain version (the same fp32 steps in the same order); dx
# (fp32 atomics in a run-dependent order), element by element against
# the magnitude of the terms it sums (sum of |w_k g|: a border pixel sums
# thousands of terms of both signs, whose sum can be far smaller than
# they are): fp32 1e-5 of it, bf16 one ulp at it
RESAMPLE_BWD_PATH_SHAPE = (2, 3, 512, 1024)
RESAMPLE_BWD_CASES = [(RESAMPLE_BWD_PATH_SHAPE, "mixed"),
                      (RESAMPLE_BWD_PATH_SHAPE, "smooth"),
                      (RESAMPLE_BWD_PATH_SHAPE, "border"),
                      (RESAMPLE_BWD_PATH_SHAPE, "wide"),
                      (RESAMPLE_BWD_PATH_SHAPE, "corners"),
                      ((2, 3, 37, 53), "mixed"),
                      ((3, 5, 1, 7), "mixed"),
                      ((1, 2, 9, 1027), "border")]
TOL_RESAMPLE_BWD_DX_REL = 1e-5
TOL_RESAMPLE_BWD_DX_ULPS = 1.0
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
# size (rows, columns) trains 1 iteration (a checkpoint at iteration 1,
# mid-epoch: 8 items at batch 4 make 2 iterations an epoch), resumes to 2,
# survives a corrupted checkpoint (the fallback is iteration 1's) and feeds
# inference: one checkpoint a run, the fewest that keep every check; an
# image snapshot every iteration (each runs G and its averaged copy once,
# and first re-estimates the averaged copy's BatchNorm statistics over the
# training loader's 2 batches: the COCO-Stuff config's style-code norms
# stay sync_batch under the instance override). The loop's numbers are
# those of the three runs' iterations
ENTRY_ITEMS = 8
ENTRY_HW = (300, 320)
ENTRY_NUM_CLASSES = 183
ENTRY_SEED = 0
ENTRY_RUNS = (1, 2)
ENTRY_OVERRIDES = {"snapshot_save_iter": 1000, "logging_iter": 1,
                   "image_save_iter": 1, "checkpoints_to_keep": 2}
# G forwards of one re-estimation: min(the config's 30, the training
# loader's batches)
ENTRY_RECAL_BATCHES = min(30, ENTRY_ITEMS // TRAIN_BATCH)

# SPADE evaluation (phase 10): the same packed dataset and config, plus
# ``trainer.fid_random_init`` (no Inception-v3 weights in the repository);
# two training iterations, an image snapshot at each (the first
# re-estimates the averaged copy's statistics) and a checkpoint at the
# second, which carries them, then ``write_metrics`` (FID and FID_ema)
# inside the loop; then the evaluate entry's sweeps. A sweep of one
# checkpoint runs G on the validation loader's 2 batches for FID, for
# FID_ema and for KID/PRDC, and re-estimates the averaged copy's
# statistics over the training loader's 2 batches before FID_ema: 8 bs-4
# forwards, 152 modulation launches
EVAL_TRAIN_ITERS = 2
EVAL_OVERRIDES = {"snapshot_save_iter": EVAL_TRAIN_ITERS, "image_save_iter": 1,
                  "logging_iter": 1, "trainer": {"fid_random_init": True}}
EVAL_VAL_BATCHES = ENTRY_ITEMS // TRAIN_BATCH
EVAL_SWEEP_FORWARDS = 3 * EVAL_VAL_BATCHES + ENTRY_RECAL_BATCHES
EVAL_METRICS = ("FID", "FID_ema", "best_FID", "KID", "PRDC_precision", "PRDC_recall",
                "PRDC_density", "PRDC_coverage")
# a second sweep of the same checkpoint: FID, FID_ema and KID relative
# (the same forwards on the same card; the features' covariances of 8
# samples are singular, so sqrtm is the least stable step); PRDC within
# one sample's membership of the 8
TOL_SWEEP_REL = 1e-3
TOL_SWEEP_PRDC = 1.0 / ENTRY_ITEMS
# the re-estimated statistics through the kernel against the plain
# composition (TF32 off): max-abs over the larger of the statistic's and
# the live statistic's max magnitude
TOL_RECAL_REL = 1e-3
# Inception-v3 on the card against the port's CPU run of the same
# random-init weights, a (2, 3, 299, 299) batch, TF32 off: max-abs over
# the features' max magnitude (cuDNN's and the CPU's fp32 convolutions sum
# in other orders through ~50 layers)
TOL_INCEPTION_REL = 1e-3
INCEPTION_PARAMS = 21_820_000


# vid2vid training from data on disk (phase 9): a seeded packed video
# dataset of 4 sequences of 6 frames, RGB images and 35-class seg maps at
# 540x1080 (resize_smallest_side 512 and random_crop_h_w 512x1024 do real
# work); the Cityscapes config with the two overrides the repository's
# missing weights force, 4 iterations (2 epochs of 2 batches of 2) at
# sequence length 4: frames 2 and 3 warp. Each warp frame runs the
# generator's warp in its D step and in its G step, and the teacher in
# its G step (5 warps, 1 correlation, 6 channelnorms a forward); its G
# backward runs the warp's backward (dflow only: the previous frame is
# detached)
V2V_ENTRY_SEQUENCES, V2V_ENTRY_FRAMES, V2V_ENTRY_HW = 4, 6, (540, 1080)
V2V_ENTRY_ITERATIONS, V2V_ENTRY_SEQ, V2V_ENTRY_BATCH = 4, 4, 2
V2V_ENTRY_WARP_FRAMES = V2V_ENTRY_SEQ - 2
V2V_ENTRY_LAUNCHES = {"resample2d": V2V_ENTRY_WARP_FRAMES * (2 + 5),
                      "resample2d_bwd": V2V_ENTRY_WARP_FRAMES,
                      "correlation": V2V_ENTRY_WARP_FRAMES,
                      "channelnorm": V2V_ENTRY_WARP_FRAMES * 6}
V2V_ENTRY_OVERRIDES = {"logging_iter": 1, "snapshot_save_iter": 1000,
                       "snapshot_save_epoch": 1000, "image_save_iter": 1000,
                       "trainer": {"speed_benchmark": True,
                                   "perceptual_loss": {"allow_random_init": True}},
                       "flow_network": {"allow_random_init": True}}
# one fp32 warp-frame G step (TF32 off) through the kernels against the
# same step through their plain versions: each loss and the grad norm,
# relative
TOL_V2V_STEP_REL = 1e-3

# vid2vid inference and evaluation from disk (phase 11): phase 9's packed
# sequences and checkpoint (4 sequences of 6 frames; 540x1080 frames
# resized to 512x1024 by the validation and test splits), the config with
# phase 9's overrides, ``trainer.fid_random_init`` (no Inception-v3
# weights in the repository), ``num_videos_to_test: 2`` and a test split on
# the packed sequences. A rollout warps every frame from the third on:
# inference rolls out every sequence, a sweep the first two twice (for FID,
# then for KID and PRDC; the real frames run no generator)
V2V_EVAL_VIDEOS = 2
V2V_EVAL_OVERRIDES = {"trainer": {"fid_random_init": True,
                                  "num_videos_to_test": V2V_EVAL_VIDEOS}}
V2V_EVAL_METRICS = ("FID", "best_FID", "KID", "PRDC_precision", "PRDC_recall",
                    "PRDC_density", "PRDC_coverage")
V2V_WARPS_PER_SEQUENCE = max(0, V2V_ENTRY_FRAMES - 2)
V2V_INFERENCE_RESAMPLE = V2V_ENTRY_SEQUENCES * V2V_WARPS_PER_SEQUENCE
V2V_SWEEP_RESAMPLE = 2 * V2V_EVAL_VIDEOS * V2V_WARPS_PER_SEQUENCE
# precompute_flow over the training split: 5 frame pairs a sequence, one
# teacher forward a sequence (a chunk holds 8 pairs), each forward 1
# correlation, 6 channelnorms and 5 warps
V2V_PRECOMPUTE_CHUNK = 8
V2V_PRECOMPUTE_PAIRS = V2V_ENTRY_SEQUENCES * (V2V_ENTRY_FRAMES - 1)
V2V_PRECOMPUTE_FORWARDS = V2V_ENTRY_SEQUENCES * -(-(V2V_ENTRY_FRAMES - 1)
                                                  // V2V_PRECOMPUTE_CHUNK)
# one training iteration from disk with every pair cached: the generator's
# warp alone (D and G step of each warp frame) and its backward
V2V_DISK_LAUNCHES = {"resample2d": 2 * V2V_ENTRY_WARP_FRAMES,
                     "resample2d_bwd": V2V_ENTRY_WARP_FRAMES,
                     "correlation": 0, "channelnorm": 0}
# the disk iteration's flow_gt against the teacher run on the same frames
# in producer mode: the store keeps flow in float16 (the CPU tests' store
# tolerance, |a - b| <= atol + rtol |b|); conf is stored exactly, and the
# two teacher runs (5 pairs a forward, then 6) may round a pixel's warp
# error to the other side of the threshold: at most this share of pixels
TOL_STORE_RTOL, TOL_STORE_ATOL = 1e-3, 1e-2
TOL_CONF_MISMATCH = 1e-4


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
    cases = [(shape, calls, n_pairs, 0, "spade") for shape, calls in MODULATION_SHAPES
             for n_pairs in (1, 2)]
    cases += [(shape, 0, n_pairs, offset, "edge")
              for shape, n_pairs, offset in MODULATION_EDGE]
    # fs-vid2vid's hyper route: planes past SPADE's 128x128, up to 512x512
    cases += [(shape, calls, 1, 0, "fs") for shape, calls in FS_MODULATION_SHAPES]
    for shape, calls, n_pairs, offset, path in cases:
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
                       "route": routes[0], "path": path,
                       "ms": time_ms(lambda: fwd(x, gs, bs)),
                       "plain_ms": time_ms(lambda: spade_mod.spade_modulation_plain(x, gs, bs)),
                       "bound_ms": bound, "bound_by": bound_by,
                       "max_abs_err": errs["forward_error"]}
                row["bound_share"] = row["bound_ms"] / row["ms"]
                rows.append(row)
                phase("kernel", name="spade_modulation", **row)
                bound, bound_by = modulation_bwd_bound_ms(shape, 1, size)
                row = {"shape": list(shape), "calls": calls, "dtype": name,
                       "route": routes[1], "path": path,
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


def corners_flow(shape, gen):
    """(B, 2, H, W) flow that sends every pixel 1.5 frame sizes and a
    fraction of a pixel out on both axes (the fraction survives in fp32):
    all four corners of every pixel clamp to one of the frame's four
    corner pixels, in fp32 and in bf16."""
    b, _, h, w = shape
    size = torch.tensor([w, h], device="cuda").view(1, 2, 1, 1)
    sign = torch.randint(0, 2, (b, 2, h, w), generator=gen, device="cuda") * 2 - 1
    return sign * (1.5 * size + torch.rand((b, 2, h, w), generator=gen, device="cuda"))


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


def resample_bwd_bound_ms(shape, elem_bytes, need_dx):
    """Least time for one backward call: x, g and flow read once, dflow
    (and dx) written once at HBM rate, against ~(12 + 14 C) fp32 flops a
    pixel (4 differences, 6 products and 4 sums a channel; 8 more with
    dx) at the fp32 peak; the larger of the two."""
    b, c, h, w = shape
    pixels = b * h * w
    nbytes = (2 * c * elem_bytes + 4 * elem_bytes + c * elem_bytes * need_dx) * pixels
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (12 + (14 + 8 * need_dx) * c) * pixels / FP32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def border_flow(shape):
    """(B, 2, H, W) flow whose sample points put every floor at or just
    past a border (-1, 0, n - 1, n), or a million pixels outside."""
    b, _, h, w = shape
    xs = torch.tensor([-1.0, -0.5, 0.0, 0.25, w - 1.0, w - 0.5, w, w + 0.75,
                       -1e6 - 0.5, 1e6 + 0.25], device="cuda")
    ys = torch.tensor([-1.0, -0.25, 0.0, h - 1.0, h - 0.5, h, 1e6 + 0.5, -1e6],
                      device="cuda")
    gx = xs[torch.arange(h * w, device="cuda") % len(xs)].view(1, h, w)
    gy = ys[torch.arange(h * w, device="cuda") % len(ys)].view(1, w, h).transpose(1, 2)
    gx = gx - torch.arange(w, device="cuda").view(1, 1, w)
    gy = gy - torch.arange(h, device="cuda").view(1, h, 1)
    return torch.stack([gx, gy], dim=1).expand(b, 2, h, w).contiguous()


def resample_bwd_flow(kind, shape, gen):
    """The backward's flow of ``kind`` (RESAMPLE_BWD_CASES) at ``shape``."""
    return {"mixed": lambda: mixed_flow(shape, gen),
            "smooth": lambda: smooth_flow(shape),
            "border": lambda: border_flow(shape),
            "wide": lambda: wide_flow(shape, gen),
            "corners": lambda: corners_flow(shape, gen)}[kind]()


def resample_bwd_errors(rs, x, f, g, dx, dflow):
    """(dflow equal bit for bit, dx error, within the gates) of a backward's
    (dx or None, dflow) against the plain version on the same inputs: dx
    element by element over the magnitude of the terms it sums (sum of
    |w_k g|), fp32 within TOL_RESAMPLE_BWD_DX_REL of it, bf16 within
    TOL_RESAMPLE_BWD_DX_ULPS bf16 ulps at it."""
    want_dx, want_dflow = rs.resample2d_bwd_plain(x, f, g, dx is not None)
    bitwise = dflow.dtype == f.dtype and torch.equal(dflow, want_dflow)
    if dx is None:
        return bitwise, None, bitwise
    if dx.dtype != x.dtype:
        return bitwise, None, False
    terms = rs.resample2d_bwd_plain(x.float(), f.float(), g.float().abs())[0]
    if x.dtype == torch.float32:
        err = ((dx - want_dx).abs() / terms.clamp_min(1e-30)).max().item()
        return bitwise, err, bitwise and err <= TOL_RESAMPLE_BWD_DX_REL
    err = bf16_ulps(dx, want_dx, scale=terms)
    return bitwise, err, bitwise and err <= TOL_RESAMPLE_BWD_DX_ULPS


def check_resample_bwd(rs):
    """Phase 3b': the resample2d backward kernel vs its plain version at
    the training path's shape and edge shapes, fp32 and bf16, dflow alone
    and with dx; times at the path's shape under each of its flows (dflow
    alone, as the path runs it; and with dx) beside the plain version, the
    bytes bound and ``torch.autograd.grad`` through F.grid_sample in the
    row's type and in fp32. Returns (rows, worst fp32 dx error over the
    magnitude of the terms summed)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(8765)
    rows, max_err = [], 0.0
    for shape, kind in RESAMPLE_BWD_CASES:
        x32 = torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5
        g32 = torch.randn(shape, generator=gen, device="cuda")
        flow = resample_bwd_flow(kind, shape, gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, f, g = x32.to(dtype), flow.to(dtype), g32.to(dtype)
            for need_dx in (False, True):
                before = rs.bwd_launches
                dx, dflow = rs.resample2d_bwd(x, f, g, need_dx)
                torch.cuda.synchronize()
                if rs.bwd_launches != before + 1:
                    raise AssertionError("resample2d_bwd did not launch its kernel")
                label = f"{str(dtype).split('.')[-1]}/{'dx+dflow' if need_dx else 'dflow'}"
                bitwise, dx_err, ok = resample_bwd_errors(rs, x, f, g, dx, dflow)
                if not ok:
                    raise AssertionError(f"resample2d_bwd {shape} {kind} {label}: "
                                         f"dflow bit for bit {bitwise}, dx error "
                                         f"{dx_err} (dx {dx if dx is None else dx.dtype})")
                if dx_err is not None and dtype == torch.float32:
                    max_err = max(max_err, dx_err)
                phase("kernel_check", name="resample2d_bwd", shape=list(shape),
                      flow=kind, dtype=label, dflow_bitwise=True, dx_error=dx_err)
        if shape == RESAMPLE_BWD_PATH_SHAPE:
            for dtype in (torch.bfloat16, torch.float32):
                x, f, g = x32.to(dtype), flow.to(dtype), g32.to(dtype)
                for need_dx in (False, True):
                    bound, bound_by = resample_bwd_bound_ms(shape, x.element_size(),
                                                            need_dx)
                    ms = time_ms(lambda: rs.resample2d_bwd(x, f, g, need_dx))
                    row = {"shape": list(shape), "flow": kind, "calls": 1,
                           "dtype": str(dtype).split(".")[-1], "need_dx": need_dx,
                           "ms": ms, "bound_ms": bound, "bound_by": bound_by,
                           "bound_share": bound / ms,
                           "plain_ms": time_ms(lambda: rs.resample2d_bwd_plain(
                               x, f, g, need_dx), iters=5),
                           "library_ms": time_ms(grid_sample_bwd(x, f, g, need_dx)),
                           "library_fp32_ms": time_ms(grid_sample_bwd(
                               x32, flow, g32, need_dx))}
                    rows.append(row)
                    phase("kernel", name="resample2d_bwd", **row)
    for row in rows:
        row["max_abs_err"] = max_err
    torch.cuda.empty_cache()
    return rows, max_err


def grid_sample_bwd(x, flow, g, need_dx):
    """fn() of ``torch.autograd.grad`` through F.grid_sample (bilinear,
    border, align_corners) for the same warp's gradients, in x's type
    (the grid too): the grid's alone, or the input's too."""
    import torch.nn.functional as F

    grid = border_grid(flow.float()).to(x.dtype).requires_grad_(True)
    xin = x.detach().clone().requires_grad_(need_dx)
    with torch.enable_grad():
        out = F.grid_sample(xin, grid, mode="bilinear", padding_mode="border",
                            align_corners=True)
    wrt = [xin, grid] if need_dx else [grid]
    return lambda: torch.autograd.grad(out, wrt, g, retain_graph=True)


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
    from imaginaire_tpu_torch.layers.activation_norm import (
        HyperSpatiallyAdaptiveNorm,
        SpatiallyAdaptiveNorm,
    )

    for m in net.modules():
        if isinstance(m, (SpatiallyAdaptiveNorm, HyperSpatiallyAdaptiveNorm)):
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
            {k: v.clone() for k, v in (trainer.ema_G or {}).items()},
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
        for k, v in ema.items():  # no averaged copy: empty
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


# fs-vid2vid (phase 12): configs/projects/fs_vid2vid/faceForensics/bf16.yaml
# with the overrides the repository forces (no VGG19 or FlowNet2 weights;
# PNG frames: the card's machine has no JPEG codec) on a seeded dataset of
# 4 sequences of 6 frames: 540x960 RGB frames and dlib-68 landmark JSON
# (a face placed in the frame, jittered frame to frame), packed. The
# data pipeline resizes the frames' smallest side to 1024, draws the
# landmarks' edge map there and crops the face to 512x512.
FS_CONFIG = REPO / "configs/projects/fs_vid2vid/faceForensics/bf16.yaml"
FS_LANDMARK_TEMPLATE = REPO / "tests/fixtures/face/raw/landmarks-dlib68/person1/00000.json"
FS_SEQUENCES, FS_FRAMES, FS_RAW_HW = 4, 6, (540, 960)
FS_ITERATIONS, FS_SEQ, FS_BATCH = 4, 4, 3
FS_HW = (512, 512)
FS_FORCED = {"trainer": {"perceptual_loss": {"allow_random_init": True}},
             "flow_network": {"allow_random_init": True}}
# the harness's cadences (the model is the config's): no snapshot in 4
# iterations, every step timed
FS_CADENCES = {"logging_iter": 1, "snapshot_save_iter": 1000, "snapshot_save_epoch": 1000,
               "image_save_iter": 1000, "trainer": {"speed_benchmark": True}}
FS_HYPER = {"gen": {"activation_norm_type": "hyper_spatially_adaptive"}}
# launches, predicted from the code: a frame warps the (picked) reference
# from the first frame on and the previous output once one is known; a
# training frame warps in its D step's and its G step's forward, and its
# G backward runs the warps' backward (dflow only: the reference is data,
# the previous output detached). The SPADE norms of the committed config
# have a BatchNorm base, which the modulation kernel refuses (0 launches);
# the hyper route's 6 HyperRes2dBlocks run 2 hyper norms each, whose
# first pair fuses with the instance norm: 12 a forward
FS_STREAM_FRAMES = 6
FS_STREAM_RESAMPLE = 1 + 2 * (FS_STREAM_FRAMES - 1)
FS_HYPER_FRAMES = 3
FS_HYPER_MODULATION = 12
FS_ENTRY_LAUNCHES = {"resample2d": 2 * (2 * FS_SEQ - 1),
                     "resample2d_bwd": 2 * FS_SEQ - 1,
                     "correlation": 0, "channelnorm": 0}
# (B, C, H, W) of the hyper route's 12 modulations a forward at batch 1
FS_MODULATION_SHAPES = [
    ((1, 1024, 16, 16), 2), ((1, 1024, 32, 32), 1), ((1, 512, 32, 32), 1),
    ((1, 512, 64, 64), 1), ((1, 256, 64, 64), 1), ((1, 256, 128, 128), 1),
    ((1, 128, 128, 128), 1), ((1, 128, 256, 256), 1), ((1, 64, 256, 256), 1),
    ((1, 64, 512, 512), 1), ((1, 32, 512, 512), 1)]
# one fp32 frame / G step (TF32 off) through the kernels against the same
# through their plain versions: the frame max-abs, each loss and the grad
# norm relative
TOL_FS_FRAME = 1e-3
TOL_FS_STEP_REL = 1e-3


# wc-vid2vid (phase 13): configs/projects/wc_vid2vid/mannequin/hed_bf16.yaml
# with the overrides the repository forces (no VGG19, FlowNet2 or trained
# single-image weights; PNG frames: the card's machine has no JPEG codec)
# on a seeded folder dataset of 2 sequences of 6 frames at 512x1024: RGB
# frames, the config's five label types (DensePose parts 0..24, MegaDepth
# depth, HED edges, DensePose and OpenPose renders: 35 channels) and, a
# frame, the pickled unprojections of a seeded cloud of 100,000 points
# seen through a z-buffer by a camera that moves frame to frame, under the
# reference's 'w1024xh512' key. Batch 1, sequence length 4: frames 0 and 1
# come from the single-image takeover (no D or G step), frames 2 and 3 take
# D and G steps with the rendered guidance. A warp frame warps in its D
# step's and its G step's generator forward, runs the teacher in its G step
# (5 warps, 1 correlation, 6 channelnorms) and the warp's backward (dflow:
# the previous frame is detached). The SPADE norms' base is BatchNorm
# (``base_norm`` is not read, ROADMAP.md C) and the single-image model's
# sync_batch: no modulation launch
WC_CONFIG = REPO / "configs/projects/wc_vid2vid/mannequin/hed_bf16.yaml"
WC_SEQUENCES, WC_FRAMES, WC_HW, WC_POINTS = 2, 6, (512, 1024), 100_000
WC_ITERATIONS, WC_SEQ = 3, 4
WC_LABEL_TYPES = {"seg_maps-densepose": 25, "depth_maps-megadepth": 3, "edge_maps-hed": 1,
                  "pose_maps-densepose": 3, "pose_maps-openpose": 3}
WC_FORCED = {"trainer": {"perceptual_loss": {"allow_random_init": True}},
             "flow_network": {"allow_random_init": True},
             "gen": {"single_image_model": {"allow_random_init": True}}}
WC_CADENCES = {"logging_iter": 1, "snapshot_save_iter": 1000, "snapshot_save_epoch": 1000,
               "image_save_iter": 1000, "trainer": {"speed_benchmark": True}}
# the partial-conv route: the guidance as an (image, mask) pair, which the
# SPADE norms turn into gamma/beta through PartialConv2d only when built
# with ``partial`` (``gen.guidance.partial_conv`` alone drops the mask)
WC_PARTIAL = {"gen": {"guidance": {"partial_conv": True},
                      "activation_norm_params": {"partial": True}}}
WC_WARP_FRAMES = WC_SEQ - 2
WC_ENTRY_LAUNCHES = {"resample2d": WC_WARP_FRAMES * (2 + 5),
                     "resample2d_bwd": WC_WARP_FRAMES,
                     "correlation": WC_WARP_FRAMES, "channelnorm": WC_WARP_FRAMES * 6}
WC_INFERENCE_RESAMPLE = WC_SEQUENCES * (WC_FRAMES - 2)
# one fp32 warp-frame G step with guidance (TF32 off) through the kernels
# against the same step through their plain versions: each loss and the
# grad norm, relative; the partial-conv route's fp32 warp-frame forward:
# max-abs
TOL_WC_STEP_REL = 1e-3
TOL_WC_PARTIAL = 1e-3

# pix2pixHD (phase 14): configs/projects/pix2pixHD/cityscapes/bf16.yaml with
# the overrides the repository forces (no VGG19 weights) and the phase's
# cadences (2 iterations, a checkpoint at the second) on a seeded packed
# dataset of 4 training and 2 validation items at 512x1024: RGB images,
# 35-class seg maps and 16-bit instance maps with Cityscapes ids (stuff
# below 1000, things label x 1000 + k, horizontal neighbours of one label
# one id apart). Batch 2, bf16. Plain instance norms: no kernel of the
# port runs. Then the encoder path, small: the unit config with PNG images
# (the card's machine has no JPEG codec) on a seeded folder dataset of 2
# items at 128x128 whose 16-bit instance maps hold four quadrant instances
# of labels 1-8, 2 iterations, a checkpoint with clustered centers
P2P_CONFIG = REPO / "configs/projects/pix2pixHD/cityscapes/bf16.yaml"
P2P_UNIT = REPO / "configs/unit_test/pix2pixHD.yaml"
P2P_TRAIN_ITEMS, P2P_VAL_ITEMS, P2P_HW, P2P_LABELS = 4, 2, (512, 1024), 35
P2P_ITERATIONS = 2
P2P_THINGS = range(24, 34)  # Cityscapes' thing labels: person .. bicycle
P2P_FORCED = {"trainer": {"perceptual_loss": {"allow_random_init": True}},
              "max_iter": P2P_ITERATIONS, "snapshot_save_iter": P2P_ITERATIONS}
P2P_CADENCES = {"logging_iter": 1, "snapshot_save_epoch": 1000, "image_save_iter": 1000,
                "trainer": {"speed_benchmark": True}}
P2P_G_PARAMS, P2P_D_PARAMS = 182_589_507, 3_156_482
P2P_ENC_ITEMS, P2P_ENC_HW = 2, (128, 128)
UNPAIRED_CONFIGS = {"munit": REPO / "configs/projects/munit/afhq_dog2cat/bf16.yaml",
                    "unit": REPO / "configs/projects/unit/winter2summer/base48_bs1.yaml"}
UNPAIRED_ITEMS = {"train": (4, 3), "val": (2, 2)}  # domain A, domain B
UNPAIRED_HW = (288, 320)  # the configs resize the smaller side to 256, then crop 256
UNPAIRED_ITERATIONS = 2
UNPAIRED_FORCED = {"max_iter": UNPAIRED_ITERATIONS,
                   "snapshot_save_iter": UNPAIRED_ITERATIONS}
UNPAIRED_CADENCES = {"logging_iter": 1, "snapshot_save_epoch": 1000,
                     "image_save_iter": 1000, "trainer": {"speed_benchmark": True}}
# (G, D) as tests/test_torch_unpaired.py counts them against the JAX trees
UNPAIRED_PARAMS = {"munit": (30_258_966, 32_322_498), "unit": (12_555_654, 5_295_042)}
UNPAIRED_DTYPES = {"munit": torch.bfloat16, "unit": torch.float32}
TOL_UNPAIRED_FWD = 1e-4
# FUNIT and COCO-FUNIT (phase 16): the committed configs, a seeded packed
# few-shot dataset, 2 iterations each, COCO-FUNIT's checkpoint and
# inference, then one fp32 forward of each generator on the card
FUNIT_CONFIGS = {
    "coco_funit": REPO / "configs/projects/coco_funit/mammals/base64_bs8_class305.yaml",
    "funit": REPO / "configs/projects/funit/animal_faces/base64_bs8_class119.yaml"}
FUNIT_INFERS = ("coco_funit",)
FUNIT_CLASSES = 3  # content and style classes each
# images a class: 18 training images make 2 batches of 8 an epoch, so the
# 2 iterations end inside epoch 0 and save once (at max_iter), not also at
# the end of a one-batch epoch 0
FUNIT_ITEMS = {"train": 6, "val": 2}
FUNIT_HW = (288, 320)
FUNIT_ITERATIONS = 2
FUNIT_BATCH = 8
# train.main saves the checkpoint at max_iter; the configs' own
# snapshot_save_iter (5000) keeps FID (no Inception-v3 weights) out
FUNIT_FORCED = {"max_iter": FUNIT_ITERATIONS}
# (G, D) as tests/test_torch_funit.py counts them against the JAX trees
FUNIT_PARAMS = {"coco_funit": (121_562_307, 92_198_721),
                "funit": (120_987_203, 92_008_257)}
TOL_FUNIT_FWD = 1e-4

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
        clocks = HostClocks(Trainer)  # accumulates over the three runs
        Trainer.save_checkpoint = timed_save
        try:
            with clocks:
                t0 = time.perf_counter()
                trainer = train.main(args + ["--max_iter", str(ENTRY_RUNS[0])])
                train_s = time.perf_counter() - t0
        finally:
            Trainer.save_checkpoint = save
        launches = {"forward": spade_mod.launches, "backward": spade_mod.bwd_launches}
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
        n_images = len(list((logdir / "images").glob("*.png")))
        want = {"forward": ENTRY_RUNS[0] * TRAIN_FWD_LAUNCHES
                + n_images * (2 + ENTRY_RECAL_BATCHES) * CALLS_PER_FORWARD,
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
        timings = {k: list(v) for k, v in trainer.timings.items()}  # and the resumes
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
        with clocks:
            trainer, resume = resumed_run(
                Trainer, args + ["--max_iter", str(ENTRY_RUNS[1])], saved, cfg_path)
        resume_s = time.perf_counter() - t0
        for k, v in trainer.timings.items():
            timings[k] += v
        resume_launches = {"forward": spade_mod.launches,
                           "backward": spade_mod.bwd_launches}
        n = ENTRY_RUNS[1] - ENTRY_RUNS[0]
        every = ENTRY_OVERRIDES["image_save_iter"]
        n_images_resume = ENTRY_RUNS[1] // every - ENTRY_RUNS[0] // every
        if resume["iteration"] != ENTRY_RUNS[0] or trainer.current_iteration != ENTRY_RUNS[1] \
                or resume_launches != {
                    "forward": n * TRAIN_FWD_LAUNCHES + n_images_resume * (
                        2 + ENTRY_RECAL_BATCHES) * CALLS_PER_FORWARD,
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
        with clocks:
            trainer, fallback_resume = resumed_run(
                Trainer, args + ["--max_iter", str(ENTRY_RUNS[1])], payload["state"],
                cfg_path)
        for k, v in trainer.timings.items():
            timings[k] += v
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
    # the three runs' iterations (1, 2 and 2 again)
    ms = {k: [t * 1e3 for t in v] for k, v in timings.items()}
    median_ms = float(np.median(ms["iteration"]))
    # the loop's wall time after the first iteration (kernel build, cuDNN's
    # picks): each batch's data wait (here each the first of its run's
    # loader) and its iteration, less only the image snapshots and meter
    # flushes that end_of_iteration runs after its clock
    window_s = sum(ms["data_wait"][1:] + ms["iteration"][1:]) / 1e3
    row = {"items": items, "hw": list(hw), "batch": 4, "data_s": data_s,
           "train_s": train_s, "iterations": len(ms["iteration"]),
           "iteration_ms": ms["iteration"], "median_iteration_ms": median_ms,
           "images_per_s": 4 * (len(ms["iteration"]) - 1) / window_s,
           "window_s": window_s,
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


def check_inception(device="cuda"):
    """Inception-v3 at its real width on the card against the port's CPU
    run of the same seeded weights (TF32 off inside the extractor), and
    its images/s at 299x299, batch 4."""
    from imaginaire_tpu_torch.evaluation import inception

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 299, 299), generator=gen)
    card = inception.load_params(random_init=True, device=device, seed=0)
    host = inception.load_params(random_init=True, device="cpu", seed=0)
    n_params = sum(p.numel() for p in card.parameters())
    extract = inception.make_extractor(card)
    got = extract(x.to(device)).cpu()
    want = inception.make_extractor(host)(x)
    err = float((got - want).abs().max() / want.abs().max())
    batch = torch.randn((4, 3, 299, 299), generator=gen).to(device)
    ms = time_ms(lambda: extract(batch), iters=10, warmup=2) if device == "cuda" else None
    row = {"params": n_params, "shape": list(got.shape), "max_rel_err": err,
           "bs4_ms": ms, "images_per_s": 4 / (ms / 1e3) if ms else "not measured",
           "tf32": False}
    if n_params != INCEPTION_PARAMS or tuple(got.shape) != (2, 2048) \
            or not torch.isfinite(got).all() or err > TOL_INCEPTION_REL:
        raise AssertionError(f"Inception-v3 on the card: {row}")
    del card, host
    return row


def recal_check(trainer, spade_mod):
    """The averaged copy's re-estimation through the kernel and through
    the plain composition (TF32 off), the live network left bit for bit."""
    from imaginaire_tpu_torch.layers.activation_norm import SpatiallyAdaptiveNorm

    net = trainer.net_G
    live = {k: v.clone() for k, v in net.state_dict().items()}
    fused = {m.fused_modulation for m in net.modules() if isinstance(m, SpatiallyAdaptiveNorm)}
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    try:
        for route, value in (("kernel", next(iter(fused))), ("plain", "none")):
            set_fused(net, value)
            trainer._ema_bn_recal_iter = None
            spade_mod.launches = 0
            if trainer.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.recalculate_model_average_batch_norm_statistics()
            if trainer.device.type == "cuda":
                torch.cuda.synchronize()
            runs[route] = (time.perf_counter() - t0, spade_mod.launches,
                           {k: v.clone() for k, v in trainer._ema_batch_stats.items()})
    finally:
        set_fused(net, next(iter(fused)))
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    (seconds, launches, kernel), (_, plain_launches, plain) = runs["kernel"], runs["plain"]
    buffers = dict(net.named_buffers())
    err = max(float((kernel[k] - plain[k]).abs().max())
              / max(float(plain[k].abs().max()), float(buffers[k].abs().max()))
              for k in kernel)
    moved = min(float((kernel[k] - buffers[k]).abs().max()) for k in kernel)
    unchanged = all(torch.equal(v, live[k]) for k, v in net.state_dict().items())
    row = {"seconds": seconds, "batches": ENTRY_RECAL_BATCHES, "statistics": len(kernel),
           "launches": launches, "plain_launches": plain_launches,
           "max_rel_err_vs_plain": err, "min_max_abs_vs_live": moved,
           "live_unchanged": unchanged}
    if len(fused) != 1 or not kernel or err > TOL_RECAL_REL or moved <= 0 or not unchanged \
            or launches != ENTRY_RECAL_BATCHES * CALLS_PER_FORWARD or plain_launches != 0:
        raise AssertionError(f"re-estimation: {row}")
    return row


def spade_eval_entry(spade_mod, device="cuda", overrides=None, items=ENTRY_ITEMS,
                     hw=ENTRY_HW):
    """Phase 10: SPADE evaluation at COCO-Stuff width through the port's
    ``python -m imaginaire_tpu_torch.evaluate``, in-process."""
    from imaginaire_tpu_torch import evaluate, train
    from imaginaire_tpu_torch.config import Config, recursive_update
    from imaginaire_tpu_torch.serving.engine import ServingEngine, ServingError
    from imaginaire_tpu_torch.trainers.base import EMA_BN_GROUP
    from imaginaire_tpu_torch.trainers.spade import Trainer
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # G runs the defaults; Inception pins fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    inception_row = check_inception(device)
    with tempfile.TemporaryDirectory(prefix="spade_eval_entry_") as tmp:
        tmp = Path(tmp)
        packed = write_entry_dataset(tmp, items, hw)
        eval_overrides = copy.deepcopy(EVAL_OVERRIDES)
        recursive_update(eval_overrides, overrides or {})
        cfg_path = entry_config(tmp, packed, eval_overrides)
        logdir = tmp / "log"
        base = ["--config", str(cfg_path), "--seed", str(ENTRY_SEED), "--device", device]

        # 1. two iterations; a checkpoint at the second, then write_metrics
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        spade_mod.launches = 0
        t0 = time.perf_counter()
        trainer = train.main(base + ["--logdir", str(logdir),
                                     "--max_iter", str(EVAL_TRAIN_ITERS)])
        train_s = time.perf_counter() - t0
        loop_launches = spade_mod.launches
        # the D+G steps; an image snapshot at each iteration (G and the
        # averaged copy, after a re-estimation at the first); at the
        # second, FID (the validation batches), the re-estimation (the
        # training batches) and FID_ema, before its image snapshot
        want_loop = EVAL_TRAIN_ITERS * TRAIN_FWD_LAUNCHES + (
            EVAL_TRAIN_ITERS * 2 + 2 * ENTRY_RECAL_BATCHES
            + 2 * EVAL_VAL_BATCHES) * CALLS_PER_FORWARD
        in_loop = {r["name"]: r["value"] for r in ScalarWriter(str(logdir)).read()
                   if r["kind"] == "counter" and r["step"] == EVAL_TRAIN_ITERS}
        if loop_launches != want_loop or not {"FID", "FID_ema", "best_FID"} <= set(in_loop):
            raise AssertionError(f"write_metrics in the loop: {loop_launches} launches, "
                                 f"expected {want_loop}; meters {sorted(in_loop)}")
        del trainer
        if cuda:
            torch.cuda.empty_cache()

        # 2. a corrupt copy of the checkpoint, first in the sweep's order
        path1 = ckpt_lib.latest_checkpoint_path(str(logdir))
        bad = str(logdir / ckpt_lib.checkpoint_name(0, 0))
        t0 = time.perf_counter()
        shutil.copytree(path1, bad)
        shutil.copy(path1 + ".integrity.json", bad + ".integrity.json")
        with open(Path(bad) / ckpt_lib.STATE_FILE, "r+b") as f:
            f.seek(f.seek(0, 2) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        copy_s = time.perf_counter() - t0

        # 3. the sweep: the corrupt copy quarantined, the checkpoint evaluated
        captured = []
        write_metrics = Trainer.write_metrics

        def capture(self):
            captured[:] = [self]
            return write_metrics(self)

        sweeps, sweep_s, launches = [], [], []
        Trainer.write_metrics = capture
        try:
            for i, target in enumerate((["--checkpoint_logdir", str(logdir)],
                                        ["--checkpoint", path1])):
                captured.clear()
                spade_mod.launches = 0
                t0 = time.perf_counter()
                sweeps.append(evaluate.main(
                    base + target + ["--metrics", "fid,kid,prdc",
                                     "--logdir", str(tmp / f"eval{i}")]))
                sweep_s.append(time.perf_counter() - t0)
                launches.append(spade_mod.launches)
                if cuda:
                    torch.cuda.empty_cache()
        finally:
            Trainer.write_metrics = write_metrics
        trainer = captured[0]
        want_sweep = EVAL_SWEEP_FORWARDS * CALLS_PER_FORWARD
        rows = [s[0] for s in sweeps]
        if [len(s) for s in sweeps] != [1, 1] or launches != [want_sweep, want_sweep] \
                or Path(bad).exists() or not Path(bad + ".corrupt").is_dir() \
                or rows[0]["iteration"] != EVAL_TRAIN_ITERS:
            raise AssertionError(f"sweeps: {[len(s) for s in sweeps]} checkpoints evaluated, "
                                 f"launches {launches} (expected {want_sweep} each), "
                                 f"corrupt copy quarantined: {Path(bad + '.corrupt').is_dir()}")
        recorded = {r["name"] for r in ScalarWriter(str(tmp / "eval0")).read()
                    if r["kind"] == "counter" and r["step"] == EVAL_TRAIN_ITERS}
        bad_values = [k for k in EVAL_METRICS if not np.isfinite(rows[0].get(k, np.nan))]
        if bad_values or rows[0]["FID"] < 0 or rows[0]["FID_ema"] < 0 \
                or not set(EVAL_METRICS) <= recorded:
            raise AssertionError(f"metrics {rows[0]}, in meters.jsonl {sorted(recorded)}")
        sweep_diff = {}
        for k in EVAL_METRICS:
            a, b = rows[0][k], rows[1][k]
            sweep_diff[k] = abs(a - b) if k.startswith("PRDC") else abs(a - b) / max(abs(a), 1e-30)
        over = [k for k, d in sweep_diff.items()
                if d > (TOL_SWEEP_PRDC if k.startswith("PRDC") else TOL_SWEEP_REL)]
        if over:
            raise AssertionError(f"two sweeps of one checkpoint differ: {over}: {rows}")

        # 4. the re-estimation against the plain composition
        recal = recal_check(trainer, spade_mod)

        # 5. the engine serves what the checkpoint restored
        engine = ServingEngine(trainer.cfg, trainer=trainer).initialize()
        eval_logdir = trainer.cfg.logdir
        trainer.cfg.logdir = str(tmp / "empty")
        try:
            engine.load_weights()
            raise AssertionError("load_weights on an empty logdir did not raise")
        except ServingError:
            pass
        trainer.cfg.logdir = str(logdir)  # the training run's: its pointer
        t0 = time.perf_counter()
        loaded = engine.load_weights()
        load_s = time.perf_counter() - t0
        trainer.cfg.logdir = eval_logdir
        stored = torch.load(Path(path1) / ckpt_lib.STATE_FILE, map_location="cpu",
                            weights_only=True, mmap=True)["state"]
        served = engine._variables
        ema_keys = [k for k in stored if k.startswith("ema_G/")]
        bn_keys = [k for k in stored if k.startswith(EMA_BN_GROUP)]
        differ = [k for k in ema_keys if not torch.equal(served[k[len("ema_G/"):]].cpu(), stored[k])]
        differ += [k for k in bn_keys
                   if not torch.equal(served[k[len(EMA_BN_GROUP):]].cpu(), stored[k])]
        if not loaded or not bn_keys or not ema_keys or differ:
            raise AssertionError(f"engine: loaded {loaded}, {len(ema_keys)} averaged weights "
                                 f"and {len(bn_keys)} statistics, differing {differ[:5]}")
        del stored, engine, trainer, captured
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
        if cuda:
            torch.cuda.empty_cache()
    import scipy

    row = {"scipy": scipy.__version__, "inception": inception_row, "train_s": train_s,
           "loop_launches": loop_launches,
           "in_loop_metrics": in_loop, "corrupt_copy_s": copy_s, "sweep_s": sweep_s,
           "sweep_launches": launches, "sweep_forwards": EVAL_SWEEP_FORWARDS,
           "metrics": rows[0], "second_sweep_diff": sweep_diff,
           "quarantined": Path(bad).name, "recalculation": recal,
           "engine_load_s": load_s, "engine_tensors_compared": len(ema_keys) + len(bn_keys),
           "peak_mem_gib": peak, "phase_s": time.perf_counter() - t_phase}
    phase("spade_eval_entry", **row)
    return row


def write_video_dataset(root, sequences=V2V_ENTRY_SEQUENCES,
                        frames=V2V_ENTRY_FRAMES, hw=V2V_ENTRY_HW, seed=ENTRY_SEED):
    """Seeded RGB frames and 35-class seg maps as PNG through the port's
    encoder, packed by ``build_packed_dataset``."""
    from imaginaire_tpu_torch.data.backends import build_packed_dataset
    from imaginaire_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    raw = root / "raw"
    for s_ in range(sequences):
        for t in range(frames):
            for kind, arr in (("images", rng.randint(0, 256, hw + (3,))),
                              ("seg_maps", rng.randint(0, V2V_LABELS, hw))):
                (raw / kind / f"seq{s_:04d}").mkdir(parents=True, exist_ok=True)
                write_png(raw / kind / f"seq{s_:04d}" / f"{t:05d}.png", arr.astype(np.uint8))
    return build_packed_dataset(str(raw), str(root / "packed"), ["images", "seg_maps"])


def video_entry_config(root, packed, overrides=None, name="config.yaml", edit=None):
    """The Cityscapes config, its splits pointed at the packed dataset,
    the weights overrides, short cadences and ``speed_benchmark``, then
    ``overrides`` and ``edit(cfg)``, written to ``root / name``."""
    import yaml

    from imaginaire_tpu_torch.config import load_yaml, recursive_update

    cfg = load_yaml(V2V_CONFIG)
    for split in ("train", "val"):
        cfg["data"][split]["roots"] = [packed]
    recursive_update(cfg, V2V_ENTRY_OVERRIDES)
    recursive_update(cfg, overrides or {})
    if edit is not None:
        edit(cfg)
    path = root / name
    path.write_text(yaml.safe_dump(cfg))
    return path


class plain_kernels:
    """Inside the block the generator's warp and the teacher call the
    plain PyTorch versions of resample2d, correlation and channelnorm in
    place of the kernels (differentiable through autograd)."""

    def __enter__(self):
        from imaginaire_tpu_torch.flow import flownet2
        from imaginaire_tpu_torch.model_utils import fs_vid2vid
        from imaginaire_tpu_torch.ops import channelnorm as cn
        from imaginaire_tpu_torch.ops import correlation as corr
        from imaginaire_tpu_torch.ops import resample2d as rs

        self.saved = [(m, name, getattr(m, name)) for m, name in (
            (fs_vid2vid, "resample2d"), (flownet2, "resample2d"),
            (flownet2, "correlation"), (flownet2, "channelnorm"))]
        fs_vid2vid.resample2d = flownet2.resample2d = rs.resample2d_plain
        flownet2.correlation = corr.correlation_plain
        flownet2.channelnorm = cn.channelnorm_plain
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def video_launches(rs, corr, cn):
    return {"resample2d": rs.launches, "resample2d_bwd": rs.bwd_launches,
            "correlation": corr.launches, "channelnorm": cn.launches}


def reset_video_launches(rs, corr, cn):
    rs.launches = rs.bwd_launches = corr.launches = cn.launches = 0


def fp32_warp_g_step(trainer, data_t, rs, corr, cn, tol, warps=1,
                     flow_losses=("Flow_L1", "Flow_Warp", "Flow_Mask")):
    """One fp32 warp-frame G step (TF32 off; the caller sets fp32) through
    the kernels against the same step through their plain versions, from
    one saved state. The teacher's (flow, conf) for the step's frame pair
    is computed both ways first and held on its own: its flow against the
    plain version's (``TOL_TEACHER_REL`` of the flow's magnitude), its conf
    against the threshold of the plain warp by its own flow (no pixel
    apart, as in phase 6). conf thresholds a warp error, so a rounding-level
    difference upstream flips the pixels lying at the threshold, and a
    loss weighted by conf jumps with them; both steps therefore read the
    kernels' (flow, conf) as the flow cache hands it to a step, and each
    of their losses and the grad norm is a continuous function of the
    kernels' outputs, held within ``tol`` relative. The step warps
    ``warps`` times forward and backward (vid2vid's previous frame; fs-
    vid2vid's reference and previous frame) and has ``flow_losses``. The
    launches of the kernels' step are the teacher's plus the step's own."""
    from imaginaire_tpu_torch.flow.flow_net import CONF_THRESHOLD

    torch.backends.cudnn.allow_tf32 = False
    try:
        im_a, im_b = data_t["image"].float(), data_t["real_prev_image"].float()
        reset_video_launches(rs, corr, cn)
        with torch.no_grad():
            flow, conf = trainer._teacher_flow(im_a, im_b)
        teacher_launches = video_launches(rs, corr, cn)
        reset_video_launches(rs, corr, cn)
        with torch.no_grad(), plain_kernels():
            flow_plain, conf_plain = trainer._teacher_flow(im_a, im_b)
        plain_teacher_launches = video_launches(rs, corr, cn)
        flow_rel = ((flow - flow_plain).abs().max()
                    / flow_plain.abs().max().clamp_min(1e-30)).item()
        warped = rs.resample2d_plain(im_b, flow)
        want = (((im_a - warped) ** 2).sum(1, keepdim=True) < CONF_THRESHOLD).float()
        conf_err = int((want != conf).sum().item())
        conf_flips = float((conf != conf_plain).float().mean())
        teacher = {"flow_rel": flow_rel, "flow_max": flow_plain.abs().max().item(),
                   "conf_mean": float(conf.mean()), "conf_vs_plain_warp_mismatches": conf_err,
                   "conf_flip_share_vs_plain_teacher": conf_flips,
                   "launches": teacher_launches}
        del flow_plain, conf_plain, warped, want
        want_teacher = dict(TEACHER_LAUNCHES, resample2d_bwd=0)
        if teacher_launches != want_teacher or any(plain_teacher_launches.values()) \
                or not flow_rel <= TOL_TEACHER_REL or conf_err:
            raise AssertionError(
                f"fp32 warp-frame teacher, kernels vs plain versions: flow {flow_rel} of "
                f"its magnitude (tol {TOL_TEACHER_REL}), conf off the plain warp's "
                f"threshold at {conf_err} pixels; launches {teacher_launches} (expected "
                f"{want_teacher}) / {plain_teacher_launches}")

        data_t = dict(data_t, flow_gt=flow, conf_gt=conf)
        snap = _snapshot(trainer)

        def g_step():
            losses = trainer._step(trainer.net_G, trainer.opt_G,
                                   lambda: trainer.gen_forward(data_t)[0], None, "gen_step")
            return {k: float(v) for k, v in losses.items()}

        reset_video_launches(rs, corr, cn)
        kernel_step = g_step()
        step_launches = video_launches(rs, corr, cn)
        _restore(trainer, snap)
        reset_video_launches(rs, corr, cn)
        with plain_kernels():
            plain_step = g_step()
        plain_launches = video_launches(rs, corr, cn)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    rel = {k: abs(kernel_step[k] - plain_step[k]) / max(abs(plain_step[k]), 1e-30)
           for k in plain_step}
    worst = max(rel, key=rel.get)
    if step_launches != {"resample2d": warps, "resample2d_bwd": warps, "correlation": 0,
                         "channelnorm": 0} \
            or any(plain_launches.values()) or rel[worst] > tol \
            or not set(flow_losses) <= set(plain_step):
        raise AssertionError(
            f"fp32 warp-frame G step through the kernels vs their plain versions "
            f"(the kernels' teacher output in both): {worst} differs by {rel[worst]} "
            f"(tol {tol}); losses {sorted(plain_step)}; launches {step_launches} / "
            f"{plain_launches}")
    return {"kernels": kernel_step, "plain": plain_step, "worst_rel": [worst, rel[worst]],
            "launches": {k: teacher_launches[k] + step_launches[k] for k in step_launches},
            "teacher": teacher}


def vid2vid_train_entry(rs, corr, cn, device="cuda", overrides=None,
                        hw=V2V_ENTRY_HW, iterations=V2V_ENTRY_ITERATIONS, workdir=None):
    """Phase 9: ``python -m imaginaire_tpu_torch.train`` in-process on a
    seeded packed video dataset, the Cityscapes config at 512x1024, batch
    2, sequence length 4, bf16: the per-frame D-then-G rollout through
    resample2d (forward and backward), correlation and channelnorm. With
    ``workdir`` the dataset (``packed/``), the config and the logdir
    (``log/``, its checkpoint) stay there for phase 11."""
    from imaginaire_tpu_torch import train
    from imaginaire_tpu_torch.resilience.integrity import verify_files
    from imaginaire_tpu_torch.trainers.vid2vid import Trainer
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # training runs the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    with (contextlib.nullcontext(str(workdir)) if workdir is not None
          else tempfile.TemporaryDirectory(prefix="vid2vid_train_entry_")) as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        packed = write_video_dataset(tmp, hw=hw)
        data_s = time.perf_counter() - t0
        cfg_path = video_entry_config(tmp, packed, overrides)
        logdir = tmp / "log"
        args = ["--config", str(cfg_path), "--logdir", str(logdir),
                "--seed", str(ENTRY_SEED), "--device", device,
                "--max_iter", str(iterations)]

        saves, flow_before = [], {}
        save, init_state = Trainer.save_checkpoint, Trainer.init_state

        def timed_save(self, *a, **k):
            t = time.perf_counter()
            path = save(self, *a, **k)
            saves.append(time.perf_counter() - t)
            return path

        def init_and_watch(self, *a, **k):
            out = init_state(self, *a, **k)
            flow_before["w"] = self.net_G.flow_network_temp.conv_flow.conv.weight.detach().clone()
            return out

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        import gc

        gc.collect()  # the earlier phases' profiler garbage (phase 8's note)
        reset_video_launches(rs, corr, cn)
        Trainer.save_checkpoint, Trainer.init_state = timed_save, init_and_watch
        try:
            with HostClocks(Trainer) as clocks:
                t0 = time.perf_counter()
                trainer = train.main(args)
                train_s = time.perf_counter() - t0
        finally:
            Trainer.save_checkpoint, Trainer.init_state = save, init_state
        launches = video_launches(rs, corr, cn)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
        want = {k: iterations * n for k, n in V2V_ENTRY_LAUNCHES.items()}
        if launches != want or trainer.compute_dtype != torch.bfloat16 \
                or trainer.sequence_length != V2V_ENTRY_SEQ:
            raise AssertionError(f"vid2vid training entry launches {launches}, "
                                 f"expected {want}; compute dtype "
                                 f"{trainer.compute_dtype}, sequence length "
                                 f"{trainer.sequence_length}")
        scalars = [r for r in ScalarWriter(logdir).read() if r["kind"] == "counter"
                   and r["name"].split("/")[0] in ("gen_update", "dis_update")]
        names = {r["name"] for r in scalars}
        bad = [r for r in scalars if not np.isfinite(r["value"])
               or r["name"].endswith("nonfinite_count")]
        if bad or not {"gen_update/Flow_L1", "gen_update/Flow_Warp",
                       "gen_update/Flow_Mask", "gen_update/Perceptual",
                       "dis_update/GAN"} <= names:
            raise AssertionError(f"meters.jsonl: {sorted(names)}, non-finite {bad[:5]}")
        flow_moved = (trainer.net_G.flow_network_temp.conv_flow.conv.weight.detach()
                      - flow_before["w"]).abs().max().item()
        if not flow_moved > 0:
            raise AssertionError("the generator's flow network did not move")
        path = ckpt_lib.latest_checkpoint_path(str(logdir))
        integrity = ckpt_lib.read_integrity_sidecar(path)
        t0 = time.perf_counter()
        verify_files(path, integrity["files"], context=path)
        verify_s = time.perf_counter() - t0
        if ckpt_lib.parse_checkpoint_name(path)[1] != iterations \
                or integrity["n_leaves"] != len(trainer.state_tensors()):
            raise AssertionError(f"checkpoint {path}: {integrity['n_leaves']} records")
        timings = {k: [t * 1e3 for t in v] for k, v in trainer.timings.items()}

        # one profiled iteration (the rollout of a batch already on the card)
        from imaginaire_tpu_torch.data import get_train_and_val_dataloader

        loader, _ = get_train_and_val_dataloader(trainer.cfg, seed=ENTRY_SEED)
        loader.dataset.set_sequence_length(V2V_ENTRY_SEQ)
        data = trainer.start_of_iteration(next(iter(loader)), iterations)
        trainer.speed_benchmark = False

        def one_iteration():
            trainer.gen_update(data)
            if cuda:
                torch.cuda.synchronize()

        breakdown = profile_call(one_iteration, repeats=1) if cuda else "not measured"

        # in situ: one fp32 warp-frame G step (TF32 off) through the kernels
        # against the same step through their plain versions
        trainer.compute_dtype = torch.float32
        gen = torch.Generator(device=device).manual_seed(9)
        data_t = trainer._get_data_t(data, 2, data["label"][:, :2],
                                     torch.tanh(torch.randn(data["images"][:, :2].shape,
                                                            generator=gen, device=device)))
        data_t["past_stacks"] = {}
        step = fp32_warp_g_step(trainer, data_t, rs, corr, cn, TOL_V2V_STEP_REL)
        del trainer, data, data_t
        if cuda:
            torch.cuda.empty_cache()
    seq = V2V_ENTRY_SEQ
    kinds = ["first", "continuation"] + ["warp"] * (seq - 2)
    by_type = {step: {kind: [ms for i, ms in enumerate(timings[step])
                             if kinds[i % seq] == kind] for kind in dict.fromkeys(kinds)}
               for step in ("dis_step", "gen_step")}
    median_ms = float(np.median(timings["iteration"]))
    frames = V2V_ENTRY_BATCH * seq
    window_s = sum(timings["data_wait"][1:] + timings["iteration"][1:]) / 1e3
    row = {"sequences": V2V_ENTRY_SEQUENCES, "frames": V2V_ENTRY_FRAMES, "hw": list(hw),
           "batch": V2V_ENTRY_BATCH, "sequence_length": seq, "data_s": data_s,
           "train_s": train_s, "iterations": iterations,
           "iteration_ms": timings["iteration"], "median_iteration_ms": median_ms,
           "frames_per_s": frames / (median_ms / 1e3),
           "frames_per_s_with_data": frames * (iterations - 1) / window_s,
           "step_ms_by_frame": {step: {kind: float(np.median(v)) for kind, v in d.items()}
                                for step, d in by_type.items()},
           "dis_step_ms": timings["dis_step"], "gen_step_ms": timings["gen_step"],
           "data_wait_ms": timings["data_wait"], "loader_wait_ms": timings["loader_wait"],
           "median_data_wait_ms": float(np.median(timings["data_wait"])),
           "host": clocks.table(), "peak_mem_gib": peak, "launches": launches,
           "launches_per_iteration": V2V_ENTRY_LAUNCHES, "flow_net_moved": flow_moved,
           "checkpoint_bytes": sum(integrity["files"][f]["size"] for f in integrity["files"]),
           "checkpoint_save_s": saves, "checkpoint_files_verify_s": verify_s,
           "fp32_step_kernels": step["kernels"], "fp32_step_plain": step["plain"],
           "fp32_worst_rel": step["worst_rel"], "fp32_step_launches": step["launches"],
           "fp32_step_teacher": step["teacher"], "iteration": breakdown}
    phase("vid2vid_train_entry", **{k: v for k, v in row.items() if k != "iteration"})
    if isinstance(breakdown, dict):
        phase("vid2vid_train_profile", **{k: breakdown[k] for k in (
            "wall_ms", "profiled_wall_ms", "device_ms", "idle_share", "families_ms")})
    return row


class PartClock:
    """Seconds spent inside named callables, patched for the ``with``
    block ({name: (owner, attribute)}), each call synchronized with the
    card at both ends; ``wrap(name, fn)`` times another callable."""

    def __init__(self, parts, cuda):
        self.parts, self.cuda = parts, cuda
        self.seconds = dict.fromkeys(parts, 0.0)
        self.calls = dict.fromkeys(parts, 0)

    def wrap(self, name, fn):
        self.seconds.setdefault(name, 0.0)
        self.calls.setdefault(name, 0)

        def timed(*a, **k):
            if self.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if self.cuda:
                    torch.cuda.synchronize()
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return timed

    def __enter__(self):
        self._saved = [(owner, attr, getattr(owner, attr))
                       for owner, attr in self.parts.values()]
        for name, (owner, attr) in self.parts.items():
            setattr(owner, attr, self.wrap(name, getattr(owner, attr)))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)

    def take(self):
        """{name: seconds} and {name: calls} since the last take."""
        out = dict(self.seconds), dict(self.calls)
        self.seconds = dict.fromkeys(self.seconds, 0.0)
        self.calls = dict.fromkeys(self.calls, 0)
        return out


def last_json_line(fn, *args):
    """(return value, the last line fn printed, parsed as JSON)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    print(buf.getvalue(), end="")
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def vid2vid_eval_entry(rs, corr, cn, workdir, device="cuda", overrides=None):
    """Phase 11: vid2vid inference and video evaluation from disk through
    the port's entries, in-process, on phase 9's packed sequences and
    checkpoint (``workdir``), at 512x1024; then the teacher cache's dataset
    half: ``precompute_flow`` twice and one training iteration from the
    disk cache."""
    from scipy import linalg

    from imaginaire_tpu_torch import evaluate, inference, precompute_flow
    from imaginaire_tpu_torch.config import Config, recursive_update
    from imaginaire_tpu_torch.data import get_train_and_val_dataloader
    from imaginaire_tpu_torch.data.paired_videos import Dataset
    from imaginaire_tpu_torch.evaluation import inception
    from imaginaire_tpu_torch.flow.cache import TeacherFlowCache, flow_cache_settings
    from imaginaire_tpu_torch.serving.engine import ServingEngine
    from imaginaire_tpu_torch.trainers.vid2vid import Trainer
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter
    from imaginaire_tpu_torch.utils.misc import nchw_to_nhwc

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # G runs the defaults; Inception pins fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tmp = Path(workdir)
    packed = str(tmp / "packed")
    checkpoint = ckpt_lib.latest_checkpoint_path(str(tmp / "log"))

    def add_test_split(cfg):
        cfg["test_data"] = {
            "name": cfg["data"]["name"], "type": cfg["data"]["type"],
            "num_workers": cfg["data"]["num_workers"],
            "input_types": copy.deepcopy(cfg["data"]["input_types"]),
            "input_image": list(cfg["data"]["input_image"]),
            "input_labels": list(cfg["data"]["input_labels"]),
            "test": dict(copy.deepcopy(cfg["data"]["val"]), roots=[packed])}

    eval_overrides = copy.deepcopy(V2V_EVAL_OVERRIDES)
    recursive_update(eval_overrides, overrides or {})
    cfg_path = video_entry_config(tmp, packed, eval_overrides, name="eval.yaml",
                                  edit=add_test_split)
    clock = PartClock({"load": (Trainer, "load_checkpoint"),
                       "rollout": (Trainer, "_generate_frame"),
                       "png": (Trainer, "_save_test_frame"),
                       "sqrtm": (linalg, "sqrtm")}, cuda)
    make_extractor = inception.make_extractor
    inception.make_extractor = lambda model: clock.wrap("inception", make_extractor(model))
    try:
        with clock:
            # 1. inference: every frame of every sequence, through the entry
            frames, save = {}, Trainer._save_test_frame

            def keep(self, output_dir, key, t, fake):
                frames[(key, t)] = (fake.float().min().item(), fake.float().max().item(),
                                    bool(torch.isfinite(fake).all()))
                if key == "seq0000":
                    frames[("first", t)] = nchw_to_nhwc(fake).cpu().numpy()
                return save(self, output_dir, key, t, fake)

            Trainer._save_test_frame = keep
            out = tmp / "frames"
            reset_video_launches(rs, corr, cn)
            t0 = time.perf_counter()
            try:
                trainer = inference.main([
                    "--config", str(cfg_path), "--checkpoint", checkpoint,
                    "--output_dir", str(out), "--logdir", str(tmp / "inference"),
                    "--seed", str(ENTRY_SEED), "--device", device])
            finally:
                Trainer._save_test_frame = save
            inference_s = time.perf_counter() - t0
            inference_launches = video_launches(rs, corr, cn)
            inference_parts, inference_calls = clock.take()
            written = sorted(str(p.relative_to(out)) for p in out.rglob("*.png"))
            want_files = [f"seq{s_:04d}/{t:04d}.png" for s_ in range(V2V_ENTRY_SEQUENCES)
                          for t in range(V2V_ENTRY_FRAMES)]
            stats = [frames[(f"seq{s_:04d}", t)] for s_ in range(V2V_ENTRY_SEQUENCES)
                     for t in range(V2V_ENTRY_FRAMES)]
            if written != want_files or not all(ok and -1 <= lo and hi <= 1
                                                for lo, hi, ok in stats) \
                    or inference_launches != {"resample2d": V2V_INFERENCE_RESAMPLE,
                                              "resample2d_bwd": 0, "correlation": 0,
                                              "channelnorm": 0}:
                raise AssertionError(f"inference: {len(written)} frames written of "
                                     f"{len(want_files)}, ranges {stats}, launches "
                                     f"{inference_launches}")

            # the first sequence again, streamed by the serving engine from
            # the same checkpoint (the same fp32 forwards: bit for bit)
            engine = ServingEngine(trainer.cfg, trainer=trainer).initialize()
            engine.load_weights(checkpoint)
            clock.take()
            test_set = Dataset(trainer.cfg, is_inference=True, is_test=True)
            test_set.set_inference_sequence_idx(0)
            stream = engine.stream(0)
            stream_diff = [float(np.abs(stream.step({"label": test_set[t]["label"]})
                                        - frames[("first", t)]).max())
                           for t in range(V2V_ENTRY_FRAMES)]
            if any(stream_diff):
                raise AssertionError(f"inference vs the engine's stream: {stream_diff}")
            del engine, trainer, stream, frames
            if cuda:
                torch.cuda.empty_cache()

            # 2. two evaluation sweeps of the checkpoint
            sweeps, sweep_s, sweep_launches, sweep_parts = [], [], [], []
            for i in range(2):
                reset_video_launches(rs, corr, cn)
                t0 = time.perf_counter()
                sweeps.append(evaluate.main([
                    "--config", str(cfg_path), "--checkpoint", checkpoint,
                    "--metrics", "fid,kid,prdc", "--logdir", str(tmp / f"eval{i}"),
                    "--seed", str(ENTRY_SEED), "--device", device]))
                sweep_s.append(time.perf_counter() - t0)
                sweep_launches.append(video_launches(rs, corr, cn))
                sweep_parts.append(clock.take())
                if cuda:
                    torch.cuda.empty_cache()
        want = {"resample2d": V2V_SWEEP_RESAMPLE, "resample2d_bwd": 0, "correlation": 0,
                "channelnorm": 0}
        rows = [s_[0] for s_ in sweeps]
        recorded = {r["name"] for r in ScalarWriter(str(tmp / "eval0")).read()
                    if r["kind"] == "counter"}
        bad = [k for k in V2V_EVAL_METRICS if not np.isfinite(rows[0].get(k, np.nan))]
        if [len(s_) for s_ in sweeps] != [1, 1] or sweep_launches != [want, want] \
                or bad or "FID_ema" in rows[0] or not set(V2V_EVAL_METRICS) <= recorded:
            raise AssertionError(f"sweeps: {rows}, launches {sweep_launches} (expected "
                                 f"{want} each), non-finite {bad}, in meters.jsonl "
                                 f"{sorted(recorded)}")
        n_frames = V2V_EVAL_VIDEOS * V2V_ENTRY_FRAMES
        sweep_diff = {}
        for k in V2V_EVAL_METRICS:
            a, b = rows[0][k], rows[1][k]
            sweep_diff[k] = abs(a - b) if k.startswith("PRDC") else abs(a - b) / max(abs(a), 1e-30)
        over = [k for k, d in sweep_diff.items()
                if d > (1.0 / n_frames if k.startswith("PRDC") else TOL_SWEEP_REL)]
        if over:
            raise AssertionError(f"two sweeps of one checkpoint differ: {over}: {rows}")
    finally:
        inception.make_extractor = make_extractor

    # 3. the teacher cache's dataset half. The committed config draws a
    # random scale per item: precompute_flow refuses it
    def flow_cache_config(name, keep_scale):
        def edit(cfg):
            cfg["flow_cache"] = {"enabled": True, "mode": "disk",
                                 "dir": str(tmp / "flow_cache")}
            aug = cfg["data"]["train"]["augmentations"]
            if not keep_scale:
                # no canonical resolution under a random scale; and the
                # disk path mirrors a flipped item's cached flow where the
                # producer runs the teacher on the flipped frames, which a
                # random-init teacher does not map to the mirrored flow
                del aug["random_scale_limit"], aug["horizontal_flip"]
        return video_entry_config(tmp, packed, overrides, name=name, edit=edit)

    refused = precompute_flow.main(["--config", str(flow_cache_config("scale.yaml", True)),
                                    "--device", device])
    pre_path = flow_cache_config("precompute.yaml", False)
    torch.backends.cudnn.allow_tf32 = False  # the teacher's two runs compared below
    pre_args = ["--config", str(pre_path), "--chunk", str(V2V_PRECOMPUTE_CHUNK), "--json",
                "--device", device]
    precompute, pre_launches, pre_s = [], [], []
    for _ in range(2):
        reset_video_launches(rs, corr, cn)
        t0 = time.perf_counter()
        rc, summary = last_json_line(precompute_flow.main, pre_args)
        pre_s.append(time.perf_counter() - t0)
        pre_launches.append(video_launches(rs, corr, cn))
        precompute.append(dict(summary, rc=rc))
    n = V2V_PRECOMPUTE_FORWARDS
    want_pre = [{"resample2d": 5 * n, "resample2d_bwd": 0, "correlation": n,
                 "channelnorm": 6 * n}, dict.fromkeys(pre_launches[0], 0)]
    if refused != 2 or [p_["rc"] for p_ in precompute] != [0, 0] \
            or [(p_["pairs"], p_["hits"]) for p_ in precompute] != [
                (V2V_PRECOMPUTE_PAIRS, 0), (V2V_PRECOMPUTE_PAIRS, V2V_PRECOMPUTE_PAIRS)] \
            or precompute[1]["hit_rate"] != 1.0 or pre_launches != want_pre:
        raise AssertionError(f"precompute_flow: refused rc {refused}, runs {precompute}, "
                             f"launches {pre_launches} (expected {want_pre})")

    # one training iteration from the disk cache, and the teacher on the
    # same frames in producer mode
    cfg = Config(str(pre_path))
    cfg.logdir = str(tmp / "disk_train")
    loader, _ = get_train_and_val_dataloader(cfg, seed=ENTRY_SEED)
    trainer = Trainer(cfg, device=device, train=True, iters_per_epoch=len(loader),
                      train_data_loader=loader)
    trainer.init_state(seed=ENTRY_SEED)
    loader.set_epoch(0)
    trainer.start_of_epoch(0)
    batch = next(iter(loader))
    reset_video_launches(rs, corr, cn)
    t0 = time.perf_counter()
    data = trainer.start_of_iteration(batch, 0)
    trainer.gen_update(data)
    if cuda:
        torch.cuda.synchronize()
    disk_s = time.perf_counter() - t0
    disk_launches = video_launches(rs, corr, cn)
    hit_rate = trainer.flow_cache.drain_stats().get("flow_cache/hit_rate")
    reset_video_launches(rs, corr, cn)
    producer = TeacherFlowCache(trainer.flow_net_wrapper, flow_cache_settings(
        {"flow_cache": {"enabled": True, "mode": "producer"}}))
    ref = producer.attach({"images": data["images"]})
    producer_launches = video_launches(rs, corr, cn)
    torch.backends.cudnn.allow_tf32 = True
    flow, flow_ref = data["flow_gt"].float(), ref["flow_gt"].float()
    excess = ((flow - flow_ref).abs() - TOL_STORE_ATOL - TOL_STORE_RTOL * flow_ref.abs())
    flow_err = float((flow - flow_ref).abs().max())
    conf_mismatch = float((data["conf_gt"] != ref["conf_gt"]).float().mean())
    pairs = V2V_ENTRY_BATCH * (V2V_ENTRY_SEQ - 1)
    if disk_launches != V2V_DISK_LAUNCHES or hit_rate != [1.0] \
            or tuple(flow.shape) != (V2V_ENTRY_BATCH, V2V_ENTRY_SEQ - 1, 2) + V2V_HW \
            or float(excess.max()) > 0 or conf_mismatch > TOL_CONF_MISMATCH \
            or producer_launches != {"resample2d": 5, "resample2d_bwd": 0,
                                     "correlation": 1, "channelnorm": 6}:
        raise AssertionError(
            f"disk-mode iteration: launches {disk_launches} (expected {V2V_DISK_LAUNCHES}), "
            f"hit rate {hit_rate}, flow_gt {tuple(flow.shape)} off the producer's by "
            f"{flow_err} (float16 store: rtol {TOL_STORE_RTOL}, atol {TOL_STORE_ATOL}), "
            f"conf mismatch share {conf_mismatch}, producer launches {producer_launches}")
    del trainer, data, batch, producer, ref, flow, flow_ref, excess
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
    if cuda:
        torch.cuda.empty_cache()

    def parts(taken):
        seconds, calls = taken
        return {"seconds": seconds, "calls": calls}

    counted = [inference_launches, *sweep_launches, *pre_launches, disk_launches,
               producer_launches]
    total = {k: sum(c[k] for c in counted) for k in counted[0]}

    rollout_frames = inference_calls["rollout"]
    row = {
        "hw": list(V2V_HW), "sequences": V2V_ENTRY_SEQUENCES, "frames": V2V_ENTRY_FRAMES,
        "checkpoint": Path(checkpoint).name,
        "inference_s": inference_s, "inference_parts": parts((inference_parts,
                                                              inference_calls)),
        "rollout_frames_per_s": rollout_frames / inference_parts["rollout"],
        "inference_launches": inference_launches, "frames_written": len(written),
        "stream_max_abs_diff": stream_diff,
        "sweep_s": sweep_s, "sweep_parts": [parts(p_) for p_ in sweep_parts],
        "sweep_rollout_frames_per_s": [p_[1]["rollout"] / p_[0]["rollout"]
                                       for p_ in sweep_parts],
        "sweep_launches": sweep_launches, "metrics": rows[0],
        "second_sweep_diff": sweep_diff, "precompute_refused_rc": refused,
        "precompute": precompute, "precompute_s": pre_s,
        "precompute_launches": pre_launches, "disk_iteration_s": disk_s,
        "disk_launches": disk_launches, "disk_hit_rate": hit_rate[0],
        "disk_pairs": pairs, "flow_gt_max_abs_diff": flow_err,
        "conf_mismatch_share": conf_mismatch, "producer_launches": producer_launches,
        "launches": total, "peak_mem_gib": peak, "phase_s": time.perf_counter() - t_phase,
        "nvidia_smi": nvidia_smi() if cuda else "not measured"}
    phase("vid2vid_eval_entry", **row)
    return row


def write_face_dataset(root, sequences=FS_SEQUENCES, frames=FS_FRAMES, hw=FS_RAW_HW,
                       seed=ENTRY_SEED):
    """Seeded RGB frames as PNG through the port's encoder and dlib-68
    landmark JSON in the repository fixture's format: the fixture's face,
    scaled to 20-30% of the frame's height and placed inside the frame a
    sequence, moved and jittered frame to frame; packed by
    ``build_packed_dataset``."""
    from imaginaire_tpu_torch.data.backends import build_packed_dataset
    from imaginaire_tpu_torch.data.png import write_png

    template = np.asarray(json.loads(FS_LANDMARK_TEMPLATE.read_text()), np.float64)
    template -= template.mean(axis=0)
    template /= np.abs(template).max()
    rng = np.random.RandomState(seed)
    raw = root / "raw"
    h, w = hw
    for s_ in range(sequences):
        size = rng.uniform(0.2, 0.3) * h
        center = np.array([rng.uniform(0.35, 0.65) * w, rng.uniform(0.4, 0.6) * h])
        for t in range(frames):
            center = center + rng.uniform(-4, 4, 2)
            points = template * size + center + rng.normal(0, 1.0, template.shape)
            seq = f"seq{s_:04d}"
            for kind in ("images", "landmarks-dlib68"):
                (raw / kind / seq).mkdir(parents=True, exist_ok=True)
            write_png(raw / "images" / seq / f"{t:05d}.png",
                      rng.randint(0, 256, hw + (3,)).astype(np.uint8))
            (raw / "landmarks-dlib68" / seq / f"{t:05d}.json").write_text(
                json.dumps(np.round(points, 1).tolist()))
    return build_packed_dataset(str(raw), str(root / "packed"),
                                ["images", "landmarks-dlib68"])


def fs_entry_config(root, packed, overrides=None, name="fs.yaml"):
    """The FaceForensics config, its splits (and a test split) pointed at
    the packed dataset, the forced overrides, PNG frames, the harness's
    cadences, then ``overrides``, written to ``root / name``."""
    import yaml

    from imaginaire_tpu_torch.config import load_yaml, recursive_update

    cfg = load_yaml(FS_CONFIG)
    for split in ("train", "val"):
        cfg["data"][split]["roots"] = [packed]
    cfg["data"]["input_types"][0]["images"]["ext"] = "png"
    recursive_update(cfg, copy.deepcopy(FS_FORCED))
    recursive_update(cfg, copy.deepcopy(FS_CADENCES))
    recursive_update(cfg, copy.deepcopy(overrides or {}))
    cfg["test_data"] = dict(copy.deepcopy(cfg["data"]), test=copy.deepcopy(cfg["data"]["val"]))
    path = root / name
    path.write_text(yaml.safe_dump(cfg))
    return path


def fs_frames(cfg, driving, reference, n=FS_STREAM_FRAMES):
    """Stream frames of sequence ``driving`` with frame 0 of sequence
    ``reference`` as the reference, through the port's data pipeline."""
    from imaginaire_tpu_torch.data.paired_few_shot_videos import Dataset

    ds = Dataset(cfg, is_inference=True)
    ds.set_inference_sequence_idx(driving, reference, 0)
    out = []
    for t in range(n):
        item = ds[t]
        out.append({"label": item["label"], "ref_images": item["ref_images"][None],
                    "ref_labels": item["ref_labels"][None]})
    return out


def fs_streams(rs, spade_mod, cfg, device):
    """Phase 12, part 1: two interleaved 6-frame streams at 512x512, each
    driven by one sequence with another's frame as its reference; each
    against itself served alone."""
    from imaginaire_tpu_torch.serving.engine import engine_from_config

    frames = {"A": fs_frames(cfg, 0, 1), "B": fs_frames(cfg, 2, 3)}
    engine = engine_from_config(cfg, device=device)
    engine.initialize(seed=ENTRY_SEED)
    warm = engine.warm()
    rs.launches = spade_mod.launches = 0
    streams = {sid: engine.stream(sid) for sid in frames}
    outputs, per_stream = {sid: [] for sid in frames}, dict.fromkeys(frames, 0)
    for t in range(FS_STREAM_FRAMES):
        for sid, session in streams.items():
            before = rs.launches
            outputs[sid].append(session.step(frames[sid][t]))
            per_stream[sid] += rs.launches - before
    modulation = spade_mod.launches
    stats = engine.stats()
    bad = [(sid, t) for sid, outs in outputs.items() for t, img in enumerate(outs)
           if img.shape != (1,) + FS_HW + (3,) or not np.isfinite(img).all()
           or np.abs(img).max() > 1.0]
    alone_diff = {}
    for sid in frames:
        alone = engine.stream(f"{sid}-alone")
        diff = max(float(np.abs(alone.step(f) - outputs[sid][t]).max())
                   for t, f in enumerate(frames[sid]))
        alone_diff[sid] = (diff, diff / max(float(np.abs(np.stack(outputs[sid])).max()), 1e-30))
        engine.close_stream(f"{sid}-alone")
    if per_stream != dict.fromkeys(frames, FS_STREAM_RESAMPLE) or modulation or bad \
            or any(a > TOL_STREAM or r > TOL_STREAM_REL for a, r in alone_diff.values()):
        raise AssertionError(f"fs streams: resample2d launches {per_stream} (expected "
                             f"{FS_STREAM_RESAMPLE} each), modulation {modulation}, bad "
                             f"frames {bad}, against each stream alone {alone_diff}")
    label = engine.label(*FS_HW, 1, tag="stream")
    ms = stats["exec_ms"][label]
    row = {"warm_ms": warm, "stream_launches": per_stream, "modulation_launches": modulation,
           "frame_ms": ms, "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)), "alone_diff": alone_diff,
           "generator_params": sum(p.numel() for p in engine.trainer.net_G.parameters())}
    del engine, streams
    return row, frames


def fs_warp_frame(trainer, frames, device):
    """A G step's data for a frame with its previous frame: frame 1's
    label and reference from ``frames``, frame 0's label as the history,
    seeded real and previous images."""
    f0, f1 = (trainer._to_device({k: np.asarray(v) for k, v in f.items()})
              for f in frames[:2])
    gen = torch.Generator(device=device).manual_seed(9)

    def image(*lead):
        return torch.tanh(torch.randn(lead + (3,) + FS_HW, generator=gen, device=device))

    return {"label": f1["label"], "image": image(1), "ref_images": f1["ref_images"],
            "ref_labels": f1["ref_labels"], "prev_labels": f0["label"][:, None],
            "prev_images": image(1, 1), "past_stacks": {}}


def fs_hyper_route(rs, spade_mod, cfg_hyper, frames, device):
    """Phase 12, part 2: the ``hyper_spatially_adaptive`` route, which
    runs the modulation kernel: one 3-frame stream (12 launches a
    forward), one fp32 frame and one fp32 G step (TF32 off) through the
    kernels against the same through their plain versions."""
    from imaginaire_tpu_torch.serving.engine import engine_from_config
    from imaginaire_tpu_torch.trainers.fs_vid2vid import Trainer

    engine = engine_from_config(cfg_hyper, device=device)
    engine.initialize(seed=ENTRY_SEED)
    rs.launches = spade_mod.launches = 0
    session = engine.stream("hyper")
    outs = [session.step(f) for f in frames[:FS_HYPER_FRAMES]]
    launches = {"spade_modulation": spade_mod.launches, "resample2d": rs.launches}
    want = {"spade_modulation": FS_HYPER_FRAMES * FS_HYPER_MODULATION,
            "resample2d": 1 + 2 * (FS_HYPER_FRAMES - 1)}
    if launches != want or not all(np.isfinite(o).all() and np.abs(o).max() <= 1 for o in outs):
        raise AssertionError(f"hyper stream launches {launches}, expected {want}")

    # one fp32 warp frame (TF32 off), kernels vs plain versions
    torch.backends.cudnn.allow_tf32 = False
    trainer = engine.trainer
    with torch.inference_mode():
        data = engine._to_device(frames[FS_HYPER_FRAMES])
        data_t = trainer._get_data_t(data, 0, session.prev_labels, session.prev_images)
        spade_mod.launches = 0
        kernel = trainer._apply_G(engine._variables, data_t)["fake_images"]
        frame_launches = spade_mod.launches
        set_fused(trainer.net_G, "none")
        with plain_kernels():
            plain = trainer._apply_G(engine._variables, data_t)["fake_images"]
        frame_err = (kernel - plain).abs().max().item()
    del engine, session
    if device == "cuda":
        torch.cuda.empty_cache()

    # one fp32 G step on a warp frame, kernels vs plain versions
    gtrainer = Trainer(cfg_hyper, device=device, train=True)
    gtrainer.init_state(seed=ENTRY_SEED)
    gtrainer.compute_dtype = torch.float32
    data_t = fs_warp_frame(gtrainer, frames, device)
    snap = [{k: v.clone() for k, v in n.state_dict().items()}
            for n in (gtrainer.net_G, gtrainer.net_D)]

    def g_step():
        out = gtrainer._step(gtrainer.net_G, gtrainer.opt_G,
                             lambda: gtrainer.gen_forward(data_t)[0], None, "gen_step")
        return {k: float(v) for k, v in out.items()}

    spade_mod.launches = spade_mod.bwd_launches = 0
    kernel_step = g_step()
    step_launches = {"forward": spade_mod.launches, "backward": spade_mod.bwd_launches}
    for n, sd in zip((gtrainer.net_G, gtrainer.net_D), snap):
        n.load_state_dict(sd)
    set_fused(gtrainer.net_G, "none")
    with plain_kernels():
        spade_mod.launches = spade_mod.bwd_launches = 0
        plain_step = g_step()
        plain_launches = spade_mod.launches + spade_mod.bwd_launches
    torch.backends.cudnn.allow_tf32 = True
    rel = {k: abs(kernel_step[k] - plain_step[k]) / max(abs(plain_step[k]), 1e-30)
           for k in plain_step}
    worst = max(rel, key=rel.get)
    if frame_launches != FS_HYPER_MODULATION or frame_err > TOL_FS_FRAME \
            or step_launches != {"forward": FS_HYPER_MODULATION,
                                 "backward": FS_HYPER_MODULATION} \
            or plain_launches or rel[worst] > TOL_FS_STEP_REL:
        raise AssertionError(
            f"hyper route: frame launches {frame_launches}, frame error {frame_err} "
            f"(tol {TOL_FS_FRAME}); G step launches {step_launches} / plain "
            f"{plain_launches}, {worst} differs by {rel[worst]} (tol {TOL_FS_STEP_REL})")
    del gtrainer, snap
    return {"stream_launches": launches, "frame_launches": frame_launches,
            "fp32_frame_max_abs": frame_err, "fp32_step_launches": step_launches,
            "fp32_step_kernels": kernel_step, "fp32_step_plain": plain_step,
            "fp32_worst_rel": [worst, rel[worst]]}


def fs_vid2vid_entry(rs, spade_mod, corr, cn, device="cuda", overrides=None,
                     raw_hw=FS_RAW_HW):
    """Phase 12: fs-vid2vid at FaceForensics width: streams through the
    serving engine, the hyper-SPADE route through the modulation kernel,
    ``imaginaire_tpu_torch.train.main`` (4 iterations, batch 3, sequence
    length 4, bf16) and ``imaginaire_tpu_torch.inference.main`` on a
    seeded packed landmark-video dataset, the inference frames against
    the engine's stream of the checkpoint."""
    from imaginaire_tpu_torch import inference, train
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.data.paired_few_shot_videos import Dataset
    from imaginaire_tpu_torch.resilience.integrity import verify_files
    from imaginaire_tpu_torch.serving.engine import ServingEngine
    from imaginaire_tpu_torch.trainers.fs_vid2vid import Trainer
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter
    from imaginaire_tpu_torch.utils.misc import nchw_to_nhwc

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # the defaults; the checks pin fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="fs_vid2vid_entry_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        packed = write_face_dataset(tmp, hw=raw_hw)
        data_s = time.perf_counter() - t0
        cfg_path = fs_entry_config(tmp, packed, overrides)
        hyper_path = fs_entry_config(tmp, packed, {**copy.deepcopy(overrides or {}),
                                                   "gen": {**(overrides or {}).get("gen", {}),
                                                           **FS_HYPER["gen"]}},
                                     name="fs_hyper.yaml")
        cfg = Config(str(cfg_path))

        t0 = time.perf_counter()
        streams, frames = fs_streams(rs, spade_mod, cfg, device)
        streams_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        hyper = fs_hyper_route(rs, spade_mod, Config(str(hyper_path)), frames["A"], device)
        hyper_s = time.perf_counter() - t0
        if cuda:
            torch.cuda.empty_cache()

        # training through the entry
        logdir = tmp / "log"
        saves, before = [], {}
        save, init_state = Trainer.save_checkpoint, Trainer.init_state

        def timed_save(self, *a, **k):
            t = time.perf_counter()
            path = save(self, *a, **k)
            saves.append(time.perf_counter() - t)
            return path

        watched = ("weight_generator.fc_spade_e_0_fc0.weight",
                   "weight_generator.fc_spade_e_3_out.weight",
                   "flow_network_ref.conv_flow.conv.weight",
                   "flow_network_ref.down_in.conv.weight")

        def init_and_watch(self, *a, **k):
            out = init_state(self, *a, **k)
            before.update({n: self.net_G.get_parameter(n).detach().clone() for n in watched})
            return out

        import gc

        gc.collect()
        reset_video_launches(rs, corr, cn)
        spade_mod.launches = spade_mod.bwd_launches = 0
        Trainer.save_checkpoint, Trainer.init_state = timed_save, init_and_watch
        try:
            with HostClocks(Trainer) as clocks:
                t0 = time.perf_counter()
                trainer = train.main(["--config", str(cfg_path), "--logdir", str(logdir),
                                      "--seed", str(ENTRY_SEED), "--device", device,
                                      "--max_iter", str(FS_ITERATIONS)])
                train_s = time.perf_counter() - t0
        finally:
            Trainer.save_checkpoint, Trainer.init_state = save, init_state
        launches = video_launches(rs, corr, cn)
        launches["spade_modulation"] = spade_mod.launches + spade_mod.bwd_launches
        want = {k: FS_ITERATIONS * n for k, n in FS_ENTRY_LAUNCHES.items()}
        want["spade_modulation"] = 0
        if launches != want or trainer.compute_dtype != torch.bfloat16 \
                or trainer.sequence_length != FS_SEQ:
            raise AssertionError(f"fs training entry launches {launches}, expected {want}; "
                                 f"compute dtype {trainer.compute_dtype}, sequence length "
                                 f"{trainer.sequence_length}")
        scalars = [r for r in ScalarWriter(logdir).read() if r["kind"] == "counter"
                   and r["name"].split("/")[0] in ("gen_update", "dis_update")]
        names = {r["name"] for r in scalars}
        bad = [r for r in scalars if not np.isfinite(r["value"])
               or r["name"].endswith("nonfinite_count")]
        if bad or not {"gen_update/Flow", "gen_update/Perceptual", "gen_update/GAN",
                       "gen_update/FeatureMatching", "dis_update/GAN"} <= names:
            raise AssertionError(f"meters.jsonl: {sorted(names)}, non-finite {bad[:5]}")
        moved = {n: (trainer.net_G.get_parameter(n).detach() - before[n]).abs().max().item()
                 for n in watched}
        if not all(v > 0 for v in moved.values()):
            raise AssertionError(f"parameters that did not move: {moved}")
        checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
        integrity = ckpt_lib.read_integrity_sidecar(checkpoint)
        verify_files(checkpoint, integrity["files"], context=checkpoint)
        if ckpt_lib.parse_checkpoint_name(checkpoint)[1] != FS_ITERATIONS \
                or integrity["n_leaves"] != len(trainer.state_tensors()):
            raise AssertionError(f"checkpoint {checkpoint}: {integrity['n_leaves']} records")
        timings = {k: [t * 1e3 for t in v] for k, v in trainer.timings.items()}

        # in situ: one fp32 G step on a warp frame (TF32 off), the kernels
        # against their plain versions
        torch.backends.cudnn.allow_tf32 = False
        trainer.compute_dtype = torch.float32
        data_t = fs_warp_frame(trainer, frames["A"], device)
        snap = _snapshot(trainer)

        def g_step():
            out = trainer._step(trainer.net_G, trainer.opt_G,
                                lambda: trainer.gen_forward(data_t)[0], None, "gen_step")
            return {k: float(v) for k, v in out.items()}

        reset_video_launches(rs, corr, cn)
        kernel_step = g_step()
        step_launches = video_launches(rs, corr, cn)
        _restore(trainer, snap)
        reset_video_launches(rs, corr, cn)
        with plain_kernels():
            plain_step = g_step()
        plain_launches = video_launches(rs, corr, cn)
        torch.backends.cudnn.allow_tf32 = True
        rel = {k: abs(kernel_step[k] - plain_step[k]) / max(abs(plain_step[k]), 1e-30)
               for k in plain_step}
        worst = max(rel, key=rel.get)
        if step_launches != {"resample2d": 2, "resample2d_bwd": 2, "correlation": 0,
                             "channelnorm": 0} \
                or any(plain_launches.values()) or rel[worst] > TOL_FS_STEP_REL:
            raise AssertionError(f"fp32 G step, kernels vs plain versions: {worst} differs "
                                 f"by {rel[worst]} (tol {TOL_FS_STEP_REL}); launches "
                                 f"{step_launches} / {plain_launches}")
        del trainer, snap, data_t
        if cuda:
            torch.cuda.empty_cache()

        # inference through the entry (inference_args: driving sequence 1,
        # the reference frame 0 of sequence 0), then the engine's stream
        kept, save_frame = {}, Trainer._save_test_frame

        def keep(self, output_dir, key, t, fake):
            kept[t] = nchw_to_nhwc(fake).cpu().numpy()
            return save_frame(self, output_dir, key, t, fake)

        out_dir = tmp / "frames"
        reset_video_launches(rs, corr, cn)
        Trainer._save_test_frame = keep
        try:
            t0 = time.perf_counter()
            itrainer = inference.main(["--config", str(cfg_path), "--checkpoint", checkpoint,
                                       "--output_dir", str(out_dir),
                                       "--logdir", str(tmp / "inference"),
                                       "--seed", str(ENTRY_SEED), "--device", device])
            inference_s = time.perf_counter() - t0
        finally:
            Trainer._save_test_frame = save_frame
        inference_launches = video_launches(rs, corr, cn)
        written = sorted(str(p.relative_to(out_dir)) for p in out_dir.rglob("*.png"))
        want_files = [f"seq0001/{t:04d}.png" for t in range(FS_FRAMES)]
        if written != want_files or inference_launches["resample2d"] != FS_STREAM_RESAMPLE \
                or not all(np.isfinite(f).all() and np.abs(f).max() <= 1 for f in kept.values()):
            raise AssertionError(f"inference: written {written}, launches "
                                 f"{inference_launches}")
        engine = ServingEngine(itrainer.cfg, trainer=itrainer).initialize()
        engine.load_weights(checkpoint)
        test_set = Dataset(itrainer.cfg, is_inference=True, is_test=True)
        test_set.set_inference_sequence_idx(1, 0, 0)
        stream = engine.stream(0)
        stream_diff = []
        for t in range(FS_FRAMES):
            item = test_set[t]
            got = stream.step({"label": item["label"], "ref_images": item["ref_images"][None],
                               "ref_labels": item["ref_labels"][None]})
            stream_diff.append(float(np.abs(got - kept[t]).max()))
        if any(stream_diff):
            raise AssertionError(f"inference vs the engine's stream: {stream_diff}")
        del engine, itrainer, stream
        if cuda:
            torch.cuda.empty_cache()
    seq = FS_SEQ
    kinds = ["first"] + ["later"] * (seq - 1)
    by_type = {step: {kind: float(np.median([ms for i, ms in enumerate(timings[step])
                                             if kinds[i % seq] == kind]))
                      for kind in ("first", "later")}
               for step in ("dis_step", "gen_step")}
    median_ms = float(np.median(timings["iteration"]))
    row = {"sequences": FS_SEQUENCES, "frames": FS_FRAMES, "raw_hw": list(raw_hw),
           "data_s": data_s, "streams_s": streams_s, "hyper_s": hyper_s,
           "streams": streams, "hyper": hyper, "train_s": train_s,
           "iterations": FS_ITERATIONS, "batch": FS_BATCH, "sequence_length": seq,
           "iteration_ms": timings["iteration"], "median_iteration_ms": median_ms,
           "frames_per_s": FS_BATCH * seq / (median_ms / 1e3),
           "step_ms_by_frame": by_type, "data_wait_ms": timings["data_wait"],
           "host": clocks.table(), "launches": launches, "moved": moved,
           "checkpoint_bytes": sum(integrity["files"][f]["size"] for f in integrity["files"]),
           "checkpoint_save_s": saves, "fp32_step_kernels": kernel_step,
           "fp32_step_plain": plain_step, "fp32_worst_rel": [worst, rel[worst]],
           "fp32_step_launches": step_launches, "inference_s": inference_s,
           "inference_launches": inference_launches, "stream_vs_inference": stream_diff,
           "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30 if cuda
                            else "not measured"),
           "phase_s": time.perf_counter() - t_phase}
    phase("fs_vid2vid_entry", **row)
    return row


def write_wc_dataset(root, sequences=WC_SEQUENCES, frames=WC_FRAMES, hw=WC_HW,
                     points=WC_POINTS, seed=ENTRY_SEED):
    """Phase 13's folder dataset under ``root / "raw"``: seeded RGB frames
    and the five label types as PNG through the port's encoder, and a
    frame's unprojections pickled as ``{"w{W}xh{H}": flat [i, j, point,
    ...]}``: a sequence's cloud of ``points`` points in a box 5-15 units
    in front of a pinhole camera (focal 0.8 W) that moves 0.08 units
    right and 0.1 forward a frame, each pixel keeping its nearest point.
    Returns (the root, the points mapped a frame)."""
    from imaginaire_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    raw = root / "raw"
    h, w = hw
    focal = 0.8 * w
    mapped = []
    for s_ in range(sequences):
        seq = f"seq{s_:04d}"
        cloud = np.stack([rng.uniform(-6, 6, points), rng.uniform(-3, 3, points),
                          rng.uniform(5, 15, points)], axis=1)
        for t in range(frames):
            rel = cloud - np.array([0.08 * t, 0.0, 0.1 * t])
            u = np.floor(focal * rel[:, 0] / rel[:, 2] + w / 2).astype(np.int64)
            v = np.floor(focal * rel[:, 1] / rel[:, 2] + h / 2).astype(np.int64)
            idx = np.nonzero((u >= 0) & (u < w) & (v >= 0) & (v < h))[0]
            nearest = idx[np.argsort(rel[idx, 2], kind="stable")]
            _, first = np.unique(v[nearest] * w + u[nearest], return_index=True)
            seen = nearest[first]
            rows = np.stack([v[seen], u[seen], seen], axis=1)
            mapped.append(len(rows))
            files = {"images": rng.randint(0, 256, hw + (3,)),
                     "seg_maps-densepose": rng.randint(0, 25, hw),
                     "depth_maps-megadepth": rng.randint(0, 256, hw + (3,)),
                     "edge_maps-hed": rng.randint(0, 256, hw),
                     "pose_maps-densepose": rng.randint(0, 256, hw + (3,)),
                     "pose_maps-openpose": rng.randint(0, 256, hw + (3,))}
            for kind, arr in files.items():
                (raw / kind / seq).mkdir(parents=True, exist_ok=True)
                write_png(raw / kind / seq / f"{t:05d}.png", arr.astype(np.uint8))
            (raw / "unprojections" / seq).mkdir(parents=True, exist_ok=True)
            (raw / "unprojections" / seq / f"{t:05d}.pkl").write_bytes(
                pickle.dumps({f"w{w}xh{h}": rows.reshape(-1).tolist()}))
    return raw, mapped


def wc_entry_config(root, data_root, overrides=None, name="wc.yaml"):
    """The mannequin config, its splits (and a test split) pointed at the
    folder dataset, the forced overrides, PNG frames, the harness's
    cadences, then ``overrides``, written to ``root / name``. The
    single-image model's config path stays the committed relative one,
    found from the repository root."""
    import yaml

    from imaginaire_tpu_torch.config import load_yaml, recursive_update

    cfg = load_yaml(WC_CONFIG)
    for split in ("train", "val"):
        cfg["data"][split]["roots"] = [str(data_root)]
    cfg["data"]["input_types"][0]["images"]["ext"] = "png"
    recursive_update(cfg, copy.deepcopy(WC_FORCED))
    recursive_update(cfg, copy.deepcopy(WC_CADENCES))
    recursive_update(cfg, copy.deepcopy(overrides or {}))
    cfg["test_data"] = dict(copy.deepcopy(cfg["data"]), test=copy.deepcopy(cfg["data"]["val"]))
    path = root / name
    path.write_text(yaml.safe_dump(cfg))
    return path


def wc_warp_frame(trainer, data):
    """Frame 2 of the clip ``data`` as the rollout hands it to a G step: a
    fresh point cloud colored by the takeover's frames 0 and 1, their
    history, and the guidance rendered from the cloud."""
    from imaginaire_tpu_torch.model_utils.fs_vid2vid import concat_frames

    trainer.reset_renderer()
    prev_labels = prev_images = None
    for t in range(2):
        data_t = trainer._get_data_t(data, t, prev_labels, prev_images)
        fake = trainer._frame_override(data_t)
        trainer._after_gen_frame(data_t, fake)
        prev_labels = concat_frames(prev_labels, data_t["label"], trainer.num_frames_G - 1)
        prev_images = concat_frames(prev_images, fake, trainer.num_frames_G - 1)
    data_t = trainer._get_data_t(data, 2, prev_labels, prev_images)
    return {k: v for k, v in data_t.items() if not k.startswith("_")}


def wc_partial_route(rs, cfg_path, data_t, device):
    """The partial-conv route (``WC_PARTIAL``) at the config's full width:
    one fp32 warp-frame forward (TF32 off, fresh seeded weights) through
    the resample2d kernel against the same through its plain version."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.layers.conv import PartialConv2d
    from imaginaire_tpu_torch.models.generators.wc_vid2vid import Generator
    from imaginaire_tpu_torch.utils.init_weight import init_weights

    cfg = Config(str(cfg_path), overrides=copy.deepcopy(WC_PARTIAL))
    with torch.device(device):
        net = Generator(cfg.gen, cfg.data).eval()
    init_weights(net, torch.Generator(device=device).manual_seed(13),
                 cfg.trainer.init.type, cfg.trainer.init.gain)
    partial = sum(isinstance(m, PartialConv2d) for m in net.modules())
    data = {k: data_t[k].float() for k in ("label", "prev_labels", "prev_images", "guidance")}
    runs = {}
    torch.backends.cudnn.allow_tf32 = False
    try:
        for route in ("kernel", "plain"):
            rs.launches = 0
            with torch.no_grad(), (plain_kernels() if route == "plain"
                                   else contextlib.nullcontext()):
                runs[route] = (net(data)["fake_images"], rs.launches)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    err = float((runs["kernel"][0] - runs["plain"][0]).abs().max())
    if partial == 0 or runs["kernel"][1] != 1 or runs["plain"][1] != 0 \
            or not torch.isfinite(runs["kernel"][0]).all() or err > TOL_WC_PARTIAL:
        raise AssertionError(f"partial-conv route: {partial} partial convs, launches "
                             f"{runs['kernel'][1]} / {runs['plain'][1]}, max-abs {err} "
                             f"(tol {TOL_WC_PARTIAL})")
    return {"partial_convs": partial, "fp32_max_abs": err,
            "launches": {route: n for route, (_, n) in runs.items()},
            "generator_params": sum(p.numel() for p in net.parameters())}


def wc_vid2vid_entry(rs, spade_mod, corr, cn, device="cuda", overrides=None, hw=WC_HW,
                     points=WC_POINTS):
    """Phase 13: wc-vid2vid at the mannequin config's width through
    ``imaginaire_tpu_torch.train.main`` (3 iterations, batch 1, sequence
    length 4, bf16: the single-image takeover, then D and G steps with the
    splat-rendered guidance) and ``imaginaire_tpu_torch.inference.main``
    (twice) on a seeded folder dataset with unprojection pickles."""
    from imaginaire_tpu_torch import inference, train
    from imaginaire_tpu_torch.resilience.integrity import verify_files
    from imaginaire_tpu_torch.trainers import wc_vid2vid as wc_trainers
    from imaginaire_tpu_torch.trainers.wc_vid2vid import Trainer
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # the defaults; the checks pin fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="wc_vid2vid_entry_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        raw, mapped = write_wc_dataset(tmp, hw=hw, points=points)
        data_s = time.perf_counter() - t0
        cfg_path = wc_entry_config(tmp, raw, overrides)

        # training through the entry
        logdir = tmp / "log"
        saves, before, clouds = [], {}, []
        save, init_state, after = Trainer.save_checkpoint, Trainer.init_state, \
            Trainer._after_gen_frame

        def timed_save(self, *a, **k):
            t = time.perf_counter()
            path = save(self, *a, **k)
            saves.append(time.perf_counter() - t)
            return path

        def init_and_watch(self, *a, **k):
            out = init_state(self, *a, **k)
            before["w"] = self.net_G.flow_network_temp.conv_flow.conv.weight.detach().clone()
            return out

        def count_points(self, data_t, fake):
            after(self, data_t, fake)
            clouds.append(self._renderer(0).num_points())

        import gc

        gc.collect()
        reset_video_launches(rs, corr, cn)
        spade_mod.launches = spade_mod.bwd_launches = 0
        clock = PartClock({"takeover": (Trainer, "_frame_override"),
                           "guidance": (wc_trainers, "guidance_tensor"),
                           "color": (Trainer, "_after_gen_frame")}, cuda)
        Trainer.save_checkpoint, Trainer.init_state, Trainer._after_gen_frame = \
            timed_save, init_and_watch, count_points
        try:
            with HostClocks(Trainer) as clocks, clock:
                t0 = time.perf_counter()
                trainer = train.main(["--config", str(cfg_path), "--logdir", str(logdir),
                                      "--seed", str(ENTRY_SEED), "--device", device,
                                      "--max_iter", str(WC_ITERATIONS)])
                train_s = time.perf_counter() - t0
        finally:
            Trainer.save_checkpoint, Trainer.init_state, Trainer._after_gen_frame = \
                save, init_state, after
        parts = clock.take()
        launches = video_launches(rs, corr, cn)
        launches["spade_modulation"] = spade_mod.launches + spade_mod.bwd_launches
        want = {k: WC_ITERATIONS * n for k, n in WC_ENTRY_LAUNCHES.items()}
        want["spade_modulation"] = 0
        per_clip = [clouds[i:i + WC_SEQ] for i in range(0, len(clouds), WC_SEQ)]
        if launches != want or trainer.compute_dtype != torch.bfloat16 \
                or trainer.sequence_length != WC_SEQ \
                or parts[1]["takeover"] != WC_ITERATIONS * WC_SEQ \
                or len(per_clip) != WC_ITERATIONS \
                or not all(c == sorted(c) and c[-1] > c[0] > 0 for c in per_clip):
            raise AssertionError(f"wc training entry launches {launches}, expected {want}; "
                                 f"compute dtype {trainer.compute_dtype}, sequence length "
                                 f"{trainer.sequence_length}, calls {parts[1]}, the point "
                                 f"clouds a clip {per_clip}")
        scalars = [r for r in ScalarWriter(logdir).read() if r["kind"] == "counter"
                   and r["name"].split("/")[0] in ("gen_update", "dis_update")]
        names = {r["name"] for r in scalars}
        bad = [r for r in scalars if not np.isfinite(r["value"])
               or r["name"].endswith("nonfinite_count")]
        guidance_loss = [r["value"] for r in scalars if r["name"] == "gen_update/Guidance"]
        if bad or not guidance_loss or not all(v > 0 for v in guidance_loss) \
                or not {"gen_update/Flow_L1", "gen_update/Flow_Warp", "gen_update/Flow_Mask",
                        "gen_update/Perceptual", "dis_update/GAN"} <= names:
            raise AssertionError(f"meters.jsonl: {sorted(names)}, non-finite {bad[:5]}, "
                                 f"Guidance {guidance_loss}")
        flow_moved = (trainer.net_G.flow_network_temp.conv_flow.conv.weight.detach()
                      - before["w"]).abs().max().item()
        if not flow_moved > 0:
            raise AssertionError("the generator's flow network did not move")
        checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
        integrity = ckpt_lib.read_integrity_sidecar(checkpoint)
        verify_files(checkpoint, integrity["files"], context=checkpoint)
        if ckpt_lib.parse_checkpoint_name(checkpoint)[1] != WC_ITERATIONS \
                or integrity["n_leaves"] != len(trainer.state_tensors()):
            raise AssertionError(f"checkpoint {checkpoint}: {integrity['n_leaves']} records")
        timings = {k: [t * 1e3 for t in v] for k, v in trainer.timings.items()}
        params = {"generator": sum(p.numel() for p in trainer.net_G.parameters()),
                  "single_image": sum(p.numel()
                                      for p in trainer.single_image_model.parameters())}

        # in situ: one fp32 warp-frame G step with guidance (TF32 off), the
        # kernels against their plain versions
        from imaginaire_tpu_torch.data import get_train_and_val_dataloader

        loader, _ = get_train_and_val_dataloader(trainer.cfg, seed=ENTRY_SEED)
        loader.dataset.set_sequence_length(WC_SEQ)
        data = trainer.start_of_iteration(next(iter(loader)), WC_ITERATIONS)
        torch.backends.cudnn.allow_tf32 = False
        trainer.compute_dtype = torch.float32
        data = {k: v.float() if torch.is_tensor(v) and v.is_floating_point() else v
                for k, v in data.items()}
        data_t = wc_warp_frame(trainer, data)
        guidance_valid = float(data_t["guidance"][:, 3].mean())
        step = fp32_warp_g_step(trainer, data_t, rs, corr, cn, TOL_WC_STEP_REL)
        if not step["kernels"].get("Guidance", 0) > 0 or not guidance_valid > 0:
            raise AssertionError(f"fp32 warp-frame G step with guidance: valid share "
                                 f"{guidance_valid}, losses {step['kernels']}")
        del trainer, data
        if cuda:
            torch.cuda.empty_cache()
        partial = wc_partial_route(rs, cfg_path, data_t, device)
        del data_t
        if cuda:
            torch.cuda.empty_cache()

        # inference through the entry, twice: every frame of both sequences
        runs = []
        save_frame = Trainer._save_test_frame
        for i in range(2):
            kept = {}

            def keep(self, output_dir, key, t, fake):
                kept[(key, t)] = fake.detach().float().cpu().clone()
                return save_frame(self, output_dir, key, t, fake)

            out_dir = tmp / f"frames{i}"
            reset_video_launches(rs, corr, cn)
            Trainer._save_test_frame = keep
            try:
                t0 = time.perf_counter()
                inference.main(["--config", str(cfg_path), "--checkpoint", checkpoint,
                                "--output_dir", str(out_dir),
                                "--logdir", str(tmp / f"inference{i}"),
                                "--seed", str(ENTRY_SEED), "--device", device])
                seconds = time.perf_counter() - t0
            finally:
                Trainer._save_test_frame = save_frame
            written = sorted(str(p.relative_to(out_dir)) for p in out_dir.rglob("*.png"))
            runs.append((kept, seconds, video_launches(rs, corr, cn), written))
            if cuda:
                torch.cuda.empty_cache()
        want_files = [f"seq{s_:04d}/{t:04d}.png" for s_ in range(WC_SEQUENCES)
                      for t in range(WC_FRAMES)]
        frames0, frames1 = runs[0][0], runs[1][0]
        same = sorted(frames0) == sorted(frames1) and all(
            torch.equal(frames0[k], frames1[k]) for k in frames0)
        for kept, _, inf_launches, written in runs:
            if written != want_files or inf_launches != {
                    "resample2d": WC_INFERENCE_RESAMPLE, "resample2d_bwd": 0,
                    "correlation": 0, "channelnorm": 0} \
                    or not all(torch.isfinite(f).all() and f.abs().max() <= 1
                               for f in kept.values()):
                raise AssertionError(f"inference: written {written}, launches "
                                     f"{inf_launches}")
        if not same:
            raise AssertionError("two inference runs of one checkpoint differ")
    seq = WC_SEQ
    by_type = {step: {"warp": float(np.median(timings[step]))}
               for step in ("dis_step", "gen_step")}
    median_ms = float(np.median(timings["iteration"]))
    seconds, calls = parts
    row = {"sequences": WC_SEQUENCES, "frames": WC_FRAMES, "hw": list(hw),
           "points": points, "mapped_points_per_frame": [min(mapped), max(mapped)],
           "data_s": data_s, "generator_params": params["generator"],
           "single_image_params": params["single_image"], "train_s": train_s,
           "iterations": WC_ITERATIONS, "batch": 1, "sequence_length": seq,
           "iteration_ms": timings["iteration"], "median_iteration_ms": median_ms,
           "frames_per_s": seq / (median_ms / 1e3), "step_ms_by_frame": by_type,
           "steps_a_clip": WC_WARP_FRAMES,  # the takeover frames take no step
           "takeover_ms": 1e3 * seconds["takeover"] / calls["takeover"],
           "guidance_render_ms": 1e3 * seconds["guidance"] / calls["guidance"],
           "color_readback_ms": 1e3 * seconds["color"] / calls["color"],
           "data_wait_ms": timings["data_wait"], "loader_wait_ms": timings["loader_wait"],
           "host": clocks.table(), "launches": launches,
           "launches_per_iteration": WC_ENTRY_LAUNCHES, "points_a_clip": per_clip,
           "guidance_loss": guidance_loss, "flow_net_moved": flow_moved,
           "checkpoint_bytes": sum(integrity["files"][f]["size"] for f in integrity["files"]),
           "checkpoint_save_s": saves, "guidance_valid_share": guidance_valid,
           "fp32_step_kernels": step["kernels"], "fp32_step_plain": step["plain"],
           "fp32_worst_rel": step["worst_rel"], "fp32_step_launches": step["launches"],
           "fp32_step_teacher": step["teacher"], "partial_conv": partial,
           "inference_s": [r[1] for r in runs],
           "inference_launches": runs[0][2], "inference_frames": len(frames0),
           "inference_bit_equal": same,
           "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30 if cuda
                            else "not measured"),
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": nvidia_smi() if cuda else "not measured"}
    phase("wc_vid2vid_entry", **row)
    return row


def write_cityscapes_dataset(root, n_train=P2P_TRAIN_ITEMS, n_val=P2P_VAL_ITEMS, hw=P2P_HW,
                             seed=ENTRY_SEED, block=32):
    """Phase 14's raw folders ``root/{train,val}/{images,seg_maps,
    instance_maps}/seq0000/<i>.png``, packed by the port's builder into
    ``root/packed_{train,val}``: seeded RGB images, and on a grid of
    ``block``-pixel cells a 35-class seg map and its 16-bit instance map,
    a cell of a thing label taking the id label x 1000 + k (k counting
    along the row, so neighbouring cells of one label are one id apart)
    and a stuff cell its label. Returns ({split: packed root}, the ids
    written)."""
    from imaginaire_tpu_torch.data.backends import build_packed_dataset
    from imaginaire_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    h, w = hw
    written, packed = set(), {}
    for split, n in (("train", n_train), ("val", n_val)):
        raw = root / split
        for i in range(n):
            labels = rng.randint(0, P2P_LABELS, (h // block, w // block))
            thing = rng.uniform(size=labels.shape) < 0.5
            labels[thing] = rng.choice(list(P2P_THINGS), int(thing.sum()))
            ids = labels.astype(np.int64)
            for r in range(ids.shape[0]):
                for c in range(ids.shape[1]):
                    if labels[r, c] in P2P_THINGS:
                        ids[r, c] = labels[r, c] * 1000 + c
            written |= set(np.unique(ids).tolist())
            up = lambda a: np.repeat(np.repeat(a, block, 0), block, 1)  # noqa: E731
            for kind, arr in (("images", rng.randint(0, 256, hw + (3,)).astype(np.uint8)),
                              ("seg_maps", up(labels).astype(np.uint8)),
                              ("instance_maps", up(ids).astype(np.uint16))):
                (raw / kind / "seq0000").mkdir(parents=True, exist_ok=True)
                write_png(raw / kind / "seq0000" / f"{i:05d}.png", arr)
        packed[split] = build_packed_dataset(str(raw), str(root / f"packed_{split}"),
                                             ["images", "seg_maps", "instance_maps"])
    return packed, written


def write_encoder_dataset(root, items=P2P_ENC_ITEMS, hw=P2P_ENC_HW, seed=ENTRY_SEED):
    """The encoder path's folder dataset: seeded PNG images, 8-class seg
    maps and 16-bit instance maps of four quadrant instances (labels 1-8,
    each a quarter of the image)."""
    from imaginaire_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    h, w = hw
    for i in range(items):
        ids = np.zeros(hw, np.uint16)
        quads = rng.permutation(np.arange(1, 9))[:4]
        for q, (y, x) in enumerate(((0, 0), (0, w // 2), (h // 2, 0), (h // 2, w // 2))):
            ids[y:y + h // 2, x:x + w // 2] = quads[q]
        for kind, arr in (("images", rng.randint(0, 256, hw + (3,)).astype(np.uint8)),
                          ("seg_maps", rng.randint(0, 8, hw).astype(np.uint8)),
                          ("instance_maps", ids)):
            (root / kind / "seq0000").mkdir(parents=True, exist_ok=True)
            write_png(root / kind / "seq0000" / f"{i:05d}.png", arr)
    return root


def p2p_config(root, base, edit, name):
    """``base``'s config, ``edit(cfg)`` applied, a test split copied from
    the val split, written to ``root / name``."""
    import yaml

    from imaginaire_tpu_torch.config import load_yaml

    cfg = load_yaml(base)
    edit(cfg)
    cfg["test_data"] = dict(copy.deepcopy(cfg["data"]), test=copy.deepcopy(cfg["data"]["val"]))
    path = root / name
    path.write_text(yaml.safe_dump(cfg))
    return path


def all_launches(rs, corr, cn, spade_mod):
    out = video_launches(rs, corr, cn)
    out.update(spade_modulation=spade_mod.launches,
               spade_modulation_bwd=spade_mod.bwd_launches)
    return out


def reset_all_launches(rs, corr, cn, spade_mod):
    reset_video_launches(rs, corr, cn)
    spade_mod.launches = spade_mod.bwd_launches = 0


def pix2pixHD_entry(rs, spade_mod, corr, cn, device="cuda", overrides=None, hw=P2P_HW,
                    enc_hw=P2P_ENC_HW):
    """Phase 14: pix2pixHD at the Cityscapes config's width through
    ``imaginaire_tpu_torch.train.main`` (2 iterations, batch 2, bf16, a
    checkpoint) and ``.inference.main`` from a verified load of it, on a
    seeded packed dataset with 16-bit instance maps; then the encoder path
    of the unit config (2 iterations, the port's K-means before the
    save). No kernel of the port runs: every launch count must stay 0."""
    from imaginaire_tpu_torch import inference, train
    from imaginaire_tpu_torch.config import recursive_update
    from imaginaire_tpu_torch.data.png import decode_png
    from imaginaire_tpu_torch.model_utils.pix2pixHD import get_edges
    from imaginaire_tpu_torch.resilience.integrity import verify_files
    from imaginaire_tpu_torch.trainers.pix2pixHD import Trainer
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # training runs the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pix2pixHD_entry_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        packed, written = write_cityscapes_dataset(tmp, hw=hw)
        data_s = time.perf_counter() - t0

        def cityscapes(cfg):
            cfg["data"]["train"]["roots"] = [packed["train"]]
            cfg["data"]["val"]["roots"] = [packed["val"]]
            for section in (P2P_FORCED, P2P_CADENCES, overrides or {}):
                recursive_update(cfg, copy.deepcopy(section))

        cfg_path = p2p_config(tmp, P2P_CONFIG, cityscapes, "p2p.yaml")

        # training through the entry; the bf16 label and the int32 ids of
        # each D and G step kept
        logdir = tmp / "log"
        saves, steps = [], []
        save, prepare = Trainer.save_checkpoint, Trainer._prepare

        def timed_save(self, *a, **k):
            t = time.perf_counter()
            path = save(self, *a, **k)
            saves.append(time.perf_counter() - t)
            return path

        def keep_step(self, data):
            out = prepare(self, data)
            steps.append((out["label"][:, -1].detach().cpu(),
                          out["instance_maps"].detach().cpu(), out["label"].dtype))
            return out

        import gc

        gc.collect()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_all_launches(rs, corr, cn, spade_mod)
        Trainer.save_checkpoint, Trainer._prepare = timed_save, keep_step
        try:
            with HostClocks(Trainer) as clocks:
                t0 = time.perf_counter()
                trainer = train.main(["--config", str(cfg_path), "--logdir", str(logdir),
                                      "--seed", str(ENTRY_SEED), "--device", device])
                train_s = time.perf_counter() - t0
        finally:
            Trainer.save_checkpoint, Trainer._prepare = save, prepare
        train_peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
        launches = all_launches(rs, corr, cn, spade_mod)
        params = {"generator": sum(p.numel() for p in trainer.net_G.parameters()),
                  "discriminator": sum(p.numel() for p in trainer.net_D.parameters())}
        if any(launches.values()) or trainer.compute_dtype != torch.bfloat16 \
                or trainer.current_iteration != P2P_ITERATIONS \
                or params != {"generator": P2P_G_PARAMS, "discriminator": P2P_D_PARAMS} \
                or len(steps) != 2 * P2P_ITERATIONS:
            raise AssertionError(f"pix2pixHD training entry: launches {launches} (all 0 "
                                 f"expected), compute dtype {trainer.compute_dtype}, "
                                 f"iterations {trainer.current_iteration}, params {params}")
        # the edges the bf16 step saw are get_edges of the uint16 ids
        neighbours = 0
        for edges, inst, dtype in steps:
            inst_np = inst.numpy().transpose(0, 2, 3, 1)
            want = torch.from_numpy(get_edges(inst_np)[..., 0])
            ids = set(np.unique(inst_np).tolist())
            pairs = (inst_np[:, :, 1:] - inst_np[:, :, :-1] == 1) & (inst_np[:, :, 1:] >= 1000)
            neighbours += int(pairs.sum())
            if dtype != torch.bfloat16 or inst.dtype != torch.int32 \
                    or not torch.equal(edges.float(), want) or not ids <= written:
                raise AssertionError(f"the step's edges differ from get_edges of the ids "
                                     f"({int((edges.float() != want).sum())} pixels), label "
                                     f"{dtype}, ids {inst.dtype}, unknown ids "
                                     f"{sorted(ids - written)[:5]}")
        if not neighbours:
            raise AssertionError("no neighbouring instances one id apart reached a step")
        scalars = [r for r in ScalarWriter(logdir).read() if r["kind"] == "counter"
                   and r["name"].split("/")[0] in ("gen_update", "dis_update")]
        names = {r["name"] for r in scalars}
        bad = [r for r in scalars if not np.isfinite(r["value"])]
        if bad or not {"gen_update/GAN", "gen_update/FeatureMatching",
                       "gen_update/Perceptual", "dis_update/GAN"} <= names \
                or set(trainer.weights) != {"GAN", "FeatureMatching", "Perceptual"}:
            raise AssertionError(f"meters.jsonl: {sorted(names)}, non-finite {bad[:5]}, "
                                 f"weights {sorted(trainer.weights)}")
        checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
        integrity = ckpt_lib.read_integrity_sidecar(checkpoint)
        t0 = time.perf_counter()
        verify_files(checkpoint, integrity["files"], context=checkpoint)
        verify_s = time.perf_counter() - t0
        if ckpt_lib.parse_checkpoint_name(checkpoint)[1] != P2P_ITERATIONS \
                or integrity["n_leaves"] != len(trainer.state_tensors()):
            raise AssertionError(f"checkpoint {checkpoint}: {integrity['n_leaves']} records")
        timings = {k: [t * 1e3 for t in v] for k, v in trainer.timings.items()}
        del trainer
        if cuda:
            torch.cuda.empty_cache()

        # inference through the entry from a verified load of the checkpoint
        kept, generate = [], Trainer._generate

        def keep(self, *a, **k):
            out = generate(self, *a, **k)
            kept.append(out.detach().float().cpu())
            return out

        out_dir = tmp / "frames"
        reset_all_launches(rs, corr, cn, spade_mod)
        Trainer._generate = keep
        try:
            t0 = time.perf_counter()
            inference.main(["--config", str(cfg_path), "--checkpoint", checkpoint,
                            "--output_dir", str(out_dir), "--logdir", str(tmp / "inference"),
                            "--seed", str(ENTRY_SEED), "--device", device])
            inference_s = time.perf_counter() - t0
        finally:
            Trainer._generate = generate
        inf_launches = all_launches(rs, corr, cn, spade_mod)
        pngs = sorted(out_dir.rglob("*.png"))
        shapes = [decode_png(p.read_bytes()).shape for p in pngs]
        if len(pngs) != P2P_VAL_ITEMS or any(s_ != hw + (3,) for s_ in shapes) \
                or any(inf_launches.values()) or len(kept) != P2P_VAL_ITEMS \
                or not all(torch.isfinite(f).all() and f.abs().max() <= 1 for f in kept):
            raise AssertionError(f"inference: {len(pngs)} PNGs of {shapes}, launches "
                                 f"{inf_launches}, outputs {len(kept)}")
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
        if cuda:
            torch.cuda.empty_cache()

        # the encoder path: the unit config, PNG images, 2 iterations
        enc_root = write_encoder_dataset(tmp / "enc_raw", hw=enc_hw)

        def encoder_cfg(cfg):
            cfg["data"]["input_types"][0]["images"]["ext"] = "png"
            for split in ("train", "val"):
                cfg["data"][split]["roots"] = [str(enc_root)]
                cfg["data"][split]["augmentations"]["resize_h_w"] = \
                    f"{enc_hw[0]}, {enc_hw[1]}"

        enc_cfg_path = p2p_config(tmp, P2P_UNIT, encoder_cfg, "p2p_enc.yaml")
        clusters, pre_save = [], Trainer._pre_save_checkpoint

        def timed_clusters(self):
            t = time.perf_counter()
            pre_save(self)
            clusters.append(time.perf_counter() - t)

        reset_all_launches(rs, corr, cn, spade_mod)
        Trainer._pre_save_checkpoint = timed_clusters
        try:
            t0 = time.perf_counter()
            enc_trainer = train.main(["--config", str(enc_cfg_path), "--logdir",
                                      str(tmp / "enc_log"), "--seed", str(ENTRY_SEED),
                                      "--device", device])
            enc_s = time.perf_counter() - t0
        finally:
            Trainer._pre_save_checkpoint = pre_save
        enc_launches = all_launches(rs, corr, cn, spade_mod)
        enc_ckpt = ckpt_lib.latest_checkpoint_path(str(tmp / "enc_log"))
        stored = ckpt_lib.load_checkpoint(enc_ckpt)["state"]["cluster_centers"]
        clustered = int((stored.abs().sum(dim=2) > 0).sum())
        if any(enc_launches.values()) or not enc_trainer.net_G.concat_features \
                or not clusters or clustered == 0 or not torch.isfinite(stored).all() \
                or not torch.equal(stored.to(enc_trainer.cluster_centers.device),
                                   enc_trainer.cluster_centers):
            raise AssertionError(f"encoder path: launches {enc_launches}, clustered centers "
                                 f"{clustered}, K-means calls {len(clusters)}")
        del enc_trainer
        if cuda:
            torch.cuda.empty_cache()
    # the first iteration carries the process's first cuDNN work at these
    # shapes; the warm figures are the iterations after it
    warm_ms = float(np.median(timings["iteration"][1:]))
    batch = 2
    row = {"items": {"train": P2P_TRAIN_ITEMS, "val": P2P_VAL_ITEMS}, "hw": list(hw),
           "data_s": data_s, "generator_params": params["generator"],
           "discriminator_params": params["discriminator"], "train_s": train_s,
           "iterations": P2P_ITERATIONS, "batch": batch,
           "iteration_ms": timings["iteration"],
           "first_iteration_ms": timings["iteration"][0],
           "warm_iterations": len(timings["iteration"]) - 1,
           "warm_iteration_ms": warm_ms, "warm_images_per_s": batch / (warm_ms / 1e3),
           "warm_dis_step_ms": float(np.median(timings["dis_step"][1:])),
           "warm_gen_step_ms": float(np.median(timings["gen_step"][1:])),
           "dis_step_ms": timings["dis_step"], "gen_step_ms": timings["gen_step"],
           "data_wait_ms": timings["data_wait"], "loader_wait_ms": timings["loader_wait"],
           "host": clocks.table(), "launches": launches,
           "neighbouring_ids_one_apart": neighbours, "train_peak_mem_gib": train_peak,
           "checkpoint_bytes": sum(integrity["files"][f]["size"] for f in integrity["files"]),
           "checkpoint_save_s": saves, "checkpoint_files_verify_s": verify_s,
           "inference_s": inference_s, "inference_launches": inf_launches,
           "inference_items": len(kept),
           "encoder_path": {"hw": list(enc_hw), "train_s": enc_s, "kmeans_s": clusters,
                            "clustered_centers": clustered, "launches": enc_launches},
           "peak_mem_gib": peak, "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": nvidia_smi() if cuda else "not measured"}
    phase("pix2pixHD_entry", **row)
    return row


def write_unpaired_dataset(root, hw=UNPAIRED_HW, seed=ENTRY_SEED):
    """Phase 15's raw folders ``root/{train,val}/{images_a,images_b}/
    seq0000/<i>.png`` (seeded smooth RGB images, domain B's of another
    hue), packed by the port's builder into ``root/packed_{train,val}``,
    each domain with its own file list. Returns {split: packed root}."""
    from imaginaire_tpu_torch.data.backends import build_packed_dataset
    from imaginaire_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    packed = {}
    for split, counts in UNPAIRED_ITEMS.items():
        raw = root / split
        for domain, n, tint in (("images_a", counts[0], (1.0, 0.6, 0.3)),
                                ("images_b", counts[1], (0.3, 0.6, 1.0))):
            (raw / domain / "seq0000").mkdir(parents=True, exist_ok=True)
            for i in range(n):
                waves = sum(np.sin(xs * rng.uniform(0.01, 0.08) + ys * rng.uniform(0.01, 0.08)
                                   + rng.uniform(0, 6.3)) for _ in range(3)) / 3
                img = np.stack([(0.5 + 0.4 * waves * t) for t in tint], axis=-1)
                img = img + rng.normal(0, 0.03, img.shape)
                write_png(raw / domain / "seq0000" / f"{i:05d}.png",
                          np.clip(img * 255, 0, 255).astype(np.uint8))
        packed[split] = build_packed_dataset(str(raw), str(root / f"packed_{split}"),
                                             ["images_a", "images_b"])
    return packed


def unpaired_fp32_forward(device="cuda", hw=(256, 256)):
    """One fp32 MUNIT generator forward of the AFHQ config at full width on
    ``device`` (TF32 off) against the port's CPU forward at the same
    seeded weights, the style codes injected: every output of the
    training forward (reconstructions, translations, re-encodings, the
    cycle). Returns the worst relative L2 and the device's ms."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.models.generators.munit import Generator
    from imaginaire_tpu_torch.utils.init_weight import init_weights

    cfg = Config(UNPAIRED_CONFIGS["munit"])
    torch.manual_seed(0)
    cpu_net = Generator(cfg.gen, cfg.data)
    init_weights(cpu_net, torch.Generator().manual_seed(ENTRY_SEED), "orthogonal", 1.0)
    cpu_net.eval()
    gen = torch.Generator().manual_seed(ENTRY_SEED + 1)
    data = {k: torch.rand((1, 3) + tuple(hw), generator=gen) * 2 - 1
            for k in ("images_a", "images_b")}
    noise = tuple(torch.randn((1, cpu_net.autoencoder_a.style_channels), generator=gen)
                  for _ in range(2))
    net = Generator(cfg.gen, cfg.data).to(device).eval()
    net.load_state_dict(cpu_net.state_dict())
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = cpu_net(data, noise=noise)
            dev_data = {k: v.to(device) for k, v in data.items()}
            dev_noise = tuple(z.to(device) for z in noise)
            got = net(dev_data, noise=dev_noise)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            net(dev_data, noise=dev_noise)
            if device == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    errs = {}
    for k, w in want.items():
        g = got[k].float().cpu()
        errs[k] = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    return errs, ms


def unpaired_entry(rs, spade_mod, corr, cn, device="cuda", overrides=None, hw=UNPAIRED_HW,
                   fwd_hw=(256, 256)):
    """Phase 15: UNIT and MUNIT at their committed configs' widths through
    ``imaginaire_tpu_torch.train.main`` (2 iterations, a checkpoint) and
    ``.inference.main`` from a verified load of it, on seeded packed
    unpaired datasets; then one fp32 MUNIT generator forward on the card
    against the CPU. No kernel of the port runs: every launch count must
    stay 0."""
    import gc

    from imaginaire_tpu_torch import inference, train
    from imaginaire_tpu_torch.config import recursive_update
    from imaginaire_tpu_torch.data.png import decode_png
    from imaginaire_tpu_torch.registry import resolve
    from imaginaire_tpu_torch.resilience.integrity import verify_files
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # training runs the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory(prefix="unpaired_entry_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        packed = write_unpaired_dataset(tmp, hw=hw)
        data_s = time.perf_counter() - t0
        for family, base in UNPAIRED_CONFIGS.items():
            def edit(cfg):
                for split in ("train", "val"):
                    cfg["data"][split]["roots"] = [packed[split]]
                for entry in cfg["data"]["input_types"]:
                    for info in entry.values():
                        info["ext"] = "png"
                for section in (UNPAIRED_FORCED, UNPAIRED_CADENCES,
                                (overrides or {}).get(family, {})):
                    recursive_update(cfg, copy.deepcopy(section))

            cfg_path = p2p_config(tmp, base, edit, f"{family}.yaml")
            trainer_cls = resolve(f"imaginaire_tpu.trainers.{family}", "Trainer")
            logdir = tmp / f"{family}_log"
            saves, save = [], trainer_cls.save_checkpoint

            def timed_save(self, *a, _save=save, **k):
                t = time.perf_counter()
                path = _save(self, *a, **k)
                saves.append(time.perf_counter() - t)
                return path

            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            reset_all_launches(rs, corr, cn, spade_mod)
            trainer_cls.save_checkpoint = timed_save
            try:
                t0 = time.perf_counter()
                trainer = train.main(["--config", str(cfg_path), "--logdir", str(logdir),
                                      "--seed", str(ENTRY_SEED), "--device", device])
                train_s = time.perf_counter() - t0
            finally:
                trainer_cls.save_checkpoint = save
            train_peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
            launches = all_launches(rs, corr, cn, spade_mod)
            params = (sum(p.numel() for p in trainer.net_G.parameters()),
                      sum(p.numel() for p in trainer.net_D.parameters()))
            if any(launches.values()) or trainer.current_iteration != UNPAIRED_ITERATIONS \
                    or trainer.compute_dtype != UNPAIRED_DTYPES[family] \
                    or params != UNPAIRED_PARAMS[family]:
                raise AssertionError(f"{family} training entry: launches {launches} (all 0 "
                                     f"expected), iterations {trainer.current_iteration}, "
                                     f"compute dtype {trainer.compute_dtype}, params {params}")
            scalars = [r for r in ScalarWriter(logdir).read() if r["kind"] == "counter"
                       and r["name"].split("/")[0] in ("gen_update", "dis_update")]
            names = {r["name"] for r in scalars}
            bad = [r for r in scalars if not np.isfinite(r["value"])]
            want_terms = {f"gen_update/{k}" for k in trainer.weights if k not in
                          ("gp", "consistency_reg")} | {"dis_update/gan", "gen_update/total"}
            if bad or not want_terms <= names:
                raise AssertionError(f"{family} meters.jsonl: {sorted(names)}, non-finite "
                                     f"{bad[:5]}, expected {sorted(want_terms)}")
            checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
            integrity = ckpt_lib.read_integrity_sidecar(checkpoint)
            t0 = time.perf_counter()
            verify_files(checkpoint, integrity["files"], context=checkpoint)
            verify_s = time.perf_counter() - t0
            if ckpt_lib.parse_checkpoint_name(checkpoint)[1] != UNPAIRED_ITERATIONS \
                    or integrity["n_leaves"] != len(trainer.state_tensors()):
                raise AssertionError(f"checkpoint {checkpoint}: {integrity['n_leaves']} records")
            timings = {k: [t * 1e3 for t in v] for k, v in trainer.timings.items()}
            weights = sorted(trainer.weights)
            del trainer
            if cuda:
                torch.cuda.empty_cache()

            # inference through the entry from a verified load of the checkpoint
            kept, forward = [], trainer_cls.inference_forward

            def keep(self, *a, _forward=forward, **k):
                out = _forward(self, *a, **k)
                kept.append(out.detach().float().cpu())
                return out

            out_dir = tmp / f"{family}_out"
            reset_all_launches(rs, corr, cn, spade_mod)
            trainer_cls.inference_forward = keep
            try:
                t0 = time.perf_counter()
                inference.main(["--config", str(cfg_path), "--checkpoint", checkpoint,
                                "--output_dir", str(out_dir), "--logdir",
                                str(tmp / f"{family}_inference"), "--seed", str(ENTRY_SEED),
                                "--device", device])
                inference_s = time.perf_counter() - t0
            finally:
                trainer_cls.inference_forward = forward
            inf_launches = all_launches(rs, corr, cn, spade_mod)
            pngs = sorted(out_dir.rglob("*.png"))
            n_test = max(UNPAIRED_ITEMS["val"])
            if len(pngs) != n_test or len(kept) != n_test or any(inf_launches.values()) \
                    or not all(torch.isfinite(f).all() for f in kept):
                raise AssertionError(f"{family} inference: {len(pngs)} PNGs, {len(kept)} "
                                     f"outputs, launches {inf_launches}")
            # each PNG is its output clipped to [-1, 1] (one 8-bit level)
            written = sorted(((str(p), decode_png(p.read_bytes())) for p in pngs))
            clip_err = 0.0
            for out, (_, img) in zip(kept, written):
                want = (out[0].clamp(-1, 1).permute(1, 2, 0).numpy() + 1) * 127.5
                if img.shape != want.shape:
                    raise AssertionError(f"{family} inference PNG {img.shape}, output "
                                         f"{want.shape}")
                clip_err = max(clip_err, float(np.abs(img - want).max()))
            if clip_err > 1.0 + 1e-3:
                raise AssertionError(f"{family} PNGs differ from the clipped outputs by "
                                     f"{clip_err} levels")
            warm = timings["iteration"][1:]
            rows[family] = {
                "config": str(base.relative_to(REPO)), "compute_dtype": str(
                    UNPAIRED_DTYPES[family]).removeprefix("torch."),
                "generator_params": params[0], "discriminator_params": params[1],
                "loss_weights": weights, "train_s": train_s,
                "iterations": UNPAIRED_ITERATIONS, "batch": 1,
                "iteration_ms": timings["iteration"],
                "first_iteration_ms": timings["iteration"][0],
                "warm_iteration_ms": float(np.median(warm)),
                "first_dis_step_ms": timings["dis_step"][0],
                "first_gen_step_ms": timings["gen_step"][0],
                "warm_dis_step_ms": float(np.median(timings["dis_step"][1:])),
                "warm_gen_step_ms": float(np.median(timings["gen_step"][1:])),
                "data_wait_ms": timings["data_wait"], "launches": launches,
                "train_peak_mem_gib": train_peak,
                "checkpoint_bytes": sum(f["size"] for f in integrity["files"].values()),
                "checkpoint_save_s": saves, "checkpoint_files_verify_s": verify_s,
                "inference_s": inference_s, "inference_items": len(kept),
                "inference_launches": inf_launches,
                "inference_max_abs": max(float(f.abs().max()) for f in kept),
                "png_vs_clipped_output_levels": clip_err}
    reset_all_launches(rs, corr, cn, spade_mod)
    errs, fwd_ms = unpaired_fp32_forward(device, hw=fwd_hw)
    fwd_launches = all_launches(rs, corr, cn, spade_mod)
    worst = max(errs.values())
    if any(fwd_launches.values()) or not worst <= TOL_UNPAIRED_FWD:
        raise AssertionError(f"fp32 MUNIT forward: card vs CPU {errs} (gate "
                             f"{TOL_UNPAIRED_FWD}), launches {fwd_launches}")
    row = {"hw": list(hw), "items": UNPAIRED_ITEMS, "data_s": data_s, **rows,
           "fp32_forward": {"hw": list(fwd_hw), "max_rel_l2": worst, "rel_l2": errs,
                            "card_ms": fwd_ms, "launches": fwd_launches},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda
           else "not measured",
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": nvidia_smi() if cuda else "not measured"}
    phase("unpaired_entry", **row)
    return row


def write_fewshot_dataset(root, hw=FUNIT_HW, seed=ENTRY_SEED):
    """Phase 16's raw folders ``root/{train,val}/{images_content,
    images_style}/class<c>/<i>.png`` (seeded smooth RGB images, each class
    of its own tint), packed by ``build_packed_dataset`` into
    ``root/packed_{train,val}``, each type with its own file list. Returns
    {split: packed root}."""
    from imaginaire_tpu_torch.data.backends import build_packed_dataset
    from imaginaire_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    h, w = hw
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    packed = {}
    for split, n in FUNIT_ITEMS.items():
        raw = root / split
        for data_type in ("images_content", "images_style"):
            for c in range(FUNIT_CLASSES):
                tint = rng.uniform(0.3, 1.0, 3)
                folder = raw / data_type / f"class{c}"
                folder.mkdir(parents=True, exist_ok=True)
                for i in range(n):
                    waves = sum(np.sin(xs * rng.uniform(0.01, 0.08)
                                       + ys * rng.uniform(0.01, 0.08) + rng.uniform(0, 6.3))
                                for _ in range(3)) / 3
                    img = np.stack([(0.5 + 0.4 * waves * t) for t in tint], axis=-1)
                    img = img + rng.normal(0, 0.03, img.shape)
                    write_png(folder / f"{i:05d}.png",
                              np.clip(img * 255, 0, 255).astype(np.uint8))
        packed[split] = build_packed_dataset(str(raw), str(root / f"packed_{split}"),
                                             ["images_content", "images_style"])
    return packed


def funit_fp32_forward(family, device="cuda", hw=(256, 256)):
    """One fp32 forward of ``family``'s generator at its committed
    config's full width on ``device`` (TF32 off) against the port's CPU
    forward at the same seeded weights (kaiming, gain 1; COCO-FUNIT's
    ``usb`` by its own draw), batch 1: the translation and the
    reconstruction. Returns {output: relative L2} and the device's ms."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.registry import resolve
    from imaginaire_tpu_torch.utils.init_weight import init_weights

    cfg = Config(FUNIT_CONFIGS[family])
    cls = resolve(cfg.gen.type, "Generator")
    cpu_net = cls(cfg.gen, cfg.data)
    init_weights(cpu_net, torch.Generator().manual_seed(ENTRY_SEED), "kaiming", 1.0)
    cpu_net.eval()
    gen = torch.Generator().manual_seed(ENTRY_SEED + 1)
    data = {k: torch.rand((1, 3) + tuple(hw), generator=gen) * 2 - 1
            for k in ("images_content", "images_style")}
    net = cls(cfg.gen, cfg.data).to(device).eval()
    net.load_state_dict(cpu_net.state_dict())
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = cpu_net(data)
            dev_data = {k: v.to(device) for k, v in data.items()}
            got = net(dev_data)
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            net(dev_data)
            if device == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    errs = {}
    for k, w in want.items():
        g = got[k].float().cpu()
        if g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{family} fp32 forward {k}: {tuple(g.shape)}, finite "
                                 f"{bool(torch.isfinite(g).all())}")
        errs[k] = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))
    return errs, ms


def funit_entry(rs, spade_mod, corr, cn, device="cuda", overrides=None, hw=FUNIT_HW,
                fwd_hw=(256, 256)):
    """Phase 16: COCO-FUNIT (mammals) and FUNIT (animal faces) at their
    committed configs' widths through ``imaginaire_tpu_torch.train.main``
    (2 iterations at batch 8, a checkpoint) on a seeded packed few-shot
    dataset, COCO-FUNIT's ``.inference.main`` from a verified load of its
    checkpoint, then one fp32 forward of each generator on the card
    against the CPU. No kernel of the port runs: every launch count must
    stay 0."""
    import gc

    from imaginaire_tpu_torch import inference, train
    from imaginaire_tpu_torch.config import recursive_update
    from imaginaire_tpu_torch.data.png import decode_png
    from imaginaire_tpu_torch.registry import resolve
    from imaginaire_tpu_torch.resilience.integrity import verify_files
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # training runs the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory(prefix="funit_entry_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        packed = write_fewshot_dataset(tmp, hw=hw)
        data_s = time.perf_counter() - t0
        for family, base in FUNIT_CONFIGS.items():
            def edit(cfg):
                for split in ("train", "val"):
                    cfg["data"][split]["roots"] = [packed[split]]
                for entry in cfg["data"]["input_types"]:
                    for info in entry.values():
                        info["ext"] = "png"
                for section in (FUNIT_FORCED, UNPAIRED_CADENCES,
                                (overrides or {}).get(family, {})):
                    recursive_update(cfg, copy.deepcopy(section))

            cfg_path = p2p_config(tmp, base, edit, f"{family}.yaml")
            trainer_cls = resolve("imaginaire_tpu.trainers.funit", "Trainer")
            logdir = tmp / f"{family}_log"
            saves, save = [], trainer_cls.save_checkpoint

            def timed_save(self, *a, _save=save, **k):
                t = time.perf_counter()
                path = _save(self, *a, **k)
                saves.append(time.perf_counter() - t)
                return path

            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            reset_all_launches(rs, corr, cn, spade_mod)
            trainer_cls.save_checkpoint = timed_save
            try:
                t0 = time.perf_counter()
                trainer = train.main(["--config", str(cfg_path), "--logdir", str(logdir),
                                      "--seed", str(ENTRY_SEED), "--device", device])
                train_s = time.perf_counter() - t0
            finally:
                trainer_cls.save_checkpoint = save
            train_peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
            launches = all_launches(rs, corr, cn, spade_mod)
            params = (sum(p.numel() for p in trainer.net_G.parameters()),
                      sum(p.numel() for p in trainer.net_D.parameters()))
            batch = int(trainer.cfg.data.train.batch_size)
            if any(launches.values()) or trainer.current_iteration != FUNIT_ITERATIONS \
                    or trainer.compute_dtype != torch.bfloat16 or batch != FUNIT_BATCH \
                    or params != FUNIT_PARAMS[family] or not trainer.model_average:
                raise AssertionError(f"{family} training entry: launches {launches} (all 0 "
                                     f"expected), iterations {trainer.current_iteration}, "
                                     f"compute dtype {trainer.compute_dtype}, batch {batch}, "
                                     f"params {params}")
            scalars = [r for r in ScalarWriter(logdir).read() if r["kind"] == "counter"
                       and r["name"].split("/")[0] in ("gen_update", "dis_update")]
            names = {r["name"] for r in scalars}
            bad = [r for r in scalars if not np.isfinite(r["value"])]
            want_terms = {f"gen_update/{k}" for k in trainer.weights} | {
                "dis_update/gan", "dis_update/D_real_acc", "gen_update/total"}
            if bad or not want_terms <= names:
                raise AssertionError(f"{family} meters.jsonl: {sorted(names)}, non-finite "
                                     f"{bad[:5]}, expected {sorted(want_terms)}")
            checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
            integrity = ckpt_lib.read_integrity_sidecar(checkpoint)
            t0 = time.perf_counter()
            verify_files(checkpoint, integrity["files"], context=checkpoint)
            verify_s = time.perf_counter() - t0
            if ckpt_lib.parse_checkpoint_name(checkpoint)[1] != FUNIT_ITERATIONS \
                    or integrity["n_leaves"] != len(trainer.state_tensors()):
                raise AssertionError(f"checkpoint {checkpoint}: {integrity['n_leaves']} records")
            timings = {k: [t * 1e3 for t in v] for k, v in trainer.timings.items()}
            weights = sorted(trainer.weights)
            del trainer
            if cuda:
                torch.cuda.empty_cache()
            warm = timings["iteration"][1:]
            rows[family] = {
                "config": str(base.relative_to(REPO)), "compute_dtype": "bfloat16",
                "generator_params": params[0], "discriminator_params": params[1],
                "loss_weights": weights, "train_s": train_s,
                "iterations": FUNIT_ITERATIONS, "batch": batch,
                "iteration_ms": timings["iteration"],
                "first_iteration_ms": timings["iteration"][0],
                "warm_iteration_ms": float(np.median(warm)),
                "first_dis_step_ms": timings["dis_step"][0],
                "first_gen_step_ms": timings["gen_step"][0],
                "warm_dis_step_ms": float(np.median(timings["dis_step"][1:])),
                "warm_gen_step_ms": float(np.median(timings["gen_step"][1:])),
                "warm_images_per_s": batch / (float(np.median(warm)) / 1e3),
                "data_wait_ms": timings["data_wait"], "launches": launches,
                "train_peak_mem_gib": train_peak,
                "checkpoint_bytes": sum(f["size"] for f in integrity["files"].values()),
                "checkpoint_save_s": saves, "checkpoint_files_verify_s": verify_s}
            if family not in FUNIT_INFERS:
                continue

            # inference through the entry from a verified load of the checkpoint
            kept, forward = [], trainer_cls.inference_forward

            def keep(self, params, data, *a, _forward=forward, **k):
                out = _forward(self, params, data, *a, **k)
                kept.extend(zip(data["key"], out.detach().float().cpu()))
                return out

            out_dir = tmp / f"{family}_out"
            reset_all_launches(rs, corr, cn, spade_mod)
            trainer_cls.inference_forward = keep
            try:
                t0 = time.perf_counter()
                inference.main(["--config", str(cfg_path), "--checkpoint", checkpoint,
                                "--output_dir", str(out_dir), "--logdir",
                                str(tmp / f"{family}_inference"), "--seed", str(ENTRY_SEED),
                                "--device", device])
                inference_s = time.perf_counter() - t0
            finally:
                trainer_cls.inference_forward = forward
            inf_launches = all_launches(rs, corr, cn, spade_mod)
            n_test = FUNIT_CLASSES * FUNIT_ITEMS["val"]
            last = dict(kept)  # a key drawn twice: its PNG holds the later output
            pngs = sorted(out_dir.rglob("*.png"))
            if len(kept) != n_test or len(pngs) != len(last) or any(inf_launches.values()) \
                    or not all(torch.isfinite(f).all() and float(f.abs().max()) <= 1.0
                               for _, f in kept):
                raise AssertionError(f"{family} inference: {len(pngs)} PNGs, {len(kept)} "
                                     f"outputs ({len(last)} keys), launches {inf_launches}, "
                                     f"max |out| {max(float(f.abs().max()) for _, f in kept)}")
            png_err = 0.0
            for key, out in last.items():
                img = decode_png((out_dir / f"{key}.png").read_bytes())
                want = (out.permute(1, 2, 0).numpy() + 1) * 127.5
                if img.shape != want.shape:
                    raise AssertionError(f"{family} inference PNG {img.shape}, output "
                                         f"{want.shape}")
                png_err = max(png_err, float(np.abs(img - want).max()))
            if png_err > 1.0 + 1e-3:
                raise AssertionError(f"{family} PNGs differ from the outputs by {png_err} "
                                     "levels")
            rows[family].update(
                inference_s=inference_s, inference_items=len(kept),
                inference_keys=len(last), inference_launches=inf_launches,
                inference_max_abs=max(float(f.abs().max()) for _, f in kept),
                png_vs_output_levels=png_err)
    fwd = {}
    for family in FUNIT_CONFIGS:
        reset_all_launches(rs, corr, cn, spade_mod)
        errs, fwd_ms = funit_fp32_forward(family, device, hw=fwd_hw)
        fwd_launches = all_launches(rs, corr, cn, spade_mod)
        if any(fwd_launches.values()) or not max(errs.values()) <= TOL_FUNIT_FWD:
            raise AssertionError(f"fp32 {family} forward: card vs CPU {errs} (gate "
                                 f"{TOL_FUNIT_FWD}), launches {fwd_launches}")
        fwd[family] = {"max_rel_l2": max(errs.values()), "rel_l2": errs, "card_ms": fwd_ms,
                       "launches": fwd_launches}
    row = {"hw": list(hw), "classes": FUNIT_CLASSES, "items_a_class": FUNIT_ITEMS,
           "data_s": data_s, **rows, "fp32_forward": {"hw": list(fwd_hw), **fwd},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda
           else "not measured",
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": nvidia_smi() if cuda else "not measured"}
    phase("funit_entry", **row)
    return row


# vid2vid dancing (phase 17): a seeded pose dataset, 4 sequences of
# 6 frames at 512x640 (the smaller side 512, as the config's resize
# expects) with one dancer a frame, OpenPose JSON in the layout of the
# repository's fixture (75 body, 210 face, 63 + 63 hand values), and a
# one-sequence test split; configs/projects/vid2vid/dancing/bf16.yaml
# with the override its loader needs (ROADMAP.md §C, C12), 2 iterations at
# batch 2, sequence length 4, bf16
POSE_CONFIG = REPO / "configs/projects/vid2vid/dancing/bf16.yaml"
POSE_SEQUENCES, POSE_FRAMES, POSE_HW, POSE_CROP = 4, 6, (512, 640), (512, 512)
POSE_TEST_FRAMES = 4
POSE_ITERATIONS, POSE_SEQ, POSE_BATCH = 2, 4, 2
# (sequence, frame) -> the hands (left, right) its dancer shows; every
# other frame shows both. Frame 4 of sequence 2 holds a second, smaller
# dancer with both hands beside a main one with none: largest-only keeps
# the main one, so its hands count 0
POSE_HANDS = {(0, 1): (False, True), (1, 3): (True, False), (2, 2): (False, False),
              (2, 4): (False, False), (3, 5): (True, False)}
POSE_SECOND_DANCER = (2, 4)
POSE_C12 = {"data": {"for_pose_dataset": {"pose_one_hot": True}}}
POSE_OVERRIDES = {"logging_iter": 1, "snapshot_save_iter": 1000,
                  "snapshot_save_epoch": 1000, "image_save_iter": 1000,
                  "trainer": {"speed_benchmark": True,
                              "perceptual_loss": {"allow_random_init": True}},
                  "flow_network": {"allow_random_init": True}}
# fs-vid2vid YouTubeDancing (phase 18):
# configs/projects/fs_vid2vid/YouTubeDancing/bf16.yaml at its widths
# (512x256, batch 6, sequence length 4, bf16, DensePose + OpenPose labels
# of 6 channels, the few-shot face D) with the forced overrides: PNG
# frames (the card's machine has no JPEG codec), no VGG19 or FlowNet2
# weights, and the finetune cut to YTD_FINETUNE_ITER iterations. A seeded
# folder dataset at the config's 540-pixel side: 12 sequences of 5 frames
# (two batches of 6 an epoch: the 2 iterations end inside epoch 0, so the
# run saves once), a dancer and a bystander a frame
YTD_CONFIG = REPO / "configs/projects/fs_vid2vid/YouTubeDancing/bf16.yaml"
YTD_SEQUENCES, YTD_FRAMES, YTD_RAW_HW = 12, 5, (540, 960)
YTD_ITERATIONS, YTD_SEQ, YTD_BATCH = 2, 4, 6
YTD_HW = (512, 256)
YTD_WALK = 20.0  # pixels the dancer moves a frame
YTD_DANCER_ID, YTD_BYSTANDER_ID = 3, 7
YTD_FINETUNE_ITER = 3
YTD_FORCED = {"trainer": {"perceptual_loss": {"allow_random_init": True}},
              "flow_network": {"allow_random_init": True},
              "inference_args": {"finetune_iter": YTD_FINETUNE_ITER}}
YTD_CADENCES = {"logging_iter": 1, "snapshot_save_iter": 1000, "snapshot_save_epoch": 1000,
                "image_save_iter": 1000, "trainer": {"speed_benchmark": True}}
# launches, predicted from the code (the FaceForensics path's): a
# training frame warps the reference in its D step's and its G step's
# forward from the first frame on, and the previous output from the
# second; its G backward runs each warp's backward (dflow alone: the
# reference is data, the previous output detached): 14 / 7 an iteration
# of 4 frames. No teacher runs in the fs G step and the committed
# config's SPADE base is BatchNorm: correlation, channelnorm and the
# modulation 0. The finetune's iterations are one-frame (the reference
# warp: 2 forward, 1 backward each); the inference then warps 1 + 2 a
# later frame of the driving sequence
YTD_ENTRY_LAUNCHES = {"resample2d": YTD_ITERATIONS * 2 * (2 * YTD_SEQ - 1),
                      "resample2d_bwd": YTD_ITERATIONS * (2 * YTD_SEQ - 1),
                      "correlation": 0, "channelnorm": 0,
                      "spade_modulation": 0, "spade_modulation_bwd": 0}
YTD_INFERENCE_LAUNCHES = {"resample2d": 2 * YTD_FINETUNE_ITER + 1 + 2 * (YTD_FRAMES - 1),
                          "resample2d_bwd": YTD_FINETUNE_ITER, "correlation": 0,
                          "channelnorm": 0, "spade_modulation": 0, "spade_modulation_bwd": 0}
# the hyper route (configs/unit_test/fs_vid2vid_pose.yaml: 3 downsamples,
# 4 HyperRes2dBlocks of 2 hyper norms, each fusing its first modulation
# pair with the instance norm): 8 modulations a forward, 8 backwards a G
# step, 2 warps and 2 dflows a warp frame's G step
YTD_HYPER_CONFIG = REPO / "configs/unit_test/fs_vid2vid_pose.yaml"
YTD_HYPER_HW, YTD_HYPER_LABELS = (64, 64), 27
YTD_HYPER_LAUNCHES = {
    "g_step": {"resample2d": 2, "resample2d_bwd": 2, "correlation": 0, "channelnorm": 0,
               "spade_modulation": 8, "spade_modulation_bwd": 8},
    "forward": {"resample2d": 2, "resample2d_bwd": 0, "correlation": 0, "channelnorm": 0,
                "spade_modulation": 8, "spade_modulation_bwd": 0}}
# BODY_25 keypoints of a standing dancer: (x, y) in units of its height
# from the top of its head, x to the image's right
BODY_25 = np.array([
    (0.0, 0.08), (0.0, 0.18), (-0.1, 0.19), (-0.14, 0.32), (-0.16, 0.44),
    (0.1, 0.19), (0.14, 0.32), (0.16, 0.44), (0.0, 0.5), (-0.06, 0.5),
    (-0.07, 0.72), (-0.07, 0.94), (0.06, 0.5), (0.07, 0.72), (0.07, 0.94),
    (-0.02, 0.065), (0.02, 0.065), (-0.04, 0.075), (0.04, 0.075), (0.1, 0.98),
    (0.12, 0.98), (0.06, 0.97), (-0.1, 0.98), (-0.12, 0.98), (-0.06, 0.97)])


def openpose_person(cx, top, height, phase_, rng, hands=(True, True)):
    """One OpenPose ``people`` entry: a dancer centred at ``cx`` whose arms
    swing with ``phase_``; 70 face keypoints on the head and 21 a hand
    around the wrists, a missing hand all zeros (OpenPose's layout)."""
    body = BODY_25.copy()
    swing = 0.06 * np.sin(phase_)
    body[[3, 4], 1] -= [swing, 2 * swing]
    body[[6, 7], 1] += [swing, 2 * swing]
    xy = body * height + [cx, top]
    xy += rng.normal(0, 0.5, xy.shape)

    def with_conf(pts, lo):
        return np.concatenate([pts, rng.uniform(lo, 1.0, (len(pts), 1))], 1)

    head = xy[0] + [0, -0.01 * height]
    ang = np.linspace(0.0, 2 * np.pi, 70, endpoint=False)
    face = head + np.stack([np.cos(ang), np.sin(ang)], 1) * [0.035 * height, 0.045 * height]
    person = {"pose_keypoints_2d": with_conf(xy, 0.6).ravel().tolist(),
              "face_keypoints_2d": with_conf(face, 0.7).ravel().tolist()}
    for key, wrist, sign, present in (("hand_left_keypoints_2d", 7, 1, hands[0]),
                                      ("hand_right_keypoints_2d", 4, -1, hands[1])):
        if not present:
            person[key] = [0.0] * 63
            continue
        fingers = [xy[wrist]]
        for f in range(5):
            a = np.pi / 2 + sign * (f - 2) * 0.35
            for j in range(1, 5):
                fingers.append(xy[wrist] + 0.022 * height * j * np.array([np.cos(a) * sign,
                                                                          np.sin(a)]))
        person[key] = with_conf(np.array(fingers), 0.5).ravel().tolist()
    return person


def write_pose_dataset(root, sequences=POSE_SEQUENCES, frames=POSE_FRAMES, hw=POSE_HW,
                       seed=ENTRY_SEED, packed=True):
    """Seeded RGB frames (PNG through the port's encoder) and OpenPose
    JSON under ``root/raw``, one dancer a frame moving across the
    sequence, the hands of ``POSE_HANDS``; packed by
    ``build_packed_dataset`` into ``root/packed`` (or left as folders).
    Returns the dataset's root."""
    from imaginaire_tpu_torch.data.backends import build_packed_dataset
    from imaginaire_tpu_torch.data.png import write_png

    rng = np.random.RandomState(seed)
    h, w = hw
    raw = Path(root) / "raw"
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for s_ in range(sequences):
        tint = rng.uniform(0.3, 1.0, 3)
        for t in range(frames):
            waves = np.sin(xs * 0.03 + ys * 0.02 + t * 0.4 + s_)
            img = (0.5 + 0.35 * waves[..., None] * tint) + rng.normal(0, 0.03, (h, w, 3))
            height = 0.6 * h
            people = [openpose_person(w / 2 + 8 * np.sin(t + s_), 0.2 * h, height,
                                      t * 0.7 + s_, rng, POSE_HANDS.get((s_, t), (True, True)))]
            if (s_, t) == POSE_SECOND_DANCER:
                people.append(openpose_person(0.12 * w, 0.5 * h, 0.3 * h, t, rng))
            for kind, ext in (("images", "png"), ("poses-openpose", "json")):
                (raw / kind / f"seq{s_:04d}").mkdir(parents=True, exist_ok=True)
            write_png(raw / "images" / f"seq{s_:04d}" / f"{t:05d}.png",
                      np.clip(img * 255, 0, 255).astype(np.uint8))
            (raw / "poses-openpose" / f"seq{s_:04d}" / f"{t:05d}.json").write_text(
                json.dumps({"people": people}))
    if not packed:
        return str(raw)
    return build_packed_dataset(str(raw), str(Path(root) / "packed"),
                                ["images", "poses-openpose"])


def resample_path_rows(rs, img, path, gen):
    """resample2d and its backward (dflow, as the training paths run it)
    at a path's warp shape ``img``, fp32 and bf16, against their plain
    versions (the forward within ``TOL_RESAMPLE_*``, dflow bit for bit);
    each timed (fp32; the backward in the paths' bf16) beside its plain
    version, its bound and the library call. Returns ({kernel: row},
    {kernel: [errors]})."""
    x32 = torch.randn(img, generator=gen, device="cuda") * 2 + 0.5
    g32 = torch.randn(img, generator=gen, device="cuda")
    flow = mixed_flow(img, gen)
    rows, errs = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        x, f, g = x32.to(dtype), flow.to(dtype), g32.to(dtype)
        with torch.no_grad():
            got = rs.resample2d(x, f)
        want = rs.resample2d_plain(x, f)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.bfloat16:
            err /= want.float().abs().max().item()
        if err > (TOL_RESAMPLE_FP32 if dtype == torch.float32 else TOL_RESAMPLE_BF16_REL):
            raise AssertionError(f"resample2d {img} {dtype}: error {err}")
        errs.setdefault("resample2d", []).append(err)
        _, dflow = rs.resample2d_bwd(x, f, g, False)
        bitwise, _, ok = resample_bwd_errors(rs, x, f, g, None, dflow)
        if not ok:
            raise AssertionError(f"resample2d_bwd {img} {dtype}: dflow not bit for bit")
        errs.setdefault("resample2d_bwd", []).append(0.0)
        phase("kernel_check", name="resample2d", shape=list(img), path=path,
              dtype=str(dtype).split(".")[-1], error=err, dflow_bitwise=bitwise)
    bound, bound_by = resample_bound_ms(img, 4)
    rows["resample2d"] = dict(time_resample(rs, x32, flow), shape=list(img), calls=1,
                              plain_ms=time_ms(lambda: rs.resample2d_plain(x32, flow)),
                              bound_ms=bound, bound_by=bound_by)
    x, f, g = x32.bfloat16(), flow.bfloat16(), g32.bfloat16()
    bound, bound_by = resample_bwd_bound_ms(img, 2, False)
    rows["resample2d_bwd"] = {
        "shape": list(img), "calls": 1, "dtype": "bfloat16", "need_dx": False,
        "ms": time_ms(lambda: rs.resample2d_bwd(x, f, g, False)),
        "plain_ms": time_ms(lambda: rs.resample2d_bwd_plain(x, f, g, False), iters=5),
        "library_ms": time_ms(grid_sample_bwd(x, f, g, False)),
        "bound_ms": bound, "bound_by": bound_by}
    return rows, errs


def check_pose_kernels(rs, corr, cn):
    """Phase 3e: the four kernels of the dancing path at its 512x512
    shapes, against their plain versions, fp32 and bf16: resample2d and
    its backward (dflow, as the path runs it) on G's (2, 3, 512, 512)
    warp and the teacher's, correlation on the teacher's FlowNetC
    features (2, 256, 64, 64), channelnorm on its (2, 3 | 2, 512, 512)
    differences and flows; each timed (fp32; the backward in the path's
    bf16) beside its plain version, its bound and the library call where
    one computes it. Returns {kernel: row}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(97531)
    b, (h, w) = POSE_BATCH, POSE_CROP
    rows, errs = resample_path_rows(rs, (b, 3, h, w), "pose", gen)
    feat = (b, 256, h // 8, w // 8)
    x1 = torch.randn(feat, generator=gen, device="cuda")
    x2 = torch.randn(feat, generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        a, c = x1.to(dtype), x2.to(dtype)
        with torch.no_grad():
            got = corr.correlation(a, c, **FLOWNETC)
        errs.setdefault("correlation", []).append(check_against_plain(
            "correlation", got, corr.correlation_plain(a, c, **FLOWNETC), dtype,
            TOL_CORR_FP32, shape=list(feat), path="pose"))
    n_d = corr.num_displacements(FLOWNETC["max_displacement"], FLOWNETC["stride2"])
    bound, bound_by, route = correlation_bound_ms(feat, n_d * n_d, 4)
    rows["correlation"] = {
        "shape": list(feat), "calls": 1, "bound_route": route,
        "ms": time_ms(lambda: corr.correlation(x1, x2, **FLOWNETC)),
        "plain_ms": time_ms(lambda: corr.correlation_plain(x1, x2, **FLOWNETC), iters=5,
                            warmup=1),
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    cn_row = {"shapes": [], "calls": [], "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "library_ms": 0.0}
    for shape, calls in (((b, 3, h, w), 4), ((b, 2, h, w), 2)):
        x = torch.randn(shape, generator=gen, device="cuda") * 10
        for dtype in (torch.float32, torch.bfloat16):
            with torch.no_grad():
                got = cn.channelnorm(x.to(dtype))
            errs.setdefault("channelnorm", []).append(check_against_plain(
                "channelnorm", got, cn.channelnorm_plain(x.to(dtype)), dtype, TOL_CN_FP32,
                shape=list(shape), path="pose"))
        cn_row["shapes"].append(list(shape))
        cn_row["calls"].append(calls)
        cn_row["ms"] += calls * time_ms(lambda: cn.channelnorm(x))
        cn_row["plain_ms"] += calls * time_ms(lambda: cn.channelnorm_plain(x))
        cn_row["library_ms"] += calls * time_ms(lambda: torch.linalg.vector_norm(
            x, 2, dim=1, keepdim=True))
        bound, cn_row["bound_by"] = channelnorm_bound_ms(shape, 4)
        cn_row["bound_ms"] += calls * bound
    rows["channelnorm"] = cn_row
    for name, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["max_abs_err"] = errs[name][0]  # fp32: max-abs; dflow bit for bit
        phase("kernel", name=name, path="pose", **row)
    torch.cuda.empty_cache()
    return rows


def pose_entry_config(root, data_root, test_root, overrides=None):
    """The dancing config with the C12 override, its splits pointed at the
    folder dataset (``ext: png`` for the frames) and a test split at the
    one-sequence dataset, short cadences and ``speed_benchmark``, then
    ``overrides``; written to ``root / pose.yaml``."""
    import yaml

    from imaginaire_tpu_torch.config import load_yaml, recursive_update

    cfg = load_yaml(POSE_CONFIG)
    for split in ("train", "val"):
        cfg["data"][split]["roots"] = [data_root]
    cfg["data"]["input_types"][0]["images"]["ext"] = "png"
    for section in (POSE_C12, POSE_OVERRIDES, overrides or {}):
        recursive_update(cfg, copy.deepcopy(section))
    data = cfg["data"]
    cfg["test_data"] = {
        key: copy.deepcopy(data[key]) for key in (
            "name", "type", "num_workers", "num_frames_G", "num_frames_D",
            "for_pose_dataset", "has_foreground", "input_types", "input_image",
            "input_labels", "keypoint_data_types")}
    cfg["test_data"]["test"] = dict(copy.deepcopy(data["val"]), roots=[test_root])
    path = Path(root) / "pose.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def pose_vid2vid_entry(rs, spade_mod, corr, cn, device="cuda", overrides=None, hw=POSE_HW):
    """Phase 17: vid2vid dancing through the port's entries: ``train.main``
    for 2 iterations (batch 2, 512x512 crops, sequence length 4, bf16,
    the face and hand Ds, the teacher in the G step) on a seeded folder
    pose dataset, the hands each G step's hand D weighs held to the
    seeded skeletons, the checkpoint verified, one fp32 warp-frame G step
    (with its region losses) through the kernels against their plain
    versions, and ``inference.main`` on the one-sequence test split.
    The six launch counters are reset just before and read just after
    each part."""
    import gc

    from imaginaire_tpu_torch import inference, train
    from imaginaire_tpu_torch.data import get_train_and_val_dataloader
    from imaginaire_tpu_torch.resilience.integrity import verify_files
    from imaginaire_tpu_torch.trainers.vid2vid import Trainer
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # training runs the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pose_entry_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        data_root = write_pose_dataset(tmp / "train", hw=hw, packed=False)
        test_root = write_pose_dataset(tmp / "test", sequences=1, frames=POSE_TEST_FRAMES,
                                       hw=hw, seed=ENTRY_SEED + 1, packed=False)
        data_s = time.perf_counter() - t0
        cfg_path = pose_entry_config(tmp, data_root, test_root, overrides)
        logdir = tmp / "log"
        saves, keys, regions = [], [], []
        save, gen_update, region = (Trainer.save_checkpoint, Trainer.gen_update,
                                    Trainer._region_d_losses)

        def timed_save(self, *a, **k):
            t = time.perf_counter()
            path = save(self, *a, **k)
            saves.append(time.perf_counter() - t)
            return path

        def keyed_update(self, data, *a, **k):
            keys.append(list(data["key"]))
            return gen_update(self, data, *a, **k)

        def kept_regions(self, d_out, losses, dis_update):
            out = region(self, d_out, losses, dis_update)
            if not dis_update:
                regions.append({"valid": d_out["hand"]["valid"].detach(),
                                **{k: out[k].detach() for k in ("GAN_face", "GAN_hand")}})
            return out

        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_all_launches(rs, corr, cn, spade_mod)
        Trainer.save_checkpoint, Trainer.gen_update = timed_save, keyed_update
        Trainer._region_d_losses = kept_regions
        try:
            t0 = time.perf_counter()
            trainer = train.main(["--config", str(cfg_path), "--logdir", str(logdir),
                                  "--seed", str(ENTRY_SEED), "--device", device,
                                  "--max_iter", str(POSE_ITERATIONS)])
            train_s = time.perf_counter() - t0
        finally:
            Trainer.save_checkpoint, Trainer.gen_update = save, gen_update
            Trainer._region_d_losses = region
        launches = all_launches(rs, corr, cn, spade_mod)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
        want = dict({k: POSE_ITERATIONS * n for k, n in V2V_ENTRY_LAUNCHES.items()},
                    spade_modulation=0, spade_modulation_bwd=0)
        batch = int(trainer.cfg.data.train.batch_size)
        if launches != want or trainer.compute_dtype != torch.bfloat16 \
                or trainer.sequence_length != POSE_SEQ or batch != POSE_BATCH \
                or trainer.add_dis_names != ["face", "hand"]:
            raise AssertionError(f"pose training entry: launches {launches} (expected "
                                 f"{want}), compute dtype {trainer.compute_dtype}, sequence "
                                 f"length {trainer.sequence_length}, batch {batch}, region "
                                 f"Ds {trainer.add_dis_names}")
        scalars = [r for r in ScalarWriter(logdir).read() if r["kind"] == "counter"
                   and r["name"].split("/")[0] in ("gen_update", "dis_update")]
        names = {r["name"] for r in scalars}
        bad = [r for r in scalars if not np.isfinite(r["value"])
               or r["name"].endswith("nonfinite_count")]
        want_terms = {f"gen_update/{k}" for k in trainer.weights if k != "Flow"} | {
            "dis_update/GAN_face", "dis_update/GAN_hand", "dis_update/GAN"}
        if bad or not want_terms <= names:
            raise AssertionError(f"meters.jsonl: {sorted(names)}, non-finite {bad[:5]}, "
                                 f"expected {sorted(want_terms)}")
        # the hands each G step's hand D weighed, against the skeletons:
        # frame t of a window ending at <seq>/<last> is frame last - (T - 1 - t)
        got_valid = [r["valid"].float().cpu().tolist() for r in regions]
        want_valid = []
        for batch_keys in keys:
            for t in range(POSE_SEQ):
                frames = [(int(k.split("/")[0][3:]), int(k.split("/")[1]) - (POSE_SEQ - 1 - t))
                          for k in batch_keys]
                hands = [POSE_HANDS.get(f, (True, True)) for f in frames]
                want_valid.append([float(h[0]) for h in hands] + [float(h[1]) for h in hands])
        region_losses = {k: [float(r[k]) for r in regions] for k in ("GAN_face", "GAN_hand")}
        if got_valid != want_valid or not all(np.isfinite(v) for vs in region_losses.values()
                                              for v in vs):
            raise AssertionError(f"hand validity a G step {got_valid}, the skeletons hold "
                                 f"{want_valid}; region losses {region_losses}")
        checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
        integrity = ckpt_lib.read_integrity_sidecar(checkpoint)
        t0 = time.perf_counter()
        verify_files(checkpoint, integrity["files"], context=checkpoint)
        verify_s = time.perf_counter() - t0
        if ckpt_lib.parse_checkpoint_name(checkpoint)[1] != POSE_ITERATIONS \
                or integrity["n_leaves"] != len(trainer.state_tensors()):
            raise AssertionError(f"checkpoint {checkpoint}: {integrity['n_leaves']} records")
        timings = {k: [t * 1e3 for t in v] for k, v in trainer.timings.items()}
        params = (sum(p.numel() for p in trainer.net_G.parameters()),
                  sum(p.numel() for p in trainer.net_D.parameters()))

        # one fp32 warp-frame G step (TF32 off) through the kernels
        # against the same step through their plain versions
        loader, _ = get_train_and_val_dataloader(trainer.cfg, seed=ENTRY_SEED)
        loader.dataset.set_sequence_length(POSE_SEQ)
        data = trainer.start_of_iteration(next(iter(loader)), POSE_ITERATIONS)
        trainer.compute_dtype = torch.float32
        gen = torch.Generator(device=device).manual_seed(9)
        data_t = trainer._get_data_t(data, 2, data["label"][:, :2], torch.tanh(
            torch.randn(data["images"][:, :2].shape, generator=gen, device=device)))
        data_t["past_stacks"] = {}
        spade_mod.launches = spade_mod.bwd_launches = 0
        step = fp32_warp_g_step(trainer, data_t, rs, corr, cn, TOL_V2V_STEP_REL)
        step["launches"].update(spade_modulation=spade_mod.launches,
                                spade_modulation_bwd=spade_mod.bwd_launches)
        step_regions = {"GAN_face", "GAN_hand", "FeatureMatching_face",
                        "FeatureMatching_hand"}
        if not step_regions <= set(step["plain"]) or spade_mod.launches \
                or spade_mod.bwd_launches:
            raise AssertionError(f"fp32 warp-frame G step: losses {sorted(step['plain'])}, "
                                 f"modulation launches {step['launches']}")
        del data, data_t, trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # inference through the entry from a verified load of the checkpoint
        frames, save_frame = [], Trainer._save_test_frame

        def keep(self, output_dir, key, t, fake):
            frames.append((key, t, float(fake.float().min()), float(fake.float().max()),
                           bool(torch.isfinite(fake).all())))
            return save_frame(self, output_dir, key, t, fake)

        out = tmp / "frames"
        reset_all_launches(rs, corr, cn, spade_mod)
        Trainer._save_test_frame = keep
        try:
            t0 = time.perf_counter()
            inference.main(["--config", str(cfg_path), "--checkpoint", checkpoint,
                            "--output_dir", str(out), "--logdir", str(tmp / "inference"),
                            "--seed", str(ENTRY_SEED), "--device", device])
            inference_s = time.perf_counter() - t0
        finally:
            Trainer._save_test_frame = save_frame
        inference_launches = all_launches(rs, corr, cn, spade_mod)
        written = sorted(str(p.relative_to(out)) for p in out.rglob("*.png"))
        want_files = [f"seq0000/{t:04d}.png" for t in range(POSE_TEST_FRAMES)]
        want_inf = dict.fromkeys(inference_launches, 0)
        want_inf["resample2d"] = max(0, POSE_TEST_FRAMES - 2)
        if written != want_files or inference_launches != want_inf \
                or not all(ok and -1 <= lo and hi <= 1 for _, _, lo, hi, ok in frames):
            raise AssertionError(f"pose inference: {written}, frames {frames}, launches "
                                 f"{inference_launches} (expected {want_inf})")
    seq = POSE_SEQ
    kinds = ["first", "continuation"] + ["warp"] * (seq - 2)
    by_type = {s: {kind: [ms for i, ms in enumerate(timings[s]) if kinds[i % seq] == kind]
                   for kind in dict.fromkeys(kinds)} for s in ("dis_step", "gen_step")}
    warm = timings["iteration"][1:]
    hand_valid = [sum(v) for v in got_valid]
    row = {"config": str(POSE_CONFIG.relative_to(REPO)), "override": POSE_C12,
           "sequences": POSE_SEQUENCES, "frames": POSE_FRAMES, "hw": list(hw),
           "batch": POSE_BATCH, "sequence_length": seq, "compute_dtype": "bfloat16",
           "generator_params": params[0], "discriminator_params": params[1],
           "data_s": data_s, "train_s": train_s, "iterations": POSE_ITERATIONS,
           "iteration_ms": timings["iteration"], "first_iteration_ms": timings["iteration"][0],
           "warm_iteration_ms": float(np.median(warm)) if warm else None,
           "warm_frames_per_s": (POSE_BATCH * seq / (float(np.median(warm)) / 1e3)
                                 if warm else None),
           "step_ms_by_frame": {s: {kind: v for kind, v in d.items()}
                                for s, d in by_type.items()},
           "warp_frame_dis_step_ms": float(np.median(by_type["dis_step"]["warp"])),
           "warp_frame_gen_step_ms": float(np.median(by_type["gen_step"]["warp"])),
           "data_wait_ms": timings["data_wait"], "peak_mem_gib": peak,
           "launches": launches, "gan_face": region_losses["GAN_face"],
           "gan_hand": region_losses["GAN_hand"],
           "hands_valid_a_g_step": hand_valid, "hands_valid_seeded": [
               sum(v) for v in want_valid], "hands_valid_total": sum(hand_valid),
           "checkpoint_bytes": sum(f["size"] for f in integrity["files"].values()),
           "checkpoint_save_s": saves, "checkpoint_files_verify_s": verify_s,
           "inference_s": inference_s, "inference_frames": len(written),
           "inference_launches": inference_launches,
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": nvidia_smi() if cuda else "not measured"}
    row.update(fp32_step_kernels=step["kernels"], fp32_step_plain=step["plain"],
               fp32_worst_rel=step["worst_rel"], fp32_step_launches=step["launches"],
               fp32_step_teacher=step["teacher"])
    phase("pose_vid2vid_entry", **row)
    return row


def _segment_mask(ys, xs, a, b, radius):
    """Pixels of the grid (ys, xs) within ``radius`` of segment a-b
    ((x, y) points)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    d = b - a
    t = np.clip(((xs - a[0]) * d[0] + (ys - a[1]) * d[1]) / max(float(d @ d), 1e-6), 0, 1)
    return (xs - a[0] - t * d[0]) ** 2 + (ys - a[1] - t * d[1]) ** 2 <= radius ** 2


# DensePose part index of each BODY_25 limb (the torso 1 / 2 by side, the
# head 23 / 24: the face parts D's face box looks for), and its radius
# in units of the person's height
DENSEPOSE_LIMBS = [((1, 8), (1, 2), 0.09), ((2, 3), 16, 0.035), ((3, 4), 20, 0.03),
                   ((5, 6), 15, 0.035), ((6, 7), 19, 0.03), ((9, 10), 7, 0.045),
                   ((10, 11), 11, 0.04), ((12, 13), 8, 0.045), ((13, 14), 12, 0.04),
                   ((11, 22), 6, 0.03), ((14, 19), 5, 0.03), ((4, 4), 3, 0.03),
                   ((7, 7), 4, 0.03), ((0, 1), (23, 24), 0.06)]


def paint_densepose(iuv, inst, person, height, inst_id):
    """Paint one person's DensePose parts (index in channel 2, U and V in
    0 and 1) into ``iuv`` and its instance id into channel 0 of
    ``inst``, over a region wide enough to hold its OpenPose strokes."""
    h, w = iuv.shape[:2]
    xy = np.asarray(person["pose_keypoints_2d"], np.float32).reshape(-1, 3)[:, :2]
    hands = [np.asarray(person[k], np.float32).reshape(-1, 3)[:, :2]
             for k in ("hand_left_keypoints_2d", "hand_right_keypoints_2d")]
    pts = np.concatenate([xy] + [p for p in hands if p.any()])
    pad = 0.13 * height
    y0, y1 = int(max(pts[:, 1].min() - pad, 0)), int(min(pts[:, 1].max() + pad, h))
    x0, x1 = int(max(pts[:, 0].min() - pad, 0)), int(min(pts[:, 0].max() + pad, w))
    ys, xs = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    region = np.zeros(ys.shape, bool)
    for (i, j), _, radius in DENSEPOSE_LIMBS:
        region |= _segment_mask(ys, xs, xy[i], xy[j], (radius + 0.03) * height)
    for i in (4, 7):
        region |= _segment_mask(ys, xs, xy[i], xy[i], 0.12 * height)
    inst[y0:y1, x0:x1, 0][region] = inst_id
    part = np.zeros(ys.shape, np.uint8)
    for (i, j), parts, radius in DENSEPOSE_LIMBS:
        mask = _segment_mask(ys, xs, xy[i], xy[j], radius * height)
        if isinstance(parts, tuple):  # split by side of the body's axis
            part[mask] = np.where(xs[mask] < xy[1][0], parts[0], parts[1])
        else:
            part[mask] = parts
    body = part > 0
    view = iuv[y0:y1, x0:x1]
    view[..., 2][body] = part[body]
    view[..., 0][body] = ((ys[body] * 7) % 256).astype(np.uint8)
    view[..., 1][body] = ((xs[body] * 5) % 256).astype(np.uint8)


def write_youtube_dataset(root, sequences=YTD_SEQUENCES, frames=YTD_FRAMES, hw=YTD_RAW_HW,
                          seed=ENTRY_SEED):
    """A seeded folder dataset of the YouTubeDancing layout under ``root``:
    RGB frames (PNG), DensePose IUV maps (PNG: the part index 0-24 in
    channel 2), OpenPose JSON of two people and DensePose instance maps
    (PNG: the id in channel 0). A dancer walks across each sequence from
    a start that differs by sequence (its own crop box moves frame to
    frame), a smaller bystander with no hands in view stands to its left
    with its own instance id, skeleton and parts. Returns the root."""
    from imaginaire_tpu_torch.data.png import encode_png

    def write_png(path, image):  # zlib's fastest level: the files are written once
        path.write_bytes(encode_png(image, 1))

    rng = np.random.RandomState(seed)
    h, w = hw
    root = Path(root)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    sin_a, cos_a = np.sin(xs * 0.03 + ys * 0.02), np.cos(xs * 0.03 + ys * 0.02)
    for s_ in range(sequences):
        tint = rng.uniform(0.3, 1.0, 3)
        seq = f"seq{s_:04d}"
        for kind in ("images", "pose_maps-densepose", "poses-openpose", "human_instance_maps"):
            (root / kind / seq).mkdir(parents=True, exist_ok=True)
        for t in range(frames):
            phase_ = t * 0.4 + s_  # a wave pattern moving frame to frame
            wave = sin_a * np.cos(phase_) + cos_a * np.sin(phase_)
            img = 0.5 + 0.35 * wave[..., None] * tint
            height, top = 0.7 * h, 0.12 * h
            dancer = openpose_person((0.38 + 0.04 * (s_ % 4)) * w + YTD_WALK * t, top, height,
                                     t * 0.7 + s_, rng)
            bystander = openpose_person(0.1 * w, 0.5 * h, 0.35 * h, t + s_, rng,
                                        hands=(False, False))
            iuv = np.zeros((h, w, 3), np.uint8)
            inst = np.zeros((h, w, 3), np.uint8)
            paint_densepose(iuv, inst, bystander, 0.35 * h, YTD_BYSTANDER_ID)
            paint_densepose(iuv, inst, dancer, height, YTD_DANCER_ID)
            name = f"{t:05d}"
            write_png(root / "images" / seq / f"{name}.png",
                      np.clip(img * 255, 0, 255).astype(np.uint8))
            write_png(root / "pose_maps-densepose" / seq / f"{name}.png", iuv)
            write_png(root / "human_instance_maps" / seq / f"{name}.png", inst)
            (root / "poses-openpose" / seq / f"{name}.json").write_text(
                json.dumps({"people": [dancer, bystander]}))
    return str(root)


def youtube_entry_config(root, data_root, overrides=None, name="youtube.yaml"):
    """The YouTubeDancing config with the forced overrides (its splits and
    a test split at the folder dataset, images ``ext: png``, the weights'
    ``allow_random_init``, the finetune's iterations), the harness's
    cadences, then ``overrides``; written to ``root / name``."""
    import yaml

    from imaginaire_tpu_torch.config import load_yaml, recursive_update

    cfg = load_yaml(YTD_CONFIG)
    for split in ("train", "val"):
        cfg["data"][split]["roots"] = [data_root]
    cfg["data"]["input_types"][0]["images"]["ext"] = "png"
    for section in (YTD_FORCED, YTD_CADENCES, overrides or {}):
        recursive_update(cfg, copy.deepcopy(section))
    cfg["test_data"] = dict(copy.deepcopy(cfg["data"]), test=copy.deepcopy(cfg["data"]["val"]))
    path = Path(root) / name
    path.write_text(yaml.safe_dump(cfg))
    return path


def pose_fs_vid2vid_entry(rs, spade_mod, corr, cn, device="cuda", overrides=None,
                          raw_hw=YTD_RAW_HW):
    """Phase 18: fs-vid2vid YouTubeDancing through the port's entries:
    ``train.main`` for 2 iterations (batch 6, 512x256, sequence length 4,
    bf16, DensePose + OpenPose labels, the few-shot face D) on the seeded
    folder dataset, the losses finite, the weight generator and the flow
    network moved, the checkpoint verified; one fp32 warp-frame G step
    through the kernels against their plain versions
    (``fp32_warp_g_step``); ``inference.main`` with the config's finetune
    (``YTD_FINETUNE_ITER`` iterations): only the finetune prefixes'
    parameters move, every frame of the driving sequence is cropped with
    one box, and the PNGs are G's clipped frames; resample2d and dflow at
    the path's (6, 3, 512, 256) warp; the hyper route on the unit pose
    config. The six launch counters are reset just before and read just
    after each part."""
    import gc
    import threading

    from imaginaire_tpu_torch import inference, train
    from imaginaire_tpu_torch.data.base import BaseDataset
    from imaginaire_tpu_torch.data.png import decode_png
    from imaginaire_tpu_torch.model_utils import fs_vid2vid
    from imaginaire_tpu_torch.resilience.integrity import verify_files
    from imaginaire_tpu_torch.trainers.fs_vid2vid import Trainer
    from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
    from imaginaire_tpu_torch.utils.meters import ScalarWriter
    from imaginaire_tpu_torch.utils.visualization import tensor2im

    cuda = device == "cuda"
    torch.backends.cudnn.allow_tf32 = True  # training runs the defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="pose_fs_entry_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        root = write_youtube_dataset(tmp / "data", hw=raw_hw)
        data_s = time.perf_counter() - t0
        cfg_path = youtube_entry_config(tmp, root, overrides)
        logdir = tmp / "log"

        # the person crop's host seconds a call, the driving sequences'
        # boxes (a thread marks the window it processes), the finetune
        saves, before, crop_s, boxes, tuned, last, setup = [], {}, [], [], {}, {}, {}
        local = threading.local()
        save, init_state, finetune = Trainer.save_checkpoint, Trainer.init_state, Trainer.finetune
        gen_update = Trainer.gen_update
        process, crop = BaseDataset.process_item, fs_vid2vid.crop_person_from_data

        def timed_save(self, *a, **k):
            t = time.perf_counter()
            path = save(self, *a, **k)
            saves.append(time.perf_counter() - t)
            return path

        watched = ("weight_generator.fc_spade_e_0_fc0.weight",
                   "weight_generator.fc_spade_e_3_out.weight",
                   "flow_network_ref.conv_flow.conv.weight",
                   "flow_network_ref.down_in.conv.weight")

        def init_and_watch(self, *a, **k):
            setup.setdefault("train_until_init_state_s", time.perf_counter() - t0)
            out = init_state(self, *a, **k)
            before.update({n: self.net_G.get_parameter(n).detach().clone() for n in watched})
            return out

        def kept_update(self, data, *a, **k):
            last["data"] = data  # the fp32 step's batch: the last one trained on
            return gen_update(self, data, *a, **k)

        def marked_process(self, data, rng, thread_common_attr=True):
            local.seq = (self.inference_sequence_idx
                         if thread_common_attr and self.threads_common_attr else None)
            return process(self, data, rng, thread_common_attr)

        def timed_crop(cfg, is_inference, data, rng=None):
            t = time.perf_counter()
            out = crop(cfg, is_inference, data, rng=rng)
            crop_s.append(time.perf_counter() - t)
            if getattr(local, "seq", None) is not None:
                boxes.append((local.seq, tuple(out["common_attr"]["crop_coords"])))
            return out

        timed_crop.uses_common_attr = True

        def watched_finetune(self, data, inference_args=None):
            setup["inference_until_finetune_s"] = time.perf_counter() - t0
            params = {n: p.detach().clone() for n, p in self.net_G.named_parameters()}
            t = time.perf_counter()
            out = finetune(self, data, inference_args)
            tuned["s"] = time.perf_counter() - t
            mask = self.finetune_mask()
            tuned["moved"] = {n for n, p in self.net_G.named_parameters()
                              if not torch.equal(p.detach(), params[n])}
            tuned["trainable"] = {n for n, m in mask.items() if m}
            tuned["counts"] = (self.opt_G.count, self.opt_D.count)
            return out

        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_all_launches(rs, corr, cn, spade_mod)
        Trainer.save_checkpoint, Trainer.init_state = timed_save, init_and_watch
        Trainer.gen_update = kept_update
        BaseDataset.process_item, fs_vid2vid.crop_person_from_data = marked_process, timed_crop
        try:
            t0 = time.perf_counter()
            trainer = train.main(["--config", str(cfg_path), "--logdir", str(logdir),
                                  "--seed", str(ENTRY_SEED), "--device", device,
                                  "--max_iter", str(YTD_ITERATIONS)])
            train_s = time.perf_counter() - t0
        finally:
            Trainer.save_checkpoint, Trainer.init_state = save, init_state
            Trainer.gen_update = gen_update
            BaseDataset.process_item, fs_vid2vid.crop_person_from_data = process, crop
        launches = all_launches(rs, corr, cn, spade_mod)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else "not measured"
        batch = int(trainer.cfg.data.train.batch_size)
        train_crop_s = list(crop_s)
        if launches != YTD_ENTRY_LAUNCHES or trainer.compute_dtype != torch.bfloat16 \
                or trainer.sequence_length != YTD_SEQ or batch != YTD_BATCH \
                or trainer.add_dis_names != ["face"] or trainer.net_G.num_input_channels != 6 \
                or trainer.net_G.frame_hw != YTD_HW:
            raise AssertionError(f"YouTubeDancing training entry: launches {launches} (expected "
                                 f"{YTD_ENTRY_LAUNCHES}), compute dtype "
                                 f"{trainer.compute_dtype}, sequence length "
                                 f"{trainer.sequence_length}, batch {batch}, region Ds "
                                 f"{trainer.add_dis_names}, G label channels "
                                 f"{trainer.net_G.num_input_channels}, frame "
                                 f"{trainer.net_G.frame_hw}")
        scalars = [r for r in ScalarWriter(logdir).read() if r["kind"] == "counter"
                   and r["name"].split("/")[0] in ("gen_update", "dis_update")]
        names = {r["name"] for r in scalars}
        bad = [r for r in scalars if not np.isfinite(r["value"])
               or r["name"].endswith("nonfinite_count")]
        want_terms = {f"gen_update/{k}" for k in ("GAN", "FeatureMatching", "GAN_face",
                                                  "FeatureMatching_face", "Perceptual", "Flow")}
        want_terms |= {"dis_update/GAN", "dis_update/GAN_face"}
        if bad or not want_terms <= names:
            raise AssertionError(f"meters.jsonl: {sorted(names)}, non-finite {bad[:5]}, "
                                 f"expected {sorted(want_terms)}")
        gan_face = {r["name"]: r["value"] for r in scalars if r["name"].endswith("GAN_face")}
        moved = {n: (trainer.net_G.get_parameter(n).detach() - before[n]).abs().max().item()
                 for n in watched}
        if not all(v > 0 for v in moved.values()):
            raise AssertionError(f"parameters that did not move: {moved}")
        checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
        integrity = ckpt_lib.read_integrity_sidecar(checkpoint)
        t0 = time.perf_counter()
        verify_files(checkpoint, integrity["files"], context=checkpoint)
        verify_s = time.perf_counter() - t0
        if ckpt_lib.parse_checkpoint_name(checkpoint)[1] != YTD_ITERATIONS \
                or integrity["n_leaves"] != len(trainer.state_tensors()):
            raise AssertionError(f"checkpoint {checkpoint}: {integrity['n_leaves']} records")
        timings = {k: [t * 1e3 for t in v] for k, v in trainer.timings.items()}
        params = (sum(p.numel() for p in trainer.net_G.parameters()),
                  sum(p.numel() for p in trainer.net_D.parameters()))

        # one fp32 warp-frame G step (TF32 off) on the last batch trained on,
        # through the kernels against the same step through their plain
        # versions
        data = {k: v.float() if torch.is_tensor(v) and v.is_floating_point() else v
                for k, v in last.pop("data").items()}
        trainer.compute_dtype = torch.float32
        gen = torch.Generator(device=device).manual_seed(9)
        data_t = trainer._get_data_t(data, 2, data["label"][:, 1:2], torch.tanh(
            torch.randn(data["images"][:, 1:2].shape, generator=gen, device=device)))
        data_t["past_stacks"] = {}
        spade_mod.launches = spade_mod.bwd_launches = 0
        step = fp32_warp_g_step(trainer, data_t, rs, corr, cn, TOL_FS_STEP_REL, warps=2,
                                flow_losses=("Flow", "Flow_L1"))
        step["launches"].update(spade_modulation=spade_mod.launches,
                                spade_modulation_bwd=spade_mod.bwd_launches)
        if not {"GAN_face", "FeatureMatching_face"} <= set(step["plain"]) \
                or spade_mod.launches or spade_mod.bwd_launches:
            raise AssertionError(f"fp32 warp-frame G step: losses {sorted(step['plain'])}, "
                                 f"launches {step['launches']}")
        del data, data_t, trainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # inference through the entry from the checkpoint, with the finetune
        kept, save_frame = {}, Trainer._save_test_frame

        def keep(self, output_dir, key, t, fake):
            kept[(key, t)] = tensor2im(fake[0].float().clamp(-1, 1).permute(1, 2, 0)
                                       .cpu().numpy())
            return save_frame(self, output_dir, key, t, fake)

        out = tmp / "frames"
        boxes.clear()
        reset_all_launches(rs, corr, cn, spade_mod)
        Trainer._save_test_frame, Trainer.finetune = keep, watched_finetune
        BaseDataset.process_item, fs_vid2vid.crop_person_from_data = marked_process, timed_crop
        try:
            t0 = time.perf_counter()
            itrainer = inference.main(["--config", str(cfg_path), "--checkpoint", checkpoint,
                                       "--output_dir", str(out),
                                       "--logdir", str(tmp / "inference"),
                                       "--seed", str(ENTRY_SEED), "--device", device])
            inference_s = time.perf_counter() - t0
        finally:
            Trainer._save_test_frame, Trainer.finetune = save_frame, finetune
            BaseDataset.process_item, fs_vid2vid.crop_person_from_data = process, crop
        inference_launches = all_launches(rs, corr, cn, spade_mod)
        driving = int(itrainer.cfg.inference_args.driving_seq_index)
        written = sorted(str(p.relative_to(out)) for p in out.rglob("*.png"))
        want_files = [f"seq{driving:04d}/{t:04d}.png" for t in range(YTD_FRAMES)]
        png_equal = written == want_files and all(
            np.array_equal(decode_png((out / key / f"{t:04d}.png").read_bytes()), img)
            for (key, t), img in kept.items())
        driving_boxes = [b for seq, b in boxes if seq == driving]
        if written != want_files or not png_equal or len(kept) != YTD_FRAMES \
                or inference_launches != YTD_INFERENCE_LAUNCHES \
                or len(driving_boxes) != YTD_FRAMES or len(set(driving_boxes)) != 1 \
                or tuned.get("counts") != (YTD_FINETUNE_ITER,) * 2 \
                or not tuned["moved"] or not tuned["moved"] <= tuned["trainable"]:
            raise AssertionError(
                f"YouTubeDancing inference: written {written}, PNGs equal G's clipped frames "
                f"{png_equal}, launches {inference_launches} (expected "
                f"{YTD_INFERENCE_LAUNCHES}), driving boxes {driving_boxes}, finetune steps "
                f"{tuned.get('counts')}, moved outside the prefixes "
                f"{sorted(tuned.get('moved', set()) - tuned.get('trainable', set()))[:5]}")
        del itrainer
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # the kernels at the path's warp, and the hyper route
        kernel_rows = {}
        if cuda:
            torch.backends.cudnn.allow_tf32 = False
            rows, errs = resample_path_rows(rs, (YTD_BATCH, 3) + YTD_HW, "youtube",
                                            torch.Generator(device="cuda").manual_seed(97532))
            torch.backends.cudnn.allow_tf32 = True
            for name, row in rows.items():
                row["bound_share"] = row["bound_ms"] / row["ms"]
                row["max_abs_err"] = errs[name][0]
                phase("kernel", name=name, path="youtube", **row)
            kernel_rows = rows
        hyper = pose_hyper_route(rs, spade_mod, corr, cn, device)
    seq = YTD_SEQ
    kinds = ["first"] + ["warp"] * (seq - 1)
    by_type = {s_: {kind: [ms for i, ms in enumerate(timings[s_]) if kinds[i % seq] == kind]
                    for kind in ("first", "warp")} for s_ in ("dis_step", "gen_step")}
    warm = timings["iteration"][1:]
    row = {"config": str(YTD_CONFIG.relative_to(REPO)), "sequences": YTD_SEQUENCES,
           "frames": YTD_FRAMES, "raw_hw": list(raw_hw), "batch": YTD_BATCH,
           "sequence_length": seq, "compute_dtype": "bfloat16",
           "generator_params": params[0], "discriminator_params": params[1],
           "data_s": data_s, "train_s": train_s, "iterations": YTD_ITERATIONS,
           "iteration_ms": timings["iteration"], "first_iteration_ms": timings["iteration"][0],
           "warm_iteration_ms": float(np.median(warm)) if warm else None,
           "warm_frames_per_s": (YTD_BATCH * seq / (float(np.median(warm)) / 1e3)
                                 if warm else None),
           "step_ms_by_frame": by_type,
           "warp_frame_dis_step_ms": float(np.median(by_type["dis_step"]["warp"])),
           "warp_frame_gen_step_ms": float(np.median(by_type["gen_step"]["warp"])),
           "person_crop_ms_a_call": 1e3 * float(np.mean(train_crop_s)),
           "person_crop_ms_an_item": 2e3 * float(np.mean(train_crop_s)),
           "person_crop_calls": len(train_crop_s),
           "data_wait_ms": timings["data_wait"], "peak_mem_gib": peak,
           "launches": launches, "gan_face": gan_face, "moved": moved,
           "checkpoint_bytes": sum(f["size"] for f in integrity["files"].values()),
           "checkpoint_save_s": saves, "checkpoint_files_verify_s": verify_s,
           **setup, "finetune_s": tuned["s"], "finetune_moved": len(tuned["moved"]),
           "finetune_trainable": len(tuned["trainable"]),
           "inference_s": inference_s, "inference_frames": len(written),
           "inference_launches": inference_launches, "driving_box": list(driving_boxes[0]),
           "kernels": kernel_rows, "hyper": hyper,
           "phase_s": time.perf_counter() - t_phase,
           "nvidia_smi": nvidia_smi() if cuda else "not measured"}
    row.update(fp32_step_kernels=step["kernels"], fp32_step_plain=step["plain"],
               fp32_worst_rel=step["worst_rel"], fp32_step_launches=step["launches"],
               fp32_step_teacher=step["teacher"])
    phase("pose_fs_vid2vid_entry", **row)
    return row


def restore_fused(net, values):
    """Put back the modulation routes ``set_fused`` replaced."""
    for m, value in values.items():
        m.fused_modulation = value


def fused_values(net):
    from imaginaire_tpu_torch.layers.activation_norm import (
        HyperSpatiallyAdaptiveNorm,
        SpatiallyAdaptiveNorm,
    )

    return {m: m.fused_modulation for m in net.modules()
            if isinstance(m, (SpatiallyAdaptiveNorm, HyperSpatiallyAdaptiveNorm))}


def pose_hyper_route(rs, spade_mod, corr, cn, device="cuda"):
    """Phase 18, part 2: the ``hyper_spatially_adaptive`` route of the
    fs generator on pose labels (``configs/unit_test/fs_vid2vid_pose.yaml``,
    27 one-hot OpenPose channels, 64x64, its region and temporal Ds),
    which runs the modulation kernel: one fp32 G step on a warp frame and
    one fp32 forward (TF32 off), each through the kernels against the
    same through their plain versions (``TOL_FS_STEP_REL``,
    ``TOL_FS_FRAME``), the modulation's and resample2d's launches counted
    and held to ``YTD_HYPER_LAUNCHES``."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.trainers.fs_vid2vid import Trainer

    trainer = Trainer(Config(str(YTD_HYPER_CONFIG)), device=device, train=True)
    trainer.init_state(seed=ENTRY_SEED)
    trainer.compute_dtype = torch.float32
    gen = torch.Generator(device=device).manual_seed(11)
    hw, c = YTD_HYPER_HW, YTD_HYPER_LABELS

    def label(*lead):
        return (torch.rand(lead + (c,) + hw, generator=gen, device=device) > 0.9).float()

    def image(*lead):
        return torch.tanh(torch.randn(lead + (3,) + hw, generator=gen, device=device))

    data_t = {"label": label(1), "image": image(1), "ref_labels": label(1, 1),
              "ref_images": image(1, 1), "prev_labels": label(1, 1), "prev_images": image(1, 1),
              "past_stacks": {}}
    fused = fused_values(trainer.net_G)
    torch.backends.cudnn.allow_tf32 = False
    try:
        snap = _snapshot(trainer)

        def g_step():
            out = trainer._step(trainer.net_G, trainer.opt_G,
                                lambda: trainer.gen_forward(data_t)[0], None, "gen_step")
            return {k: float(v) for k, v in out.items()}

        reset_all_launches(rs, corr, cn, spade_mod)
        kernel_step = g_step()
        step_launches = all_launches(rs, corr, cn, spade_mod)
        _restore(trainer, snap)
        set_fused(trainer.net_G, "none")
        with plain_kernels():
            reset_all_launches(rs, corr, cn, spade_mod)
            plain_step = g_step()
            plain_launches = sum(all_launches(rs, corr, cn, spade_mod).values())
        restore_fused(trainer.net_G, fused)
        with torch.inference_mode():
            frame = {k: v for k, v in data_t.items() if k not in ("image", "past_stacks")}
            reset_all_launches(rs, corr, cn, spade_mod)
            kernel = trainer._apply_G(trainer.inference_params(), frame)["fake_images"]
            frame_launches = all_launches(rs, corr, cn, spade_mod)
            set_fused(trainer.net_G, "none")
            with plain_kernels():
                plain = trainer._apply_G(trainer.inference_params(), frame)["fake_images"]
            frame_err = (kernel - plain).abs().max().item()
    finally:
        restore_fused(trainer.net_G, fused)
        torch.backends.cudnn.allow_tf32 = True
    rel = {k: abs(kernel_step[k] - plain_step[k]) / max(abs(plain_step[k]), 1e-30)
           for k in plain_step}
    worst = max(rel, key=rel.get)
    want = YTD_HYPER_LAUNCHES
    if step_launches != want["g_step"] or frame_launches != want["forward"] \
            or plain_launches or rel[worst] > TOL_FS_STEP_REL or frame_err > TOL_FS_FRAME \
            or not {"GAN_face", "GAN_hand"} <= set(plain_step):
        raise AssertionError(
            f"pose hyper route: G step launches {step_launches} / plain {plain_launches}, "
            f"forward launches {frame_launches} (expected {want}); {worst} differs by "
            f"{rel[worst]} (tol {TOL_FS_STEP_REL}), forward by {frame_err} (tol "
            f"{TOL_FS_FRAME}); losses {sorted(plain_step)}")
    del trainer, snap
    return {"config": str(YTD_HYPER_CONFIG.relative_to(REPO)), "g_step_launches": step_launches,
            "forward_launches": frame_launches, "fp32_step_kernels": kernel_step,
            "fp32_step_plain": plain_step, "fp32_worst_rel": [worst, rel[worst]],
            "fp32_forward_max_abs": frame_err}


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
    rs_kernels = ptxas_kernels(Path(f"{libs[rs.KERNEL]}.log").read_text())
    phase("build", seconds=build_s, libraries=[str(p) for p in libs.values()],
          ptxas={k: v for k, v in ptxas.items() if k != spade_mod.KERNEL},
          modulation_kernels=mod_kernels)
    for name, table in ((spade_mod.KERNEL, mod_kernels), (rs.KERNEL, rs_kernels)):
        spilled = [k for k in table if k["spill_bytes"] != 0]
        if not table or spilled:
            raise AssertionError(f"{name} kernels spill registers: {spilled}")

    seconds = {"build": build_s}

    def timed(fn, *a, **k):
        t = time.perf_counter()
        out = fn(*a, **k)
        seconds[fn.__name__] = time.perf_counter() - t
        return out

    rows, bwd_rows, max_err, bwd_err = timed(check_modulation, spade_mod)
    rs_rows, rs_err = timed(check_resample, rs)
    rs_bwd_rows, rs_bwd_err = timed(check_resample_bwd, rs)
    corr_rows, corr_err = timed(check_correlation, corr)
    cn_rows, cn_err = timed(check_channelnorm, cn)
    main = timed(main_path, spade_mod)
    v2v = timed(vid2vid_path, rs, spade_mod)
    rs_rows[0]["flows"]["vid2vid"] = v2v["resample2d_path_flow"]
    teacher = timed(teacher_path, corr, cn, rs)
    train = timed(spade_train_path, spade_mod)
    entry = timed(spade_train_entry, spade_mod)
    with tempfile.TemporaryDirectory(prefix="vid2vid_entry_") as v2v_dir:
        v2v_train = timed(vid2vid_train_entry, rs, corr, cn, workdir=v2v_dir)
        v2v_eval = timed(vid2vid_eval_entry, rs, corr, cn, v2v_dir)
    evaluation = timed(spade_eval_entry, spade_mod)
    fs = timed(fs_vid2vid_entry, rs, spade_mod, corr, cn)
    fs_train, fs_hyper = fs["launches"], fs["hyper"]
    wc = timed(wc_vid2vid_entry, rs, spade_mod, corr, cn)
    p2p = timed(pix2pixHD_entry, rs, spade_mod, corr, cn)
    unpaired = timed(unpaired_entry, rs, spade_mod, corr, cn)
    funit = timed(funit_entry, rs, spade_mod, corr, cn)
    pose_shapes = timed(check_pose_kernels, rs, corr, cn)
    pose = timed(pose_vid2vid_entry, rs, spade_mod, corr, cn)
    ytd = timed(pose_fs_vid2vid_entry, rs, spade_mod, corr, cn)
    phase("phase_seconds", **seconds, total=time.perf_counter() - t0)

    def p2p_launches(name):
        """pix2pixHD (phase 14): plain instance norms, no kernel."""
        return {"train": p2p["launches"][name], "inference": p2p["inference_launches"][name],
                "encoder_path": p2p["encoder_path"]["launches"][name]}

    def unpaired_launches(name):
        """UNIT and MUNIT (phase 15): instance norms and AdaIN, no kernel."""
        out = {f"{family}_{part}": unpaired[family][key][name]
               for family in UNPAIRED_CONFIGS
               for part, key in (("train", "launches"), ("inference", "inference_launches"))}
        out["fp32_forward"] = unpaired["fp32_forward"]["launches"][name]
        return out

    def funit_launches(name):
        """FUNIT and COCO-FUNIT (phase 16): instance norms and AdaIN, no
        kernel."""
        out = {f"{family}_train": funit[family]["launches"][name]
               for family in FUNIT_CONFIGS}
        out.update({f"{family}_inference": funit[family]["inference_launches"][name]
                    for family in FUNIT_INFERS})
        out.update({f"{family}_fp32_forward": funit["fp32_forward"][family]["launches"][name]
                    for family in FUNIT_CONFIGS})
        return out

    def pose_launches(name):
        """vid2vid dancing (phase 17): 2 training iterations, the fp32
        warp-frame G step, one inference entry."""
        return {"train": pose["launches"][name],
                "fp32_g_step": pose["fp32_step_launches"][name],
                "inference": pose["inference_launches"][name]}

    def ytd_launches(name):
        """fs-vid2vid YouTubeDancing (phase 18): 2 training iterations, the
        fp32 warp-frame G step, the inference entry with its finetune, the
        hyper route's G step and forward on the unit pose config."""
        return {"train": ytd["launches"][name], "fp32_g_step": ytd["fp32_step_launches"][name],
                "inference": ytd["inference_launches"][name],
                "hyper_g_step": ytd["hyper"]["g_step_launches"][name],
                "hyper_forward": ytd["hyper"]["forward_launches"][name]}

    def ytd_shape(name):
        """The kernel at the YouTubeDancing path's (6, 3, 512, 256) warp."""
        return {key: ytd["kernels"][name][key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")}

    def pose_shape(name):
        """The kernel at the dancing path's 512x512 shapes (phase 3e)."""
        return {key: pose_shapes[name][key] for key in (
            "shape" if "shape" in pose_shapes[name] else "shapes", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "max_abs_err")}

    def per_call_set(table, dtype, path="spade"):
        sel = [r for r in table if r["dtype"].startswith(dtype) and r["path"] == path]
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
        # fs-vid2vid (phase 12): the hyper route's stream, its fp32 frame
        # and G step; the committed config's training (a BatchNorm base: 0)
        "fs_launches": {"hyper_stream": fs_hyper["stream_launches"]["spade_modulation"],
                        "hyper_fp32_frame": fs_hyper["frame_launches"],
                        "hyper_fp32_g_step": fs_hyper["fp32_step_launches"]["forward"],
                        "train": fs_train["spade_modulation"]},
        # wc-vid2vid (phase 13): BatchNorm bases everywhere
        "wc_launches": {"train": wc["launches"]["spade_modulation"]},
        "p2p_launches": p2p_launches("spade_modulation"),
        "unpaired_launches": unpaired_launches("spade_modulation"),
        "funit_launches": funit_launches("spade_modulation"),
        "pose_launches": pose_launches("spade_modulation"),
        "ytd_launches": ytd_launches("spade_modulation"),
        # the hyper route's 12 calls of a batch-1 forward at 512x512, fp32
        "fs_forward": per_call_set(rows, "float32", "fs"),
        # the 19 calls of one bs-4 generator forward, fp32, n_pairs 1
        **per_forward, "library_ms": None}, {
        "name": "spade_modulation_bwd", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/spade_modulation.cu",
        "replaces": "imaginaire_tpu/ops/spade_modulation.py:119",
        "launches": train["launches"]["backward"], "max_abs_err": bwd_err,
        "fs_launches": {"hyper_fp32_g_step": fs_hyper["fp32_step_launches"]["backward"],
                        "train": 0},
        "wc_launches": {"train": 0},
        "p2p_launches": p2p_launches("spade_modulation_bwd"),
        "unpaired_launches": unpaired_launches("spade_modulation_bwd"),
        "funit_launches": funit_launches("spade_modulation_bwd"),
        "pose_launches": pose_launches("spade_modulation_bwd"),
        "ytd_launches": ytd_launches("spade_modulation_bwd"),
        "fs_backward": per_call_set(bwd_rows, "bfloat16", "fs"),
        # the 19 calls of one G step's backward, bf16 (the training path's
        # type), n_pairs 1; max_abs_err is the fp32 checks' worst error
        # over the plain output's max magnitude
        **per_backward, "library_ms": None}, {
        "name": "resample2d", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/resample2d.cu",
        "replaces": "imaginaire_tpu/ops/pallas/resample2d_kernel.py:87",
        "launches": v2v["launches"], "max_abs_err": rs_err,
        # launches on the vid2vid inference, evaluation and flow-cache paths
        # (phase 11), counted beside the main path's
        "eval_entry_launches": v2v_eval["launches"]["resample2d"],
        # fs-vid2vid (phase 12): two 6-frame streams, the hyper stream, 4
        # training iterations, the fp32 G step, the inference entry
        "fs_launches": {"streams": sum(fs["streams"]["stream_launches"].values()),
                        "hyper_stream": fs_hyper["stream_launches"]["resample2d"],
                        "train": fs_train["resample2d"],
                        "fp32_g_step": fs["fp32_step_launches"]["resample2d"],
                        "inference": fs["inference_launches"]["resample2d"]},
        # wc-vid2vid (phase 13): 3 training iterations, the fp32 G step,
        # the partial-conv forward, one inference entry of 12 frames
        "wc_launches": {"train": wc["launches"]["resample2d"],
                        "fp32_g_step": wc["fp32_step_launches"]["resample2d"],
                        "partial_conv_forward": wc["partial_conv"]["launches"]["kernel"],
                        "inference": wc["inference_launches"]["resample2d"]},
        "p2p_launches": p2p_launches("resample2d"),
        "unpaired_launches": unpaired_launches("resample2d"),
        "funit_launches": funit_launches("resample2d"),
        "pose_launches": pose_launches("resample2d"),
        "ytd_launches": ytd_launches("resample2d"),
        "pose_shape": pose_shape("resample2d"),
        "ytd_shape": ytd_shape("resample2d"),
        # one warp of the previous (1, 3, 512, 1024) frame, fp32, mixed flow
        **{key: rs_rows[0][key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}, {
        "name": "resample2d_bwd", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/resample2d.cu",
        "replaces": "imaginaire_tpu/ops/resample2d.py:82",
        "launches": v2v_train["launches"]["resample2d_bwd"], "max_abs_err": rs_bwd_err,
        "fs_launches": {"train": fs_train["resample2d_bwd"],
                        "fp32_g_step": fs["fp32_step_launches"]["resample2d_bwd"]},
        "wc_launches": {"train": wc["launches"]["resample2d_bwd"],
                        "fp32_g_step": wc["fp32_step_launches"]["resample2d_bwd"]},
        "p2p_launches": p2p_launches("resample2d_bwd"),
        "unpaired_launches": unpaired_launches("resample2d_bwd"),
        "funit_launches": funit_launches("resample2d_bwd"),
        "pose_launches": pose_launches("resample2d_bwd"),
        "ytd_launches": ytd_launches("resample2d_bwd"),
        "pose_shape": pose_shape("resample2d_bwd"),
        "ytd_shape": ytd_shape("resample2d_bwd"),
        # the training warp's backward of (2, 3, 512, 1024) frames, bf16 (the
        # path's type), dflow alone (the path's), mixed flow; max_abs_err is
        # dflow's (0: bit for bit) and the fp32 dx checks' worst over the
        # magnitude of the terms summed
        **{key: next(r for r in rs_bwd_rows if r["flow"] == "mixed"
                     and r["dtype"] == "bfloat16" and not r["need_dx"])[key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}, {
        "name": "correlation", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/correlation.cu",
        "replaces": "imaginaire_tpu/ops/pallas/correlation_kernel.py:76",
        "launches": teacher["launches"]["correlation"], "max_abs_err": corr_err,
        "eval_entry_launches": v2v_eval["launches"]["correlation"],
        "wc_launches": {"train": wc["launches"]["correlation"],
                        "fp32_g_step": wc["fp32_step_launches"]["correlation"]},
        "p2p_launches": p2p_launches("correlation"),
        "unpaired_launches": unpaired_launches("correlation"),
        "funit_launches": funit_launches("correlation"),
        "pose_launches": pose_launches("correlation"),
        "ytd_launches": ytd_launches("correlation"),
        "pose_shape": pose_shape("correlation"),
        # the one call of a FlowNet2 forward of one frame pair, fp32
        **{key: corr_rows[0][key] for key in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}, {
        "name": "channelnorm", "route": "cuda",
        "source": "imaginaire_tpu_torch/csrc/channelnorm.cu",
        "replaces": "imaginaire_tpu/ops/pallas/channelnorm_kernel.py:32",
        "launches": teacher["launches"]["channelnorm"], "max_abs_err": cn_err,
        "eval_entry_launches": v2v_eval["launches"]["channelnorm"],
        "wc_launches": {"train": wc["launches"]["channelnorm"],
                        "fp32_g_step": wc["fp32_step_launches"]["channelnorm"]},
        "p2p_launches": p2p_launches("channelnorm"),
        "unpaired_launches": unpaired_launches("channelnorm"),
        "funit_launches": funit_launches("channelnorm"),
        "pose_launches": pose_launches("channelnorm"),
        "ytd_launches": ytd_launches("channelnorm"),
        "pose_shape": pose_shape("channelnorm"),
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
             "spade_train_entry": entry, "resample2d_bwd": rs_bwd_rows,
             "vid2vid_train_entry": v2v_train, "vid2vid_eval_entry": v2v_eval,
             "spade_eval_entry": evaluation, "fs_vid2vid_entry": fs,
             "wc_vid2vid_entry": wc, "pix2pixHD_entry": p2p, "unpaired_entry": unpaired,
             "funit_entry": funit, "pose_kernels": pose_shapes, "pose_vid2vid_entry": pose,
             "pose_fs_vid2vid_entry": ytd, "kernels": kernels}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
