"""spade_modulation: the fused SPADE norm -> modulate epilogue, forward
and backward.

    out = instance_norm(x) * (1 + sum_i gamma_i) + sum_i beta_i

Port of ``imaginaire_tpu/ops/spade_modulation.py`` with its training
route, ``implementation="fused"``: a differentiable op whose only
residuals are (x, gamma_i, mean, rstd). Tensors are NCHW.

- ``spade_modulation_plain``: plain PyTorch, the arithmetic of the JAX
  package's ``_apply`` (fp32 statistics with the centred biased variance
  of ``jnp.var``, ``eps`` inside the square root, normalize in fp32,
  cast to x's type, then combine in x's type). ``stats`` hands it given
  statistics instead of its own.
- ``spade_modulation_bwd_plain``: plain PyTorch, the arithmetic of
  ``_fused_bwd``: with g_hat = g (1 + sum gamma) in fp32,
  ``dx = rstd (g_hat - mean(g_hat) - x_hat mean(g_hat x_hat))`` and one
  ``dgamma = g x_hat`` for every gamma_i, each rounded once to its
  tensor's type; the gradient of every beta_i is g.
- ``spade_modulation``: the wrapper, a ``torch.autograd.Function``. A
  tensor on the CPU takes the plain versions; a CUDA tensor launches the
  hand-written kernels (``csrc/spade_modulation.cu``, forward and
  backward) or raises. ``launches`` and ``bwd_launches`` count the
  kernel launches.
- ``modulation_plan``: the kernels' launch for one call (path, vector
  width, vectors a thread holds, cluster size, threads, planes a block,
  grid), chosen by shape, type and alignment here so that the CPU tests
  reach it; the kernels check it and run it, and refuse a plan they
  cannot run (the wrapper then raises).

The statistics are computed in fp32 for fp32 and bf16 inputs, and in
fp64 for fp64 inputs (so that ``torch.autograd.gradcheck`` can check the
plain route).
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from imaginaire_tpu_torch.ops import build

KERNEL = "spade_modulation"
MAX_PAIRS = 4  # SPADE_MAX_PAIRS in csrc/spade_modulation.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernels' struct Plan, field by field (csrc/spade_modulation.cu)
PLAN_FIELDS = ("path", "vec", "per_thread", "cluster", "threads",
               "planes_per_block", "grid")
PATHS = {"warp": 0, "block": 1, "stream": 2}  # PATH_WARP, PATH_BLOCK, PATH_STREAM
# vectors a lane may hold on the warp path: up to 128 vectors a plane,
# 1024 bf16 or 512 fp32 elements (a 32x32 fp32 plane runs as a block)
WARP_PER_THREAD = (1, 2, 4)
WARP_MAX_VECTORS = 32 * WARP_PER_THREAD[-1]
WARP_BLOCK_THREADS = 128      # 4 planes a block on the warp path
BLOCK_PER_THREAD = 4          # SPADE_BLOCK_NV: vectors a thread on the block path
STREAM_THREADS = 512          # SPADE_STREAM_THREADS
MAX_GRID = 2 ** 31 - 1

launches = 0      # forward kernel launches since the last reset (set to 0)
bwd_launches = 0  # backward kernel launches since the last reset (set to 0)


def _stats_dtype(dtype):
    return torch.promote_types(dtype, torch.float32)


def spade_modulation_stats_plain(x, eps=1e-5):
    """(mean, rstd), each (B, C) in fp32 (fp64 for fp64 x): the biased
    spatial variance from a centred second pass, ``eps`` inside the
    square root."""
    x32 = x.to(_stats_dtype(x.dtype))
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(2, 3), keepdim=True)
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    return mean.flatten(1), rstd.flatten(1)


def spade_modulation_plain(x, gammas, betas, eps=1e-5, stats=None):
    """The epilogue in plain PyTorch (the reference the kernel is held
    to); ``stats`` = (mean, rstd), each (B, C), replaces its own."""
    mean, rstd = spade_modulation_stats_plain(x, eps) if stats is None else stats
    x32 = x.to(_stats_dtype(x.dtype))
    y = ((x32 - mean[..., None, None]) * rstd[..., None, None]).to(x.dtype)
    gamma_sum = functools.reduce(operator.add, gammas)
    beta_sum = functools.reduce(operator.add, betas)
    return y * (1.0 + gamma_sum) + beta_sum


def spade_modulation_bwd_plain(x, gammas, mean, rstd, g):
    """(dx, dgamma) of the epilogue for the output gradient g, given the
    forward's statistics (mean, rstd), each (B, C)."""
    ct = _stats_dtype(x.dtype)
    mean = mean.to(ct)[..., None, None]
    rstd = rstd.to(ct)[..., None, None]
    g32 = g.to(ct)
    xhat = (x.to(ct) - mean) * rstd
    gs = functools.reduce(lambda a, b: a + b.to(ct), gammas, 1.0)
    ghat = g32 * gs
    m1 = ghat.mean(dim=(2, 3), keepdim=True)
    m2 = (ghat * xhat).mean(dim=(2, 3), keepdim=True)
    dx = rstd * (ghat - m1 - xhat * m2)
    return dx.to(x.dtype), (g32 * xhat).to(gammas[0].dtype)


def _check_args(x, gammas, betas):
    if x.dim() != 4:
        raise ValueError(f"spade_modulation expects NCHW x, got {tuple(x.shape)}")
    if not gammas or len(gammas) != len(betas):
        raise ValueError(
            f"spade_modulation needs matched non-empty gamma/beta lists, "
            f"got {len(gammas)} gammas / {len(betas)} betas")
    for t in gammas + betas:
        if t.shape != x.shape:
            raise ValueError(
                f"spade_modulation gamma/beta must match x {tuple(x.shape)}, "
                f"got {tuple(t.shape)}")


class _SpadeModulation(torch.autograd.Function):
    """Saves (x, gamma_i, mean, rstd); the betas are not kept."""

    @staticmethod
    def forward(ctx, x, eps, n_pairs, *gammas_betas):
        gammas, betas = gammas_betas[:n_pairs], gammas_betas[n_pairs:]
        if x.device.type == "cpu":
            mean, rstd = spade_modulation_stats_plain(x, eps)
            out = spade_modulation_plain(x, gammas, betas, eps, (mean, rstd))
        else:
            out, mean, rstd = _launch_fwd(x, gammas, betas, eps)
        ctx.beta_dtypes = tuple(b.dtype for b in betas)
        ctx.save_for_backward(x, mean, rstd, *gammas)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, *gammas = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dgamma = spade_modulation_bwd_plain(x, gammas, mean, rstd, g)
        else:
            dx, dgamma = _launch_bwd(x, gammas, mean, rstd, g)
        dgammas = [dgamma if gm.dtype == dgamma.dtype else dgamma.to(gm.dtype)
                   for gm in gammas]
        dbetas = [g.to(dt) for dt in ctx.beta_dtypes]
        return (dx, None, None, *dgammas, *dbetas)


def spade_modulation(x, gammas, betas, eps=1e-5):
    """``instance_norm(x) * (1 + sum gammas) + sum betas``; x, every gamma
    and beta: (B, C, H, W) tensors of one shape. Differentiable in x and
    every gamma and beta."""
    gammas, betas = tuple(gammas), tuple(betas)
    _check_args(x, gammas, betas)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spade_modulation runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda":
        _check_kernel_args(x, gammas, betas)
    return _SpadeModulation.apply(x, float(eps), len(gammas), *gammas, *betas)


def _library():
    lib = build.load(KERNEL)
    ptr, ptrs, i64 = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_longlong
    ints = ctypes.POINTER(ctypes.c_int)
    lib.spade_modulation_fwd.argtypes = [
        ptr, ptrs, ptrs, ctypes.c_int, ptr, ptr, ptr, i64, i64, ctypes.c_float,
        ctypes.c_int, ints, ptr]
    lib.spade_modulation_fwd.restype = ctypes.c_int
    lib.spade_modulation_bwd.argtypes = [
        ptr, ptrs, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, i64, i64,
        ctypes.c_int, ints, ptr]
    lib.spade_modulation_bwd.restype = ctypes.c_int
    lib.spade_modulation_error_string.argtypes = [ctypes.c_int]
    lib.spade_modulation_error_string.restype = ctypes.c_char_p
    return lib


def max_threads(per_thread, arrays):
    """The most threads a block of a cached kernel may have when its
    registers hold ``arrays`` arrays of ``per_thread`` 16-byte vectors
    (``max_threads`` in csrc/spade_modulation.cu)."""
    return 1024 if 4 * per_thread * arrays <= 16 else 512


def block_clusters(dtype, backward):
    """The cluster sizes the block path may take, in order of preference
    (``cluster_ok`` in csrc/spade_modulation.cu): one block a plane, and
    for the fp32 backward, whose 128x128 plane one block's registers
    cannot hold, a cluster of 2. A cluster lost to one block wherever one
    block holds the plane (scripts/torch_kernel_probe.py, PERF.md)."""
    return (1, 2) if backward and dtype == torch.float32 else (1,)


def _ceil(a, b):
    return -(-a // b)


def _warps(n):
    return 32 * _ceil(n, 32)


def modulation_plan(n_planes, plane, dtype, n_pairs=1, aligned=True,
                    backward=False, cluster=None):
    """The kernels' launch for ``n_planes`` = B C planes of ``plane`` =
    H W elements of ``dtype`` (float32 or bfloat16) with ``n_pairs``
    (gamma, beta) pairs; ``aligned``: every pointer of the call 16-byte
    aligned. A dict of PLAN_FIELDS and ``route`` (the path's name):

    - stream, scalar (``vec`` 1): a ragged plane (H W not a multiple of
      the 16-byte vector) or a misaligned pointer; one block a plane;
    - warp: a plane of at most WARP_MAX_VECTORS vectors is one warp's,
      ``per_thread`` vectors a lane, WARP_BLOCK_THREADS // 32 planes a
      block;
    - block: one block (or a cluster of ``cluster`` blocks) a plane, each
      thread holding BLOCK_PER_THREAD vectors of it in registers, the
      first of ``block_clusters`` (or ``cluster``) whose threads fit the
      register bound;
    - stream (``vec`` 8 bf16, 4 fp32): a plane the block path cannot hold,
      re-read for each pass.

    Raises ValueError for a grid the card cannot launch, and for a
    ``cluster`` that cannot hold the plane."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the spade_modulation kernel takes float32 or "
                        f"bfloat16, got {dtype}")
    if not 1 <= n_pairs <= MAX_PAIRS:
        raise ValueError(f"the spade_modulation kernel takes 1 to {MAX_PAIRS} "
                         f"(gamma, beta) pairs, got {n_pairs}")
    native = 16 // dtype.itemsize
    vec = native if aligned and plane % native == 0 else 1
    if cluster is not None and vec == 1:
        raise ValueError(f"the block path needs 16-byte vectors: a plane of "
                         f"{plane} elements, aligned={aligned}")
    pv = plane // vec
    bound = max_threads(BLOCK_PER_THREAD, 3 if backward else 1)
    plan = None
    if vec > 1 and pv <= WARP_MAX_VECTORS and cluster is None:
        per_thread = next(n for n in WARP_PER_THREAD if 32 * n >= pv)
        threads = min(WARP_BLOCK_THREADS, _warps(32 * n_planes))
        plan = dict(route="warp", per_thread=per_thread, cluster=1,
                    threads=threads, planes_per_block=threads // 32,
                    grid=_ceil(n_planes, threads // 32))
    elif vec > 1:
        choices = block_clusters(dtype, backward)
        for cl in (cluster,) if cluster is not None else choices:
            threads = max(32, _warps(_ceil(pv, BLOCK_PER_THREAD * cl)))
            if cl in choices and threads <= bound:
                plan = dict(route="block", per_thread=BLOCK_PER_THREAD, cluster=cl,
                            threads=threads, planes_per_block=1,
                            grid=n_planes * cl)
                break
        else:
            if cluster is not None:
                raise ValueError(f"the block path cannot hold a plane of {plane} "
                                 f"{dtype} elements over a cluster of {cluster}")
    if plan is None:
        plan = dict(route="stream", per_thread=0, cluster=1,
                    threads=min(STREAM_THREADS, _warps(pv)), planes_per_block=1,
                    grid=n_planes)
    if plan["grid"] > MAX_GRID:
        raise ValueError(f"the spade_modulation kernel cannot launch "
                         f"{n_planes} planes: its grid would be {plan['grid']} "
                         f"blocks")
    return dict(plan, path=PATHS[plan["route"]], vec=vec)


def _check_kernel_args(x, gammas, betas):
    if len(gammas) > MAX_PAIRS:
        raise ValueError(f"the spade_modulation kernel takes at most "
                         f"{MAX_PAIRS} (gamma, beta) pairs, got {len(gammas)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the spade_modulation kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    for t in gammas + betas:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("spade_modulation tensors must share x's device "
                             f"and dtype ({x.device}, {x.dtype}); got "
                             f"{t.device}, {t.dtype}")
    for t in (x,) + gammas + betas:
        if not t.is_contiguous():
            raise ValueError("spade_modulation tensors must be contiguous NCHW")


def _raise_on(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"spade_modulation {what} kernel launch failed: CUDA error {err} "
            f"({lib.spade_modulation_error_string(err).decode()})")


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _plan_fields(plan):
    return (ctypes.c_int * len(PLAN_FIELDS))(*(plan[k] for k in PLAN_FIELDS))


@functools.lru_cache(maxsize=1024)
def _default_fields(n_planes, plane, dtype, n_pairs, aligned, backward):
    """The C fields of modulation_plan's plan, kept per call shape: a
    training step asks for the same 7 shapes 76 times."""
    return _plan_fields(modulation_plan(n_planes, plane, dtype, n_pairs, aligned,
                                        backward))


def _aligned(tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_fwd(x, gammas, betas, eps, plan=None):
    """(out, mean, rstd) from the forward kernel, under ``plan`` (default
    ``modulation_plan``'s)."""
    global launches
    b, c, h, w = x.shape
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out, mean, rstd
    fields = _plan_fields(plan) if plan is not None else _default_fields(
        b * c, h * w, x.dtype, len(gammas),
        _aligned((x, out) + tuple(gammas) + tuple(betas)), False)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spade_modulation_fwd(
            x.data_ptr(), _pointers(gammas), _pointers(betas), len(gammas),
            out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b * c, h * w,
            eps, _DTYPE_CODES[x.dtype], fields, stream)
    _raise_on(lib, err, "forward")
    launches += 1
    return out, mean, rstd


def _launch_bwd(x, gammas, mean, rstd, g, plan=None):
    """(dx, dgamma) from the backward kernel, under ``plan`` (default
    ``modulation_plan``'s)."""
    global bwd_launches
    g = g.to(x.dtype).contiguous()
    mean, rstd = (t.to(torch.float32).contiguous() for t in (mean, rstd))
    if mean.shape != x.shape[:2] or rstd.shape != x.shape[:2]:
        raise ValueError(f"spade_modulation backward needs (B, C) statistics "
                         f"for x {tuple(x.shape)}, got {tuple(mean.shape)}, "
                         f"{tuple(rstd.shape)}")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dgamma = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return dx, dgamma
    b, c, h, w = x.shape
    fields = _plan_fields(plan) if plan is not None else _default_fields(
        b * c, h * w, x.dtype, len(gammas),
        _aligned((x, g, dx, dgamma) + tuple(gammas)), True)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spade_modulation_bwd(
            x.data_ptr(), _pointers(gammas), len(gammas), mean.data_ptr(),
            rstd.data_ptr(), g.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
            b * c, h * w, _DTYPE_CODES[x.dtype], fields, stream)
    _raise_on(lib, err, "backward")
    bwd_launches += 1
    return dx, dgamma
