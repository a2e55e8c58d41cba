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
    lib.spade_modulation_fwd.argtypes = [
        ptr, ptrs, ptrs, ctypes.c_int, ptr, ptr, ptr, i64, i64, ctypes.c_float,
        ctypes.c_int, ptr]
    lib.spade_modulation_fwd.restype = ctypes.c_int
    lib.spade_modulation_bwd.argtypes = [
        ptr, ptrs, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, i64, i64,
        ctypes.c_int, ptr]
    lib.spade_modulation_bwd.restype = ctypes.c_int
    lib.spade_modulation_error_string.argtypes = [ctypes.c_int]
    lib.spade_modulation_error_string.restype = ctypes.c_char_p
    return lib


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


def _launch_fwd(x, gammas, betas, eps):
    """(out, mean, rstd) from the forward kernel."""
    global launches
    b, c, h, w = x.shape
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return out, mean, rstd
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spade_modulation_fwd(
            x.data_ptr(), _pointers(gammas), _pointers(betas), len(gammas),
            out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), b * c, h * w,
            eps, _DTYPE_CODES[x.dtype], stream)
    _raise_on(lib, err, "forward")
    launches += 1
    return out, mean, rstd


def _launch_bwd(x, gammas, mean, rstd, g):
    """(dx, dgamma) from the backward kernel."""
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
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spade_modulation_bwd(
            x.data_ptr(), _pointers(gammas), len(gammas), mean.data_ptr(),
            rstd.data_ptr(), g.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
            b * c, h * w, _DTYPE_CODES[x.dtype], stream)
    _raise_on(lib, err, "backward")
    bwd_launches += 1
    return dx, dgamma
