"""spade_modulation: the fused SPADE norm -> modulate epilogue, forward.

    out = instance_norm(x) * (1 + sum_i gamma_i) + sum_i beta_i

Port of ``imaginaire_tpu/ops/spade_modulation.py`` (forward only; the
training slice adds the backward as a kernel). Tensors are NCHW.

- ``spade_modulation_plain``: plain PyTorch, the arithmetic of the JAX
  package's main path (fp32 statistics with the centred biased variance
  of ``jnp.var``, ``eps`` inside the square root, normalize in fp32,
  cast to x's type, then combine in x's type).
- ``spade_modulation``: the wrapper. A tensor on the CPU takes the plain
  version; a CUDA tensor launches the hand-written kernel
  (``csrc/spade_modulation.cu``) or raises. ``launches`` counts the
  kernel launches.
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

launches = 0  # kernel launches since the last reset (set it to 0 to reset)


def spade_modulation_plain(x, gammas, betas, eps=1e-5):
    """The epilogue in plain PyTorch (the reference the kernel is held to)."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(2, 3), keepdim=True)
    y = ((x32 - mean) * torch.reciprocal(torch.sqrt(var + eps))).to(x.dtype)
    gamma_sum = functools.reduce(operator.add, gammas)
    beta_sum = functools.reduce(operator.add, betas)
    return y * (1.0 + gamma_sum) + beta_sum


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


def spade_modulation(x, gammas, betas, eps=1e-5):
    """``instance_norm(x) * (1 + sum gammas) + sum betas``; x, every gamma
    and beta: (B, C, H, W) tensors of one shape."""
    gammas, betas = tuple(gammas), tuple(betas)
    _check_args(x, gammas, betas)
    if x.device.type == "cpu":
        return spade_modulation_plain(x, gammas, betas, eps)
    if x.device.type != "cuda":
        raise ValueError(f"spade_modulation runs on cpu or cuda, not {x.device}")
    return _launch(x, gammas, betas, float(eps))


def _library():
    lib = build.load(KERNEL)
    lib.spade_modulation_fwd.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.spade_modulation_fwd.restype = ctypes.c_int
    lib.spade_modulation_error_string.argtypes = [ctypes.c_int]
    lib.spade_modulation_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, gammas, betas, eps):
    global launches
    tensors = (x,) + gammas + betas
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "spade_modulation has no CUDA backward yet: it comes with the "
            "SPADE training slice (ROADMAP.md, slice 2); run inference "
            "under torch.no_grad() or torch.inference_mode()")
    if len(gammas) > MAX_PAIRS:
        raise ValueError(f"the spade_modulation kernel takes at most "
                         f"{MAX_PAIRS} (gamma, beta) pairs, got {len(gammas)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the spade_modulation kernel takes float32 or "
                        f"bfloat16, got {x.dtype}")
    for t in tensors:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError("spade_modulation tensors must share x's device "
                             f"and dtype ({x.device}, {x.dtype}); got "
                             f"{t.device}, {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("spade_modulation tensors must be contiguous NCHW")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    b, c, h, w = x.shape
    lib = _library()
    n = len(gammas)
    gamma_ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in gammas))
    beta_ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in betas))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.spade_modulation_fwd(
            x.data_ptr(), gamma_ptrs, beta_ptrs, n, out.data_ptr(), b * c,
            h * w, eps, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"spade_modulation kernel launch failed: CUDA error {err} "
            f"({lib.spade_modulation_error_string(err).decode()})")
    launches += 1
    return out
