"""channelnorm: the per-pixel L-p norm over the channel axis, forward.

Port of ``imaginaire_tpu/ops/channelnorm.py``. NCHW: x (B, C, H, W) ->
(B, 1, H, W) with value ``(sum_c |x_c|^p)^(1/p)``, ``sqrt(sum_c x_c^2)``
at p = 2. FlowNet2 runs it on 2-3 channel flows and image differences;
it is a frozen teacher, so there is no backward.

- ``channelnorm_plain``: plain PyTorch. It computes in fp32 whatever the
  input type and casts the result to x's type, as the Pallas kernel does
  (``channelnorm_kernel.py:20-27``).
- ``channelnorm``: the wrapper. A tensor on the CPU takes the plain
  version; a CUDA tensor launches the hand-written kernel
  (``csrc/channelnorm.cu``) or raises. ``launches`` counts the kernel
  launches.
"""

from __future__ import annotations

import ctypes

import torch

from imaginaire_tpu_torch.ops import build

KERNEL = "channelnorm"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (set it to 0 to reset)


def _check_args(x, p):
    if x.dim() != 4:
        raise ValueError(f"channelnorm expects NCHW x (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"channelnorm takes a floating tensor, got {x.dtype}")
    if not p > 0:
        raise ValueError(f"channelnorm needs p > 0, got {p}")


def channelnorm_plain(x, p=2):
    """The norm in plain PyTorch (the reference the kernel is held to)."""
    _check_args(x, p)
    v = x.float()
    if p == 2:
        out = torch.sqrt((v * v).sum(dim=1, keepdim=True))
    else:
        out = v.abs().pow(p).sum(dim=1, keepdim=True).pow(1.0 / p)
    return out.to(x.dtype)


def channelnorm(x, p=2):
    """L-p norm over the channels of x (B, C, H, W) -> (B, 1, H, W)."""
    _check_args(x, p)
    if x.device.type == "cpu":
        return channelnorm_plain(x, p)
    if x.device.type != "cuda":
        raise ValueError(f"channelnorm runs on cpu or cuda, not {x.device}")
    return _launch(x, p)


def _library():
    lib = build.load(KERNEL)
    lib.channelnorm_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p]
    lib.channelnorm_fwd.restype = ctypes.c_int
    lib.channelnorm_error_string.argtypes = [ctypes.c_int]
    lib.channelnorm_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, p):
    global launches
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "channelnorm has no CUDA backward: FlowNet2 is a frozen teacher; "
            "run it under torch.no_grad() or torch.inference_mode()")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the channelnorm kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("channelnorm x must be contiguous NCHW")
    b, c, h, w = x.shape
    out = torch.empty((b, 1, h, w), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out.zero_()  # an empty sum is 0 (and so is C = 0)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.channelnorm_fwd(x.data_ptr(), out.data_ptr(), b, c, h, w,
                                  _DTYPE_CODES[x.dtype], float(p), 1.0 / p,
                                  stream)
    if err != 0:
        raise RuntimeError(
            f"channelnorm kernel launch failed: CUDA error {err} "
            f"({lib.channelnorm_error_string(err).decode()})")
    launches += 1
    return out
