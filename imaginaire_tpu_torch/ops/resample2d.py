"""resample2d: backward-warp an image by an optical flow field, forward.

Port of ``imaginaire_tpu/ops/resample2d.py`` (forward only; the
backward, a scatter-add into x plus the flow gradient, comes as a kernel
with vid2vid training). Tensors are NCHW: x (B, C, H, W), flow
(B, 2, H, W) in pixels with channel 0 = dx (+x right) and channel 1 =
dy (+y down). Every output pixel (y, x) samples x bilinearly at
(x + dx, y + dy); corner indices are clamped to the border and the
weights come from the unclamped fractional parts.

- ``resample2d_plain``: plain PyTorch. It computes the coordinates,
  floors and weights in fp32 whatever the input types, gathers and
  accumulates in fp32 and casts the result to x's type, as the Pallas
  kernel does (``resample2d_kernel.py:57-58``).
- ``resample2d``: the wrapper. A tensor on the CPU takes the plain
  version; a CUDA tensor launches the hand-written kernel
  (``csrc/resample2d.cu``) or raises. ``launches`` counts the kernel
  launches.
"""

from __future__ import annotations

import ctypes

import torch

from imaginaire_tpu_torch.ops import build

KERNEL = "resample2d"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (set it to 0 to reset)


def _check_args(x, flow):
    if x.dim() != 4 or flow.dim() != 4 or flow.shape[1] != 2 \
            or flow.shape[0] != x.shape[0] or flow.shape[2:] != x.shape[2:]:
        raise ValueError(f"resample2d expects NCHW x (B, C, H, W) and flow "
                         f"(B, 2, H, W), got {tuple(x.shape)}, "
                         f"{tuple(flow.shape)}")
    if not (x.is_floating_point() and flow.is_floating_point()):
        raise TypeError(f"resample2d takes floating tensors, got {x.dtype}, "
                        f"{flow.dtype}")


def resample2d_plain(x, flow):
    """The warp in plain PyTorch (the reference the kernel is held to)."""
    _check_args(x, flow)
    b, c, h, w = x.shape
    f = flow.float()
    xs = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w) + f[:, 0]
    ys = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1) + f[:, 1]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    ax = xs - x0  # fractional parts BEFORE clamping
    ay = ys - y0
    x0i = x0.clamp(-1, w).long()
    y0i = y0.clamp(-1, h).long()
    x1i = (x0i + 1).clamp(0, w - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x0i = x0i.clamp(0, w - 1)
    y0i = y0i.clamp(0, h - 1)
    planes = x.float().reshape(b, c, h * w)

    def gather(yi, xi):
        idx = (yi * w + xi).view(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(planes, 2, idx).view(b, c, h, w)

    bx, by = 1.0 - ax, 1.0 - ay
    w00 = (by * bx).unsqueeze(1)
    w01 = (by * ax).unsqueeze(1)
    w10 = (ay * bx).unsqueeze(1)
    w11 = (ay * ax).unsqueeze(1)
    out = (w00 * gather(y0i, x0i) + w01 * gather(y0i, x1i)
           + w10 * gather(y1i, x0i) + w11 * gather(y1i, x1i))
    return out.to(x.dtype)


def resample2d(x, flow):
    """Warp x (B, C, H, W) backward by flow (B, 2, H, W), in pixels."""
    _check_args(x, flow)
    if x.device.type == "cpu" and flow.device.type == "cpu":
        return resample2d_plain(x, flow)
    if x.device.type != "cuda":
        raise ValueError(f"resample2d runs on cpu or cuda, not {x.device}")
    return _launch(x, flow)


def _library():
    lib = build.load(KERNEL)
    lib.resample2d_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.resample2d_fwd.restype = ctypes.c_int
    lib.resample2d_error_string.argtypes = [ctypes.c_int]
    lib.resample2d_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, flow):
    global launches
    if torch.is_grad_enabled() and (x.requires_grad or flow.requires_grad):
        raise NotImplementedError(
            "resample2d has no CUDA backward yet: it comes with vid2vid "
            "training (ROADMAP.md); run inference under torch.no_grad() "
            "or torch.inference_mode()")
    for name, t in (("x", x), ("flow", flow)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"the resample2d kernel takes float32 or "
                            f"bfloat16, got {name} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"resample2d tensors must share x's device "
                             f"({x.device}); got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"resample2d {name} must be contiguous NCHW")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    b, c, h, w = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.resample2d_fwd(
            x.data_ptr(), flow.data_ptr(), out.data_ptr(), b, c, h, w,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[flow.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"resample2d kernel launch failed: CUDA error {err} "
            f"({lib.resample2d_error_string(err).decode()})")
    launches += 1
    return out
