"""resample2d: backward-warp an image by an optical flow field, forward
and backward.

Port of ``imaginaire_tpu/ops/resample2d.py``. Tensors are NCHW: x (B, C, H, W), flow
(B, 2, H, W) in pixels with channel 0 = dx (+x right) and channel 1 =
dy (+y down). Every output pixel (y, x) samples x bilinearly at
(x + dx, y + dy); corner indices are clamped to the border and the
weights come from the unclamped fractional parts.

- ``resample2d_plain``: plain PyTorch. It computes the coordinates,
  floors and weights in fp32 whatever the input types (fp64 when an
  input is fp64, for ``gradcheck``), gathers and accumulates in fp32 and
  casts the result to x's type, as the Pallas kernel does
  (``resample2d_kernel.py:57-58``).
- ``resample2d_bwd_plain``: the backward in plain PyTorch, with the
  forward's fp32 coordinates: ``dflow`` from the derivatives of the
  weights in the unclamped fractions (``floor`` has zero gradient),
  summed over the channels in order, and, when asked for, ``dx`` by
  ``index_add_`` of ``w_k * g`` into the four clamped corners. The JAX
  backward (``_pallas_bwd``, ``jax.vjp`` of the jnp warp) computes its
  coordinates in ``promote_types(x, flow)``, bf16 for bf16 inputs; the
  port keeps fp32, as its forward does (ROADMAP.md, section C).
- ``resample2d``: the wrapper, a ``torch.autograd.Function``. Tensors on
  the CPU take the plain versions; CUDA tensors launch the hand-written
  kernels (``csrc/resample2d.cu``: ``resample2d_fwd``, and
  ``resample2d_bwd``, which launches a kernel without atomics for dflow
  alone and one that also adds dx when x needs a gradient) or raise.
  ``launches`` and ``bwd_launches`` count the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from imaginaire_tpu_torch.ops import build

KERNEL = "resample2d"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # forward kernel launches since the last reset (set it to 0)
bwd_launches = 0  # backward kernel launches since the last reset


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
    cdt = _compute_dtype(x, flow)
    ax, ay, corners = _sample_points(flow, cdt)
    planes = x.to(cdt).reshape(b, c, h * w)

    def gather(idx):
        return torch.gather(planes, 2, idx.view(b, 1, h * w).expand(b, c, h * w)
                            ).view(b, c, h, w)

    bx, by = 1.0 - ax, 1.0 - ay
    w00 = (by * bx).unsqueeze(1)
    w01 = (by * ax).unsqueeze(1)
    w10 = (ay * bx).unsqueeze(1)
    w11 = (ay * ax).unsqueeze(1)
    i00, i01, i10, i11 = corners
    out = (w00 * gather(i00) + w01 * gather(i01)
           + w10 * gather(i10) + w11 * gather(i11))
    return out.to(x.dtype)


def _compute_dtype(*tensors):
    """fp32, or fp64 when an input is fp64 (``gradcheck``)."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
            else torch.float32)


def _sample_points(flow, cdt):
    """The fractional parts (ax, ay), (B, H, W) in ``cdt``, and the flat
    in-plane indices of the four clamped corners (00, 01, 10, 11) of each
    output pixel."""
    _, _, h, w = flow.shape
    f = flow.to(cdt)
    xs = torch.arange(w, dtype=cdt, device=flow.device).view(1, 1, w) + f[:, 0]
    ys = torch.arange(h, dtype=cdt, device=flow.device).view(1, h, 1) + f[:, 1]
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
    return ax, ay, (y0i * w + x0i, y0i * w + x1i, y1i * w + x0i, y1i * w + x1i)


def resample2d_bwd_plain(x, flow, g, need_dx=True):
    """The warp's backward in plain PyTorch (the reference the backward
    kernel is held to): (dx or None, dflow) for the output gradient ``g``
    (x's shape). dflow is summed over the channels in order, each term
    ``g * ((1 - ay)(x01 - x00) + ay (x11 - x10))`` (x) and
    ``g * ((1 - ax)(x10 - x00) + ax (x11 - x01))`` (y), in fp32; dx
    scatter-adds ``w_k * g`` into the clamped corners (``index_add_``) in
    fp32. Each is cast to its input's type."""
    _check_args(x, flow)
    if g.shape != x.shape:
        raise ValueError(f"resample2d's output gradient must have x's shape "
                         f"{tuple(x.shape)}, got {tuple(g.shape)}")
    b, c, h, w = x.shape
    cdt = _compute_dtype(x, flow, g)
    ax, ay, corners = _sample_points(flow, cdt)
    bx, by = 1.0 - ax, 1.0 - ay
    planes = x.to(cdt).reshape(b, c, h * w)
    gc = g.to(cdt)
    v = [torch.gather(planes, 2, idx.view(b, 1, h * w).expand(b, c, h * w)
                      ).view(b, c, h, w) for idx in corners]
    dfx = torch.zeros((b, h, w), dtype=cdt, device=x.device)
    dfy = torch.zeros((b, h, w), dtype=cdt, device=x.device)
    for ch in range(c):
        v00, v01, v10, v11 = (t[:, ch] for t in v)
        tx = by * (v01 - v00) + ay * (v11 - v10)
        ty = bx * (v10 - v00) + ax * (v11 - v01)
        dfx = dfx + gc[:, ch] * tx
        dfy = dfy + gc[:, ch] * ty
    dflow = torch.stack([dfx, dfy], dim=1).to(flow.dtype)
    if not need_dx:
        return None, dflow
    dx = torch.zeros(b * c * h * w, dtype=cdt, device=x.device)
    base = (torch.arange(b * c, device=x.device) * (h * w)).view(b, c, 1)
    for idx, wk in zip(corners, (by * bx, by * ax, ay * bx, ay * ax)):
        dx.index_add_(0, (base + idx.view(b, 1, h * w)).reshape(-1),
                      (wk.unsqueeze(1) * gc).reshape(-1))
    return dx.view(b, c, h, w).to(x.dtype), dflow


def _on_cpu(*tensors):
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if tensors[0].device.type != "cuda":
        raise ValueError(f"resample2d runs on cpu or cuda, not "
                         f"{tensors[0].device}")
    return False


def resample2d_bwd(x, flow, g, need_dx=True):
    """(dx or None, dflow) of the warp for the output gradient ``g``: the
    plain version for CPU tensors, the backward kernel for CUDA ones."""
    _check_args(x, flow)
    if _on_cpu(x, flow, g):
        return resample2d_bwd_plain(x, flow, g, need_dx)
    return _launch_bwd(x, flow, g, need_dx)


class _Resample2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, flow):
        ctx.save_for_backward(x, flow)
        if _on_cpu(x, flow):
            return resample2d_plain(x, flow)
        return _launch(x, flow)

    @staticmethod
    def backward(ctx, g):
        x, flow = ctx.saved_tensors
        need_dx, need_dflow = ctx.needs_input_grad[:2]
        dx, dflow = resample2d_bwd(x, flow, g.contiguous(), need_dx)
        return dx, dflow if need_dflow else None


def resample2d(x, flow):
    """Warp x (B, C, H, W) backward by flow (B, 2, H, W), in pixels;
    differentiable in both."""
    _check_args(x, flow)
    return _Resample2d.apply(x, flow)


def _library():
    lib = build.load(KERNEL)
    lib.resample2d_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.resample2d_fwd.restype = ctypes.c_int
    lib.resample2d_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.resample2d_bwd.restype = ctypes.c_int
    lib.resample2d_error_string.argtypes = [ctypes.c_int]
    lib.resample2d_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_args(**tensors):
    x = tensors["x"]
    for name, t in tensors.items():
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"the resample2d kernel takes float32 or "
                            f"bfloat16, got {name} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"resample2d tensors must share x's device "
                             f"({x.device}); got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"resample2d {name} must be contiguous NCHW")


def _raise_on(err, lib, which):
    if err != 0:
        raise RuntimeError(
            f"resample2d {which} kernel launch failed: CUDA error {err} "
            f"({lib.resample2d_error_string(err).decode()})")


def _launch(x, flow):
    global launches
    _check_kernel_args(x=x, flow=flow)
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
    _raise_on(err, lib, "forward")
    launches += 1
    return out


def _launch_bwd(x, flow, g, need_dx):
    global bwd_launches
    _check_kernel_args(x=x, flow=flow, g=g)
    if g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"resample2d's output gradient must match x "
                         f"({x.dtype}, {tuple(x.shape)}), got {g.dtype}, "
                         f"{tuple(g.shape)}")
    dflow = torch.empty(flow.shape, dtype=flow.dtype, device=flow.device)
    dx = (torch.zeros(x.shape, dtype=torch.float32, device=x.device)
          if need_dx else None)
    if x.numel() == 0:
        return (dx.to(x.dtype) if need_dx else None), dflow.zero_()
    b, c, h, w = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.resample2d_bwd(
            x.data_ptr(), flow.data_ptr(), g.data_ptr(), dflow.data_ptr(),
            dx.data_ptr() if need_dx else None, b, c, h, w,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[flow.dtype], stream)
    _raise_on(err, lib, "backward")
    bwd_launches += 1
    return (dx.to(x.dtype) if need_dx else None), dflow
