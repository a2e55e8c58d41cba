"""correlation: the FlowNetC cost volume between two feature maps, forward.

Port of ``imaginaire_tpu/ops/correlation.py`` for ``kernel_size=1``,
``stride1=1`` and ``pad_size >= max_displacement``, the configuration
that FlowNetC and the JAX package's Pallas kernel use. Tensors are
NCHW: x1, x2 (B, C, H, W) -> (B, n_d * n_d, H, W) with
n_d = 2 * max_displacement // stride2 + 1 displacements per axis,
``-md, -md + s2, ..., -md + (n_d - 1) s2``; channel ``dyi * n_d + dxi``
holds ``sum_c x1[c, y, x] * x2pad[c, y + dy, x + dx] / C``, x2
zero-padded by ``pad_size``. FlowNet2 is a frozen teacher, so there is
no backward.

- ``correlation_plain``: plain PyTorch, a loop over the displacements as
  ``_correlation_jnp`` walks them (``ops/correlation.py:41-70``), in
  fp32 whatever the input types, the result cast to x1's type (the
  Pallas kernel's fp32 ``acc_ref``, ``correlation_kernel.py:44-70``).
- ``correlation``: the wrapper. Tensors on the CPU take the plain
  version; CUDA tensors launch the hand-written kernel
  (``csrc/correlation.cu``, a 3xTF32 tensor-core band product) or
  raise. ``launches`` counts the kernel launches.
- ``tile_plan``: the kernel's tiling for one call (tile width, phases,
  channel chunk, pipeline stages, window, shared memory, grid), computed
  here so that the CPU tests reach it; the kernel checks it and runs it.
  Where a tile cannot be staged in shared memory (fp32 from stride2 65)
  it plans the kernel's direct path instead: one thread an output, a
  loop over the channels.

A ``max_displacement`` that ``stride2`` does not divide takes the grid
of the JAX package's public op: its default ``implementation="auto"``
sends the case to the jnp scan, which steps ``arange(-md, md + 1, s2)``,
so n_d = 2 md // s2 + 1 steps from -md that stop short of +md where s2
does not divide 2 md (6 steps, -5 .. 5, at md 5, s2 2; 5 steps, -7 .. 5,
at md 7, s2 3). The JAX Pallas kernel takes ``2 (md // s2) + 1`` steps
instead and is not what the public op answers. Other configurations
(``kernel_size`` or ``stride1`` other than 1) raise
``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from imaginaire_tpu_torch.ops import build

KERNEL = "correlation"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (set it to 0 to reset)

# the kernel's struct Plan, field by field (csrc/correlation.cu)
PLAN_FIELDS = ("tile_w", "m_tiles", "rows", "dys", "dx_groups", "dx_per_group",
               "n_tiles8", "window", "stride_x1", "stride_x2", "chunk",
               "stages", "threads", "smem_bytes", "x_tiles", "y_blocks",
               "dy_groups", "grid_x", "phases", "phase_groups")
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use on sm_90
MAX_DX_PER_GROUP = 25    # 16 + 25 - 1 window columns = 5 n8 tiles
MAX_DYS = 3              # vertical displacements a block accumulates
MAX_WARPS = 16           # 512 threads, one m16 tile of one row each
# (stages, channels a stage) of the cp.async ring, in order of preference:
# the first that fits in shared memory
RING_CHOICES = ((3, 32), (3, 16), (3, 8), (2, 8))
DIRECT_THREADS = 256     # threads a block of the direct path


def num_displacements(max_displacement, stride2):
    """Displacements per axis: n_d, so the output has n_d**2 channels
    (the length of ``arange(-md, md + 1, s2)``)."""
    return 2 * max_displacement // stride2 + 1


def _ceil(a, b):
    return -(-a // b)


def _padded_stride(columns, elem_bytes):
    """Shared row stride in elements: at least ``columns``, 16-byte
    aligned, and 8 words past a multiple of 32 banks (conflict-free
    fragment loads at stride2 1)."""
    words = _ceil(columns * elem_bytes, 4)
    words += (8 - words) % 32
    return words * 4 // elem_bytes


def tile_plan(shape, max_displacement, stride2, elem_bytes=4):
    """The kernel's tiling of one call on x1, x2 of NCHW ``shape``:
    a dict of PLAN_FIELDS (and ``n_d``). A block owns ``rows`` output rows
    (y, y + s2, ...), ``dys`` vertical displacements, ``dx_per_group``
    horizontal displacements and, of the ``tile_w`` = 16 s2 ``m_tiles``
    output columns of its tile, the ``phases`` column phases of its phase
    group (all s2 of them up to stride2 16); each of its warps computes
    one m16 tile of one phase of one row for all its displacements. Every
    block stages its tile's columns whole. A tile that does not fit
    shared memory even with one vertical displacement and a ring of two
    stages of 8 channels (in fp32 from stride2 65) takes the direct path:
    ``dict(route="direct", threads, grid_x, n_d)``, one thread an output.
    Raises ValueError for a grid the card cannot launch."""
    b, c, h, w = shape
    n_d = num_displacements(max_displacement, stride2)
    s2 = stride2
    per_phase = _ceil(w, s2)                      # output columns per phase
    m_tiles = max(1, min(8 // s2, _ceil(per_phase, 16)))
    # one warp a (phase, m16 tile): above MAX_WARPS of them (stride2 > 16,
    # where m_tiles is 1) the phases split into groups, one group a block
    phase_groups = _ceil(s2 * m_tiles, MAX_WARPS)
    phases = _ceil(s2, phase_groups)
    n_mt = phases * m_tiles
    rows = 2 if 2 * n_mt <= MAX_WARPS and h > s2 else 1
    dx_groups = _ceil(n_d, MAX_DX_PER_GROUP)
    dx_per_group = _ceil(n_d, dx_groups)
    n_tiles8 = _ceil(15 + dx_per_group, 8)
    tile_w = 16 * s2 * m_tiles
    window = s2 * (16 * (m_tiles - 1) + 8 * n_tiles8)
    stride_x1 = _padded_stride(tile_w, elem_bytes)
    stride_x2 = _padded_stride(window, elem_bytes)
    # the most vertical displacements a block, then the deepest ring, that
    # fit; chunks are a power of two (the kernel splits a stage's row
    # index by shift)
    fit = max(8, 1 << (c - 1).bit_length())  # the least power of two >= C
    choices = [(dys, stages, min(chunk, fit))
               for dys in range(min(MAX_DYS, n_d), 0, -1)
               for stages, chunk in RING_CHOICES]
    for dys, stages, chunk in choices:
        per_channel = elem_bytes * (rows * stride_x1
                                    + (rows + dys - 1) * stride_x2)
        epilogue = 4 * rows * dys * dx_per_group * tile_w
        smem = max(stages * chunk * per_channel, epilogue)
        if smem <= SMEM_LIMIT:
            break
    else:
        return direct_plan(shape, n_d)
    x_tiles = _ceil(w, tile_w)
    y_blocks = s2 * _ceil(_ceil(h, s2), rows)
    dy_groups = _ceil(n_d, dys)
    grid_x = x_tiles * phase_groups * dx_groups * dy_groups * y_blocks
    if grid_x >= 2 ** 31 or b > 65535:
        raise ValueError(f"the correlation kernel cannot stage {tuple(shape)}: "
                         f"its grid would be ({grid_x}, {b}) blocks")
    return dict(tile_w=tile_w, m_tiles=m_tiles, rows=rows, dys=dys,
                dx_groups=dx_groups, dx_per_group=dx_per_group,
                n_tiles8=n_tiles8, window=window, stride_x1=stride_x1,
                stride_x2=stride_x2, chunk=chunk, stages=stages,
                threads=32 * rows * n_mt, smem_bytes=smem,
                x_tiles=x_tiles, y_blocks=y_blocks, dy_groups=dy_groups,
                grid_x=grid_x, phases=phases, phase_groups=phase_groups,
                n_d=n_d)


def direct_plan(shape, n_d):
    """The direct path's launch: one thread an output, 256 a block."""
    b, _, h, w = shape
    grid_x = _ceil(b * n_d * n_d * h * w, DIRECT_THREADS)
    if grid_x >= 2 ** 31:
        raise ValueError(f"the correlation kernel cannot stage {tuple(shape)}: "
                         f"its direct grid would be {grid_x} blocks")
    return dict(route="direct", threads=DIRECT_THREADS, grid_x=grid_x, n_d=n_d)


def _check_args(x1, x2, pad_size, kernel_size, max_displacement, stride1,
                stride2):
    if x1.dim() != 4 or x1.shape != x2.shape:
        raise ValueError(f"correlation expects matching NCHW inputs, got "
                         f"{tuple(x1.shape)}, {tuple(x2.shape)}")
    if not (x1.is_floating_point() and x2.is_floating_point()):
        raise TypeError(f"correlation takes floating tensors, got {x1.dtype}, "
                        f"{x2.dtype}")
    if x1.shape[1] == 0:
        raise ValueError("correlation needs at least one channel (it divides "
                         "by C)")
    if pad_size < max_displacement:
        raise ValueError("pad_size must cover max_displacement")
    if kernel_size != 1 or stride1 != 1 or stride2 < 1 or max_displacement < 0:
        raise NotImplementedError(
            "correlation supports kernel_size=1, stride1=1, stride2 >= 1 and "
            f"max_displacement >= 0, got kernel_size={kernel_size}, "
            f"stride1={stride1}, max_displacement={max_displacement}, "
            f"stride2={stride2}")


def correlation_plain(x1, x2, pad_size=20, kernel_size=1, max_displacement=20,
                      stride1=1, stride2=2):
    """The cost volume in plain PyTorch (the reference the kernel is held
    to)."""
    _check_args(x1, x2, pad_size, kernel_size, max_displacement, stride1,
                stride2)
    b, c, h, w = x1.shape
    n_d = num_displacements(max_displacement, stride2)
    a = x1.float()
    x2p = F.pad(x2.float(), (pad_size,) * 4)
    out = torch.empty((b, n_d * n_d, h, w), dtype=torch.float32, device=x1.device)
    for dyi in range(n_d):
        row = pad_size - max_displacement + dyi * stride2
        for dxi in range(n_d):
            col = pad_size - max_displacement + dxi * stride2
            shifted = x2p[:, :, row:row + h, col:col + w]
            out[:, dyi * n_d + dxi] = (a * shifted).sum(dim=1) / c
    return out.to(x1.dtype)


def correlation(x1, x2, pad_size=20, kernel_size=1, max_displacement=20,
                stride1=1, stride2=2):
    """FlowNetC cost volume of x1, x2 (B, C, H, W) -> (B, n_d**2, H, W)."""
    _check_args(x1, x2, pad_size, kernel_size, max_displacement, stride1,
                stride2)
    if x1.device.type == "cpu" and x2.device.type == "cpu":
        return correlation_plain(x1, x2, pad_size, kernel_size,
                                 max_displacement, stride1, stride2)
    if x1.device.type != "cuda":
        raise ValueError(f"correlation runs on cpu or cuda tensors, got x1 on "
                         f"{x1.device} and x2 on {x2.device}")
    return _launch(x1, x2, max_displacement, stride2)


def _library():
    lib = build.load(KERNEL)
    lib.correlation_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_void_p]
    lib.correlation_fwd.restype = ctypes.c_int
    lib.correlation_direct_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.correlation_direct_fwd.restype = ctypes.c_int
    lib.correlation_error_string.argtypes = [ctypes.c_int]
    lib.correlation_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x1, x2, max_displacement, stride2):
    global launches
    if torch.is_grad_enabled() and (x1.requires_grad or x2.requires_grad):
        raise NotImplementedError(
            "correlation has no CUDA backward: FlowNet2 is a frozen teacher; "
            "run it under torch.no_grad() or torch.inference_mode()")
    for name, t in (("x1", x1), ("x2", x2)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"the correlation kernel takes float32 or "
                            f"bfloat16, got {name} {t.dtype}")
        if t.device != x1.device:
            raise ValueError(f"correlation tensors must share x1's device "
                             f"({x1.device}); got {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"correlation {name} must be contiguous NCHW")
    if x2.dtype != x1.dtype:
        raise TypeError(f"correlation x1 and x2 must share a type, got "
                        f"{x1.dtype}, {x2.dtype}")
    b, c, h, w = x1.shape
    n_d = num_displacements(max_displacement, stride2)
    out = torch.empty((b, n_d * n_d, h, w), dtype=x1.dtype, device=x1.device)
    if x1.numel() == 0:
        return out  # no pixels: nothing to compute
    plan = tile_plan(x1.shape, max_displacement, stride2, x1.element_size())
    lib = _library()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        if plan.get("route") == "direct":
            err = lib.correlation_direct_fwd(
                x1.data_ptr(), x2.data_ptr(), out.data_ptr(), b, c, h, w,
                max_displacement, stride2, _DTYPE_CODES[x1.dtype], stream)
        else:
            fields = (ctypes.c_int * len(PLAN_FIELDS))(
                *(plan[k] for k in PLAN_FIELDS))
            err = lib.correlation_fwd(
                x1.data_ptr(), x2.data_ptr(), out.data_ptr(), b, c, h, w,
                max_displacement, stride2, _DTYPE_CODES[x1.dtype], fields,
                stream)
    if err != 0:
        raise RuntimeError(
            f"correlation kernel launch failed: CUDA error {err} "
            f"({lib.correlation_error_string(err).decode()})")
    launches += 1
    return out
