"""The port's resample2d (bilinear backward warp) against the JAX
package's op.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it on the CPU: the 'jnp' gather
version and the Pallas kernel in interpret mode ('pallas_interpret').
Flows mix fractional, integer-valued, zero (identity) and out-of-frame
(+-1.5 W or H) displacements, so the border clamp and the weights taken
from the unclamped fractions are both exercised. On the CPU the port's
wrapper takes its plain version; the CUDA kernel is held to that plain
version on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerance: fp32 atol 1e-5 (the Pallas kernel rounds its corner sum in
another order; the jnp version is bit-equal).

The backward (``resample2d_bwd_plain`` and the autograd Function) is held
to ``jax.vjp`` of the 'jnp' and 'pallas_interpret' routes (the Pallas
route's backward is the vjp of the jnp warp) in fp32: dx and dflow within
1e-5 of the reference's max magnitude, under mixed, border-clamped,
entirely out-of-range, exact-integer and all-corners flows (every sample
just or far past a corner of the frame); the Function passes
``torch.autograd.gradcheck`` in fp64. In bf16 the port keeps fp32
coordinates: its backward equals its fp32 backward of the same
(bf16-valued) inputs rounded once, and is held to the JAX vjp of
fp32-cast inputs within 8e-3 of the max magnitude (bf16 rounds once at
the end); the JAX vjp of bf16 inputs computes its coordinates in bf16
and lands whole pixels away (ROADMAP.md, section C).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.ops.resample2d import resample2d as jax_resample2d
from imaginaire_tpu_torch.ops import build
from imaginaire_tpu_torch.ops import resample2d as rs


def mixed_flow(rng, b, h, w):
    """(B, H, W, 2) pixel flow whose pixels are, at random, fractional,
    integer-valued, zero or far outside the frame."""
    kind = rng.randint(0, 4, (b, h, w, 1))
    frac = rng.uniform(-3.0, 3.0, (b, h, w, 2))
    integer = rng.randint(-4, 5, (b, h, w, 2)).astype(np.float64)
    outside = rng.choice([-1.5, 1.5], (b, h, w, 2)) * np.array([w, h])
    flow = np.select([kind == 0, kind == 1, kind == 2],
                     [frac, integer, np.zeros_like(frac)], outside)
    return flow.astype(np.float32)


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def border_flow(b, h, w):
    """(B, H, W, 2) pixel flow whose sample points put every floor at or
    just past a border (-1, 0, n - 1, n), or a million pixels outside."""
    xs = np.array([-1.0, -0.5, 0.0, 0.25, w - 1.0, w - 0.5, w, w + 0.75,
                   -1e6 - 0.5, 1e6 + 0.25], np.float32)
    ys = np.array([-1.0, -0.25, 0.0, h - 1.0, h - 0.5, h, 1e6 + 0.5,
                   -1e6], np.float32)
    gx = np.resize(xs, (b, h, w)) - np.arange(w, dtype=np.float32)
    gy = np.resize(ys, (b, w, h)).transpose(0, 2, 1) \
        - np.arange(h, dtype=np.float32)[:, None]
    return np.stack([gx, gy], -1).astype(np.float32)


@pytest.mark.parametrize("impl,flow_kind", [
    pytest.param("jnp", "mixed", id="jnp"),
    pytest.param("pallas_interpret", "mixed", id="pallas_interpret"),
    pytest.param("jnp", "border", id="jnp-border"),
    pytest.param("pallas_interpret", "border", id="pallas_interpret-border"),
])
def test_plain_matches_jax_fp32(impl, flow_kind):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 16, 3).astype(np.float32)
    flow = mixed_flow(rng, 2, 8, 16) if flow_kind == "mixed" \
        else border_flow(2, 8, 16)
    want = np.asarray(jax_resample2d(jnp.asarray(x), jnp.asarray(flow),
                                     implementation=impl))
    before = rs.launches
    got = rs.resample2d(nchw(x), nchw(flow))
    assert rs.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5, rtol=0)


def test_zero_and_integer_flows_copy_and_shift():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 2, 6, 7).astype(np.float32))
    flow = torch.zeros(1, 2, 6, 7)
    assert torch.equal(rs.resample2d(x, flow), x)
    flow[:, 0] = 2.0  # every pixel reads two columns to its right
    out = rs.resample2d(x, flow)
    assert torch.equal(out[..., :5], x[..., 2:])
    assert torch.equal(out[..., 5:], x[..., 6:].expand(1, 2, 6, 2))  # border


def test_bf16_keeps_fp32_coordinates():
    """At W = 512 the bf16 warp equals the fp32 warp of the same inputs
    rounded to bf16, because the coordinates stay fp32. The JAX jnp
    version computes them in bf16, which holds no column index above
    256 exactly, and lands whole pixels away (ROADMAP.md, section C)."""
    rng = np.random.RandomState(2)
    x = rng.randn(1, 4, 512, 3).astype(np.float32)
    flow = rng.uniform(-2.0, 2.0, (1, 4, 512, 2)).astype(np.float32)
    xb, fb = nchw(x, torch.bfloat16), nchw(flow, torch.bfloat16)
    got = rs.resample2d(xb, fb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, rs.resample2d_plain(xb.float(), fb.float()).bfloat16())
    ref_bf16 = np.asarray(jax_resample2d(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(flow, jnp.bfloat16),
        implementation="jnp").astype(jnp.float32))
    assert np.abs(ref_bf16 - nhwc(got)).max() > 0.5


def outside_flow(rng, b, h, w):
    """(B, H, W, 2) flow sending every pixel 2-3 frame sizes outside."""
    sign = rng.choice([-1.0, 1.0], (b, h, w, 2))
    return (sign * rng.uniform(2.0, 3.0, (b, h, w, 2)) * np.array([w, h])).astype(np.float32)


def corners_flow(rng, b, h, w):
    """(B, H, W, 2) flow whose every sample point lies past a corner of the
    frame on both axes: half of them within one pixel of it (floor -1 or
    n - 1, where the weights come from the unclamped fractions), half 1.5
    frame sizes out. All four corners of every pixel clamp to one of the
    frame's four corner pixels."""
    size = np.array([w, h], np.float64)
    frac = rng.uniform(1 / 16, 15 / 16, (b, h, w, 2))
    near = rng.randint(0, 2, (b, h, w, 2)) * size - 1 + frac
    far = rng.choice([-1.0, 1.0], (b, h, w, 2)) * (1.5 * size + frac)
    pixel = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)
    return np.where(rng.randint(0, 2, (b, h, w, 1)) == 0, near - pixel,
                    far).astype(np.float32)


def integer_flow(rng, b, h, w):
    """(B, H, W, 2) integer flows: every sample point on a pixel centre,
    where floor's convention decides the corners."""
    return rng.randint(-3, 4, (b, h, w, 2)).astype(np.float32)


def jax_vjp(impl, x, flow, g, dtype=jnp.float32):
    """(dx, dflow) of the JAX op's vjp, one jitted program."""
    def grads(a, f, gg):
        _, vjp = jax.vjp(lambda a_, f_: jax_resample2d(a_, f_, implementation=impl), a, f)
        return vjp(gg)

    args = [jnp.asarray(a, dtype) for a in (x, flow, g)]
    return [np.asarray(v, np.float32) for v in jax.jit(grads)(*args)]


def rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("flow_kind", ["mixed", "border", "outside", "integer",
                                       "corners"])
def test_backward_plain_matches_jax_vjp_fp32(impl, flow_kind):
    rng = np.random.RandomState(3)
    b, h, w = 2, 8, 16
    x = rng.randn(b, h, w, 3).astype(np.float32)
    g = rng.randn(b, h, w, 3).astype(np.float32)
    flow = {"mixed": lambda: mixed_flow(rng, b, h, w),
            "border": lambda: border_flow(b, h, w),
            "outside": lambda: outside_flow(rng, b, h, w),
            "integer": lambda: integer_flow(rng, b, h, w),
            "corners": lambda: corners_flow(rng, b, h, w)}[flow_kind]()
    want_dx, want_dflow = jax_vjp(impl, x, flow, g)
    before = rs.bwd_launches
    dx, dflow = rs.resample2d_bwd(nchw(x), nchw(flow), nchw(g))
    assert rs.bwd_launches == before  # the CPU takes the plain version
    assert dx.dtype == dflow.dtype == torch.float32
    assert rel_err(nhwc(dx), want_dx) <= 1e-5
    if flow_kind in ("outside", "corners"):
        # every pixel's corners clamp to one corner pixel: dflow is 0, and
        # the JAX vjp's is the rounding of a difference of two equal sums
        corners = torch.stack(rs._sample_points(nchw(flow), torch.float32)[2])
        assert (corners == corners[:1]).all()
        assert not nhwc(dflow).any() and np.abs(want_dflow).max() <= 1e-6
    else:
        assert rel_err(nhwc(dflow), want_dflow) <= 1e-5
    _, dflow_only = rs.resample2d_bwd_plain(nchw(x), nchw(flow), nchw(g), need_dx=False)
    assert _ is None and torch.equal(dflow_only, dflow)


def test_autograd_function_matches_autograd_of_the_plain_warp():
    """Through the Function (the plain backward on the CPU) and through
    autograd of ``resample2d_plain``: the same gradients up to the order
    of fp32 sums; a flow alone needing a gradient gets dflow only."""
    rng = np.random.RandomState(4)
    x, flow = nchw(rng.randn(2, 8, 16, 3)), nchw(mixed_flow(rng, 2, 8, 16))
    g = nchw(rng.randn(2, 8, 16, 3))
    grads = []
    for warp in (rs.resample2d, rs.resample2d_plain):
        xi, fi = x.clone().requires_grad_(True), flow.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(warp(xi, fi), [xi, fi], g))
    for a, b in zip(*grads):
        assert rel_err(a.numpy(), b.numpy()) <= 1e-5
    fi = flow.clone().requires_grad_(True)
    (dflow,) = torch.autograd.grad(rs.resample2d(x, fi), [fi], g)
    assert torch.equal(dflow, grads[0][1])


def test_autograd_function_passes_gradcheck():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 2, 3, 5, dtype=torch.float64, generator=gen).requires_grad_(True)
    # fractional sample points only: the warp is not differentiable where
    # a coordinate is an integer
    flow = (torch.rand(2, 2, 3, 5, dtype=torch.float64, generator=gen) * 0.8 + 0.1
            + torch.randint(-2, 2, (2, 2, 3, 5), generator=gen)).requires_grad_(True)
    before = (rs.launches, rs.bwd_launches)
    assert torch.autograd.gradcheck(rs.resample2d, (x, flow))
    assert (rs.launches, rs.bwd_launches) == before


def test_bf16_backward_keeps_fp32_coordinates():
    """At W = 512 the port's bf16 backward is its fp32 backward of the
    same bf16-valued inputs, rounded once, and within 8e-3 of the JAX vjp
    of fp32-cast inputs; the JAX vjp of bf16 inputs computes coordinates
    in bf16 (2 pixels apart at x in [256, 512)) and is far off."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 2, 512, 3).astype(np.float32)
    flow = rng.uniform(-2.0, 2.0, (1, 2, 512, 2)).astype(np.float32)
    g = rng.randn(1, 2, 512, 3).astype(np.float32)
    xb, fb, gb = (nchw(a, torch.bfloat16) for a in (x, flow, g))
    dx, dflow = rs.resample2d_bwd(xb, fb, gb)
    assert dx.dtype == dflow.dtype == torch.bfloat16
    dx32, dflow32 = rs.resample2d_bwd_plain(xb.float(), fb.float(), gb.float())
    assert torch.equal(dflow, dflow32.bfloat16())
    assert torch.equal(dx, dx32.bfloat16())
    cast = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) for a in (x, flow, g)]
    want_dx, want_dflow = jax_vjp("jnp", *cast)
    assert rel_err(nhwc(dx), want_dx) <= 8e-3
    assert rel_err(nhwc(dflow), want_dflow) <= 8e-3
    _, bf16_dflow = jax_vjp("jnp", x, flow, g, jnp.bfloat16)
    assert rel_err(bf16_dflow, want_dflow) > 0.1


def test_backward_bad_gradient_shape_raises():
    x, flow = torch.zeros(1, 3, 4, 4), torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError):
        rs.resample2d_bwd(x, flow, torch.zeros(1, 2, 4, 4))


@pytest.mark.parametrize("x_shape,flow_shape", [
    ((1, 3, 8, 8), (1, 3, 8, 8)),    # flow with 3 channels
    ((1, 3, 8, 8), (2, 2, 8, 8)),    # batch mismatch
    ((1, 3, 8, 8), (1, 2, 8, 9)),    # spatial mismatch
    ((3, 8, 8), (1, 2, 8, 8)),       # x not rank 4
    ((1, 3, 8, 8), (1, 8, 8, 2)),    # NHWC flow
])
def test_bad_shapes_raise(x_shape, flow_shape):
    with pytest.raises(ValueError):
        rs.resample2d(torch.zeros(x_shape), torch.zeros(flow_shape))


def test_integer_tensors_raise():
    with pytest.raises(TypeError):
        rs.resample2d(torch.zeros(1, 3, 4, 4, dtype=torch.int32),
                      torch.zeros(1, 2, 4, 4))


# --- the CUDA kernel's tiling, on the CPU ----------------------------------

def kernel_constants():
    """The tiling constants of csrc/resample2d.cu, read from its source."""
    src = build.source_path(rs.KERNEL).read_text()
    return {name: int(value) for name, value in
            re.findall(r"^#define RESAMPLE_(\w+) (\d+)\b", src, re.M)}


def kernel_cover(shape, k, blocks):
    """How often the kernel's threads write each (b, y, x), following
    csrc/resample2d.cu's index map with its constants ``k``: ``blocks``
    blocks walk the tiles grid-stride; warp w of a block takes row w of a
    tile, lane l of it the PIXELS pixels of columns l, l + 32, ... of the
    tile that lie inside W."""
    b, _, h, w = shape
    tile_w = 32 * k["PIXELS"]
    tiles_x, tiles_y = -(-w // tile_w), -(-h // k["TILE_ROWS"])
    t = np.arange(32 * k["TILE_ROWS"])
    row, col = t // 32, t % 32
    counts = np.zeros((b, h, w), np.int32)
    per_image = tiles_x * tiles_y
    for block in range(blocks):
        for tile in range(block, per_image * b, blocks):
            bi, rt = divmod(tile, per_image)
            ty, tx = divmod(rt, tiles_x)
            y, x0 = ty * k["TILE_ROWS"] + row, tx * tile_w + col
            for i in range(k["PIXELS"]):
                xs = x0 + 32 * i
                keep = (y < h) & (x0 < w) & (xs < w)
                np.add.at(counts[bi], (y[keep], xs[keep]), 1)
    return counts, per_image * b


@pytest.mark.parametrize("shape", [
    (1, 3, 64, 256),     # whole tiles
    (2, 3, 37, 53),      # ragged tiles, W not a multiple of 4 or 8
    (1, 2, 9, 1027),
    (3, 5, 1, 7),        # H = 1: one row of a tile
    (2, 3, 40, 300),
    (2, 2, 48, 520),
])
def test_kernel_tiles_cover_each_pixel_once(shape):
    k = kernel_constants()
    _, tiles = kernel_cover(shape, k, 1)
    for blocks in sorted({1, 3, tiles}):  # a grid of any size up to the tiles
        counts, _ = kernel_cover(shape, k, blocks)
        assert counts.min() == 1 and counts.max() == 1


def test_backward_kernel_shares_the_forward_tiling():
    """The backward kernel walks tile_pixel's tiles: the forward's for
    dflow alone, 32 columns a pixel a thread with dx; it ships with dx's
    three contention cuts on and at most 3 planes in flight."""
    src = build.source_path(rs.KERNEL).read_text()
    k = kernel_constants()
    body = src[src.index("resample2d_bwd_kernel(const T*"):]
    assert "DX ? 32 * RESAMPLE_DX_PIXELS : RESAMPLE_TILE_W;" in body
    assert "tile_pixel(t, tiles_x, per_image, TILE_W, &b, &y, &x0);" in body
    assert k["DX_MERGE"] == k["DX_WARP_SUM"] == k["DX_NEIGHBOURS"] == 1
    assert 1 <= k["BWD_PLANES"] <= 3 and 1 <= k["DX_PLANES"] <= 3
    assert k["DX_PIXELS"] in (1, 2)


@pytest.mark.parametrize("shape", [(2, 3, 37, 53), (3, 5, 1, 7), (1, 2, 9, 1027)])
def test_backward_dx_tiles_cover_each_pixel_once(shape):
    """The dx kernel's tiles (32 RESAMPLE_DX_PIXELS columns) cover each
    pixel once, for a grid of any size up to the tiles."""
    k = dict(kernel_constants())
    k["PIXELS"] = k["DX_PIXELS"]
    _, tiles = kernel_cover(shape, k, 1)
    for blocks in sorted({1, 3, tiles}):
        counts, _ = kernel_cover(shape, k, blocks)
        assert counts.min() == 1 and counts.max() == 1


def test_kernel_tiling_of_the_paths():
    """The vid2vid warp and the teacher's warps (512x1024): 2 pixels a
    thread 32 columns apart, 64 x 8 tiles of 256 threads, 1024 of them a
    frame, at most 64 registers a thread (4 blocks an SM)."""
    k = kernel_constants()
    assert (k["PIXELS"], k["PLANES"], k["TILE_ROWS"]) == (2, 3, 8)
    assert 32 * k["TILE_ROWS"] * k["MIN_BLOCKS"] * 64 <= 65536
    for batch in (1, 6):
        shape = (batch, 3, 512, 1024)
        counts, tiles = kernel_cover(shape, k, 1056)
        assert tiles == 1024 * batch and (counts == 1).all()
