"""The port's channelnorm and correlation (FlowNet2's two kernels) against
the JAX package's ops.

Inputs are made with numpy from a seed and handed to both packages in
their own layouts (NHWC for JAX, NCHW for the port). The JAX side runs
as its own tests run it on the CPU: the 'jnp' versions, correlation's
'mxu' matmul formulation, and the Pallas kernels in interpret mode
('pallas_interpret'). On the CPU the port's wrappers take their plain
versions and launch nothing; the CUDA kernels are held to those plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: channelnorm rtol = atol = 1e-5 (fp32; sums of 3-5 terms in
another order); correlation rtol 1e-4, atol 1e-5 (the JAX package's own
tolerance for its versions against each other; fp32 sums of up to 16
products in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.ops import channelnorm as jax_channelnorm
from imaginaire_tpu.ops import correlation as jax_correlation
from imaginaire_tpu_torch.ops import channelnorm as cn
from imaginaire_tpu_torch.ops import correlation as corr


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("p", [1, 2, 3])
def test_channelnorm_plain_matches_jax(impl, p):
    x = np.random.RandomState(p).randn(2, 5, 6, 3).astype(np.float32)
    want = np.asarray(jax_channelnorm(jnp.asarray(x), p=p, implementation=impl))
    before = cn.launches
    got = cn.channelnorm(nchw(x), p=p)
    assert cn.launches == before  # the CPU takes the plain version
    assert got.shape == (2, 1, 5, 6) and got.dtype == torch.float32
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)


def test_channelnorm_bf16_computes_in_fp32():
    x = nchw(np.random.RandomState(4).randn(1, 7, 9, 2).astype(np.float32),
             torch.bfloat16)
    got = cn.channelnorm(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, cn.channelnorm_plain(x.float()).bfloat16())


@pytest.mark.parametrize("x,p,error", [
    (torch.zeros(3, 4, 4), 2, ValueError),              # not rank 4
    (torch.zeros(1, 3, 4, 4, dtype=torch.int32), 2, TypeError),
    (torch.zeros(1, 3, 4, 4), 0, ValueError),           # p must be > 0
])
def test_channelnorm_bad_inputs_raise(x, p, error):
    with pytest.raises(error):
        cn.channelnorm(x, p=p)


# (x shape NHWC, pad_size, max_displacement, stride2) x the JAX versions
# that tests/test_ops.py runs there: its shapes, and the FlowNetC
# configuration on an 8x12 map (441 displacements, most in the padding)
CORRELATION_CASES = [
    pytest.param((2, 6, 7, 4), 2, 2, 1, impl, id=f"md2s1-{impl}")
    for impl in ("jnp", "mxu", "pallas_interpret")
] + [
    pytest.param((1, 5, 5, 3), 4, 4, 2, impl, id=f"md4s2-{impl}")
    for impl in ("jnp", "mxu")
] + [
    pytest.param((1, 8, 12, 16), 20, 20, 2, impl, id=f"flownetc-{impl}")
    for impl in ("jnp", "mxu", "pallas_interpret")
]


@pytest.mark.parametrize("shape,pad,md,s2,impl", CORRELATION_CASES)
def test_correlation_plain_matches_jax(shape, pad, md, s2, impl):
    rng = np.random.RandomState(sum(shape))
    x1 = rng.randn(*shape).astype(np.float32)
    x2 = rng.randn(*shape).astype(np.float32)
    want = np.asarray(jax_correlation(jnp.asarray(x1), jnp.asarray(x2),
                                      pad_size=pad, max_displacement=md,
                                      stride2=s2, implementation=impl))
    before = corr.launches
    got = corr.correlation(nchw(x1), nchw(x2), pad_size=pad,
                           max_displacement=md, stride2=s2)
    assert corr.launches == before
    n_d = 2 * md // s2 + 1
    assert got.shape == (shape[0], n_d * n_d, shape[1], shape[2])
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-5)


def test_correlation_bf16_accumulates_in_fp32():
    rng = np.random.RandomState(5)
    x1 = nchw(rng.randn(1, 6, 9, 32).astype(np.float32), torch.bfloat16)
    x2 = nchw(rng.randn(1, 6, 9, 32).astype(np.float32), torch.bfloat16)
    kw = dict(pad_size=4, max_displacement=4, stride2=2)
    got = corr.correlation(x1, x2, **kw)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, corr.correlation_plain(x1.float(), x2.float(),
                                                   **kw).bfloat16())


@pytest.mark.parametrize("pad,md,s2", [(5, 5, 2), (8, 7, 3)])
def test_correlation_indivisible_displacement_matches_jax_auto(pad, md, s2):
    """A max_displacement that stride2 does not divide: the JAX public op
    (``implementation="auto"``) sends it to the jnp scan, whose grid
    ``arange(-md, md + 1, s2)`` has 2 md // s2 + 1 steps (6 at md 5, s2 2:
    -5 .. 5; 5 at md 7, s2 3: -7 .. 5). The port gives that answer. The
    JAX versions disagree with each other there: at md 5, s2 2 the
    Pallas kernel takes 2 (5 // 2) + 1 = 5 steps from -5 (-5 .. 3)."""
    rng = np.random.RandomState(md)
    x1 = rng.randn(1, 6, 7, 3).astype(np.float32)
    x2 = rng.randn(1, 6, 7, 3).astype(np.float32)
    kw = dict(pad_size=pad, max_displacement=md, stride2=s2)
    want = np.asarray(jax_correlation(jnp.asarray(x1), jnp.asarray(x2),
                                      implementation="auto", **kw))
    n_d = corr.num_displacements(md, s2)
    assert n_d == len(np.arange(-md, md + 1, s2)) and want.shape[-1] == n_d ** 2
    if (md, s2) == (5, 2):
        pallas = jax_correlation(jnp.asarray(x1), jnp.asarray(x2),
                                 implementation="pallas_interpret", **kw)
        assert want.shape[-1] == 36 and pallas.shape[-1] == 25
    for fn in (corr.correlation, corr.correlation_plain):
        got = fn(nchw(x1), nchw(x2), **kw)
        assert got.shape == (1, n_d * n_d, 6, 7)
        np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kwargs,error", [
    (dict(kernel_size=3), NotImplementedError),
    (dict(stride1=2), NotImplementedError),
    (dict(pad_size=1), ValueError),        # pad_size < max_displacement
])
def test_correlation_unsupported_configurations_raise(kwargs, error):
    x = torch.zeros(1, 2, 5, 5)
    args = dict(pad_size=2, kernel_size=1, max_displacement=2, stride1=1,
                stride2=1)
    args.update(kwargs)
    with pytest.raises(error):
        corr.correlation(x, x, **args)


@pytest.mark.parametrize("x1,x2,error", [
    (torch.zeros(1, 2, 5, 5), torch.zeros(1, 2, 5, 6), ValueError),
    (torch.zeros(2, 5, 5), torch.zeros(2, 5, 5), ValueError),
    (torch.zeros(1, 0, 5, 5), torch.zeros(1, 0, 5, 5), ValueError),
    (torch.zeros(1, 2, 5, 5, dtype=torch.int64),
     torch.zeros(1, 2, 5, 5, dtype=torch.int64), TypeError),
])
def test_correlation_bad_inputs_raise(x1, x2, error):
    with pytest.raises(error):
        corr.correlation(x1, x2, pad_size=2, max_displacement=2, stride2=1)


# --- the CUDA kernel's tile plan and arithmetic, checked on the CPU -------
#
# (x1 NCHW shape, max_displacement, stride2): FlowNetC at the teacher's
# attach, and the edge shapes chip_smoke.py and tests/test_torch_cuda.py
# hold the kernel to on the card
PLAN_SHAPES = [
    ((6, 256, 64, 128), 20, 2),   # the teacher path: 6 frame pairs
    ((1, 8, 7, 9), 2, 1),         # odd map inside one tile
    ((2, 16, 13, 17), 4, 2),
    ((1, 256, 8, 12), 20, 2),     # most displacements in the padding
    ((1, 3, 5, 300), 4, 1),       # three column tiles
    ((2, 5, 6, 40), 13, 1),       # 27 displacements: two dx groups
    ((1, 40, 9, 130), 20, 2),     # W not a multiple of the tile
    ((1, 16, 6, 5), 2, 1),        # W smaller than one m16 tile
    ((1, 1, 7, 20), 2, 1),        # C = 1
    ((2, 33, 5, 24), 4, 2),       # C = 33: a partial channel chunk
    ((2, 8, 5, 21), 0, 1),        # max_displacement 0: one displacement
    ((1, 16, 9, 37), 8, 4),       # stride2 4
    ((3, 16, 6, 20), 4, 2),       # B = 3
    ((2, 6, 6, 11), 5, 2),        # md 5, s2 2: 6 steps from -5
    ((1, 8, 9, 37), 7, 3),        # md 7, s2 3: 5 steps from -7
    # stride2 above 16: the column phases split into groups, one a block
    ((1, 8, 6, 40), 17, 17), ((2, 5, 7, 70), 34, 17),
    ((1, 8, 6, 45), 20, 20), ((1, 8, 6, 45), 40, 20),
    ((1, 8, 5, 70), 32, 32), ((1, 8, 5, 70), 64, 32),
]


def kernel_cover(shape, plan, s2):
    """How often the kernel's blocks write each (dyi, dxi, y, x) of one
    batch element, following csrc/correlation.cu's index map (blockIdx.y is
    the batch element, one to one)."""
    _, _, h, w = shape
    n_d = plan["n_d"]
    counts = np.zeros((n_d, n_d, h, w), np.int32)
    phase_cols = s2 * np.arange(16 * plan["m_tiles"])  # column - x0 of phase 0
    for bx in range(plan["grid_x"]):
        xt, rest = bx % plan["x_tiles"], bx // plan["x_tiles"]
        pg, rest = rest % plan["phase_groups"], rest // plan["phase_groups"]
        phases = pg * plan["phases"] + np.arange(plan["phases"])
        gx, rest = rest % plan["dx_groups"], rest // plan["dx_groups"]
        dyg, yb = rest % plan["dy_groups"], rest // plan["dy_groups"]
        x0, gx0 = xt * plan["tile_w"], gx * plan["dx_per_group"]
        nx = min(plan["dx_per_group"], n_d - gx0)
        dyi0 = dyg * plan["dys"]
        ndy = min(plan["dys"], n_d - dyi0)
        ys = yb % s2 + s2 * (plan["rows"] * (yb // s2) + np.arange(plan["rows"]))
        xs = x0 + (phase_cols[:, None] + phases[phases < s2][None, :]).ravel()
        ys, xs = ys[ys < h], xs[xs < w]
        if ndy <= 0 or nx <= 0 or not len(ys) or not len(xs):
            continue
        idx = np.ix_(dyi0 + np.arange(ndy), gx0 + np.arange(nx), ys, xs)
        counts[idx] += 1
    return counts


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("shape,md,s2", PLAN_SHAPES)
def test_correlation_tile_plan_covers_each_output_once(shape, md, s2, elem_bytes):
    plan = corr.tile_plan(shape, md, s2, elem_bytes)
    assert set(corr.PLAN_FIELDS) <= set(plan)
    assert plan["smem_bytes"] <= corr.SMEM_LIMIT == 227 * 1024
    assert plan["threads"] <= 512 and plan["threads"] % 32 == 0
    assert plan["phases"] * plan["phase_groups"] >= s2 >= plan["phases"]
    if s2 <= 16:  # every phase of a tile in one block
        assert plan["phase_groups"] == 1
    assert plan["chunk"] in (8, 16, 32) and plan["stages"] in (2, 3)
    # each m16 tile's band (16 + dx_per_group - 1 window columns) fits its
    # n8 tiles, and the staged window holds every tile's columns
    assert 8 * plan["n_tiles8"] >= 15 + plan["dx_per_group"]
    assert plan["window"] >= s2 * (16 * (plan["m_tiles"] - 1) + 8 * plan["n_tiles8"])
    stage = plan["chunk"] * elem_bytes * (
        plan["rows"] * plan["stride_x1"]
        + (plan["rows"] + plan["dys"] - 1) * plan["stride_x2"])
    assert plan["stages"] * stage <= plan["smem_bytes"]
    assert (plan["stride_x1"] * elem_bytes) % 16 == 0
    assert (plan["stride_x1"] * elem_bytes // 4) % 32 == 8
    counts = kernel_cover(shape, plan, s2)
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("shape,md,s2", [
    ((1, 8, 4, 2048), 650, 65),        # a tile past shared memory
    ((65536, 1, 1, 1), 0, 1),          # more batch elements than grid rows
])
def test_correlation_tile_plan_refuses_what_it_cannot_stage(shape, md, s2):
    """A tile past shared memory now takes the direct path (one thread an
    output); only a grid the card cannot launch still raises."""
    if shape[0] > 65535:
        with pytest.raises(ValueError, match="cannot stage"):
            corr.tile_plan(shape, md, s2)
        return
    plan = corr.tile_plan(shape, md, s2)
    assert plan["route"] == "direct" and plan["n_d"] == 21
    assert plan["grid_x"] * plan["threads"] >= 21 * 21 * 4 * 2048
    with pytest.raises(ValueError, match="cannot stage"):
        corr.direct_plan((2 ** 20, 8, 64, 64), 21)


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("shape,md,s2", [
    ((1, 8, 4, 2048), 650, 65), ((2, 16, 6, 300), 182, 91),
    ((1, 4, 3, 500), 400, 200), ((1, 8, 6, 45), 40, 20)])
def test_correlation_wide_strides_choose_their_path_by_shape(
        shape, md, s2, elem_bytes):
    """fp32 from stride2 65 plans the direct path (bf16 tiles, half the
    bytes, fit further); what fits shared memory keeps the tiled plan."""
    plan = corr.tile_plan(shape, md, s2, elem_bytes)
    direct = plan.get("route") == "direct"
    if elem_bytes == 4:
        assert direct == (s2 >= 65)
    if direct:
        b, _, h, w = shape
        n_d = corr.num_displacements(md, s2)
        assert plan["n_d"] == n_d
        assert (plan["grid_x"] - 1) * plan["threads"] < b * n_d * n_d * h * w \
            <= plan["grid_x"] * plan["threads"]


@pytest.mark.parametrize("batch", [1, 6])
def test_correlation_tile_plan_of_flownetc_is_unchanged(batch):
    """FlowNetC's plan (stride2 2) at one frame pair and at the teacher's
    attach, field for field: every column phase in one block (one phase
    group), 2 rows x 3 dy x 128 columns, 16 warps, a ring of 3 stages of
    16 channels."""
    plan = corr.tile_plan((batch, 256, 64, 128), 20, 2)
    assert plan == dict(
        tile_w=128, m_tiles=4, rows=2, dys=3, dx_groups=1, dx_per_group=21,
        n_tiles8=5, window=176, stride_x1=136, stride_x2=200, chunk=16,
        stages=3, threads=512, smem_bytes=205824, x_tiles=1, y_blocks=32,
        dy_groups=7, grid_x=224, phases=2, phase_groups=1, n_d=21)


def _kernel_index_map(x1, x2, md, s2):
    """The cost volume computed along csrc/correlation.cu's address
    arithmetic, in fp64 with exact products: each block stages its x1
    rows and x2 windows whole (zero outside the frame), each warp
    multiplies the m16 tile of one phase of its block's group against
    its n8 tiles, the band (j - i = dxl) goes through the epilogue buffer
    and out by the kernel's store map, which keeps the group's phases.
    NaN where nothing was written; raises where a value is written
    twice."""
    b_, c, h, w = x1.shape
    p = corr.tile_plan(x1.shape, md, s2)
    n_d, nt, tile_w = p["n_d"], p["n_tiles8"], p["tile_w"]
    out = np.full((b_, n_d * n_d, h, w), np.nan)

    def staged(src, b, yrow, g0, cols):
        row = np.zeros((c, cols))
        g = g0 + np.arange(cols)
        ok = (g >= 0) & (g < w)
        if 0 <= yrow < h:
            row[:, ok] = src[b, :, yrow][:, g[ok]]
        return row

    for b in range(b_):
        for bx in range(p["grid_x"]):
            xt, rest = bx % p["x_tiles"], bx // p["x_tiles"]
            ph0 = (rest % p["phase_groups"]) * p["phases"]
            rest //= p["phase_groups"]
            gx, rest = rest % p["dx_groups"], rest // p["dx_groups"]
            dyg, yb = rest % p["dy_groups"], rest // p["dy_groups"]
            x0, gx0, dyi0 = xt * tile_w, gx * p["dx_per_group"], dyg * p["dys"]
            nx, ndy = min(p["dx_per_group"], n_d - gx0), min(p["dys"], n_d - dyi0)
            y_base = yb % s2 + s2 * p["rows"] * (yb // s2)
            yy_base, wx0 = y_base - md + s2 * dyi0, x0 - md + s2 * gx0
            s1 = [staged(x1, b, y_base + s2 * r, x0, tile_w)
                  for r in range(p["rows"])]
            sw = [staged(x2, b, yy_base + s2 * k, wx0, p["window"])
                  for k in range(p["rows"] + p["dys"] - 1)]
            E = np.zeros((p["rows"], p["dys"], p["dx_per_group"], tile_w))
            for r in range(p["rows"]):
                for mt in range(p["phases"] * p["m_tiles"]):
                    ph, m = ph0 + mt % p["phases"], mt // p["phases"]
                    if ph >= s2:
                        continue
                    a = s1[r][:, s2 * (16 * m + np.arange(16)) + ph]
                    for g in range(ndy):
                        acc = a.T @ sw[r + g][:, s2 * (16 * m + np.arange(8 * nt)) + ph]
                        for dxl in range(nx):
                            E[r, g, dxl, s2 * (16 * m + np.arange(16)) + ph] = \
                                acc[np.arange(16), np.arange(16) + dxl]
            col = np.arange(tile_w)
            keep = ((p["phases"] == s2) | ((col % s2 - ph0) % 2 ** 32 < p["phases"])) \
                & (x0 + col < w)
            for r in range(p["rows"]):
                yr = y_base + s2 * r
                for g in range(ndy):
                    for dxl in range(nx):
                        if yr >= h:
                            continue
                        ch = (dyi0 + g) * n_d + gx0 + dxl
                        dst = out[b, ch, yr]
                        assert np.isnan(dst[x0 + col[keep]]).all(), "written twice"
                        dst[x0 + col[keep]] = E[r, g, dxl, keep] / c
    return out


@pytest.mark.parametrize("shape,md,s2", [
    ((2, 3, 6, 11), 5, 2),     # every phase in one block; 6 steps from -5
    ((1, 3, 9, 37), 7, 3),     # 5 steps from -7
    ((1, 3, 6, 40), 17, 17),   # two phase groups of 9 (one phase empty)
    ((1, 2, 5, 45), 20, 20),   # two groups of 10
    ((1, 2, 4, 70), 32, 32),   # two groups of 16
])
def test_correlation_kernel_index_map_matches_plain(shape, md, s2):
    """The kernel's addressing, followed step by step on the CPU, writes
    every output once and computes the plain version's cost volume, for
    blocks that hold every column phase and for phase groups."""
    rng = np.random.RandomState(sum(shape) + md)
    x1, x2 = rng.randn(*shape), rng.randn(*shape)
    got = _kernel_index_map(x1, x2, md, s2)
    want = corr.correlation_plain(torch.from_numpy(x1), torch.from_numpy(x2),
                                  pad_size=md, max_displacement=md, stride2=s2)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want.double().numpy(), rtol=0, atol=1e-5)


def _tf32(a):
    """Round fp32 to TF32 as cvt.rna does: to nearest on the 10-bit
    mantissa, ties away from zero (13 low bits dropped)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _band_correlation(x1, x2, md, s2, split):
    """The kernel's arithmetic on NHWC arrays: per vertical displacement
    one product P = A B over the channels with TF32 operands (3xTF32:
    a_lo b_hi + a_hi b_lo + a_hi b_hi; else a_hi b_hi), fp32 sums, then the
    band out[x, dxi] = P[x, x - md + dxi s2] / C."""
    b, h, w, c = x1.shape
    n_d = 2 * (md // s2) + 1
    x2p = np.pad(x2, ((0, 0), (md, md), (md, md), (0, 0)))
    a_hi = _tf32(x1)
    a_lo = _tf32(x1 - a_hi)
    out = np.zeros((b, h, w, n_d * n_d), np.float32)
    cols = np.arange(w)[:, None] + s2 * np.arange(n_d)[None, :]
    for dyi in range(n_d):
        win = x2p[:, dyi * s2:dyi * s2 + h]          # (B, H, W + 2 md, C)
        b_hi = _tf32(win)
        b_lo = _tf32(win - b_hi)
        prod = np.einsum("bhwc,bhvc->bhwv", a_hi, b_hi)
        if split:
            prod = (np.einsum("bhwc,bhvc->bhwv", a_lo, b_hi)
                    + np.einsum("bhwc,bhvc->bhwv", a_hi, b_lo)) + prod
        band = np.take_along_axis(prod, np.broadcast_to(cols, prod.shape[:2] + cols.shape),
                                  axis=-1)
        out[..., dyi * n_d:(dyi + 1) * n_d] = band / np.float32(c)
    return out


@pytest.mark.parametrize("channels", [8, 256])
def test_correlation_3xtf32_meets_the_fp32_gate_and_1xtf32_does_not(channels):
    """Why the kernel splits each operand: against the JAX jnp cost volume
    the 3xTF32 band product stays within the card gate (1e-5, absolute;
    chip_smoke.py TOL_CORR_FP32) and plain TF32 does not."""
    rng = np.random.RandomState(channels)
    x1 = rng.randn(1, 8, 16, channels).astype(np.float32)
    x2 = rng.randn(1, 8, 16, channels).astype(np.float32)
    want = np.asarray(jax_correlation(jnp.asarray(x1), jnp.asarray(x2),
                                      pad_size=4, max_displacement=4, stride2=2,
                                      implementation="jnp"))
    split = np.abs(_band_correlation(x1, x2, 4, 2, split=True) - want).max()
    plain = np.abs(_band_correlation(x1, x2, 4, 2, split=False) - want).max()
    assert split <= 1e-5 < plain, (split, plain)
