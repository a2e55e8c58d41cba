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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.ops.resample2d import resample2d as jax_resample2d
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


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
def test_plain_matches_jax_fp32(impl):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 16, 3).astype(np.float32)
    flow = mixed_flow(rng, 2, 8, 16)
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
