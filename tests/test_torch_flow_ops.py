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
    n_d = 2 * (md // s2) + 1
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


def test_correlation_indivisible_displacement_is_refused():
    """At max_displacement 5, stride2 2 the JAX package's versions
    disagree: the jnp grid ``arange(-5, 6, 2)`` has 6 steps (-5 .. 5),
    the Pallas kernel takes 2 (5 // 2) + 1 = 5 steps from -5 (-5 .. 3).
    There is no one answer to port, so the port refuses the case."""
    rng = np.random.RandomState(6)
    x1 = rng.randn(1, 6, 6, 3).astype(np.float32)
    x2 = rng.randn(1, 6, 6, 3).astype(np.float32)
    kw = dict(pad_size=5, max_displacement=5, stride2=2)
    scan = jax_correlation(jnp.asarray(x1), jnp.asarray(x2),
                           implementation="jnp", **kw)
    pallas = jax_correlation(jnp.asarray(x1), jnp.asarray(x2),
                             implementation="pallas_interpret", **kw)
    assert scan.shape[-1] == 36 and pallas.shape[-1] == 25
    for fn in (corr.correlation, corr.correlation_plain):
        with pytest.raises(NotImplementedError):
            fn(nchw(x1), nchw(x2), **kw)


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
