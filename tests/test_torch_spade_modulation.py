"""The port's fused SPADE modulation against the JAX package's op.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it on the CPU: the 'jnp' composition
and the Pallas kernel in interpret mode ('pallas_interpret', at <= 32^2
spatial). On the CPU the port's wrapper takes its plain version; the
CUDA kernel is held to that plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: fp32 atol 1e-5 (the two packages reduce the statistics in a
different order); bf16 2e-2 of the output's max magnitude (a few bf16
roundings, which the two frameworks place differently).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.ops.spade_modulation import spade_modulation as jax_spade_modulation
from imaginaire_tpu_torch.ops import build
from imaginaire_tpu_torch.ops import spade_modulation as spade_mod

SHAPES = [((2, 16, 16, 8), 1), ((2, 32, 32, 4), 2)]  # NHWC, n_pairs


def _case(shape, n_pairs, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    gs = [(rng.randn(*shape) * 0.3).astype(np.float32) for _ in range(n_pairs)]
    bs = [(rng.randn(*shape) * 0.3).astype(np.float32) for _ in range(n_pairs)]
    return x, gs, bs


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape,n_pairs", SHAPES)
def test_plain_matches_jax_fp32(impl, shape, n_pairs):
    x, gs, bs = _case(shape, n_pairs)
    want = np.asarray(jax_spade_modulation(
        jnp.asarray(x), [jnp.asarray(g) for g in gs],
        [jnp.asarray(b) for b in bs], implementation=impl))
    got = spade_mod.spade_modulation(_nchw(x), [_nchw(g) for g in gs],
                                     [_nchw(b) for b in bs])
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape,n_pairs", SHAPES)
def test_plain_matches_jax_bf16(impl, shape, n_pairs):
    x, gs, bs = _case(shape, n_pairs, seed=1)
    bf = jnp.bfloat16
    want = np.asarray(jax_spade_modulation(
        jnp.asarray(x, bf), [jnp.asarray(g, bf) for g in gs],
        [jnp.asarray(b, bf) for b in bs], implementation=impl)).astype(np.float32)
    got = spade_mod.spade_modulation(
        _nchw(x, torch.bfloat16), [_nchw(g, torch.bfloat16) for g in gs],
        [_nchw(b, torch.bfloat16) for b in bs])
    assert got.dtype == torch.bfloat16
    err = np.abs(_nhwc(got) - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    x, gs, bs = _case((1, 8, 8, 3), 2)
    before = spade_mod.launches
    args = (_nchw(x), [_nchw(g) for g in gs], [_nchw(b) for b in bs])
    got = spade_mod.spade_modulation(*args)
    assert torch.equal(got, spade_mod.spade_modulation_plain(*args))
    assert spade_mod.launches == before


@pytest.mark.parametrize("bad", ["shape", "count", "empty", "rank"])
def test_wrapper_rejects_malformed_inputs(bad):
    x = torch.zeros(1, 2, 4, 4)
    g = [torch.zeros(1, 2, 4, 4)]
    b = [torch.zeros(1, 2, 4, 4)]
    if bad == "shape":
        g = [torch.zeros(1, 2, 1, 1)]  # AdaIN-style broadcast maps refuse
    elif bad == "count":
        b = b * 2
    elif bad == "empty":
        g, b = [], []
    else:
        x = torch.zeros(2, 4, 4)
    with pytest.raises(ValueError):
        spade_mod.spade_modulation(x, g, b)


def test_kernel_source_and_build_command():
    src = build.source_path(spade_mod.KERNEL).read_text()
    assert int(re.search(r"#define SPADE_MAX_PAIRS (\d+)", src).group(1)) \
        == spade_mod.MAX_PAIRS
    assert "spade_modulation_fwd_pallas" in src  # names the TPU kernel it replaces
    cmd = build.nvcc_command("nvcc", "k.cu", "k.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in cmd
    lib = build.library_path(spade_mod.KERNEL)
    assert lib.parent == build.BUILD_DIR and lib.suffix == ".so"


def test_build_reports_missing_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    if (build.Path("/usr/local/cuda/bin/nvcc")).is_file():
        assert build.find_nvcc() == "/usr/local/cuda/bin/nvcc"
    else:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build_all([spade_mod.KERNEL])
        assert not (tmp_path / "build").exists() or not any(
            (tmp_path / "build").glob("*.so"))
    with pytest.raises(FileNotFoundError):
        build.build_all(["no_such_kernel"])
