"""The port's layers against the JAX package's, one module at a time.

Each JAX module's variable shapes come from ``jax.eval_shape`` of its
init; the values are drawn with numpy from a seed (non-trivial running
statistics, unit ``u`` vectors), applied on the JAX side and carried
into the port through ``bridge.load_flax_variables``. Inputs are NHWC
numpy arrays; the port sees them as NCHW. Tolerance: atol 1e-5 (fp32,
different summation orders).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.layers import activation_norm as jan
from imaginaire_tpu.layers import conv as jconv
from imaginaire_tpu.layers import residual as jres
from imaginaire_tpu.layers.nonlinearity import apply_nonlinearity as j_nonlin
from imaginaire_tpu.layers.weight_norm import power_iteration as j_power_iteration
from imaginaire_tpu.utils.model_average import collapse_spectral_norm as j_collapse
from imaginaire_tpu_torch.bridge import load_flax_variables
from imaginaire_tpu_torch.layers import activation_norm as tan
from imaginaire_tpu_torch.layers.conv import Conv2dBlock, LinearBlock
from imaginaire_tpu_torch.layers.nonlinearity import VALID, apply_nonlinearity
from imaginaire_tpu_torch.layers.residual import Res2dBlock
from imaginaire_tpu_torch.layers.weight_norm import power_iteration
from imaginaire_tpu_torch.utils import misc
from imaginaire_tpu_torch.utils.init_weight import init_weights
from imaginaire_tpu_torch.utils.model_average import collapse_spectral_norm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs on one CPU thread: the suite runs several
    test processes at once, and intra-op threads of each would contend
    for the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ATOL = 1e-5


def random_variables(module, *args, seed=0, **kwargs):
    """Numpy-filled variables shaped like ``module.init(*args)``."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "u":
            u = rng.randn(*leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        scale = 1.0 if name in ("mean", "scale") else 0.2
        return (rng.randn(*leaf.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def run_both(jmod, tmod, inputs, jkw=None, seed=0):
    """Apply the JAX module (NHWC) and the bridged port module (NCHW)."""
    jargs = [jnp.asarray(a) for a in inputs]
    variables = random_variables(jmod, *jargs, seed=seed, **(jkw or {}))
    want = np.asarray(jmod.apply(variables, *jargs, **(jkw or {})))
    load_flax_variables(tmod, variables)
    targs = [nchw(a) if np.ndim(a) == 4 else torch.from_numpy(np.asarray(a))
             for a in inputs]
    with torch.no_grad():
        got = tmod.eval()(*targs)
    got = nhwc(got) if got.dim() == 4 else got.numpy()
    return got, want


def rand(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("padding_mode,order,norm", [
    ("zeros", "CNA", ""), ("reflect", "NAC", "instance"),
    ("zeros", "CNA", "sync_batch")])
def test_conv2d_block_spectral(padding_mode, order, norm):
    jmod = jconv.Conv2dBlock(8, kernel_size=3, padding_mode=padding_mode,
                             weight_norm_type="spectral",
                             activation_norm_type=norm,
                             nonlinearity="leakyrelu", order=order)
    tmod = Conv2dBlock(5, 8, kernel_size=3, padding_mode=padding_mode,
                       weight_norm_type="spectral", activation_norm_type=norm,
                       nonlinearity="leakyrelu", order=order)
    got, want = run_both(jmod, tmod, [rand(2, 12, 12, 5)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_linear_block_spectral():
    jmod = jconv.LinearBlock(6, weight_norm_type="spectral",
                             nonlinearity="relu", order="CAN")
    tmod = LinearBlock(10, 6, weight_norm_type="spectral", nonlinearity="relu",
                       order="CAN")
    got, want = run_both(jmod, tmod, [rand(3, 10)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_instance_norm_affine():
    got, want = run_both(jan.InstanceNorm(), tan.InstanceNorm(4),
                         [rand(2, 8, 8, 4) * 3 + 1])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_batch_norm_running_statistics():
    got, want = run_both(jan.BatchNorm(), tan.BatchNorm(4), [rand(2, 8, 8, 4)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_batch_norm_refuses_training_mode():
    """Training mode no longer refuses: it normalizes with the batch
    statistics, and moves the running ones (biased variance, momentum
    0.9) only when the owner's step advances its state."""
    from imaginaire_tpu_torch.layers.state import state_updates

    jmod, x = jan.BatchNorm(), rand(2, 8, 8, 4) * 2 + 0.5
    variables = random_variables(jmod, jnp.asarray(x))
    want, mut = jmod.apply(variables, jnp.asarray(x), training=True,
                           mutable=["batch_stats"])
    tmod = load_flax_variables(tan.BatchNorm(4), variables).train()
    kept = tmod.mean.clone()
    with torch.no_grad():
        got = tmod(nchw(x))
        assert torch.equal(tmod.mean, kept)  # not this network's step
        with state_updates(tmod, True):
            tmod(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=ATOL, rtol=0)
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tmod.mean.numpy(), np.asarray(stats["mean"]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tmod.var.numpy(), np.asarray(stats["var"]),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("base,separate", [("sync_batch", True),
                                           ("instance", False)])
def test_adaptive_norm_linear(base, separate):
    jmod = jan.AdaptiveNorm(base_norm=base, separate_projection=separate,
                            weight_norm_type="spectral")
    tmod = tan.AdaptiveNorm(4, 6, base_norm=base, separate_projection=separate,
                            weight_norm_type="spectral")
    got, want = run_both(jmod, tmod, [rand(2, 8, 8, 4), rand(2, 6, seed=2)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused,base,separate", [
    ("auto", "instance", True), ("none", "instance", False),
    ("auto", "sync_batch", True)])
def test_spatially_adaptive_norm(fused, base, separate):
    kw = dict(num_filters=5, kernel_size=3, base_norm=base,
              separate_projection=separate, weight_norm_type="spectral",
              fused_modulation=fused)
    jmod = jan.SpatiallyAdaptiveNorm(**kw)
    tmod = tan.SpatiallyAdaptiveNorm(6, [3, 2], **kw)
    # conditions at 2x and 4x x's size: the nearest downsizes are part of it
    got, want = run_both(jmod, tmod, [rand(2, 8, 8, 6), rand(2, 16, 16, 3, seed=2),
                                      rand(2, 32, 32, 2, seed=3)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_res2d_block_learned_shortcut_with_spade():
    anp = dict(num_filters=4, kernel_size=3, activation_norm_type="instance",
               separate_projection=True, weight_norm_type="spectral")
    kw = dict(kernel_size=3, padding=1, bias=[True, True, False],
              weight_norm_type="spectral",
              activation_norm_type="spatially_adaptive",
              nonlinearity="leakyrelu", order="NACNAC")
    jmod = jres.Res2dBlock(4, activation_norm_params=anp, **kw)
    tmod = Res2dBlock(6, 4, activation_norm_params=dict(anp, cond_dims=3), **kw)
    assert tmod.conv_s is not None
    got, want = run_both(jmod, tmod, [rand(2, 8, 8, 6), rand(2, 16, 16, 3, seed=2)])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", [k for k in VALID if k])
def test_nonlinearity(kind):
    x = rand(2, 4, 4, 3)
    want = np.asarray(j_nonlin(jnp.asarray(x), kind, prelu_alpha=0.25))
    got = apply_nonlinearity(nchw(x), kind, prelu_alpha=torch.tensor(0.25))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("method,src,dst", [
    ("nearest", 256, 16), ("nearest", 24, 48), ("cubic", 16, 32),
    ("cubic", 16, 64), ("cubic", 16, 16), ("bilinear", 64, 32),
    ("bilinear", 512, 4), ("bilinear", 16, 40)])
def test_resize_matches_jax_image_resize(method, src, dst):
    x = rand(1, src, src, 2)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, dst, dst, 2), method))
    fn = {"nearest": misc.resize_nearest, "cubic": misc.resize_cubic,
          "bilinear": misc.resize_bilinear}[method]
    np.testing.assert_allclose(nhwc(fn(nchw(x), (dst, dst))), want,
                               atol=1e-5, rtol=0)


def test_spectral_power_iteration_and_collapse():
    w = rand(7, 5)
    u = rand(7, seed=2)
    u /= np.linalg.norm(u)
    s_j, u_j = j_power_iteration(jnp.asarray(w), jnp.asarray(u))
    s_t, u_t = power_iteration(torch.from_numpy(w), torch.from_numpy(u))
    np.testing.assert_allclose(float(s_t), float(s_j), rtol=1e-6)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-6)

    jmod = jconv.Conv2dBlock(8, kernel_size=3, weight_norm_type="spectral")
    tmod = Conv2dBlock(5, 8, kernel_size=3, weight_norm_type="spectral")
    variables = random_variables(jmod, jnp.zeros((1, 6, 6, 5)))
    load_flax_variables(tmod, variables)
    want = np.asarray(j_collapse(variables["params"], variables["spectral"])
                      ["conv"]["kernel"]).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(collapse_spectral_norm(tmod)["conv.weight"].numpy(),
                               want, atol=1e-6, rtol=0)


def test_bridge_rejects_unmatched_and_leftover_leaves():
    jmod = jconv.LinearBlock(6, order="C")
    variables = random_variables(jmod, jnp.zeros((1, 4)))
    with pytest.raises(KeyError, match="unset"):
        load_flax_variables(LinearBlock(4, 6, order="C",
                                        weight_norm_type="spectral"), variables)
    extra = {"params": dict(variables["params"], stray=np.zeros(3, np.float32))}
    with pytest.raises(KeyError, match="stray"):
        load_flax_variables(LinearBlock(4, 6, order="C"), extra)
    with pytest.raises(ValueError, match="shape"):
        load_flax_variables(LinearBlock(5, 6, order="C"), variables)


def test_init_weights_xavier_distribution():
    conv = Conv2dBlock(64, 32, kernel_size=3, order="C")
    init_weights(conv, torch.Generator().manual_seed(0), "xavier", 0.02)
    fan_in, fan_out = 64 * 9, 32 * 9
    std = 0.02 * np.sqrt(2.0 / (fan_in + fan_out))
    assert abs(conv.conv.weight.std().item() / std - 1.0) < 0.05
    assert conv.conv.bias.abs().max().item() == 0.0
