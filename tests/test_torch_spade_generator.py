"""The port's SPADE generator against the JAX package's, whole.

Both the unit-test config and the COCO-Stuff config (with the serving
slice's ``instance`` base-norm override, 185 label channels) are cut to
small widths; the structure (kernel sizes, projections, spectral norms,
BatchNorm AdaIN blocks, positional encoding) is the config's. Weights
are numpy-drawn into the JAX variable shapes and bridged; the style code
z is injected on both sides by calling the JAX ``spade_generator``
submodule directly. Tolerance: atol 1e-4 over the tanh output (fp32,
~20 layers of differently ordered sums).
"""

from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.models.generators.spade import Generator as JaxGenerator
from imaginaire_tpu.models.generators.spade import StyleEncoder as JaxStyleEncoder
from imaginaire_tpu.trainers.spade import Trainer as JaxTrainer
from imaginaire_tpu_torch.bridge import load_flax_variables
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.models.generators.spade import Generator, StyleEncoder
from imaginaire_tpu_torch.trainers.spade import Trainer
from imaginaire_tpu_torch.utils.init_weight import init_weights


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs on one CPU thread: the suite runs several
    test processes at once, and intra-op threads of each would contend
    for the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


UNIT = "configs/unit_test/spade.yaml"
COCO = "configs/projects/spade/cocostuff/base128_bs4.yaml"
SMALL = dict(num_filters=8, style_dims=16, style_enc=dict(num_filters=4),
             activation_norm_params=dict(num_filters=8))
OVERRIDES = {
    UNIT: dict(gen=SMALL),
    COCO: dict(gen=dict(SMALL, activation_norm_params=dict(
        num_filters=8, activation_norm_type="instance"))),
}


# the same functions, compiled with less optimization (CPU compile time)
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}

# label maps of 64x64: the 256 ladder's least input with every level
# above 1x1 (its 16x16 start runs at 4x4)
LABEL_HW = 64


def random_variables(shapes, seed=0):
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "u":
            u = rng.randn(*leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def one_hot_labels(n, channels, hw=256, seed=1):
    idx = np.random.RandomState(seed).randint(0, channels, (n, hw, hw))
    return np.eye(channels, dtype=np.float32)[idx]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("path", [UNIT, COCO])
def test_spade_generator_matches_jax(path):
    jcfg = JaxConfig(path, overrides=OVERRIDES[path])
    tcfg = Config(path, overrides=OVERRIDES[path])
    jnet = JaxGenerator(jcfg.gen, jcfg.data)
    tnet = Generator(tcfg.gen, tcfg.data).eval()
    num_labels = tnet.spade_generator.head_0.conv.weight.shape[1] - (
        2 if tnet.spade_generator.use_posenc_in_input_layer else 0)
    assert num_labels == (185 if path == COCO else 14)
    seg = one_hot_labels(2 if path == UNIT else 1, num_labels, hw=LABEL_HW)
    z = np.random.RandomState(2).randn(seg.shape[0], 16).astype(np.float32)
    shapes = jax.eval_shape(lambda: jnet.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        {"label": jnp.asarray(seg), "images": jnp.zeros(seg.shape[:3] + (3,))},
        training=True))
    variables = random_variables(shapes)
    assert ("batch_stats" in variables) == (path == COCO)  # BN AdaIN blocks

    want = np.asarray(jax.jit(lambda v, s, zz: jnet.apply(
        v, s, zz, method=lambda m, s_, z_: m.spade_generator(
            s_, z_, training=False))["fake_images"], compiler_options=CHEAP)(
        variables, jnp.asarray(seg), jnp.asarray(z)))
    load_flax_variables(tnet, variables)
    with torch.no_grad():
        got = tnet.spade_generator(nchw(seg), torch.from_numpy(z))["fake_images"]
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == seg.shape[:3] + (3,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_style_encoder_matches_jax():
    jenc = JaxStyleEncoder(num_filters=4, kernel_size=3, style_dims=8)
    tenc = StyleEncoder(image_channels=3, num_filters=4, kernel_size=3,
                        style_dims=8).eval()
    images = np.random.RandomState(3).randn(2, 256, 256, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    variables = random_variables(jax.eval_shape(
        lambda: jenc.init({"params": key}, jnp.asarray(images), rng=key)))
    want = jax.jit(lambda v, x: jenc.apply(v, x, rng=key), compiler_options=CHEAP)(
        variables, jnp.asarray(images))
    eps = np.array(jax.random.normal(key, (2, 8)))  # the draw JAX made
    load_flax_variables(tenc, variables)
    with torch.no_grad():
        got = tenc(nchw(images), torch.from_numpy(eps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("size", [512, 1024])
def test_high_resolution_ladders_sum_their_heads(size):
    cfg = Config(UNIT, overrides=dict(gen=dict(
        num_filters=2, style_dims=4, style_enc=dict(num_filters=2),
        activation_norm_params=dict(num_filters=2))))
    cfg.data.train.augmentations.random_crop_h_w = f"{size}, {size}"
    net = Generator(cfg.gen, cfg.data).eval()
    names = {n.split(".")[1] for n, _ in net.named_parameters()
             if n.startswith("spade_generator.")}
    assert {"conv_img256", "conv_img512"} <= names
    assert ("conv_img1024" in names) == (size == 1024)
    init_weights(net, torch.Generator().manual_seed(0))
    seg = torch.from_numpy(one_hot_labels(1, 14, hw=size)).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = net.inference({"label": seg.contiguous()}, random_style=True,
                            generator=torch.Generator().manual_seed(1))
    assert out.shape == (1, 3, size, size) and torch.isfinite(out).all()


def test_expand_labels_and_resize_data_match_jax():
    jcfg = JaxConfig(UNIT, overrides=OVERRIDES[UNIT])
    trainer = Trainer(Config(UNIT, overrides=OVERRIDES[UNIT]), device="cpu")
    jself = SimpleNamespace(cfg=jcfg, compute_dtype=jnp.float32, base=trainer.base)
    rng = np.random.RandomState(4)
    label = rng.randint(0, 13, (2, 8, 8)).astype(np.int32)
    edge = rng.rand(2, 8, 8, 1).astype(np.float32)
    want = np.asarray(JaxTrainer._expand_labels(
        jself, {"label": jnp.asarray(label), "label_float": jnp.asarray(edge)})["label"])
    got = trainer._expand_labels({"label": torch.from_numpy(label),
                                  "label_float": nchw(edge)})
    assert "label_float" not in got
    np.testing.assert_array_equal(got["label"].permute(0, 2, 3, 1).numpy(), want)

    data = {"label": np.zeros((1, 250, 270, 3)), "images": np.zeros((1, 250, 270, 3))}
    want = JaxTrainer._resize_data(jself, data)
    got = trainer._resize_data(data)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}


def test_trainer_fresh_weights_and_averaged_inference_params():
    cfg = Config(COCO, overrides=OVERRIDES[COCO])
    trainer = Trainer(cfg, device="cpu")
    assert trainer.model_average  # the COCO-Stuff recipe averages weights
    trainer.init_state(seed=3)
    params = trainer.inference_params()
    net = trainer.net_G
    # the averaged copy holds sigma-collapsed kernels; the module's own
    # spectral norm then divides by ~1, so both forwards agree
    w = net.spade_generator.head_0.conv.weight
    assert not torch.equal(params["spade_generator.head_0.conv.weight"], w)
    seg = nchw(one_hot_labels(1, 185, hw=LABEL_HW, seed=5))
    noise = torch.randn(1, 16, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        live = net.inference({"label": seg}, random_style=True, noise=noise)
        avg = torch.func.functional_call(
            net, params, ({"label": seg},),
            {"random_style": True, "noise": noise})["fake_images"]
    np.testing.assert_allclose(avg.numpy(), live.numpy(), atol=1e-4, rtol=0)
    again = Trainer(cfg, device="cpu")
    again.init_state(seed=3)
    assert torch.equal(again.net_G.spade_generator.head_0.conv.weight, w)
