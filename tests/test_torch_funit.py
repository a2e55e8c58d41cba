"""FUNIT and COCO-FUNIT modules of the port against the JAX package's, on
the CPU: the up-residual block, RMSprop, the rotation augmentation, the
few-shot class dataset and the class-conditional one, both generators,
the projection discriminator, flax's own draws of the class embedding
and the universal style bias, and the full-width trees (the trainer is in
``test_torch_funit_training.py``).

The unit configs (``configs/unit_test/{funit,coco_funit}.yaml``) at
64x64 on ``tests/fixtures/fewshot/raw``, weights numpy-drawn into
``jax.eval_shape`` shapes and bridged (kernels at 1/sqrt(fan_in), unit
``u``, conv biases at zero: an instance norm follows most of them), each
JAX forward one jitted program with XLA's cheap CPU options.

Tolerances:
- RMSprop: rtol 1e-6 over three updates;
- ``rotate`` against ``cv2.warpAffine``, and dataset items against the
  JAX package's (which rotates and resizes with OpenCV): within one
  8-bit level (2/255 after the [-1, 1] normalisation), with under 1e-3
  of the elements off; keys, labels and ``is_flipped`` exact;
- forwards (the residual blocks, both generators, the discriminator's
  logits and pooled features): relative L2 1e-5, ``u`` atol 1e-5;
- the draws: the embedding's standard deviation within 2% of the JAX
  draw's and its share beyond two standard deviations within 2e-3,
  ``usb``'s standard deviation within 10% (1024 draws);
- parameter counts: exact.
"""

import random

import cv2
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.data.images import Dataset as JaxImages
from imaginaire_tpu.data.unpaired_few_shot_images import Dataset as JaxFewShot
from imaginaire_tpu.layers import Res2dBlock as JaxRes2dBlock
from imaginaire_tpu.layers import UpRes2dBlock as JaxUpRes2dBlock
from imaginaire_tpu.registry import resolve as jax_resolve
from imaginaire_tpu_torch.bridge import load_flax_variables, load_jax_state, to_port_layout
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.augment import Augmentor, rotate
from imaginaire_tpu_torch.data.backends import build_packed_dataset
from imaginaire_tpu_torch.data.images import Dataset as Images
from imaginaire_tpu_torch.data.unpaired_few_shot_images import Dataset as FewShot
from imaginaire_tpu_torch.layers import Res2dBlock, UpRes2dBlock
from imaginaire_tpu_torch.layers.state import state_updates
from imaginaire_tpu_torch.models.discriminators.funit import Embed
from imaginaire_tpu_torch.models.generators.coco_funit import COCOFUNITTranslator
from imaginaire_tpu_torch.optim.optimizers import get_optimizer_for_params
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.serving.engine import ServingError, engine_from_config

FUNIT = "configs/unit_test/funit.yaml"
COCO = "configs/unit_test/coco_funit.yaml"
FIXTURES = "tests/fixtures/fewshot/raw"
FUNIT_119 = "configs/projects/funit/animal_faces/base64_bs8_class119.yaml"
COCO_119 = "configs/projects/coco_funit/animal_faces/base64_bs8_class119.yaml"
COCO_305 = "configs/projects/coco_funit/mammals/base64_bs8_class305.yaml"
HW, B = 64, 2
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
TOL_FWD = 1e-5
ONE_LEVEL = 2.0 / 255 + 1e-6
# a crop, a rotation and a flip drawn per type (the mammals config's
# chain, cut to the fixture's size)
AUGMENTED = {"data": {"train": {"augmentations": {"resize_h_w": "72, 80", "rotate": 4,
                                                  "random_crop_h_w": "64, 64",
                                                  "horizontal_flip": True}},
                      "val": {"augmentations": {"resize_h_w": "64, 64"}}}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cheap_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=CHEAP)


def draw(shapes, seed=0):
    """Kernels at 1/sqrt(fan_in), unit ``u``, conv biases at zero, the
    other leaves small or at unit scale (``usb``)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "u":
            u = rng.standard_normal(leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if path[-1].key == "bias":
            scale = 0.0 if path[-2].key == "conv" else 0.1
            return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)
        if path[-1].key in ("usb", "embedding"):
            return (rng.standard_normal(leaf.shape) / 4).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 4
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def batch(seed, b=B, hw=HW, num_classes=3):
    rng = np.random.RandomState(seed)
    out = {k: rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
           for k in ("images_content", "images_style")}
    out.update(labels_content=rng.randint(0, num_classes, b).astype(np.int32),
               labels_style=rng.randint(0, num_classes, b).astype(np.int32))
    return out


def to_port(data):
    return {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2) if v.ndim == 4
                                                     else v)) for k, v in data.items()}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def g_init_shapes(net, data):
    return jax.eval_shape(lambda d: net.init(jax.random.PRNGKey(0), d, training=True), data)


def d_init_shapes(net, data, out):
    return jax.eval_shape(lambda d, o: net.init(jax.random.PRNGKey(0), d, o, recon=True,
                                                training=True), data, out)


def check_u(net, mut):
    buffers = dict(net.named_buffers())
    u = to_port_layout(net, mut["spectral"])
    assert u and set(u) == set(buffers)
    for name, value in u.items():
        np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------- the layers


@pytest.mark.parametrize("kind", ["up_adain", "res_plain"])
def test_residual_blocks_with_the_new_flags_match_jax(kind):
    """FUNIT's decoder block (the 2x up-residual, kernel 5, reflect, the
    hidden width the output's, the nonlinearity on the AdaIN shortcut),
    and a plain residual block with both flags and a learned shortcut."""
    rng = np.random.RandomState(1)
    x = rng.randn(B, 6, 8, 8).astype(np.float32).transpose(0, 2, 3, 1)
    flags = dict(hidden_channels_equal_out_channels=True, skip_nonlinearity=True,
                 nonlinearity="relu", padding_mode="reflect")
    if kind == "up_adain":
        style = rng.randn(B, 5).astype(np.float32)
        jblock = JaxUpRes2dBlock(out_channels=4, kernel_size=5, padding=2,
                                 activation_norm_type="adaptive",
                                 activation_norm_params=dict(base_norm="instance"), **flags)
        block = UpRes2dBlock(6, 4, kernel_size=5, padding=2, activation_norm_type="adaptive",
                             activation_norm_params={"cond_dims": 5}, **flags)
        args = (x, style)
    else:
        jblock = JaxRes2dBlock(out_channels=9, order="NACNAC", **flags)
        block = Res2dBlock(6, 9, order="NACNAC", **flags)
        args = (x,)
    variables = draw(jax.eval_shape(lambda *a: jblock.init(jax.random.PRNGKey(0), *a),
                                    *args), 3)
    want = cheap_jit(lambda v, *a: jblock.apply(v, *a), variables, *args)(variables, *args)
    load_flax_variables(block, variables)
    assert block.conv_0.conv.weight.shape[0] == block.conv_1.conv.weight.shape[0]
    with torch.no_grad():
        got = block(nchw(x), *[torch.from_numpy(a) for a in args[1:]])
    assert got.shape[2] == (16 if kind == "up_adain" else 8)
    assert rel_l2(nhwc(got), np.asarray(want)) <= TOL_FWD


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_rmsprop_matches_optax(weight_decay):
    """Three updates of the unit configs' optimizer (decay 0.9, eps in the
    square root, no bias correction) under a step lr policy, with and
    without ``add_decayed_weights``."""
    import optax

    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    cfg = {"type": "rmsprop", "lr": 1e-3, "weight_decay": weight_decay,
           "lr_policy": {"iteration_mode": True, "type": "step", "step_size": 2,
                         "gamma": 0.5}}
    tx = optax.rmsprop(learning_rate=lambda step: 1e-3 * 0.5 ** (step // 2), eps=1e-8)
    if weight_decay:
        tx = optax.chain(optax.add_decayed_weights(weight_decay), tx)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = get_optimizer_for_params(cfg, tparams)
    for step in range(3):
        scale = 1e-5 if step == 1 else 0.1  # below and above sqrt(eps)
        grads = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(tparams, ("a", "b")):
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for p, k in zip(tparams, ("a", "b")):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=0)
    assert opt.count == 3 and opt.mu == [] and len(opt.nu) == 2


@pytest.mark.parametrize("hw,channels", [((64, 64), 3), ((270, 270), 3), ((37, 53), 1)])
def test_rotate_matches_opencv(hw, channels):
    """Angles across the mammals config's +-4 degrees (and 30): within one
    level of ``cv2.warpAffine`` about the centre, constant-0 border."""
    rng = np.random.RandomState(hw[0])
    h, w = hw
    img = (rng.rand(h, w, channels) * 255).astype(np.uint8)
    off = total = 0
    for angle in list(rng.uniform(-4, 4, 4)) + [30.0]:
        want = cv2.warpAffine(img, cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0),
                              (w, h), flags=cv2.INTER_LINEAR).reshape(img.shape)
        got = rotate(img, angle, "BILINEAR")
        assert got.dtype == np.uint8 and got.shape == img.shape
        diff = np.abs(got.astype(np.int32) - want)
        assert diff.max() <= 1, angle
        off += int((diff > 0).sum())
        total += diff.size
    assert off <= 1e-3 * total
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rotate(img, 1.0, "NEAREST")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Augmentor({"rotate": 4}, keypoint_data_types=["landmarks"])


# ---------------------------------------------------------------- the data


@pytest.fixture(scope="module")
def fewshot_sets(tmp_path_factory):
    """{backend: (JAX config, port config)} on the fixture's folders and
    on a pack of them built by the port."""
    packed = str(tmp_path_factory.mktemp("fewshot") / "packed")
    build_packed_dataset(FIXTURES, packed, ["images_content", "images_style"])
    out = {}
    for backend, root in (("folder", FIXTURES), ("packed", packed)):
        over = {"data": {split: dict(AUGMENTED["data"][split], roots=[root],
                                     is_packed=backend == "packed")
                         for split in ("train", "val")}}
        out[backend] = (JaxConfig(FUNIT, overrides=over), Config(FUNIT, overrides=over))
    return out


def check_item(got, want, types, stats):
    assert set(got) == set(want) and got["key"] == want["key"]
    np.testing.assert_array_equal(got["is_flipped"], want["is_flipped"])
    for k in got:
        if k.startswith("labels"):
            assert got[k].dtype == np.int32 and got[k] == want[k], k
    for t in types:
        assert got[t].shape == want[t].shape == (HW, HW, 3)
        diff = np.abs(got[t] - np.asarray(want[t]))
        assert diff.max() <= ONE_LEVEL, t
        stats[0] += int((diff > 1e-6).sum())
        stats[1] += diff.size


@pytest.mark.parametrize("backend", ["folder", "packed"])
@pytest.mark.parametrize("split,seed", [("train", 0), ("train", 1), ("val", None)])
def test_fewshot_items_match_jax_with_injected_draws(fewshot_sets, backend, split, seed):
    """Every item of the split (the validation split pinned to each style
    class in turn): the JAX draws from ``random.seed(s)``, the port's from
    ``random.Random(s)``, so each type's file, resize, rotation, crop and
    flip agree."""
    jcfg, cfg = fewshot_sets[backend]
    inference = split == "val"
    jds, ds = JaxFewShot(jcfg, is_inference=inference), FewShot(cfg, is_inference=inference)
    assert ds.class_name_to_idx == jds.class_name_to_idx
    assert (ds.num_content_classes, ds.num_style_classes) == (2, 3)
    pins = range(ds.num_style_classes) if inference else [None]
    stats = [0, 0]
    for pin in pins:
        ds.set_sample_class_idx(pin)
        jds.set_sample_class_idx(pin)
        assert len(ds) == len(jds) > 0
        for index in range(len(ds)):
            s = 17 * (seed or 0) + index
            random.seed(s)
            want = jds[index]
            ds.item_rng = lambda i, s=s: random.Random(s)
            got = ds[index]
            if pin is not None:
                assert got["labels_style"] == pin
            check_item(got, want, ("images_content", "images_style"), stats)
    assert stats[0] <= 1e-3 * stats[1]


def test_set_sample_class_idx():
    """Pinning a style class: the length is the class's style files, item
    i takes content file i and the class's style file i (each modulo its
    pool), the labels follow; unpinning restores the larger pool's
    length; an unpinned inference item draws from its own generator."""
    ds = FewShot(Config(FUNIT), is_inference=True)
    content = ds.items["images_content"]
    assert len(ds) == max(len(content), len(ds.items["images_style"]))
    for cls, pool in ds.items_by_class["images_style"].items():
        ds.set_sample_class_idx(cls)
        assert len(ds) == len(pool)
        for i in range(len(pool) + 1):
            item = ds[i]
            c, s = content[i % len(content)], pool[i % len(pool)]
            assert item["key"] == f"{c[1]}/{c[2]}|{s[1]}/{s[2]}"
            assert item["labels_style"] == cls
            assert item["labels_content"] == ds.class_name_to_idx["images_content"][c[3]]
    ds.set_sample_class_idx(None)
    assert len(ds) == max(len(v) for v in ds.items.values())
    keys = set()
    for epoch in range(6):
        ds.reseed(0, epoch)
        keys.add(ds[0]["key"])
    assert len(keys) > 1


@pytest.mark.parametrize("split", ["train", "val"])
def test_class_image_items_match_jax(split):
    """The class-conditional dataset on the fixture's content classes:
    the items (a class pinned for the validation split), labels and
    keys."""
    over = {"data": {"type": "imaginaire_tpu.data.images",
                     "input_types": [{"images_content": {
                         "ext": "jpg", "num_channels": 3, "interpolator": "BILINEAR",
                         "normalize": True}}], **AUGMENTED["data"]}}
    inference = split == "val"
    jds = JaxImages(JaxConfig(FUNIT, overrides=over), is_inference=inference)
    ds = Images(Config(FUNIT, overrides=over), is_inference=inference)
    assert ds.class_name_to_idx == jds.class_name_to_idx == {"cat": 0, "dog": 1}
    stats = [0, 0]
    for pin in ([1] if inference else [None]):
        ds.set_sample_class_idx(pin)
        jds.set_sample_class_idx(pin)
        assert len(ds) == len(jds) == (2 if inference else 4)
        for index in range(len(ds)):
            random.seed(index)
            want = jds[index]
            ds.item_rng = lambda i, s=index: random.Random(s)
            got = ds[index]
            check_item(got, want, ("images_content",), stats)
    assert stats[0] <= 1e-3 * stats[1]


# ------------------------------------------------------------ generators


@pytest.fixture(scope="module")
def generators():
    """{config: (JAX net, drawn variables, port net)}."""
    out = {}
    for path, seed in ((FUNIT, 1), (COCO, 2)):
        jcfg = JaxConfig(path)
        jnet = jax_resolve(jcfg.gen.type, "Generator")(jcfg.gen, jcfg.data)
        variables = draw(g_init_shapes(jnet, batch(0)), seed)
        cfg = Config(path)
        net = load_flax_variables(resolve(cfg.gen.type, "Generator")(cfg.gen, cfg.data),
                                  variables)
        out[path] = (jnet, variables, net)
    return out


@pytest.mark.parametrize("config", [FUNIT, COCO])
def test_generator_training_forward_and_inference_match_jax(generators, config):
    """``images_trans`` and ``images_recon`` of the training forward, and
    ``inference`` (with ``keep_original_size``: no ``original_h_w``, no
    resize)."""
    jnet, variables, net = generators[config]
    data = batch(7)
    want = cheap_jit(lambda v, d: jnet.apply(v, d, training=True), variables, data)(
        variables, data)
    want_inf = cheap_jit(lambda v, d: jnet.apply(v, d, keep_original_size=True,
                                                 method=jnet.inference),
                         variables, data)(variables, data)
    with torch.no_grad():
        got = net(to_port(data))
        got_inf = net.inference(to_port(data), keep_original_size=True)
    assert set(got) == set(want) == {"images_trans", "images_recon"}
    for k in want:
        assert rel_l2(nhwc(got[k]), np.asarray(want[k])) <= TOL_FWD, k
    assert rel_l2(nhwc(got_inf), np.asarray(want_inf)) <= TOL_FWD
    if config == COCO:
        assert tuple(net.generator.usb.shape) == (1, 32)


def test_bridge_loads_the_averaged_copy(generators):
    """``load_jax_state`` fills COCO-FUNIT's G (its ``usb`` too) and the
    averaged copy (``ema_G``, G's params tree) of a trainer that
    averages."""
    _, variables, _ = generators[COCO]
    ema = jax.tree_util.tree_map(lambda a: a * 0.5, variables["params"])
    cfg = Config(COCO, overrides={"trainer": {"model_average": True}})
    trainer = resolve(cfg.trainer.type, "Trainer")(cfg, device="cpu")
    trainer.init_state(seed=0)
    load_jax_state(trainer, {"vars_G": variables, "ema_G": ema})
    want = to_port_layout(trainer.net_G, ema)
    assert set(want) == set(trainer.ema_G) and "generator.usb" in want
    for name, value in want.items():
        np.testing.assert_array_equal(trainer.ema_G[name].numpy(), value)
    np.testing.assert_array_equal(trainer.net_G.generator.usb.detach().numpy(),
                                  np.asarray(variables["params"]["generator"]["usb"]))


# ---------------------------------------------------------- discriminator


def test_projection_discriminator_matches_jax():
    """The spectral-normed D of the unit config on the translation, the
    real style image and the reconstruction: the projected logits, the
    pooled features and each ``u`` after the forward (three power steps,
    one a call); without labels the model returns the pooled features
alone."""
    over = {"dis": {"weight_norm_type": "spectral"}}
    jcfg, cfg = JaxConfig(FUNIT, overrides=over), Config(FUNIT, overrides=over)
    jnet = jax_resolve(jcfg.dis.type, "Discriminator")(jcfg.dis, jcfg.data)
    data = batch(11)
    g_out = {"images_trans": batch(12)["images_content"],
             "images_recon": batch(13)["images_style"]}
    variables = draw(d_init_shapes(jnet, data, g_out), 3)
    want, mut = cheap_jit(lambda v, d, o: jnet.apply(
        v, d, o, recon=True, training=True, mutable=["spectral"]), variables, data, g_out)(
        variables, data, g_out)
    net = resolve(cfg.dis.type, "Discriminator")(cfg.dis, cfg.data)
    load_flax_variables(net, variables)
    names = {n.split(".")[1] for n, _ in net.named_parameters()}
    assert names == {"conv_in", "res_0_0", "res_0_1", "res_1_0", "res_1_1", "res_2_0",
                     "res_2_1", "classifier", "embedder"}
    net.train()
    with state_updates(net, True):
        got = net(to_port(data), to_port(g_out), recon=True)
    net.eval()
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = got[k].detach().numpy(), np.asarray(w)
        if g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        assert g.shape == w.shape and rel_l2(g, w) <= TOL_FWD, k
    assert got["fake_out_trans"].shape == (B, 1, 16, 16)
    check_u(net, mut)
    with torch.no_grad():
        feats = net.model(nchw(g_out["images_trans"]))
        _, labelled = net.model(nchw(g_out["images_trans"]), torch.zeros(B, dtype=torch.int32))
    assert feats.shape == (B, 32) and torch.equal(feats, labelled)


def test_flax_drawn_leaves_match_jax_statistics():
    """The mammals D's class embedding (305 x 1024, flax's ``Embed``
    default: an untruncated normal of variance 1 / features) and
    COCO-FUNIT's ``usb`` (flax's ``normal(1.0)``): the port's draws
    against the JAX draws (their spread and their tails)."""
    import flax.linen as fnn

    generator = torch.Generator().manual_seed(0)
    emb = Embed(305, 1024)
    emb.draw_own_init(generator)
    want = np.asarray(fnn.Embed(305, 1024).init(jax.random.PRNGKey(0),
                                                jnp.zeros((1,), jnp.int32))["params"]["embedding"])
    got = emb.embedding.detach().numpy()
    assert got.shape == want.shape
    assert abs(got.std() / want.std() - 1) <= 0.02 and abs(got.mean()) <= 1e-3
    # untruncated: beyond two standard deviations as often in both
    tails = [float((np.abs(a) > 2 / 32).mean()) for a in (got, want)]
    assert abs(tails[0] - tails[1]) <= 2e-3 and tails[1] > 0.04
    translator = COCOFUNITTranslator(Config(COCO_305).gen)
    translator.draw_own_init(generator)
    usb = translator.usb.detach().numpy()
    want_usb = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 1024)))
    assert abs(usb.std() / want_usb.std() - 1) <= 0.1 and abs(usb.mean()) <= 0.15


# --------------------------------------------------- the full-width trees


@pytest.mark.parametrize("config,counts", [(FUNIT_119, (120_987_203, 92_008_257)),
                                           (COCO_119, (121_562_307, 92_008_257)),
                                           (COCO_305, (121_562_307, 92_198_721))])
def test_full_width_trees_match_jax(config, counts):
    """The committed configs at 256x256: the JAX ``init`` trees traced
    with ``jax.eval_shape`` load path for path into port networks built
    on the meta device, leaving nothing unset."""
    jcfg, cfg = JaxConfig(config), Config(config)
    shape = jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32)
    label = jax.ShapeDtypeStruct((1,), jnp.int32)
    data = {"images_content": shape, "images_style": shape,
            "labels_content": label, "labels_style": label}
    jgen = jax_resolve(jcfg.gen.type, "Generator")(jcfg.gen, jcfg.data)
    jdis = jax_resolve(jcfg.dis.type, "Discriminator")(jcfg.dis, jcfg.data)
    trees = {"gen": g_init_shapes(jgen, data),
             "dis": d_init_shapes(jdis, data, {"images_trans": shape,
                                               "images_recon": shape})}
    got = []
    for kind, shapes in trees.items():
        cls = resolve(cfg[kind].type, "Generator" if kind == "gen" else "Discriminator")
        with torch.device("meta"):
            net = cls(cfg[kind], cfg.data)
        zeros = jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
        load_flax_variables(net, zeros)
        got.append(sum(p.numel() for p in net.parameters()))
        assert got[-1] == sum(int(np.prod(s.shape)) for s in
                              jax.tree_util.tree_leaves(shapes["params"]))
    assert tuple(got) == counts


# ------------------------------------------------- the rest of the family


def test_default_config_modules_and_the_engine():
    """The default config's no-op G and D own nothing and return empty
    dicts; the four FUNIT types resolve to the port; the serving engine,
    which serves label-to-image requests, refuses FUNIT (ROADMAP.md
    A.5)."""
    for kind, attr in (("generators", "Generator"), ("discriminators", "Discriminator")):
        cls = resolve(f"imaginaire_tpu.models.{kind}.dummy", attr)
        net = cls(None, None)
        assert not list(net.parameters())
        assert (net({}) if kind == "generators" else net({}, {})) == {}
    assert resolve("imaginaire_tpu.models.generators.dummy", "Generator")().inference({}) == {}
    for name, attr in (("models.generators.funit", "Generator"),
                       ("models.generators.coco_funit", "Generator"),
                       ("models.discriminators.funit", "Discriminator"),
                       ("trainers.funit", "Trainer"),
                       ("data.unpaired_few_shot_images", "Dataset"),
                       ("data.images", "Dataset")):
        assert resolve(f"imaginaire_tpu.{name}", attr).__module__ == \
            f"imaginaire_tpu_torch.{name}"
    assert resolve(Config(FUNIT).trainer.type, "Trainer").serves_requests is False
    with pytest.raises(ServingError, match="ROADMAP"):
        engine_from_config(Config(FUNIT), device="cpu")
