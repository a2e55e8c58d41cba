"""UNIT and MUNIT modules of the port against the JAX package's, on the
CPU: the GAN modes, ``random_shift`` and ``gradient_penalty``, MUNIT's
instance-normalized perceptual loss, the unpaired two-domain dataset,
both generators, the residual D's pool aggregation and the three kinds
of domain discriminator (the trainers are in
``test_torch_unpaired_training.py``).

The unit configs (``configs/unit_test/{munit,munit_patch,unit}.yaml``)
at 64x64, weights numpy-drawn into ``jax.eval_shape`` shapes and bridged
(kernels at 1/sqrt(fan_in), unit ``u``, conv biases at zero: an instance
norm follows them), each JAX forward one jitted program with XLA's cheap
CPU options; the style codes the JAX forward draws are injected into the
port. The full-width configs' trees are traced with ``jax.eval_shape``
only.

Tolerances:
- the GAN losses, ``dis_accuracy``, ``random_shift``: rtol 1e-6 (shifts
  exactly); ``gradient_penalty`` and its gradient, the instance-normalized
  perceptual loss: rtol 1e-5;
- dataset items: keys and ``is_flipped`` exact, images within one 8-bit
  level (2/255 after the [-1, 1] normalisation) with under 1e-3 of the
  elements off by one level (both packages decode the JPEG fixtures
  with OpenCV; the port resizes in numpy);
- forwards: each output within 1e-5 of the JAX output in relative L2
  (the cycle, two autoencoders deep, within 3e-5), ``u`` after the
  forward atol 1e-5.
"""

import random

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.data.unpaired_images import Dataset as JaxDataset
from imaginaire_tpu.losses.gan import dis_accuracy as j_dis_accuracy
from imaginaire_tpu.losses.gan import gan_loss as j_gan_loss
from imaginaire_tpu.losses.perceptual import PerceptualLoss as JaxPerceptualLoss
from imaginaire_tpu.models.discriminators.residual import ResDiscriminator as JaxRes
from imaginaire_tpu.registry import resolve as jax_resolve
from imaginaire_tpu.utils.misc import gradient_penalty as j_gradient_penalty
from imaginaire_tpu.utils.misc import random_shift as j_random_shift
from imaginaire_tpu_torch.bridge import load_flax_variables, load_jax_state, to_port_layout
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.backends import build_packed_dataset
from imaginaire_tpu_torch.data.unpaired_images import Dataset
from imaginaire_tpu_torch.layers.state import state_updates
from imaginaire_tpu_torch.losses.gan import GAN_MODES, dis_accuracy, gan_loss
from imaginaire_tpu_torch.losses.perceptual import PerceptualLoss
from imaginaire_tpu_torch.models.discriminators.residual import ResDiscriminator
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.utils.misc import gradient_penalty, random_shift

MUNIT = "configs/unit_test/munit.yaml"
MUNIT_PATCH = "configs/unit_test/munit_patch.yaml"
UNIT = "configs/unit_test/unit.yaml"
FIXTURES = "tests/fixtures/unpaired/raw"
AFHQ = "configs/projects/munit/afhq_dog2cat/bf16.yaml"
WINTER = "configs/projects/unit/winter2summer/base48_bs1.yaml"
HW, B = 64, 2
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
TOL_FWD = 1e-5
TOL_CYCLE = 3e-5
ONE_LEVEL = 2.0 / 255 + 1e-6
# crops and flips drawn per domain
CROPS = {"data": {"train": {"augmentations": {"resize_h_w": "72, 80",
                                              "random_crop_h_w": "64, 64",
                                              "horizontal_flip": True}},
                  "val": {"augmentations": {"resize_smallest_side": 64,
                                            "center_crop_h_w": "64, 64"}}}}


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
    other biases small."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "u":
            u = rng.standard_normal(leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if path[-1].key == "bias":
            scale = 0.0 if path[-2].key == "conv" else 0.1
            return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 4
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def images(seed, b=B, hw=HW):
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
            for k in ("images_a", "images_b")}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def init_shapes(net, data):
    """``jax.eval_shape`` of a JAX generator's init through its
    translations alone: every sub-network runs once, so every parameter
    is made, at a third of the full forward's tracing."""
    flags = {"image_recon": False, "cycle_recon": False}
    if "latent_recon" in net.__call__.__code__.co_varnames:
        flags["latent_recon"] = False
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda d: net.init({"params": key, "noise": key}, d,
                                             training=True, **flags), data)


def dis_init_shapes(net, data, out):
    """``jax.eval_shape`` of a JAX two-domain D's init through the
    translations alone (each domain's D runs once)."""
    return jax.eval_shape(lambda d, o: net.init(jax.random.PRNGKey(0), d, o, real=False,
                                                training=True), data, out)


def jax_style_key(net, rng):
    """The key the JAX generator's first ``make_rng('noise')`` returns."""
    return net.apply({}, rngs={"noise": rng}, method=lambda m: m.make_rng("noise"))


# ------------------------------------------------------------- the losses


@pytest.mark.parametrize("mode", GAN_MODES)
def test_gan_losses_and_accuracy_match_jax(mode):
    """Every mode's D forms (real, fake) and G form, per-scale lists and a
    single tensor, with and without per-sample weights, and the
    accuracies (the least_square boundary is the labels' midpoint)."""
    rng = np.random.RandomState(3)
    logits = [rng.randn(2, 4, 4, 1).astype(np.float32) for _ in range(3)]
    weight = np.array([1.0, 0.0], np.float32)
    jl, tl = [jnp.asarray(a) for a in logits], [nchw(a) for a in logits]
    pairs = []
    for sw in (None, weight):
        jw = None if sw is None else jnp.asarray(sw)
        tw = None if sw is None else torch.from_numpy(sw)
        for t_real, dis_update in ((True, True), (False, True), (True, False)):
            for j_in, t_in in ((jl, tl), (jl[0], tl[0])):
                pairs.append((gan_loss(t_in, t_real, mode, dis_update, sample_weight=tw),
                              j_gan_loss(j_in, t_real, mode, dis_update, sample_weight=jw)))
    pairs += list(zip(dis_accuracy([tl[:2], tl[2]], tl[::-1], mode),
                      j_dis_accuracy([jl[:2], jl[2]], jl[::-1], mode)))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="target should be real"):
        gan_loss(tl, False, mode, dis_update=False)


def test_random_shift_matches_jax_with_its_offsets():
    """The JAX offsets (``randint`` of the key's two halves) injected:
    the same reflect-padded windows, for a square and an oblong batch."""
    for shape, seed in (((3, 20, 20, 2), 0), ((2, 40, 24, 3), 1)):
        x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
        key = jax.random.PRNGKey(seed)
        want = np.asarray(j_random_shift(jnp.asarray(x), key))
        b, h, w, _ = shape
        mh, mw = max(1, int(0.05 * h)), max(1, int(0.05 * w))
        ky, kx = jax.random.split(key)
        offsets = (np.asarray(jax.random.randint(ky, (b,), 0, 2 * mh + 1)),
                   np.asarray(jax.random.randint(kx, (b,), 0, 2 * mw + 1)))
        got = nhwc(random_shift(nchw(x), offsets))
        np.testing.assert_array_equal(got, want)


def test_gradient_penalty_and_its_gradient_match_jax():
    """A two-output D (a list, as a patch D returns): the penalty, and
    its gradient with respect to D's weight (the graph is kept)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 6, 3).astype(np.float32)
    w = rng.randn(3).astype(np.float32)

    def j_d(params, im):
        return [jnp.tanh(im @ params) ** 2, jnp.sin(im @ params)]

    def j_gp(params):
        return j_gradient_penalty(j_d, params, jnp.asarray(x), None)

    want, want_grad = jax.value_and_grad(j_gp)(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_(True)

    def t_d(im):
        y = torch.einsum("bchw,c->bhw", im, tw)
        return [torch.tanh(y) ** 2, torch.sin(y)]

    got = gradient_penalty(t_d, nchw(x))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-6)


def test_instance_normalized_perceptual_loss_matches_jax():
    """MUNIT's perceptual loss: VGG19 features instance-normalized before
    the L1 (random weights, relu_1_1 and relu_2_1); a MUNIT trainer with
    a perceptual weight builds it so."""
    layers, weights = ["relu_1_1", "relu_2_1"], [0.5, 1.0]
    jloss = JaxPerceptualLoss(layers=layers, weights=weights, instance_normalized=True,
                              allow_random_init=True)
    params = draw(jax.eval_shape(lambda: jloss.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))), 4)["params"]
    rng = np.random.RandomState(5)
    fake, real = (rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    want = cheap_jit(jloss, params, jnp.asarray(fake), jnp.asarray(real))(
        params, jnp.asarray(fake), jnp.asarray(real))
    tloss = PerceptualLoss(layers=layers, weights=weights, instance_normalized=True,
                           weights_path="no/such/vgg19.npz", allow_random_init=True)
    load_flax_variables(tloss.module, {"params": params})
    np.testing.assert_allclose(float(tloss(nchw(fake), nchw(real))), float(want), rtol=1e-5)
    cfg = Config(MUNIT, overrides={"trainer": {"perceptual_allow_random_init": True,
                                               "loss_weight": {"perceptual": 1.0}}})
    trainer = resolve(cfg.trainer.type, "Trainer")(cfg, device="cpu", train=True)
    assert trainer.perceptual.instance_normalized and "perceptual" in trainer.weights


# ---------------------------------------------------------------- the data


@pytest.fixture(scope="module")
def unpaired_sets(tmp_path_factory):
    """{backend: (JAX config, port config)} on the fixture's folders and
    on a pack of them built by the port."""
    packed = str(tmp_path_factory.mktemp("unpaired") / "packed")
    build_packed_dataset(FIXTURES, packed, ["images_a", "images_b"])
    out = {}
    for backend, root in (("folder", FIXTURES), ("packed", packed)):
        over = {"data": {split: dict(CROPS["data"][split], roots=[root],
                                     is_packed=backend == "packed")
                         for split in ("train", "val")}}
        out[backend] = (JaxConfig(MUNIT, overrides=over), Config(MUNIT, overrides=over))
    return out


@pytest.mark.parametrize("backend", ["folder", "packed"])
@pytest.mark.parametrize("split,seed", [("train", 0), ("train", 1), ("train", 2),
                                        ("val", None)])
def test_unpaired_items_match_jax_with_injected_draws(unpaired_sets, backend, split, seed):
    """Every item of the split: the JAX draws from ``random.seed(s)``,
    the port's from ``random.Random(s)`` (its item generator replaced),
    so each domain's file, crop and flip agree."""
    jcfg, cfg = unpaired_sets[backend]
    inference = split == "val"
    jds, ds = JaxDataset(jcfg, is_inference=inference), Dataset(cfg, is_inference=inference)
    assert len(ds) == len(jds) == 3
    assert {t: len(p) for t, p in ds.items.items()} == {"images_a": 3, "images_b": 2}
    off = total = 0
    for index in range(len(ds)):
        s = 17 * (seed or 0) + index
        random.seed(s)
        want = jds[index]
        ds.item_rng = lambda i, s=s: random.Random(s)
        got = ds[index]
        assert set(got) == set(want) and got["key"] == want["key"]
        np.testing.assert_array_equal(got["is_flipped"], want["is_flipped"])
        for t in ("images_a", "images_b"):
            assert got[t].shape == want[t].shape == (HW, HW, 3)
            diff = np.abs(got[t] - np.asarray(want[t]))
            assert diff.max() <= ONE_LEVEL, t
            off += int((diff > 1e-6).sum())
            total += diff.size
    assert off <= 1e-3 * total


def test_unpaired_flips_are_drawn_per_domain(unpaired_sets):
    """Across epochs the two domains' flips differ somewhere, and a
    training item's files do not follow its index."""
    _, cfg = unpaired_sets["folder"]
    ds = Dataset(cfg)
    flips, keys = set(), set()
    for epoch in range(6):
        ds.reseed(0, epoch)
        item = ds[0]
        flips.add(tuple(item["is_flipped"]))
        keys.add(item["key"])
    assert (True, False) in flips or (False, True) in flips
    assert len(keys) > 1


# ------------------------------------------------------------ generators


@pytest.fixture(scope="module")
def generators():
    """{config: (JAX net, drawn variables, port net)}."""
    out = {}
    for path, seed in ((MUNIT, 1), (UNIT, 2)):
        jcfg = JaxConfig(path)
        jnet = jax_resolve(jcfg.gen.type, "Generator")(jcfg.gen, jcfg.data)
        data = {k: jnp.asarray(v) for k, v in images(0).items()}
        variables = draw(init_shapes(jnet, data), seed)
        cfg = Config(path)
        net = resolve(cfg.gen.type, "Generator")(cfg.gen, cfg.data)
        out[path] = (jnet, variables, net)
    return out


def check_outputs(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().numpy()
        if g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        tol = TOL_CYCLE if k in ("images_aba", "images_bab", "content_ab",
                                 "content_ba") else TOL_FWD
        assert rel_l2(g, np.asarray(w)) <= tol, (k, rel_l2(g, np.asarray(w)))


@pytest.mark.parametrize("config", [MUNIT, UNIT])
def test_generator_training_forward_matches_jax(generators, config):
    """Every output key of the training forward (all reconstructions on),
    the JAX style draws injected, and each ``u`` after it."""
    jnet, variables, net = generators[config]
    data = images(7)
    rng = jax.random.PRNGKey(4)
    flags = {} if config == UNIT else {"within_latent_recon": True}
    out, mut = cheap_jit(lambda v, d, r: jnet.apply(
        v, d, training=True, rngs={"noise": r}, mutable=["spectral"], **flags),
        variables, data, rng)(variables, data, rng)
    load_flax_variables(net, variables)
    tdata = {k: nchw(v) for k, v in data.items()}
    noise = {}
    if config == MUNIT:
        ka, kb = jax.random.split(jax_style_key(jnet, rng))
        noise["noise"] = tuple(torch.from_numpy(np.asarray(jax.random.normal(k, (B, 8))))
                               for k in (ka, kb))
    net.train()
    with state_updates(net, True):
        got = net(tdata, **flags, **noise)
    net.eval()
    check_outputs(got, out)
    if config == MUNIT:
        # the injected draw (eager) against the jitted one's: an ulp apart
        np.testing.assert_allclose(got["style_a_rand"].numpy(),
                                   np.asarray(out["style_a_rand"]), rtol=1e-6)
    buffers = dict(net.named_buffers())
    u = to_port_layout(net, mut["spectral"])
    assert set(u) == set(buffers) and u
    for name, value in u.items():
        np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("config", [MUNIT, UNIT])
def test_generator_inference_matches_jax(generators, config):
    """``inference`` both ways; MUNIT's A into B under the prior's style
    (the JAX draw injected), B into A under A's own style."""
    jnet, variables, net = generators[config]
    data = images(8)
    load_flax_variables(net, variables)
    tdata = {k: nchw(v) for k, v in data.items()}
    rng = jax.random.PRNGKey(6)
    for a2b, random_style in ((True, True), (False, config != MUNIT)):
        want = cheap_jit(lambda v, d, r: jnet.apply(
            v, d, a2b=a2b, random_style=random_style, rngs={"noise": r},
            method=jnet.inference), variables, data, rng)(variables, data, rng)
        kwargs = {"a2b": a2b, "random_style": random_style}
        if config == MUNIT and random_style:
            z = jax.random.normal(jax_style_key(jnet, rng), (B, 8))
            kwargs["noise"] = torch.from_numpy(np.asarray(z))
        with torch.no_grad():
            got = net.inference(tdata, **kwargs)
        assert rel_l2(nhwc(got), np.asarray(want)) <= TOL_FWD, (a2b, random_style)


def test_bridge_loads_the_averaged_copy(generators):
    """``load_jax_state`` fills G, its ``u`` and the averaged copy
    (``ema_G``, G's params tree); a state with an averaged copy does not
    load into a trainer that averages none."""
    _, variables, _ = generators[MUNIT]
    ema = jax.tree_util.tree_map(lambda a: a * 0.5, variables["params"])
    cfg = Config(MUNIT, overrides={"trainer": {"model_average": True}})
    trainer = resolve(cfg.trainer.type, "Trainer")(cfg, device="cpu")
    trainer.init_state(seed=0)
    load_jax_state(trainer, {"vars_G": variables, "ema_G": ema})
    want = to_port_layout(trainer.net_G, ema)
    assert set(want) == set(trainer.ema_G)
    for name, value in want.items():
        np.testing.assert_array_equal(trainer.ema_G[name].numpy(), value)
    u = to_port_layout(trainer.net_G, variables["spectral"])
    buffers = dict(trainer.net_G.named_buffers())
    assert u and all(np.array_equal(buffers[n].numpy(), v) for n, v in u.items())
    plain = resolve(cfg.trainer.type, "Trainer")(Config(MUNIT), device="cpu")
    plain.init_state(seed=0)
    with pytest.raises(KeyError, match="ema_G"):
        load_jax_state(plain, {"vars_G": variables, "ema_G": ema})


def test_generator_refuses_noise_layers():
    cfg = Config(UNIT, overrides={"gen": {"apply_noise": True}})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        resolve(cfg.gen.type, "Generator")(cfg.gen, cfg.data)


# ---------------------------------------------------------- discriminators


@pytest.mark.parametrize("config,kind", [(MUNIT, "residual"), (MUNIT_PATCH, "patch"),
                                         (UNIT, "shared")])
def test_domain_discriminator_matches_jax(config, kind):
    """Translations, real images and reconstructions (``gan_recon``)
    through both domains' discriminators: logits, every feature and each
    ``u`` after the forward (a shared patch D advances its ``u`` once a
    scale)."""
    jcfg, cfg = JaxConfig(config), Config(config)
    jnet = jax_resolve(jcfg.dis.type, "Discriminator")(jcfg.dis, jcfg.data)
    real, fake = images(11), images(12)
    g_out = {"images_ab": fake["images_a"], "images_ba": fake["images_b"],
             "images_aa": real["images_b"], "images_bb": real["images_a"]}
    variables = draw(dis_init_shapes(jnet, real, g_out), 3)
    want, mut = cheap_jit(lambda v, d, o: jnet.apply(
        v, d, o, real=True, gan_recon=True, training=True, mutable=["spectral"]),
        variables, real, g_out)(variables, real, g_out)
    net = resolve(cfg.dis.type, "Discriminator")(cfg.dis, cfg.data)
    load_flax_variables(net, variables)
    names = {n.split(".")[1] for n, _ in net.named_parameters()}
    assert names == {"residual": {"conv_first", "res_0", "res_1", "res_2", "res_3",
                                  "agg", "classifier"},
                     "patch": {"d_0", "d_1", "d_2"}, "shared": {"d_shared"}}[kind]
    net.train()
    with state_updates(net, True):
        got = net({k: nchw(v) for k, v in real.items()},
                  {k: nchw(v) for k, v in g_out.items()}, real=True, gan_recon=True)
    assert set(got) == set(want)
    for k in want:
        for g, w in zip(jax.tree_util.tree_leaves(
                [t.detach().numpy() for t in _leaves(got[k])]),
                jax.tree_util.tree_leaves(want[k])):
            w = np.asarray(w)
            if g.ndim == 4:
                g = g.transpose(0, 2, 3, 1)
            assert g.shape == w.shape and rel_l2(g, w) <= TOL_FWD, k
    buffers = dict(net.named_buffers())
    for name, value in to_port_layout(net, mut["spectral"]).items():
        np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5, rtol=0,
                                   err_msg=name)


def test_residual_discriminator_pool_aggregation_matches_jax():
    """The global average ``pool`` aggregation and reflect padding, with a
    first kernel of 3 (the domain test covers ``conv`` and zeros)."""
    from imaginaire_tpu.models.discriminators.residual import ResDiscriminator as JaxRes

    from imaginaire_tpu_torch.models.discriminators.residual import ResDiscriminator

    kw = dict(num_filters=4, max_num_filters=16, first_kernel_size=3, num_layers=2,
              padding_mode="reflect", weight_norm_type="spectral", aggregation="pool")
    x = images(13, hw=16)["images_a"]
    jnet = JaxRes(**kw)
    variables = draw(jax.eval_shape(lambda a: jnet.init(jax.random.PRNGKey(0), a), x), 5)
    (out, feats, _), mut = cheap_jit(lambda v, a: jnet.apply(
        v, a, training=True, mutable=["spectral"]), variables, x)(variables, x)
    net = load_flax_variables(ResDiscriminator(3, **kw), variables).train()
    with state_updates(net, True):
        got, got_feats, _ = net(nchw(x))
    assert got.shape == (B, 1) and got_feats.shape == (B, 16, 1, 1)
    assert rel_l2(got.detach().numpy(), np.asarray(out)) <= TOL_FWD
    assert rel_l2(nhwc(got_feats), np.asarray(feats)) <= TOL_FWD
    buffers = dict(net.named_buffers())
    for name, value in to_port_layout(net, mut["spectral"]).items():
        np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="aggregation"):
        ResDiscriminator(3, aggregation="max")


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


# --------------------------------------------------- the full-width trees


@pytest.mark.parametrize("config", [AFHQ, WINTER])
def test_full_width_trees_match_jax(config):
    """The committed AFHQ MUNIT and winter2summer UNIT configs at 256x256:
    the JAX ``init`` trees traced with ``jax.eval_shape`` load path for
    path into port networks built on the meta device, leaving nothing
    unset."""
    jcfg, cfg = JaxConfig(config), Config(config)
    data = {k: jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32)
            for k in ("images_a", "images_b")}
    jgen = jax_resolve(jcfg.gen.type, "Generator")(jcfg.gen, jcfg.data)
    jdis = jax_resolve(jcfg.dis.type, "Discriminator")(jcfg.dis, jcfg.data)
    g_shapes = init_shapes(jgen, data)
    g_out = {"images_ab": data["images_a"], "images_ba": data["images_b"]}
    d_shapes = dis_init_shapes(jdis, data, g_out)
    counts = []
    for kind, shapes in (("gen", g_shapes), ("dis", d_shapes)):
        cls = resolve(cfg[kind].type, "Generator" if kind == "gen" else "Discriminator")
        with torch.device("meta"):
            net = cls(cfg[kind], cfg.data)
        zeros = jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
        load_flax_variables(net, zeros)
        counts.append(sum(p.numel() for p in net.parameters()))
        assert counts[-1] == sum(int(np.prod(s.shape)) for s in
                                 jax.tree_util.tree_leaves(shapes["params"]))
    assert counts == {AFHQ: [30_258_966, 32_322_498],
                      WINTER: [12_555_654, 5_295_042]}[config]


# ------------------------------------------------------------ trainers


def trainers(config, overrides=None, seed=1):
    """(JAX trainer, port trainer, drawn JAX variables {G, D})."""
    jt = jax_resolve(JaxConfig(config).trainer.type, "Trainer")(
        JaxConfig(config, overrides=overrides or {}))
    cfg = Config(config, overrides=overrides or {})
    tr = resolve(cfg.trainer.type, "Trainer")(cfg, device="cpu", train=True)
    tr.init_state(seed=0)
    data = {k: jnp.asarray(v) for k, v in images(0).items()}
    shapes_g = init_shapes(jt.net_G, data)
    out = {"images_ab": data["images_a"], "images_ba": data["images_b"]}
    shapes_d = dis_init_shapes(jt.net_D, data, out)
    v = {"G": draw(shapes_g, seed), "D": draw(shapes_d, seed + 1)}
    load_jax_state(tr, {"vars_G": v["G"], "vars_D": v["D"]})
    return jt, tr, v
