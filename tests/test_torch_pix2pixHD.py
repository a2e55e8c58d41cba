"""The port's pix2pixHD modules against the JAX package's, on the CPU.

Inputs and weights are numpy-drawn from a seed (weights into
``jax.eval_shape`` shapes, kernels at 1/sqrt(fan_in)) and bridged into
the port; the JAX side runs one jitted apply a case, compiled with XLA's
cheap CPU options. Widths are the unit config's
(``configs/unit_test/pix2pixHD.yaml``: a global generator of 16 filters
and 3 downsamples, one local enhancer, an encoder of 8 filters and 2
downsamples) at 32x32, the whole generator at 64x64; the Cityscapes
config's trees are compared by names and shapes only. Conv biases that
an instance norm follows are drawn zero, as the configs' init leaves
them: the norm removes them, and a large one only adds fp32
cancellation noise.

Tolerances:
- ``get_edges``: identical, on float ids and on bf16-rounded ids;
- ``instance_average``: 1e-6 of the features' max magnitude (fp32 sums
  in another order);
- the four networks' forwards: within 1e-5 of JAX relative to the
  output's scale (the L2 norm of the difference over the output's), and
  every element within 5e-5 of the output's max magnitude. Both
  packages' fp32 forwards are themselves ~1e-5 from a float64 run at
  the worst element (instance norms over the global trunk's 4x4 planes
  amplify rounding), so a max-element bound of 1e-5 would hold rounding,
  not the port;
- K-means against scikit-learn (only here, in the test): on well
  separated blobs the same centers up to order, within 1e-9; on instance
  features of an encoder the inertia within 10% of scikit-learn's (both
  are local searches from different draws: on such data the two land in
  minima that differ by up to ~5% either way);
- ``sample_feature_map`` with the same integer seed and the same
  centers: identical.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.model_utils import pix2pixHD as jutils
from imaginaire_tpu.models.discriminators.multires_patch import (
    Discriminator as JaxDiscriminator,
)
from imaginaire_tpu.models.generators import pix2pixHD as jgen
from imaginaire_tpu_torch import registry
from imaginaire_tpu_torch.bridge import load_flax_variables
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.model_utils import pix2pixHD as tutils
from imaginaire_tpu_torch.models.discriminators.multires_patch import Discriminator
from imaginaire_tpu_torch.models.generators import pix2pixHD as tgen

UNIT = "configs/unit_test/pix2pixHD.yaml"
CITYSCAPES = "configs/projects/pix2pixHD/cityscapes/bf16.yaml"
HW = 32
# the Cityscapes config's networks, counted with jax.eval_shape on the CPU
CITYSCAPES_G_PARAMS = 182_589_507
CITYSCAPES_G_U = 21_376
CITYSCAPES_D_PARAMS = 3_156_482
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
TOL_FORWARD = 1e-5
TOL_FORWARD_MAX = 5e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cheap_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=CHEAP)(*args)


def draw(shapes, seed=0):
    """Numpy values for a flax variable tree: kernels at 1/sqrt(fan_in),
    unit ``u`` vectors."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "u":
            u = rng.standard_normal(leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if path[-1].key == "bias" and path[-2].key == "conv":
            return np.zeros(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 4
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def assert_forward_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= TOL_FORWARD * np.linalg.norm(want)
    assert rel_err(got, want) <= TOL_FORWARD_MAX


def instance_ids(b, hw, ids, seed=0, block=4):
    """(B, H, W, 1) int ids drawn from ``ids``, constant on blocks of
    ``block`` pixels: contiguous instances with neighbours of other ids."""
    rng = np.random.RandomState(seed)
    coarse = rng.choice(np.asarray(ids), (b, hw // block, hw // block))
    return np.repeat(np.repeat(coarse, block, 1), block, 2)[..., None]


def unit_inputs(seed=0, b=2, hw=HW, seg=8):
    rng = np.random.RandomState(seed)
    inst = instance_ids(b, hw, range(seg + 1), seed)
    label = np.concatenate([np.eye(seg, dtype=np.float32)[rng.randint(0, seg, (b, hw, hw))],
                            tutils.get_edges(inst.astype(np.float32))], axis=-1)
    images = rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
    return label, images, inst.astype(np.int32)


# ----------------------------------------------------------- model utils


@pytest.mark.parametrize("case", ["small_ids", "cityscapes_ids"])
def test_get_edges_matches_jax(case):
    if case == "small_ids":
        inst = instance_ids(2, 24, range(5), seed=3, block=3).astype(np.float32)
    else:  # Cityscapes things: neighbours one id apart
        inst = instance_ids(2, 24, [7, 24, 26001, 26002, 26003, 33000], seed=4)
        inst = inst.astype(np.float32)
    got = tutils.get_edges(inst)
    want = np.asarray(jutils.get_edges(jnp.asarray(inst)))
    assert got.dtype == np.float32 and got.shape == inst.shape
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_edges_of_bf16_ids_lose_the_boundary_the_host_keeps():
    """Why the edges are taken before the cast: 26001 and 26002 are one
    number in bf16."""
    inst = np.full((1, 4, 8, 1), 26001, np.float32)
    inst[:, :, 4:] = 26002
    edges = tutils.get_edges(inst)
    assert edges[0, :, 3:5, 0].all() and edges.sum() == 8
    rounded = torch.from_numpy(inst).bfloat16().float().numpy()
    assert tutils.get_edges(rounded).sum() == 0
    np.testing.assert_array_equal(
        np.asarray(jutils.get_edges(jnp.asarray(rounded))), tutils.get_edges(rounded))


@pytest.mark.parametrize("max_instances", [64, 3])
def test_instance_average_matches_jax(max_instances):
    """With 3 kept ids of 9, six ids share the overflow segment."""
    rng = np.random.RandomState(5)
    inst = instance_ids(2, 16, [0, 2, 5, 26001, 26002, 26003, 30000, 31001, 40000], seed=5)
    feats = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    want = np.asarray(jutils.instance_average(jnp.asarray(feats), jnp.asarray(inst),
                                              max_instances=max_instances))
    got = tutils.instance_average(nchw(feats), torch.from_numpy(inst.transpose(0, 3, 1, 2)),
                                  max_instances=max_instances)
    assert rel_err(nhwc(got), want) <= 1e-6
    if max_instances == 3:
        # the overflow segment is one mean over every id past the third
        over = inst[0, ..., 0] > np.unique(inst[0])[2]
        np.testing.assert_allclose(nhwc(got)[0][over], feats[0][over].mean(0)[None]
                                   .repeat(over.sum(), 0), atol=1e-6)


def test_instance_average_passes_gradients():
    feats = torch.randn(1, 2, 4, 4, dtype=torch.float64, requires_grad=True)
    inst = torch.tensor([[0, 0, 1, 1]] * 4).reshape(1, 1, 4, 4)
    torch.autograd.gradcheck(lambda f: tutils.instance_average(f, inst), (feats,))


def test_instance_labels_and_features_match_jax():
    ids = np.array([3, 999, 1000, 26001, 33002])
    np.testing.assert_array_equal(tutils.instance_labels(ids),
                                  jutils.instance_labels(ids))
    np.testing.assert_array_equal(tutils.instance_labels(ids, False),
                                  jutils.instance_labels(ids, False))
    inst = instance_ids(2, 16, [1, 4, 26001, 26002, 33000], seed=6)
    feats = np.asarray(jutils.instance_average(
        jnp.asarray(np.random.RandomState(6).standard_normal((2, 16, 16, 3)), jnp.float32),
        jnp.asarray(inst)))
    want = jutils.collect_instance_features(feats, inst, 35)
    got = tutils.collect_instance_features(feats.transpose(0, 3, 1, 2),
                                           inst.transpose(0, 3, 1, 2), 35)
    assert sorted(got) == sorted(want)
    for label in want:
        np.testing.assert_allclose(got[label], want[label], rtol=0, atol=1e-7)
    assert got[26].shape[0] == 4  # 26001 and 26002 in each sample


def test_kmeans_finds_sklearns_centers_on_separated_blobs():
    from sklearn.cluster import KMeans

    rng = np.random.RandomState(7)
    centers = rng.uniform(-10, 10, (4, 3))
    x = np.concatenate([c + 0.3 * rng.standard_normal((40, 3)) for c in centers])
    got, inertia = tutils.kmeans(x, 4, seed=0)
    km = KMeans(n_clusters=4, random_state=0, n_init=10).fit(x)
    order = lambda c: c[np.lexsort(c.T[::-1])]  # noqa: E731
    np.testing.assert_allclose(order(got), order(km.cluster_centers_), rtol=0, atol=1e-9)
    assert inertia == pytest.approx(km.inertia_, rel=1e-9)


def test_kmeans_inertia_near_sklearn_on_instance_features():
    """Rows as ``cluster_features`` gives them: the encoder's pooled
    features of seeded images, one row an instance."""
    from sklearn.cluster import KMeans

    enc = tgen.Encoder(3, num_feat_channels=3, num_filters=8, num_downsamples=2)
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / max(p[0].numel(), 1) ** 0.5)
        rows = []
        for seed in range(4):
            inst = torch.from_numpy(instance_ids(1, 32, range(40), seed, block=8)
                                    .transpose(0, 3, 1, 2).copy())
            feats = enc(torch.rand(1, 3, 32, 32, generator=gen) * 2 - 1, inst)
            for label_rows in tutils.collect_instance_features(
                    feats.numpy(), inst.numpy(), 40, is_cityscapes=False).values():
                rows += list(label_rows[:, :-1])
    x = np.stack(rows)
    assert len(x) > 40
    for k in (4, 10):
        _, inertia = tutils.kmeans(x, k, seed=0)
        want = KMeans(n_clusters=k, random_state=0, n_init=10).fit(x).inertia_
        assert abs(inertia - want) <= 0.1 * want, (k, inertia, want)


def test_kmeans_handles_duplicates_and_refuses_too_many_clusters():
    x = np.repeat(np.array([[0.0, 1.0], [2.0, 3.0]]), 5, axis=0)
    centers, inertia = tutils.kmeans(x, 2, seed=1)
    assert inertia == 0 and sorted(map(tuple, centers)) == [(0.0, 1.0), (2.0, 3.0)]
    centers, inertia = tutils.kmeans(x, 3, seed=1)
    assert inertia == 0 and np.isfinite(centers).all()
    with pytest.raises(ValueError):
        tutils.kmeans(x, 11)


def test_sample_feature_map_picks_what_jax_picks():
    """The JAX function draws its RandomState seed from the key; given that
    integer, the port paints the same centers."""
    rng = np.random.RandomState(9)
    centers = rng.standard_normal((35, 4, 3)).astype(np.float32)
    centers[7] = 0  # a label with no cluster: left zero
    centers[26, 2:] = 0  # two of four clusters empty
    inst = instance_ids(2, 16, [7, 24, 26001, 26002, 26003, 33000, 40000], seed=9)
    key = jax.random.PRNGKey(3)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    want = np.asarray(jutils.sample_feature_map(centers, inst, key, is_cityscapes=True))
    got = tutils.sample_feature_map(centers, inst.transpose(0, 3, 1, 2), seed)
    np.testing.assert_array_equal(got.transpose(0, 2, 3, 1), want)
    assert np.abs(got).sum() > 0


# --------------------------------------------------------------- networks


def _jax_vs_port(jmodule, tmodule, jargs, targs, seed):
    variables = draw(jax.eval_shape(lambda *a: jmodule.init(jax.random.PRNGKey(0), *a),
                                    *jargs), seed=seed)
    want = cheap_jit(lambda v, *a: jmodule.apply(v, *a), variables, *jargs)
    load_flax_variables(tmodule, variables)
    with torch.no_grad():
        got = tmodule(*targs)
    return got, want


def test_global_generator_matches_jax():
    label, _, _ = unit_inputs(10)
    kw = dict(num_filters=16, num_downsamples=3, num_res_blocks=2,
              weight_norm_type="spectral", padding_mode="reflect")
    got, want = _jax_vs_port(jgen.GlobalGenerator(**kw), tgen.GlobalGenerator(9, **kw),
                             (jnp.asarray(label),), (nchw(label),), seed=10)
    assert got.shape == (2, 3, HW, HW)
    assert_forward_close(nhwc(got), want)


def test_local_enhancer_matches_jax():
    label, _, _ = unit_inputs(11)
    coarse = np.random.RandomState(11).standard_normal((2, HW // 2, HW // 2, 16))
    coarse = coarse.astype(np.float32)
    kw = dict(num_res_blocks=1, weight_norm_type="spectral", padding_mode="reflect",
              output_img=True)
    got, want = _jax_vs_port(jgen.LocalEnhancer(8, **kw), tgen.LocalEnhancer(9, 8, **kw),
                             (jnp.asarray(coarse), jnp.asarray(label)),
                             (nchw(coarse), nchw(label)), seed=11)
    assert got.shape == (2, 3, HW, HW)
    assert_forward_close(nhwc(got), want)


def test_encoder_matches_jax():
    _, images, inst = unit_inputs(12)
    kw = dict(num_feat_channels=3, num_filters=8, num_downsamples=2)
    got, want = _jax_vs_port(jgen.Encoder(**kw), tgen.Encoder(3, **kw),
                             (jnp.asarray(images), jnp.asarray(inst)),
                             (nchw(images), torch.from_numpy(inst.transpose(0, 3, 1, 2))),
                             seed=12)
    assert_forward_close(nhwc(got), want)
    # pooled: one value an instance
    for i in np.unique(inst[0]):
        vals = nhwc(got)[0][inst[0, ..., 0] == i]
        assert np.ptp(vals, axis=0).max() <= 1e-6


@pytest.fixture(scope="module")
def unit_generator():
    """The unit config's JAX generator and its drawn variables, shared by
    the cases: the tree of the encoding init (flax creates no encoder
    parameters in an init that is handed the features)."""
    jcfg = JaxConfig(UNIT)
    jnet = jgen.Generator(jcfg.gen, jcfg.data)
    label, images, inst = unit_inputs(13, hw=2 * HW)
    data = {"label": jnp.asarray(label), "images": jnp.asarray(images),
            "instance_maps": jnp.asarray(inst)}
    return jnet, draw(jax.eval_shape(lambda d: jnet.init(jax.random.PRNGKey(0), d), data),
                      seed=13)


@pytest.mark.parametrize("features", ["encoded", "given"])
def test_generator_matches_jax(unit_generator, features):
    """The unit config's generator (encoder, global generator, one
    enhancer, the average-pool pyramid), with the encoder's features or
    with ``feature_maps`` passed in."""
    tcfg = Config(UNIT)
    jnet, variables = unit_generator
    hw = 2 * HW
    label, images, inst = unit_inputs(13, hw=hw)
    data = {"label": jnp.asarray(label), "images": jnp.asarray(images),
            "instance_maps": jnp.asarray(inst)}
    tdata = {"label": nchw(label), "images": nchw(images),
             "instance_maps": torch.from_numpy(inst.transpose(0, 3, 1, 2).copy())}
    if features == "given":
        feats = np.random.RandomState(13).uniform(-1, 1, (2, hw, hw, 3)).astype(np.float32)
        data["feature_maps"], tdata["feature_maps"] = jnp.asarray(feats), nchw(feats)
    want = cheap_jit(lambda v, d: jnet.apply(v, d), variables, data)
    tnet = tgen.Generator(tcfg.gen, tcfg.data)
    load_flax_variables(tnet, variables)
    with torch.no_grad():
        got = tnet(tdata)
    assert sorted(got) == sorted(want) == ["fake_images", "feature_maps"]
    assert_forward_close(nhwc(got["fake_images"]), want["fake_images"])
    assert_forward_close(nhwc(got["feature_maps"]), want["feature_maps"])


def test_discriminator_matches_jax():
    """The multires_patch wrapper at the unit config's widths: fake then
    real, outputs and features of both scales."""
    jcfg, tcfg = JaxConfig(UNIT), Config(UNIT)
    jnet = JaxDiscriminator(jcfg.dis, jcfg.data)
    label, images, _ = unit_inputs(14)
    data = {"label": jnp.asarray(label), "images": jnp.asarray(images)}
    fake = {"fake_images": jnp.asarray(np.tanh(images[::-1]))}
    variables = draw(jax.eval_shape(lambda d, f: jnet.init(jax.random.PRNGKey(0), d, f),
                                    data, fake), seed=14)
    want = cheap_jit(lambda v, d, f: jnet.apply(v, d, f), variables, data, fake)
    tnet = load_flax_variables(Discriminator(tcfg.dis, tcfg.data), variables)
    with torch.no_grad():
        got = tnet({"label": nchw(label), "images": nchw(images)},
                   {"fake_images": nchw(np.asarray(fake["fake_images"]))})
    for key in ("fake_outputs", "real_outputs"):
        assert len(got[key]) == len(want[key]) == 2
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=1e-4, rtol=0)
    for key in ("fake_features", "real_features"):
        for fa, fb in zip(got[key], want[key]):
            for a, b in zip(fa, fb):
                np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=1e-4, rtol=0)


# ----------------------------------------------------- the Cityscapes trees


def test_cityscapes_trees_match_jax_eval_shape():
    """The committed config's G and D on the meta device: the bridge fills
    every port tensor from the JAX ``eval_shape`` trees, each leaf in its
    shape, none left over."""
    jcfg, tcfg = JaxConfig(CITYSCAPES), Config(CITYSCAPES)
    key = jax.random.PRNGKey(0)
    data = {"label": jax.ShapeDtypeStruct((1, 64, 128, 36), jnp.float32),
            "images": jax.ShapeDtypeStruct((1, 64, 128, 3), jnp.float32)}
    jg, jd = jgen.Generator(jcfg.gen, jcfg.data), JaxDiscriminator(jcfg.dis, jcfg.data)
    g_shapes = jax.eval_shape(lambda d: jg.init(key, d), data)
    d_shapes = jax.eval_shape(
        lambda d: jd.init(key, d, {"fake_images": d["images"]}), data)
    count = lambda tree: sum(int(np.prod(s.shape))  # noqa: E731
                             for s in jax.tree_util.tree_leaves(tree))
    assert count(g_shapes["params"]) == CITYSCAPES_G_PARAMS
    assert count(g_shapes["spectral"]) == CITYSCAPES_G_U
    assert count(d_shapes["params"]) == CITYSCAPES_D_PARAMS
    zeros = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda s: np.broadcast_to(np.float32(0), s.shape), flax.core.unfreeze(tree))
    with torch.device("meta"):
        tg, td = tgen.Generator(tcfg.gen, tcfg.data), Discriminator(tcfg.dis, tcfg.data)
    load_flax_variables(tg, zeros(g_shapes))
    load_flax_variables(td, zeros(d_shapes))
    assert sum(p.numel() for p in tg.parameters()) == CITYSCAPES_G_PARAMS
    assert sum(b.numel() for b in tg.buffers()) == CITYSCAPES_G_U
    assert sum(p.numel() for p in td.parameters()) == CITYSCAPES_D_PARAMS
    assert not tg.concat_features and tg.num_enhancers == 0


def test_config_types_resolve_to_the_port():
    assert registry.resolve("imaginaire_tpu.trainers.pix2pixHD", "Trainer").__module__ \
        == "imaginaire_tpu_torch.trainers.pix2pixHD"
    assert registry.resolve("imaginaire_tpu.models.generators.pix2pixHD", "Generator") \
        is tgen.Generator
    assert registry.resolve("imaginaire_tpu.models.discriminators.multires_patch",
                            "Discriminator") is Discriminator
