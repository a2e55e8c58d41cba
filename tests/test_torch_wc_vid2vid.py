"""The port's wc-vid2vid against the JAX package on the CPU: the point-cloud
renderer and the unprojection data (exact), the partial convolution and
the partial SPADE branch, and the generator's first, continuation and
warp frames with guidance under ``gen.guidance.only_with_flow`` True and
False (and ``partial_conv``), at ``configs/unit_test/wc_vid2vid.yaml``
(64x64, num_filters 4). The training steps, the takeover, the data item,
the entries and both committed wc configs' full-width generator trees
are in ``test_torch_wc_vid2vid_training.py``, which shares these helpers
(two files run side by side under ``--dist loadfile``).

JAX variable shapes come from ``jax.eval_shape`` of the generator's
``init_all`` init; leaves are drawn with numpy (kernels at
1/sqrt(fan_in), the flow heads 20x smaller so that warps move pixels by
a few pixels, as in ``test_torch_fs_vid2vid.py``) and carried into the
port by ``bridge.load_flax_variables``, which fails on a leaf left over
or a port tensor left unset: the port owns exactly the JAX tree's
parameters. Each JAX case is one compiled program.

Tolerances: the renderer, ``guidance_tensor``, ``decode_unprojections``
and ``_point_info``: exact; ``PartialConv2d`` and the partial SPADE
branch: 1e-5; the generator: 1e-5 (fp32; flows in head units, divided
by ``flow_output_multiplier``; the warp is held to the JAX warp of the
port's own flow).
"""

import copy
import pickle

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.layers.activation_norm import SpatiallyAdaptiveNorm as JaxSpade
from imaginaire_tpu.layers.conv import PartialConv2d as JaxPartialConv2d
from imaginaire_tpu.model_utils import fs_vid2vid as jfs
from imaginaire_tpu.model_utils import wc_vid2vid as jwc
from imaginaire_tpu.models.generators.wc_vid2vid import Generator as JaxGenerator
from imaginaire_tpu.trainers.wc_vid2vid import Trainer as JaxTrainer
from imaginaire_tpu_torch.bridge import load_flax_variables
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.layers.activation_norm import SpatiallyAdaptiveNorm
from imaginaire_tpu_torch.layers.conv import PartialConv2d
from imaginaire_tpu_torch.model_utils import wc_vid2vid as twc
from imaginaire_tpu_torch.models.generators.wc_vid2vid import Generator
from imaginaire_tpu_torch.trainers.wc_vid2vid import Trainer

CFG = "configs/unit_test/wc_vid2vid.yaml"
HW, LABELS = 64, 12
FLOW_MULTIPLIER = 40  # gen.flow.flow_output_multiplier of the config
FLOW_HEAD_SCALE = 0.05
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
# the partial-conv route: the guidance as an (image, mask) pair, into SPADE
# norms built with ``partial`` (their hidden width must be > 0)
PARTIAL = {"gen": {"guidance": {"partial_conv": True},
                   "activation_norm_params": {"partial": True, "num_filters": 4,
                                              "kernel_size": 3}}}
OUT_KEYS = ("fake_images", "fake_flow_maps", "fake_occlusion_masks",
            "fake_raw_images", "warped_images", "guidance_images_and_masks")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def merged(*parts):
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(
                out.get(k), dict) else copy.deepcopy(v)
    return out


def configs(*extra, path=CFG):
    overrides = merged(*extra)
    return JaxConfig(path, overrides=copy.deepcopy(overrides)), \
        Config(path, overrides=copy.deepcopy(overrides))


def cheap_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=CHEAP)(*args)


def draw(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "u":
            u = rng.standard_normal(leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def to_torch(a):
    """NHWC / (N, T, H, W, C) numpy -> NCHW / (N, T, C, H, W) torch."""
    a = np.asarray(a, np.float32)
    perm = (0, 3, 1, 2) if a.ndim == 4 else (0, 1, 4, 2, 3)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(perm)))


def to_nhwc(t):
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t.permute(0, 1, 3, 4, 2)).numpy()


def guidance(rng, b=1, hw=HW):
    """A (b, hw, hw, 4) guidance: RGB in [-1, 1] where the mask is 1,
    zero elsewhere, as a render of a half-seen cloud gives."""
    mask = (rng.rand(b, hw, hw, 1) < 0.5).astype(np.float32)
    return np.concatenate([np.tanh(rng.randn(b, hw, hw, 3)) * mask, mask],
                          axis=-1).astype(np.float32)


def frames(seed, history=0, b=1):
    """A frame's data: one-hot label, ``history`` previous frames, the
    guidance and the real frame."""
    rng = np.random.RandomState(seed)

    def labels(*lead):
        return np.eye(LABELS, dtype=np.float32)[rng.randint(0, LABELS, lead + (HW, HW))]

    d = {"label": labels(b)}
    if history:
        d["prev_labels"] = labels(b, history)
        d["prev_images"] = np.tanh(rng.randn(b, history, HW, HW, 3)).astype(np.float32)
    d["guidance"] = guidance(rng, b)
    d["image"] = np.tanh(rng.randn(b, HW, HW, 3)).astype(np.float32)
    return d


def generator_vars(jnet, seed=1):
    """Drawn variables of the JAX generator's whole tree (``init_all``:
    the temporal path and the guidance's SPADE convs); the flow head
    scaled by ``FLOW_HEAD_SCALE``."""
    d = {k: jnp.asarray(v) for k, v in frames(0).items() if k != "image"}
    key = jax.random.PRNGKey(0)
    variables = draw(jax.eval_shape(lambda: jnet.init(
        {"params": key, "noise": key}, d, training=True, init_all=True)), seed)
    head = variables["params"]["flow_network_temp"]["conv_flow"]["conv"]
    for k in head:
        head[k] = head[k] * FLOW_HEAD_SCALE
    return variables


# ------------------------------------------------------------ renderer


@pytest.mark.parametrize("flipped", [False, True])
def test_splat_renderer_and_guidance_match_jax(flipped):
    """Four frames of a seeded cloud: each colors its first-seen points
    and renders the guidance of the next: colors, seen flags and times,
    renders and guidance equal the JAX renderer's."""
    rng = np.random.RandomState(1 + flipped)
    renderers = (jwc.SplatRenderer(), twc.SplatRenderer())
    for step in range(4):
        n = 200
        info = np.stack([rng.randint(0, 16, n), rng.randint(0, 24, n),
                         rng.randint(0, 300 + 100 * step, n)], axis=1)
        image = rng.randint(0, 256, (16, 24, 3)).astype(np.uint8)
        want = jwc.guidance_tensor(renderers[0], info, 24, 16, flipped=flipped)
        got = twc.guidance_tensor(renderers[1], info, 24, 16, flipped=flipped)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == np.float32
        for r in renderers:
            r.update_point_cloud(image, info)
        for name in ("colors", "seen_mask", "seen_time", "call_idx"):
            np.testing.assert_array_equal(getattr(renderers[1], name),
                                          getattr(renderers[0], name))
        assert renderers[1].num_points() == renderers[0].num_points() > 0
    for r in renderers:
        r.update_point_cloud(image, np.zeros((0, 3), np.int64))  # a frame that sees nothing
        r.reset()
    assert renderers[1].num_points() == renderers[0].num_points() == 0


def test_decode_unprojections_matches_jax():
    """Ragged frames under two keys, one frame lacking a key and one
    seeing nothing: the same padded (T, N, 3) stacks and count rows."""
    rng = np.random.RandomState(3)
    frames_ = []
    for t, n in enumerate((5, 2, 0, 7)):
        flat = rng.randint(0, 500, 3 * n).tolist()
        info = {"w1024xh512": flat}
        if t != 1:
            info["64x128"] = flat[: 3 * max(n - 1, 0)]
        frames_.append(pickle.dumps(info))
    want = jwc.decode_unprojections(frames_)
    got = twc.decode_unprojections(frames_)
    assert set(got) == set(want) == {"w1024xh512", "64x128"}
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def _decoded(seed, frames_=3):
    rng = np.random.RandomState(seed)
    items = [pickle.dumps({"w64xh32": rng.randint(0, 99, 3 * n).tolist(),
                           "16x8": rng.randint(0, 99, 3 * n).tolist(),
                           "8x4": [1, 2, 3]})
             for n in rng.randint(0, 6, frames_)]
    return twc.decode_unprojections(items)


POINT_INFO_CASES = {
    # a [batch][frame] list of raw (N, 3) arrays
    "nested_list": lambda: [[np.random.RandomState(s).randint(0, 9, (4 + s, 3))
                             for s in range(3)] for _ in range(2)],
    # a stacked (B, T, N, 3) array
    "stacked": lambda: np.random.RandomState(5).randint(0, 9, (2, 3, 6, 3)),
    # one sample's decoded {resolution: (T, N, 3)}
    "decoded": lambda: _decoded(6),
    # the loader's collation: a list of per-sample decoded dicts
    "collated_list": lambda: [_decoded(7), _decoded(8)],
    # a dict of (B, T, N, 3) stacks
    "collated_stack": lambda: {k: np.stack([v, v]) for k, v in _decoded(9).items()},
}


@pytest.mark.parametrize("target_hw", [(32, 64), (8, 16), None])
@pytest.mark.parametrize("layout", sorted(POINT_INFO_CASES))
def test_point_info_matches_jax(layout, target_hw):
    """Every frame and batch element of each accepted layout, at the
    reference's ``w{W}xh{H}`` key, at the ``{H}x{W}`` key and with no
    target (the finest): the same mapping, padding stripped; a
    single-sample dict asked for element 1 raises in both."""
    unproj = POINT_INFO_CASES[layout]()
    for key in ("unprojections", "unprojection"):
        data = {key: unproj}
        batch = 1 if layout == "decoded" else 2
        for b in range(batch):
            for t in range(4):  # frame 3 is past the data's 3 frames
                want = JaxTrainer._point_info(JaxTrainer, data, t, b, target_hw)
                got = Trainer._point_info(Trainer, data, t, b, target_hw)
                if want is None:
                    assert got is None
                else:
                    np.testing.assert_array_equal(got, want)
    if layout == "decoded":
        for trainer in (JaxTrainer, Trainer):
            with pytest.raises(ValueError, match="single-sample"):
                trainer._point_info(trainer, {"unprojections": unproj}, 0, 1)
    assert Trainer._point_info(Trainer, {}, 0, 0) is None
    for key in ("w1024xh512", "512x1024", "W8XH4", "nonsense"):
        assert Trainer._resolution_hw(key) == JaxTrainer._resolution_hw(key)


# ------------------------------------------------------- partial layers


@pytest.mark.parametrize("mask,kernel", [(True, 3), (True, 1), (False, 3)])
def test_partial_conv2d_matches_jax(mask, kernel):
    """The masked conv, its window rescaling and the updated mask. The
    JAX layer runs eagerly: it cannot be traced (the next test)."""
    rng = np.random.RandomState(10 + kernel + 4 * mask)
    x = rng.randn(2, 12, 10, 3).astype(np.float32)
    m = (rng.rand(2, 12, 10, 1) < 0.4).astype(np.float32) if mask else None
    jmod = JaxPartialConv2d(5, kernel)
    variables = draw(jmod.init(jax.random.PRNGKey(0), x, m), seed=11)
    want_out, want_mask = jmod.apply(variables, x, m)
    tmod = load_flax_variables(PartialConv2d(3, 5, kernel), variables)
    with torch.no_grad():
        got_out, got_mask = tmod(to_torch(x), None if m is None else to_torch(m))
    np.testing.assert_allclose(to_nhwc(got_out), np.asarray(want_out), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(to_nhwc(got_mask), np.asarray(want_mask))


def test_jax_partial_conv_cannot_be_traced():
    """The JAX ``PartialConv2d`` takes ``float()`` of a traced product of
    its kernel size, so neither ``jit`` nor ``eval_shape`` can trace it:
    the JAX package's ``partial_conv`` generator runs only eagerly
    (ROADMAP.md, section C, C9)."""
    x = np.zeros((1, 4, 4, 3), np.float32)
    m = np.ones((1, 4, 4, 1), np.float32)
    jmod = JaxPartialConv2d(2, 3)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x, m))


@pytest.mark.parametrize("partial", [True, False])
def test_partial_spade_matches_jax(partial):
    """SPADE with the label and an (image, mask) condition at twice x's
    size: with ``partial`` the pair goes through a ``PartialConv2d``
    ``mlp_1`` (and the fused route is refused); without it the mask is
    dropped. BatchNorm base in eval mode (the configs' base). The JAX
    layer runs eagerly."""
    rng = np.random.RandomState(20 + partial)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    label = rng.randn(2, 16, 16, 5).astype(np.float32)
    g = guidance(rng, 2, 16)
    conds = (label, (g[..., :3], g[..., 3:]))
    jmod = JaxSpade(num_filters=4, kernel_size=3, partial=partial, fused_modulation="auto")
    variables = draw(jmod.init(jax.random.PRNGKey(0), x, *conds), seed=21)
    want = jmod.apply(variables, x, *conds)
    tmod = SpatiallyAdaptiveNorm(6, [5, (3, 1)], num_filters=4, kernel_size=3,
                                 partial=partial, fused_modulation="auto")
    load_flax_variables(tmod, variables).eval()
    assert isinstance(tmod.mlp_1, PartialConv2d) == partial
    with torch.no_grad():
        got = tmod(to_torch(x), to_torch(label), (to_torch(g[..., :3]), to_torch(g[..., 3:])))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def test_partial_spade_refuses_a_partial_condition_without_hidden_width():
    with pytest.raises(ValueError, match="num_filters > 0"):
        SpatiallyAdaptiveNorm(6, [5, (3, 1)], num_filters=0, partial=True)


# ------------------------------------------------------------ generator


GENERATOR_CASES = {
    "all_layers": {"gen": {"guidance": {"only_with_flow": False}}},
    "only_with_flow": {"gen": {"guidance": {"only_with_flow": True}}},
}


@pytest.fixture(scope="module")
def nets():
    """case -> (the JAX generator's drawn variables, its jitted apply, the
    port generator with those variables), built on first use."""
    built = {}

    def get(case):
        if case not in built:
            jcfg, tcfg = configs(GENERATOR_CASES[case])
            jnet = JaxGenerator(jcfg.gen, jcfg.data)
            variables = generator_vars(jnet)
            apply = jax.jit(lambda v, d: jnet.apply(
                v, d, training=False, mutable=["batch_stats", "spectral"])[0],
                compiler_options=CHEAP)
            tnet = load_flax_variables(Generator(tcfg.gen, tcfg.data), variables).eval()
            built[case] = (variables, apply, tnet)
        return built[case]

    return get


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_guidance_conditions_where_the_config_says(nets, case):
    """The up-layers' SPADE norms have one more condition where the
    guidance arrives (the bridge already held the tree to JAX's): the
    multi-SPADE layers (up_0, up_1) under ``only_with_flow``, every layer
    of the up loop (up_0..up_2) otherwise, none in the first frame's
    trunk."""
    tnet = nets(case)[2]
    for i in range(tnet.num_layers + 1):
        guided = i < 2 or (i == 2 and case != "only_with_flow")
        n_conds = 1 + (i < 2) + guided
        for norm in (m for m in getattr(tnet, f"up_{i}").modules()
                     if isinstance(m, SpatiallyAdaptiveNorm)):
            assert sorted(n for n, _ in norm.named_children() if n.startswith("gamma_")) \
                == [f"gamma_{k}" for k in range(n_conds)], i


def test_partial_conv_route_reads_the_mask():
    """Under ``partial_conv`` (and ``partial`` norms) the guidance is an
    (image, mask) pair through a ``PartialConv2d`` in each guided norm
    (the JAX generator cannot be traced there, C9, so this holds the
    port to the route's meaning): changing the guidance's colors where
    the mask is 0 leaves a warp frame unchanged, changing them where it
    is 1 does not; the plain route reads them everywhere."""
    rng = np.random.RandomState(50)
    data = {k: to_torch(v) for k, v in frames(51, 2).items() if k != "image"}
    off = torch.zeros_like(data["guidance"])
    off[:, :3] = torch.from_numpy(rng.randn(1, 3, HW, HW).astype(np.float32))
    off[:, :3] *= 1 - data["guidance"][:, 3:]
    on = off.clone()
    on[:, :3] = torch.flip(off[:, :3], dims=[2]) * data["guidance"][:, 3:]
    for case, extra in (("partial", PARTIAL), ("plain", {})):
        _, tcfg = configs(extra)
        torch.manual_seed(0)
        net = Generator(tcfg.gen, tcfg.data).eval()
        for p in net.parameters():
            if p.dim() > 1:
                torch.nn.init.normal_(p, 0, 1 / np.sqrt(p[0].numel()))
        partial = [n for n, m in net.named_modules() if isinstance(m, PartialConv2d)]
        assert (len(partial) > 0) == (case == "partial")
        assert all(n.startswith(("up_0.", "up_1.", "up_2.")) for n in partial)
        with torch.no_grad():
            base = net(data)["fake_images"]
            masked_off = net(dict(data, guidance=data["guidance"] + off))["fake_images"]
            masked_on = net(dict(data, guidance=data["guidance"] + on))["fake_images"]
        assert not torch.equal(base, masked_on)
        assert torch.equal(base, masked_off) == (case == "partial")


# (guidance setting, previous frames): first, continuation and warp
# frames; the first two read no guidance, so one setting covers them
@pytest.mark.parametrize("case,history", [
    ("all_layers", 0), ("all_layers", 1), ("all_layers", 2), ("only_with_flow", 2)])
def test_generator_matches_jax(nets, case, history):
    """Each frame type with the guidance in the data (the first and
    continuation frames ignore it): every output within 1e-5."""
    variables, apply, tnet = nets(case)
    data = {k: v for k, v in frames(40 + history, history).items() if k != "image"}
    want = apply(variables, {k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        got = tnet({k: to_torch(v) for k, v in data.items()})
    assert set(got) == set(want) == set(OUT_KEYS)
    if history == 2:
        want = dict(want, warped_images=jfs.resample(
            jnp.asarray(data["prev_images"][:, -1]),
            jnp.asarray(to_nhwc(got["fake_flow_maps"]))))
    for key in OUT_KEYS:
        if want[key] is None:
            assert got[key] is None, key
            continue
        scale = FLOW_MULTIPLIER if key == "fake_flow_maps" else 1
        np.testing.assert_allclose(to_nhwc(got[key]) / scale, np.asarray(want[key]) / scale,
                                   atol=1e-5, rtol=0, err_msg=key)
    assert (got["warped_images"] is not None) == (history == 2)
