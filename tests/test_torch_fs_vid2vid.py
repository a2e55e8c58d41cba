"""The port's fs-vid2vid against the JAX package on the CPU: the hyper
layers, the weight generator at K = 1 and K = 2, the generator under the
unit config's ``hyper_spatially_adaptive`` norm and under FaceForensics's
``spatially_adaptive`` (BatchNorm) norm. The training steps and
inference are in ``test_torch_fs_vid2vid_training.py``, which shares
these helpers (two files run side by side under ``--dist loadfile``).

The config is ``configs/unit_test/fs_vid2vid.yaml`` cut further (``CUT``),
at 32x32: 2 downsamples, embedders and flow networks 2 levels deep, one
residual block a flow network, attention one level down, one image
discriminator scale of one layer and VGG19 up to relu_1_1. XLA's CPU
compile time grows with the program and each JAX case here is one
compiled program. JAX variable shapes come from ``jax.eval_shape``;
leaves are drawn with numpy (kernels at 1/sqrt(fan_in), so the predicted
per-sample kernels have a real magnitude) and carried into the port by
``bridge.load_flax_variables``, which fails on a leaf left over or a port
tensor left unset: the port owns exactly the JAX tree's parameters.

Tolerances:
- ``per_sample_conv2d``, the hyper norm and ``HyperRes2dBlock``: 1e-5;
- the weight generator's outputs (encoding, label pyramid, predicted
  weights, attention): 1e-5; ``ref_idx`` exact;
- the generator: 1e-4 (flows in head units, divided by
  ``flow_output_multiplier``); each warp is held to the JAX warp of the
  port's own flow (a flow within 1e-4 head units moves a warped pixel by
  the image's slope times 2e-3 pixels);
- the steps and inference: see ``test_torch_fs_vid2vid_training.py``.
"""

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.layers import hyper_ops as jhyper
from imaginaire_tpu.layers.activation_norm import HyperSpatiallyAdaptiveNorm as JaxHyperNorm
from imaginaire_tpu.layers.residual import HyperRes2dBlock as JaxHyperRes
from imaginaire_tpu.model_utils import fs_vid2vid as jfs
from imaginaire_tpu.models.generators.fs_vid2vid import Generator as JaxGenerator
from imaginaire_tpu_torch.bridge import load_flax_variables
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.layers import HyperRes2dBlock, hyper_ops
from imaginaire_tpu_torch.layers.activation_norm import HyperSpatiallyAdaptiveNorm
from imaginaire_tpu_torch.model_utils import fs_vid2vid as tfs
from imaginaire_tpu_torch.models.generators.fs_vid2vid import Generator
from imaginaire_tpu_torch.trainers.fs_vid2vid import Trainer

CFG = "configs/unit_test/fs_vid2vid.yaml"
HW, LABELS = 32, 12
FLOW_MULTIPLIER = 20  # gen.flow.flow_output_multiplier of the config
LR = 1e-6
# drawn at 1/sqrt(fan_in), the flow heads give flows of ~80 pixels on a
# 32x32 frame: most samples clamp to the border, whole regions of the warp
# are one border pixel's value, and a kink (a leaky ReLU at 0, the clamp)
# that a 1e-5 difference moves across flips the gradient of the whole
# region (measured: 10% of a leaf's max). A trained flow network moves
# pixels by a few pixels: the heads are drawn 20x smaller (flows of a few
# pixels), where a kink moves one pixel's term
FLOW_HEAD_SCALE = 0.05
CUT = {
    "trainer": {"perceptual_loss": {"layers": ["relu_1_1"], "weights": [1.0]},
                "loss_weight": {"temporal_gan": 0.0}},
    "gen": {"num_downsamples": 2, "embed": {"num_downsamples": 2},
            "hyper": {"attention": {"num_downsamples": 1}},
            "flow": {"num_downsamples": 1, "num_blocks": 1,
                     "multi_spade_combine": {"embed": {"num_downsamples": 2}}}},
    "dis": {"image": {"num_discriminators": 1, "num_layers": 1}, "temporal": None},
    "gen_opt": {"lr": LR}, "dis_opt": {"lr": LR},
    "data": {"val": {"augmentations": {"resize_h_w": "32, 32"}},
             "train": {"augmentations": {"resize_h_w": "32, 32"}}},
}
SPADE = {"gen": {"activation_norm_type": "spatially_adaptive"}}  # FaceForensics's norm
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


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


def configs(*extra, k=1):
    overrides = merged(CUT, {"data": {"initial_few_shot_K": k}}, *extra)
    return JaxConfig(CFG, overrides=copy.deepcopy(overrides)), \
        Config(CFG, overrides=copy.deepcopy(overrides))


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


def frames(seed, b=1, k=1, t=0):
    """A frame's data: one-hot labels and tanh images, K references and
    ``t`` previous frames (absent when 0)."""
    rng = np.random.RandomState(seed)

    def labels(*lead):
        return np.eye(LABELS, dtype=np.float32)[rng.randint(0, LABELS, lead + (HW, HW))]

    def images(*lead):
        return np.tanh(rng.randn(*lead, HW, HW, 3)).astype(np.float32)

    d = {"label": labels(b), "ref_labels": labels(b, k), "ref_images": images(b, k)}
    if t:
        d["prev_labels"], d["prev_images"] = labels(b, t), images(b, t)
    d["image"] = images(b)
    return d


def g_data(d):
    return {k: v for k, v in d.items() if k != "image"}


def generator_vars(jnet, k, seed=1):
    """Drawn generator variables; the flow heads' kernels and biases
    scaled by ``FLOW_HEAD_SCALE``."""
    d = {k_: jnp.asarray(v) for k_, v in g_data(frames(0, k=k)).items()}
    key = jax.random.PRNGKey(0)
    variables = draw(jax.eval_shape(lambda: jnet.init({"params": key, "noise": key}, d,
                                                      training=True, init_all=True)), seed)
    for name, net in variables["params"].items():
        if name.startswith("flow_network"):
            net["conv_flow"]["conv"] = {k_: v * FLOW_HEAD_SCALE
                                        for k_, v in net["conv_flow"]["conv"].items()}
    return variables


def port_generator(tcfg, variables):
    net = Generator(tcfg.gen, tcfg.data)
    return load_flax_variables(net, variables).eval()


# ------------------------------------------------------------- layers


@pytest.mark.parametrize("stride,bias", [(1, True), (1, False), (2, True), (2, False)])
def test_per_sample_conv2d_matches_jax(stride, bias):
    """Each sample convolved with its own (kh, kw, cin, cout) kernel, XLA's
    SAME padding (0 before, 1 after at stride 2 on an even size)."""
    rng = np.random.RandomState(stride + 2 * bias)
    x = rng.randn(3, 10, 10, 4).astype(np.float32)
    w = rng.randn(3, 3, 3, 4, 5).astype(np.float32)
    b = rng.randn(3, 5).astype(np.float32) if bias else None
    want = jhyper.per_sample_conv2d(jnp.asarray(x), jnp.asarray(w),
                                    None if b is None else jnp.asarray(b), stride=stride)
    got = hyper_ops.per_sample_conv2d(to_torch(x), torch.from_numpy(w),
                                      None if b is None else torch.from_numpy(b),
                                      stride=stride)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_weights", [False, True])
def test_hyper_norm_matches_jax(with_weights):
    """Two conditions (one at half size, resized nearest): the first
    through the predicted per-sample conv or ``gb_0``, the second through
    ``gb_1``, applied in sequence; the first pair through the fused
    modulation's plain version on the CPU."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    conds = [rng.randn(2, 8, 8, 3).astype(np.float32),
             rng.randn(2, 4, 4, 5).astype(np.float32)]
    nw = ((rng.randn(2, 1, 1, 3, 12) * 0.5).astype(np.float32),
          (rng.randn(2, 12) * 0.1).astype(np.float32)) if with_weights else None
    jnorm = JaxHyperNorm(num_filters=0, kernel_size=1)
    jargs = [jnp.asarray(x)] + [jnp.asarray(c) for c in conds]
    jnw = None if nw is None else tuple(jnp.asarray(a) for a in nw)
    shapes = jax.eval_shape(lambda: jnorm.init(jax.random.PRNGKey(0), *jargs, norm_weights=jnw))
    variables = draw(shapes, seed=6)
    want = jnorm.apply(variables, *jargs, norm_weights=jnw)
    tnorm = HyperSpatiallyAdaptiveNorm(6, [3, 5], num_filters=0, kernel_size=1,
                                       hyper=with_weights)
    load_flax_variables(tnorm, variables)
    got = tnorm(to_torch(x), *[to_torch(c) for c in conds],
                norm_weights=None if nw is None else tuple(torch.from_numpy(a) for a in nw))
    assert hasattr(tnorm, "gb_0") != with_weights
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def test_hyper_res_block_matches_jax():
    """``HyperRes2dBlock`` (NACNAC, 8 -> 4 channels, a 1x1 shortcut) with
    per-sample conv kernels for both steps and hyper-SPADE weights for
    both norms: the block owns only its shortcut and the norms' second
    condition's convs."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 8, 8).astype(np.float32)
    conds = [rng.randn(2, 8, 8, 3).astype(np.float32),
             rng.randn(2, 8, 8, 2).astype(np.float32)]

    def pair(*shape):
        return ((rng.randn(2, *shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32),
                (0.1 * rng.randn(2, shape[-1])).astype(np.float32))

    conv_w = (pair(3, 3, 8, 4), pair(3, 3, 4, 4))
    norm_w = (pair(1, 1, 3, 16), pair(1, 1, 3, 8))
    anp = {"num_filters": 0, "kernel_size": 1}
    jblock = JaxHyperRes(4, weight_norm_type="spectral", activation_norm_params=anp,
                         order="NACNAC")

    def jw(ws):
        return tuple(tuple(jnp.asarray(a) for a in w) for w in ws)

    jargs = [jnp.asarray(x)] + [jnp.asarray(c) for c in conds]
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), *jargs,
                                                conv_weights=jw(conv_w),
                                                norm_weights=jw(norm_w)))
    variables = draw(shapes, seed=8)
    want = jblock.apply(variables, *jargs, conv_weights=jw(conv_w), norm_weights=jw(norm_w))

    def tw(ws):
        return tuple(tuple(torch.from_numpy(a) for a in w) for w in ws)

    tblock = HyperRes2dBlock(8, 4, weight_norm_type="spectral",
                             activation_norm_params=dict(anp, cond_dims=[3, 2]),
                             order="NACNAC", hyper_conv=True, hyper_norm=True)
    load_flax_variables(tblock, variables)
    got = tblock(to_torch(x), *[to_torch(c) for c in conds], conv_weights=tw(conv_w),
                 norm_weights=tw(norm_w))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("idx", [None, 1, "per_sample"])
def test_pick_image_matches_jax(idx):
    """The reference a sample uses: the first, a fixed one, or one a
    sample (the attention's ``ref_idx``)."""
    refs = np.random.RandomState(9).randn(3, 4, 5, 6, 2).astype(np.float32)
    per = np.array([2, 0, 3])
    jidx = jnp.asarray(per) if idx == "per_sample" else idx
    tidx = torch.from_numpy(per) if idx == "per_sample" else idx
    want = jfs.pick_image([jnp.asarray(refs), None], jidx)
    got = tfs.pick_image([to_torch(refs), None], tidx)
    assert got[1] is None and want[1] is None
    np.testing.assert_array_equal(to_nhwc(got[0]), np.asarray(want[0]))


# --------------------------------------------------- weight generator


def check_weight_generator(got, want):
    """The weight generator's outputs: the reference encoding, the label
    pyramid through the predicted embedding kernels, every predicted norm
    weight, and (K > 1) the attention and the reference it picks."""
    x, enc, conv_w, norm_w, atn, _, ref_idx = got
    np.testing.assert_allclose(to_nhwc(x), np.asarray(want[0]), atol=1e-5, rtol=0)
    for a, b in zip(enc, want[1]):
        np.testing.assert_allclose(to_nhwc(a), np.asarray(b), atol=1e-5, rtol=0)
    assert len(norm_w) == len(want[3]) == 2 and len(conv_w) == len(want[2])
    for layer, wlayer in zip(norm_w + conv_w, list(want[3]) + list(want[2])):
        for (w, b), (jw_, jb) in zip(layer, wlayer):
            np.testing.assert_allclose(w.numpy(), np.asarray(jw_), atol=1e-5, rtol=0)
            np.testing.assert_allclose(b.numpy(), np.asarray(jb), atol=1e-5, rtol=0)
    if atn is None:
        assert ref_idx is None and want[6] is None
    else:
        np.testing.assert_allclose(atn.numpy(), np.asarray(want[4]), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(ref_idx.numpy(), np.asarray(want[6]))


def test_weight_generator_at_k2_matches_jax():
    """K = 2 references: the attention module combines them and picks
    one a sample (K = 1 is held inside ``test_generator_matches_jax``);
    with ``is_hyper_conv`` the generator's conv kernels are predicted too
    (and its hyper blocks own no conv)."""
    jcfg, tcfg = configs({"gen": {"hyper": {"is_hyper_conv": True}}}, k=2)
    jnet = JaxGenerator(jcfg.gen, jcfg.data)
    variables = generator_vars(jnet, 2)
    d = frames(11, b=2, k=2)
    want = cheap_jit(lambda v, r, rl, lab: jnet.apply(
        v, r, rl, lab, True, method=lambda m, *a: m.weight_generator(*a)),
        variables, jnp.asarray(d["ref_images"]), jnp.asarray(d["ref_labels"]),
        jnp.asarray(d["label"]))
    net = port_generator(tcfg, variables)
    with torch.no_grad():
        got = net.weight_generator(to_torch(d["ref_images"]), to_torch(d["ref_labels"]),
                                   to_torch(d["label"]))
    assert got[4] is not None and len(got[2]) == 2
    assert not hasattr(net.up_0.conv_0, "conv") and hasattr(net.up_2.conv_0, "conv")
    check_weight_generator(got, want)


# ----------------------------------------------------------- generator


@pytest.fixture(scope="module")
def nets():
    """{norm: (JAX generator, variables, JAX config, port config)} for the
    unit config's hyper norm and FaceForensics's SPADE norm."""
    out = {}
    for name, extra in (("hyper", {}), ("spade", SPADE)):
        jcfg, tcfg = configs(extra)
        jnet = JaxGenerator(jcfg.gen, jcfg.data)
        out[name] = (jnet, generator_vars(jnet, 1, seed=2), jcfg, tcfg)
    return out


OUT_KEYS = ("fake_flow_maps", "fake_occlusion_masks", "warped_images")


def check_outputs(got, want, prev_images, ref_images):
    np.testing.assert_allclose(to_nhwc(got["fake_images"]), np.asarray(want["fake_images"]),
                               atol=1e-4, rtol=0, err_msg="fake_images")
    for key in OUT_KEYS:
        for j, (a, b) in enumerate(zip(got[key], want[key])):
            if b is None:
                assert a is None, (key, j)
                continue
            if key == "warped_images":
                # the JAX warp of the port's own flow
                src = ref_images[:, 0] if j == 0 else prev_images[:, -1]
                b = jfs.resample(jnp.asarray(src), jnp.asarray(to_nhwc(got["fake_flow_maps"][j])))
            scale = FLOW_MULTIPLIER if key == "fake_flow_maps" else 1
            np.testing.assert_allclose(to_nhwc(a) / scale, np.asarray(b) / scale,
                                       atol=1e-4, rtol=0, err_msg=f"{key}[{j}]")


@pytest.mark.parametrize("norm,t", [("hyper", 0), ("hyper", 1), ("spade", 1)])
def test_generator_matches_jax(nets, norm, t):
    """The first frame (the reference warp alone) and a frame with its
    previous frame (both warps) under the unit config's hyper norm, and
    the latter under FaceForensics's SPADE norm: every output, and the
    weight generator's at K = 1 (captured from the same JAX program)."""
    jnet, variables, _, tcfg = nets[norm]
    d = g_data(frames(20 + t, b=2, t=t))
    want, state = cheap_jit(lambda v, dd: jnet.apply(
        v, dd, training=False, capture_intermediates=lambda m, _: m.name == "weight_generator"),
        variables, {k: jnp.asarray(v) for k, v in d.items()})
    net = port_generator(tcfg, variables)
    captured = []
    net.weight_generator.register_forward_hook(lambda m, i, o: captured.append(o))
    with torch.no_grad():
        got = net({k: to_torch(v) for k, v in d.items()})
    assert (got["warped_images"][1] is None) == (t == 0)
    check_outputs(got, want, d.get("prev_images"), d["ref_images"])
    check_weight_generator(captured[0],
                           state["intermediates"]["weight_generator"]["__call__"][0])


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("what", ["finetune", "inference_finetune", "pose", "raw_output",
                                  "native", "evaluate"])
def test_still_refused_branches_raise_naming_the_roadmap(what, tmp_path):
    """The branches still refused raise naming the roadmap; the finetune
    (alone and before ``test``) and the pose path, once refused, run."""
    _, tcfg = configs()
    if what == "native":
        from imaginaire_tpu_torch.registry import resolve

        with pytest.raises(ModuleNotFoundError, match="ROADMAP"):
            resolve("imaginaire_tpu.data.paired_few_shot_videos_native", "Dataset")
        return
    if what == "raw_output":
        extra = {"gen": {"flow": {"generate_raw_output": True}}}
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Generator(configs(extra)[1].gen, configs(extra)[1].data)
        return
    if what == "pose":
        # pose labels: under 'open' the DensePose channels are cut first
        _, pose = configs({"data": {"for_pose_dataset": {"pose_type": "open"}}})
        net = Generator(pose.gen, pose.data).eval()
        assert net.is_pose_data and net.num_input_channels == LABELS - 3
        d = frames(60)
        with torch.no_grad():
            out = net({k: to_torch(v) for k, v in d.items() if k != "image"})
        assert out["fake_images"].shape == (1, 3, HW, HW)
        return
    if what == "evaluate":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(tcfg, device="cpu").write_metrics()
        return
    with pytest.raises(RuntimeError, match="train=True"):
        Trainer(tcfg, device="cpu").finetune({})
    trainer = Trainer(tcfg, device="cpu", train=True)
    trainer.init_state(seed=1)
    before = {n: p.detach().clone() for n, p in trainer.net_G.named_parameters()}
    if what == "finetune":
        d = frames(61)
        trainer.finetune({k: to_torch(d[k]) for k in ("ref_labels", "ref_images")},
                         {"finetune_iter": 1})
    else:
        from imaginaire_tpu_torch.data.loader import DataLoader
        from imaginaire_tpu_torch.data.paired_few_shot_videos import Dataset

        loader = DataLoader(Dataset(tcfg, is_inference=True), 1, shuffle=False,
                            drop_last=False)
        trainer.test(loader, str(tmp_path), {"finetune": True, "finetune_iter": 1,
                                             "driving_seq_index": 0})
        assert len(list(tmp_path.rglob("*.png"))) == 3
    mask = trainer.finetune_mask()
    assert trainer.has_finetuned and trainer.opt_G.count == 1
    assert all(torch.equal(p, before[n]) for n, p in trainer.net_G.named_parameters()
               if not mask[n])
