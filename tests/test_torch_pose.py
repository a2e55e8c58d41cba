"""The port's pose pieces against the JAX package's on the CPU: the
OpenPose decoder and renderer, the keypoint dicts through the
augmentation, the pose dataset item, the face and hand crops of G's
output, the weighted GAN and feature-matching losses, the vid2vid
discriminator with its region discriminators, and ``mlp_multiclass``.

Keypoints come from ``chip_smoke.py``'s seeded dancer
(``openpose_person``, ``write_pose_dataset``: the layout of the
repository's fixture, one frame with two dancers, frames with hands
missing). Random draws are injected: the JAX dataset and renderer draw
from the global ``random`` module, the port from the item's
``random.Random`` seeded with "<seed>/<epoch>/<index>", so
``random.seed`` of the same string makes both draw the same.

Tolerances: the decoder, the renderer and the dataset item bit for bit;
the keypoint moves 1e-5; the face crop fp32 1e-5 of the output's scale,
bf16 one bf16 ulp (2**-8) of it, its gradient 1e-5; the hand crop and
its validity exact; the losses rtol 1e-6; the discriminator's outputs
and features 1e-5; ``mlp_multiclass`` 1e-5 (outputs, BatchNorm's
running statistics after a training forward).
"""

import copy
import json
import random

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import openpose_person, write_pose_dataset
from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.data.augment import Augmentor as JaxAugmentor
from imaginaire_tpu.data.paired_videos import Dataset as JaxDataset
from imaginaire_tpu.losses.feature_matching import feature_matching_loss as jax_fm
from imaginaire_tpu.losses.gan import gan_loss as jax_gan
from imaginaire_tpu.model_utils import fs_vid2vid as jfs
from imaginaire_tpu.models.discriminators.fs_vid2vid import Discriminator as JaxDis
from imaginaire_tpu.models.discriminators.mlp_multiclass import Discriminator as JaxMlp
from imaginaire_tpu.models.generators.vid2vid import Generator as JaxGenerator
from imaginaire_tpu.utils.data import get_paired_input_label_channel_number as jax_channels
from imaginaire_tpu.utils.visualization import pose as jpose
from imaginaire_tpu_torch.bridge import load_flax_variables
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.augment import Augmentor
from imaginaire_tpu_torch.data.paired_videos import Dataset
from imaginaire_tpu_torch.layers import activation_norm
from imaginaire_tpu_torch.losses import feature_matching_loss, gan_loss
from imaginaire_tpu_torch.model_utils import fs_vid2vid as tfs
from imaginaire_tpu_torch.models.discriminators.fs_vid2vid import Discriminator
from imaginaire_tpu_torch.models.discriminators.mlp_multiclass import Discriminator as Mlp
from imaginaire_tpu_torch.models.generators.vid2vid import Generator
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.utils.visualization import pose as tpose

CFG = "configs/unit_test/vid2vid_pose.yaml"
DANCING = "configs/projects/vid2vid/dancing/bf16.yaml"
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
HW = 64
RAW_HW = (96, 120)
TYPES = [
    {"images": dict(ext="png", num_channels=3, interpolator="BILINEAR", normalize=True)},
    {"poses-openpose": dict(
        ext="json", num_channels=27, interpolator="NEAREST", normalize=False,
        pre_aug_ops="decode_json, convert::imaginaire_tpu.utils.visualization.pose::"
                    "openpose_to_npy_largest_only",
        post_aug_ops="vis::imaginaire_tpu.utils.visualization.pose::draw_openpose_npy")}]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cheap_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=CHEAP)(*args)


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2))).to(dtype)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def frame_json(seed, h=256, w=320, people=1, hands=(True, True)):
    """A decoded OpenPose JSON frame: the seeded dancer (and a smaller
    one beside it)."""
    rng = np.random.RandomState(seed)
    out = [openpose_person(w / 2, 0.2 * h, 0.6 * h, seed * 0.7, rng, hands)]
    if people == 2:
        out.append(openpose_person(0.15 * w, 0.5 * h, 0.3 * h, seed, rng))
    return json.loads(json.dumps({"people": out}))


# ------------------------------------------------------------- renderer


def test_openpose_decoding_matches_jax():
    """Frame lists, a bare people list, largest-only on a two-dancer
    frame (the tall one), and a frame with no one."""
    frames = [frame_json(1), frame_json(2, people=2), {"people": []}]
    for largest in (False, True):
        want = jpose.openpose_to_npy(copy.deepcopy(frames), largest)
        got = tpose.openpose_to_npy(copy.deepcopy(frames), largest)
        assert len(got) == len(want) == 3 and got[2] is want[2] is None
        for g, w in zip(got[:2], want[:2]):
            g, w = (g, w) if largest else (g[-1], w[-1])
            assert set(g) == set(w) == {"pose", "face", "hand_l", "hand_r"}
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    two = tpose.openpose_to_npy_largest_only(frame_json(2, people=2))
    np.testing.assert_array_equal(two["pose"], tpose.openpose_to_npy(frame_json(2, people=2))[0]["pose"])
    bare = frame_json(3)["people"]
    np.testing.assert_array_equal(tpose.openpose_to_npy(bare)[0]["face"],
                                  jpose.openpose_to_npy(bare)[0]["face"])


@pytest.mark.parametrize("one_hot,basic,no_face,drop,people", [
    (False, False, False, 0.0, 1), (True, False, False, 0.0, 1),
    (True, True, False, 0.0, 1), (True, False, True, 0.0, 2),
    (False, False, False, 0.05, 2), (True, False, False, 0.05, 1)])
def test_renderer_matches_jax(one_hot, basic, no_face, drop, people):
    """``draw_openpose_npy`` on the colored (3-channel) and one-hot
    (27-channel) canvases, with ``basic_points_only``,
    ``remove_face_labels``, a frame with no one, every person of a
    two-dancer frame drawn, a missing hand, and ``random_drop_prob`` 0.05
    with the draws injected: bit for bit."""
    cfgdata = {"for_pose_dataset": dict(pose_one_hot=one_hot, basic_points_only=basic,
                                        remove_face_labels=no_face, random_drop_prob=drop)}
    frames = [frame_json(4, people=people), frame_json(5, hands=(False, True)), None]
    decoded = [jpose.openpose_to_npy(f, people == 1) if f else None for f in frames]
    geometry = (256, 320, 256, 320, 256, 320, False)
    random.seed("0/0/7")
    want = jpose.draw_openpose_npy(*geometry, cfgdata, copy.deepcopy(decoded))
    rng = random.Random("0/0/7")
    got = tpose.draw_openpose_npy(*geometry, cfgdata, copy.deepcopy(decoded), rng=rng)
    assert rng.random() == random.random()  # the same number of draws
    assert len(got) == 3 and got[0].shape == (256, 320, 27 if one_hot else 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got[0].max() == 1.0 and not got[2].any()
    if one_hot:  # the second frame has no left hand; basic points draw no hand
        assert got[1][..., 24].max() == 0 and got[1][..., 25].max() == float(not basic)
        assert bool(got[0][..., 26].any()) == (not (basic or no_face))


@pytest.mark.parametrize("aug", [
    dict(resize_smallest_side=64, random_scale_limit=0.2, random_crop_h_w="64, 64",
         horizontal_flip=True),
    dict(resize_h_w="48, 80", center_crop_h_w="40, 64", horizontal_flip=True)])
def test_keypoint_dicts_move_with_the_images_as_in_jax(aug):
    """A largest-only frame (a dict of groups) and a two-dancer frame (a
    list of them) through resize, scale, crop and flip: x and y move,
    the confidence column is kept (1e-5)."""
    frames = [jpose.openpose_to_npy(frame_json(6), True),
              jpose.openpose_to_npy(frame_json(7, people=2))]
    images = [np.zeros((256, 320, 3), np.uint8)] * 2
    for seed in range(4):
        random.seed(f"0/0/{seed}")
        want, wflip = JaxAugmentor(aug, keypoint_data_types=["kp"]).perform_augmentation(
            {"images": list(images), "kp": copy.deepcopy(frames)})
        got, gflip = Augmentor(aug, keypoint_data_types=["kp"]).perform_augmentation(
            {"images": list(images), "kp": copy.deepcopy(frames)}, random.Random(f"0/0/{seed}"))
        assert gflip == wflip
        people = [(got["kp"][0], want["kp"][0])] + list(zip(got["kp"][1], want["kp"][1]))
        assert len(people) == 3
        for g, w in people:
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(got["kp"][0]["pose"][:, 2], frames[0]["pose"][:, 2])


# --------------------------------------------------------------- dataset


@pytest.fixture(scope="module")
def pose_root(tmp_path_factory):
    return write_pose_dataset(tmp_path_factory.mktemp("pose"), hw=RAW_HW, packed=False)


def data_overrides(root, drop=0.0):
    aug = dict(resize_smallest_side=HW, random_scale_limit=0.2,
               random_crop_h_w=f"{HW}, {HW}", horizontal_flip=True)
    return dict(data=dict(input_types=copy.deepcopy(TYPES),
                          for_pose_dataset=dict(random_drop_prob=drop),
                          train=dict(roots=[root], augmentations=aug),
                          val=dict(roots=[root], augmentations=dict(
                              resize_smallest_side=HW, center_crop_h_w=f"{HW}, {HW}"))))


@pytest.mark.parametrize("drop,inference", [(0.0, False), (0.05, False), (0.0, True)])
def test_dataset_items_match_jax(pose_root, drop, inference):
    """The unit pose config's items (PNG frames and OpenPose JSON, 3
    frames a window; training: a scale, a crop, a flip and the strokes'
    drops drawn; inference: the centre crop) equal the JAX dataset's,
    with no keypoint stash for dict frames."""
    o = data_overrides(pose_root, drop)
    jds = JaxDataset(JaxConfig(CFG, overrides=copy.deepcopy(o)), is_inference=inference)
    tds = Dataset(Config(CFG, overrides=copy.deepcopy(o)), is_inference=inference)
    assert len(tds) == len(jds) == 4
    for i in range(len(tds)):
        random.seed(f"0/0/{i}")
        want = jds[i]
        got = tds[i]
        assert set(got) == set(want) == {"images", "label", "is_flipped", "key"}
        assert got["label"].shape == (3 if not inference else 1, HW, HW, 27)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v


def test_c12_committed_config_renders_3_channels_and_the_port_refuses(pose_root):
    """configs/projects/vid2vid/dancing/bf16.yaml declares 27 label
    channels and sets no ``pose_one_hot``: the JAX loader renders 3
    colored channels, where ``get_paired_input_label_channel_number``
    (which sizes the networks) counts 27. The port refuses the item,
    naming ROADMAP.md; with ``pose_one_hot: True`` both render 27."""
    o = dict(data=dict(train=dict(roots=[pose_root]), val=dict(roots=[pose_root])))
    jcfg, tcfg = JaxConfig(DANCING, overrides=copy.deepcopy(o)), Config(DANCING, overrides=o)
    for cfg in (jcfg, tcfg):
        cfg.data.input_types[0]["images"]["ext"] = "png"
    jds, tds = JaxDataset(jcfg), Dataset(tcfg)
    for ds in (jds, tds):
        ds.set_sequence_length(1)
    random.seed("0/0/0")
    assert jds[0]["label"].shape == (1, 512, 512, 3) and jax_channels(jcfg.data) == 27
    with pytest.raises(ValueError, match="renders 3 channels.*27.*ROADMAP"):
        tds[0]
    for cfg in (jcfg, tcfg):
        cfg.data.for_pose_dataset.pose_one_hot = True
    jds, tds = JaxDataset(jcfg), Dataset(tcfg)
    for ds in (jds, tds):
        ds.set_sequence_length(1)
    random.seed("0/0/0")
    np.testing.assert_array_equal(tds[0]["label"], jds[0]["label"])
    assert tds[0]["label"].shape[-1] == 27


def test_c12_dancing_spade_norms_have_a_batchnorm_base(monkeypatch):
    """The dancing config's ``base_norm: instance`` (and the comment that
    its epilogue fuses) is not read: ``activation_norm_params`` has no
    ``activation_norm_type``, so both packages default the SPADE base to
    ``sync_batch``, and a G forward calls the modulation op 0 times."""
    narrow = dict(gen=dict(num_filters=4, max_num_filters=16, flow=dict(
        num_filters=4, max_num_filters=16, multi_spade_combine=dict(embed=dict(num_filters=4))),
        embed=dict(num_filters=4)))
    jcfg, tcfg = JaxConfig(DANCING, overrides=narrow), Config(DANCING, overrides=narrow)
    assert "activation_norm_type" not in tcfg.gen.activation_norm_params
    label = jnp.zeros((1, 512, 512, 27))  # the config's crop sets G's start size
    shapes = jax.eval_shape(lambda: JaxGenerator(jcfg.gen, jcfg.data).init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        {"label": label, "images": label[..., :3]}, training=True, init_all=True))
    assert set(shapes["batch_stats"]["up_0"]["conv_0"]["norm"]["BatchNorm_0"]["BatchNorm_0"]) \
        == {"mean", "var"}
    net = Generator(tcfg.gen, tcfg.data).eval()
    spade = [m for m in net.modules() if isinstance(m, activation_norm.SpatiallyAdaptiveNorm)]
    assert spade and {m.base_norm for m in spade} == {"sync_batch"}
    calls = []
    monkeypatch.setattr(activation_norm, "spade_modulation",
                        lambda *a: calls.append(1) or 1 / 0)
    with torch.no_grad():
        out = net({"label": torch.zeros(1, 27, 512, 512)})
    assert calls == [] and out["fake_images"].shape == (1, 3, 512, 512)


# ----------------------------------------------------------------- crops


CROP_H, CROP_W = 256, 288  # the face patch 64², the boxes 32 to 256: both ways


def pose_labels(b=4, h=CROP_H, w=CROP_W):
    """One-hot pose labels with face boxes that the crop upsamples
    (sample 0: the 32 px floor), downsamples (1: the frame's height), a
    default box (2: no face), and one at the frame's corner (3); hands
    present or absent sample by sample."""
    pose = np.zeros((b, h, w, 27), np.float32)
    pose[0, 80:83, 120:123, -1] = 1
    pose[1, 8:240, 16:270, -1] = 1
    pose[3, 0:10, 250:288, -1] = 1
    pose[0, 120:160, 40:64, -3] = pose[1, 200:250, 240:280, -2] = 1
    pose[3, 0:5, 0:9, -3] = pose[3, 250:256, 280:288, -2] = 1
    return pose


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_face_crop_matches_jax(dtype):
    """The boxes exactly, and the (H // 32 * 8)² patch of
    ``scale_and_translate(method="linear")`` (antialiased when it
    shrinks): fp32 within 1e-5 of the output's scale, bf16 within one
    bf16 ulp of it."""
    cfg = {"input_labels": ["poses-openpose"]}
    pose = pose_labels()
    img = np.random.RandomState(0).randn(4, CROP_H, CROP_W, 5).astype(np.float32)
    want_box = np.asarray(jfs.get_face_bbox_for_output(cfg, jnp.asarray(pose)))
    got_box = tfs.get_face_bbox_for_output(cfg, nchw(pose)).numpy()
    np.testing.assert_array_equal(got_box, want_box)
    sides = want_box[:, 1] - want_box[:, 0]
    assert sides.tolist() == [32, 256, 64, 92]  # up- and downsampled to 64
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(cheap_jit(lambda i, p: jfs.crop_face_from_output(cfg, i, p),
                                jnp.asarray(img).astype(jdt), jnp.asarray(pose))).astype(np.float32)
    got = tfs.crop_face_from_output(cfg, nchw(img, tdt), nchw(pose))
    assert got.dtype == tdt and got.shape == (4, 3, 64, 64)
    scale = np.abs(want).max()
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    assert np.abs(nhwc(got) - want).max() <= tol * scale
    stacked = tfs.crop_face_from_output(cfg, [nchw(img)] * 2, nchw(pose))
    assert isinstance(stacked, list) and len(stacked) == 2


def test_face_crop_gradient_matches_jax_vjp():
    cfg = {"input_labels": ["poses-openpose"]}
    pose = pose_labels()
    rng = np.random.RandomState(1)
    img = rng.randn(4, CROP_H, CROP_W, 3).astype(np.float32)
    cot = rng.randn(4, 64, 64, 3).astype(np.float32)
    want = np.asarray(cheap_jit(lambda i, p, c: jax.vjp(
        lambda x: jfs.crop_face_from_output(cfg, x, p), i)[1](c)[0],
        jnp.asarray(img), jnp.asarray(pose), jnp.asarray(cot)))
    x = nchw(img).requires_grad_(True)
    tfs.crop_face_from_output(cfg, x, nchw(pose)).backward(nchw(cot))
    assert np.abs(nhwc(x.grad) - want).max() <= 1e-5 * np.abs(want).max()


def test_hand_crop_matches_jax():
    """Both hands' windows stacked on the batch (left, then right), the
    absent ones weighted out by the (2B,) validity, exactly as the JAX
    crop; its gradient reaches G's frame."""
    cfg = {"input_labels": ["poses-openpose"]}
    pose = pose_labels()
    img = np.random.RandomState(2).randn(4, CROP_H, CROP_W, 4).astype(np.float32)
    want, want_valid = cheap_jit(lambda i, p: jfs.crop_hand_from_output(cfg, i, p),
                                 jnp.asarray(img), jnp.asarray(pose))
    x = nchw(img).requires_grad_(True)
    got, valid = tfs.crop_hand_from_output(cfg, x, nchw(pose))
    assert got.shape == (8, 3, 32, 32) and valid.dtype == torch.float32
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    assert valid.tolist() == [1, 0, 0, 1, 0, 1, 0, 1]
    got.sum().backward()
    assert x.grad[:, -3:].sum() == got.numel() and x.grad[:, 0].abs().sum() == 0


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("weights", ["ones", "mixed", "zeros"])
def test_weighted_gan_and_feature_matching_match_jax(weights):
    """``sample_weight`` (B,) over per-scale logits in every GAN mode
    (D and G forms) and over L1 and L2 feature matching: a per-sample
    mean weighted by the weights over their sum, floored at 1e-6."""
    rng = np.random.RandomState(3)
    w = {"ones": np.ones(4), "mixed": np.array([1.0, 0.0, 1.0, 0.5]),
         "zeros": np.zeros(4)}[weights].astype(np.float32)
    logits = [rng.randn(4, 1, 5, 5).astype(np.float32), rng.randn(4, 1, 3, 3).astype(np.float32)]
    jl, tl = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in logits], [torch.from_numpy(x) for x in logits]
    for mode in ("hinge", "least_square", "non_saturated", "wasserstein"):
        for t_real, dis_update in ((True, True), (False, True), (True, False)):
            want = float(jax_gan(jl, t_real, mode, dis_update, sample_weight=jnp.asarray(w)))
            got = float(gan_loss(tl, t_real, mode, dis_update, sample_weight=torch.from_numpy(w)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=mode)
    feats = [[rng.randn(4, 6, 4, 4).astype(np.float32) for _ in range(2)] for _ in range(4)]
    for criterion in ("l1", "l2"):
        want = float(jax_fm([[jnp.asarray(f.transpose(0, 2, 3, 1)) for f in d] for d in feats[:2]],
                            [[jnp.asarray(f.transpose(0, 2, 3, 1)) for f in d] for d in feats[2:]],
                            criterion, sample_weight=jnp.asarray(w)))
        got = float(feature_matching_loss([[torch.from_numpy(f) for f in d] for d in feats[:2]],
                                          [[torch.from_numpy(f) for f in d] for d in feats[2:]],
                                          criterion, sample_weight=torch.from_numpy(w)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=criterion)
    if weights == "zeros":
        assert got == 0.0


# ---------------------------------------------------------- discriminator


def draw(shapes, seed=0):
    """Numpy values for a flax tree: kernels at 1/sqrt(fan_in), unit u,
    positive variances, the rest near their initial values."""
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


def rendered_labels(b=2):
    """(B, HW, HW, 27) labels rendered by the port from the seeded dancer
    (sample 1 with no left hand)."""
    cfgdata = {"for_pose_dataset": {"pose_one_hot": True}}
    frames = [tpose.openpose_to_npy_largest_only(frame_json(10 + i, h=HW, w=HW,
                                                            hands=(i == 0, True)))
              for i in range(b)]
    return np.stack(tpose.draw_openpose_npy(HW, HW, HW, HW, HW, HW, False, cfgdata, frames))


def test_discriminator_with_region_ds_matches_jax():
    """The unit pose config's D (image D, temporal scale, face and hand
    Ds) with the JAX variables bridged path for path (``net_D_face``,
    ``net_D_hand``): every output and feature within 1e-5, the hands'
    validity exactly."""
    jcfg, tcfg = JaxConfig(CFG), Config(CFG)
    label = rendered_labels()
    rng = np.random.RandomState(4)
    real, fake = (np.tanh(rng.randn(2, HW, HW, 3)).astype(np.float32) for _ in range(2))
    past = [tuple(np.tanh(rng.randn(2, 2, HW, HW, 3)).astype(np.float32) for _ in range(2))]
    jnet = JaxDis(jcfg.dis, jcfg.data)
    jd = {"label": jnp.asarray(label), "image": jnp.asarray(real)}
    jout = {"fake_images": jnp.asarray(fake)}
    jpast = [tuple(jnp.asarray(p) for p in past[0])]
    variables = draw(jax.eval_shape(lambda: jnet.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jd, jout, past_stacks=jpast, training=True)), seed=5)
    assert {"net_D_face", "net_D_hand"} <= set(variables["params"])
    want = cheap_jit(lambda v, d, o, p: jnet.apply(v, d, o, past_stacks=p, training=False),
                     variables, jd, jout, jpast)
    tnet = Discriminator(tcfg.dis, tcfg.data).eval()
    load_flax_variables(tnet, variables)
    with torch.no_grad():
        got = tnet({"label": nchw(label), "image": nchw(real)}, {"fake_images": nchw(fake)},
                   past_stacks=[tuple(torch.from_numpy(np.ascontiguousarray(
                       p.transpose(0, 1, 4, 2, 3))) for p in past[0])])
    assert set(got) == set(want) == {"indv", "face", "hand", "temporal_0"}
    np.testing.assert_array_equal(got["hand"]["valid"].numpy(), np.asarray(want["hand"]["valid"]))
    assert got["hand"]["valid"].tolist() == [1, 0, 1, 1] and "valid" not in got["face"]
    for name in want:
        for side in ("pred_real", "pred_fake"):
            for kind in ("outputs", "features"):
                w_leaves = jax.tree_util.tree_leaves(want[name][side][kind])
                g_leaves = jax.tree_util.tree_leaves(got[name][side][kind])
                assert len(w_leaves) == len(g_leaves) > 0
                for g, w in zip(g_leaves, w_leaves):
                    np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-5,
                                               err_msg=f"{name} {side} {kind}")


# --------------------------------------------------------- mlp_multiclass


MLP_CFG = {"num_labels": 7, "num_filters": 16, "num_layers": 4}


@pytest.fixture(scope="module")
def mlp():
    x = np.random.RandomState(6).randn(8, 3, 5).astype(np.float32)
    jnet = JaxMlp(MLP_CFG)
    shapes = jax.eval_shape(lambda: jnet.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        {"data": jnp.asarray(x)}, training=False))
    variables = draw(shapes, seed=7)
    tnet = resolve("imaginaire_tpu.models.discriminators.mlp_multiclass", "Discriminator")(
        dict(MLP_CFG, in_features=15))
    assert isinstance(tnet, Mlp)
    load_flax_variables(tnet, variables)
    return jnet, variables, tnet, x


def test_mlp_multiclass_eval_matches_jax(mlp):
    """fc_in and 4 hidden LinearBlocks (dense, BatchNorm on its running
    statistics, leaky ReLU), dropout off, fc_out's 7 scores: 1e-5."""
    jnet, variables, tnet, x = mlp
    want = cheap_jit(lambda v, d: jnet.apply(v, {"data": d}, training=False)["results"],
                     variables, jnp.asarray(x))
    with torch.no_grad():
        got = tnet.eval()({"data": torch.from_numpy(x)})["results"]
    assert got.shape == (8, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert [d.p for d in tnet.dropouts] == [0.1, 0.15000000000000002, 0.22500000000000003,
                                            0.3375, 0.5]


def test_mlp_multiclass_training_mode_matches_jax(mlp):
    """Training mode: BatchNorm's batch statistics and the running
    statistics they move to (1e-5), and flax's dropout masks, recovered
    from the JAX run's ``dropout`` stream (the zeros of each dropout's
    output), injected into the port's dropouts."""
    jnet, variables, tnet, x = mlp
    (want, mut), inter = cheap_jit(lambda v, d: (
        lambda r: ((r[0]["results"], {"batch_stats": r[1]["batch_stats"]}),
                   r[1]["intermediates"]))(jnet.apply(
                       v, {"data": d}, training=True, rngs={"dropout": jax.random.PRNGKey(3)},
                       mutable=["batch_stats", "intermediates"],
                       capture_intermediates=lambda m, _: isinstance(m, flax.linen.Dropout))),
        variables, jnp.asarray(x))
    masks = [np.asarray(inter[f"Dropout_{i}"]["__call__"][0]) != 0 for i in range(5)]
    assert all(0 < (~m).mean() < 0.7 for m in masks)

    class Injected(torch.nn.Module):
        def __init__(self, mask, p):
            super().__init__()
            self.mask, self.p = torch.from_numpy(mask), p

        def forward(self, v):
            return torch.where(self.mask, v / (1.0 - self.p), torch.zeros_like(v))

    net = copy.deepcopy(tnet).train()
    for layer in net.modules():
        if hasattr(layer, "update_state"):
            layer.update_state = True
    net.dropouts = torch.nn.ModuleList(Injected(m, d.p) for m, d in zip(masks, net.dropouts))
    got = net({"data": torch.from_numpy(x)})["results"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    stats = dict(net.named_buffers())
    for path, value in flax.traverse_util.flatten_dict(flax.core.unfreeze(mut["batch_stats"])).items():
        name = f"{path[0]}.norm.{path[-1]}"  # flax: <block>/norm/BatchNorm_0/<stat>
        np.testing.assert_allclose(stats[name].numpy(), np.asarray(value), rtol=0, atol=1e-5,
                                   err_msg=name)
