"""wc-vid2vid's training steps, the single-image takeover, the data item
and the entries in the port against the JAX package on the CPU, on the
unit config of ``test_torch_wc_vid2vid.py`` (whose helpers this file
shares) cut further (``CUT``: one image-discriminator scale, no temporal
discriminator, VGG19 up to relu_1_1, ``loss_weight.guidance`` 20).

- one fp32 warp-frame D step and G step with guidance: the losses (the
  ``Guidance`` term among them) to rtol 1e-4, the parameters after Adam's
  first step to rtol 1e-4 (and within 0.25 lr where a gradient is over 1%
  of the network's largest, as in ``test_torch_fs_vid2vid_training.py``),
  and the whole gradient within 5e-3 in L2 (``GRAD_TOL``);
- the takeover: a tiny single-image SPADE generator (widths 8, the wc
  data's 12 labels) with the JAX variables and the JAX z injected,
  frames within 1e-4; the port's rollout skips the takeover frames'
  steps and colors the point cloud with them;
- a dataset item with pickled unprojections (``convert::`` op) equal to
  the JAX dataset's item, the unprojections array for array;
- the single-image checkpoint route (a port SPADE trainer's checkpoint,
  by path and by logdir) and its refusals;
- ``train.main`` for 2 iterations and ``inference.main`` on a tiny
  folder dataset with unprojection pickles, the renderer reset at each
  sequence;
- both committed wc configs' full-width generator trees against the JAX
  ``jax.eval_shape`` tree (on the meta device, through the bridge).
"""

import copy
import pickle
import random

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.data.paired_videos import Dataset as JaxDataset
from imaginaire_tpu.models.generators.wc_vid2vid import Generator as JaxGenerator
from imaginaire_tpu.models.generators.spade import Generator as JaxSpadeGenerator
from imaginaire_tpu.trainers.wc_vid2vid import Trainer as JaxTrainer
from imaginaire_tpu_torch import inference, train
from imaginaire_tpu_torch.bridge import load_flax_variables, to_port_layout
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.paired_videos import Dataset
from imaginaire_tpu_torch.data.png import write_png
from imaginaire_tpu_torch.model_utils import wc_vid2vid as twc
from imaginaire_tpu_torch.trainers.spade import Trainer as SpadeTrainer
from imaginaire_tpu_torch.trainers.wc_vid2vid import Trainer
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
from imaginaire_tpu_torch.models.generators.wc_vid2vid import Generator
from imaginaire_tpu_torch.utils.data import get_paired_input_label_channel_number
from imaginaire_tpu_torch.utils.meters import ScalarWriter
from test_torch_wc_vid2vid import (  # noqa: E402
    CFG,
    HW,
    LABELS,
    cheap_jit,
    draw,
    frames,
    generator_vars,
    merged,
    to_nhwc,
    to_torch,
)

FULL = ("configs/projects/wc_vid2vid/mannequin/hed_bf16.yaml",
        "configs/projects/wc_vid2vid/cityscapes/seg_bf16.yaml")
LR = 1e-6
# the whole gradient's relative L2 difference. The JAX fp32 G-step program
# is the noisier side here: measured on this step, the JAX fp32 gradient
# differs from the same step in float64 (JAX, and the port, which agree
# to 1.9e-4 of a leaf's max) by up to 3.2e-2 of a leaf's max
# (res_2.conv_1.conv.weight, behind BatchNorms of batch 1), the port's
# fp32 gradient by 7.4e-4; the two fp32 gradients differ by 2.3e-3 in L2
GRAD_TOL = 5e-3
CUT = {
    "trainer": {"perceptual_loss": {"layers": ["relu_1_1"], "weights": [1.0]},
                "loss_weight": {"temporal_gan": 0.0, "guidance": 20.0}},
    "dis": {"image": {"num_discriminators": 1}, "temporal": None},
    "gen_opt": {"lr": LR}, "dis_opt": {"lr": LR},
}
SINGLE = {"gen": {"num_filters": 8, "style_dims": 16, "style_enc": {"num_filters": 4},
                  "activation_norm_params": {"num_filters": 8}}}
DATA_TYPES = [
    {"images": {"ext": "png", "num_channels": 3, "interpolator": "BILINEAR",
                "normalize": True}},
    {"seg_maps": {"ext": "png", "num_channels": LABELS, "interpolator": "NEAREST",
                  "is_mask": True}},
    {"unprojections": {"ext": "pkl", "post_aug_ops":
                       "convert::imaginaire_tpu.model_utils.wc_vid2vid::decode_unprojections"}},
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def configs(*extra):
    overrides = merged(CUT, *extra)
    return JaxConfig(CFG, overrides=copy.deepcopy(overrides)), \
        Config(CFG, overrides=copy.deepcopy(overrides))


def single_config(tmp_path):
    """A tiny single-image SPADE yaml on the wc data's images and labels."""
    cfg = yaml.safe_load(open("configs/unit_test/spade.yaml"))
    cfg = merged(cfg, SINGLE)
    cfg["data"]["input_types"] = copy.deepcopy(DATA_TYPES[:2])
    cfg["data"]["input_labels"] = ["seg_maps"]
    path = tmp_path / "single.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


# ---------------------------------------------------------------- steps


@pytest.fixture(scope="module")
def train_pair():
    jcfg, tcfg = configs()
    jt = JaxTrainer(jcfg)
    d = {k: jnp.asarray(v) for k, v in frames(30, 2).items()}
    key = jax.random.PRNGKey(0)
    variables = {
        "G": generator_vars(jt.net_G, seed=3),
        "D": draw(jax.eval_shape(lambda: jt.net_D.init(
            {"params": key, "dropout": key}, d, {"fake_images": d["image"]},
            past_stacks=[], training=True)), seed=4),
        "VGG": draw(jax.eval_shape(lambda: jt.perceptual.module.init(
            key, jnp.zeros((1, HW, HW, 3)))), seed=5)["params"]}
    return jt, tcfg, variables


def jax_step(jt, kind, variables, data_t):
    state = {"vars_G": variables["G"], "vars_D": variables["D"],
             "loss_params": {"perceptual": variables["VGG"]}}
    net, other, fwd = (("vars_D", "vars_G", jt.dis_forward) if kind == "D"
                       else ("vars_G", "vars_D", jt.gen_forward))

    def loss_fn(params):
        own = dict(state[net], params=params)
        args = (state[other], own) if kind == "D" else (own, state[other])
        res = fwd(*args, state["loss_params"], data_t, jax.random.PRNGKey(0))
        losses = {k: v.astype(jnp.float32) for k, v in res[0].items()}
        total = jt._total(losses)
        return total, dict(losses, total=total)

    (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(state[net]["params"])
    return losses, grads


def port_trainer(tcfg, variables):
    trainer = Trainer(tcfg, device="cpu", train=True)
    trainer.init_state(seed=0)
    load_flax_variables(trainer.net_G, variables["G"])
    load_flax_variables(trainer.net_D, variables["D"])
    load_flax_variables(trainer.perceptual.module, {"params": variables["VGG"]})
    return trainer


@pytest.mark.parametrize("kind", ["D", "G"])
def test_warp_frame_step_with_guidance_matches_jax(train_pair, kind):
    """One fp32 D step and one G step on a warp frame with its guidance:
    the losses, every gradient, and the parameters after Adam's first
    step. The G step's ``Guidance`` term is the masked L1 against the
    guidance's colors, normalized over its valid pixels."""
    jt, tcfg, variables = train_pair
    assert jt.weights["Guidance"] == 20.0
    d = frames(31, 2)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    losses, grads = cheap_jit(lambda v, dt: jax_step(jt, kind, v, dt), variables, jd)
    trainer = port_trainer(tcfg, variables)
    assert trainer.weights["Guidance"] == 20.0
    net, opt = ((trainer.net_D, trainer.opt_D) if kind == "D"
                else (trainer.net_G, trainer.opt_G))
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    td = {k: to_torch(v) for k, v in d.items()}
    forward = ((lambda: trainer.dis_forward(td)) if kind == "D"
               else (lambda: trainer.gen_forward(td)[0]))
    got = trainer._step(net, opt, forward, None, f"{kind}_step")
    expected = {"GAN", "total"} | ({"D_real_acc", "D_fake_acc"} if kind == "D" else
                                   {"FeatureMatching", "Perceptual", "Flow", "Guidance"})
    assert expected <= set(losses) == set(got) - {"grad_norm"}
    for k, v in losses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=0, err_msg=k)
    if kind == "G":
        assert float(got["Guidance"]) > 0
    want_g = to_port_layout(net, grads)
    got_g = {n: p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
             for n, p in net.named_parameters()}
    assert set(want_g) == set(got_g)
    diff2 = sum(float(((got_g[n] - g).astype(np.float64) ** 2).sum()) for n, g in want_g.items())
    norm2 = sum(float((g.astype(np.float64) ** 2).sum()) for g in want_g.values())
    assert np.sqrt(diff2 / norm2) <= GRAD_TOL
    largest = max(np.abs(g).max() for g in want_g.values())
    for name, g in want_g.items():
        want = before[name].numpy() - LR * g / (np.abs(g) + 1e-8)
        got_p = net.get_parameter(name).detach().numpy()
        np.testing.assert_allclose(got_p, want, rtol=1e-4, atol=2.1 * LR, err_msg=name)
        diff = np.abs(got_p - want)
        assert diff[np.abs(g) > 1e-2 * largest].max(initial=0) <= 0.25 * LR, name


# ------------------------------------------------------------- takeover


@pytest.fixture(scope="module")
def takeover(tmp_path_factory):
    """(the JAX single-image generator, its drawn variables, the port wc
    trainer with them, both configs)."""
    tmp = tmp_path_factory.mktemp("single")
    sim = {"gen": {"single_image_model": {"config": single_config(tmp),
                                          "allow_random_init": True}}}
    jcfg, tcfg = configs(sim)
    jnet = JaxSpadeGenerator(JaxConfig(sim["gen"]["single_image_model"]["config"]).gen,
                             JaxConfig(sim["gen"]["single_image_model"]["config"]).data)
    d = {"label": jnp.zeros((1, HW, HW, LABELS)), "images": jnp.zeros((1, HW, HW, 3))}
    key = jax.random.PRNGKey(0)
    variables = draw(jax.eval_shape(lambda: jnet.init(
        {"params": key, "noise": key}, d, random_style=False, training=False)), seed=7)
    trainer = Trainer(tcfg, device="cpu", train=True)
    trainer.init_state(seed=0)
    load_flax_variables(trainer.single_image_model, variables)
    return jnet, variables, trainer, tcfg


def jax_z(jnet, key, batch):
    """The z of the JAX single-image apply under noise key ``key``."""
    k = jnet.apply({}, rngs={"noise": key}, method=lambda m: m.make_rng("noise"))
    return jax.random.normal(k, (batch, SINGLE["gen"]["style_dims"]), jnp.float32)


def test_takeover_matches_jax_and_the_rollout_skips_its_steps(takeover, monkeypatch):
    """The takeover frame with the JAX z injected equals the JAX
    single-image frame (1e-4); a 3-frame rollout takes it for frames 0
    and 1 (no D or G step: one of each in all), feeds it to the history,
    and colors the point cloud with it, the frame generated at frame 2
    coloring only the points first seen there."""
    jnet, variables, trainer, _ = takeover
    key = jax.random.PRNGKey(77321)
    d = frames(60)
    want = cheap_jit(lambda v, lab: jnet.apply(
        v, {"label": lab, "images": lab[..., :3]}, random_style=True, training=False,
        rngs={"noise": key})["fake_images"], variables, jnp.asarray(d["label"]))
    z = torch.from_numpy(np.array(jax_z(jnet, key, 1)))
    monkeypatch.setattr(trainer, "_single_image_z", lambda batch: z)
    data_t = {"label": to_torch(d["label"]), "image": to_torch(d["image"])}
    got = trainer._frame_override(data_t)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), atol=1e-4, rtol=0)
    assert trainer._frame_override(dict(data_t, prev_images=torch.zeros(1, 2, 3, HW, HW),
                                        prev_labels=torch.zeros(1, 2, LABELS, HW, HW))) is None

    rng = np.random.RandomState(61)
    clip = {"label": to_torch(np.stack([frames(62 + t)["label"][0] for t in range(3)])[None]),
            "images": to_torch(np.stack([frames(62 + t)["image"][0] for t in range(3)])[None]),
            "unprojections": [[np.stack([rng.randint(0, HW, 300), rng.randint(0, HW, 300),
                                         rng.randint(0, 400, 300)], 1) for _ in range(3)]]}
    seen, after = [], trainer._after_gen_frame

    def record(data_t, fake):
        seen.append((fake.clone(), "prev_images" in data_t and data_t["prev_images"].clone()))
        after(data_t, fake)

    monkeypatch.setattr(trainer, "_after_gen_frame", record)
    counts = (trainer.opt_D.count, trainer.opt_G.count)
    losses = trainer.gen_update(clip)
    assert (trainer.opt_D.count - counts[0], trainer.opt_G.count - counts[1]) == (1, 1)
    assert len(seen) == 3 and "Guidance" in losses
    for t in range(2):  # the takeover frames, and the history frame 2 read
        want_t = trainer._frame_override({"label": clip["label"][:, t],
                                          "image": clip["images"][:, t]})
        torch.testing.assert_close(seen[t][0], want_t, rtol=0, atol=0)
        torch.testing.assert_close(seen[2][1][:, t], want_t, rtol=0, atol=0)
    # the point cloud, colored as the JAX trainer colors it (host numpy)
    # from the frames the rollout produced
    want_cloud = twc.SplatRenderer()
    for (fake, _), info in zip(seen, clip["unprojections"][0]):
        img = ((to_nhwc(fake)[0] * 0.5 + 0.5) * 255).clip(0, 255).astype(np.uint8)
        want_cloud.update_point_cloud(img, info)
    cloud = trainer._renderer(0)
    assert cloud.num_points() == want_cloud.num_points() > 0
    np.testing.assert_array_equal(cloud.colors, want_cloud.colors)
    np.testing.assert_array_equal(cloud.seen_time, want_cloud.seen_time)


# ----------------------------------------------------------------- data


def write_dataset(root, sequences=2, frames_=4, hw=(40, 44), seed=0):
    """Seeded PNG frames and 12-class seg maps, and per frame a pickled
    ``{"w{W}xh{H}": flat [i, j, point, ...]}`` mapping of a random subset
    of a 400-point cloud (a point seen by several frames)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    for s in range(sequences):
        for t in range(frames_):
            for kind, arr in (("images", rng.randint(0, 256, (h, w, 3), np.uint8)),
                              ("seg_maps", rng.randint(0, LABELS, (h, w), np.uint8))):
                path = root / kind / f"seq{s:04d}" / f"{t:05d}.png"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_png(str(path), arr)
            n = rng.randint(50, 150)
            rows = np.stack([rng.randint(0, h, n), rng.randint(0, w, n),
                             rng.choice(400, n, replace=False)], 1)
            path = root / "unprojections" / f"seq{s:04d}" / f"{t:05d}.pkl"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_bytes(pickle.dumps({f"w{w}xh{h}": rows.reshape(-1).tolist()}))
    return str(root)


def data_overrides(root, **aug):
    return {"data": {"input_types": copy.deepcopy(DATA_TYPES), "num_workers": 0,
                     "train": {"roots": [root], "initial_sequence_length": 3,
                               "augmentations": dict({"resize_h_w": "64, 64"}, **aug)},
                     "val": {"roots": [root], "augmentations": {"resize_h_w": "64, 64"}}}}


def test_dataset_item_with_unprojections_matches_jax(tmp_path):
    """A training item (random start, crop and flip over the frames; the
    pickles pass through the augmentation untouched and the ``convert::``
    op decodes them) equals the JAX dataset's: images, labels, the flip
    flag, and the unprojections ``{resolution: (T, N, 3)}`` array for
    array. The loader collates them into a list of per-sample dicts, and
    the trainer's host hook and device copy leave them on the host."""
    root = write_dataset(tmp_path, frames_=5)
    o = merged(CUT, data_overrides(root, resize_h_w="68, 72", random_crop_h_w="64, 64",
                                   horizontal_flip=True))
    jds = JaxDataset(JaxConfig(CFG, overrides=copy.deepcopy(o)))
    tds = Dataset(Config(CFG, overrides=copy.deepcopy(o)))
    flips = []
    for i in range(len(tds)):
        random.seed(f"0/0/{i}")
        want, got = jds[i], tds[i]
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "unprojections":
                assert set(got[k]) == set(v) == {"w44xh40"}
                np.testing.assert_array_equal(got[k]["w44xh40"], v["w44xh40"])
                assert got[k]["w44xh40"].shape[0] == 3
            elif isinstance(v, np.ndarray):
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                assert got[k] == v, k
        flips.append(bool(got["is_flipped"]))
    from imaginaire_tpu_torch.data.loader import DataLoader

    batch = next(iter(DataLoader(tds, batch_size=2, shuffle=False)))
    assert isinstance(batch["unprojections"], list) and len(batch["unprojections"]) == 2
    trainer = Trainer(Config(CFG, overrides=copy.deepcopy(o)), device="cpu", train=True)
    on_device = trainer.start_of_iteration(batch, 0)
    assert on_device["unprojections"] is batch["unprojections"]
    assert torch.is_tensor(on_device["images"])
    info = trainer._point_info(on_device, 1, 1, target_hw=(64, 64))
    assert info is not None and info.ndim == 2 and info.shape[1] == 3


# ------------------------------------------------------ the checkpoint route


def test_single_image_checkpoint_route_and_its_refusals(tmp_path):
    """The single-image weights from a port SPADE trainer's checkpoint,
    named by its path or by its logdir, equal the saved generator's; a
    missing checkpoint, no ``checkpoint`` key without
    ``allow_random_init``, and a checkpoint without generator tensors
    raise."""
    single = single_config(tmp_path)
    scfg = Config(single)
    scfg.logdir = str(tmp_path / "single")
    strainer = SpadeTrainer(scfg, device="cpu")
    strainer.init_state(seed=5)
    path = strainer.save_checkpoint(0, 3)
    saved = strainer.net_G.state_dict()
    for ckpt in (path, scfg.logdir):
        _, tcfg = configs({"gen": {"single_image_model": {"config": single,
                                                          "checkpoint": ckpt}}})
        trainer = Trainer(tcfg, device="cpu")
        got = trainer.single_image_model.state_dict()
        assert set(got) == set(saved)
        assert all(torch.equal(got[k], saved[k]) for k in saved)
    _, tcfg = configs({"gen": {"single_image_model": {
        "config": single, "checkpoint": str(tmp_path / "missing")}}})
    with pytest.raises(FileNotFoundError, match="single_image_model"):
        Trainer(tcfg, device="cpu")
    _, tcfg = configs({"gen": {"single_image_model": {"config": single}}})
    with pytest.raises(ValueError, match="checkpoint"):
        Trainer(tcfg, device="cpu")
    bare = ckpt_lib.save_checkpoint(str(tmp_path / "bare"), {"x": torch.zeros(1)}, {}, 0, 1)
    _, tcfg = configs({"gen": {"single_image_model": {"config": single,
                                                      "checkpoint": bare}}})
    with pytest.raises(ValueError, match="net_G"):
        Trainer(tcfg, device="cpu")


# -------------------------------------------------------------- entries


def test_train_and_inference_entries_with_guidance(tmp_path, monkeypatch):
    """``train.main`` (2 iterations of 3 frames: the takeover for frames 0
    and 1, D and G steps with guidance for frame 2) then
    ``inference.main`` over both sequences of a folder dataset with
    unprojection pickles: finite losses with a nonzero ``Guidance``, a
    checkpoint, every frame written in [-1, 1], the point cloud grown
    within a sequence and reset at the next."""
    root = write_dataset(tmp_path / "data")
    single = single_config(tmp_path)
    o = merged(CUT, data_overrides(root), {
        "gen": {"single_image_model": {"config": single, "allow_random_init": True}},
        "logging_iter": 1, "snapshot_save_iter": 1000, "image_save_iter": 1000})
    o["test_data"] = {"name": "wc", "type": "imaginaire_tpu.data.paired_videos",
                      "num_workers": 0, "input_types": copy.deepcopy(DATA_TYPES),
                      "input_image": ["images"], "input_labels": ["seg_maps"],
                      "test": copy.deepcopy(o["data"]["val"])}
    cfg = yaml.safe_load(open(CFG))
    cfg_path = tmp_path / "wc.yaml"
    cfg_path.write_text(yaml.safe_dump(merged(cfg, o)))
    logdir = tmp_path / "log"
    trainer = train.main(["--config", str(cfg_path), "--logdir", str(logdir),
                          "--device", "cpu", "--max_iter", "2"])
    assert (trainer.opt_G.count, trainer.opt_D.count) == (2, 2)  # frame 2 of each clip
    scalars = {r["name"]: r["value"] for r in ScalarWriter(str(logdir)).read()
               if r["kind"] == "counter"}
    assert all(np.isfinite(v) for v in scalars.values())
    assert scalars["gen_update/Guidance"] > 0 and "gen_update/Flow" in scalars
    checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
    assert ckpt_lib.parse_checkpoint_name(checkpoint)[1] == 2

    points, starts = [], []
    after, start = Trainer._after_gen_frame, Trainer._start_of_test_sequence

    def record_after(self, data_t, fake):
        after(self, data_t, fake)
        points.append(self._renderer(0).num_points())

    def record_start(self, data):
        starts.append(self._renderer(0).num_points())
        start(self, data)
        starts.append(self._renderer(0).num_points())

    monkeypatch.setattr(Trainer, "_after_gen_frame", record_after)
    monkeypatch.setattr(Trainer, "_start_of_test_sequence", record_start)
    out = tmp_path / "frames"
    inference.main(["--config", str(cfg_path), "--checkpoint", checkpoint,
                    "--output_dir", str(out), "--logdir", str(tmp_path / "inf"),
                    "--device", "cpu"])
    written = sorted(str(p.relative_to(out)) for p in out.rglob("*.png"))
    assert written == [f"seq{s:04d}/{t:04d}.png" for s in range(2) for t in range(4)]
    # each sequence starts from an empty cloud (``reset()``), which grows
    # frame by frame
    assert starts == [0] * 4 and len(points) == 8
    for seq in (points[:4], points[4:]):
        assert 0 < seq[0] and seq == sorted(seq)


def test_engine_streams_refuse_the_family():
    """The serving engine's streams run neither per-frame hook, so a wc
    config's stream raises naming the roadmap instead of serving frames
    without the takeover or the guidance."""
    from imaginaire_tpu_torch.serving.engine import ServingError, engine_from_config

    _, tcfg = configs()
    engine = engine_from_config(tcfg, device="cpu")
    with pytest.raises(ServingError, match="ROADMAP"):
        engine.stream("a")


# ------------------------------------------------------- full-width trees


@pytest.mark.parametrize("path", FULL)
def test_full_width_generator_tree_matches_jax(path):
    """The committed configs' generators at full width (512x1024, 35 or
    Cityscapes' label channels), built on the meta device: the bridge
    fills every port tensor from the JAX ``eval_shape`` tree of the
    ``init_all`` init, each leaf in its shape, none left over (the
    guidance's convs in the multi-SPADE layers alone: both configs set
    ``only_with_flow``)."""
    jcfg, tcfg = JaxConfig(path), Config(path)
    jnet = JaxGenerator(jcfg.gen, jcfg.data)
    labels = get_paired_input_label_channel_number(tcfg.data)
    example = {"label": jax.ShapeDtypeStruct((1, 512, 1024, labels), jnp.float32),
               "guidance": jax.ShapeDtypeStruct((1, 512, 1024, 4), jnp.float32)}
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda d: jnet.init({"params": key, "noise": key}, d,
                                                training=True, init_all=True), example)
    leaves = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                                    flax.core.unfreeze(shapes))
    with torch.device("meta"):
        tnet = Generator(tcfg.gen, tcfg.data)
    load_flax_variables(tnet, leaves)
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in tnet.parameters()) == n_jax
