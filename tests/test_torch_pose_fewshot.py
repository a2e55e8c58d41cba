"""fs-vid2vid YouTubeDancing's data path in the port against the JAX
package on the CPU: the DensePose preprocessing, the pose label channels
the generator reads, the bystander removal, the person box and crop,
the few-shot dataset's items, and the pinned inference sequence's shared
crop box behind its first-frame barrier.

The data is ``chip_smoke.py``'s seeded YouTubeDancing folder dataset
(``write_youtube_dataset``: PNG frames, DensePose IUV PNGs with face
parts, OpenPose JSON of a dancer and a bystander, DensePose instance
maps with a different id each) at 108x192, under
``configs/projects/fs_vid2vid/YouTubeDancing/bf16.yaml`` cut to a 64x32
output (``youtube_entry_config``). The generator, the discriminator, the
steps and the finetune are in ``test_torch_pose_fewshot_training.py``.

Random draws are injected: the JAX package draws the DensePose part
drops and the renderer's stroke drops from the global ``random`` and the
person crop's jitter from ``np.random.randn``; the port draws each from
a ``random.Random`` it is given (the item's, seeded "<seed>/<epoch>/
<index>"), the crop's jitter by ``gauss``. So ``random.seed(s)`` (with
``np.random.randn`` answered from ``random.gauss``) before the JAX call
makes both draw the same numbers in the same order.

Tolerances: the DensePose preprocessing, the label channels, the
bystander removal, the boxes and the dataset items bit for bit; the
person crop's images within one 8-bit level (the port's numpy twin of
``cv2.resize``, as ``tests/test_torch_data.py::test_resize_matches_opencv``),
its nearest-resized labels exact, the moved keypoints 1e-4 pixels.
"""

import copy
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import openpose_person, paint_densepose, write_youtube_dataset
from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.data.paired_few_shot_videos import Dataset as JaxDataset
from imaginaire_tpu.model_utils import fs_vid2vid as jfs
from imaginaire_tpu.trainers.fs_vid2vid import Trainer as JaxTrainer
from imaginaire_tpu_torch import inference, train
from imaginaire_tpu_torch.config import Config, recursive_update
from imaginaire_tpu_torch.data import paired_videos
from imaginaire_tpu_torch.data.loader import DataLoader
from imaginaire_tpu_torch.data.paired_few_shot_videos import Dataset
from imaginaire_tpu_torch.model_utils import fs_vid2vid as tfs
from imaginaire_tpu_torch.trainers.fs_vid2vid import Trainer
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
from imaginaire_tpu_torch.utils.visualization import pose as tpose

RAW_HW = (108, 192)
OUT_HW = (64, 32)
SEQUENCES, FRAMES = 4, 5
DATA = {"data": {"output_h_w": "64, 32", "num_workers": 0,
                 "train": {"augmentations": {"resize_smallest_side": RAW_HW[0]}},
                 "val": {"augmentations": {"resize_smallest_side": RAW_HW[0]}}}}
# the config cut to tiny widths, fp32, no FlowNet2 teacher (the fs G step
# runs none) and VGG19 to relu_1_1 (the networks' tests and the entries)
LR = 1e-6
W = {"num_filters": 4, "max_num_filters": 16}
TINY = {
    "trainer": {"compute_dtype": "float32",
                "perceptual_loss": {"layers": ["relu_1_1"], "weights": [1.0],
                                    "allow_random_init": True}},
    "gen": dict(W, num_downsamples=2,
                hyper={"num_hyper_layers": 2, "attention": {"num_filters": 4}},
                flow=dict(W, num_downsamples=1, num_blocks=1,
                          multi_spade_combine={"embed": dict(W, num_downsamples=2)}),
                embed=dict(W, num_downsamples=2)),
    "dis": {"image": dict(W, num_discriminators=1, num_layers=1),
            "additional_discriminators": {"face": dict(W, num_layers=2)}},
    "flow_network": None,
    "gen_opt": {"lr": LR}, "dis_opt": {"lr": LR},
    "data": {"output_h_w": "64, 32"}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ytd(tmp_path_factory):
    """The seeded dataset's root and the cut config's path."""
    tmp = tmp_path_factory.mktemp("ytd")
    root = write_youtube_dataset(tmp / "data", sequences=SEQUENCES, frames=FRAMES, hw=RAW_HW)
    return root, chip_smoke.youtube_entry_config(tmp, root, DATA)


def configs(path):
    return JaxConfig(str(path)), Config(str(path))


class JaxDraws:
    """``np.random``'s ``randn`` answered from ``random.gauss`` of
    ``rng``: the port's draws, handed to the JAX op."""

    def __init__(self, rng):
        self.rng = rng

    def randn(self, *shape):
        if not shape:
            return self.rng.gauss(0.0, 1.0)
        return np.array([self.rng.gauss(0.0, 1.0) for _ in range(int(np.prod(shape)))]
                        ).reshape(shape)


def pose_label(seed, lead=(2, 3), hw=(24, 20)):
    """A (lead..., H, W, 6) float label as the dataset makes it: part
    indices 0-24 / 255 in channel 2 (every part present, face parts
    23-24 and the parts the face removal catches, 17-19, among them), U
    and V in 0 and 1, a rendered OpenPose map in 3:6."""
    rng = np.random.RandomState(seed)
    label = rng.randint(0, 256, lead + hw + (6,)).astype(np.float32) / 255.0
    label[..., 2] = rng.randint(0, 25, lead + hw) / 255.0
    label[..., 3:] *= rng.rand(*lead, *hw, 1) > 0.7
    return label


# ------------------------------------------------------ DensePose labels


@pytest.mark.parametrize("drop,infer", [(0.3, False), (0.3, True), (0.0, False)])
def test_pre_process_densepose_matches_jax(drop, infer):
    """Part drops (one draw a part, in order, for the whole batch), the
    part channel over 24 parts, every channel to [-1, 1]: the same draws
    give the same map; inference drops nothing."""
    cfg = {"random_drop_prob": drop}
    label = pose_label(1)
    random.seed("dp")
    want = jfs.pre_process_densepose(cfg, label, is_infer=infer)
    got = tfs.pre_process_densepose(cfg, label, is_infer=infer, rng=random.Random("dp"))
    np.testing.assert_array_equal(got, want)
    undropped = tfs.pre_process_densepose(cfg, label, is_infer=True)
    assert (got != undropped).any() == (drop > 0 and not infer)
    assert got.min() >= -1 and got.max() <= 1


@pytest.mark.parametrize("pose_type,remove,do_remove,time", [
    ("both", True, True, False), ("both", True, False, False), ("both", True, True, True),
    ("open", True, True, False), ("both", False, True, True)])
def test_extract_valid_pose_labels_matches_jax(pose_type, remove, do_remove, time):
    """The channels G reads of a preprocessed label, a frame (B, C, H, W)
    or a history (B, T, C, H, W): OpenPose alone under 'open'; the
    DensePose face parts (the part channel in (0.4, 0.6)) at -1 under
    ``remove_face_labels`` unless ``do_remove`` is False (the reference
    labels)."""
    label = tfs.pre_process_densepose({}, pose_label(2, (2, 3) if time else (2,)),
                                      is_infer=True)
    face = (label[..., 2] > 0.4) & (label[..., 2] < 0.6)
    assert face.any() and not (label[..., :3][face] == -1).all()
    want = np.asarray(jfs.extract_valid_pose_labels(jnp.asarray(label), pose_type, remove,
                                                    do_remove))
    perm = (0, 1, 4, 2, 3) if time else (0, 3, 1, 2)
    got = tfs.extract_valid_pose_labels(torch.from_numpy(label.transpose(perm)), pose_type,
                                        remove, do_remove)
    np.testing.assert_array_equal(got.numpy().transpose(np.argsort(perm)), want)
    removed = pose_type == "both" and remove and do_remove
    assert (want[..., :3][face] == -1).all() == removed
    assert tfs.extract_valid_pose_labels(None, pose_type, remove) is None


# --------------------------------------------------------- person crop


def two_people(hw=RAW_HW, frames=2, seed=0, walk=6.0):
    """Frames of a dancer and a bystander: uint8 images, DensePose IUV
    and instance maps (the ids in channel 0), the OpenPose JSON people and
    the rendered OpenPose maps of both."""
    rng = np.random.RandomState(seed)
    h, w = hw
    out = {k: [] for k in ("images", "pose_maps-densepose", "human_instance_maps",
                           "poses-openpose")}
    people = []
    for t in range(frames):
        dancer = openpose_person(0.45 * w + walk * t, 0.12 * h, 0.7 * h, t, rng)
        bystander = openpose_person(0.1 * w, 0.5 * h, 0.35 * h, t, rng)
        iuv = np.zeros((h, w, 3), np.uint8)
        inst = np.zeros((h, w, 3), np.uint8)
        paint_densepose(iuv, inst, bystander, 0.35 * h, chip_smoke.YTD_BYSTANDER_ID)
        paint_densepose(iuv, inst, dancer, 0.7 * h, chip_smoke.YTD_DANCER_ID)
        out["images"].append(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        out["pose_maps-densepose"].append(iuv)
        out["human_instance_maps"].append(inst)
        people.append([dancer, bystander])
    decoded = tpose.openpose_to_npy([{"people": p} for p in people])
    out["poses-openpose"] = tpose.draw_openpose_npy(h, w, h, w, h, w, False, {}, decoded)
    return out


def test_remove_other_ppl_keeps_the_dancer_as_jax():
    """The instance id most common under the OpenPose strokes (the
    dancer's, read from channel 0 of the instance map) masks both people's
    DensePose and strokes: the bystander's parts and strokes go, the
    dancer's stay. Reading the ids from another channel (all zeros) would
    keep nothing but the background."""
    data = two_people()
    dp = np.stack(data["pose_maps-densepose"]).astype(np.float32) / 255.0
    labels = np.concatenate([dp, np.stack(data["poses-openpose"])], axis=-1)
    inst = np.stack(data["human_instance_maps"]).astype(np.float32) / 255.0
    want = jfs.remove_other_ppl(labels, inst)
    got = tfs.remove_other_ppl(labels, inst)
    np.testing.assert_array_equal(got, want)
    ids = (inst[..., 0] * 255).round()
    dancer, bystander = ids == chip_smoke.YTD_DANCER_ID, ids == chip_smoke.YTD_BYSTANDER_ID
    assert (labels[bystander][:, :6] > 0).any() and not (got[bystander] > 0).any()
    assert (got[dancer][:, 2] > 0).any() and (got[dancer][:, 3:] > 0).any()


@pytest.mark.parametrize("case", ["dancer", "wide", "empty", "offset"])
def test_person_bbox_matches_jax(case):
    """The box of the DensePose support over the frames: a dancer's, one
    whose width-driven branch overruns the frame (a wide body at a 1:2
    crop), none (the middle of the frame) and a jittered one."""
    h, w = RAW_HW
    pose = np.zeros((2, h, w, 3), np.float32)
    offset, aspect = None, 0.5
    if case == "dancer":
        pose[0, 20:90, 80:110, 2] = pose[1, 25:95, 86:116, 2] = 0.1
    elif case == "wide":
        pose[1, 40:60, 2:190, 2] = 0.1
    elif case == "offset":
        pose[0, 30:70, 150:170, 2] = 0.1
        offset = [0.04, -0.07]
    want = jfs.get_person_bbox_for_data(pose, (h, w), 1.4, aspect, offset)
    got = tfs.get_person_bbox_for_data(pose, (h, w), 1.4, aspect, offset)
    assert got == want
    y0, y1, x0, x1 = got
    assert (x0 < 0 or x1 > w or y0 < 0 or y1 > h) == (case == "wide")


@pytest.mark.parametrize("inference,walk,openpose", [
    (False, 6.0, True), (True, 6.0, True), (False, 70.0, True), (True, 6.0, False)])
def test_crop_person_from_data_matches_jax(ytd, inference, walk, openpose):
    """The whole op on two frames (the third case walks the dancer to the
    frame's edge, so the box is clamped; the last has no OpenPose maps, so
    the DensePose is masked to every instance): the bystander removed,
    every type cropped with its interpolator, the keypoint stash moved,
    the instance maps gone, the jitter drawn in the JAX order, and at
    inference the box left in ``common_attr``."""
    data = two_people(walk=walk)
    if not openpose:
        del data["poses-openpose"]
    data["poses-openpose_xy"] = np.random.RandomState(3).uniform(0, 100, (2, 9, 2)).astype(
        np.float32)
    jcfg, tcfg = configs(ytd[1])
    want = jfs.crop_person_from_data(jcfg.data, inference, copy.deepcopy(data),
                                     rng=JaxDraws(random.Random("crop")))
    got = tfs.crop_person_from_data(tcfg.data, inference, copy.deepcopy(data),
                                    rng=random.Random("crop"))
    assert set(got) == set(want) and "human_instance_maps" not in got
    assert ("common_attr" in got) == inference
    if inference:
        assert got["common_attr"] == want["common_attr"]
    for t in ("images", "pose_maps-densepose", "poses-openpose")[:3 if openpose else 2]:
        g, w_ = np.stack(got[t]), np.stack(want[t])
        assert g.shape == w_.shape == (2,) + OUT_HW + (3,)
        if t == "images":
            assert np.abs(g.astype(int) - w_.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(g, w_)
    np.testing.assert_allclose(got["poses-openpose_xy"], want["poses-openpose_xy"],
                               atol=1e-4, rtol=0)


# ------------------------------------------------------------ dataset


@pytest.mark.parametrize("inference", [False, True])
def test_dataset_items_match_jax(ytd, inference, monkeypatch):
    """Items of the few-shot dataset on the seeded folders: training
    items (window, reference, renderer drops and both crops' jitter from
    the injected draws) and the frames of a pinned sequence (the driving
    sequence 1 with frame 0 of sequence 0 as the reference): images,
    6-channel labels and references bit for bit."""
    jcfg, tcfg = configs(ytd[1])
    jds, tds = (JaxDataset(jcfg, is_inference=inference),
                Dataset(tcfg, is_inference=inference))
    if inference:
        jds.set_inference_sequence_idx(1, 0, 0)
        tds.set_inference_sequence_idx(1, 0, 0)
    monkeypatch.setattr(np.random, "randn", JaxDraws(random).randn)
    tds.reseed(3, 1)
    for index in range(FRAMES if inference else 3):
        got = tds[index]
        random.seed(f"3/1/{index}")
        want = jds[index]
        assert set(got) == set(want) and got["key"] == want["key"]
        assert got["label"].shape[-1] == got["ref_labels"].shape[-1] == 6
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(got[k], v, err_msg=f"{index} {k}")


def frame_boxes(tds, seq):
    """Each frame's own person box (no shared attributes) of sequence
    ``seq``."""
    boxes = []
    for t in range(FRAMES):
        tds.set_inference_sequence_idx(seq, 0, 0)
        calls = []
        real = tfs.get_person_bbox_for_data
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tfs, "get_person_bbox_for_data",
                       lambda *a, **k: calls.append(real(*a, **k)) or calls[-1])
            tds.threads_common_attr = False
            tds[t]
            tds.threads_common_attr = True
        boxes.append(calls[0])
    return boxes


@pytest.mark.parametrize("workers", [1, 3])
def test_pinned_sequence_frames_share_the_first_frames_box(ytd, workers, monkeypatch):
    """A pinned sequence read by 1 or 3 loader threads (a batch of all 5
    frames: frames 1-4 start beside frame 0 and wait for it): the driving
    box is computed once, from frame 0, and every frame is cropped with
    it, though each frame's own box differs; the reference window's box is
    its own and leaves the shared one alone."""
    _, tcfg = configs(ytd[1])
    tds = Dataset(tcfg, is_inference=True)
    own = frame_boxes(tds, 1)
    assert len(set(map(tuple, own))) == FRAMES
    reference = frame_boxes(tds, 0)[0]
    tds.set_inference_sequence_idx(1, 0, 0)
    calls, real = [], tfs.get_person_bbox_for_data
    monkeypatch.setattr(tfs, "get_person_bbox_for_data",
                        lambda *a, **k: calls.append(real(*a, **k)) or calls[-1])
    batch = next(iter(DataLoader(tds, batch_size=FRAMES, shuffle=False, drop_last=False,
                                 num_workers=workers)))
    monkeypatch.undo()
    assert tds._common_attr == {"crop_coords": own[0]}
    driving = [c for c in calls if c != reference]
    assert driving == [own[0]] and calls.count(reference) == FRAMES
    # the same frames read one by one, frame 0 first, on one thread
    tds.set_inference_sequence_idx(1, 0, 0)
    for t in range(FRAMES):
        np.testing.assert_array_equal(batch["label"][t], tds[t]["label"])


def test_first_frame_barrier_raises_and_a_new_pin_clears_the_box(ytd, monkeypatch):
    """A later frame of a pinned sequence waits for frame 0 and raises when
    frame 0 does not come (the JAX dataset would crop it with a box of its
    own after 30 s) or failed; a new pin forgets the box; a dataset whose
    ops share nothing has no barrier."""
    _, tcfg = configs(ytd[1])
    tds = Dataset(tcfg, is_inference=True)
    monkeypatch.setattr(paired_videos, "FIRST_FRAME_TIMEOUT_S", 0.05)
    tds.set_inference_sequence_idx(1, 0, 0)
    with pytest.raises(RuntimeError, match="waited"):
        tds[2]
    load = tds.load_item
    monkeypatch.setattr(tds, "load_item", lambda *a: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        tds[0]
    monkeypatch.setattr(tds, "load_item", load)
    with pytest.raises(RuntimeError, match="frame 0 .* failed"):
        tds[1]
    tds.set_inference_sequence_idx(1, 0, 0)
    tds[0]
    box = tds._common_attr["crop_coords"]
    tds.set_inference_sequence_idx(2, 0, 0)
    assert tds._common_attr is None
    tds[0]
    assert tds._common_attr["crop_coords"] != box
    plain = Dataset(Config(str(ytd[1]), overrides={"data": {"full_data_ops": None}}),
                    is_inference=True)
    assert not plain.threads_common_attr
    plain[3]


# ------------------------------------------------------- trainer hook


@pytest.mark.parametrize("iteration", [0, 7, -1])
def test_densepose_hook_matches_jax_and_reads_the_seed_and_iteration_alone(ytd, iteration):
    """The trainer's host hook on a batch of two 2-frame clips and their
    references: the clips' labels lose each part with one draw for the
    whole batch (at ``random_drop_prob`` 0.3 here), from a generator of
    the run's seed and the iteration alone (so a resumed run draws what
    the unbroken one drew), the references and inference batches
    (iteration -1) none; the JAX hook, drawing from the global ``random``
    seeded with the same string, gives the same batch."""
    heavy = {"data": {"for_pose_dataset": {"random_drop_prob": 0.3}}, "flow_network": None}
    path = chip_smoke.youtube_entry_config(os.path.dirname(ytd[1]), ytd[0],
                                           merged(DATA, heavy), name="hook.yaml")
    jcfg, tcfg = configs(path)
    labels = np.stack([pose_label(s, (2,), RAW_HW) for s in (5, 6)])
    batch = {"label": labels, "ref_labels": labels[:, :1].copy(),
             "images": np.zeros(labels.shape[:-1] + (3,), np.float32)}
    trainer = Trainer(tcfg, device="cpu")
    trainer.init_state(seed=3)
    for other in (iteration + 1, iteration + 2):
        trainer._start_of_iteration(copy.deepcopy(batch), other)
    got = trainer._start_of_iteration(copy.deepcopy(batch), iteration)
    random.seed(f"3/densepose/{iteration}")
    want = JaxTrainer(jcfg)._start_of_iteration(copy.deepcopy(batch), iteration)
    for key in ("label", "ref_labels"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)
    undropped = tfs.pre_process_densepose({}, labels, is_infer=True)
    assert (got["label"] != undropped).any() == (iteration >= 0)
    np.testing.assert_array_equal(got["ref_labels"], undropped[:, :1])
    # device frames (a serving stream's) are refused, naming the roadmap
    with pytest.raises(NotImplementedError, match="A.5"):
        trainer._start_of_iteration({"label": torch.zeros(1, 6, 4, 4)}, iteration)


def merged(*parts):
    out = {}
    for part in parts:
        recursive_update(out, copy.deepcopy(part))
    return out


# -------------------------------------------------------------- entries


def test_train_resume_and_finetuned_inference_entries(ytd, tmp_path):
    """The committed config (cut to tiny widths; the forced overrides of
    ``chip_smoke.youtube_entry_config``) through the port's entries:
    ``train.main`` for 2 iterations (batch 2, 2-frame clips, DensePose
    part drops), again to iteration 3 from its checkpoint (a resume), then
    ``inference.main`` from the logdir, whose finetune (3 iterations)
    moves only G's parameters under the finetune prefixes before the
    driving sequence's 5 frames are written."""
    entry = merged(DATA, TINY, {"data": {"train": {"batch_size": 2,
                                                   "initial_sequence_length": 2}}})
    path = chip_smoke.youtube_entry_config(tmp_path, ytd[0], entry)
    logdir = str(tmp_path / "log")
    base = ["--config", str(path), "--logdir", logdir, "--device", "cpu"]
    first = train.main(base + ["--max_iter", "2"])
    assert (first.sequence_length, first.opt_G.count, first.add_dis_names) == (2, 4, ["face"])
    resumed = train.main(base + ["--max_iter", "3"])
    assert (resumed.current_iteration, resumed.opt_G.count) == (3, 6)
    checkpoint = ckpt_lib.latest_checkpoint_path(logdir)
    assert ckpt_lib.parse_checkpoint_name(checkpoint)[1] == 3
    saved = ckpt_lib.load_checkpoint(checkpoint)["state"]
    out = tmp_path / "frames"
    tuned = inference.main(["--config", str(path), "--logdir", logdir,
                            "--output_dir", str(out), "--device", "cpu"])
    assert tuned.has_finetuned and tuned.opt_G.count == tuned.opt_D.count == 3
    mask = tuned.finetune_mask()
    moved = {n for n, p in tuned.net_G.named_parameters()
             if not torch.equal(p.detach(), saved[f"net_G/{n}"])}
    assert moved and moved <= {n for n, m in mask.items() if m}
    written = sorted(str(p.relative_to(out)) for p in out.rglob("*.png"))
    assert written == [f"seq0001/{t:04d}.png" for t in range(FRAMES)]
