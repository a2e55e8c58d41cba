"""fs-vid2vid's data path in the port against the JAX package on the CPU:
the few-shot dataset on the repository's face fixture (one sequence of 3
frames of 128x128 JPEG images with dlib-68 landmark JSON) under
``configs/projects/fs_vid2vid/faceForensics/bf16.yaml``: the landmark JSON
through the backends and the packer, the data ops (``decode_json``,
``to_numpy``, the ``vis::`` edge drawing, the face crop), keypoints
through the augmentation, and the items.

The JAX face crop reads a ``label`` entry that its dataset assembles only
later, and returns the images stacked as uint8, which skips their
normalization (ROADMAP.md, section C): its items hold the edge map at the
augmentation's 1024x1024 and the cropped images as 0-255 uint8. The port
crops every data type with the box. So the port's edge labels are held
to the JAX edge map cropped with the JAX box by the JAX op's own
``crop_and_resize``, and its images to the JAX images mapped to [-1, 1].

Tolerances: landmark coordinates, crop boxes and the drawn edge maps
exact; labels after the bilinear crop atol 1e-6 (the port's numpy twin of
OpenCV's float resize); images within 1/255 of the JAX items (the same
decoded bytes through the same integer resize: exact in practice).
"""

import copy
import json
import pickle
import random

import numpy as np
import pytest

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.data.augment import Augmentor as JaxAugmentor
from imaginaire_tpu.data.paired_few_shot_videos import Dataset as JaxDataset
from imaginaire_tpu.model_utils import fs_vid2vid as jfs
from imaginaire_tpu.utils.visualization import face as jface
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.augment import Augmentor
from imaginaire_tpu_torch.data.backends import (
    FolderBackend,
    PackedBackend,
    build_packed_dataset,
)
from imaginaire_tpu_torch.data.paired_few_shot_videos import Dataset
from imaginaire_tpu_torch.model_utils import fs_vid2vid as tfs
from imaginaire_tpu_torch.model_utils import wc_vid2vid as twc
from imaginaire_tpu_torch.utils.visualization import face as tface

CFG = "configs/projects/fs_vid2vid/faceForensics/bf16.yaml"
FIXTURE = "tests/fixtures/face/raw"
LM = "landmarks-dlib68"


def overrides(root=FIXTURE, packed=False, **data):
    split = {"roots": [root], "is_packed": packed}
    return {"data": dict({"train": dict(split, initial_sequence_length=2), "val": split},
                         **data)}


def configs(**kw):
    o = overrides(**kw)
    return JaxConfig(CFG, overrides=copy.deepcopy(o)), Config(CFG, overrides=copy.deepcopy(o))


def landmarks(frame=0):
    with open(f"{FIXTURE}/{LM}/person1/{frame:05d}.json") as f:
        return np.asarray(json.load(f), np.float32)


def check_item(got, want, ref_landmarks):
    """A port item against a JAX item (see the module doc)."""
    np.testing.assert_array_equal(got[f"{LM}_xy"], want[f"{LM}_xy"])
    for img_key, label_key, lm in (("images", "label", want[f"{LM}_xy"][0]),
                                   ("ref_images", "ref_labels", ref_landmarks)):
        size = want["label"].shape[1:3]
        box, _ = jfs.get_face_bbox_for_data(lm, size, None, True)
        assert tfs.get_face_bbox_for_data(lm, size, None, True)[0] == box
        label, = jfs.crop_and_resize([want[label_key]], box, (512, 512))
        np.testing.assert_allclose(got[label_key], label, atol=1e-6, rtol=0)
        assert want[img_key].dtype == np.uint8
        np.testing.assert_allclose(got[img_key], want[img_key] / 255.0 * 2 - 1,
                                   atol=1 / 255, rtol=0)
        assert got[img_key].dtype == got[label_key].dtype == np.float32


def test_inference_items_match_jax():
    """A pinned inference item (the driving frame 0, the reference frame
    2; the JAX dataset holds a later frame until frame 0 is read): the landmarks through the resize, the drawn and cropped edge
    maps, the crop boxes and the images."""
    jcfg, tcfg = configs()
    jds, tds = JaxDataset(jcfg, is_inference=True), Dataset(tcfg, is_inference=True)
    jds.set_inference_sequence_idx(0, None, 2)
    tds.set_inference_sequence_idx(0, None, 2)
    assert len(tds) == len(jds) == 3
    got, want = tds[0], jds[0]
    assert got["images"].shape == (1, 512, 512, 3) and got["label"].shape == (1, 512, 512, 1)
    assert got["ref_images"].shape == (1, 512, 512, 3) and got["key"] == want["key"]
    # the reference item's landmarks: frame 2's, moved by the same resize
    ref_lm = landmarks(2) * (1024 / 128)
    check_item(got, want, ref_lm)
    assert got["label"].max() == 1.0 and got["label"].min() == 0.0


def test_training_items_match_jax_with_injected_draws(monkeypatch):
    """A training item: the JAX dataset draws its window and references
    from ``random`` and its crop jitter from ``np.random``; with
    ``np.random.uniform`` injected from ``random`` and ``random`` seeded as
    the port's item generator, both draw the same numbers in the same
    order: the window, the reference frame and both jittered face crops
    are the JAX item's. The 2-frame window and its one reference frame are
    disjoint."""
    jcfg, tcfg = configs()
    tds = Dataset(tcfg)
    tds.reseed(3, 1)
    got = tds[0]
    random.seed("3/1/0")
    monkeypatch.setattr(np.random, "uniform", lambda a, b: random.uniform(a, b))
    want = JaxDataset(jcfg)[0]
    monkeypatch.undo()
    assert got["images"].shape == (2, 512, 512, 3) and got["ref_images"].shape == (1, 512, 512, 3)
    np.testing.assert_array_equal(got[f"{LM}_xy"], want[f"{LM}_xy"])
    np.testing.assert_allclose(got["images"], want["images"] / 255.0 * 2 - 1, atol=1 / 255, rtol=0)
    np.testing.assert_allclose(got["ref_images"], want["ref_images"] / 255.0 * 2 - 1,
                               atol=1 / 255, rtol=0)
    # the window and the reference: 3 frames, each once
    window = {int(got["key"].split("/")[1]) - i for i in range(2)}
    assert got["key"] == want["key"] and len(window) == 2 and window <= {0, 1, 2}


def test_packed_json_round_trip_and_items(tmp_path):
    """The packer copies the landmark JSON bytes; both backends return
    them as text; an item from the packed copy equals the folder's."""
    out = build_packed_dataset(FIXTURE, str(tmp_path / "packed"), ["images", LM])
    raw = open(f"{FIXTURE}/{LM}/person1/00001.json").read()
    assert PackedBackend(f"{out}/{LM}", "json").getitem("person1/00001") == raw
    assert FolderBackend(f"{FIXTURE}/{LM}", "json").getitem("person1/00001") == raw
    _, folder = configs()
    _, packed = configs(root=out, packed=True)
    a, b = Dataset(folder, is_inference=True)[0], Dataset(packed, is_inference=True)[0]
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("aug", [
    {"resize_h_w": "96, 80"},
    {"resize_smallest_side": 100, "random_crop_h_w": "64, 72", "horizontal_flip": True},
    {"resize_h_w": "64, 64", "random_rotate_90": True, "center_crop_h_w": "40, 48"},
])
def test_keypoints_follow_the_augmentation_like_jax(aug):
    """Landmarks moved by the same resize, quarter turns, crop and flip
    as the image, with the same draws; the ``vis::`` geometry."""
    img = np.zeros((128, 128, 3), np.uint8)
    pts = landmarks()
    for seed in range(3):
        random.seed(seed)
        jaug = JaxAugmentor(aug, {"images": "BILINEAR"}, keypoint_data_types=[LM])
        want, jflip = jaug.perform_augmentation({"images": [img], LM: [pts]})
        taug = Augmentor(aug, {"images": "BILINEAR"}, keypoint_data_types=[LM])
        got, tflip = taug.perform_augmentation({"images": [img], LM: [pts]},
                                               random.Random(seed))
        assert tflip == jflip
        np.testing.assert_array_equal(got[LM][0], want[LM][0])
        assert got["images"][0].shape == want["images"][0].shape
        assert taug.geometry() == (jaug.resize_h, jaug.resize_w, jaug.crop_h, jaug.crop_w,
                                   jaug.original_h, jaug.original_w, jaug.is_flipped)


@pytest.mark.parametrize("upper", [False, True])
def test_face_edge_maps_match_jax(upper):
    """``connect_face_keypoints`` of three frames of landmarks (the
    fixture's, scaled to a 256x200 frame), with and without the upper
    face: the same curves, strokes and pixels."""
    cfgdata = {"for_face_dataset": {"add_upper_face": upper}}
    kp = np.stack([landmarks(t) * 1.7 for t in range(3)])
    args = (256, 200, 256, 200, 128, 128, False)
    want = jface.connect_face_keypoints(*args, cfgdata, kp)
    got = tface.connect_face_keypoints(*args, cfgdata, kp)
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    x, y = tface.interp_points([1.0, 5.0, 9.0], [2.0, 3.5, 7.0])
    jx, jy = jface.interp_points([1.0, 5.0, 9.0], [2.0, 3.5, 7.0])
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("what", ["decode_pkl", "convert", "distance_transform"])
def test_unported_data_ops_raise_naming_the_roadmap(what):
    """``add_distance_transform`` and an op of a prefix the port lacks
    raise naming the roadmap; ``decode_pkl`` and ``convert::`` ops, which
    wc-vid2vid's unprojections brought into the port, resolve (the first
    unpickles each frame, the second is the port's twin of the named
    function)."""
    _, tcfg = configs()
    if what == "distance_transform":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tface.connect_face_keypoints(
                8, 8, 8, 8, 8, 8, False,
                {"for_face_dataset": {"add_distance_transform": True}}, landmarks()[None])
        return
    if what == "decode_pkl":
        op = "decode_pkl"
        frames = [pickle.dumps({"a": [1, 2]}), pickle.dumps({"b": 3})]
        want = [{"a": [1, 2]}, {"b": 3}]
    else:
        op = "convert::imaginaire_tpu.model_utils.wc_vid2vid::decode_unprojections"
        frames = [pickle.dumps({"8x8": [1, 2, 3]})]
        want = None
    tcfg.data.input_types[1][LM]["pre_aug_ops"] = op
    fn = Dataset(tcfg)._resolve_op(op)
    if want is None:
        assert fn is twc.decode_unprojections
        assert fn(frames)["8x8"].tolist() == [[[1, 2, 3], [1, 1, 1]]]
    else:
        assert fn(frames) == want
    tcfg.data.input_types[1][LM]["pre_aug_ops"] = "other::a.b::c"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Dataset(tcfg)
