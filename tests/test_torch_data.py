"""The port's data pipeline against the JAX package's, on the fixtures
``tests/fixtures/spade/raw`` (3 items of 300x320: JPEG images, PNG seg,
edge and instance maps).

- the port's PNG codec: its decode equals ``cv2.imdecode`` on every
  fixture PNG, its encoder round-trips (and OpenCV reads what it writes);
- packs: a pack built by either package reads identically in the other;
- ``process_item`` of every fixture item on ``configs/unit_test/spade.yaml``
  with crops and ``resize_smallest_side`` cut to 64, the train split
  under several seeds (JAX: ``random.seed(s)``; the port:
  ``random.Random(s)``) and the test split: keys and shapes equal, labels
  and ``is_flipped`` exact, images and edge maps within one 8-bit level
  (2/255 after the [-1, 1] normalisation; the share of elements off by
  one level is asserted below 1e-3, and is 0 with the port's
  fixed-point resize);
- the train loader's order over 3 epochs, the threaded loader's batches,
  ``one_hot_on_device``'s index maps, and the trainer's
  ``start_of_iteration`` (the JAX hook's arrays, NCHW).
"""

import json
import os
import random
import sys

import cv2
import numpy as np
import pytest
import torch

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.data import backends as jbackends
from imaginaire_tpu.data.loader import get_train_and_val_dataloader as jax_loaders
from imaginaire_tpu.data.loader import get_test_dataloader as jax_test_loader
from imaginaire_tpu.data.paired_images import Dataset as JaxDataset
from imaginaire_tpu.trainers.spade import Trainer as JaxTrainer
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data import backends, png
from imaginaire_tpu_torch.data.augment import resize
from imaginaire_tpu_torch.data.loader import get_test_dataloader, get_train_and_val_dataloader
from imaginaire_tpu_torch.data.paired_images import Dataset
from imaginaire_tpu_torch.trainers.spade import Trainer

UNIT = "configs/unit_test/spade.yaml"
FIXTURES = "tests/fixtures/spade/raw"
TYPES = ["images", "seg_maps", "edge_maps"]
FIXTURE_PNGS = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(FIXTURES)
                      for f in fs if f.endswith(".png"))
CUT = {"data": {"train": {"augmentations": {"resize_smallest_side": 64,
                                            "random_crop_h_w": "64, 64"}},
                "val": {"augmentations": {"resize_smallest_side": 64,
                                          "center_crop_h_w": "64, 64"}}},
       "test_data": {"test": {"augmentations": {"resize_smallest_side": 64,
                                                "center_crop_h_w": "64, 64"}}}}
SMALL = dict(gen=dict(num_filters=8, style_dims=16, style_enc=dict(num_filters=4),
                      activation_norm_params=dict(num_filters=8)),
             dis=dict(num_filters=8, max_num_filters=16))
TRAIN_SEEDS = range(4)
ONE_LEVEL = 2.0 / 255 + 1e-6
OFF_BY_ONE = {"off": 0, "total": 0}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def configs(overrides=CUT):
    return JaxConfig(UNIT, overrides=overrides), Config(UNIT, overrides=overrides)


@pytest.fixture(scope="module")
def datasets():
    jcfg, cfg = configs()
    return {"train": (JaxDataset(jcfg), Dataset(cfg)),
            "test": (JaxDataset(jcfg, is_inference=True, is_test=True),
                     Dataset(cfg, is_inference=True, is_test=True))}


# ------------------------------------------------------------------ PNG


@pytest.mark.parametrize("path", FIXTURE_PNGS, ids=lambda p: os.path.relpath(p, FIXTURES))
def test_png_decode_matches_opencv(path):
    buf = open(path, "rb").read()
    want = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    got = png.decode_png(buf, path)
    assert got.dtype == np.uint8 and got.shape == want.shape + (1,)
    np.testing.assert_array_equal(got[..., 0], want)


@pytest.mark.parametrize("shape", [(1, 1), (5, 7, 1), (17, 13, 3), (4, 4, 4),
                                   (300, 320, 3)])
def test_png_encoder_round_trips(shape):
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    buf = png.encode_png(img)
    np.testing.assert_array_equal(png.decode_png(buf).reshape(shape), img)
    cv = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED)
    if cv.ndim == 3:
        cv = cv2.cvtColor(cv, cv2.COLOR_BGR2RGB if cv.shape[2] == 3 else cv2.COLOR_BGRA2RGBA)
    np.testing.assert_array_equal(cv.reshape(shape), img)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_decode_reads_every_filter(channels):
    """OpenCV's encoder picks a filter a row (Sub, Up, Average, Paeth)."""
    img = np.random.RandomState(1).randint(0, 256, (40, 50, channels)).astype(np.uint8)
    img[:20] //= 16  # smooth rows, so the encoder picks other filters there
    ok, buf = cv2.imencode(".png", img)
    want = cv2.cvtColor(img, cv2.COLOR_BGR2RGB if channels == 3 else cv2.COLOR_BGRA2RGBA)
    np.testing.assert_array_equal(png.decode_png(buf.tobytes()), want)


def test_png_refuses_what_it_cannot_read():
    ok, buf16 = cv2.imencode(".png", np.zeros((4, 4), np.uint16))
    with pytest.raises(NotImplementedError, match="bit depth 16"):
        png.decode_png(buf16.tobytes(), "deep.png")
    buf = bytearray(png.encode_png(np.zeros((4, 4), np.uint8)))
    buf[40] ^= 0xFF  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(buf), "bad.png")


def test_jpeg_needs_opencv_and_says_so(monkeypatch):
    path = os.path.join(FIXTURES, "images/seq0001/00000.jpg")
    buf = open(path, "rb").read()
    np.testing.assert_array_equal(backends.decode_image(buf, "jpg", path),
                                  jbackends._decode_image(buf, "jpg"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"00000\.jpg: decoding JPEG needs OpenCV"):
        backends.decode_image(buf, "jpg", path)
    # PNG and npy never need it
    assert backends.decode_image(open(FIXTURE_PNGS[0], "rb").read(), "png").ndim == 3


def test_lmdb_backend_points_at_the_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        backends.LMDBBackend(FIXTURES)


# ---------------------------------------------------------------- packs


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_packs_read_across_packages(builder, tmp_path):
    build = {"jax": jbackends.build_packed_dataset,
             "port": backends.build_packed_dataset}[builder]
    other = {"jax": backends.build_packed_dataset,
             "port": jbackends.build_packed_dataset}[builder]
    build(FIXTURES, str(tmp_path / "a"), TYPES + ["instance_maps"])
    other(FIXTURES, str(tmp_path / "b"), TYPES + ["instance_maps"])
    for name in ("all_filenames.json", "images/index.json", "seg_maps/data.bin"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    names = json.loads((tmp_path / "a" / "all_filenames.json").read_text())
    for t in TYPES + ["instance_maps"]:
        port_reader = backends.PackedBackend(str(tmp_path / "a" / t))
        jax_reader = jbackends.PackedBackend(str(tmp_path / "a" / t))
        jax_reader._native_tried = True  # its Python read path
        for seq, stems in names.items():
            for stem in stems:
                np.testing.assert_array_equal(port_reader.getitem(f"{seq}/{stem}"),
                                              jax_reader.getitem(f"{seq}/{stem}"))
        port_reader.close()
        jax_reader.close()


# ------------------------------------------------------------ the items


def port_item(ds, index, rng):
    root_idx, seq, stem = ds.items[index]
    out = ds.process_item(ds.load_item(root_idx, seq, [stem]), rng)
    return dict(ds.concat_labels(out, squeeze_time=True), key=f"{seq}/{stem}")


def compare_items(jitem, item):
    assert sorted(jitem) == sorted(item)
    for key, want in jitem.items():
        got = item[key]
        if isinstance(want, str):
            assert got == want
            continue
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if key in ("images", "edge_maps"):
            diff = np.abs(got - want)
            assert diff.max() <= ONE_LEVEL, (key, diff.max())
            OFF_BY_ONE["off"] += int((diff > 1e-6).sum())
            OFF_BY_ONE["total"] += diff.size
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("split,index,seed",
                         [("train", i, s) for i in range(3) for s in TRAIN_SEEDS]
                         + [("test", i, 0) for i in range(3)])
def test_process_item_matches_jax(datasets, split, index, seed):
    jds, ds = datasets[split]
    random.seed(seed)
    jitem = jds[index]
    compare_items(jitem, port_item(ds, index, random.Random(seed)))


def test_process_item_flips_both_ways(datasets):
    jds, ds = datasets["train"]
    flips = {bool(port_item(ds, 0, random.Random(s))["is_flipped"]) for s in TRAIN_SEEDS}
    assert flips == {True, False}
    assert OFF_BY_ONE["total"] == 0 or OFF_BY_ONE["off"] / OFF_BY_ONE["total"] < 1e-3


@pytest.mark.parametrize("hw", [(64, 68), (77, 82), (150, 160), (13, 9)])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_matches_opencv(hw, channels):
    img = np.random.RandomState(2).randint(0, 256, (300, 320, channels)).astype(np.uint8)
    for interp, flag in (("BILINEAR", cv2.INTER_LINEAR), ("NEAREST", cv2.INTER_NEAREST)):
        want = cv2.resize(img, hw[::-1], interpolation=flag).reshape(hw + (channels,))
        np.testing.assert_array_equal(resize(img, hw, interp), want, err_msg=interp)


def test_dataset_items_are_reproducible(datasets):
    _, ds = datasets["train"]
    ds.reseed(3, 1)
    a, b = ds[1], ds[1]
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


# ---------------------------------------------------------------- loaders


def test_train_loader_order_matches_jax():
    jcfg, cfg = configs()
    jtrain, _ = jax_loaders(jcfg, seed=3)
    train, _ = get_train_and_val_dataloader(cfg, seed=3)
    assert len(train) == len(jtrain)
    for epoch in range(3):
        jtrain.set_epoch(epoch)
        train.set_epoch(epoch)
        np.testing.assert_array_equal(train._order(), jtrain._order())
        assert [b["key"] for b in train] == [b["key"] for b in jtrain]


def test_threaded_loader_gives_the_same_batches():
    _, cfg = configs()
    serial, _ = get_train_and_val_dataloader(cfg, seed=1)
    threaded, _ = get_train_and_val_dataloader(cfg, seed=1)
    threaded.num_workers = 2
    serial.set_epoch(2)
    threaded.set_epoch(2)
    threaded.fast_forward(1)
    want = list(serial)[1:]
    got = list(threaded)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


def test_test_loader_keeps_every_item():
    jcfg, cfg = configs()
    assert ([b["key"] for b in get_test_dataloader(cfg)]
            == [b["key"] for b in jax_test_loader(jcfg)])


def test_one_hot_on_device_index_map_matches_jax():
    overrides = dict(CUT, test_data=dict(CUT["test_data"], one_hot_on_device=True))
    jcfg, cfg = configs(overrides)
    jds = JaxDataset(jcfg, is_inference=True, is_test=True)
    ds = Dataset(cfg, is_inference=True, is_test=True)
    for i in range(len(ds)):
        jitem, item = jds[i], ds[i]
        assert item["label"].dtype == np.int32 and item["label"].ndim == 2
        np.testing.assert_array_equal(item["label"], jitem["label"])
        np.testing.assert_array_equal(item["label_float"], jitem["label_float"])
        # the dont-care index: out-of-range values of the 12-class map
        assert (item["label"] == 12).any()


@pytest.mark.parametrize("frames", [1, 3])
def test_start_of_iteration_is_the_jax_hook_in_nchw(frames):
    """A batch whose image is larger than the crop keeps the whole image
    (64x68 here), so the hook also rounds W down to the base 16."""
    overrides = dict(SMALL, data={"train": {"augmentations": {"resize_smallest_side": 64}}})
    jcfg, cfg = configs(overrides)
    batch = next(iter(get_train_and_val_dataloader(cfg, seed=0)[0]))
    if frames > 1:
        batch = {k: (np.stack([v] * frames, axis=1) if k in ("label", "images") else v)
                 for k, v in batch.items()}
    want = JaxTrainer(jcfg)._start_of_iteration(dict(batch), 0)
    got = Trainer(cfg, device="cpu").start_of_iteration(dict(batch), 0)
    assert got["key"] == want["key"]
    for key in ("label", "images", "is_flipped"):
        w = np.asarray(want[key])
        if w.ndim == 4:
            w = w.transpose(0, 3, 1, 2)
        assert got[key].device.type == "cpu" and got[key].is_contiguous()
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
    assert got["images"].shape[-2:] == (64, 64)
