"""The port's paired-video dataset, its batches and the sequence-length
curriculum against the JAX package's.

A seeded PNG video dataset (sequences of 3, 5 and 6 frames, 40x44 RGB
frames and 12-class seg maps) is written through the port's encoder into
a temporary directory (the repository's fixtures are JPEG, which the GPU
machine cannot decode). The training split draws a time step up to 2, a
start, a scale, a crop and a flip; the JAX dataset draws them from the
global ``random`` module, the port from the item's ``random.Random``
seeded with "<seed>/<epoch>/<index>", so ``random.seed`` of that string
before a JAX item makes both draw the same. Items are compared exactly:
the same frames, the same augmentation for every frame of an item.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.data.paired_videos import Dataset as JaxDataset
from imaginaire_tpu.trainers.vid2vid import Trainer as JaxTrainer
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.loader import DataLoader
from imaginaire_tpu_torch.data.paired_images import Dataset as ImageDataset
from imaginaire_tpu_torch.data.paired_videos import Dataset
from imaginaire_tpu_torch.data.png import write_png
from imaginaire_tpu_torch.trainers.vid2vid import Trainer

CFG = "configs/unit_test/vid2vid_street.yaml"
LABELS = 12
FRAMES = (3, 5, 6)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.RandomState(0)
    for s, n in enumerate(FRAMES):
        for t in range(n):
            for kind, arr in (("images", rng.randint(0, 256, (40, 44, 3), np.uint8)),
                              ("seg_maps", rng.randint(0, LABELS, (40, 44), np.uint8))):
                path = root / kind / f"seq{s:04d}" / f"{t:05d}.png"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_png(str(path), arr)
    return str(root)


def overrides(root, **train):
    aug = dict(resize_smallest_side=32, random_scale_limit=0.2, horizontal_flip=True,
               random_crop_h_w="32, 32", max_time_step=2)
    return dict(data=dict(
        input_types=[{"images": dict(ext="png", num_channels=3, interpolator="BILINEAR",
                                     normalize=True)},
                     {"seg_maps": dict(ext="png", num_channels=LABELS,
                                       interpolator="NEAREST", normalize=False,
                                       is_mask=True)}],
        train=dict(roots=[root], batch_size=2, initial_sequence_length=3,
                   augmentations=aug, **train),
        val=dict(roots=[root], augmentations=dict(resize_h_w="32, 32"))))


def both(root, is_inference=False, **train):
    o = overrides(root, **train)
    return (JaxDataset(JaxConfig(CFG, overrides=o), is_inference=is_inference),
            Dataset(Config(CFG, overrides=o), is_inference=is_inference))


def assert_items_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def jax_item(ds, index, seed=0, epoch=0):
    random.seed(f"{seed}/{epoch}/{index}")
    return ds[index]


@pytest.mark.parametrize("length", [3, 5])
def test_items_match_jax(root, length):
    """Strided windows from a random start, one augmentation for every
    frame: (T, H, W, C) images and one-hot labels, the flip flag and the
    key, equal to the JAX dataset's item by item."""
    jds, tds = both(root)
    for ds in (jds, tds):
        ds.set_sequence_length(length)
    assert len(tds) == len(jds) == sum(n >= length for n in FRAMES)
    assert tds.sequence_length_max == jds.sequence_length_max == max(FRAMES)
    for i in range(len(tds)):
        want = jax_item(jds, i)
        got = tds[i]
        assert got["images"].shape == (length, 32, 32, 3)
        assert got["label"].shape == (length, 32, 32, LABELS)
        assert_items_equal(got, want)


def test_time_step_falls_back_to_one_when_the_window_is_too_long(root):
    jds, tds = both(root)
    tds.set_sequence_length(4)  # 1 + 3 * 2 = 7 frames: longer than any sequence
    for seed in range(5):
        assert tds._sample_time_step(random.Random(seed)) == (4, 1)


def test_inference_items_and_pinned_sequences_match_jax(root):
    jds, tds = both(root, is_inference=True)
    assert tds.sequence_length == 1 and tds.num_inference_sequences() == len(FRAMES)
    for i in range(len(tds)):
        assert_items_equal(tds[i], jax_item(jds, i))
    for ds in (jds, tds):
        ds.set_inference_sequence_idx(2)
    assert len(tds) == len(jds) == FRAMES[2]
    for i in range(len(tds)):
        got = tds[i]
        assert got["images"].shape[0] == 1
        assert_items_equal(got, jax_item(jds, i))
    _, train_ds = both(root)
    with pytest.raises(ValueError):
        train_ds.set_inference_sequence_idx(0)


def test_batches_collate_and_reach_the_device_as_btchw(root):
    """The loader stacks (T, H, W, C) items to (B, T, H, W, C); the
    trainer's move to the device makes that (B, T, C, H, W)."""
    _, tds = both(root)
    loader = DataLoader(tds, batch_size=2, shuffle=True, seed=3)
    loader.set_epoch(1)
    batch = next(iter(loader))
    assert batch["images"].shape == (2, 3, 32, 32, 3)
    assert batch["label"].shape == (2, 3, 32, 32, LABELS)
    assert len(batch["key"]) == 2
    trainer = Trainer(Config(CFG, overrides=overrides(tds.roots[0])), device="cpu")
    data = trainer.start_of_iteration(dict(batch), 0)
    assert data["images"].shape == (2, 3, 3, 32, 32)
    assert torch.equal(data["label"], torch.from_numpy(batch["label"]).permute(0, 1, 4, 2, 3))
    assert data["key"] == batch["key"]


class _Loader:
    """A loader stand-in: a dataset that records the lengths it is told."""

    def __init__(self, longest):
        self.dataset = SimpleNamespace(sequence_length_max=longest, told=[])
        self.dataset.set_sequence_length = self.dataset.told.append

    def __len__(self):
        return 4


@pytest.mark.parametrize("single_frame_epoch,step,longest", [(0, 1, 16), (2, 2, 6)])
def test_curriculum_matches_jax(single_frame_epoch, step, longest):
    """The sequence length of each epoch, and the lengths the dataset is
    told, over 9 epochs: one frame before ``single_frame_epoch``, then
    ``initial_sequence_length`` doubled every ``num_epochs_temporal_step``
    epochs, up to ``max_sequence_length`` and the longest sequence."""
    o = dict(single_frame_epoch=single_frame_epoch, num_epochs_temporal_step=step,
             data=dict(train=dict(initial_sequence_length=2, max_sequence_length=12)))
    jl, tl = _Loader(longest), _Loader(longest)
    jt = JaxTrainer(JaxConfig(CFG, overrides=o), train_data_loader=jl)
    tt = Trainer(Config(CFG, overrides=o), device="cpu", train_data_loader=tl)
    assert tt.sequence_length_max == jt.sequence_length_max
    lengths = []
    for epoch in range(9):
        jt._start_of_epoch(epoch)
        tt.start_of_epoch(epoch)
        assert tt.sequence_length == jt.sequence_length, epoch
        lengths.append(tt.sequence_length)
    assert tl.dataset.told == jl.dataset.told
    assert lengths[-1] == min(12, longest) and lengths[0] == (1 if single_frame_epoch else 2)


def test_knobs_a_dataset_does_not_implement_are_refused(root):
    o = overrides(root)
    image_cfg = Config(CFG, overrides=dict(o, data=dict(
        o["data"], type="imaginaire_tpu.data.paired_images")))
    with pytest.raises(ValueError, match="max_time_step"):
        ImageDataset(image_cfg)
    with pytest.raises(ValueError, match="one_hot_on_device"):
        Dataset(Config(CFG, overrides=dict(o, data=dict(o["data"], one_hot_on_device=True))))
