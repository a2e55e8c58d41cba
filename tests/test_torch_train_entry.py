"""The port's training and inference entry points on the CPU, at 64x64
on ``configs/unit_test/spade.yaml`` (small widths; the crop keys stay at
256, the least the SPADE ladder takes, and ``resize_smallest_side: 64``
leaves images smaller than the crop, which keeps them whole, as in the
JAX package: the trainer rounds them to 64x64):

- ``train.main`` for 2 iterations writes a checkpoint with its integrity
  sidecar and pointer, ``meters.jsonl`` and an image;
- a run killed at 2 and resumed to 4 is bit-identical to 4 straight
  (every tensor of the final checkpoint, and its loop counters);
- a corrupted checkpoint is quarantined and the older one loads, through
  ``load_latest_verified`` and through the trainer;
- ``inference.main`` writes one PNG a test item;
- the checkpoint, integrity and meter pieces on their own.
"""

import errno
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from imaginaire_tpu_torch import inference, train
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.png import decode_png
from imaginaire_tpu_torch.resilience import integrity
from imaginaire_tpu_torch.trainers.spade import Trainer
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
from imaginaire_tpu_torch.utils.meters import Meter, ScalarWriter

UNIT = "configs/unit_test/spade.yaml"
SMALL = dict(gen=dict(num_filters=8, style_dims=16, style_enc=dict(num_filters=4),
                      activation_norm_params=dict(num_filters=8)),
             dis=dict(num_filters=8, max_num_filters=16))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    cfg = Config(UNIT, overrides=SMALL)
    for split in (cfg.data.train, cfg.data.val, cfg.test_data.test):
        split.augmentations.resize_smallest_side = 64
    cfg.image_save_iter = 2
    del cfg["source_filename"]
    path = tmp_path_factory.mktemp("cfg") / "spade64.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return str(path)


@pytest.fixture(scope="module")
def bench_cfg_path(cfg_path):
    """The same config with ``trainer.speed_benchmark``: the loop records
    its timings (and syncs after each step), and trains the same."""
    cfg = yaml.safe_load(open(cfg_path))
    cfg["trainer"]["speed_benchmark"] = True
    path = cfg_path.replace(".yaml", "_bench.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run(cfg_path, logdir, max_iter):
    return train.main(["--config", cfg_path, "--logdir", str(logdir),
                       "--max_iter", str(max_iter), "--device", "cpu"])


@pytest.fixture(scope="module")
def runs(cfg_path, bench_cfg_path, tmp_path_factory):
    """4 iterations straight (timed), and 2 then a resume to 4."""
    root = tmp_path_factory.mktemp("runs")
    straight = run(bench_cfg_path, root / "straight", 4)
    run(cfg_path, root / "killed", 2)
    resumed = run(cfg_path, root / "killed", 4)
    return root, resumed, straight


def test_two_iterations_write_checkpoint_meters_and_image(cfg_path, tmp_path):
    trainer = run(cfg_path, tmp_path, 2)
    path = ckpt_lib.latest_checkpoint_path(str(tmp_path))
    assert ckpt_lib.parse_checkpoint_name(path) == (0, 2)
    payload = ckpt_lib.load_checkpoint(path)  # files and tensors verified
    assert payload["meta"] == {"epoch": 0, "iteration": 2, "batch_in_epoch": 2}
    assert set(payload["state"]) == set(trainer.state_tensors())
    records = ScalarWriter(str(tmp_path)).read()
    losses = {r["name"]: r["value"] for r in records
              if r["kind"] == "counter" and r["step"] == 2}
    assert {"gen_update/GAN", "gen_update/Perceptual", "dis_update/GAN/true",
            "gen_update/total", "time/iteration"} <= set(losses)
    assert all(np.isfinite(v) for v in losses.values())
    # image, label, fake, averaged fake side by side would be 4 columns;
    # the unit config averages nothing: 3 columns of 64x64
    img = decode_png((tmp_path / "images" / "000000002.png").read_bytes())
    assert img.shape == (64, 3 * 64, 3)
    # timings are kept only under speed_benchmark: nothing grows with the run
    assert not any(trainer.timings.values())


def test_kill_and_resume_is_bit_identical(runs):
    root, resumed, straight = runs
    assert {k: len(v) for k, v in straight.timings.items()} == {
        "gen_step": 4, "dis_step": 4, "loader_wait": 4, "data_wait": 4, "iteration": 4}
    assert resumed.current_iteration == 4 and resumed.current_epoch == 1
    a = ckpt_lib.load_checkpoint(ckpt_lib.latest_checkpoint_path(str(root / "straight")))
    b = ckpt_lib.load_checkpoint(ckpt_lib.latest_checkpoint_path(str(root / "killed")))
    assert a["meta"] == b["meta"] == {"epoch": 1, "iteration": 4, "batch_in_epoch": 1}
    assert set(a["state"]) == set(b["state"])
    differ = [k for k in a["state"] if not torch.equal(a["state"][k], b["state"][k])]
    assert not differ
    # the resumed run's optimizers, noise generators and EMA counter went on
    assert int(b["state"]["opt_G/count"]) == int(b["state"]["opt_D/count"]) == 4
    assert any(k.endswith(".u") for k in b["state"])


def flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(f.seek(0, 2) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_corrupted_checkpoint_is_quarantined_and_older_loads(runs, cfg_path, tmp_path):
    root, *_ = runs
    logdir = tmp_path / "log"
    shutil.copytree(root / "straight", logdir)
    entries = ckpt_lib.scan_checkpoints(str(logdir))
    newest, older = entries[-1][2], entries[-2][2]
    flip_byte(f"{newest}/{ckpt_lib.STATE_FILE}")
    payload, path, fallbacks = ckpt_lib.load_latest_verified(str(logdir))
    assert (path, fallbacks) == (older, 1)
    assert payload["meta"]["iteration"] == ckpt_lib.parse_checkpoint_name(older)[1]
    assert not (logdir / newest).exists() and (logdir / f"{newest}.corrupt").is_dir()
    assert (logdir / f"{newest}.corrupt.integrity.json").exists()
    # an explicit path that fails to verify: quarantined, the newest
    # verifiable sibling loads (the inference entry's fallback)
    trainer = Trainer(Config(cfg_path, overrides={"logdir": str(logdir)}), device="cpu")
    trainer.init_state(seed=0)
    assert trainer.load_checkpoint(older)
    later = trainer.save_checkpoint(1, 5)
    flip_byte(f"{later}/{ckpt_lib.STATE_FILE}")
    with pytest.raises(integrity.CheckpointIntegrityError):
        trainer.load_checkpoint(later)
    assert trainer.load_checkpoint(later, fallback=True)
    assert trainer.checkpoint_path == older
    assert (logdir / f"{later}.corrupt").is_dir()


def test_device_errors_on_load_quarantine_nothing(runs, cfg_path, tmp_path, monkeypatch):
    """An error that says nothing about the checkpoint's bytes (a device
    fault in ``torch.load``) propagates and leaves every checkpoint in
    place, through ``load_latest_verified`` and the trainer's fallback."""
    root, *_ = runs
    logdir = tmp_path / "log"
    shutil.copytree(root / "straight", logdir)
    before = ckpt_lib.scan_checkpoints(str(logdir))
    trainer = Trainer(Config(cfg_path, overrides={"logdir": str(logdir)}), device="cpu")
    trainer.init_state(seed=0)

    def device_fault(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(torch, "load", device_fault)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ckpt_lib.load_latest_verified(str(logdir))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        trainer.load_checkpoint(before[-1][2], fallback=True)
    assert ckpt_lib.scan_checkpoints(str(logdir)) == before
    assert not list(logdir.glob("*.corrupt"))
    assert not ckpt_lib.is_corrupt_checkpoint_error(torch.OutOfMemoryError("CUDA out of memory"))
    assert not ckpt_lib.is_corrupt_checkpoint_error(OSError(errno.EMFILE, "Too many open files"))


def test_truncated_checkpoint_without_sidecar_is_quarantined(tmp_path):
    """With no integrity records to check, ``torch.load``'s own error on a
    damaged archive (a RuntimeError) is the checkpoint's fault."""
    state = {"w": torch.arange(4096, dtype=torch.float32)}
    older = ckpt_lib.save_checkpoint(str(tmp_path), state, {"iteration": 1}, 0, 1)
    newest = ckpt_lib.save_checkpoint(str(tmp_path), state, {"iteration": 2}, 0, 2)
    os.remove(f"{newest}.integrity.json")
    target = f"{newest}/{ckpt_lib.STATE_FILE}"
    data = open(target, "rb").read()
    with open(target, "wb") as f:
        f.write(data[:len(data) // 2])
    payload, path, fallbacks = ckpt_lib.load_latest_verified(str(tmp_path))
    assert (path, fallbacks) == (older, 1)
    assert torch.equal(payload["state"]["w"], state["w"])
    assert (tmp_path / f"{newest}.corrupt").is_dir()


def test_checkpoint_tensors_are_matched_before_any_copy(runs, cfg_path):
    root, *_ = runs
    payload = ckpt_lib.load_checkpoint(ckpt_lib.latest_checkpoint_path(str(root / "straight")))
    trainer = Trainer(Config(cfg_path), device="cpu", train=True)
    trainer.init_state(seed=5)
    before = {k: v.clone() for k, v in trainer.state_tensors().items()}
    for missing in ("opt_D/count", "net_D/" + next(iter(trainer.net_D.state_dict()))):
        state = dict(payload["state"])
        del state[missing]
        with pytest.raises(KeyError):
            trainer.load_state_tensors(state)
        assert all(torch.equal(before[k], v) for k, v in trainer.state_tensors().items())
    # weights only: the networks, not the optimizers or the generators' states
    trainer.load_state_tensors(payload["state"], resume=False)
    name = next(iter(trainer.net_G.state_dict()))
    assert torch.equal(trainer.net_G.state_dict()[name], payload["state"][f"net_G/{name}"])
    assert trainer.opt_G.count == 0
    assert torch.equal(trainer.gen_rng.get_state(), before["gen_rng"])


def test_inference_writes_one_png_per_test_item(runs, cfg_path, tmp_path):
    root, *_ = runs
    out = tmp_path / "out"
    inference.main(["--config", cfg_path, "--logdir", str(root / "straight"),
                    "--output_dir", str(out), "--device", "cpu"])
    pngs = sorted(out.rglob("*.png"))
    assert [p.relative_to(out).as_posix() for p in pngs] == [
        f"seq0001/0000{i}.png" for i in range(3)]
    for p in pngs:
        img = decode_png(p.read_bytes())
        assert img.shape == (64, 64, 3) and img.std() > 0


def test_entry_refuses_runtime_planes_the_port_lacks(tmp_path):
    for overrides in ({"chaos": {"enabled": True}},
                      {"parallel": {"mesh_shape": [2, 1]}},
                      {"resilience": {"elastic": {"enabled": True}}}):
        with pytest.raises(NotImplementedError, match="not in the port"):
            train.refuse_unported_runtime(Config(UNIT, overrides=overrides))
    train.refuse_unported_runtime(Config(UNIT, overrides={
        "resilience": {"cluster": {"enabled": "auto"}}}))
    # the port always checksums and verifies: a config that turns it off
    # is refused, not silently overridden
    for resilience in ({"enabled": False}, {"checksum": False},
                       {"verify_on_load": False}):
        with pytest.raises(NotImplementedError, match="always checksums"):
            train.refuse_unported_runtime(Config(UNIT, overrides={"resilience": resilience}))
    train.refuse_unported_runtime(Config(UNIT, overrides={
        "resilience": {"checksum": True, "verify_on_load": True}}))


# --------------------------------------------------------------- pieces


@pytest.mark.parametrize("epoch,iteration", [(0, 0), (3, 7), (12345, 987654321)])
def test_checkpoint_names_round_trip(epoch, iteration):
    name = ckpt_lib.checkpoint_name(epoch, iteration)
    assert ckpt_lib.parse_checkpoint_name(f"/x/{name}") == (epoch, iteration)


def test_scan_ignores_quarantined_and_temporary(tmp_path):
    for name in ("epoch_00000_iteration_000000002_checkpoint",
                 "epoch_00001_iteration_000000004_checkpoint.corrupt",
                 "epoch_00001_iteration_000000005_checkpoint.tmp-12",
                 "epoch_00001_iteration_000000003_checkpoint"):
        (tmp_path / name).mkdir()
    assert [it for _, it, _ in ckpt_lib.scan_checkpoints(str(tmp_path))] == [2, 3]


def test_gc_keeps_the_pointer_target_and_the_newest(tmp_path):
    state = {"w": torch.arange(4.0)}
    paths = [ckpt_lib.save_checkpoint(str(tmp_path), state, {}, 0, i) for i in (1, 2, 3)]
    (tmp_path / ckpt_lib.POINTER).write_text(ckpt_lib.checkpoint_name(0, 1))
    deleted = ckpt_lib.gc_checkpoints(str(tmp_path), 1)
    assert deleted == [paths[1]]
    assert not (tmp_path / f"{ckpt_lib.checkpoint_name(0, 2)}.integrity.json").exists()
    assert [it for _, it, _ in ckpt_lib.scan_checkpoints(str(tmp_path))] == [1, 3]


def test_every_candidate_corrupt_raises(tmp_path):
    path = ckpt_lib.save_checkpoint(str(tmp_path), {"w": torch.ones(64)}, {}, 0, 1)
    flip_byte(f"{path}/{ckpt_lib.STATE_FILE}")
    with pytest.raises(RuntimeError, match="no verifiable checkpoint"):
        ckpt_lib.load_latest_verified(str(tmp_path))
    assert ckpt_lib.load_latest_verified(str(tmp_path / "fresh")) == (None, None, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64, torch.uint8])
def test_tree_checksums_catch_a_changed_tensor(dtype):
    tree = {"a": torch.arange(6).reshape(2, 3).to(dtype), "b": torch.tensor(3, dtype=dtype)}
    record = integrity.tree_checksums(tree)
    assert record["n_leaves"] == 2 and record["leaves"]["b"]["shape"] == []
    integrity.verify_tree({k: v.clone() for k, v in tree.items()}, record)
    changed = dict(tree, a=tree["a"].clone())
    changed["a"][1, 2] = 0
    with pytest.raises(integrity.CheckpointIntegrityError, match="a: crc"):
        integrity.verify_tree(changed, record)
    with pytest.raises(integrity.CheckpointIntegrityError, match="b: missing"):
        integrity.verify_tree({"a": tree["a"]}, record)
    # the same bytes read as another type of the same size
    same_size = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                 torch.int64: torch.float64, torch.uint8: torch.int8}[dtype]
    with pytest.raises(integrity.CheckpointIntegrityError, match="a: dtype"):
        integrity.verify_tree(dict(tree, a=tree["a"].view(same_size)), record)


def test_meter_averages_and_drops_non_finite(tmp_path):
    writer = ScalarWriter(str(tmp_path))
    meter = Meter("gen_update/GAN", writer)
    for v in (1.0, torch.tensor(3.0), float("nan"), None):
        meter.write(v)
    meter.flush(7)
    meter.flush(8)  # nothing written since: no record
    records = writer.read()
    assert [(r["name"], r["value"], r["step"]) for r in records] == [
        ("gen_update/GAN/nonfinite_count", 1.0, 7), ("gen_update/GAN", 2.0, 7)]
