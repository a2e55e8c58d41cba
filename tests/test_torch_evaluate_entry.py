"""The port's SPADE evaluation plumbing on the CPU, against itself: the
checkpoint's optional ``ema_bn/`` group (the averaged copy's re-estimated
BatchNorm statistics), ``python -m imaginaire_tpu_torch.evaluate`` and
``ServingEngine.load_weights``. The numbers are held to the JAX package
in ``test_torch_spade_eval.py``.

``configs/unit_test/spade.yaml`` at small widths with ``model_average``
on and the style code's norms ``sync_batch``, fresh seeded weights; the
evaluate entry runs at 64x64 on the repository's fixture images with a
stub extractor (per-channel mean and standard deviation of the
preprocessed images) in place of Inception-v3.
"""

import copy
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from imaginaire_tpu_torch import evaluate, train
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.resilience.integrity import CheckpointIntegrityError, verify_tree
from imaginaire_tpu_torch.serving.engine import ServeRequest, ServingEngine, ServingError
from imaginaire_tpu_torch.trainers.base import EMA_BN_GROUP
from imaginaire_tpu_torch.trainers.spade import Trainer
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
from imaginaire_tpu_torch.utils.meters import ScalarWriter

UNIT = "configs/unit_test/spade.yaml"
OVERRIDES = {"gen": {"num_filters": 8, "style_dims": 16, "style_enc": {"num_filters": 4},
                     "activation_norm_params": {"num_filters": 8},
                     "global_adaptive_norm_type": "sync_batch"},
             "dis": {"num_filters": 8, "max_num_filters": 16},
             "trainer": {"model_average": True, "fid_random_init": True,
                         "model_average_batch_norm_estimation_iteration": 2}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def one_hot(n, channels=14, hw=32, seed=1):
    idx = np.random.RandomState(seed).randint(0, channels, (n, hw, hw))
    return np.eye(channels, dtype=np.float32)[idx]


def batches(n, batch, seed):
    rng = np.random.RandomState(seed)
    return [{"label": one_hot(batch, seed=seed + i),
             "images": rng.uniform(-1, 1, (batch, 32, 32, 3)).astype(np.float32)}
            for i in range(n)]


def stub_extractor(x):
    return torch.cat([x.mean((2, 3)), x.std((2, 3), correction=0)], dim=1)


def port(logdir, train_=False, seed=0):
    cfg = Config(UNIT, overrides=copy.deepcopy(OVERRIDES))
    cfg.logdir = str(logdir)
    trainer = Trainer(cfg, device="cpu", train=train_)
    trainer.init_state(seed=seed)
    return trainer


def live_state(trainer):
    return {k: v.clone() for k, v in trainer.net_G.state_dict().items()}


# ------------------------------------------------- the checkpoint group


def test_checkpoint_carries_the_statistics_and_an_old_one_still_loads(tmp_path):
    a = port(tmp_path, train_=True)
    a.recalculate_model_average_batch_norm_statistics(data_loader=batches(2, 2, 20))
    path3 = a.save_checkpoint(0, 3)
    saved3 = {k: v.clone() for k, v in a.state_tensors().items()}
    group = [k for k in saved3 if k.startswith(EMA_BN_GROUP)]
    assert len(group) == 8
    # the group is under the per-tensor crc32 records
    leaves = ckpt_lib.read_integrity_sidecar(path3)["leaves"]
    assert set(group) <= set(leaves)
    payload = ckpt_lib.load_checkpoint(path3)
    payload["state"][group[0]] = payload["state"][group[0]] + 1e-3
    with pytest.raises(CheckpointIntegrityError):
        verify_tree(payload["state"], ckpt_lib.read_integrity_sidecar(path3))

    # a checkpoint of the earlier format (no group) saves and resumes
    a._ema_batch_stats = None
    path4 = a.save_checkpoint(0, 4)
    saved4 = {k: v.clone() for k, v in a.state_tensors().items()}
    assert not any(k.startswith(EMA_BN_GROUP) for k in saved4)
    b = port(tmp_path, train_=True, seed=5)
    b._ema_batch_stats = {k[len(EMA_BN_GROUP):]: v.clone() for k, v in saved3.items()
                          if k.startswith(EMA_BN_GROUP)}
    assert b.load_checkpoint() and b.checkpoint_path == path4
    assert b._ema_batch_stats is None
    state = b.state_tensors()
    assert set(state) == set(saved4)
    assert all(torch.equal(state[k].cpu(), saved4[k]) for k in saved4)

    # a flipped byte in the newest: quarantined, the older one with its
    # group restores, bit for bit
    with open(os.path.join(path4, ckpt_lib.STATE_FILE), "r+b") as f:
        f.seek(f.seek(0, 2) // 2)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    c = port(tmp_path, train_=True)
    assert c.load_checkpoint() and c.checkpoint_path == path3
    assert os.path.isdir(path4 + ".corrupt")
    state = c.state_tensors()
    assert set(state) == set(saved3)
    assert all(torch.equal(state[k].cpu(), saved3[k]) for k in saved3)
    params = c.inference_params()
    assert all(torch.equal(params[k[len(EMA_BN_GROUP):]], saved3[k]) for k in group)

    # a group that does not fit G raises before anything is copied
    broken = dict(saved3)
    del broken[group[0]]
    d = port(tmp_path)
    kept = live_state(d)
    with pytest.raises(KeyError, match=EMA_BN_GROUP):
        d.load_state_tensors(broken, resume=False)
    assert all(torch.equal(kept[k], v) for k, v in d.net_G.state_dict().items())


# ----------------------------------------- the evaluate entry, the engine


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    """A 64x64 config on the fixture images and a logdir with two
    checkpoints: iteration 1 without the averaged copy's statistics (the
    earlier format), iteration 2 with them."""
    root = tmp_path_factory.mktemp("eval_entry")
    cfg = Config(UNIT, overrides=copy.deepcopy(OVERRIDES))
    for split in (cfg.data.train, cfg.data.val, cfg.test_data.test):
        split.augmentations.resize_smallest_side = 64
    del cfg["source_filename"]
    cfg_path = root / "spade64.yaml"
    cfg_path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    logdir = root / "run"
    cfg = Config(str(cfg_path))
    cfg.logdir = str(logdir)
    train_loader, _ = train.get_train_and_val_dataloader(cfg)
    tr = Trainer(cfg, device="cpu", train_data_loader=train_loader)
    tr.init_state(seed=0)
    tr.save_checkpoint(0, 1)
    with torch.no_grad():
        for v in tr.ema_G.values():
            v.mul_(0.9)
    tr.current_iteration = 2
    tr.recalculate_model_average_batch_norm_statistics()
    path2 = tr.save_checkpoint(0, 2)
    return root, str(cfg_path), logdir, path2, tr


def copy_checkpoint(src, dst):
    shutil.copytree(src, dst)
    shutil.copy(src + ".integrity.json", dst + ".integrity.json")


def test_evaluate_sweeps_skips_and_quarantines(entry, monkeypatch):
    root, cfg_path, logdir, path2, _ = entry
    monkeypatch.setattr(Trainer, "_fid_extractor", lambda self: stub_extractor)
    # a quarantined one is skipped by name; a corrupt copy is quarantined
    copy_checkpoint(path2, str(logdir / "epoch_00000_iteration_000000007_checkpoint.corrupt"))
    bad = str(logdir / ckpt_lib.checkpoint_name(0, 3))
    copy_checkpoint(path2, bad)
    with open(os.path.join(bad, ckpt_lib.STATE_FILE), "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    out = root / "eval"
    rows = evaluate.main(["--config", cfg_path, "--checkpoint_logdir", str(logdir),
                          "--metrics", "fid,kid,prdc", "--device", "cpu",
                          "--logdir", str(out)])
    assert [r["iteration"] for r in rows] == [1, 2]
    assert os.path.isdir(bad + ".corrupt") and not os.path.exists(bad)
    names = {"FID", "FID_ema", "best_FID", "KID", "PRDC_precision", "PRDC_recall",
             "PRDC_density", "PRDC_coverage"}
    for row in rows:
        assert names <= set(row) and all(np.isfinite(row[n]) for n in names)
        assert row["FID"] >= 0 and row["FID_ema"] >= 0
    assert rows[1]["best_FID"] == min(rows[0]["FID"], rows[1]["FID"])
    records = ScalarWriter(str(out)).read()
    for step in (1, 2):
        assert names <= {r["name"] for r in records if r.get("step") == step}
    # the same checkpoint again, alone: the same numbers
    again = evaluate.main(["--config", cfg_path, "--checkpoint", path2,
                           "--metrics", "fid,kid,prdc", "--device", "cpu",
                           "--logdir", str(root / "eval2")])
    for name in names - {"best_FID"}:
        assert again[0][name] == pytest.approx(rows[1][name], rel=1e-6, abs=1e-12), name


def test_evaluate_refuses_bad_arguments_and_unported_planes(entry, monkeypatch, tmp_path):
    _, cfg_path, logdir, path2, _ = entry
    base = ["--config", cfg_path, "--device", "cpu", "--logdir", str(tmp_path)]
    with pytest.raises(SystemExit, match="unknown --metrics"):
        evaluate.main(base + ["--checkpoint", path2, "--metrics", "fid,lpips"])
    with pytest.raises(SystemExit, match="--checkpoint"):
        evaluate.main(base)
    monkeypatch.setattr(Trainer, "_fid_extractor", lambda self: stub_extractor)
    monkeypatch.setattr(Trainer, "_extra_metric_activations", lambda self, ext: None)
    with pytest.raises(SystemExit, match="produced none"):
        evaluate.main(base + ["--checkpoint", path2, "--metrics", "kid"])
    cfg = yaml.safe_load(open(cfg_path))
    cfg["evaluation"] = {"every_n_iter": 2}
    plane = tmp_path / "plane.yaml"
    plane.write_text(yaml.safe_dump(cfg))
    with pytest.raises(NotImplementedError, match="evaluation.every_n_iter"):
        evaluate.main(["--config", str(plane), "--checkpoint", path2, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="evaluation.every_n_iter"):
        train.refuse_unported_runtime(Config(str(plane)))
    # a device error while loading says nothing about the checkpoint:
    # it propagates and nothing is quarantined
    monkeypatch.setattr(ckpt_lib.torch, "load", lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("CUDA error: an illegal memory access was encountered")))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        evaluate.main(base + ["--checkpoint", path2])
    assert os.path.isdir(path2)


def test_engine_serves_the_restored_averaged_weights_and_statistics(entry, tmp_path):
    _, cfg_path, logdir, path2, saver = entry
    cfg = Config(cfg_path)
    cfg.logdir = str(tmp_path / "empty")
    engine = ServingEngine(cfg, device="cpu").initialize(seed=3)
    with pytest.raises(ServingError, match="no verifiable checkpoint"):
        engine.load_weights()
    assert engine.load_weights(require=False) is False
    cfg.logdir = str(logdir)
    engine = ServingEngine(cfg, device="cpu").initialize(seed=3)
    assert engine.load_weights(path2)
    served = engine._variables
    for name, value in saver._ema_batch_stats.items():
        assert torch.equal(served[name], value)
    for name, value in saver.ema_G.items():
        assert torch.equal(served[name], value)
    lanes = engine.serve([engine_request(64)])
    assert lanes[0].shape == (64, 64, 3) and np.isfinite(lanes[0]).all()


def engine_request(hw):
    label = one_hot(1, hw=hw, seed=40)
    image = np.zeros((1, hw, hw, 3), np.float32)
    return ServeRequest({"label": label, "images": image}, seed=0)
