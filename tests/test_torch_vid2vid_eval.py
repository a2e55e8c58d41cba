"""vid2vid inference and video evaluation from disk, and the teacher
cache's dataset half, in the port against the JAX package on the CPU.

``configs/unit_test/vid2vid_street.yaml`` on the repository's fixture (one
sequence of 3 frames, resized to 64x64; the validation split lists the
fixture twice, so it holds two sequences), its generator cut to 3
layers. The generator's variable
shapes come from ``jax.eval_shape`` of its ``init_all`` init; the leaves
are drawn with numpy and carried into the port with ``bridge.py``. The
JAX trainer's ``_apply_G`` runs as one cheaply compiled program a frame
type. Both packages get one cheap extractor in place of Inception-v3: an
8x8 average pool of the preprocessed 299x299 frames (192 features). The
teacher of ``precompute_flow`` is a stub (the full FlowNet2 is not run
here): its flow is a fixed function of the frame pair.

Tolerances:
- generated frames: atol 1e-4 before encoding (fp32 sums in other
  orders, fed back as the next frames' history; the generator's own
  test holds the whole unit generator to the same); the PNG's
  uint8 pixels within 1 of the JAX ``tensor2im`` (a value on a rounding
  boundary may land either side);
- activations: atol 1e-4 (the frames' tolerance through a mean pool);
- augmentation records, payload keys, canonical frames and shard arrays:
  exact (the same decoded bytes through the same integer resize);
- shards across the packages: exact (the same float16 and uint8 bytes).
"""

import copy
import json
import os
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
from imaginaire_tpu.evaluation.common import get_video_activations as jax_video_activations
from imaginaire_tpu.flow import cache as jax_cache
from imaginaire_tpu.trainers.vid2vid import Trainer as JaxTrainer
from imaginaire_tpu.utils.visualization import tensor2im as jax_tensor2im
from imaginaire_tpu_torch import evaluate, inference, precompute_flow
from imaginaire_tpu_torch.bridge import load_flax_variables
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.augment import deterministic_resize_chain
from imaginaire_tpu_torch.data.loader import DataLoader
from imaginaire_tpu_torch.data.paired_videos import Dataset
from imaginaire_tpu_torch.data.png import decode_png
from imaginaire_tpu_torch.evaluation.common import get_video_activations
from imaginaire_tpu_torch.flow import cache as port_cache
from imaginaire_tpu_torch.trainers.vid2vid import Trainer
from imaginaire_tpu_torch.utils.meters import ScalarWriter

CFG = "configs/unit_test/vid2vid_street.yaml"
FIXTURE = "tests/fixtures/spade/raw"
HW, LABELS, FRAMES = 64, 12, 3
TOL_FRAME = 1e-4
TOL_ACTS = 1e-4
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
# the generator cut to 3 layers whose embedders, flow network and
# multi-SPADE combine go one level deep (XLA's CPU compile time grows with
# the program, and each frame type is one program)
EVAL = {"trainer": {"fid_random_init": True, "num_videos_to_test": 1},
        "gen": {"num_layers": 3, "num_downsamples_img": 1, "embed": {"num_downsamples": 1},
                "flow": {"num_downsamples": 1, "num_res_blocks": 1,
                         "multi_spade_combine": {"num_layers": 1,
                                                 "embed": {"num_downsamples": 1}}}},
        "data": {"val": {"roots": [FIXTURE, FIXTURE]}}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def pool_extractor(x):
    """(B, 3, 299, 299) -> (B, 192): the mean of each of 8x8 blocks of 37
    pixels, in the JAX extractor's (row, column, channel) order."""
    b = x.shape[0]
    pooled = x[:, :, :296, :296].reshape(b, 3, 8, 37, 8, 37).mean((3, 5))
    return pooled.permute(0, 2, 3, 1).reshape(b, -1)


def pool_extractor_jax(x):
    b = x.shape[0]
    return x[:, :296, :296].reshape(b, 8, 37, 8, 37, 3).mean((2, 4)).reshape(b, -1)


def draw(shapes, seed=0):
    """Numpy leaves: kernels at 1/sqrt(fan_in), unit ``u``, positive
    running variances, the rest within 0.1 of their initial values."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "u":
            u = rng.standard_normal(leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


@pytest.fixture(scope="module")
def pair():
    """The JAX trainer (its ``_apply_G`` compiled once a frame type) and a
    factory of port trainers holding the same drawn generator."""
    jt = JaxTrainer(JaxConfig(CFG, overrides=copy.deepcopy(EVAL)))
    key = jax.random.PRNGKey(0)
    example = {"label": jnp.zeros((1, HW, HW, LABELS)), "images": jnp.zeros((1, HW, HW, 3))}
    variables = draw(jax.eval_shape(lambda: jt.net_G.init(
        {"params": key, "noise": key}, example, training=True, init_all=True)), seed=1)
    jt.state = {"vars_G": variables}
    apply_g, compiled = jt._apply_G, {}

    def cheap_apply(vars_g, data_t, rng, training):
        shape = (training,) + tuple((k, np.shape(v)) for k, v in sorted(data_t.items()))
        if shape not in compiled:
            compiled[shape] = jax.jit(lambda v, d, r: apply_g(v, d, r, training)).lower(
                vars_g, data_t, rng).compile(compiler_options=CHEAP)
        return compiled[shape](vars_g, data_t, rng)

    jt._apply_G = cheap_apply

    def port(logdir=None, overrides=EVAL):
        cfg = Config(CFG, overrides=copy.deepcopy(overrides))
        if logdir is not None:
            cfg.logdir = str(logdir)
        trainer = Trainer(cfg, device="cpu")
        trainer.init_state(seed=0)
        load_flax_variables(trainer.net_G, variables)
        return trainer

    return jt, port


def datasets(overrides=EVAL, is_inference=True):
    return (JaxDataset(JaxConfig(CFG, overrides=copy.deepcopy(overrides)),
                       is_inference=is_inference),
            Dataset(Config(CFG, overrides=copy.deepcopy(overrides)),
                    is_inference=is_inference))


def frame_loader(dataset):
    return DataLoader(dataset, batch_size=1, shuffle=False, drop_last=False)


def write_config(path, overrides):
    cfg = Config(CFG, overrides=copy.deepcopy(overrides))
    del cfg["source_filename"]
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return str(path)


# ------------------------------------------------------------------- C6


def test_write_metrics_and_evaluate_compute_video_fid(pair, tmp_path, monkeypatch):
    """ROADMAP C6: the vid2vid trainer inherited a ``_compute_fid`` that
    returns None, so neither the loop's snapshots nor ``evaluate`` wrote a
    video FID. One pinned validation sequence, ``fid_random_init``."""
    _, port = pair
    monkeypatch.setattr(Trainer, "_fid_extractor", lambda self: pool_extractor)
    val = Dataset(Config(CFG, overrides=copy.deepcopy(EVAL)), is_inference=True)
    trainer = port(tmp_path / "run")
    trainer.val_data_loader = frame_loader(val)
    trainer.current_iteration = 3
    fid = trainer.write_metrics()
    assert fid is not None and np.isfinite(fid) and trainer.fid_ema is None
    names = {r["name"]: r["value"] for r in ScalarWriter(str(tmp_path / "run")).read()}
    assert names["FID"] == pytest.approx(fid) and names["best_FID"] == pytest.approx(fid)
    assert os.path.exists(tmp_path / "run" / "real_stats_video_street_tiny.npz")

    path = trainer.save_checkpoint(0, 3)
    cfg_path = write_config(tmp_path / "v2v.yaml", EVAL)
    rows = evaluate.main(["--config", cfg_path, "--checkpoint", path, "--device", "cpu",
                          "--metrics", "fid,kid,prdc", "--logdir", str(tmp_path / "eval")])
    want = {"FID", "best_FID", "KID", "PRDC_precision", "PRDC_recall", "PRDC_density",
            "PRDC_coverage"}
    assert len(rows) == 1 and want <= set(rows[0]) and "FID_ema" not in rows[0]
    assert all(np.isfinite(rows[0][k]) for k in want)
    # the same weights and sequence as the in-loop FID
    assert rows[0]["FID"] == pytest.approx(fid, rel=1e-6)
    written = {r["name"] for r in ScalarWriter(str(tmp_path / "eval")).read()}
    assert want <= written


# ------------------------------------------------------------ inference


def test_trainer_test_writes_every_frame_as_jax_generates_it(pair, tmp_path):
    jt, port = pair
    jds, tds = datasets()
    jax_frames = []
    jt._save_test_frame = lambda out, key, t, fake: jax_frames.append(
        (key, t, np.asarray(fake)[0]))
    jt.test(jt._frame_loader(jds), str(tmp_path / "jax"))

    trainer = port()
    port_frames, save = [], trainer._save_test_frame

    def keep(out, key, t, fake):
        port_frames.append((key, t, fake[0].permute(1, 2, 0).numpy()))
        save(out, key, t, fake)

    trainer._save_test_frame = keep
    out = tmp_path / "port"
    trainer.test(frame_loader(tds), str(out))
    keys = [(f"seq{s:04d}", t) for s in range(2) for t in range(FRAMES)]
    assert [f[:2] for f in port_frames] == [f[:2] for f in jax_frames] == keys
    assert sorted(os.listdir(out)) == ["seq0000", "seq0001"]
    for (key, t, got), (_, _, want) in zip(port_frames, jax_frames):
        np.testing.assert_allclose(got, want, atol=TOL_FRAME, rtol=0, err_msg=f"{key}/{t}")
        png = decode_png((out / key / f"{t:04d}.png").read_bytes())
        assert png.shape == (HW, HW, 3)
        assert np.abs(png.astype(int) - jax_tensor2im(want).astype(int)).max() <= 1
    # the two sequences are the same frames: each rollout started afresh
    np.testing.assert_array_equal(port_frames[FRAMES][2], port_frames[0][2])


def test_inference_entry_writes_every_frame_of_every_sequence(pair, tmp_path):
    _, port = pair
    overrides = copy.deepcopy(EVAL)
    overrides["test_data"] = {
        "name": "street_tiny", "type": "imaginaire_tpu.data.paired_videos",
        "input_types": copy.deepcopy(Config(CFG).data.input_types),
        "input_image": ["images"], "input_labels": ["seg_maps"],
        "test": {"roots": [FIXTURE, FIXTURE],
                 "augmentations": {"resize_h_w": "64, 64"}}}
    path = port(tmp_path / "run").save_checkpoint(0, 1)
    cfg_path = write_config(tmp_path / "v2v.yaml", overrides)
    out = tmp_path / "frames"
    inference.main(["--config", cfg_path, "--checkpoint", path, "--device", "cpu",
                    "--output_dir", str(out), "--logdir", str(tmp_path / "inf")])
    assert {str(p.relative_to(out)) for p in out.rglob("*.png")} == {
        f"seq{s:04d}/{t:04d}.png" for s in range(2) for t in range(FRAMES)}


# ----------------------------------------------------------- activations


def test_video_activations_match_jax_and_cap_sequences_first(pair):
    jt, port = pair
    jds, tds = datasets()
    trainer = port()
    for trainer_j, trainer_p in ((jt, trainer), (None, None)):
        for sample_size in (None, 1):
            want = jax_video_activations(jt._frame_loader(jds), "images", "fake_images",
                                         trainer_j, pool_extractor_jax, sample_size)
            got = get_video_activations(frame_loader(tds), "images", "fake_images",
                                        trainer_p, pool_extractor, sample_size)
            n_seq = 2 if sample_size is None else 1
            assert got.shape == np.shape(want) == (n_seq * FRAMES, 192)
            np.testing.assert_allclose(got, want, atol=TOL_ACTS, rtol=0)


# ------------------------------------------ the teacher cache's dataset half


def flow_overrides(tmp_path, **augmentations):
    aug = dict(resize_smallest_side=64, random_crop_h_w="48, 48", horizontal_flip=True)
    aug.update(augmentations)
    return {"flow_network": {"type": "imaginaire_tpu.flow.flow_net",
                             "allow_random_init": True,
                             "weights_path": str(tmp_path / "absent.npz")},
            "flow_cache": {"enabled": True, "mode": "disk", "dir": str(tmp_path / "cache")},
            "data": {"train": {"augmentations": aug}}}


def jax_item(ds, index):
    random.seed(f"0/0/{index}")
    return ds[index]


def assert_payloads_equal(got, want):
    assert set(got) == set(want)
    assert got["record"] == want["record"]
    for key in set(want) - {"record"}:
        if key == "keys":
            assert got[key] == want[key]
        else:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("augmentation", ["crop_flip", "rot90"])
def test_records_and_payloads_match_jax(tmp_path, augmentation):
    """A window with a miss ships its canonical frames; once the JAX
    package's store holds every pair, the same item ships the stacked
    (flow, conf) read back from it; a draw that is not crops and flips
    after the resizes ships its record alone."""
    extra = {"random_rotate_90": True} if augmentation == "rot90" else {}
    jds, tds = datasets(flow_overrides(tmp_path, **extra), is_inference=False)
    assert tds._flow_hook is not None and tds._flow_hook.teacher == jds._flow_hook.teacher
    want, got = jax_item(jds, 0), tds[0]
    for key in ("images", "label"):
        np.testing.assert_array_equal(got[key], want[key])
    assert tds.augmentor.last_record == jds.augmentor.last_record
    assert_payloads_equal(got["_flow_cache"], want["_flow_cache"])
    payload = want["_flow_cache"]
    if augmentation == "rot90":
        assert set(payload) == {"record"} and not payload["record"]["canonical_ok"]
        return
    assert set(payload) == {"record", "keys", "src"}
    assert payload["record"]["canonical_hw"] == (HW, HW)
    assert payload["record"]["crop"][2:] == (48, 48)
    assert payload["src"].shape == (FRAMES, HW, HW, 3)

    rng = np.random.default_rng(0)
    store = jax_cache.FlowCacheStore(str(tmp_path / "cache"))
    for key in payload["keys"]:
        store.put(key, rng.standard_normal((HW, HW, 2)).astype(np.float32) * 5,
                  (rng.uniform(size=(HW, HW, 1)) > 0.5).astype(np.float32))
    want, got = jax_item(jds, 0), tds[0]
    assert set(got["_flow_cache"]) == {"record", "keys", "flow", "conf"}
    assert_payloads_equal(got["_flow_cache"], want["_flow_cache"])
    # a pinned inference item never carries one
    _, val = datasets(flow_overrides(tmp_path))
    val.set_inference_sequence_idx(0)
    assert "_flow_cache" not in val[0]


# --------------------------------------------------------- precompute_flow


class StubTeacher:
    """Stands in for the port's ``FlowNet``: the flow from a to b is
    their mean difference on both axes, the confidence where it is
    positive."""
    calls = 0
    device = torch.device("cpu")

    def __init__(self, weights_path=None, allow_random_init=False, device=None):
        self.weights_path = weights_path

    def init_params(self, seed=0):
        pass

    def __call__(self, a, b):
        type(self).calls += 1
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        diff = (a - b).mean(1, keepdim=True)
        return torch.cat([diff, -diff], 1), (diff > 0).float()


def test_precompute_flow_refuses_warms_and_crosses_packages(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(precompute_flow, "FlowNet", StubTeacher)
    monkeypatch.setattr(StubTeacher, "calls", 0)
    run = ["--device", "cpu", "--json"]
    refused = {
        "no_dir": dict(flow_overrides(tmp_path), flow_cache={"enabled": True}),
        "no_teacher": dict(flow_overrides(tmp_path), flow_network=None),
        "random_resize": flow_overrides(tmp_path, random_scale_limit=0.2),
        "no_sequences": dict(flow_overrides(tmp_path), data={
            "type": "imaginaire_tpu.data.paired_images"})}
    for name, overrides in refused.items():
        cfg_path = write_config(tmp_path / f"{name}.yaml", overrides)
        assert precompute_flow.main(["--config", cfg_path] + run) == 2, name
    assert not (tmp_path / "cache").exists() and StubTeacher.calls == 0

    cfg_path = write_config(tmp_path / "warm.yaml", flow_overrides(tmp_path))
    capsys.readouterr()
    summaries = []
    for _ in range(2):
        assert precompute_flow.main(["--config", cfg_path] + run) == 0
        summaries.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert [(s["pairs"], s["hits"], s["misses"]) for s in summaries] == [
        (FRAMES - 1, 0, FRAMES - 1), (FRAMES - 1, FRAMES - 1, 0)]
    assert summaries[1]["hit_rate"] == 1.0 and summaries[0]["canonical_hw"] == [HW, HW]
    assert StubTeacher.calls == 1  # one chunk of 2 pairs; none on the second run

    # the JAX package reads the shards under its own keys, and the port's
    # dataset ships them
    jds, tds = datasets(flow_overrides(tmp_path), is_inference=False)
    _, seq, stems = jds.sequences[0]
    jax_store = jax_cache.FlowCacheStore(str(tmp_path / "cache"))
    port_store = port_cache.FlowCacheStore(str(tmp_path / "cache"))
    teacher = jax_cache.teacher_id(str(tmp_path / "absent.npz"))
    assert port_cache.teacher_id(str(tmp_path / "absent.npz")) == teacher
    ops, _, _ = deterministic_resize_chain(tds.augmentor.cfg, (300, 320))
    frames = precompute_flow.canonicalize_frames(
        [tds.backends["images"][0].getitem(f"{seq}/{s}") for s in stems],
        ops, "BILINEAR", True)
    keys = [jax_cache.pair_key("street_tiny", 0, seq, stems[p + 1], stems[p], (HW, HW),
                               teacher) for p in range(FRAMES - 1)]
    for p, key in enumerate(keys):
        flow, conf = jax_store.get(key)
        for got, want in zip(port_store.get(key), (flow, conf)):
            np.testing.assert_array_equal(got, want)
        diff = (frames[p + 1] - frames[p]).mean(-1, keepdims=True)
        # the stub's float32 flow, stored as float16
        np.testing.assert_allclose(flow, np.concatenate([diff, -diff], -1),
                                   rtol=1e-3, atol=1e-3)
        assert set(np.unique(conf)) <= {0.0, 1.0}
    payload = tds[0]["_flow_cache"]
    assert set(payload) == {"record", "keys", "flow", "conf"}
    assert payload["keys"] == keys

    # a training batch from the loader attaches every pair from the store,
    # cropped and flipped as its item was, and runs no teacher
    batch = next(iter(DataLoader(tds, batch_size=1, shuffle=False)))
    assert isinstance(batch["_flow_cache"], list) and batch["images"].shape[1:] == (
        FRAMES, 48, 48, 3)
    cache = port_cache.TeacherFlowCache(StubTeacher(), port_cache.flow_cache_settings(
        Config(CFG, overrides=flow_overrides(tmp_path))), str(tmp_path / "cache"))
    record = batch["_flow_cache"][0]["record"]
    out = cache.attach(batch)
    assert cache.hit_rate() == 1.0 and StubTeacher.calls == 1
    stored = port_cache.transform_flow(payload["flow"], payload["conf"], record)
    np.testing.assert_array_equal(out["flow_gt"][0].permute(0, 2, 3, 1).numpy(), stored[0])
    np.testing.assert_array_equal(out["conf_gt"][0].permute(0, 2, 3, 1).numpy(), stored[1])


def test_teacher_cache_attaches_to_the_loaders_host_batches():
    """ROADMAP C7: the trainer's host hook hands ``attach`` the loader's
    (B, T, H, W, C) arrays, which it read as (B, T, C, H, W): with the
    flow cache on, a training iteration raised in the teacher."""
    settings = port_cache.flow_cache_settings(
        {"flow_cache": {"enabled": True, "mode": "producer"}})
    cache = port_cache.TeacherFlowCache(StubTeacher(), settings)
    images = np.tanh(np.random.RandomState(0).randn(2, FRAMES, 8, 10, 3)).astype(np.float32)
    host = cache.attach({"images": images})
    device = cache.attach({"images": torch.from_numpy(images).permute(0, 1, 4, 2, 3)})
    assert host["flow_gt"].shape == (2, FRAMES - 1, 2, 8, 10)
    assert host["conf_gt"].shape == (2, FRAMES - 1, 1, 8, 10)
    for key in ("flow_gt", "conf_gt"):
        assert torch.equal(host[key], device[key])
