"""The port's FlowNet2 teacher (flow/flownet2.py, flow/flow_net.py,
flow/cache.py, the teacher half of trainers/vid2vid.py) against the JAX
package.

Weights: the JAX parameter shapes come from ``jax.eval_shape`` of
``FlowNet2.init`` (running the init is slow), every kernel is drawn with
numpy from a seed at ~1/sqrt(fan_in) and every bias at 0.1 scale, and the
tree is carried into the port with ``bridge.load_flax_variables`` (which
refuses a leaf left over or a port tensor left unset) or through a
``flownet2.npz`` written from it. The JAX side is jitted once per input
shape. On the CPU the port's wrappers take their plain versions; the
CUDA kernels are held to them on the card.

Tolerances: the whole cascade (fp32, ~100 layers, five networks, four
warps) max-abs <= 1e-4 of the flow's max magnitude; one transposed conv
1e-5. The confidence map thresholds a squared warp error at 0.02, so the
two packages' maps may differ only where the port's own error is within
1e-3 of the threshold.
"""

import logging

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.flow import FlowNet as JaxFlowNet
from imaginaire_tpu.flow import cache as jax_cache
from imaginaire_tpu.flow.flownet2 import Deconv as JaxDeconv
from imaginaire_tpu.flow.flownet2 import FlowNet2 as JaxFlowNet2
from imaginaire_tpu_torch.bridge import load_flax_variables
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.flow import cache
from imaginaire_tpu_torch.flow.flow_net import FlowNet
from imaginaire_tpu_torch.flow.flownet2 import Deconv, FlowNet2
from imaginaire_tpu_torch.ops import resample2d as rs
from imaginaire_tpu_torch.trainers.vid2vid import Trainer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs on one CPU thread: the suite runs several
    test processes at once, and intra-op threads of each would contend
    for the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


PARAMS = 162_518_834  # the reference's count (flownet2/models.py:17)
TOL_REL = 1e-4
CONF_BAND = 1e-3
HW = 64


def random_params(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            w = rng.standard_normal(leaf.shape, dtype=np.float32)
            return w * np.float32(1.0 / np.sqrt(fan_in))
        return rng.standard_normal(leaf.shape, dtype=np.float32) * np.float32(0.1)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def nchw(a):
    """NHWC (or N,T,H,W,C) numpy -> NCHW (N,T,C,H,W) torch."""
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def nhwc(t):
    return np.moveaxis(t.float().numpy(), -3, -1)


def clip(seed, t=3, lead=(1,)):
    """Seeded frames in [-1, 1], NHWC with time at dim 1: each frame is
    the previous one shifted by a pixel plus noise, so some pixels warp
    back well."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-1, 1, lead + (HW + t, HW + t, 3)).astype(np.float32)
    frames = [base[..., i:i + HW, i:i + HW, :] for i in range(t)]
    out = np.stack(frames, axis=len(lead))
    return out + rng.normal(0, 0.05, out.shape).astype(np.float32)


def assert_flow_close(got, want):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= TOL_REL * scale, (err, scale)


def assert_conf_matches(got, want, im1, im2, flow):
    """got, want: NHWC conf; im1, im2, flow: the port's NCHW inputs and
    flow. Mismatches only where the squared warp error is at the
    threshold."""
    sq = ((im1 - rs.resample2d_plain(im2, flow)) ** 2).sum(1, keepdim=True)
    near = np.abs(nhwc(sq) - 0.02) <= CONF_BAND
    assert set(np.unique(got)) <= {0.0, 1.0}
    assert np.array_equal(got[~near], want[~near])


@pytest.fixture(scope="module")
def jax_params():
    shapes = jax.eval_shape(lambda: JaxFlowNet2().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, HW, HW, 3))))
    return random_params(shapes["params"])


@pytest.fixture(scope="module")
def port_model(jax_params):
    with torch.device("meta"):
        model = FlowNet2().eval()
    model.to_empty(device="cpu")
    return load_flax_variables(model, {"params": jax_params})


@pytest.fixture(scope="module")
def weights_npz(jax_params, tmp_path_factory):
    flat = {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(jax_params)}
    path = tmp_path_factory.mktemp("flownet2") / "flownet2.npz"
    np.savez(path, **flat)
    return str(path)


@pytest.fixture(scope="module")
def wrappers(jax_params, weights_npz):
    """(JAX FlowNet, port FlowNet) on the same weights; the port's loads
    them from the npz, and both name it as their weights file."""
    jfn = JaxFlowNet(weights_path=weights_npz)
    jfn.params = jax_params
    tfn = FlowNet(weights_path=weights_npz, device="cpu")
    tfn.init_params()
    return jfn, tfn


def test_param_count():
    with torch.device("meta"):
        model = FlowNet2()
    assert sum(p.numel() for p in model.parameters()) == PARAMS


def test_deconv_bridge_rotates_transposed_kernels():
    """flax ConvTranspose(k4, s2, padding 2) (transpose_kernel=False)
    equals torch ConvTranspose2d(k4, s2, p1) with the kernel moved to
    (in, out, kh, kw) and rotated 180 degrees."""
    x = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32)
    jnet = JaxDeconv(6)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), x))
    variables = random_params(shapes, seed=1)
    want = np.asarray(jnet.apply(variables, x))
    tnet = load_flax_variables(Deconv(3, 6), variables)
    with torch.no_grad():
        got = tnet(nchw(x))
    assert got.shape == (2, 6, 10, 14)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-5)


def test_flownet2_matches_jax(jax_params, port_model):
    data = clip(2, t=2)  # (1, 2, 64, 64, 3)
    want = np.asarray(jax.jit(lambda p, x: JaxFlowNet2().apply(
        {"params": p}, x))(jax_params, jnp.asarray(data)))
    with torch.no_grad():
        got = port_model(nchw(data))
    assert got.shape == (1, 2, HW, HW)
    assert np.abs(want).max() > 1.0  # a flow of a few pixels, not noise
    assert_flow_close(nhwc(got), want)


def test_npz_round_trip_gives_the_same_flow(port_model, wrappers):
    data = nchw(clip(3, t=2))
    with torch.no_grad():
        want = port_model(data)
        got = wrappers[1].model(data)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(1, HW + 6, HW + 36), (1, 2, HW, HW)],
                         ids=["resize-70x100", "5d"])
def test_flow_net_wrapper_matches_jax(wrappers, shape):
    """(1, 70, 100): resized to 64x64 and back, flow scaled per axis; 5-d
    (B, N, ...) inputs flatten through."""
    jfn, tfn = wrappers
    rng = np.random.RandomState(4)
    a = rng.uniform(-1, 1, shape + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), -1, 1).astype(np.float32)
    want_flow, want_conf = (np.asarray(v) for v in jfn(jnp.asarray(a),
                                                       jnp.asarray(b)))
    flow, conf = tfn(nchw(a), nchw(b))
    assert flow.shape == shape[:-2] + (2,) + shape[-2:]
    assert conf.shape == shape[:-2] + (1,) + shape[-2:]
    assert_flow_close(nhwc(flow), want_flow)
    if shape[-2:] == (HW, HW):
        im1 = nchw(a).reshape(-1, 3, HW, HW)
        im2 = nchw(b).reshape(-1, 3, HW, HW)
        assert_conf_matches(nhwc(conf).reshape(-1, HW, HW, 1),
                            want_conf.reshape(-1, HW, HW, 1), im1, im2,
                            flow.reshape(-1, 2, HW, HW))
    else:  # resized back bilinearly: a blend of 0/1 values
        assert conf.min() >= 0 and conf.max() <= 1
        np.testing.assert_allclose(nhwc(conf), want_conf, rtol=0, atol=0.05)


def test_cache_keys_and_flow_transform_match_jax():
    assert cache.TEACHER_VERSION == jax_cache.TEACHER_VERSION
    args = ("cityscapes", 0, "seq01", "frame_0003", "frame_0002", (512, 1024),
            cache.teacher_id())
    assert cache.pair_key(*args) == jax_cache.pair_key(*args)
    images = clip(5, t=3)
    assert cache.content_key(images, "t") == jax_cache.content_key(images, "t")
    rng = np.random.RandomState(6)
    flow = rng.randn(2, 8, 10, 2).astype(np.float32)
    conf = (rng.rand(2, 8, 10, 1) > 0.5).astype(np.float32)
    for record in ({}, {"crop": (1, 2, 5, 6)}, {"hflip": True},
                   {"crop": (0, 3, 8, 7), "hflip": True}):
        got = cache.transform_flow(flow, conf, record)
        want = jax_cache.transform_flow(flow, conf, record)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_store_shards_cross_between_packages(tmp_path):
    rng = np.random.RandomState(7)
    flow = (rng.randn(4, 6, 2) * 10).astype(np.float32)
    conf = (rng.rand(4, 6, 1) > 0.5).astype(np.float32)
    jstore = jax_cache.FlowCacheStore(tmp_path)
    tstore = cache.FlowCacheStore(tmp_path)
    jstore.put("aa01", flow, conf)
    tstore.put("bb02", flow * 2, conf)
    for store, key, scale in ((tstore, "aa01", 1), (jstore, "bb02", 2)):
        got_flow, got_conf = store.get(key)
        np.testing.assert_allclose(got_flow, flow * scale, rtol=1e-3, atol=1e-2)
        assert np.array_equal(got_conf, conf)
    # a corrupt shard is a miss once, then moved aside
    with open(tstore.path("aa01"), "wb") as f:
        f.write(b"not a zip")
    assert tstore.get("aa01") is None
    assert tstore.corrupt_shards == 1
    assert (tmp_path / "aa" / "aa01.npz.corrupt").exists()
    assert tstore.stats()["hits"] == 1 and tstore.stats()["misses"] == 1


def test_teacher_flow_cache_attach_matches_jax(wrappers, tmp_path):
    jfn, tfn = wrappers
    images = clip(8, t=3)  # (1, 3, 64, 64, 3) in [-1, 1]
    jax_batch = jax_cache.TeacherFlowCache(
        jfn, jax_cache.flow_cache_settings({"flow_cache": {"mode": "producer"}})
    ).attach({"images": images})
    settings = cache.flow_cache_settings(
        {"flow_cache": {"enabled": True, "mode": "disk"}})
    teacher = cache.TeacherFlowCache(tfn, settings, cache_dir=str(tmp_path))
    first = teacher.attach({"images": nchw(images)})
    assert first["flow_gt"].shape == (1, 2, 2, HW, HW)
    assert first["conf_gt"].shape == (1, 2, 1, HW, HW)
    assert_flow_close(nhwc(first["flow_gt"]), jax_batch["flow_gt"])
    frames = nchw(images)[0]
    assert_conf_matches(nhwc(first["conf_gt"][0]), jax_batch["conf_gt"][0],
                        frames[1:], frames[:-1], first["flow_gt"][0])
    assert (teacher.pair_hits, teacher.pair_misses) == (0, 2)

    # the second attach reads the shard back (float16 flow)
    second = teacher.attach({"images": nchw(images)})
    assert (teacher.pair_hits, teacher.pair_misses) == (2, 2)
    np.testing.assert_allclose(second["flow_gt"].numpy(),
                               first["flow_gt"].numpy(), rtol=1e-3, atol=1e-2)
    assert torch.equal(second["conf_gt"], first["conf_gt"])
    stats = teacher.drain_stats()
    assert stats["flow_cache/pairs"] == [2.0, 2.0]
    assert stats["flow_cache/hit_rate"] == [0.0, 0.5]

    # same key and shard format: the JAX cache hits the port's shard
    jdisk = jax_cache.TeacherFlowCache(jfn, settings, cache_dir=str(tmp_path))
    hit = jdisk.attach({"images": images})
    assert jdisk.pair_hits == 2
    np.testing.assert_allclose(hit["flow_gt"], nhwc(second["flow_gt"]),
                               rtol=0, atol=0)


def test_teacher_flow_cache_attach_from_payloads_matches_jax(wrappers, tmp_path):
    """Per-sample ``_flow_cache`` payloads (NHWC, the dataset hook's
    layout): sample 0 carries its canonical frames and is flipped, sample
    1 a cached canonical flow that is cropped to the batch."""
    jfn, tfn = wrappers
    frames = clip(10, t=3)[0]  # (3, 64, 64, 3)
    rng = np.random.RandomState(11)
    cached_flow = (rng.randn(2, HW + 2, HW + 6, 2) * 3).astype(np.float32)
    cached_conf = (rng.rand(2, HW + 2, HW + 6, 1) > 0.5).astype(np.float32)
    metas = [{"src": frames, "keys": ["aa01", "bb02"], "record": {"hflip": True}},
             {"flow": cached_flow, "conf": cached_conf,
              "record": {"crop": (1, 3, HW, HW)}}]
    images = np.zeros((2, 3, HW, HW, 3), np.float32)  # only its size is read
    settings = cache.flow_cache_settings(
        {"flow_cache": {"enabled": True, "mode": "disk"}})
    jax_batch = jax_cache.TeacherFlowCache(jfn, settings, cache_dir=str(
        tmp_path / "jax")).attach({"images": images, "_flow_cache": metas})
    teacher = cache.TeacherFlowCache(tfn, settings, cache_dir=str(tmp_path / "port"))
    got = teacher.attach({"images": nchw(images), "_flow_cache": metas})
    assert "_flow_cache" not in got
    assert got["flow_gt"].shape == (2, 2, 2, HW, HW)
    assert (teacher.pair_hits, teacher.pair_misses) == (2, 2)
    assert_flow_close(nhwc(got["flow_gt"][0]), jax_batch["flow_gt"][0])
    assert np.array_equal(nhwc(got["flow_gt"][1]), jax_batch["flow_gt"][1])
    assert np.array_equal(nhwc(got["conf_gt"][1]), jax_batch["conf_gt"][1])
    # the canonical misses were written back, one shard per frame pair
    for key, p in (("aa01", 0), ("bb02", 1)):
        flow, _ = teacher.store.get(key)
        want = nhwc(got["flow_gt"][0, p])[:, ::-1] * np.float32([-1, 1])
        np.testing.assert_allclose(flow, want, rtol=1e-3, atol=1e-2)


def _trainer(tmp_path, allow_random_init):
    return Trainer(Config("configs/unit_test/vid2vid_street.yaml", overrides={
        "flow_network": {"type": "imaginaire_tpu.flow.flow_net",
                         "weights_path": str(tmp_path / "absent.npz"),
                         "allow_random_init": allow_random_init},
        "flow_cache": {"enabled": True, "mode": "producer"}}), device="cpu")


def test_trainer_attaches_teacher_flow_on_training_iterations(tmp_path):
    trainer = _trainer(tmp_path, allow_random_init=True)
    assert trainer.flow_cache is not None and trainer.flow_cache.mode == "producer"
    images = nchw(clip(9, t=2))
    data = {"images": images, "label": torch.zeros(1, 2, 12, HW, HW)}
    trained = trainer._start_of_iteration(dict(data), 0)
    assert trained["flow_gt"].shape == (1, 1, 2, HW, HW)
    assert trained["conf_gt"].shape == (1, 1, 1, HW, HW)
    assert torch.isfinite(trained["flow_gt"]).all()
    assert "flow_gt" not in data  # the caller's dict is left alone
    evaluated = trainer._start_of_iteration(
        dict(data, _flow_cache=[{"record": {}}]), -1)
    assert set(evaluated) == {"images", "label"}


def test_trainer_without_teacher_weights_warns(tmp_path, caplog):
    with caplog.at_level(logging.WARNING):
        trainer = _trainer(tmp_path, allow_random_init=False)
    assert trainer.flow_net_wrapper is None and trainer.flow_cache is None
    assert "FlowNet2 teacher unavailable" in caplog.text
    data = {"images": nchw(clip(9, t=2))}
    assert set(trainer._start_of_iteration(dict(data), 0)) == {"images"}
