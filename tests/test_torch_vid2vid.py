"""The port's vid2vid generator and stream serving against the JAX
package, at configs/unit_test/vid2vid_street.yaml (64x64, num_filters 4).

Weights: the JAX variable shapes come from ``jax.eval_shape`` of the
generator's ``init_all`` init (running the init itself is slow), the
leaves are drawn with numpy from a seed (kernels ~ 1/sqrt(fan_in) so
the outputs have a real magnitude, BatchNorm variances positive, ``u``
at unit norm) and carried into the port with
``bridge.load_flax_variables``, which refuses a leaf left over or a port
tensor left unset. The JAX generator is jitted once per frame type
(first frame, one-frame history, warp). Labels are seeded one-hot maps.

Tolerances: 1e-5 for the embedders and the flow network (fp32, a few
layers); 1e-4 for the whole generator and the stream (fp32, ~40 layers
of differently ordered sums). Flows are compared in the units of the
flow head, i.e. divided by the config's ``flow_output_multiplier``
(40), which scales their rounding error with them.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.model_utils import fs_vid2vid as jax_fs
from imaginaire_tpu.models.generators.vid2vid import Generator as JaxGenerator
from imaginaire_tpu_torch.bridge import load_flax_variables
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.model_utils import fs_vid2vid
from imaginaire_tpu_torch.models.generators.vid2vid import Generator
from imaginaire_tpu_torch.ops import resample2d as rs
from imaginaire_tpu_torch.serving.engine import ServingError, engine_from_config

CFG = "configs/unit_test/vid2vid_street.yaml"
LABELS, HW = 12, 64
FLOW_MULTIPLIER = 40  # gen.flow.flow_output_multiplier of the config
OUT_KEYS = ("fake_images", "fake_flow_maps", "fake_occlusion_masks",
            "fake_raw_images", "warped_images")


def random_variables(shapes, seed=0):
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "u":
            u = rng.randn(*leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def one_hot(seed, n=1):
    idx = np.random.RandomState(seed).randint(0, LABELS, (n, HW, HW))
    return np.eye(LABELS, dtype=np.float32)[idx]


def nchw(a):
    """NHWC (or N,T,H,W,C) numpy -> NCHW (N,T,C,H,W) torch."""
    a = np.asarray(a)
    perm = (0, 3, 1, 2) if a.ndim == 4 else (0, 1, 4, 2, 3)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(perm)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def nets():
    jnet = JaxGenerator(JaxConfig(CFG).gen, JaxConfig(CFG).data)
    example = {"label": jnp.zeros((1, HW, HW, LABELS)),
               "images": jnp.zeros((1, HW, HW, 3))}
    shapes = jax.eval_shape(lambda: jnet.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        example, training=True, init_all=True))
    variables = random_variables(shapes)
    apply = jax.jit(lambda v, d: jnet.apply(
        v, d, training=False, mutable=["batch_stats", "spectral"])[0])
    tnet = Generator(Config(CFG).gen, Config(CFG).data).eval()
    load_flax_variables(tnet, variables)
    return jnet, variables, apply, tnet


def jax_method(nets, fn, *args):
    jnet, variables = nets[0], nets[1]
    return jax.jit(lambda v, *a: jnet.apply(v, *a, method=fn))(
        variables, *[jnp.asarray(a) for a in args])


def test_tree_has_the_spade_batchnorm_base_norms(nets):
    """The vid2vid configs' ``base_norm: instance`` is not read: every
    SPADE layer normalizes with BatchNorm running statistics, under a
    doubly auto-named path (ROADMAP.md, section C)."""
    stats = nets[1]["batch_stats"]
    assert set(stats["up_0"]["conv_0"]["norm"]["BatchNorm_0"]["BatchNorm_0"]) \
        == {"mean", "var"}
    assert set(nets[1]) == {"params", "spectral", "batch_stats"}


@pytest.mark.parametrize("name,channels", [("label_embedding", LABELS),
                                           ("img_prev_embedding", 4)])
def test_label_embedder_matches_jax(nets, name, channels):
    x = np.random.RandomState(3).randn(1, HW, HW, channels).astype(np.float32)
    want = jax_method(nets, lambda m, a: getattr(m, name)(a), x)
    with torch.no_grad():
        got = getattr(nets[3], name)(nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), atol=1e-5, rtol=0)


def test_flow_generator_matches_jax(nets):
    rng = np.random.RandomState(4)
    lbl = rng.randn(1, HW, HW, 3 * LABELS).astype(np.float32)
    img = rng.randn(1, HW, HW, 6).astype(np.float32)
    want = jax_method(nets, lambda m, a, b: m.flow_network_temp(a, b), lbl, img)
    with torch.no_grad():
        got = nets[3].flow_network_temp(nchw(lbl), nchw(img))
    for g, w, scale in zip(got, want, (FLOW_MULTIPLIER, 1)):
        np.testing.assert_allclose(nhwc(g) / scale, np.asarray(w) / scale,
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("history", [0, 1, 2])  # first, continuation, warp
def test_generator_matches_jax(nets, history):
    _, variables, apply, tnet = nets
    rng = np.random.RandomState(5)
    data = {"label": one_hot(6)}
    if history:
        data["prev_labels"] = np.stack([one_hot(7 + t)[0] for t in range(history)])[None]
        data["prev_images"] = np.tanh(rng.randn(1, history, HW, HW, 3)).astype(np.float32)
    want = apply(variables, {k: jnp.asarray(v) for k, v in data.items()})
    with torch.no_grad():
        got = tnet({k: nchw(v) for k, v in data.items()})
    assert set(got) == set(want) == set(OUT_KEYS)
    if history == 2:
        # a flow that agrees to 1e-4 head units moves a random previous
        # frame by more than 1e-4, so the warp is held to the JAX warp of
        # the same frame by the port's own flow
        want = dict(want, warped_images=jax_fs.resample(
            jnp.asarray(data["prev_images"][:, -1]),
            jnp.asarray(nhwc(got["fake_flow_maps"]))))
    for key in OUT_KEYS:
        if want[key] is None:
            assert got[key] is None, key
        else:
            scale = FLOW_MULTIPLIER if key == "fake_flow_maps" else 1
            np.testing.assert_allclose(nhwc(got[key]) / scale,
                                       np.asarray(want[key]) / scale,
                                       atol=1e-4, rtol=0, err_msg=key)
    assert (got["warped_images"] is not None) == (history == 2)


def test_code_start_matches_jax():
    """Without ``use_segmap_as_input`` (the vid2vid dancing config) the
    first frame starts from a code through a dense layer whose output is
    laid out (sh, sw, C)."""
    override = {"gen": {"use_segmap_as_input": False}}
    jnet = JaxGenerator(JaxConfig(CFG, overrides=override).gen,
                        JaxConfig(CFG, overrides=override).data)
    data = {"label": one_hot(60), "z": np.random.RandomState(61).randn(
        1, 32).astype(np.float32)}
    shapes = jax.eval_shape(lambda: jnet.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
        {k: jnp.asarray(v) for k, v in data.items()}, training=True,
        init_all=True))
    variables = random_variables(shapes, seed=1)
    want = jax.jit(lambda v, d: jnet.apply(
        v, d, training=False, mutable=["batch_stats", "spectral"])[0])(
        variables, {k: jnp.asarray(v) for k, v in data.items()})
    cfg = Config(CFG, overrides=override)
    tnet = Generator(cfg.gen, cfg.data).eval()
    load_flax_variables(tnet, variables)
    with torch.no_grad():
        got = tnet({"label": nchw(data["label"]), "z": torch.from_numpy(data["z"])})
    np.testing.assert_allclose(nhwc(got["fake_images"]),
                               np.asarray(want["fake_images"]), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def engine(nets):
    eng = engine_from_config(Config(CFG), device="cpu")
    eng.initialize(seed=0)
    load_flax_variables(eng.trainer.net_G, nets[1])
    eng.refresh_weights()
    return eng


def test_stream_session_matches_jax_frame_by_frame(nets, engine):
    _, variables, apply, _ = nets
    labels = [one_hot(20 + t) for t in range(4)]
    before = rs.launches
    session = engine.stream("parity")
    got = [session.step({"label": lab}) for lab in labels]
    engine.close_stream("parity")
    assert rs.launches == before  # the CPU takes the plain warp
    prev_labels = prev_images = None
    for t, lab in enumerate(labels):
        data = {"label": jnp.asarray(lab)}
        if prev_images is not None:
            data.update(prev_labels=prev_labels, prev_images=prev_images)
        fake = apply(variables, data)["fake_images"]
        np.testing.assert_allclose(got[t], np.asarray(fake), atol=1e-4, rtol=0,
                                   err_msg=f"frame {t}")
        prev_labels = jax_fs.concat_frames(prev_labels, data["label"], 2)
        prev_images = jax_fs.concat_frames(prev_images, fake, 2)
    label = engine.label(HW, HW, 1, tag="stream")
    assert label == "serve/vid2vid/stream/64x64/bs1"
    assert len(engine.stats()["exec_ms"][label]) >= 4


def test_interleaved_streams_are_isolated_and_reset_clears_history(engine):
    a_labels = [one_hot(30 + t) for t in range(4)]
    b_labels = [one_hot(40 + t) for t in range(3)]
    a, b = engine.stream("a"), engine.stream("b")
    b_frames = []
    for t in range(4):
        a.step({"label": a_labels[t]})
        if t < 3:
            b_frames.append(b.step({"label": b_labels[t]}))
    assert (a.t, b.t, a.prev_images.shape[1]) == (4, 3, 2)
    alone = engine.stream("b-alone")
    for t in range(3):
        np.testing.assert_array_equal(alone.step({"label": b_labels[t]}), b_frames[t])
    b.reset()
    assert (b.t, b.prev_labels, b.prev_images) == (0, None, None)
    np.testing.assert_array_equal(b.step({"label": b_labels[0]}), b_frames[0])
    for sid in ("a", "b", "b-alone"):
        engine.close_stream(sid)
    assert engine.stream("a").t == 0  # a closed stream reopens empty


def test_trainer_test_single_matches_the_stream(engine):
    trainer = engine.trainer
    labels = [one_hot(50 + t) for t in range(3)]
    session = engine.stream("trainer")
    want = [session.step({"label": lab}) for lab in labels]
    trainer.reset()
    for t, lab in enumerate(labels):
        got = trainer.test_single({"label": nchw(lab)})["fake_images"]
        np.testing.assert_array_equal(nhwc(got), want[t])
    assert trainer._test_prev_images.shape == (1, 2, 3, HW, HW)


def test_warm_steps_first_continuation_and_warp_frames(engine):
    report = engine.warm()
    assert list(report) == ["serve/vid2vid/stream/64x64/bs1"]
    assert len(report["serve/vid2vid/stream/64x64/bs1"]) == 3


def test_engine_refuses_batched_requests_and_other_frame_sizes(engine):
    from imaginaire_tpu_torch.serving.engine import ServeRequest

    with pytest.raises(ServingError, match="stream"):
        engine.submit(ServeRequest({"label": one_hot(0)}))
    with pytest.raises(ServingError, match="64x64"):
        engine.stream("odd").step({"label": np.zeros((1, 32, 32, LABELS), np.float32)})
    engine.close_stream("odd")


def test_fold_time_and_concat_frames_match_jax():
    rng = np.random.RandomState(8)
    ring = rng.randn(2, 3, 4, 5, 6).astype(np.float32)  # (B, T, H, W, C)
    want = np.asarray(jax_fs.fold_time(jnp.asarray(ring)))
    got = fs_vid2vid.fold_time(nchw(ring))
    np.testing.assert_array_equal(nhwc(got), want)
    now = rng.randn(2, 4, 5, 6).astype(np.float32)
    want = np.asarray(jax_fs.concat_frames(jnp.asarray(ring), jnp.asarray(now), 3))
    got = fs_vid2vid.concat_frames(nchw(ring), nchw(now), 3)
    np.testing.assert_array_equal(got.permute(0, 1, 3, 4, 2).numpy(), want)


@pytest.mark.parametrize("override,match", [
    ({"gen": {"flow": {"generate_raw_output": True}}}, "generate_raw_output"),
    ({"gen": {"flow": {"multi_spade_combine": False}}}, "multi_spade_combine"),
])
def test_unported_branches_raise_naming_the_roadmap(override, match):
    cfg = Config(CFG, overrides=override)
    with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP.md"):
        Generator(cfg.gen, cfg.data)
