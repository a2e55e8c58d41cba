"""fs-vid2vid's training steps and inference in the port against the JAX
package on the CPU, on the cut unit config of ``test_torch_fs_vid2vid.py``
(whose helpers this file shares): one fp32 D and G step with Adam, the
rollout under ``gen.remat: blocks``, and ``trainer.test`` and the serving
engine's stream.

Tolerances:
- the steps: losses rtol 1e-4, each grad leaf within 1e-3 of its max,
  a leaf under 1% of the largest held to 1e-3 of 1% of it (the vid2vid
  rollout test's rule, ``check_grads``), Adam's first step
  lr * g / (|g| + eps) from the JAX grads, within 0.25 lr where a
  gradient is over 1% of the network's largest and 2.1 lr (a sign flip
  of a rounding-noise gradient) elsewhere; remat against no remat 1e-6;
- ``trainer.test`` frames: 1e-4; the engine's stream equals
  ``trainer.test`` exactly (the same forwards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.data.paired_few_shot_videos import Dataset as JaxDataset
from imaginaire_tpu.models.generators.fs_vid2vid import Generator as JaxGenerator
from imaginaire_tpu.trainers.fs_vid2vid import Trainer as JaxTrainer
from imaginaire_tpu_torch.bridge import load_flax_variables, to_port_layout
from imaginaire_tpu_torch.data.loader import DataLoader
from imaginaire_tpu_torch.data.paired_few_shot_videos import Dataset
from imaginaire_tpu_torch.serving.engine import engine_from_config
from imaginaire_tpu_torch.trainers.fs_vid2vid import Trainer
from test_torch_fs_vid2vid import (  # noqa: E402
    CHEAP,
    HW,
    LR,
    cheap_jit,
    configs,
    draw,
    frames,
    generator_vars,
    to_nhwc,
    to_torch,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- steps


def port_trainer(tcfg, variables):
    trainer = Trainer(tcfg, device="cpu", train=True)
    trainer.init_state(seed=0)
    load_flax_variables(trainer.net_G, variables["G"])
    load_flax_variables(trainer.net_D, variables["D"])
    load_flax_variables(trainer.perceptual.module, {"params": variables["VGG"]})
    return trainer


@pytest.fixture(scope="module")
def train_pair():
    jcfg, tcfg = configs()
    jt = JaxTrainer(jcfg)
    d = {k: jnp.asarray(v) for k, v in frames(30).items()}
    key = jax.random.PRNGKey(0)
    d0 = {"label": d["label"], "image": d["image"], "ref_images": d["ref_images"],
          "ref_labels": d["ref_labels"]}
    variables = {
        "G": generator_vars(jt.net_G, 1, seed=3),
        "D": draw(jax.eval_shape(lambda: jt.net_D.init(
            {"params": key, "dropout": key}, d0, {"fake_images": d0["image"]},
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


def check_grads(net, got, grads):
    want = to_port_layout(net, grads)
    assert set(want) == set(got)
    largest = max(np.abs(v).max() for v in want.values())
    for name, value in want.items():
        scale = max(np.abs(value).max(), 1e-2 * largest)
        assert np.abs(got[name].numpy() - value).max() <= 1e-3 * scale, name


@pytest.mark.parametrize("kind", ["D", "G"])
def test_step_matches_jax(train_pair, kind, t=1):
    """One fp32 D step and one G step on a frame with its previous frame
    (both warps; the G step runs the resample backward of both): the
    losses, every gradient, and the parameters after Adam's first
    step. The first frame's outputs are held by the generator test."""
    jt, tcfg, variables = train_pair
    d = frames(31 + t, t=t)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    losses, grads = cheap_jit(lambda v, dt: jax_step(jt, kind, v, dt), variables, jd)
    trainer = port_trainer(tcfg, variables)
    net, opt = ((trainer.net_D, trainer.opt_D) if kind == "D"
                else (trainer.net_G, trainer.opt_G))
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    td = {k: to_torch(v) for k, v in d.items()}
    forward = ((lambda: trainer.dis_forward(td)) if kind == "D"
               else (lambda: trainer.gen_forward(td)[0]))
    got = trainer._step(net, opt, forward, None, f"{kind}_step")
    expected = {"GAN", "total"} | ({"D_real_acc", "D_fake_acc"} if kind == "D" else
                                   {"FeatureMatching", "Perceptual", "Flow"})
    assert expected <= set(losses) == set(got) - {"grad_norm"}
    for k, v in losses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=0, err_msg=k)
    # a parameter no loss reaches (the shortcut's predicted norm weights)
    # has no gradient in the port and a zero one in JAX
    grads_got = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in net.named_parameters()}
    check_grads(net, grads_got, grads)
    # Adam's first update is lr * g / (|g| + eps) an element: where a
    # gradient is rounding noise its sign may differ (2 lr at most), where
    # it is over 1% of the network's largest the update is the JAX one up
    # to the float32 rounding of the parameter (values near 1: 0.12 lr)
    want_g = to_port_layout(net, grads)
    largest = max(np.abs(g).max() for g in want_g.values())
    for name, g in want_g.items():
        want = before[name].numpy() - LR * g / (np.abs(g) + 1e-8)
        diff = np.abs(net.get_parameter(name).detach().numpy() - want)
        assert diff.max() <= 2.1 * LR, name
        assert diff[np.abs(g) > 1e-2 * largest].max(initial=0) <= 0.25 * LR, name


def test_remat_rollout_equals_plain_rollout(train_pair):
    """``gen.remat: blocks`` checkpoints the hyper blocks with their
    predicted weights riding the call: a 2-frame rollout gives the same
    losses, gradients and spectral-norm state as without remat."""
    _, _, variables = train_pair
    clip = {k: to_torch(np.concatenate([frames(40 + t)[k][:, None] for t in range(2)], 1))
            for k in ("label", "image")}
    d = frames(40)
    data = {"label": clip["label"], "images": clip["image"],
            "ref_images": to_torch(d["ref_images"]), "ref_labels": to_torch(d["ref_labels"])}
    results = []
    for remat in ("none", "blocks"):
        _, tcfg = configs({"gen": {"remat": remat}})
        trainer = port_trainer(tcfg, variables)
        losses = trainer.gen_update(data)
        results.append((losses, [p.grad for p in trainer.net_G.parameters()],
                        [b.clone() for b in trainer.net_G.buffers()]))
    (l0, g0, b0), (l1, g1, b1) = results
    assert set(l0) == set(l1) and "Flow" in l0
    for k in l0:
        torch.testing.assert_close(l0[k], l1[k], rtol=1e-6, atol=0)
    for a, b in zip(g0 + b0, g1 + b1):
        if a is None:
            assert b is None
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ inference


@pytest.fixture(scope="module")
def hyper_net():
    """The JAX generator of the unit config's hyper norm, its drawn
    variables and both configs."""
    jcfg, tcfg = configs()
    jnet = JaxGenerator(jcfg.gen, jcfg.data)
    return jnet, generator_vars(jnet, 1, seed=2), jcfg, tcfg


def test_trainer_test_and_engine_stream_match_jax(hyper_net, tmp_path):
    """``trainer.test`` over the fixture's sequence with ``driving_seq_index``
    and ``few_shot_frame_index`` pinned (the k-shot frame is frame 2):
    frames within 1e-4 of the JAX trainer's; the serving engine's stream
    of the same frames and reference equals ``trainer.test`` exactly."""
    _, variables, jcfg, tcfg = hyper_net
    args = {"driving_seq_index": 0, "few_shot_frame_index": 2}
    jt = JaxTrainer(jcfg)
    jt.state = {"vars_G": variables}
    compiled, apply_g = {}, jt._apply_G

    def cheap_apply(v, data_t, rng, training):
        shape = (training,) + tuple((k, np.shape(x)) for k, x in sorted(data_t.items()))
        if shape not in compiled:
            compiled[shape] = jax.jit(lambda a, b, c: apply_g(a, b, c, training)).lower(
                v, data_t, rng).compile(compiler_options=CHEAP)
        return compiled[shape](v, data_t, rng)

    jt._apply_G = cheap_apply
    jax_frames = []
    jt._save_test_frame = lambda out, key, t, fake: jax_frames.append(np.asarray(fake)[0])
    jds = JaxDataset(jcfg, is_inference=True)
    jt.test(jt._frame_loader(jds), str(tmp_path / "jax"), dict(args))

    trainer = Trainer(tcfg, device="cpu")
    trainer.init_state(seed=0)
    load_flax_variables(trainer.net_G, variables)
    port_frames, save = [], trainer._save_test_frame
    trainer._save_test_frame = lambda out, key, t, fake: (
        port_frames.append(to_nhwc(fake)[0]), save(out, key, t, fake))
    tds = Dataset(tcfg, is_inference=True)
    trainer.test(DataLoader(tds, batch_size=1, shuffle=False), str(tmp_path / "port"),
                 dict(args))
    assert len(port_frames) == len(jax_frames) == 3
    assert sorted(p.name for p in (tmp_path / "port" / "seq0000").iterdir()) == \
        ["0000.png", "0001.png", "0002.png"]
    for got, want in zip(port_frames, jax_frames):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

    # the snapshot's visualization: the reference, the last real frame, the
    # last generated frame (the rollout above's last frame), its warped reference
    clip = {k: torch.cat([torch.from_numpy(np.asarray(tds[t][k]))[None] for t in range(3)], 1)
            for k in ("label", "images")}
    ref = tds[0]
    vis = trainer._get_visualizations(trainer._to_device(
        dict(label=clip["label"].numpy(), images=clip["images"].numpy(),
             ref_images=ref["ref_images"][None], ref_labels=ref["ref_labels"][None])))
    assert [v.shape for v in vis] == [(1, HW, HW, 3)] * 4
    np.testing.assert_array_equal(vis[2][0], port_frames[2])

    engine = engine_from_config(tcfg, trainer=trainer)
    engine.refresh_weights()
    warm = engine.warm()
    assert len(next(iter(warm.values()))) == trainer.num_frames_G
    tds.set_inference_sequence_idx(0, None, 2)
    stream = engine.stream("a")
    for t in range(3):
        item = tds[t]
        frame = {"label": item["label"], "ref_images": item["ref_images"][None],
                 "ref_labels": item["ref_labels"][None]}
        np.testing.assert_array_equal(stream.step(frame)[0], port_frames[t])
