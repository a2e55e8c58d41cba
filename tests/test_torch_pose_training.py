"""vid2vid on pose data in the port against the JAX package on the CPU:
one D and one G step of ``configs/unit_test/vid2vid_pose.yaml`` with its
face and hand discriminators, the foreground flag on the OpenPose path,
and the training and inference entries over seeded PNG frames and
OpenPose JSON (``chip_smoke.py``'s dancer; the helpers are
``test_torch_pose.py``'s).

The step is the first frame of a 64x64 clip at batch 2 (one sample with
no left hand, so the hand D's validity weights out one of its four
crops), VGG19 up to relu_1_1, fp32, with the JAX variables bridged. The
losses agree to rtol 1e-4, as in ``tests/test_torch_vid2vid_training.py``.
The gradients are held as a whole in L2 (``GRAD_TOL``), as in
``tests/test_torch_wc_vid2vid_training.py``, not leaf by leaf: measured
against the port's float64 step at the same weights, both packages' fp32
gradients of one leaf are far off in the D step (``net_D.d_0.layer0.conv.weight``,
1.7e-2 of its max in the port, 1.9e-2 in JAX: one filter of the sparse
pose label's first layer, behind an instance norm), and the JAX fp32 G
gradient is 1.8e-2 from float64 in L2 where the port's is 4.7e-3 (the two
fp32 gradients 2.0e-2 apart; the D step's 1.7e-4). So the D gradient is
held within 1e-3 and the G gradient within 3e-2 of JAX's in L2, and the
port's fp32 G gradient within 1e-2 of its own float64 one. Adam's first
update (lr * g / (|g| + eps) at ``LR``) holds within 1e-4 relative and 2.1
lr absolute of JAX's, and within 0.25 lr of lr * sign(g) where |g| is over
1% of the network's largest (g the JAX gradient in the D step, the
float64 one in the G step, where one such element of JAX's fp32 G
gradient has the other sign).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.trainers.vid2vid import Trainer as JaxTrainer
from imaginaire_tpu_torch import inference, train
from imaginaire_tpu_torch.bridge import load_flax_variables, to_port_layout
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.losses.flow import FlowLoss
from imaginaire_tpu_torch.trainers.vid2vid import Trainer
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
from imaginaire_tpu_torch.utils.meters import ScalarWriter
from test_torch_pose import (  # noqa: E402
    CFG,
    HW,
    TYPES,
    cheap_jit,
    draw,
    nchw,
    rendered_labels,
    write_pose_dataset,
)

LR = 1e-6
GRAD_TOL = {"D": 1e-3, "G": 3e-2}
GRAD_TOL_F64 = 1e-2
CUT = {"trainer": {"perceptual_loss": {"layers": ["relu_1_1"], "weights": [1.0]}},
       "gen_opt": {"lr": LR}, "dis_opt": {"lr": LR}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def step_pair():
    """The JAX trainer, the port's config, the first frame of a clip and
    numpy-drawn G, D and VGG19 variables."""
    jt = JaxTrainer(JaxConfig(CFG, overrides=copy.deepcopy(CUT)))
    label = rendered_labels()
    image = np.tanh(np.random.RandomState(8).randn(2, HW, HW, 3)).astype(np.float32)
    frame = {"label": jnp.asarray(label), "image": jnp.asarray(image)}
    key = jax.random.PRNGKey(0)
    stacks = [(jnp.zeros((2, 2, HW, HW, 3)),) * 2]
    variables = {
        "G": draw(jax.eval_shape(lambda: jt.net_G.init(
            {"params": key, "noise": key}, frame, training=True, init_all=True)), seed=1),
        "D": draw(jax.eval_shape(lambda: jt.net_D.init(
            {"params": key, "dropout": key}, frame, {"fake_images": frame["image"]},
            past_stacks=stacks, training=True)), seed=2),
        "VGG": draw(jax.eval_shape(lambda: jt.perceptual.module.init(
            key, jnp.zeros((1, HW, HW, 3)))), seed=3)["params"]}
    return jt, Config(CFG, overrides=copy.deepcopy(CUT)), (label, image), variables


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


def port_trainer(tcfg, variables):
    trainer = Trainer(tcfg, device="cpu", train=True)
    trainer.init_state(seed=0)
    load_flax_variables(trainer.net_G, variables["G"])
    load_flax_variables(trainer.net_D, variables["D"])
    load_flax_variables(trainer.perceptual.module, {"params": variables["VGG"]})
    return trainer


@pytest.mark.parametrize("kind", ["D", "G"])
def test_first_frame_step_with_region_ds_matches_jax(step_pair, kind):
    """One fp32 D step and one G step of the first frame: the losses with
    ``GAN_face`` and ``GAN_hand`` (and their feature matching in the G
    step) at the config's weights, every gradient, and the parameters
    after Adam's first step."""
    jt, tcfg, (label, image), variables = step_pair
    jd = {"label": jnp.asarray(label), "image": jnp.asarray(image)}
    losses, grads = cheap_jit(lambda v, dt: jax_step(jt, kind, v, dt), variables, jd)
    trainer = port_trainer(tcfg, variables)
    for name in ("face", "hand"):
        assert trainer.weights[f"GAN_{name}"] == jt.weights[f"GAN_{name}"] == 10.0
        assert trainer.weights[f"FeatureMatching_{name}"] == 10.0
    net, opt = ((trainer.net_D, trainer.opt_D) if kind == "D"
                else (trainer.net_G, trainer.opt_G))
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    td = {"label": nchw(label), "image": nchw(image)}
    forward = ((lambda: trainer.dis_forward(td)) if kind == "D"
               else (lambda: trainer.gen_forward(td)[0]))
    got = trainer._step(net, opt, forward, None, f"{kind}_step")
    regions = {"GAN_face", "GAN_hand"} | (
        {"FeatureMatching_face", "FeatureMatching_hand", "Perceptual"} if kind == "G"
        else {"D_real_acc"})
    assert regions <= set(losses) == set(got) - {"grad_norm"}
    for k, v in losses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=0, err_msg=k)
    want_g = to_port_layout(net, grads)
    got_g = {n: p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
             for n, p in net.named_parameters()}
    assert set(want_g) == set(got_g)
    assert any(n.startswith("net_D_hand.") for n in got_g) == (kind == "D")
    assert rel_l2(got_g, want_g) <= GRAD_TOL[kind]
    sign_ref = want_g  # the gradient whose sign a large element's update must follow
    if kind == "G":
        exact = port_trainer(tcfg, variables)
        for module in (exact.net_G, exact.net_D, exact.perceptual.module):
            module.double().train()
        for p in exact.net_G.parameters():
            p.requires_grad_(True)
        losses64, _ = exact.gen_forward({k: v.double() for k, v in td.items()})
        sum(exact.weights[k] * v for k, v in losses64.items() if k in exact.weights).backward()
        sign_ref = {n: p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape))
                    for n, p in exact.net_G.named_parameters()}
        assert rel_l2(got_g, sign_ref) <= GRAD_TOL_F64
    largest = max(np.abs(g).max() for g in sign_ref.values())
    for name, g in want_g.items():
        got_p = net.get_parameter(name).detach().numpy()
        np.testing.assert_allclose(got_p, before[name].numpy() - LR * g / (np.abs(g) + 1e-8),
                                   rtol=1e-4, atol=2.1 * LR, err_msg=name)
        ref = sign_ref[name]
        diff = np.abs(got_p - (before[name].numpy() - LR * np.sign(ref)))
        assert diff[np.abs(ref) > 1e-2 * largest].max(initial=0) <= 0.25 * LR, name


def rel_l2(got, want):
    """|got - want| / |want| over every leaf of a gradient."""
    diff = sum(float(((got[n] - w).astype(np.float64) ** 2).sum()) for n, w in want.items())
    return np.sqrt(diff / sum(float((w.astype(np.float64) ** 2).sum()) for w in want.values()))


def test_has_foreground_changes_nothing_on_the_openpose_path(step_pair):
    """``data.has_foreground`` (the dancing config sets it) reads a
    ``fg_mask`` that OpenPose data never carries and masks a raw output
    the vid2vid generator never makes: a warp frame's G losses and a D
    step's losses are the same with it on and off, and ``FlowLoss`` with
    the teacher's flow equals the one without the flag."""
    _, tcfg, (label, image), variables = step_pair
    results = []
    for has_fg in (False, True):
        cfg = copy.deepcopy(tcfg)
        cfg.data.has_foreground = has_fg
        trainer = port_trainer(cfg, variables)
        assert trainer.has_fg == has_fg
        prev = torch.tanh(torch.randn(2, 2, 3, HW, HW, generator=torch.Generator().manual_seed(9)))
        td = {"label": nchw(label), "image": nchw(image),
              "prev_labels": torch.stack([nchw(label)] * 2, 1), "prev_images": prev}
        with torch.no_grad():
            g_losses, out = trainer.gen_forward(td)
            d_losses = trainer.dis_forward(td)
        assert out.get("fake_raw_images") is None and "Flow" in g_losses
        flow = torch.randn(2, 2, HW, HW, generator=torch.Generator().manual_seed(10))
        teacher = FlowLoss(lambda a, b: (flow, torch.ones(2, 1, HW, HW)), has_fg=has_fg)
        flow_losses = teacher({"image": td["image"], "real_prev_image": prev[:, -1]}, out)
        results.append(({k: float(v) for k, v in {**g_losses, **{
            f"D_{k}": v for k, v in d_losses.items()}}.items()},
                        [float(v) for v in flow_losses]))
    assert results[0] == results[1]


def test_train_and_inference_entries_on_openpose_data(tmp_path):
    """``train.main`` (2 iterations of 3-frame clips at batch 1, the
    temporal and both region Ds) and ``inference.main`` over a folder
    dataset of PNG frames and OpenPose JSON: finite losses with
    ``GAN_face`` / ``GAN_hand`` and their feature matching, a checkpoint,
    and every frame of every test sequence written, in [-1, 1]."""
    root = write_pose_dataset(tmp_path / "data", sequences=2, frames=4, hw=(72, 80),
                              packed=False)
    cfg = yaml.safe_load(open(CFG))
    cfg["trainer"]["perceptual_loss"].update(layers=["relu_1_1"], weights=[1.0])
    cfg["data"]["input_types"] = copy.deepcopy(TYPES)
    for split in ("train", "val"):
        cfg["data"][split]["roots"] = [root]
    cfg["data"]["val"]["augmentations"] = {"resize_h_w": f"{HW}, {HW}"}
    cfg["test_data"] = {"name": "pose", "type": cfg["data"]["type"], "num_workers": 0,
                        "input_types": copy.deepcopy(TYPES),
                        "for_pose_dataset": dict(cfg["data"]["for_pose_dataset"]),
                        "input_image": ["images"], "input_labels": ["poses-openpose"],
                        "keypoint_data_types": ["poses-openpose"],
                        "test": copy.deepcopy(cfg["data"]["val"])}
    cfg.update(logging_iter=1, snapshot_save_iter=1000, image_save_iter=1000)
    cfg_path = tmp_path / "pose.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    logdir = tmp_path / "log"
    trainer = train.main(["--config", str(cfg_path), "--logdir", str(logdir),
                          "--device", "cpu", "--max_iter", "2"])
    assert (trainer.opt_G.count, trainer.opt_D.count) == (6, 6)
    scalars = {r["name"]: r["value"] for r in ScalarWriter(str(logdir)).read()
               if r["kind"] == "counter"}
    assert all(np.isfinite(v) for v in scalars.values())
    assert {f"{s}/GAN_{n}" for s in ("gen_update", "dis_update") for n in ("face", "hand")} \
        | {"gen_update/FeatureMatching_face", "gen_update/FeatureMatching_hand"} <= set(scalars)
    checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
    assert ckpt_lib.parse_checkpoint_name(checkpoint)[1] == 2
    out = tmp_path / "frames"
    inference.main(["--config", str(cfg_path), "--checkpoint", checkpoint,
                    "--output_dir", str(out), "--logdir", str(tmp_path / "inf"),
                    "--device", "cpu"])
    written = sorted(str(p.relative_to(out)) for p in out.rglob("*.png"))
    assert written == [f"seq{s:04d}/{t:04d}.png" for s in range(2) for t in range(4)]
    assert os.path.getsize(out / written[0]) > 0
