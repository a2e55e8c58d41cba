"""fs-vid2vid YouTubeDancing's networks, steps and finetune in the port
against the JAX package on the CPU, and its training and inference
entries: the fs generator on DensePose + OpenPose labels, the few-shot
discriminator with its face D and the reference frame's crop, one
first-frame D and G step, a 2-iteration finetune, and ``train.main`` /
``inference.main`` (resume and finetune included).

The config is ``configs/projects/fs_vid2vid/YouTubeDancing/bf16.yaml``
cut to tiny widths (``TINY``: 4 to 16 filters, 2 downsamples, the face D
2 layers) at a 64x32 output, in fp32, with no FlowNet2 teacher (none runs
in the fs G step), VGG19 up to relu_1_1 and lr 1e-6. The labels are the pose
dataset's: items of ``chip_smoke.py``'s seeded YouTubeDancing folders
(``test_torch_pose_fewshot.py``'s) through the DensePose preprocessing,
their face parts inside the crop. Variables are drawn with numpy into
``jax.eval_shape`` trees and bridged into the port.

Tolerances:
- the generator 1e-4 (flows in head units; each warp against the JAX
  warp of the port's own flow), as ``tests/test_torch_fs_vid2vid.py``;
  the discriminator's outputs and features 1e-5, its face boxes exact;
- the step: losses rtol 1e-4; gradients in L2 against JAX's
  (``GRAD_TOL``); the port's fp32 G gradient against its own float64 one
  (``GRAD_TOL_F64``); Adam's first update within 1e-4 relative and 2.1 lr
  of JAX's, and within 0.25 lr of lr * sign(g) where |g| is over 1% of
  the network's largest (g the JAX gradient in the D step, the port's
  float64 one in the G step). The numbers behind ``GRAD_TOL`` were
  measured against the port's float64 step at the same weights: see
  ``test_first_frame_step_matches_jax``. They are no looser than the
  vid2vid pose step's (``tests/test_torch_pose_training.py``);
- the finetune (2 iterations): each weight's move within 0.25 lr of
  JAX's (the fp32 rounding of the parameters), a bias's within 5.1 lr
  (the conv biases before instance norms have a true gradient of 0, so
  their rounding noise may take either sign at each step: Adam moves
  such an element by up to lr, then sqrt(1 + b2) lr; measured, the
  weights' moves agree within 0.004 lr and 0.3% of G's elements, all in
  biases, differ by over 0.5 lr); the frozen parameters bit for bit; the
  spectral-norm vectors and BatchNorm statistics (which the finetune
  advances in every layer, frozen or not, in both packages) 1e-5.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.model_utils import fs_vid2vid as jfs
from imaginaire_tpu.models.discriminators.fs_vid2vid import Discriminator as JaxDis
from imaginaire_tpu.models.generators.fs_vid2vid import Generator as JaxGenerator
from imaginaire_tpu.trainers.fs_vid2vid import Trainer as JaxTrainer
from imaginaire_tpu_torch.bridge import flax_path, load_flax_variables, to_port_layout
from imaginaire_tpu_torch.config import Config, recursive_update
from imaginaire_tpu_torch.data.paired_few_shot_videos import Dataset
from imaginaire_tpu_torch.model_utils import fs_vid2vid as tfs
from imaginaire_tpu_torch.models.discriminators.fs_vid2vid import Discriminator
from imaginaire_tpu_torch.models.generators.fs_vid2vid import Generator
from imaginaire_tpu_torch.trainers.fs_vid2vid import Trainer
from test_torch_fs_vid2vid import CHEAP, FLOW_HEAD_SCALE, cheap_jit, draw, to_nhwc, to_torch
from test_torch_pose_fewshot import DATA, FRAMES, LR, RAW_HW, SEQUENCES, TINY

CFG = "configs/projects/fs_vid2vid/YouTubeDancing/bf16.yaml"
HW = (64, 32)
FLOW_MULTIPLIER = 20  # gen.flow.flow_output_multiplier of the config
GRAD_TOL = {"D": 1e-4, "G": 1e-4}
GRAD_TOL_F64 = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def no_jax_mesh():
    """The JAX package's steps run here with no process mesh, whatever
    mesh an earlier test of the process left configured: the trainer's
    placement and the hyper convs read it, and the step programs are
    compiled once for the step tests' inputs and reused by the finetune."""
    from imaginaire_tpu.parallel import mesh

    before = mesh.peek_mesh()
    mesh.set_mesh(None)
    yield
    mesh.set_mesh(before)


def configs(*extra):
    overrides = copy.deepcopy(TINY)
    for part in extra:
        recursive_update(overrides, copy.deepcopy(part))
    return JaxConfig(CFG, overrides=copy.deepcopy(overrides)), \
        Config(CFG, overrides=copy.deepcopy(overrides))


@pytest.fixture(scope="module")
def ytd(tmp_path_factory):
    """The seeded dataset (as ``test_torch_pose_fewshot.py``'s) and a
    batch of two frames of it: preprocessed 6-channel labels with face
    parts, frames, references and the previous frames' labels."""
    tmp = tmp_path_factory.mktemp("ytd")
    root = chip_smoke.write_youtube_dataset(tmp / "data", sequences=SEQUENCES, frames=FRAMES,
                                            hw=RAW_HW)
    path = chip_smoke.youtube_entry_config(tmp, root, DATA)
    ds = Dataset(Config(str(path)), is_inference=True)
    items = []
    for seq in (1, 2):
        ds.set_inference_sequence_idx(seq, 0, 0)
        items.append([ds[0], ds[1]])

    def stack(key, t):
        return np.stack([it[t][key][0] for it in items])

    pre = lambda x: tfs.pre_process_densepose({}, x, is_infer=True)  # noqa: E731
    rng = np.random.RandomState(4)
    batch = {"label": pre(stack("label", 1)), "image": stack("images", 1),
             "ref_labels": pre(stack("ref_labels", 1))[:, None],
             "ref_images": stack("ref_images", 1)[:, None],
             "prev_labels": pre(stack("label", 0))[:, None],
             "prev_images": np.tanh(rng.randn(2, 1, *HW, 3)).astype(np.float32)}
    assert batch["label"].shape == (2,) + HW + (6,)
    assert (batch["label"][..., 2] > 0.9).any()  # the face parts D's face box looks for
    return root, batch


def frame(batch, t):
    keys = ("label", "image", "ref_labels", "ref_images") + (
        ("prev_labels", "prev_images") if t else ())
    return {k: batch[k] for k in keys}


def generator_vars(jnet, d, seed):
    key = jax.random.PRNGKey(0)
    g = {k: jnp.asarray(v) for k, v in d.items() if k != "image"}
    variables = draw(jax.eval_shape(lambda: jnet.init({"params": key, "noise": key}, g,
                                                      training=True, init_all=True)), seed)
    for name, net in variables["params"].items():
        if name.startswith("flow_network"):
            net["conv_flow"]["conv"] = {k: v * FLOW_HEAD_SCALE
                                        for k, v in net["conv_flow"]["conv"].items()}
    return variables


# ----------------------------------------------------------- networks


@pytest.fixture(scope="module")
def gen_pair(ytd):
    jcfg, tcfg = configs()
    jnet = JaxGenerator(jcfg.gen, jcfg.data)
    return jnet, generator_vars(jnet, frame(ytd[1], 1), seed=2), tcfg


@pytest.mark.parametrize("t", [0, 1])
def test_pose_generator_matches_jax(ytd, gen_pair, t):
    """The fs generator on pose labels (DensePose + OpenPose, the face
    parts of the frame's and the previous labels at -1, the reference's
    kept): the first frame (the reference warp) and a frame with its
    previous frame (both warps); G owns exactly the JAX tree's
    parameters, its label input 6 channels wide."""
    jnet, variables, tcfg = gen_pair
    d = {k: v for k, v in frame(ytd[1], t).items() if k != "image"}
    want = cheap_jit(lambda v, dd: jnet.apply(v, dd, training=False), variables,
                     {k: jnp.asarray(v) for k, v in d.items()})
    net = load_flax_variables(Generator(tcfg.gen, tcfg.data), variables).eval()
    assert net.num_input_channels == 6 and net.remove_face_labels
    with torch.no_grad():
        got = net({k: to_torch(v) for k, v in d.items()})
    np.testing.assert_allclose(to_nhwc(got["fake_images"]), np.asarray(want["fake_images"]),
                               atol=1e-4, rtol=0)
    for key in ("fake_flow_maps", "fake_occlusion_masks", "warped_images"):
        for j, (a, b) in enumerate(zip(got[key], want[key])):
            assert (a is None) == (b is None) == (j == 1 and not t), (key, j)
            if b is None:
                continue
            if key == "warped_images":
                src = d["ref_images"][:, 0] if j == 0 else d["prev_images"][:, -1]
                b = jfs.resample(jnp.asarray(src), jnp.asarray(to_nhwc(got["fake_flow_maps"][j])))
            scale = FLOW_MULTIPLIER if key == "fake_flow_maps" else 1
            np.testing.assert_allclose(to_nhwc(a) / scale, np.asarray(b) / scale, atol=1e-4,
                                       rtol=0, err_msg=f"{key}[{j}]")


def test_fewshot_discriminator_with_face_crop_matches_jax(ytd):
    """The few-shot D with its face D: the image D's condition holds the
    reference label and image, the face D sees the face crop (DensePose's
    face parts, channel 2 above 0.9) of the real or fake frame beside the
    reference image's crop at the same box (6 channels); outputs and
    features of every scale."""
    jcfg, tcfg = configs()
    batch = ytd[1]
    d = {k: jnp.asarray(v) for k, v in frame(batch, 0).items()}
    fake = np.tanh(np.random.RandomState(6).randn(*batch["image"].shape)).astype(np.float32)
    jnet = JaxDis(jcfg.dis, jcfg.data)
    key = jax.random.PRNGKey(0)
    variables = draw(jax.eval_shape(lambda: jnet.init(
        {"params": key, "dropout": key}, d, {"fake_images": jnp.asarray(fake)},
        past_stacks=[], training=True)), seed=7)
    want = cheap_jit(lambda v, dd, f: jnet.apply(v, dd, {"fake_images": f}, past_stacks=[],
                                                 training=False),
                     variables, d, jnp.asarray(fake))
    net = load_flax_variables(Discriminator(tcfg.dis, tcfg.data), variables).eval()
    assert net.net_D_face.d_0.layer0.conv.weight.shape[1] == 6
    with torch.no_grad():
        got = net({k: to_torch(v) for k, v in d.items()}, {"fake_images": to_torch(fake)})
    assert set(got) == set(want) == {"indv", "face"}
    for name in ("indv", "face"):
        for side in ("pred_real", "pred_fake"):
            for a, b in zip(got[name][side]["outputs"], want[name][side]["outputs"]):
                np.testing.assert_allclose(to_nhwc(a), np.asarray(b), atol=1e-5, rtol=0)
            for fa, fb in zip(got[name][side]["features"], want[name][side]["features"]):
                for a, b in zip(fa, fb):
                    np.testing.assert_allclose(to_nhwc(a), np.asarray(b), atol=1e-5, rtol=0)
    boxes = tfs.get_face_bbox_for_output(tcfg.data, to_torch(batch["label"]))
    np.testing.assert_array_equal(
        boxes.numpy(), np.asarray(jfs.get_face_bbox_for_output(jcfg.data, d["label"])))
    assert not tfs._use_openpose(tcfg.data)


# -------------------------------------------------------------- steps


FRAME_KEYS = ("label", "image", "ref_labels", "ref_images")
_PROGRAMS = {}


def jax_step(jt, kind, variables, data_t):
    """(losses, gradients, new mutable state, G's frame) of the JAX
    trainer's D or G step on one frame."""
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
        fake = res[2]["fake_images"] if kind == "G" else None
        return total, (dict(losses, total=total), res[1], fake)

    (_, (losses, new_mut, fake)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(state[net]["params"])
    return losses, grads, new_mut, fake


def step_program(jt, kind, variables, data_t):
    """``jax_step`` compiled once a kind with ``CHEAP``'s options, shared
    by the step and finetune tests (the same trainer and shapes)."""
    if kind not in _PROGRAMS:
        _PROGRAMS[kind] = jax.jit(lambda v, dt: jax_step(jt, kind, v, dt)).lower(
            variables, data_t).compile(compiler_options=CHEAP)
    return _PROGRAMS[kind](variables, data_t)


@pytest.fixture(scope="module")
def step_pair(ytd, gen_pair):
    """The JAX trainer, the port's config and the G, D and VGG19
    variables (G's the generator test's)."""
    jcfg, tcfg = configs()
    jt = JaxTrainer(jcfg)
    d = {k: jnp.asarray(v) for k, v in frame(ytd[1], 0).items()}
    key = jax.random.PRNGKey(0)
    variables = {
        "G": gen_pair[1],
        "D": draw(jax.eval_shape(lambda: jt.net_D.init(
            {"params": key, "dropout": key}, d, {"fake_images": d["image"]},
            past_stacks=[], training=True)), seed=3),
        "VGG": draw(jax.eval_shape(lambda: jt.perceptual.module.init(
            key, jnp.zeros((1,) + HW + (3,)))), seed=4)["params"]}
    return jt, tcfg, variables


def port_trainer(tcfg, variables, seed=0):
    trainer = Trainer(tcfg, device="cpu", train=True)
    trainer.init_state(seed=seed)
    load_flax_variables(trainer.net_G, variables["G"])
    load_flax_variables(trainer.net_D, variables["D"])
    load_flax_variables(trainer.perceptual.module, {"params": variables["VGG"]})
    return trainer


def rel_l2(got, want):
    """|got - want| / |want| over every leaf of a gradient."""
    diff = sum(float(((got[n] - w).astype(np.float64) ** 2).sum()) for n, w in want.items())
    return np.sqrt(diff / sum(float((w.astype(np.float64) ** 2).sum()) for w in want.values()))


@pytest.mark.parametrize("kind", ["D", "G"])
def test_first_frame_step_matches_jax(ytd, step_pair, kind):
    """One fp32 D step and one G step of a first frame on pose labels: the
    losses with ``GAN_face`` (and its feature matching in the G step) at
    the config's weights, the gradients, and the parameters after Adam's
    first step. Measured against the port's float64 step at the same
    weights, the fp32 gradients in L2: D step port 2.3e-5, JAX 2.1e-5
    (port to JAX 5.2e-6); G step port 3.9e-6, JAX 1.3e-5 (port to JAX
    1.3e-5). Leaf by leaf the conv biases before instance norms, whose
    true gradient is 0, hold only rounding noise (up to 11x their own max
    from float64), so the gradients are held as a whole: within 1e-4 of
    JAX's and of the port's float64 one in L2 (``GRAD_TOL``,
    ``GRAD_TOL_F64``), 5-8x the measured spread."""
    jt, tcfg, variables = step_pair
    d = frame(ytd[1], 0)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    losses, grads, _, _ = step_program(jt, kind, variables, jd)
    trainer = port_trainer(tcfg, variables)
    assert trainer.weights["GAN_face"] == jt.weights["GAN_face"] == 10.0
    net, opt = ((trainer.net_D, trainer.opt_D) if kind == "D"
                else (trainer.net_G, trainer.opt_G))
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    td = {k: to_torch(v) for k, v in d.items()}
    forward = ((lambda: trainer.dis_forward(td)) if kind == "D"
               else (lambda: trainer.gen_forward(td)[0]))
    got = trainer._step(net, opt, forward, None, f"{kind}_step")
    regions = {"GAN_face"} | ({"FeatureMatching_face", "Perceptual", "Flow"} if kind == "G"
                              else {"D_real_acc"})
    assert regions <= set(losses) == set(got) - {"grad_norm"}
    for k, v in losses.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=0, err_msg=k)
    want_g = to_port_layout(net, grads)
    got_g = {n: p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape), np.float32)
             for n, p in net.named_parameters()}
    assert set(want_g) == set(got_g)
    assert any(n.startswith("net_D_face.") and np.abs(g).max() > 0
               for n, g in got_g.items()) == (kind == "D")
    assert rel_l2(got_g, want_g) <= GRAD_TOL[kind]
    exact = port_trainer(tcfg, variables)
    for module in (exact.net_G, exact.net_D, exact.perceptual.module):
        module.double().train()
    exact_net = exact.net_D if kind == "D" else exact.net_G
    exact_net.requires_grad_(True)  # float64: the reference of GRAD_TOL_F64
    td64 = {k: v.double() for k, v in td.items()}
    if kind == "D":
        losses64 = exact.dis_forward(td64)
    else:
        losses64, _ = exact.gen_forward(td64)
    sum(exact.weights[k] * v for k, v in losses64.items() if k in exact.weights).backward()
    g64 = {n: p.grad.numpy() if p.grad is not None else np.zeros(tuple(p.shape))
           for n, p in exact_net.named_parameters()}
    assert rel_l2(got_g, g64) <= GRAD_TOL_F64
    sign_ref = want_g if kind == "D" else g64
    largest = max(np.abs(g).max() for g in sign_ref.values())
    for name, g in want_g.items():
        got_p = net.get_parameter(name).detach().numpy()
        np.testing.assert_allclose(got_p, before[name].numpy() - LR * g / (np.abs(g) + 1e-8),
                                   rtol=1e-4, atol=2.1 * LR, err_msg=name)
        ref = sign_ref[name]
        diff = np.abs(got_p - (before[name].numpy() - LR * np.sign(ref)))
        assert diff[np.abs(ref) > 1e-2 * largest].max(initial=0) <= 0.25 * LR, name


# ------------------------------------------------------------ finetune


class FrameStep:
    """The JAX trainer's D or G step program of a frame
    (``_vid_dis_step_fn`` / ``_vid_gen_step_fn`` on fp32, finite steps):
    the compiled ``jax_step`` of the step test, then the trainer's own
    optimizer (``tx_D`` / ``tx_G``, which the finetune replaces) applied
    and the new mutable state kept, as there."""

    def __init__(self, jt, kind):
        self.jt, self.kind, self.update = jt, kind, None

    def retrace(self, reason=""):
        """The finetune replaced the optimizer: compile its update anew."""
        self.update = None

    def __call__(self, state, data_t):
        jt, kind = self.jt, self.kind
        variables = {"G": state["vars_G"], "D": state["vars_D"],
                     "VGG": state["loss_params"]["perceptual"]}
        losses, grads, new_mut, fake = step_program(
            jt, kind, variables, {k: data_t[k] for k in FRAME_KEYS})
        net, opt, tx = (("vars_D", "opt_D", jt.tx_D) if kind == "D"
                        else ("vars_G", "opt_G", jt.tx_G))

        def update(g, o, p):
            updates, new_o = tx.update(g, o, p)
            return optax.apply_updates(p, updates), new_o

        args = (grads, state[opt], state[net]["params"])
        if self.update is None:
            self.update = jax.jit(update).lower(*args).compile(compiler_options=CHEAP)
        params, new_opt = self.update(*args)
        state = dict(state, **{net: dict(state[net], params=params, **new_mut), opt: new_opt})
        return (state, losses, None) if kind == "D" else (state, losses, fake, None)


def test_finetune_matches_jax(ytd, step_pair):
    """A 2-iteration finetune from the same weights and draws (the JAX
    finetune draws from ``np.random``, the port's from a ``RandomState``
    of the run's seed): the parameters under ``weight_generator``,
    ``conv_img`` and ``up`` (any segment of the JAX path, read through
    ``bridge.flax_path``) move as JAX's do, the others stay bit for bit in
    both packages, D moves as JAX's, and the spectral-norm vectors and
    BatchNorm statistics advance in every layer as JAX's."""
    jt, tcfg, variables = step_pair
    b, seed, iters = ytd[1], 5, 2
    data = {"label": b["label"][:, None], "images": b["image"][:, None],
            "ref_labels": b["ref_labels"], "ref_images": b["ref_images"]}
    key = jax.random.PRNGKey(0)
    jt.state = {"vars_G": variables["G"], "vars_D": variables["D"],
                "loss_params": {"perceptual": variables["VGG"]},
                "step": jnp.zeros((), jnp.int32), "step_D": jnp.zeros((), jnp.int32),
                "rng_G": key, "rng_D": key, "opt_G": None, "opt_D": None}
    jt._jit_vid_dis, jt._jit_vid_gen = FrameStep(jt, "D"), FrameStep(jt, "G")
    jt.diag.observe = lambda *a, **k: None  # the steps report no health summary
    np.random.seed(seed)
    jt.finetune({k: jnp.asarray(v) for k, v in data.items()}, {"finetune_iter": iters})
    trainer = port_trainer(tcfg, variables, seed=seed)
    g0 = {n: p.detach().clone() for n, p in trainer.net_G.named_parameters()}
    d0 = {n: p.detach().clone() for n, p in trainer.net_D.named_parameters()}
    trainer.finetune({k: to_torch(v) for k, v in data.items()}, {"finetune_iter": iters})
    assert trainer.opt_G.count == trainer.opt_D.count == iters
    mask = trainer.finetune_mask()
    assert {n.split(".")[0] for n, m in mask.items() if m} == {
        "weight_generator", "conv_img", "ref_image_embedding", "flow_network_ref"} | {
        f"up_{i}" for i in range(3)}
    # an 'up' segment inside another module trains too, as the JAX mask reads it
    assert mask["ref_image_embedding.up_0.conv.weight"]
    assert not mask["flow_network_ref.down_in.conv.weight"]
    assert flax_path("up_0.conv_0.conv.weight") == ("up_0", "conv_0", "conv", "kernel")
    for net, before, tree in ((trainer.net_G, g0, jt.state["vars_G"]),
                              (trainer.net_D, d0, jt.state["vars_D"])):
        want = to_port_layout(net, tree["params"])
        start = to_port_layout(net, (variables["G"] if net is trainer.net_G
                                     else variables["D"])["params"])
        for name, p in net.named_parameters():
            got = p.detach().numpy()
            if net is trainer.net_G and not mask[name]:
                np.testing.assert_array_equal(got, before[name].numpy(), err_msg=name)
                np.testing.assert_array_equal(want[name], start[name], err_msg=name)
                continue
            # a conv bias before an instance norm has a true gradient of 0:
            # its rounding noise can take either sign at each step, where
            # Adam moves it by up to lr, then sqrt(1 + b2) lr
            atol = (2 * (1 + np.sqrt(1.999)) + 0.25 if name.endswith(".bias") else 0.25) * LR
            np.testing.assert_allclose(got - before[name].numpy(), want[name] - start[name],
                                       atol=atol, rtol=0, err_msg=name)
        assert any(np.abs(want[n] - start[n]).max() > 0 for n in want)
        for collection in ("spectral", "batch_stats"):
            if collection in tree:
                state = to_port_layout(net, tree[collection])
                buffers = dict(net.named_buffers())
                for name, value in state.items():
                    np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5,
                                               rtol=0, err_msg=name)


def test_spade_norms_have_a_batchnorm_base(ytd, gen_pair, monkeypatch):
    """The config's comment says its SPADE epilogue fuses through the
    modulation op (``base_norm: instance``), but its
    ``activation_norm_params`` names no ``activation_norm_type``, so both
    packages give the up blocks' SPADE norms a ``sync_batch`` (BatchNorm)
    base and a G forward calls the modulation op 0 times (ROADMAP.md,
    section C)."""
    jnet, variables, tcfg = gen_pair
    assert "activation_norm_type" not in tcfg.gen.activation_norm_params
    assert tcfg.gen.activation_norm_params.base_norm == "instance"
    assert set(variables["batch_stats"]["up_0"]["conv_0"]["norm"]["BatchNorm_0"]
               ["BatchNorm_0"]) == {"mean", "var"}
    from imaginaire_tpu_torch.layers import activation_norm

    net = load_flax_variables(Generator(tcfg.gen, tcfg.data), variables).eval()
    spade = [m for m in net.modules() if isinstance(m, activation_norm.SpatiallyAdaptiveNorm)]
    assert spade and {m.base_norm for m in spade} == {"sync_batch"}
    calls = []
    monkeypatch.setattr(activation_norm, "spade_modulation",
                        lambda *a: calls.append(1) or 1 / 0)
    with torch.no_grad():
        out = net({k: to_torch(v) for k, v in frame(ytd[1], 1).items() if k != "image"})
    assert calls == [] and out["fake_images"].shape == (2, 3) + HW
