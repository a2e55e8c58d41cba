"""The port's vid2vid training against the JAX package's, piece by piece
and as one rollout iteration, and its training entry on the CPU.

The config is ``configs/unit_test/vid2vid_street.yaml`` (it has the flow
branch, multi-SPADE combine and a temporal discriminator scale) cut
further, at 32x32 and batch 2: a 3-layer generator whose embedders,
flow network and multi-SPADE combine go one level deep, a one-scale
one-layer image and temporal discriminator, and VGG19 up to relu_1_1.
XLA's compile time on the CPU grows with the program, and every JAX
step here is one compiled program. The JAX variable shapes come from
``jax.eval_shape``; leaves are drawn with numpy from a seed and bridged
into the port. The vid2vid generator draws no noise in training (it
starts from the label map, ``use_segmap_as_input``), and the
discriminators have no dropout, so no random draw is injected.

Tolerances:
- resample2d's backward (in ``test_torch_resample2d.py``);
- the flow losses: rtol 1e-5; ``skip_stride_span`` / ``_past_stacks``
  exact;
- the discriminator's outputs and features with and without past stacks:
  atol 1e-4;
- the generator's training forward (BatchNorm batch statistics, the
  spectral-norm power step): outputs atol 1e-5 (flows in head units; a
  warp frame's image 1e-4), running statistics and ``u`` after it atol
  1e-5;
- one rollout iteration under the fp32 policy, sequence length 3 (a
  first frame, a continuation frame and a warp frame with the temporal
  scale active), against the JAX sequential rollout (each frame's D step
  then G step, the next frame's history from that G step's output): each
  frame's D and G losses rtol 1e-4; every grad leaf within 1e-3 of its
  max |g| (``ZERO_GRAD_FLOOR`` and ``SMALL_LEAF_SHARE`` below); ``u`` and
  the BatchNorm statistics after each step atol 1e-5; the parameters
  after the rollout within 3 Adam sign flips. The learning rate is cut
  to ``ROLLOUT_LR``. One case a step, each compiling that step's JAX
  program;
- the bf16 policy: one warp frame's G losses within 2e-2 relative (the
  JAX warp computes its coordinates in bf16, ``resample2d.py:39-41``,
  where the port keeps fp32: ROADMAP.md, section C; at 32x32 that moves
  no loss past the tolerance).
"""

import json
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.losses import flow as jflow
from imaginaire_tpu.model_utils import fs_vid2vid as jfs
from imaginaire_tpu.trainers.vid2vid import Trainer as JaxTrainer
from imaginaire_tpu_torch import train
from imaginaire_tpu_torch.bridge import load_adam_state, load_flax_variables, to_port_layout
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.png import decode_png, write_png
from imaginaire_tpu_torch.layers.state import state_buffers, state_updates
from imaginaire_tpu_torch.losses import flow as tflow
from imaginaire_tpu_torch.model_utils import fs_vid2vid as tfs
from imaginaire_tpu_torch.models.discriminators.fs_vid2vid import Discriminator
from imaginaire_tpu_torch.ops import resample2d as rs
from imaginaire_tpu_torch.trainers.vid2vid import Trainer
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
from imaginaire_tpu_torch.utils.meters import ScalarWriter

CFG = "configs/unit_test/vid2vid_street.yaml"
HW, LABELS, B, T = 32, 12, 2, 3
FLOW_MULTIPLIER = 40  # gen.flow.flow_output_multiplier of the config
CUT = dict(
    trainer=dict(perceptual_loss=dict(layers=["relu_1_1"], weights=[1.0])),
    gen=dict(num_layers=3, num_downsamples_img=1, embed=dict(num_downsamples=1),
             flow=dict(num_downsamples=1, num_res_blocks=1,
                       multi_spade_combine=dict(num_layers=1,
                                                embed=dict(num_downsamples=1)))),
    dis=dict(image=dict(num_discriminators=1, num_layers=1),
             temporal=dict(num_layers=1)),
    data=dict(val=dict(augmentations=dict(resize_h_w="32, 32"))))
# the rollout's learning rate: Adam's first update is lr * g / |g| for
# every element, whatever beta1, so an element whose gradient is near 0
# moves by +-lr in one package and -+lr in the other; at the config's
# lr (1e-4 / 4e-4) that moves the next frames' losses by ~1e-4
ROLLOUT_LR = 1e-6
ROLLOUT_CFG = dict(CUT, gen_opt=dict(lr=ROLLOUT_LR), dis_opt=dict(lr=ROLLOUT_LR))
ZERO_GRAD_FLOOR = 1e-6  # see tests/test_torch_spade_training.py
# a leaf whose gradient is under 1% of the network's largest takes its
# rounding from the same sums as the large ones (BatchNorm's batch
# statistics in the backward): measured with identical inputs and state,
# the continuation frame's G step differs by 1.08e-3 of the max of a leaf
# at 1% of the largest (down_0.conv_s.norm.beta_0.conv.weight); such a
# leaf is held to 1e-3 of 1% of the largest leaf's max
SMALL_LEAF_SHARE = 1e-2
# the frames each package generates and feeds back (fp32, 1e-4 as the
# whole generator's eval test); a step that reads them is held to 2e-3
# of each leaf's max (measured worst: 1.04e-3, frame 2's G step,
# down_0.conv_0.norm.gamma_0.conv.bias, with the JAX history 1e-3)
HISTORY_TOL = 1e-4
# the flow network's leaves in the warp frame's G step: their gradient
# comes through the warp's backward, which reads the previous frame's
# slope at the sample points; the flows agree to 1e-5 head units (4e-4
# pixels) and a random frame's slope is ~1 a pixel (measured worst:
# 4.0e-3 of a leaf's max, flow_network_temp.down_lbl_0.conv.weight)
WARP_FLOW_TOL = 1e-2
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cheap_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=CHEAP)(*args)


def draw(shapes, seed=0):
    """Numpy values for a flax variable tree: kernels at 1/sqrt(fan_in),
    unit ``u`` vectors, positive running variances, and biases, norm
    scales and running means within 0.1 of their initial values (large
    biases make BatchNorm's E[x^2] - E[x]^2 variance a difference of
    nearly equal numbers, whose rounding both packages then amplify)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "u":
            u = rng.standard_normal(leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def to_torch(a, dtype=torch.float32):
    """NHWC (or N, T, H, W, C) numpy -> NCHW (N, T, C, H, W) torch."""
    a = np.asarray(a, np.float32)
    perm = (0, 3, 1, 2) if a.ndim == 4 else (0, 1, 4, 2, 3)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(perm))).to(dtype)


def to_nhwc(t):
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t.permute(0, 1, 3, 4, 2)).numpy()


def clip(seed):
    rng = np.random.RandomState(seed)
    label = np.eye(LABELS, dtype=np.float32)[rng.randint(0, LABELS, (B, T, HW, HW))]
    images = np.tanh(rng.randn(B, T, HW, HW, 3)).astype(np.float32)
    return label, images


@pytest.fixture(scope="module")
def pair():
    """The JAX trainer and the port's (fp32 policy) on the cut config,
    with numpy-drawn G, D and VGG19 variables bridged into the port."""
    jt = JaxTrainer(JaxConfig(CFG, overrides=ROLLOUT_CFG))
    label, images = clip(0)
    data = {"label": jnp.asarray(label), "images": jnp.asarray(images)}
    d0 = jt._frame0(data)
    key = jax.random.PRNGKey(0)
    stacks = [(jnp.zeros((B, 2, HW, HW, 3)),) * 2]
    variables = {
        "G": draw(jax.eval_shape(lambda: jt.net_G.init(
            {"params": key, "noise": key}, d0, training=True, init_all=True)), seed=1),
        "D": draw(jax.eval_shape(lambda: jt.net_D.init(
            {"params": key, "dropout": key}, d0,
            {"fake_images": d0["image"], "fake_raw_images": d0["image"]},
            past_stacks=stacks, training=True)), seed=2),
        "VGG": draw(jax.eval_shape(lambda: jt.perceptual.module.init(
            key, jnp.zeros((1, HW, HW, 3)))), seed=3)["params"]}
    return SimpleNamespace(jt=jt, data=data, label=label, images=images,
                           vars=variables)


def port_trainer(variables, overrides=CUT):
    trainer = Trainer(Config(CFG, overrides=overrides), device="cpu", train=True)
    trainer.init_state(seed=0)
    load_flax_variables(trainer.net_G, variables["G"])
    load_flax_variables(trainer.net_D, variables["D"])
    load_flax_variables(trainer.perceptual.module, {"params": variables["VGG"]})
    return trainer


def history(seed, n):
    rng = np.random.RandomState(seed)
    prev_labels = np.eye(LABELS, dtype=np.float32)[rng.randint(0, LABELS, (B, n, HW, HW))]
    prev_images = np.tanh(rng.randn(B, n, HW, HW, 3)).astype(np.float32)
    return prev_labels, prev_images


# ------------------------------------------------------------ losses


def test_masked_l1_and_flow_loss_branches_match_jax():
    """masked_l1_loss (plain and normalized over the valid mask) and the
    three sources of FlowLoss's ground truth: a cached flow_gt/conf_gt, an
    injected flow network (a stub, the same function on both sides), and
    none (the warp and mask terms alone)."""
    rng = np.random.RandomState(1)
    img, prev = (np.tanh(rng.randn(2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    out = {"fake_images": np.tanh(rng.randn(2, 8, 8, 3)).astype(np.float32),
           "warped_images": np.tanh(rng.randn(2, 8, 8, 3)).astype(np.float32),
           "fake_flow_maps": rng.randn(2, 8, 8, 2).astype(np.float32) * 3,
           "fake_occlusion_masks": rng.uniform(0, 1, (2, 8, 8, 1)).astype(np.float32)}
    gt = {"flow_gt": rng.randn(2, 8, 8, 2).astype(np.float32),
          "conf_gt": (rng.uniform(0, 1, (2, 8, 8, 1)) > 0.3).astype(np.float32)}

    def jstub(a, b):
        d = a - b
        return d[..., :2] * 5.0, jax.nn.sigmoid(d.sum(-1, keepdims=True))

    def tstub(a, b):
        d = a - b
        return d[:, :2] * 5.0, torch.sigmoid(d.sum(1, keepdim=True))

    jout = {k: jnp.asarray(v) for k, v in out.items()}
    tout = {k: to_torch(v) for k, v in out.items()}
    cases = [
        (jflow.FlowLoss(None), tflow.FlowLoss(None),
         dict(image=img, **gt)),
        (jflow.FlowLoss(jstub), tflow.FlowLoss(tstub),
         dict(image=img, real_prev_image=prev)),
        (jflow.FlowLoss(None), tflow.FlowLoss(None), dict(image=img)),
    ]
    for jl, tl, d in cases:
        want = jl({k: jnp.asarray(v) for k, v in d.items()}, jout)
        got = tl({k: to_torch(v) for k, v in d.items()}, tout)
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=0)
    assert float(got[0]) == float(got[1]) == 0.0  # no ground truth: mask term alone
    x, tgt = out["fake_images"], img
    mask = out["fake_occlusion_masks"]
    for normalize in (False, True):
        want = jflow.masked_l1_loss(jnp.asarray(x), jnp.asarray(tgt), jnp.asarray(mask),
                                    normalize_over_valid=normalize)
        got = tflow.masked_l1_loss(to_torch(x), to_torch(tgt), to_torch(mask),
                                   normalize_over_valid=normalize)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=0)


def test_skip_stride_span_and_past_stacks_match_jax():
    """Strided past stacks of two temporal scales (tD = 3: strides 1 and
    3, spans 2 and 6) for every ring length up to the ring's size."""
    for tD, s in [(3, 0), (3, 1), (3, 2), (2, 3)]:
        assert tfs.skip_stride_span(tD, s) == jfs.skip_stride_span(tD, s)
    rng = np.random.RandomState(2)
    jt = SimpleNamespace(num_temporal_scales=2, num_frames_D=3)
    for length in range(1, 7):
        real, fake = (rng.randn(2, length, 4, 4, 3).astype(np.float32) for _ in range(2))
        want = JaxTrainer._past_stacks(jt, jnp.asarray(real), jnp.asarray(fake))
        got = Trainer._past_stacks(jt, to_torch(real), to_torch(fake))
        assert set(got) == set(want)
        for key, (wr, wf) in want.items():
            np.testing.assert_array_equal(to_nhwc(got[key][0]), np.asarray(wr))
            np.testing.assert_array_equal(to_nhwc(got[key][1]), np.asarray(wf))
    assert Trainer._past_stacks(jt, None, None) == {}


# ---------------------------------------------------- discriminator


@pytest.mark.parametrize("with_stacks", [False, True])
def test_discriminator_matches_jax(pair, with_stacks):
    """The image D and, given past stacks, the temporal scale: outputs and
    features of the real and fake passes."""
    p = pair
    rng = np.random.RandomState(3)
    fake = np.tanh(rng.randn(B, HW, HW, 3)).astype(np.float32)
    past = [rng.randn(B, 2, HW, HW, 3).astype(np.float32) for _ in range(2)]
    d_t = {"label": p.data["label"][:, 0], "image": p.data["images"][:, 0]}
    stacks = [tuple(jnp.asarray(a) for a in past)] if with_stacks else [None]
    want = cheap_jit(lambda v, d, f, st: p.jt.net_D.apply(
        v, d, {"fake_images": f}, past_stacks=st, training=True),
        p.vars["D"], d_t, jnp.asarray(fake), stacks)
    tnet = Discriminator(Config(CFG, overrides=CUT).dis, Config(CFG, overrides=CUT).data)
    load_flax_variables(tnet, p.vars["D"]).train()
    with torch.no_grad():
        got = tnet({"label": to_torch(p.label[:, 0]), "image": to_torch(p.images[:, 0])},
                   {"fake_images": to_torch(fake)},
                   past_stacks=[tuple(to_torch(a) for a in past)] if with_stacks else [None])
    assert set(got) == set(want) == ({"indv", "temporal_0"} if with_stacks else {"indv"})
    for part in want:
        for side in ("pred_real", "pred_fake"):
            for a, b in zip(got[part][side]["outputs"], want[part][side]["outputs"]):
                np.testing.assert_allclose(to_nhwc(a), np.asarray(b), atol=1e-4, rtol=0)
            for fa, fb in zip(got[part][side]["features"], want[part][side]["features"]):
                for a, b in zip(fa, fb):
                    np.testing.assert_allclose(to_nhwc(a), np.asarray(b), atol=1e-4, rtol=0)


# -------------------------------------------------------- generator


@pytest.mark.parametrize("n_prev", [1, 2])  # a continuation and a warp frame
def test_generator_training_forward_matches_jax(pair, n_prev):
    """A frame in training mode, the generator's own step (its state
    advances): outputs, then every BatchNorm running statistic and ``u``.
    The warp frame's image gets the whole generator's 1e-4, and its warp
    is held to the JAX warp by the port's own flow: a flow within 1e-5
    head units (4e-4 pixels) moves the warped frame by more."""
    p = pair
    prev_labels, prev_images = history(4, n_prev)
    data = {"label": p.label[:, 2], "prev_labels": prev_labels, "prev_images": prev_images}
    want, mut = cheap_jit(lambda v, d: p.jt.net_G.apply(
        v, d, training=True, mutable=["batch_stats", "spectral"]),
        p.vars["G"], {k: jnp.asarray(v) for k, v in data.items()})
    tnet = port_trainer(p.vars).net_G.train()
    with torch.no_grad(), state_updates(tnet, True):
        got = tnet({k: to_torch(v) for k, v in data.items()})
    if n_prev == 2:
        # the warp held to the JAX warp of the same frame by the port's flow
        want = dict(want, warped_images=jfs.resample(
            jnp.asarray(prev_images[:, -1]), jnp.asarray(to_nhwc(got["fake_flow_maps"]))))
    for key in ("fake_images", "fake_flow_maps", "fake_occlusion_masks", "warped_images"):
        if want[key] is None:
            assert got[key] is None
            continue
        scale = FLOW_MULTIPLIER if key == "fake_flow_maps" else 1
        atol = 1e-4 if key == "fake_images" and n_prev == 2 else 1e-5
        np.testing.assert_allclose(to_nhwc(got[key]) / scale, np.asarray(want[key]) / scale,
                                   atol=atol, rtol=0, err_msg=key)
    buffers = dict(tnet.named_buffers())
    for tree in mut.values():
        for name, value in to_port_layout(tnet, tree).items():
            np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5, rtol=0,
                                       err_msg=name)


def test_remat_rollout_equals_plain_rollout(pair):
    """gen.remat / dis.image.remat 'blocks' recompute the checkpointed
    blocks in the backward: the same losses, grads, u and BatchNorm
    statistics after a whole 3-frame rollout, and the warp kernel is not
    recomputed (one forward warp a warp-frame G forward, the D step's
    included)."""
    results = []
    data = {"label": to_torch(pair.label), "images": to_torch(pair.images)}
    for remat in ("none", "blocks"):
        overrides = dict(CUT, gen=dict(CUT["gen"], remat=remat),
                         dis=dict(CUT["dis"], image=dict(CUT["dis"]["image"], remat=remat)))
        trainer = port_trainer(pair.vars, overrides)
        calls = []
        orig = tfs.resample2d
        tfs.resample2d = lambda x, f: calls.append(1) or orig(x, f)
        try:
            g = trainer.gen_update(data)
        finally:
            tfs.resample2d = orig
        results.append((g, [q.grad for q in trainer.net_G.parameters()]
                        + [q.grad for q in trainer.net_D.parameters()],
                        state_buffers(trainer.net_G) + state_buffers(trainer.net_D),
                        len(calls)))
    (g0, grads0, s0, n0), (g1, grads1, s1, n1) = results
    assert n0 == n1 == 2  # frame 2's D step and G step
    for k in g0:
        torch.testing.assert_close(g0[k], g1[k], rtol=1e-6, atol=0)
    for a, b in zip(grads0 + s0, grads1 + s1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------- rollout


def jax_step(jt, kind, state, data_t):
    """The loss and gradient of one step of the JAX sequential rollout
    (``_vid_dis_step_fn`` / ``_vid_gen_step_fn``): ((losses, grads,
    mutables), G's output or None)."""
    key = jax.random.PRNGKey(0)  # no step of this config draws from it
    net, other, fwd = (("vars_D", "vars_G", jt.dis_forward) if kind == "D"
                       else ("vars_G", "vars_D", jt.gen_forward))

    def loss_fn(params):
        own = dict(state[net], params=jt._to_compute_dtype(params))
        args = ((jt._cast_net_vars(state[other]), own) if kind == "D"
                else (own, jt._cast_net_vars(state[other])))
        res = fwd(*args, state["loss_params"], jt._to_compute_dtype(data_t), key)
        losses = {k: v.astype(jnp.float32) for k, v in res[0].items()}
        total = jt._total(losses)
        return total, (dict(losses, total=total), res[1],
                       res[2]["fake_images"] if kind == "G" else None)

    (_, (losses, mut, fake)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state[net]["params"])
    return (losses, grads, mut), fake


def jax_update(tx, params, opt, grads):
    """The step's Adam update (one program a network, for every frame)."""
    updates, opt = tx.update(grads, opt, params)
    return optax.apply_updates(params, updates), opt


class Rollout:
    """The port's rollout of one 3-frame clip, each step's losses, grads
    and state recorded; the JAX rollout of the same clip from the same
    variables, step by step on demand (each step one compiled program:
    frame t's D step, then its G step, whose output joins the history;
    and one compiled Adam update a network, for every frame).
    Both at ``ROLLOUT_LR``."""

    def __init__(self, p):
        self.p = p
        trainer = port_trainer(p.vars, ROLLOUT_CFG)
        self.records = []
        step = trainer._step

        def recorded(net, opt, forward, clip_norm, key):
            losses = step(net, opt, forward, clip_norm, key)
            grads = {n: (q.grad.clone() if q.grad is not None else torch.zeros_like(q))
                     for n, q in net.named_parameters()}
            self.records.append((losses, grads,
                                 {n: b.clone() for n, b in net.named_buffers()}, net))
            return losses

        trainer._step = recorded
        self.fakes = []
        gen_forward = trainer.gen_forward

        def recorded_forward(data_t):
            losses, out = gen_forward(data_t)
            self.fakes.append(out["fake_images"].detach())
            return losses, out

        trainer.gen_forward = recorded_forward
        self.mean = trainer.gen_update({"label": to_torch(p.label), "images": to_torch(p.images)})
        self.trainer = trainer
        v = p.vars
        self.state = {"vars_G": v["G"], "vars_D": v["D"],
                      "loss_params": {"perceptual": v["VGG"]},
                      "opt_G": p.jt.tx_G.init(v["G"]["params"]),
                      "opt_D": p.jt.tx_D.init(v["D"]["params"])}
        self.rings = (None, None, None, None)  # prev labels / images, past real / fake
        self.steps = []
        self.updates = {}  # the compiled Adam update of each network

    def jax(self, i):
        """The JAX rollout's step i: (losses, grads, mutables) of frame
        i // 2's D step (i even) or G step (i odd)."""
        jt, data = self.p.jt, self.p.data
        while len(self.steps) <= i:
            prev_labels, prev_images, past_real, past_fake = self.rings
            t, kind = divmod(len(self.steps), 2)
            data_t = jt._get_data_t(data, t, prev_labels, prev_images)
            data_t["past_stacks"] = jt._past_stacks(past_real, past_fake)
            name = "DG"[kind]
            result, fake = cheap_jit(lambda s, dt: jax_step(jt, name, s, dt),
                                     self.state, data_t)
            net, opt, tx = (("vars_D", "opt_D", jt.tx_D) if name == "D"
                            else ("vars_G", "opt_G", jt.tx_G))
            args = (self.state[net]["params"], self.state[opt], result[1])
            if name not in self.updates:
                self.updates[name] = jax.jit(lambda *a, tx=tx: jax_update(tx, *a)).lower(
                    *args).compile(compiler_options=CHEAP)
            params, new_opt = self.updates[name](*args)
            self.state = dict(self.state, **{
                net: dict(self.state[net], params=params, **result[2]), opt: new_opt})
            self.steps.append(result)
            if kind == 1:
                self.rings = (jfs.concat_frames(prev_labels, data_t["label"], 2),
                              jfs.concat_frames(prev_images, fake, 2),
                              jfs.concat_frames(past_real, data_t["image"], 2),
                              jfs.concat_frames(past_fake, fake, 2))
        return self.steps[i]


@pytest.fixture(scope="module")
def rollout(pair):
    return Rollout(pair)



def check_step(record, want, grad_tol=1e-3, flow_tol=None):
    """A port step's losses, grads and network state after it, against
    the JAX step's (the flow network's leaves to ``flow_tol`` where
    given)."""
    got_losses, got_grads, got_buffers, net = record
    losses, grads, mut = want
    assert set(losses) <= set(got_losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(got_losses[k]), float(v), rtol=1e-4, atol=0,
                                   err_msg=k)
    want_g = to_port_layout(net, grads)
    assert set(want_g) == set(got_grads)
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in want_g.values()))
    floor = ZERO_GRAD_FLOOR * norm
    largest = max(np.abs(v).max() for v in want_g.values())
    for name, value in want_g.items():
        got = got_grads[name].numpy()
        scale = np.abs(value).max()
        if scale <= floor:
            assert np.abs(got).max() <= floor, name
        else:
            scale = max(scale, SMALL_LEAF_SHARE * largest)
            tol = flow_tol if flow_tol and name.startswith("flow_network_temp.") else grad_tol
            assert np.abs(got - value).max() <= tol * scale, name
    for tree in mut.values():
        for name, value in to_port_layout(net, tree).items():
            np.testing.assert_allclose(got_buffers[name].numpy(), value, atol=1e-5,
                                       rtol=0, err_msg=name)


@pytest.mark.parametrize("t,kind", [(t, k) for t in range(3) for k in "DG"])
def test_rollout_step_matches_jax(rollout, t, kind):
    """Frame t's D or G step (frames: first, continuation, warp with the
    temporal scale active)."""
    i = 2 * t + (kind == "G")
    want = rollout.jax(i)
    # from frame 1 on each package's step reads its own history: the
    # frames it generated, within HISTORY_TOL of each other
    check_step(rollout.records[i], want, grad_tol=1e-3 if t == 0 else 2e-3,
               flow_tol=WARP_FLOW_TOL if (t, kind) == (2, "G") else None)
    if kind == "G" and t < 2:  # the frame the next frames read
        jax_fake = np.asarray(rollout.rings[1][:, -1])
        assert np.abs(to_nhwc(rollout.fakes[t]) - jax_fake).max() <= HISTORY_TOL
    temporal = {"GAN_T0"} | ({"Flow", "FeatureMatching_T0"} if kind == "G" else set())
    assert (temporal <= set(want[0])) == (t == 2)
    if i == 5:
        # the rollout's returned losses: each key's mean over its frames
        g_frames = [rollout.jax(j)[0] for j in (1, 3, 5)]
        assert set(rollout.mean) == set().union(*g_frames) | {"grad_norm"}
        for k in set().union(*g_frames):
            want_mean = np.mean([float(f[k]) for f in g_frames if k in f])
            np.testing.assert_allclose(float(rollout.mean[k]), want_mean, rtol=1e-4, err_msg=k)
        assert rollout.trainer.opt_G.count == rollout.trainer.opt_D.count == 3
        # after 3 updates an element differs by at most 3 sign flips
        for net, key in ((rollout.trainer.net_G, "vars_G"), (rollout.trainer.net_D, "vars_D")):
            params = dict(net.named_parameters())
            for name, value in to_port_layout(net, rollout.state[key]["params"]).items():
                assert np.abs(params[name].detach().numpy() - value).max() \
                    <= 6.1 * ROLLOUT_LR, name


def test_g_step_bf16_policy_matches_jax(pair):
    """One warp frame's G step under bf16 compute with fp32 masters: each
    loss within 2e-2 relative. The JAX warp computes its coordinates in
    bf16 (0.125 pixel apart at x in [16, 32)) where the port keeps fp32;
    at this size that moves no loss past the tolerance (the divergence is
    pinned in tests/test_torch_resample2d.py)."""
    p = pair
    bf16 = dict(CUT, trainer=dict(CUT["trainer"], mixed_precision=dict(enabled=True)))
    jt = JaxTrainer(JaxConfig(CFG, overrides=bf16))
    prev_labels, prev_images = history(5, 2)
    data_t = {"label": p.label[:, 2], "image": p.images[:, 2],
              "prev_labels": prev_labels, "prev_images": prev_images}
    jdata = {k: jnp.asarray(a) for k, a in data_t.items()}
    v = p.vars

    def g_losses(vg, vd, vgg, d):
        return jt.gen_forward(dict(vg, params=jt._to_compute_dtype(vg["params"])),
                              jt._cast_net_vars(vd), {"perceptual": vgg},
                              jt._to_compute_dtype(d), jax.random.PRNGKey(0))[0]

    want = cheap_jit(g_losses, v["G"], v["D"], v["VGG"], jdata)
    trainer = port_trainer(v, bf16)
    assert trainer.compute_dtype == torch.bfloat16
    tdata = trainer._prepare({k: to_torch(a) for k, a in data_t.items()})
    got = trainer._step(trainer.net_G, trainer.opt_G,
                        lambda: trainer.gen_forward(tdata)[0], None, "gen_step")
    assert set(want) <= set(got) and "Flow" in want
    for k, value in want.items():
        assert abs(float(got[k]) - float(value)) <= 2e-2 * abs(float(value)), k


def test_adam_state_of_both_networks_bridges(pair):
    """Both optimizers' moments and counts carried from optax trees, the
    discriminator's temporal scale included."""
    trainer = port_trainer(pair.vars)
    for opt, net, tree in ((trainer.opt_G, trainer.net_G, pair.vars["G"]["params"]),
                           (trainer.opt_D, trainer.net_D, pair.vars["D"]["params"])):
        mu = jax.tree_util.tree_map(lambda a: a * 0.5, tree)
        nu = jax.tree_util.tree_map(lambda a: a * a, tree)
        load_adam_state(opt, net, mu, nu, 5)
        want = to_port_layout(net, mu)
        names = [n for n, _ in net.named_parameters()]
        assert opt.count == 5 and set(names) == set(want)
        for name, t in zip(names, opt.mu):
            np.testing.assert_array_equal(t.numpy(), want[name])
    assert any(n.startswith("net_DT0.") for n, _ in trainer.net_D.named_parameters())


# ----------------------------------------------------------- refusals


@pytest.mark.parametrize("what", ["rollout_scan", "additional_discriminators",
                                  "few_shot", "warp_ref", "densepose", "inference"])
def test_unported_branches_raise_naming_the_roadmap(what, tmp_path):
    if what == "inference":
        trainer = Trainer(Config(CFG, overrides=CUT), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            trainer.test([], str(tmp_path))
        return
    if what == "warp_ref":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tflow.FlowLoss(None, warp_ref=True)
        return
    if what == "densepose":
        trainer = Trainer(Config(CFG, overrides=dict(CUT, data=dict(
            CUT["data"], for_pose_dataset=dict(), input_labels=["pose_maps-densepose"]))),
            device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            trainer._start_of_iteration({"label": np.zeros((1, 4, 4, 3))}, 0)
        return
    overrides = {
        "rollout_scan": dict(CUT, trainer=dict(CUT["trainer"], rollout_scan=True)),
        "additional_discriminators": dict(CUT, dis=dict(
            CUT["dis"], additional_discriminators=dict(face=dict(crop_func="a::b")))),
        "few_shot": dict(CUT, data=dict(CUT["data"],
                                        type="imaginaire_tpu.data.paired_few_shot_videos")),
    }[what]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(Config(CFG, overrides=overrides), device="cpu", train=True)
    if what == "rollout_scan":
        with pytest.raises(NotImplementedError, match="rollout_scan.*ROADMAP"):
            train.refuse_unported_runtime(Config(CFG, overrides=overrides))


# -------------------------------------------------------------- entry


def write_video_dataset(root, sequences=3, frames=4, hw=(36, 40), seed=0):
    """A seeded PNG video dataset (RGB frames, 12-class seg maps) in the
    folder layout, written through the port's encoder."""
    rng = np.random.RandomState(seed)
    for s in range(sequences):
        for t in range(frames):
            for kind, arr in (("images", rng.randint(0, 256, hw + (3,), np.uint8)),
                              ("seg_maps", rng.randint(0, LABELS, hw, np.uint8))):
                path = root / kind / f"seq{s:04d}" / f"{t:05d}.png"
                path.parent.mkdir(parents=True, exist_ok=True)
                write_png(str(path), arr)


@pytest.fixture(scope="module")
def entry_cfg(tmp_path_factory):
    """The cut unit config on a PNG video dataset of 3 sequences of 4
    frames, resized to 32x32: 3 iterations an epoch at batch 1; 2 frames
    in epoch 0, 4 from epoch 1 (``num_epochs_temporal_step: 1``)."""
    root = tmp_path_factory.mktemp("videos")
    write_video_dataset(root)
    cfg = Config(CFG, overrides=CUT)
    cfg.data.train.augmentations.resize_h_w = "32, 32"
    cfg.data.input_types[0]["images"]["ext"] = "png"
    for split in (cfg.data.train, cfg.data.val):
        split.roots = [str(root)]
    cfg.data.train.initial_sequence_length = 2
    cfg.data.train.max_sequence_length = 4
    cfg.num_epochs_temporal_step = 1
    cfg.image_save_iter = 4
    cfg.data.num_workers = 2
    del cfg["source_filename"]
    path = root / "vid2vid_png.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    return str(path)


def run(cfg_path, logdir, max_iter):
    return train.main(["--config", cfg_path, "--logdir", str(logdir),
                       "--max_iter", str(max_iter), "--device", "cpu"])


def test_entry_trains_and_a_killed_run_resumes_bit_for_bit(entry_cfg, tmp_path, monkeypatch):
    """``train.main`` on the CPU: 4 iterations straight (the curriculum
    moves from 2 to 4 frames at epoch 1, and each epoch's items have the
    length set before its loader started; an image snapshot at 4),
    against 2 iterations, then a resume to 4 that fast-forwards epoch 0
    past its first 2 batches."""
    lengths = []
    orig = Trainer.gen_update
    monkeypatch.setattr(Trainer, "gen_update", lambda self, data, noise=None: (
        lengths.append(int(data["images"].shape[1])) or orig(self, data)))
    straight = run(entry_cfg, tmp_path / "straight", 4)
    assert lengths == [2, 2, 2, 4] and straight.sequence_length == 4
    path = ckpt_lib.latest_checkpoint_path(str(tmp_path / "straight"))
    payload = ckpt_lib.load_checkpoint(path)  # files and tensors verified
    assert payload["meta"] == {"epoch": 1, "iteration": 4, "batch_in_epoch": 1}
    assert int(payload["state"]["sequence_length"]) == 4
    assert any(k.startswith("net_D/net_DT0.") for k in payload["state"])
    records = ScalarWriter(str(tmp_path / "straight")).read()
    losses = {r["name"]: r["value"] for r in records if r["kind"] == "counter"}
    assert {"gen_update/GAN", "gen_update/Flow", "gen_update/GAN_T0",
            "dis_update/GAN", "gen_update/total"} <= set(losses)
    assert all(np.isfinite(v) for v in losses.values())
    # the snapshot: the last real frame, its label, the rolled-out fake
    img = decode_png((tmp_path / "straight" / "images" / "000000004.png").read_bytes())
    assert img.shape == (32, 3 * 32, 3)

    lengths.clear()
    run(entry_cfg, tmp_path / "killed", 2)
    resumed = run(entry_cfg, tmp_path / "killed", 4)
    assert lengths == [2, 2, 2, 4]
    assert (resumed.current_iteration, resumed.current_epoch) == (4, 1)
    a = ckpt_lib.load_checkpoint(path)["state"]
    b = ckpt_lib.load_checkpoint(ckpt_lib.latest_checkpoint_path(
        str(tmp_path / "killed")))["state"]
    assert set(a) == set(b)
    assert not [k for k in a if not torch.equal(a[k], b[k])]


def test_readahead_starts_after_the_epochs_sequence_length(entry_cfg):
    """The loader's threads read ahead only once its iteration starts, so a
    length set before (train.py: set_epoch, start_of_epoch, then the
    loop) reaches every item of the epoch, and none is read earlier."""
    from imaginaire_tpu_torch.data.loader import get_train_and_val_dataloader

    loader, _ = get_train_and_val_dataloader(Config(entry_cfg), seed=0)
    assert loader.num_workers == 2
    reads = []
    getitem = loader.dataset.__getitem__
    loader.dataset.__getitem__ = lambda i: reads.append(i) or getitem(i)
    it = iter(loader)
    loader.dataset.set_sequence_length(3)
    assert not reads
    assert [b["images"].shape[1] for b in it] == [3, 3, 3]
