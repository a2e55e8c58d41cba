"""The port's SPADE training against the JAX package's, piece by piece
and as one D+G step.

Inputs and weights are numpy-drawn from a seed (into ``jax.eval_shape``
shapes) and bridged; the JAX side runs one jitted apply or step a case,
compiled with XLA's cheap CPU options (the same function, less
optimized code). The whole step runs ``configs/unit_test/spade.yaml``
cut to small widths at 32x32 (the least size FPSE's five stride-2 levels
take), with the style encoder's VAE eps injected: the draw the JAX step
makes from its key.

Tolerances:
- modulation backward, plain vs ``jax.vjp`` of the 'fused' and
  'pallas_interpret' ops: fp32 1e-5 and bf16 8e-3 of the reference's
  max magnitude (bf16: the two frameworks round the inputs' gradient
  products at different steps); the autograd function passes
  ``torch.autograd.gradcheck`` in fp64;
- spectral-norm ``u`` after a training forward: atol 1e-6;
- the discriminator's outputs and features: atol 1e-4, its ``u``: 1e-5;
- the losses: rtol 1e-5; Adam fed identical grads (3 steps, a step lr
  policy): rtol 1e-6; the EMA: rtol 1e-6;
- the D+G step under the fp32 policy: each loss rtol 1e-4; the grads of
  every leaf within 1e-3 of that leaf's max |g| (a leaf whose gradient
  is zero, max |g| under 1e-6 of the global norm in the JAX step, is
  held under that floor: ZERO_GRAD_FLOOR), the global norms rtol 1e-4;
  ``u`` (and BatchNorm statistics) after the step atol 1e-5. The
  parameters after Adam are not compared element by element: with
  beta1 = 0 the first update is ~lr sign(g), which grads near zero flip;
  the G step therefore starts from the JAX state after its D step;
- the bf16 policy: one G step's losses within 2e-2 relative.
"""

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
from imaginaire_tpu.layers import conv as jconv
from imaginaire_tpu.losses import (
    PerceptualLoss as JaxPerceptualLoss,
    dis_accuracy as j_dis_accuracy,
    feature_matching_loss as j_feature_matching_loss,
    gan_loss as j_gan_loss,
    gaussian_kl_loss as j_gaussian_kl_loss,
)
from imaginaire_tpu.ops.spade_modulation import spade_modulation as jax_spade_modulation
from imaginaire_tpu.optim import optimizers as jopt
from imaginaire_tpu.trainers.spade import Trainer as JaxTrainer
from imaginaire_tpu.utils import model_average as jema
from imaginaire_tpu_torch import losses as tlosses
from imaginaire_tpu_torch.bridge import load_adam_state, load_flax_variables, to_port_layout
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.layers.activation_norm import BatchNorm
from imaginaire_tpu_torch.layers.conv import Conv2dBlock, LinearBlock
from imaginaire_tpu_torch.layers.state import state_buffers, state_updates
from imaginaire_tpu_torch.ops import spade_modulation as spade_mod
from imaginaire_tpu_torch.optim.optimizers import get_optimizer_for_params
from imaginaire_tpu_torch.trainers.base import NonFiniteLossError, compute_dtype_of
from imaginaire_tpu_torch.trainers.spade import Trainer
from imaginaire_tpu_torch.utils import model_average as tema

UNIT = "configs/unit_test/spade.yaml"
COCO = "configs/projects/spade/cocostuff/base128_bs4.yaml"
SMALL = dict(
    gen=dict(num_filters=8, style_dims=16, style_enc=dict(num_filters=4),
             activation_norm_params=dict(num_filters=8)),
    dis=dict(num_filters=8, max_num_filters=16))
HW = 32
# a leaf whose gradient is zero (a conv bias followed by an instance norm
# or by the next block's norm) holds fp32 rounding noise in both packages
# (measured: at most 4e-9 of the network's global grad norm, where every
# other leaf's max |g| is above 1e-4 of it): below this share of the
# global norm a leaf is held to zero, not to its own noise
ZERO_GRAD_FLOOR = 1e-6
# the same function, compiled with less optimization (CPU compile time)
CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side of these tiny cases runs on one CPU thread: the
    suite runs several test processes at once, and intra-op threads of
    each would contend for the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cheap_jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=CHEAP)(*args)


def draw(shapes, seed=0):
    """Numpy values for a flax variable tree: kernels at 1/sqrt(fan_in),
    unit ``u`` vectors, positive running variances."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "u":
            u = rng.standard_normal(leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 4
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2))).to(dtype)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------------ C1


@pytest.mark.parametrize("path,want", [
    ("configs/projects/vid2vid/dancing/bf16.yaml", "bfloat16"),
    ("configs/projects/wc_vid2vid/cityscapes/seg_single.yaml", "bfloat16"),
    (COCO, "bfloat16"),
    (UNIT, "float32")])
def test_compute_dtype_follows_the_jax_rule(path, want):
    """The JAX trainer's rule (imaginaire_tpu/trainers/base.py:101-107),
    read off the YAML: mixed_precision.enabled decides first, then the
    legacy trainer.compute_dtype, then fp32."""
    with open(path) as f:
        tcfg = yaml.safe_load(f).get("trainer") or {}
    mp = tcfg.get("mixed_precision") or {}
    rule = (jnp.dtype(mp.get("compute_dtype", "bfloat16")) if mp.get("enabled", False)
            else jnp.dtype(tcfg.get("compute_dtype", "float32")))
    assert rule.name == want
    assert compute_dtype_of(Config(path)) == getattr(torch, want)


# -------------------------------------------------- modulation backward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_pairs", [1, 2, 3, 4])
@pytest.mark.parametrize("impl", ["fused", "pallas_interpret"])
def test_modulation_backward_matches_jax_vjp(impl, n_pairs, dtype):
    rng = np.random.RandomState(n_pairs)
    shape = (2, 8, 8, 4)
    x = rng.randn(*shape) * 2 + 0.5
    gs = [rng.randn(*shape) * 0.3 for _ in range(n_pairs)]
    bs = [rng.randn(*shape) * 0.3 for _ in range(n_pairs)]
    g = rng.randn(*shape)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(
        lambda x_, gs_, bs_: jax_spade_modulation(x_, gs_, bs_, implementation=impl),
        jnp.asarray(x, jdt), [jnp.asarray(a, jdt) for a in gs],
        [jnp.asarray(a, jdt) for a in bs])
    dx, dgs, dbs = vjp(jnp.asarray(g, jdt))
    want = [dx, *dgs, *dbs]

    tdt = getattr(torch, dtype)
    inputs = [nchw(a, tdt).requires_grad_(True) for a in [x, *gs, *bs]]
    out = spade_mod.spade_modulation(inputs[0], inputs[1:1 + n_pairs],
                                     inputs[1 + n_pairs:])
    got = torch.autograd.grad(out, inputs, nchw(g, tdt))
    tol = 1e-5 if dtype == "float32" else 8e-3
    for a, b in zip(got, want):
        assert a.dtype == tdt
        assert rel_err(nhwc(a), np.asarray(b, np.float32)) <= tol


def test_modulation_autograd_function_passes_gradcheck():
    gen = torch.Generator().manual_seed(0)

    def draw64(scale):
        return (torch.randn((2, 2, 3, 4), generator=gen, dtype=torch.float64)
                * scale).requires_grad_(True)

    inputs = (draw64(2.0), draw64(0.3), draw64(0.3), draw64(0.3), draw64(0.3))
    before = (spade_mod.launches, spade_mod.bwd_launches)
    assert torch.autograd.gradcheck(
        lambda x, g0, g1, b0, b1: spade_mod.spade_modulation(x, [g0, g1], [b0, b1]),
        inputs)
    assert (spade_mod.launches, spade_mod.bwd_launches) == before  # CPU: no kernel


# ---------------------------------------------------------- layer state


def test_spectral_norm_u_after_one_training_forward():
    x = np.random.RandomState(0).randn(2, 8, 8, 5).astype(np.float32)
    jmod = jconv.Conv2dBlock(8, kernel_size=3, weight_norm_type="spectral")
    variables = draw(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x))))
    want, mut = jmod.apply(variables, jnp.asarray(x), training=True,
                           mutable=["spectral"])
    tmod = load_flax_variables(
        Conv2dBlock(5, 8, kernel_size=3, weight_norm_type="spectral"), variables).train()
    u0 = tmod.conv.u.clone()
    with torch.no_grad():
        kept = tmod(nchw(x))  # not this network's step: u is read, kept
        assert torch.equal(tmod.conv.u, u0)
        with state_updates(tmod, True):
            got = tmod(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    assert torch.equal(kept, got)
    np.testing.assert_allclose(tmod.conv.u.numpy(),
                               np.asarray(mut["spectral"]["conv"]["u"]),
                               atol=1e-6, rtol=0)


# ------------------------------------------------------------ fixtures


def one_hot(n, channels, hw=HW, seed=1):
    idx = np.random.RandomState(seed).randint(0, channels, (n, hw, hw))
    return np.eye(channels, dtype=np.float32)[idx]


@pytest.fixture(scope="module")
def unit_pair():
    """The JAX trainer and the port's, on the cut unit-test config, with
    numpy-drawn G, D and VGG19 variables bridged into the port."""
    jcfg = JaxConfig(UNIT, overrides=SMALL)
    jt = JaxTrainer(jcfg)
    seg, img = one_hot(2, 14), np.random.RandomState(2).uniform(-1, 1, (2, HW, HW, 3))
    data = {"label": jnp.asarray(seg), "images": jnp.asarray(img, jnp.float32)}
    key = jax.random.PRNGKey(0)
    variables = {
        "G": draw(jax.eval_shape(lambda: jt.net_G.init(
            {"params": key, "noise": key}, data, training=True)), seed=1),
        "D": draw(jax.eval_shape(lambda: jt.net_D.init(
            {"params": key}, data, {"fake_images": data["images"]},
            training=True)), seed=2),
        "VGG": draw(jax.eval_shape(lambda: jt.perceptual.module.init(
            key, jnp.zeros((1, HW, HW, 3)))), seed=3)["params"]}
    return SimpleNamespace(jt=jt, data=data, seg=seg, img=img, vars=variables)


def port_trainer(overrides=SMALL, variables=None):
    trainer = Trainer(Config(UNIT, overrides=overrides), device="cpu", train=True)
    trainer.init_state(seed=0)
    if variables is not None:
        load_flax_variables(trainer.net_G, variables["G"])
        load_flax_variables(trainer.net_D, variables["D"])
        load_flax_variables(trainer.perceptual.module, {"params": variables["VGG"]})
    return trainer


def jax_eps(jt, key, batch, dtype=jnp.float32):
    """The style encoder's eps of a JAX apply with noise key ``key``."""
    sub = jt.net_G.apply({}, rngs={"noise": key},
                         method=lambda m: m.make_rng("noise"))
    return np.asarray(jax.random.normal(sub, (batch, jt.cfg.gen.style_dims), dtype),
                      np.float32)


# ------------------------------------------------------- discriminator


def test_discriminator_matches_jax(unit_pair):
    """A training forward of D in its own step: outputs, features, and
    every u after it (each layer steps once a pass, FPSE's shared heads
    three times)."""
    p = unit_pair
    fake = {"fake_images": jnp.asarray(np.tanh(p.img[::-1]), jnp.float32)}
    want, mut = cheap_jit(lambda v, d, f: p.jt.net_D.apply(
        v, d, f, training=True, mutable=["spectral"]), p.vars["D"], p.data, fake)
    tnet = load_flax_variables(port_trainer().net_D, p.vars["D"]).train()
    with torch.no_grad(), state_updates(tnet, True):
        got = tnet({"label": nchw(p.seg), "images": nchw(p.img)},
                   {"fake_images": nchw(np.asarray(fake["fake_images"]))})
    for key in ("real_outputs", "fake_outputs"):
        assert len(got[key]) == len(want[key]) == 5
        for a, b in zip(got[key], want[key]):
            np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=1e-4, rtol=0)
    for key in ("real_features", "fake_features"):
        for fa, fb in zip(got[key], want[key]):
            for a, b in zip(fa, fb):
                np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=1e-4, rtol=0)
    u_want = to_port_layout(tnet, mut["spectral"])
    buffers = dict(tnet.named_buffers())
    assert set(u_want) == set(buffers)
    for name, value in u_want.items():
        np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5, rtol=0)


# -------------------------------------------------------------- losses


def test_gan_feature_matching_and_kl_losses_match_jax():
    rng = np.random.RandomState(4)
    logits = [rng.randn(2, 4, 4, 1).astype(np.float32) for _ in range(3)]
    fakes = [[rng.randn(2, 4, 4, 3).astype(np.float32) for _ in range(2)]
             for _ in range(2)]
    reals = [[rng.randn(2, 4, 4, 3).astype(np.float32) for _ in range(2)]
             for _ in range(2)]
    mu, logvar = rng.randn(2, 8).astype(np.float32), rng.randn(2, 8).astype(np.float32)
    jl = [jnp.asarray(a) for a in logits]
    tl = [nchw(a) for a in logits]
    pairs = [(tlosses.gan_loss(tl, True, dis_update=False),
              j_gan_loss(jl, True, dis_update=False))]
    for t_real in (True, False):
        pairs.append((tlosses.gan_loss(tl, t_real, dis_update=True),
                      j_gan_loss(jl, t_real, dis_update=True)))
    pairs += list(zip(tlosses.dis_accuracy(tl, tl[::-1]),
                      j_dis_accuracy(jl, jl[::-1])))
    pairs.append((tlosses.feature_matching_loss(
        [[nchw(a) for a in f] for f in fakes], [[nchw(a) for a in r] for r in reals]),
        j_feature_matching_loss([[jnp.asarray(a) for a in f] for f in fakes],
                                [[jnp.asarray(a) for a in r] for r in reals])))
    pairs.append((tlosses.gaussian_kl_loss(torch.from_numpy(mu), torch.from_numpy(logvar)),
                  j_gaussian_kl_loss(jnp.asarray(mu), jnp.asarray(logvar))))
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlosses.gan_loss(tl, True, gan_mode="least_square")


def test_perceptual_loss_matches_jax():
    """VGG19 up to relu_2_1 with random weights, images rounded to bf16
    first on both sides (the JAX default), convolutions in fp32."""
    layers, weights = ["relu_1_1", "relu_2_1"], [0.5, 1.0]
    jloss = JaxPerceptualLoss(layers=layers, weights=weights, allow_random_init=True)
    params = draw(jax.eval_shape(lambda: jloss.module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))))["params"]
    rng = np.random.RandomState(5)
    fake, real = (rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    want = cheap_jit(jloss, params, jnp.asarray(fake), jnp.asarray(real))
    tloss = tlosses.PerceptualLoss(layers=layers, weights=weights,
                                   weights_path="no/such/vgg19.npz",
                                   allow_random_init=True)
    load_flax_variables(tloss.module, {"params": params})
    got = tloss(nchw(fake), nchw(real))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=0)
    with pytest.raises(FileNotFoundError):
        tlosses.PerceptualLoss(layers=layers, weights_path="no/such/vgg19.npz").init_params()


# ------------------------------------------------------ optimizer, EMA


@pytest.mark.parametrize("section", ["coco_gen_opt", "decaying"])
def test_adam_matches_optax_over_three_steps(section):
    cfg_opt = (Config(COCO).gen_opt if section == "coco_gen_opt" else dict(
        type="adam", lr=1e-3, adam_beta1=0.5, adam_beta2=0.99,
        lr_policy=dict(type="step", step_size=1, gamma=0.5, iteration_mode=True)))
    rng = np.random.RandomState(6)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    tx = jopt.get_optimizer_for_params(cfg_opt, jopt.get_scheduler(cfg_opt, 1))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    tparams = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = get_optimizer_for_params(cfg_opt, tparams)
    for _ in range(3):
        grads = {k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
                 for k, v in params.items()}
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(tparams, ("a", "b")):
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for p, k in zip(tparams, ("a", "b")):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=0)
    assert opt.count == 3
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_optimizer_for_params(dict(type="rmsprop"), tparams)


@pytest.mark.parametrize("num_updates", [3, 12])
def test_ema_matches_jax(num_updates):
    """Spectral-collapsed EMA: a copy up to start_iteration (10), then
    beta 0.9."""
    x = jnp.zeros((2, 7))
    jmod = jconv.LinearBlock(6, weight_norm_type="spectral")
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x))
    v0, v1 = draw(shapes, seed=7), draw(shapes, seed=8)
    avg = jema.ema_init(v0["params"], v0["spectral"], remove_sn=True)
    avg = jema.ema_update(avg, v1["params"], num_updates, beta=0.9, start_iteration=10,
                          spectral=v1["spectral"], remove_sn=True)
    tmod = load_flax_variables(LinearBlock(7, 6, weight_norm_type="spectral"), v0)
    tavg = tema.ema_init(tmod)
    load_flax_variables(tmod, v1)
    tema.ema_update(tavg, tmod, num_updates, beta=0.9, start_iteration=10)
    want = to_port_layout(tmod, avg)
    assert set(want) == set(tavg)
    for name, value in want.items():
        np.testing.assert_allclose(tavg[name].numpy(), value, rtol=1e-6, atol=0)


# ------------------------------------------------------- the D+G step


def jax_step(jt, kind, state, data, key):
    """One JAX step's (losses, grads, new mutables, new params, new opt),
    the loss and update of ``_dis_step_fn`` / ``_gen_step_fn``."""
    net, other, forward, tx = (("vars_D", "vars_G", jt.dis_forward, jt.tx_D)
                               if kind == "D" else
                               ("vars_G", "vars_D", jt.gen_forward, jt.tx_G))

    def step(state, data, key):
        def loss_fn(params):
            own = dict(state[net], params=jt._to_compute_dtype(params))
            args = ((jt._cast_net_vars(state[other]), own) if kind == "D"
                    else (own, jt._cast_net_vars(state[other])))
            losses, mut = forward(*args, state["loss_params"],
                                  jt._to_compute_dtype(data), key)
            losses = {k: v.astype(jnp.float32) for k, v in losses.items()}
            total = jt._total(losses)
            return total, (dict(losses, total=total), mut)

        (_, (losses, mut)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state[net]["params"])
        updates, opt = tx.update(grads, state["opt"], state[net]["params"])
        return losses, grads, mut, optax.apply_updates(state[net]["params"], updates), opt

    return cheap_jit(step, state, data, key)


def check_step(got_losses, net, want):
    """A port step's losses and grads, and its network's state after, against
    the JAX step's."""
    losses, grads, mut = want[:3]
    for k, v in losses.items():
        np.testing.assert_allclose(float(got_losses[k]), float(v), rtol=1e-4, atol=0,
                                   err_msg=k)
    want_g = to_port_layout(net, grads)
    got_g = {n: p.grad for n, p in net.named_parameters()}
    assert set(want_g) == set(got_g)
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in want_g.values()))
    floor = ZERO_GRAD_FLOOR * norm
    for name, value in want_g.items():
        got = got_g[name].numpy()
        scale = np.abs(value).max()
        if scale <= floor:  # a zero gradient: rounding noise on both sides
            assert np.abs(got).max() <= floor, name
        else:
            assert np.abs(got - value).max() <= 1e-3 * scale, name
    np.testing.assert_allclose(float(got_losses["grad_norm"]), norm, rtol=1e-4)
    buffers = dict(net.named_buffers())
    assert mut
    for tree in mut.values():
        for name, value in to_port_layout(net, tree).items():
            np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5,
                                       rtol=0, err_msg=name)


def test_dg_step_matches_jax_fp32(unit_pair):
    p = unit_pair
    jt, v = p.jt, p.vars
    trainer = port_trainer(variables=v)
    assert trainer.compute_dtype == torch.float32
    loss_params = {"perceptual": v["VGG"]}
    tdata = {"label": nchw(p.seg), "images": nchw(p.img)}

    key_d, key_g = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    state = {"vars_G": v["G"], "vars_D": v["D"], "loss_params": loss_params,
             "opt": jt.tx_D.init(v["D"]["params"])}
    want_d = jax_step(jt, "D", state, p.data, key_d)
    got_d = trainer.dis_update(tdata, noise=torch.tensor(jax_eps(jt, key_d, 2)))
    check_step(got_d, trainer.net_D, want_d)
    assert float(got_d["total"]) == pytest.approx(float(want_d[0]["GAN"]), rel=1e-4)

    # the G step from the JAX state after its D step
    vars_d = dict(v["D"], params=want_d[3], **want_d[2])
    load_flax_variables(trainer.net_D, vars_d)
    state = dict(state, vars_D=vars_d, opt=jt.tx_G.init(v["G"]["params"]))
    want_g = jax_step(jt, "G", state, p.data, key_g)
    got_g = trainer.gen_update(tdata, noise=torch.tensor(jax_eps(jt, key_g, 2)))
    check_step(got_g, trainer.net_G, want_g)
    # D's state is the step's input, read but not advanced
    for name, value in to_port_layout(trainer.net_D, vars_d["spectral"]).items():
        np.testing.assert_array_equal(dict(trainer.net_D.named_buffers())[name].numpy(),
                                      value)


def test_g_step_bf16_policy_matches_jax(unit_pair):
    """mixed_precision on: params and data cast to bf16, fp32 masters and
    statistics, VGG in fp32 on bf16-rounded images."""
    p = unit_pair
    bf16 = dict(SMALL, trainer=dict(mixed_precision=dict(enabled=True)))
    jt = JaxTrainer(JaxConfig(UNIT, overrides=bf16))
    v = p.vars
    key = jax.random.PRNGKey(13)
    state = {"vars_G": v["G"], "vars_D": v["D"], "loss_params": {"perceptual": v["VGG"]},
             "opt": jt.tx_G.init(v["G"]["params"])}
    want = jax_step(jt, "G", state, p.data, key)[0]
    trainer = port_trainer(bf16, v)
    assert trainer.compute_dtype == torch.bfloat16
    got = trainer.gen_update({"label": nchw(p.seg), "images": nchw(p.img)},
                             noise=torch.tensor(jax_eps(jt, key, 2, jnp.bfloat16)))
    for k, value in want.items():
        assert abs(float(got[k]) - float(value)) <= 2e-2 * abs(float(value)), k


# --------------------------------------------- the port's own contracts


SYNC = dict(SMALL, gen=dict(SMALL["gen"], global_adaptive_norm_type="sync_batch",
                            activation_norm_params=dict(num_filters=8,
                                                        activation_norm_type="sync_batch")))


def test_remat_step_equals_plain_step():
    """gen.remat / dis.remat 'blocks' recompute each block in the backward:
    the same grads, u and BatchNorm statistics as without (base norms
    sync_batch, so the G blocks hold running statistics)."""
    data = {"label": nchw(one_hot(2, 14)),
            "images": nchw(np.random.RandomState(3).uniform(-1, 1, (2, HW, HW, 3)))}
    noise = torch.randn(2, 16, generator=torch.Generator().manual_seed(4))
    results = []
    for remat in ("none", "blocks"):
        overrides = dict(SYNC, gen=dict(SYNC["gen"], remat=remat),
                         dis=dict(SYNC["dis"], remat=remat))
        trainer = port_trainer(overrides)
        d = trainer.dis_update(data, noise=noise)
        d_grads = [q.grad.clone() for q in trainer.net_D.parameters()]
        g = trainer.gen_update(data, noise=noise)
        results.append((d, g, d_grads, [q.grad for q in trainer.net_G.parameters()],
                        state_buffers(trainer.net_G) + state_buffers(trainer.net_D)))
    (d0, g0, dg0, gg0, s0), (d1, g1, dg1, gg1, s1) = results
    assert any(isinstance(m, BatchNorm) for m in trainer.net_G.modules())
    for a, b in [(d0, d1), (g0, g1)]:
        for k in a:
            assert torch.allclose(a[k], b[k], rtol=1e-6, atol=0), k
    for a, b in zip(dg0 + gg0 + s0, dg1 + gg1 + s1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_nonfinite_step_keeps_the_state_or_halts():
    data = {"label": nchw(one_hot(1, 14)),
            "images": torch.full((1, 3, HW, HW), float("nan"))}
    skip = dict(SMALL, diagnostics=dict(on_nonfinite="skip"))
    trainer = port_trainer(skip)
    before = ([q.clone() for q in trainer.net_G.parameters()],
              [b.clone() for b in state_buffers(trainer.net_G)])
    losses = trainer.gen_update(data)
    assert not torch.isfinite(losses["total"]) and trainer.nonfinite_events == 1
    assert trainer.opt_G.count == 0
    for a, b in zip(before[0] + before[1], list(trainer.net_G.parameters())
                    + state_buffers(trainer.net_G)):
        assert torch.equal(a, b)
    with pytest.raises(NonFiniteLossError):
        port_trainer().dis_update(data)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_trainer(dict(SMALL, diagnostics=dict(on_nonfinite="rollback")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_trainer(dict(SMALL, trainer=dict(gan_mode="least_square")))


def test_adam_state_bridge_round_trip(unit_pair):
    v = unit_pair.vars["D"]["params"]
    trainer = port_trainer()
    mu = jax.tree_util.tree_map(lambda a: a * 0.5, v)
    nu = jax.tree_util.tree_map(lambda a: a * a, v)
    load_adam_state(trainer.opt_D, trainer.net_D, mu, nu, 7)
    names = [n for n, _ in trainer.net_D.named_parameters()]
    want = to_port_layout(trainer.net_D, mu)
    assert trainer.opt_D.count == 7
    for name, t in zip(names, trainer.opt_D.mu):
        np.testing.assert_array_equal(t.numpy(), want[name])
