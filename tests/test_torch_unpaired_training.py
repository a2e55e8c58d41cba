"""The port's UNIT and MUNIT trainers against the JAX package's, on the
CPU: one D+G step of each family, MUNIT's with the gradient penalty, the
consistency regularization and ``gan_recon`` on; the two-domain FID; and
2-iteration runs of the train, inference and evaluate entries.

The unit configs (``configs/unit_test/{munit_patch,unit}.yaml``) at
64x64, batch 2, weights numpy-drawn into ``jax.eval_shape`` shapes and
bridged, the residual trunks cut to one block, each JAX step one program
compiled with XLA's cheap CPU options; the JAX steps' style codes and
shift offsets are injected into the port.

Tolerances: those of the pix2pixHD step test for the D steps (each loss
rtol 1e-4, every gradient leaf within 1e-3 of that leaf's max |g|, a
leaf whose gradient is zero, under 1e-6 of the global norm, held under
that floor, the global norm rtol 1e-4, ``u`` after the step atol 1e-5),
but the gradient penalty rtol 1e-3 (``TOL_GP``). The G steps: the losses
and ``u`` as above, the gradient as a whole and its norm within 1e-2
in L2 (``TOL_G``: through the cycle the fp32 gradient of either package
is up to 2.1e-2 of a leaf's max from the float64 one), and Adam's update
within 1e-3 of the lr where the gradient is above 0.1 of its leaf's max
(``LIVE_G``). FID_a, FID_b and their mean rtol 1e-4 (a stub extractor of
3 features in place of Inception-v3).
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from imaginaire_tpu.evaluation import inception as jax_inception
from imaginaire_tpu_torch import evaluate, inference, train
from imaginaire_tpu_torch.bridge import load_jax_state, to_port_layout
from imaginaire_tpu_torch.data.png import decode_png
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
from imaginaire_tpu_torch.utils.meters import ScalarWriter

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_unpaired import (  # noqa: E402
    MUNIT,
    MUNIT_PATCH,
    UNIT,
    cheap_jit,
    images,
    jax_style_key,
    nchw,
    trainers,
)

B, LATENT = 2, 8
ZERO_GRAD_FLOOR = 1e-6  # see tests/test_torch_spade_training.py
TOL_METRIC = 1e-4
# MUNIT's G step in fp32 is 2.0e-3 (JAX) and 6.5e-3 (the port) from the
# port's float64 step in L2, and 2.1e-2 of a leaf's max through the cycle
TOL_G = 1e-2
# Adam's first update is lr sign(g): held where |g| is above this share of
# its leaf's max, beyond the fp32 noise
LIVE_G = 0.1
# the port's fp32 gp equals its float64 one to 1e-7; the JAX fp32 gp, a
# gradient of a gradient, is 1.8e-4 from it
TOL_GP = 1e-3
# the step tests cut the residual trunks to one block
NARROW = {"gen": {"num_res_blocks": 1}}
# MUNIT's D-step regularizers, with the reconstructions as fakes, on the
# patch D cut to one scale of three layers (its pyramid is held in
# test_torch_unpaired.py)
REGULARIZED = {"trainer": {"gan_recon": True,
                           "loss_weight": {"gp": 1.0, "consistency_reg": 1.0}},
               "gen": {"num_res_blocks": 1},
               "dis": {"num_discriminators": 1, "num_layers": 3}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_step(jt, kind, state, data, key):
    """One JAX step's (losses, grads, new mutables, new params, new opt),
    the loss and update of the trainer's step functions, compiled cheaply."""
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

    return cheap_jit(step, state, data, key)(state, data, key)


def check_mutables(net, mut):
    buffers = dict(net.named_buffers())
    assert mut
    for tree in mut.values():
        for name, value in to_port_layout(net, tree).items():
            np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5, rtol=0,
                                       err_msg=name)


def check_step(got_losses, net, want):
    """A D step: each loss, every gradient leaf (within 1e-3 of its max, a
    zero leaf under the floor), the global norm and ``u``."""
    losses, grads, mut = want[:3]
    for k, v in losses.items():
        np.testing.assert_allclose(float(got_losses[k]), float(v), rtol=1e-4, atol=0,
                                   err_msg=k)
    want_g = to_port_layout(net, grads)
    got_g = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(want_g) == set(got_g)
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in want_g.values()))
    floor = ZERO_GRAD_FLOOR * norm
    for name, value in want_g.items():
        scale = np.abs(value).max()
        if scale <= floor:
            assert np.abs(got_g[name]).max() <= floor, name
        else:
            assert np.abs(got_g[name] - value).max() <= 1e-3 * scale, name
    np.testing.assert_allclose(float(got_losses["grad_norm"]), norm, rtol=1e-4)
    check_mutables(net, mut)


def jax_noise(jt, key, data, shifts=False):
    """The style codes (and the consistency shifts' offsets) the JAX
    step draws from ``key``, for the port."""
    ka, kb = jax.random.split(jax_style_key(jt.net_G, key))
    out = {"style": tuple(torch.from_numpy(np.asarray(jax.random.normal(k, (B, LATENT))))
                          for k in (ka, kb))}
    if shifts:
        keys = jax.random.split(jax.random.fold_in(key, 7), 4)
        out["shifts"] = []
        for k, src in zip(keys, ("images_a", "images_b", "images_a", "images_b")):
            _, h, w, _ = data[src].shape
            ky, kx = jax.random.split(k)
            out["shifts"].append(tuple(
                torch.from_numpy(np.asarray(jax.random.randint(kk, (B,), 0, 2 * m + 1)))
                for kk, m in ((ky, max(1, int(0.05 * h))), (kx, max(1, int(0.05 * w))))))
    return out


def check_g_step(got_losses, net, want):
    """A G step: the losses as ``check_step`` holds them, ``u`` atol
    1e-5, and the gradient as a whole, and so its norm, within ``TOL_G``
    in L2 (the cycle's gradient is ill-conditioned in fp32: ROADMAP.md,
    section C)."""
    losses, grads, mut = want[:3]
    for k, v in losses.items():
        np.testing.assert_allclose(float(got_losses[k]), float(v), rtol=1e-4, atol=0,
                                   err_msg=k)
    want_g = to_port_layout(net, grads)
    got_g = {n: p.grad.numpy() for n, p in net.named_parameters()}
    assert set(want_g) == set(got_g)
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in want_g.values()))
    err = np.sqrt(sum(float(((got_g[n] - v).astype(np.float64) ** 2).sum())
                      for n, v in want_g.items()))
    assert err <= TOL_G * norm, err / norm
    # the norm moves by at most the difference's own L2
    np.testing.assert_allclose(float(got_losses["grad_norm"]), norm, rtol=TOL_G)
    check_mutables(net, mut)
    return want_g, ZERO_GRAD_FLOOR * norm


@pytest.mark.parametrize("config", [MUNIT_PATCH, UNIT])
def test_dg_step_matches_jax_fp32(config):
    """One D step, then one G step from the JAX state after it: every
    loss term, the gradients, ``u``, and Adam's update of G. MUNIT's on
    the patch D (features a list of lists a scale) with the gradient
    penalty, the consistency regularization (both from the step's
    starting ``u``) and ``gan_recon`` on."""
    munit = config == MUNIT_PATCH
    jt, tr, v = trainers(config, REGULARIZED if munit else NARROW)
    host = images(2)
    data = {k: jnp.asarray(a) for k, a in host.items()}
    tdata = {k: nchw(a) for k, a in host.items()}
    state = {"vars_G": v["G"], "vars_D": v["D"], "loss_params": {},
             "opt": jt.tx_D.init(v["D"]["params"])}
    key_d, key_g = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    want_d = jax_step(jt, "D", state, data, key_d)
    u_before = {n: b.clone() for n, b in tr.net_D.named_buffers()}
    got_d = tr.dis_update(tdata, noise=jax_noise(jt, key_d, data, shifts=munit)
                          if munit else None)
    regularizers = {"gp", "consistency_reg"} if munit else set()
    assert set(got_d) == {"gan", "D_real_acc", "D_fake_acc", "total",
                          "grad_norm"} | regularizers
    assert all(float(got_d[k]) > 0 for k in regularizers)
    losses = dict(want_d[0])
    if munit:
        gp, total = float(losses.pop("gp")), float(losses.pop("total"))
        np.testing.assert_allclose(float(got_d["gp"]), gp, rtol=TOL_GP)
        # the total carries the gradient penalty's own difference
        assert abs(float(got_d["total"]) - total) <= 1e-4 * abs(total) + TOL_GP * gp
    check_step(got_d, tr.net_D, (losses,) + tuple(want_d[1:]))
    assert any(not torch.equal(b, u_before[n]) for n, b in tr.net_D.named_buffers())

    vars_d = dict(v["D"], params=want_d[3], **want_d[2])
    load_jax_state(tr, {"vars_G": v["G"], "vars_D": vars_d})
    state = dict(state, vars_D=vars_d, opt=jt.tx_G.init(v["G"]["params"]))
    want_g = jax_step(jt, "G", state, data, key_g)
    before = {n: p.detach().clone() for n, p in tr.net_G.named_parameters()}
    got_g = tr.gen_update(tdata, noise=jax_noise(jt, key_g, data) if munit else None)
    terms = ({"gan", "image_recon", "style_recon", "content_recon", "kl", "cycle_recon"}
             if munit else {"gan", "image_recon", "cycle_recon"})
    assert set(got_g) == terms | {"total", "grad_norm"}
    assert set(tr.weights) == terms | regularizers
    grads, floor = check_g_step(got_g, tr.net_G, want_g)
    lr = jt.cfg.gen_opt.lr
    after = to_port_layout(tr.net_G, want_g[3])
    for name, p in tr.net_G.named_parameters():
        scale = np.abs(grads[name]).max()
        if scale <= floor:
            continue
        live = np.abs(grads[name]) > LIVE_G * scale
        got_upd = (p.detach() - before[name]).numpy()[live]
        want_upd = (after[name] - before[name].numpy())[live]
        assert np.abs(got_upd - want_upd).max(initial=0) <= 1e-3 * lr, name


# --------------------------------------------------- FID and the entries


def stub_extractor_jax(x):
    return x.mean((1, 2))


def stub_extractor(x):
    return x.mean((2, 3))


class CompiledInference:
    """A flax generator whose ``apply(..., method=inference)`` runs one
    cheaply compiled program a direction (eager applies cost more)."""

    def __init__(self, net):
        self.net, self.programs = net, {}

    def __getattr__(self, name):
        return getattr(self.net, name)

    def apply(self, variables, data, a2b, random_style, rngs, method):
        key = (a2b, random_style)
        if key not in self.programs:
            self.programs[key] = cheap_jit(lambda v, d, r: self.net.apply(
                v, d, a2b=a2b, random_style=random_style, rngs={"noise": r},
                method=self.net.inference), variables, data, rngs["noise"])
        return self.programs[key](variables, data, rngs["noise"])


def test_two_domain_fid_matches_jax(tmp_path, monkeypatch):
    """FID_a (B into A) and FID_b (A into B) over a validation batch of
    4, the style drawn from the trainers' fixed key (the JAX draw
    injected), into their meters; the mean is the FID. The stub extractor
    takes each image's 3 channel means."""
    jt, tr, v = trainers(MUNIT, {"logdir": str(tmp_path / "port")}, seed=7)
    jt.cfg.logdir = str(tmp_path / "jax")
    jt.state = {"vars_G": v["G"]}
    val = [images(30, b=4)]
    jt.val_data_loader, tr.val_data_loader = val, val
    monkeypatch.setattr(jax_inception, "load_params", lambda random_init=False: None)
    monkeypatch.setattr(jax_inception, "make_extractor", lambda variables: stub_extractor_jax)
    jt._flush_meters = lambda step: None
    tr._cached_fid_extractor = stub_extractor
    tr.current_iteration = 3
    z = jax.random.normal(jax_style_key(jt.net_G, jax.random.PRNGKey(0)), (4, LATENT))
    jt.net_G = CompiledInference(jt.net_G)
    call = tr._call_inference
    tr._call_inference = lambda params, data, **kw: call(
        params, data, **dict(kw, noise=torch.from_numpy(np.asarray(z))))
    want = jt._compute_fid()
    got = tr.write_metrics()
    assert got == pytest.approx(want, rel=TOL_METRIC)
    records = {r["name"]: r["value"] for r in ScalarWriter(str(tmp_path / "port")).read()
               if r["kind"] == "counter" and r["step"] == 3}
    for name in ("FID_a", "FID_b"):
        assert records[name] == pytest.approx(float(jt.meters[name].values[-1]),
                                              rel=TOL_METRIC), name
    assert records["FID"] == pytest.approx(0.5 * (records["FID_a"] + records["FID_b"]))
    assert records["FID_a"] != pytest.approx(records["FID_b"], rel=1e-3)
    for domain in "ab":
        assert (tmp_path / "port" / f"real_stats_{domain}.npz").exists()


@pytest.mark.parametrize("config", [MUNIT, UNIT])
def test_train_inference_and_evaluate_entries(config, tmp_path, monkeypatch):
    """Two iterations through ``python -m imaginaire_tpu_torch.train`` on
    the fixture's two domains (an image snapshot at 2, a checkpoint), the
    inference entry from the verified load (the config's
    ``inference_args``: A into B), and the evaluate entry's FID sweep
    (the stub extractor)."""
    cfg = yaml.safe_load(open(config))
    cfg["test_data"] = dict(cfg["data"], test=cfg["data"]["val"])
    cfg["image_save_iter"] = 2
    cfg["inference_args"] = {"a2b": True, "random_style": True}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    logdir = tmp_path / "log"
    trainer = train.main(["--config", str(path), "--logdir", str(logdir), "--device", "cpu"])
    assert trainer.current_iteration == 2
    assert (logdir / "images" / f"{2:09d}.png").exists()
    scalars = {r["name"]: r["value"] for r in ScalarWriter(str(logdir)).read()
               if r["kind"] == "counter"}
    assert np.isfinite(scalars["gen_update/total"]) and np.isfinite(scalars["dis_update/gan"])
    checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
    out = tmp_path / "out"
    served = inference.main(["--config", str(path), "--checkpoint", checkpoint,
                             "--output_dir", str(out), "--device", "cpu"])
    assert served.checkpoint_path == checkpoint
    pngs = sorted(out.rglob("*.png"))
    assert len(pngs) == 3  # the larger domain's 3 files
    assert all("|" in str(p.relative_to(out)) for p in pngs)
    for p in pngs:
        img = decode_png(p.read_bytes())
        assert img.shape == (64, 64, 3) and img.std() > 0
    trainer_cls = type(trainer)
    monkeypatch.setattr(trainer_cls, "_fid_extractor", lambda self: stub_extractor)
    rows = evaluate.main(["--config", str(path), "--checkpoint", checkpoint,
                          "--metrics", "fid", "--device", "cpu",
                          "--logdir", str(tmp_path / "eval")])
    assert [r["iteration"] for r in rows] == [2] and np.isfinite(rows[0]["FID"])
