"""The port's FUNIT trainer against the JAX package's, on the CPU: one
fp32 D+G step of each generator under the unit configs' RMSprop (FUNIT's
with a spectral-normed D and the gradient penalty), the mean per-class
FID, 2-iteration runs of the train, inference and evaluate entries, and
every committed project config through the train and inference entries
at tiny widths.

The unit configs (``configs/unit_test/{funit,coco_funit}.yaml``) at
64x64, batch 2, weights numpy-drawn into ``jax.eval_shape`` shapes and
bridged, each JAX step one program compiled with XLA's cheap CPU
options.

Tolerances: every loss rtol 1e-5 (the gradient penalty, a gradient of a
gradient, rtol 1e-3 as in the MUNIT step test, ``TOL_GP``); after the D
step every parameter atol 1e-5 (RMSprop's first update is
lr g / sqrt(0.1 g^2 + 1e-8): its slope is at most 1 in g, so a parameter
moves by at most a gradient's own difference) and ``u`` atol 1e-5. After
the G step at least 97% of the parameters' elements atol 1e-5
(``LIVE_G``), and the parameters' difference within 3e-2 of the update
in L2 (``TOL_G``): G's gradient of the GAN term crosses D's leaky ReLU
kinks, where an fp32 rounding of the fakes flips a unit's slope. Against
the port's float64 G gradient at the same weights, COCO-FUNIT's fp32
gradient is 1.4e-3 away in L2 in the JAX package and 2.8e-4 in the port,
which leaves 1.4% of its parameters' elements over 1e-5 (up to 5.4e-4)
and the difference 1.9e-2 of the update; FUNIT's G step after its D step
moves 13 elements of a first conv by up to 6.8e-5 (ROADMAP.md, section
C). The FID and its per-class terms rtol 1e-4 (a stub extractor of
3 features in place of Inception-v3: a 2048x2048 ``sqrtm`` a class costs
10-25 s on these CPUs).
"""

import glob
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

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.evaluation import inception as jax_inception
from imaginaire_tpu.registry import resolve as jax_resolve
from imaginaire_tpu_torch import evaluate, inference, train
from imaginaire_tpu_torch.bridge import load_jax_state, to_port_layout
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.png import decode_png
from imaginaire_tpu_torch.registry import resolve
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib
from imaginaire_tpu_torch.utils.meters import ScalarWriter
from imaginaire_tpu_torch.utils.model_average import ema_init

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_funit import (  # noqa: E402
    COCO,
    FUNIT,
    batch,
    cheap_jit,
    d_init_shapes,
    draw,
    g_init_shapes,
    to_port,
)

TOL_LOSS = 1e-5
TOL_PARAM = 1e-5
# the G step (see above): the share of elements held at TOL_PARAM, and the
# parameters' difference over the update in L2
LIVE_G = 0.97
TOL_G = 3e-2
TOL_GP = 1e-3
TOL_METRIC = 1e-4
# FUNIT's step on a spectral-normed D with the gradient penalty on
REGULARIZED = {"trainer": {"loss_weight": {"gp": 1.0}},
               "dis": {"weight_norm_type": "spectral"}}
# the committed configs at tiny widths on the fixture: every piece their
# entries run, at 64x64 crops
TINY = {"gen": {"num_filters": 8, "num_filters_mlp": 16, "style_dims": 16, "usb_dims": 32,
                "num_res_blocks": 1, "num_downsamples_content": 2,
                "num_downsamples_style": 3},
        "dis": {"num_filters": 8, "max_num_filters": 32, "num_layers": 3}}
PROJECT_CONFIGS = sorted(glob.glob("configs/projects/funit/*/*.yaml")
                         + glob.glob("configs/projects/coco_funit/*/*.yaml"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def trainers(config, overrides=None, seed=1):
    """(JAX trainer, port trainer, drawn JAX variables {G, D})."""
    jt = jax_resolve(JaxConfig(config).trainer.type, "Trainer")(
        JaxConfig(config, overrides=overrides or {}))
    cfg = Config(config, overrides=overrides or {})
    tr = resolve(cfg.trainer.type, "Trainer")(cfg, device="cpu", train=True)
    tr.init_state(seed=0)
    data = batch(0)
    out = {"images_trans": data["images_style"], "images_recon": data["images_content"]}
    v = {"G": draw(g_init_shapes(jt.net_G, data), seed),
         "D": draw(d_init_shapes(jt.net_D, data, out), seed + 1)}
    load_jax_state(tr, {"vars_G": v["G"], "vars_D": v["D"]})
    return jt, tr, v


def jax_step(jt, kind, state, data, key):
    """One JAX step's (losses, grads, new mutables, new params), the loss
    and update of the trainer's step functions, compiled cheaply."""
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
        opt = tx.init(state[net]["params"])
        updates, _ = tx.update(grads, opt, state[net]["params"])
        return losses, grads, mut, optax.apply_updates(state[net]["params"], updates)

    return cheap_jit(step, state, data, key)(state, data, key)


def check_step(got_losses, net, want, before, g_step=False):
    """Each loss, ``grad_norm``, the parameters after the update (every
    element, or for a G step ``LIVE_G`` of them and ``TOL_G`` in L2), and
    the state the step wrote."""
    losses, grads, mut, params = want
    gp = float(losses.pop("gp", 0.0))
    total = float(losses.pop("total"))
    for k, v in losses.items():
        np.testing.assert_allclose(float(got_losses[k]), float(v), rtol=TOL_LOSS, atol=0,
                                   err_msg=k)
    if gp:
        np.testing.assert_allclose(float(got_losses["gp"]), gp, rtol=TOL_GP)
    # the total carries the gradient penalty's own difference
    assert abs(float(got_losses["total"]) - total) <= TOL_LOSS * abs(total) + TOL_GP * gp
    want_g = to_port_layout(net, grads)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in want_g.values()))
    np.testing.assert_allclose(float(got_losses["grad_norm"]), norm, rtol=1e-3)
    after = to_port_layout(net, params)
    assert set(after) == {n for n, _ in net.named_parameters()}
    diff = np.concatenate([(p.detach().numpy() - after[n]).ravel()
                           for n, p in net.named_parameters()])
    update = np.concatenate([(after[n] - before[n]).ravel() for n in before])
    assert np.linalg.norm(update) > 0
    if g_step:
        assert (np.abs(diff) <= TOL_PARAM).mean() >= LIVE_G
        assert np.linalg.norm(diff) <= TOL_G * np.linalg.norm(update)
    else:
        assert np.abs(diff).max() <= TOL_PARAM
    buffers = dict(net.named_buffers())
    for tree in (mut or {}).values():
        for name, value in to_port_layout(net, tree).items():
            np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5, rtol=0,
                                       err_msg=name)


@pytest.mark.parametrize("config", [FUNIT, COCO])
def test_dg_step_matches_jax_fp32(config):
    """One D step, then one G step from the JAX state after it: every loss
    term, the gradient norm, the parameters after RMSprop's update and
    D's ``u``. FUNIT's on a spectral-normed D with the gradient penalty
    (from the step's starting ``u``); COCO-FUNIT's on the unit config."""
    jt, tr, v = trainers(config, REGULARIZED if config == FUNIT else None)
    host = batch(2)
    data = {k: jnp.asarray(a) for k, a in host.items()}
    tdata = to_port(host)
    state = {"vars_G": v["G"], "vars_D": v["D"], "loss_params": {}}
    want_d = jax_step(jt, "D", state, data, jax.random.PRNGKey(11))
    before = {n: p.detach().numpy().copy() for n, p in tr.net_D.named_parameters()}
    got_d = tr.dis_update(tdata)
    regularizers = {"gp"} if config == FUNIT else set()
    assert set(got_d) == {"gan", "D_real_acc", "D_fake_acc", "total",
                          "grad_norm"} | regularizers
    assert all(float(got_d[k]) > 0 for k in regularizers)
    check_step(got_d, tr.net_D, want_d, before)

    vars_d = dict(v["D"], params=want_d[3], **want_d[2])
    load_jax_state(tr, {"vars_G": v["G"], "vars_D": vars_d})
    state = dict(state, vars_D=vars_d)
    u_before = {n: b.clone() for n, b in tr.net_D.named_buffers()}
    want_g = jax_step(jt, "G", state, data, jax.random.PRNGKey(12))
    before = {n: p.detach().numpy().copy() for n, p in tr.net_G.named_parameters()}
    got_g = tr.gen_update(tdata)
    assert set(got_g) == {"gan", "image_recon", "feature_matching", "total", "grad_norm"}
    assert set(tr.weights) == {"gan", "image_recon", "feature_matching"} | regularizers
    check_step(got_g, tr.net_G, want_g, before, g_step=True)
    # the G step stores no u of D
    assert all(torch.equal(b, u_before[n]) for n, b in tr.net_D.named_buffers())


# --------------------------------------------------- FID and the entries


def stub_extractor_jax(x):
    return x.mean((1, 2))


def stub_extractor(x):
    return x.mean((2, 3))


class ClassLoader:
    """A validation loader over per-style-class batches: it iterates the
    batches of the class its dataset (itself) is pinned to."""

    def __init__(self, batches):
        self.batches, self.dataset = batches, self
        self.num_style_classes, self.sample_class_idx = len(batches), None

    def set_sample_class_idx(self, class_idx=None):
        self.sample_class_idx = class_idx

    def __iter__(self):
        return iter(self.batches[self.sample_class_idx])


class CompiledInference:
    """A flax generator whose ``apply(..., method=inference)`` runs one
    cheaply compiled program (eager applies cost more)."""

    def __init__(self, net):
        self.net, self.program = net, None

    def __getattr__(self, name):
        return getattr(self.net, name)

    def apply(self, variables, data, rngs=None, method=None):
        data = {k: v for k, v in data.items() if k.startswith("images")}
        if self.program is None:
            self.program = cheap_jit(lambda v, d: self.net.apply(
                v, d, method=self.net.inference), variables, data)
        return self.program(variables, data)


def test_mean_per_class_fid_matches_jax(tmp_path, monkeypatch):
    """The mean over 3 style classes of each class's FID (a validation
    batch of 4 a class, the stub extractor taking each image's 3 channel
    means), the real statistics cached per class; FID_ema of an averaged
    copy equal to the live weights is the FID."""
    jt, tr, v = trainers(COCO, {"logdir": str(tmp_path / "port")}, seed=7)
    jt.cfg.logdir = str(tmp_path / "jax")
    jt.state = {"vars_G": v["G"]}
    val = ClassLoader([[batch(30 + c, b=4)] for c in range(3)])
    jt.val_data_loader, tr.val_data_loader = val, val
    monkeypatch.setattr(jax_inception, "load_params", lambda random_init=False: None)
    monkeypatch.setattr(jax_inception, "make_extractor", lambda variables: stub_extractor_jax)
    jt.net_G = CompiledInference(jt.net_G)
    tr._cached_fid_extractor = stub_extractor
    want = jt._compute_fid()
    per_class = [float(np.load(tmp_path / "jax" / f"real_stats_style{c}.npz")["mu"].sum())
                 for c in range(3)]
    tr.current_iteration = 3
    got = tr.write_metrics()
    assert got == pytest.approx(want, rel=TOL_METRIC)
    assert val.sample_class_idx is None and tr.fid_ema is None
    for c in range(3):
        mu = float(np.load(tmp_path / "port" / f"real_stats_style{c}.npz")["mu"].sum())
        assert mu == pytest.approx(per_class[c], rel=TOL_METRIC)
    tr.model_average, tr.ema_G = True, ema_init(tr.net_G, True)
    assert tr.write_metrics() == pytest.approx(got, rel=1e-6)
    assert tr.fid_ema == pytest.approx(got, rel=1e-6)
    records = {r["name"] for r in ScalarWriter(str(tmp_path / "port")).read()}
    assert {"FID", "FID_ema", "best_FID"} <= records


@pytest.mark.parametrize("config", [FUNIT, COCO])
def test_train_inference_and_evaluate_entries(config, tmp_path, monkeypatch):
    """Two iterations through ``python -m imaginaire_tpu_torch.train`` on
    the fixture's classes (an image snapshot at 2, a checkpoint), the
    inference entry from the verified load (``keep_original_size``: the
    items carry no original size), one PNG a distinct item key, and the
    evaluate entry's per-class FID sweep (the stub extractor)."""
    cfg = yaml.safe_load(open(config))
    cfg["test_data"] = dict(cfg["data"], test=cfg["data"]["val"])
    cfg["image_save_iter"] = 2
    cfg["inference_args"] = {"keep_original_size": True}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    logdir = tmp_path / "log"
    trainer = train.main(["--config", str(path), "--logdir", str(logdir), "--device", "cpu"])
    assert trainer.current_iteration == 2
    assert (logdir / "images" / f"{2:09d}.png").exists()
    scalars = {r["name"]: r["value"] for r in ScalarWriter(str(logdir)).read()
               if r["kind"] == "counter"}
    assert np.isfinite(scalars["gen_update/feature_matching"])
    assert np.isfinite(scalars["dis_update/gan"])
    checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
    out = tmp_path / "out"
    keys = []
    forward = type(trainer).inference_forward

    def keep(self, params, data, *a, **k):
        keys.extend(data["key"])
        return forward(self, params, data, *a, **k)

    monkeypatch.setattr(type(trainer), "inference_forward", keep)
    served = inference.main(["--config", str(path), "--checkpoint", checkpoint,
                             "--output_dir", str(out), "--device", "cpu"])
    assert served.checkpoint_path == checkpoint
    pngs = sorted(out.rglob("*.png"))
    assert len(keys) == 6 and len(pngs) == len(set(keys))  # the 6 style files
    assert {str(p.relative_to(out))[:-4] for p in pngs} == set(keys)
    for p in pngs:
        img = decode_png(p.read_bytes())
        assert img.shape == (64, 64, 3) and img.std() > 0
    monkeypatch.setattr(type(trainer), "_fid_extractor", lambda self: stub_extractor)
    rows = evaluate.main(["--config", str(path), "--checkpoint", checkpoint,
                          "--metrics", "fid", "--device", "cpu",
                          "--logdir", str(tmp_path / "eval")])
    assert [r["iteration"] for r in rows] == [2] and np.isfinite(rows[0]["FID"])
    assert all((tmp_path / "eval" / f"real_stats_style{c}.npz").exists() for c in range(3))


@pytest.mark.parametrize("config", PROJECT_CONFIGS)
def test_committed_configs_train_and_infer(config, tmp_path):
    """Every committed FUNIT and COCO-FUNIT config, with only its data
    (the fixture's folders, batch 1, 64x64 crops) and widths overridden:
    one iteration through the train entry (bf16, Adam, the averaged
    copy), then the inference entry (``keep_original_size`` where the
    config sets it)."""
    cfg = yaml.safe_load(open(config))
    for section, values in TINY.items():
        cfg[section].update(values)
    cfg["data"]["num_workers"] = 0
    for split in ("train", "val"):
        cfg["data"][split].update(roots=["tests/fixtures/fewshot/raw"], is_packed=False,
                                  batch_size=1)
        aug = cfg["data"][split]["augmentations"]
        for key, value in (("resize_smallest_side", 72), ("resize_h_w", "72, 72"),
                           ("random_crop_h_w", "64, 64"), ("center_crop_h_w", "64, 64")):
            if key in aug:
                aug[key] = value
    cfg["test_data"] = dict(cfg["data"], test=cfg["data"]["val"])
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    logdir = tmp_path / "log"
    trainer = train.main(["--config", str(path), "--logdir", str(logdir), "--max_iter", "1",
                          "--device", "cpu"])
    assert trainer.current_iteration == 1 and trainer.model_average
    assert trainer.compute_dtype == torch.bfloat16
    assert trainer.net_D.model.embedder.embedding.shape[0] == cfg["dis"]["num_classes"]
    inference.main(["--config", str(path), "--logdir", str(logdir), "--output_dir",
                    str(tmp_path / "out"), "--device", "cpu"])
    assert len(list((tmp_path / "out").rglob("*.png"))) > 0
