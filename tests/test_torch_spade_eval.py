"""SPADE evaluation in the port against the JAX package on the CPU: the
averaged copy's BatchNorm re-estimation (ROADMAP C4), and FID / FID_ema /
best_FID / KID / PRDC through the trainers (the checkpoint's ``ema_bn/``
group, the evaluate entry and the engine's ``load_weights`` are in
``test_torch_evaluate_entry.py``).

``configs/unit_test/spade.yaml`` cut to the small widths of
``test_torch_spade_training.py`` (whose helpers this file reuses), at
32x32, with ``model_average`` on and the style code's global norm set to
``sync_batch`` (the COCO-Stuff config's), so G has BatchNorm layers to
re-estimate. Weights are numpy-drawn into ``jax.eval_shape`` shapes and
bridged; the averaged copy is drawn apart from the live weights. The JAX
trainer's ``_apply_G`` runs as one cheaply compiled program a mode; the
style code's eps of each JAX apply is injected into the port. The two
trainers share one stub extractor (per-channel mean and standard
deviation of the preprocessed images: 6 features), so Inception-v3 does
not run here.

Tolerances:
- re-estimated statistics: each within 1e-5 of the larger of its own and
  the live statistic's max magnitude. The JAX trainer recovers each
  batch's statistic from flax's running update, ``(new - 0.9 old) / 0.1``,
  which multiplies the update's fp32 rounding (at the live statistic's
  size) by 10; the port reads the statistic directly;
- FID, FID_ema, best_FID, KID: rtol 1e-4 (G's fp32 forwards differ by
  ~1e-6 between the packages; FID is a float64 function of the 6-feature
  statistics); PRDC exactly (counts of k-NN comparisons).
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.trainers.spade import Trainer as JaxTrainer
from imaginaire_tpu_torch.bridge import load_flax_variables, to_port_layout
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.trainers.spade import Trainer
from imaginaire_tpu_torch.utils.meters import ScalarWriter

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_spade_training import CHEAP, HW, SMALL, UNIT, draw, jax_eps, one_hot  # noqa: E402

OVERRIDES = copy.deepcopy(SMALL)
OVERRIDES["gen"]["global_adaptive_norm_type"] = "sync_batch"
OVERRIDES["trainer"] = {"model_average": True, "fid_random_init": True,
                        "model_average_batch_norm_estimation_iteration": 2}
TOL_STATS = 1e-5
TOL_METRIC = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def batches(n, batch, seed):
    rng = np.random.RandomState(seed)
    return [{"label": one_hot(batch, 14, seed=seed + i),
             "images": rng.uniform(-1, 1, (batch, HW, HW, 3)).astype(np.float32)}
            for i in range(n)]


def stub_extractor_jax(x):
    return jnp.concatenate([x.mean((1, 2)), x.std((1, 2))], axis=-1)


def stub_extractor(x):
    return torch.cat([x.mean((2, 3)), x.std((2, 3), correction=0)], dim=1)


@pytest.fixture(scope="module")
def eval_pair():
    """The JAX trainer with drawn live and averaged G variables, and a
    factory of port trainers holding the same."""
    jt = JaxTrainer(JaxConfig(UNIT, overrides=OVERRIDES))
    train_batches, val_batches = batches(3, 2, 20), batches(3, 4, 30)
    key = jax.random.PRNGKey(0)
    d0 = {k: jnp.asarray(v) for k, v in train_batches[0].items()}
    shapes = jax.eval_shape(lambda: jt.net_G.init({"params": key, "noise": key}, d0,
                                                  training=True))
    assert "batch_stats" in shapes
    v_g, ema = draw(shapes, seed=1), draw(shapes, seed=4)["params"]
    jt.state = {"vars_G": v_g, "ema_G": ema}
    apply_g, compiled = jt._apply_G, {}

    def cheap_apply(vars_g, data, rng, training, random_style=False):
        data = dict(data)  # a prefetched batch is a dict subclass
        shape = (training, random_style) + tuple(
            (k, tuple(np.shape(v))) for k, v in sorted(data.items()))
        if shape not in compiled:
            compiled[shape] = jax.jit(
                lambda v, d, r: apply_g(v, d, r, training, random_style)).lower(
                vars_g, data, rng).compile(compiler_options=CHEAP)
        return compiled[shape](vars_g, data, rng)

    jt._apply_G = cheap_apply

    def port(logdir=None, train_=False):
        cfg = Config(UNIT, overrides=OVERRIDES)
        if logdir is not None:
            cfg.logdir = str(logdir)
        trainer = Trainer(cfg, device="cpu", train=train_)
        trainer.init_state(seed=0)
        load_flax_variables(trainer.net_G, v_g)
        trainer.ema_G = {k: torch.from_numpy(v)
                         for k, v in to_port_layout(trainer.net_G, ema).items()}
        return trainer

    recal_eps = [jax_eps(jt, jax.random.fold_in(jax.random.PRNGKey(1234), i), 2)
                 for i in range(2)]
    return dict(jt=jt, port=port, train=train_batches, val=val_batches,
                recal_eps=[torch.tensor(e) for e in recal_eps],
                eval_eps=torch.tensor(jax_eps(jt, jax.random.PRNGKey(0), 4)))


def live_state(trainer):
    return {k: v.clone() for k, v in trainer.net_G.state_dict().items()}


# ------------------------------------------------------------------ C4


def test_ema_batch_norm_statistics_match_jax(eval_pair):
    p = eval_pair
    jt, tr = p["jt"], p["port"]()
    jt.current_iteration = tr.current_iteration = 5
    jt.recalculate_model_average_batch_norm_statistics(data_loader=p["train"])
    before = live_state(tr)
    tr.recalculate_model_average_batch_norm_statistics(data_loader=p["train"],
                                                       noise=p["recal_eps"])
    want = to_port_layout(tr.net_G, jt._ema_batch_stats)
    got = tr._ema_batch_stats
    live = dict(tr.net_G.named_buffers())
    assert set(got) == set(want) and len(got) == 8  # 4 BatchNorms x (mean, var)
    for name, value in want.items():
        scale = max(np.abs(value).max(), live[name].abs().max().item())
        err = np.abs(got[name].numpy() - value).max()
        assert err <= TOL_STATS * scale, (name, err)
        # the re-estimated statistics are not the live ones
        assert np.abs(live[name].numpy() - value).max() > 0.1
    # the live network is left bit for bit: parameters, u, statistics
    after = live_state(tr)
    assert all(torch.equal(before[k], after[k]) for k in before)
    # the same iteration does not estimate again (an exhausted noise
    # iterator would raise if it did); the next one does
    stats = tr._ema_batch_stats
    tr.recalculate_model_average_batch_norm_statistics(data_loader=p["train"], noise=[])
    assert tr._ema_batch_stats is stats
    tr.current_iteration = 6
    tr.recalculate_model_average_batch_norm_statistics(data_loader=p["train"][:1],
                                                       noise=p["recal_eps"][:1])
    assert tr._ema_bn_recal_iter == 6 and tr._ema_batch_stats is not stats


def test_ema_column_and_inference_params_use_the_reestimated_statistics(eval_pair):
    p = eval_pair
    tr = p["port"]()
    tr.train_data_loader = p["train"]
    tr.current_iteration = 3
    params = tr.inference_params()
    live = dict(tr.net_G.named_buffers())
    assert all(params[k] is live[k] for k in live)  # nothing estimated yet
    data = tr._to_device(p["val"][0])
    vis = tr._get_visualizations(data)
    assert tr._ema_bn_recal_iter == 3 and len(vis) == 4
    params = tr.inference_params()
    for name, value in tr._ema_batch_stats.items():
        assert params[name] is value
        assert not torch.equal(value, live[name])
    for name, value in tr.ema_G.items():
        assert params[name] is value

    def ema_column(params):
        generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            fake = tr._generate(tr._inference_data(data), params, generator, True)
        return fake[:, :3].permute(0, 2, 3, 1).numpy()

    np.testing.assert_array_equal(vis[3], ema_column(params))
    stale = dict(params, **{k: live[k] for k in tr._ema_batch_stats})
    assert np.abs(vis[3] - ema_column(stale)).max() > 1e-3
    # the unit config without model averaging draws 3 columns, estimates nothing
    plain = Trainer(Config(UNIT, overrides=SMALL), device="cpu")
    plain.init_state(0)
    plain.train_data_loader = p["train"]
    plain.recalculate_model_average_batch_norm_statistics()
    assert plain._ema_batch_stats is None


# ---------------------------------------------------------- the metrics


def test_fid_kid_prdc_through_the_trainers_match_jax(eval_pair, tmp_path):
    p = eval_pair
    jt, tr = p["jt"], p["port"](tmp_path / "port")
    jt.cfg.logdir = str(tmp_path / "jax")
    for t, ext in ((jt, stub_extractor_jax), (tr, stub_extractor)):
        t._cached_fid_extractor = ext
        t.train_data_loader, t.val_data_loader = p["train"], p["val"]
        t.current_iteration = 7
    jt.best_fid = None
    jt._flush_meters = lambda step: None  # keep the JAX meters' values
    recal_eps = iter(p["recal_eps"])
    tr._draw_noise = lambda data, generator: next(recal_eps)
    tr._eval_noise = lambda data: p["eval_eps"]

    jt.write_metrics()
    want = {name: float(jt.meters[name].values[-1]) for name in ("FID", "FID_ema", "best_FID")}
    want.update(jt.compute_extra_metrics(["kid", "prdc"]))
    got_fid = tr.write_metrics()
    got = tr.compute_extra_metrics(["kid", "prdc"])
    records = {r["name"]: r["value"] for r in ScalarWriter(str(tmp_path / "port")).read()
               if r["kind"] == "counter" and r["step"] == 7}
    assert records["FID"] == pytest.approx(got_fid, rel=1e-12)
    assert set(records) == set(want)
    for name, value in want.items():
        if name.startswith("PRDC"):
            assert records[name] == value, name
        else:
            assert records[name] == pytest.approx(value, rel=TOL_METRIC), name
            assert np.isfinite(value) and (value >= 0 or name == "KID")
    assert got == {k: v for k, v in records.items() if k in got}
    assert tr.fid_ema == pytest.approx(want["FID_ema"], rel=TOL_METRIC)
    assert want["FID"] != pytest.approx(want["FID_ema"], rel=1e-3)
    # real statistics cached once beside the run, as in the JAX package
    assert os.path.exists(tmp_path / "port" / "real_stats_cocostuff_tiny.npz")


def test_missing_inception_weights_skip_fid(eval_pair, capsys, tmp_path):
    cfg = Config(UNIT, overrides=SMALL)
    cfg.logdir = str(tmp_path)
    tr = Trainer(cfg, device="cpu", val_data_loader=eval_pair["val"])
    tr.init_state(0)
    # no weights/inception_v3.npz in the repository and no fid_random_init
    assert tr.write_metrics() is None
    assert tr.compute_extra_metrics(["kid"]) == {}
    out = capsys.readouterr().out
    assert "FID skipped" in out and "extra metrics skipped" in out
