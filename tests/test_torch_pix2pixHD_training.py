"""The port's pix2pixHD trainer against the JAX package's, on the CPU.

The unit config (``configs/unit_test/pix2pixHD.yaml``: an encoder, one
local enhancer, a two-scale patch D) at 64x64, weights numpy-drawn into
``jax.eval_shape`` shapes and bridged, the JAX step jitted with XLA's
cheap CPU options.

Tolerances:
- ``pre_process``: edges and ids identical (ids exact in int32 after the
  bf16 cast of the label);
- the fp32 D+G step, as the SPADE step test holds it: each loss rtol
  1e-4, every gradient leaf within 1e-3 of that leaf's max |g| (a leaf
  whose gradient is zero, under 1e-6 of the global norm, held under that
  floor), the global norm rtol 1e-4, ``u`` after the step atol 1e-5;
  Adam's update of the G step (the parameters after it) within 1e-3 of
  the lr for every element whose gradient is above 1e-2 of its leaf's
  max, in every leaf above the zero floor (with beta1 0 the first update
  is ~lr sign(g), which rounding flips where g is ~0);
- ``_pre_save_checkpoint``'s centers against the JAX ``cluster_features``
  (scikit-learn's K-means, the JAX encoder) on the same validation
  batches: per label the same set of centers, each within 1e-5;
- save, verified load and resume: ``cluster_centers`` bit for bit.
"""

import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.model_utils import pix2pixHD as jutils
from imaginaire_tpu.trainers.pix2pixHD import Trainer as JaxTrainer
from imaginaire_tpu_torch import evaluate, inference, train
from imaginaire_tpu_torch.bridge import load_flax_variables, load_jax_state, to_port_layout
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.data.png import decode_png
from imaginaire_tpu_torch.model_utils import pix2pixHD as tutils
from imaginaire_tpu_torch.trainers.pix2pixHD import Trainer
from imaginaire_tpu_torch.utils import checkpoint as ckpt_lib

UNIT = "configs/unit_test/pix2pixHD.yaml"
HW = 64
SEG = 8
ZERO_GRAD_FLOOR = 1e-6
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
    """Kernels at 1/sqrt(fan_in), unit ``u``, conv biases that an instance
    norm follows at zero (as the configs' init leaves them)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "u":
            u = rng.standard_normal(leaf.shape)
            return (u / np.linalg.norm(u)).astype(np.float32)
        if path[-1].key == "bias" and path[-2].key == "conv":
            return np.zeros(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 4
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, flax.core.unfreeze(shapes))


def nchw(a, dtype=torch.float32):
    a = np.asarray(a)
    t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    return t.to(dtype) if a.dtype.kind == "f" else t


def quadrant_ids(b, hw, ids):
    """(B, H, W, 1) ids: four quadrants a sample, ``ids[n]`` = its four."""
    out = np.zeros((b, hw, hw, 1), np.int32)
    h = hw // 2
    for n in range(b):
        for q, (y, x) in enumerate(((0, 0), (0, h), (h, 0), (h, h))):
            out[n, y:y + h, x:x + h] = ids[n][q]
    return out


def host_batch(seed, ids, b=2, hw=HW):
    """A loader batch: NHWC float label (one-hot seg, then the raw ids as
    the instance channel) and images."""
    rng = np.random.RandomState(seed)
    inst = quadrant_ids(b, hw, ids)
    seg = np.eye(SEG, dtype=np.float32)[rng.randint(0, SEG, (b, hw, hw))]
    return {"label": np.concatenate([seg, inst.astype(np.float32)], axis=-1),
            "images": rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)}


def port_trainer(overrides=None, **kw):
    trainer = Trainer(Config(UNIT, overrides=overrides or {}), device="cpu", train=True,
                      **kw)
    trainer.init_state(seed=0)
    return trainer


# ------------------------------------------------------------ pre_process


def test_pre_process_keeps_bf16_ids_apart():
    """Cityscapes ids 26001 and 26002 side by side: the edge between them
    is taken on the host before the bf16 cast, and the ids ride the cast
    as int32; the same edges and ids as the JAX ``pre_process``."""
    bf16 = {"trainer": {"mixed_precision": {"enabled": True}}}
    trainer = Trainer(Config(UNIT, overrides=bf16), device="cpu", train=True)
    assert trainer.compute_dtype == torch.bfloat16
    batch = host_batch(0, [[26001, 26002, 26001, 26002], [7, 26001, 26002, 33000]])
    got = trainer._start_of_iteration(batch, 0)
    want = JaxTrainer(JaxConfig(UNIT, overrides=bf16)).pre_process(
        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got["label"], np.asarray(want["label"]))
    np.testing.assert_array_equal(got["instance_maps"], np.asarray(want["instance_maps"]))
    edges = got["label"][..., -1]
    assert edges[0, :, HW // 2 - 1:HW // 2 + 1].all()  # 26001 | 26002
    assert np.array_equal(tutils.get_edges(batch["label"][..., -1:])[..., 0], edges)
    # idempotent: a preprocessed batch passes through
    assert trainer.pre_process(got) is got
    data = trainer._prepare(trainer._to_device(got))
    assert data["label"].dtype == torch.bfloat16
    assert data["instance_maps"].dtype == torch.int32
    assert set(np.unique(data["instance_maps"][0].numpy())) == {26001, 26002}
    # what the cast would have done to the ids
    assert torch.tensor([26001.0, 26002.0]).bfloat16().unique().numel() == 1


def test_one_hot_on_device_with_instance_maps_is_refused():
    """The port refuses it; the JAX ``pre_process`` slices the index map's
    last column as the instance channel (ROADMAP.md C10)."""
    cfg = {"data": {"one_hot_on_device": True}}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(Config(UNIT, overrides=cfg), device="cpu")
    jt = JaxTrainer(JaxConfig(UNIT))
    index_map = np.random.RandomState(1).randint(0, SEG, (2, 16, 24)).astype(np.int32)
    out = jt.pre_process({"label": jnp.asarray(index_map),
                          "label_float": jnp.zeros((2, 16, 24, 1))})
    assert out["instance_maps"].shape == (2, 16, 1)  # a column, not a map
    np.testing.assert_array_equal(np.asarray(out["instance_maps"])[..., 0],
                                  index_map[..., -1])


# -------------------------------------------------------- the D+G step


def jax_step(jt, kind, state, data, key):
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
        if scale <= floor:
            assert np.abs(got).max() <= floor, name
        else:
            assert np.abs(got - value).max() <= 1e-3 * scale, name
    np.testing.assert_allclose(float(got_losses["grad_norm"]), norm, rtol=1e-4)
    buffers = dict(net.named_buffers())
    for tree in mut.values():
        for name, value in to_port_layout(net, tree).items():
            np.testing.assert_allclose(buffers[name].numpy(), value, atol=1e-5,
                                       rtol=0, err_msg=name)
    return want_g, floor


def test_dg_step_matches_jax_fp32():
    """One D step, then one G step from the JAX state after it: losses
    (GAN, FeatureMatching, Perceptual; no KL), gradients through the
    encoder's instance pooling, u, and Adam's update of G."""
    jt = JaxTrainer(JaxConfig(UNIT))
    batch = host_batch(2, [[0, 1, 2, 3], [4, 5, 6, 7]])
    data = {k: jnp.asarray(v) for k, v in jt.pre_process(
        {k: jnp.asarray(v) for k, v in batch.items()}).items()}
    key = jax.random.PRNGKey(0)
    shapes_g = jax.eval_shape(lambda d: jt.net_G.init(
        {"params": key, "noise": key}, d, training=True), data)
    shapes_d = jax.eval_shape(lambda d: jt.net_D.init(
        {"params": key}, d, {"fake_images": d["images"]}, training=True), data)
    shapes_vgg = jax.eval_shape(lambda: jt.perceptual.module.init(
        key, jnp.zeros((1, HW, HW, 3))))
    v = {"G": draw(shapes_g, 1), "D": draw(shapes_d, 2), "VGG": draw(shapes_vgg, 3)["params"]}
    trainer = port_trainer()
    assert set(trainer.weights) == {"GAN", "FeatureMatching", "Perceptual"}
    load_flax_variables(trainer.net_G, v["G"])
    load_flax_variables(trainer.net_D, v["D"])
    load_flax_variables(trainer.perceptual.module, {"params": v["VGG"]})
    tdata = trainer._to_device(trainer._start_of_iteration(batch, 0))
    assert tdata["instance_maps"].shape == (2, 1, HW, HW)

    state = {"vars_G": v["G"], "vars_D": v["D"], "loss_params": {"perceptual": v["VGG"]},
             "opt": jt.tx_D.init(v["D"]["params"])}
    want_d = jax_step(jt, "D", state, data, jax.random.PRNGKey(11))
    got_d = trainer.dis_update(tdata)
    check_step(got_d, trainer.net_D, want_d)

    vars_d = dict(v["D"], params=want_d[3], **want_d[2])
    load_flax_variables(trainer.net_D, vars_d)
    state = dict(state, vars_D=vars_d, opt=jt.tx_G.init(v["G"]["params"]))
    want_g = jax_step(jt, "G", state, data, jax.random.PRNGKey(12))
    before = {n: p.detach().clone() for n, p in trainer.net_G.named_parameters()}
    got_g = trainer.gen_update(tdata)
    grads, floor = check_step(got_g, trainer.net_G, want_g)
    assert float(got_g["Perceptual"]) > 0 and float(got_g["GaussianKL"]) == 0
    assert any(np.abs(grads[n]).max() > floor for n in grads if n.startswith("encoder."))
    # Adam's update where the gradient is not rounding noise
    lr = jt.cfg.gen_opt.lr
    after = to_port_layout(trainer.net_G, want_g[3])
    for name, p in trainer.net_G.named_parameters():
        scale = np.abs(grads[name]).max()
        if scale <= floor:
            continue  # a zero gradient: Adam's update of rounding noise
        live = np.abs(grads[name]) > 1e-2 * scale
        got_upd = (p.detach() - before[name]).numpy()[live]
        want_upd = (after[name] - before[name].numpy())[live]
        assert np.abs(got_upd - want_upd).max(initial=0) <= 1e-3 * lr, name


# ------------------------------------------------------- cluster centers


def val_batches(trainer):
    """Two validation batches of two items: quadrant instances of labels
    1-8 (each a quarter of the image, above the 1/16 small-instance
    cut), so each label has at most 4 rows and K-means keeps them all."""
    return [host_batch(20 + i, [[1, 2, 3, 4], [5, 6, 7, 8]] if i == 0
                       else [[1, 3, 5, 7], [2, 4, 6, 8]]) for i in range(2)]


def test_pre_save_checkpoint_clusters_like_jax(tmp_path):
    jt = JaxTrainer(JaxConfig(UNIT))
    trainer = port_trainer({"logdir": str(tmp_path)})
    assert trainer.cluster_centers.shape == (SEG + 1, 4, 3)
    assert not trainer.cluster_centers.any()
    batches = val_batches(trainer)
    trainer.val_data_loader = batches
    data0 = {k: jnp.asarray(v) for k, v in jt.pre_process(
        {k: jnp.asarray(v) for k, v in batches[0].items()}).items()}
    variables = draw(jax.eval_shape(lambda d: jt.net_G.init(
        {"params": jax.random.PRNGKey(0)}, d), data0), 4)
    load_flax_variables(trainer.net_G, variables)
    trainer.ema_G = None  # the unit config averages no G: the live weights

    jax_batches = [{k: jnp.asarray(v) for k, v in jt.pre_process(
        {k: jnp.asarray(v) for k, v in b.items()}).items()} for b in batches]
    encode = jax.jit(lambda v, im, inst: jt.net_G.apply(
        v, im, inst, method=lambda m, im, inst: m.encoder(im, inst))).lower(
        variables, data0["images"], data0["instance_maps"]).compile(compiler_options=CHEAP)

    def jax_encode(d):
        return np.asarray(encode(variables, d["images"], d["instance_maps"]))

    want = jutils.cluster_features(jax_encode, jax_batches, SEG + 1, 3, n_clusters=4,
                                   is_cityscapes=False)
    path = trainer.save_checkpoint(0, 1)
    got = trainer.cluster_centers.numpy()
    # labels 1-8: two instances each, so two centers and two zero rows
    assert np.abs(got[1:, :2]).sum(axis=2).min() > 0 and not got[:, 2:].any()
    for label in range(SEG + 1):
        order = lambda c: c[np.lexsort(c.T[::-1])]  # noqa: E731
        np.testing.assert_allclose(order(got[label]), order(want[label]), atol=1e-5,
                                   rtol=0, err_msg=str(label))
    # the checkpoint holds them, verified
    stored = ckpt_lib.load_checkpoint(path)["state"]
    assert torch.equal(stored["cluster_centers"], trainer.cluster_centers)


def test_cluster_centers_resume_and_load_bit_for_bit(tmp_path):
    trainer = port_trainer({"logdir": str(tmp_path)})
    trainer.val_data_loader = val_batches(trainer)
    trainer.save_checkpoint(0, 1)
    saved = trainer.cluster_centers.clone()
    assert saved.abs().sum() > 0
    resumed = port_trainer({"logdir": str(tmp_path)})
    assert resumed.load_checkpoint() and resumed.current_iteration == 1
    assert torch.equal(resumed.cluster_centers, saved)
    served = Trainer(Config(UNIT, overrides={"logdir": str(tmp_path)}), device="cpu")
    served.init_state(0)
    assert served.load_checkpoint(ckpt_lib.latest_checkpoint_path(str(tmp_path)))
    assert torch.equal(served.cluster_centers, saved)
    # a checkpoint without the centers does not load into an encoder's trainer
    state = {k: v for k, v in trainer.state_tensors().items() if k != "cluster_centers"}
    with pytest.raises(KeyError, match="cluster_centers"):
        resumed.load_state_tensors(state)


def test_bridge_loads_cluster_centers_from_a_jax_state():
    jt = JaxTrainer(JaxConfig(UNIT))
    data = {k: jnp.asarray(v) for k, v in jt.pre_process(
        {k: jnp.asarray(v) for k, v in host_batch(5, [[0, 1, 2, 3]] * 2).items()}).items()}
    key = jax.random.PRNGKey(0)
    vars_g = draw(jax.eval_shape(lambda d: jt.net_G.init({"params": key}, d), data), 6)
    vars_d = draw(jax.eval_shape(lambda d: jt.net_D.init(
        {"params": key}, d, {"fake_images": d["images"]}), data), 7)
    centers = np.random.RandomState(6).standard_normal((SEG + 1, 4, 3)).astype(np.float32)
    trainer = port_trainer()
    load_jax_state(trainer, {"vars_G": vars_g, "vars_D": vars_d, "cluster_centers": centers})
    np.testing.assert_array_equal(trainer.cluster_centers.numpy(), centers)
    for net, tree in ((trainer.net_G, vars_g), (trainer.net_D, vars_d)):
        own = dict(net.named_parameters(), **dict(net.named_buffers()))
        for collection in tree.values():
            for name, value in to_port_layout(net, collection).items():
                np.testing.assert_array_equal(own[name].detach().numpy(), value)
    with pytest.raises(KeyError, match="cluster_centers"):
        load_jax_state(trainer, {"vars_G": vars_g, "cluster_centers": centers[:3]})


# ------------------------------------------------------------- the entries


def test_train_inference_and_evaluate_entries_on_the_unit_config(tmp_path, monkeypatch):
    """Two iterations through ``python -m imaginaire_tpu_torch.train`` on
    the unit config (the repository's fixture images), a checkpoint with
    clustered centers, then the inference entry from it, and the evaluate
    entry's sweep (a stub feature extractor in place of Inception-v3:
    each image's per-channel mean and standard deviation)."""
    cfg = yaml.safe_load(open(UNIT))
    cfg["test_data"] = dict(cfg["data"], test=cfg["data"]["val"])
    cfg["image_save_iter"] = 2
    for split in ("train", "val", "test"):
        cfg["test_data" if split == "test" else "data"][split]["augmentations"][
            "resize_h_w"] = "64, 64"
    path = tmp_path / "p2p.yaml"
    path.write_text(yaml.safe_dump(json.loads(json.dumps(cfg))))
    logdir = tmp_path / "log"
    trainer = train.main(["--config", str(path), "--logdir", str(logdir), "--device", "cpu"])
    assert trainer.current_iteration == 2
    checkpoint = ckpt_lib.latest_checkpoint_path(str(logdir))
    stored = ckpt_lib.load_checkpoint(checkpoint)["state"]
    assert stored["cluster_centers"].abs().sum() > 0
    assert (logdir / "images" / f"{2:09d}.png").exists()
    out = tmp_path / "out"
    inference.main(["--config", str(path), "--logdir", str(logdir),
                    "--output_dir", str(out), "--device", "cpu"])
    pngs = sorted(out.rglob("*.png"))
    assert len(pngs) == 3
    for p in pngs:
        img = decode_png(p.read_bytes())
        assert img.shape == (64, 64, 3) and img.std() > 0
    monkeypatch.setattr(Trainer, "_fid_extractor", lambda self: lambda x: torch.cat(
        [x.mean((2, 3)), x.std((2, 3), correction=0)], dim=1))
    rows = evaluate.main(["--config", str(path), "--checkpoint_logdir", str(logdir),
                          "--metrics", "fid,kid,prdc", "--device", "cpu",
                          "--logdir", str(tmp_path / "eval")])
    names = {"FID", "best_FID", "KID", "PRDC_precision", "PRDC_recall", "PRDC_density",
             "PRDC_coverage"}
    assert [r["iteration"] for r in rows] == [2]
    assert names <= set(rows[0]) and all(np.isfinite(rows[0][n]) for n in names)
