"""The port's serving engine on the CPU, at a tiny width.

Covers what the engine decides on the host: settings parsed as the JAX
parser parses them, chunking to the configured batch sizes with zero pad
lanes sliced off, request order, per-lane noise that does not depend on
batch-mates, queue backpressure and batching-window logic, the device
rule and the config-type resolver. The generator's numbers are held to
the JAX package in test_torch_spade_generator.py.
"""

import numpy as np
import pytest
import torch

from imaginaire_tpu.config import Config as JaxConfig
from imaginaire_tpu.serving.engine import serving_settings as jax_serving_settings
from imaginaire_tpu_torch import registry
from imaginaire_tpu_torch.config import Config
from imaginaire_tpu_torch.serving.engine import (
    ServeRequest,
    ServingError,
    engine_from_config,
    serving_settings,
)
from imaginaire_tpu_torch.utils.misc import resolve_device


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side runs on one CPU thread: the suite runs several
    test processes at once, and intra-op threads of each would contend
    for the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


UNIT = "configs/unit_test/spade.yaml"
TINY = dict(gen=dict(num_filters=2, style_dims=4, style_enc=dict(num_filters=2),
                     activation_norm_params=dict(num_filters=2)),
            inference_args=dict(random_style=True))
LABELS = 14


def _label(seed, hw=256):
    idx = np.random.RandomState(seed).randint(0, LABELS, (1, hw, hw))
    return np.eye(LABELS, dtype=np.float32)[idx]


def _requests(n, first_seed=0):
    return [ServeRequest({"label": _label(first_seed + i)}, seed=100 + i)
            for i in range(n)]


@pytest.fixture(scope="module")
def engine():
    eng = engine_from_config(Config(UNIT, overrides=TINY), device="cpu")
    eng.initialize({"label": np.zeros((1, 256, 256, LABELS), np.float32)}, seed=0)
    return eng


@pytest.mark.parametrize("serving", [
    None,
    {"buckets": [[256, 256], {"hw": [128, 256], "batch_sizes": [2]}],
     "batch_sizes": [1, 8], "queue_timeout_ms": 2.5, "max_queue": 9, "seed": 7}])
def test_serving_settings_agree_with_jax(serving):
    overrides = {"serving": serving} if serving else None
    want = jax_serving_settings(JaxConfig(UNIT, overrides=overrides))
    got = serving_settings(Config(UNIT, overrides=overrides))
    for key in got:
        if key == "buckets":
            assert [(b.height, b.width, b.batch_sizes) for b in got[key]] == \
                [(b.height, b.width, b.batch_sizes) for b in want[key]]
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("serving", [{"compute_dtype": "bfloat16"},
                                     {"buckets": [{"hw": [64, 64], "remat": "blocks"}]}])
def test_serving_settings_refuse_unported_overrides(serving):
    with pytest.raises(ServingError):
        serving_settings(Config(UNIT, overrides={"serving": serving}))


def test_warm_runs_every_bucket_and_batch_size(engine):
    assert sorted(engine.warm()) == ["serve/spade/256x256/bs1",
                                     "serve/spade/256x256/bs4"]


def test_seven_requests_chunk_into_four_and_padded_three(engine):
    before = dict(batches=engine._batches, total=engine._lane_total,
                  padded=engine._lane_padded)
    reqs = _requests(7)
    images = engine.serve(reqs)
    assert engine._batches - before["batches"] == 2
    assert engine._lane_total - before["total"] == 8
    assert engine._lane_padded - before["padded"] == 1
    assert len(images) == 7
    for img in images:
        assert img.shape == (256, 256, 3) and np.isfinite(img).all()
        assert np.abs(img).max() <= 1.0
    # request order: each image is its own request's, not a batch-mate's
    assert all(not np.array_equal(images[i], images[i + 1]) for i in range(6))

    # a request served alone (bs 1) matches its lane in the padded chunk;
    # atol 1e-4: the two batch sizes may take different conv algorithms
    alone = engine.serve([ServeRequest({"label": _label(5)}, seed=105)])[0]
    np.testing.assert_allclose(alone, images[5], atol=1e-4, rtol=0)


def test_lane_output_is_the_generator_with_the_request_noise(engine):
    req = _requests(1, first_seed=9)[0]
    got = engine.serve([req])[0]
    noise = torch.randn(1, 4, generator=torch.Generator().manual_seed(req.seed))
    label = torch.from_numpy(req.data["label"]).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        want = engine.trainer.net_G.inference({"label": label}, random_style=True,
                                              noise=noise)
    np.testing.assert_allclose(got, want[0].permute(1, 2, 0).numpy(), atol=1e-6)


def test_queue_overflow_and_batching_window():
    cfg = Config(UNIT, overrides=dict(TINY, serving={"max_queue": 2,
                                                     "queue_timeout_ms": 1e6}))
    eng = engine_from_config(cfg, device="cpu")
    with pytest.raises(ServingError, match="initialize"):
        eng.warm()
    reqs = _requests(3)
    eng.submit(reqs[0])
    assert not eng.queue.due()
    assert eng.pump() == {}
    eng.submit(reqs[1])
    with pytest.raises(ServingError, match="overflow"):
        eng.submit(reqs[2])
    assert eng.queue.depth == 2
    assert eng.queue.due(now=reqs[0].t_submit + 1e4)  # past the window


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        engine_from_config(Config(UNIT, overrides=TINY))


def test_config_types_resolve_to_the_port():
    assert registry.port_module_name("imaginaire_tpu.trainers.spade") == \
        "imaginaire_tpu_torch.trainers.spade"
    assert registry.port_module_name("imaginaire.generators.spade") == \
        "imaginaire_tpu_torch.models.generators.spade"
    with pytest.raises(ValueError):
        registry.port_module_name("somewhere.else")
    assert registry.resolve("imaginaire_tpu.trainers.vid2vid", "Trainer") \
        .__module__ == "imaginaire_tpu_torch.trainers.vid2vid"
    with pytest.raises(ModuleNotFoundError, match="ROADMAP"):
        registry.resolve("imaginaire_tpu.trainers.pix2pixHD", "Trainer")
