"""The port's evaluation modules against the JAX package's on the CPU:
Inception-v3, the preprocessing, FID, KID and PRDC.

Weights are numpy-drawn from a seed into ``jax.eval_shape`` shapes and
written as the flat ``/``-keyed ``.npz`` that
``scripts/convert_weights.py inception_v3`` writes; each package reads it
through its own ``load_params``. The JAX graph runs as one jitted apply
a case (cheap CPU compile options), at (2, 75, 75, 3), the smallest
input the graph takes.

Tolerances:
- Inception-v3 features, fp32 and on bf16-rounded inputs: max-abs over
  the features' max magnitude 1e-5 (the same fp32 convolutions summed in
  other orders through ~50 layers);
- one ``BasicConv`` at running variances near its eps, and the padded
  average pool: atol 1e-6;
- ``preprocess_for_inception``: atol 3e-4 against JAX, 1e-6 against the
  port's own float64 run. The JAX resize sums in fp32 and lands up to
  7.4e-5 from float64 at 320 -> 299 (x2.2 after the normalization); the
  port's weights are formed in float64 and its fp32 result lands within
  2e-7 of float64;
- FID, KID, PRDC on the same activations: rtol 1e-9 (both are the same
  float64 numpy/scipy arithmetic), PRDC exactly; the real-stat cache:
  exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from imaginaire_tpu.evaluation import common as jcommon
from imaginaire_tpu.evaluation import fid as jfid
from imaginaire_tpu.evaluation import inception as jinc
from imaginaire_tpu.evaluation import kid as jkid
from imaginaire_tpu.evaluation import prdc as jprdc
from imaginaire_tpu_torch.evaluation import common, fid, inception, kid, prdc

CHEAP = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}
SMALLEST = (2, 75, 75, 3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def draw_inception(shapes, seed=0):
    """Kernels at std sqrt(2 / fan_in) (activations keep their scale);
    BatchNorm affines and statistics near the identity."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("bn_var", "bn_scale"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flat_npz(path, params):
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(params, ())
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def inception_pair(tmp_path_factory):
    shapes = jax.eval_shape(lambda: jinc.InceptionV3().init(
        jax.random.PRNGKey(0), jnp.zeros(SMALLEST)))
    path = tmp_path_factory.mktemp("inception") / "inception_v3.npz"
    flat_npz(path, jax.tree_util.tree_map(np.asarray, draw_inception(shapes)["params"]))
    jvars = jinc.load_params(str(path))
    apply = jax.jit(lambda v, x: jinc.InceptionV3().apply(v, x)).lower(
        jvars, jnp.zeros(SMALLEST)).compile(compiler_options=CHEAP)
    return jvars, apply, inception.load_params(str(path)), path


# ----------------------------------------------------------- Inception


def test_inception_matches_jax_fp32_and_bf16_rounded_input(inception_pair):
    jvars, apply, model, _ = inception_pair
    x = np.random.RandomState(0).uniform(-2, 2, SMALLEST).astype(np.float32)
    want = np.asarray(apply(jvars, jnp.asarray(x)))
    with torch.no_grad():
        got = model(nchw(x)).numpy()
    assert got.shape == want.shape == (2, 2048)
    assert rel_err(got, want) <= 1e-5
    # the extractors: the JAX one casts to bf16 and flax promotes to fp32
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    assert not np.array_equal(xb, x)
    want_b = np.asarray(apply(jvars, jnp.asarray(xb)))
    got_b = inception.make_extractor(model)(nchw(x))
    assert got_b.dtype == torch.float32
    assert rel_err(got_b.numpy(), want_b) <= 1e-5


def test_inception_parameter_count_and_paths(inception_pair):
    jvars, _, model, _ = inception_pair
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(jvars))
    assert n_jax == sum(p.numel() for p in model.parameters()) == 21_820_000
    assert not any(p.requires_grad for p in model.parameters())
    names = {n for n, _ in model.named_parameters()}
    assert {"Conv2d_1a_3x3.conv.weight", "Mixed_7c.branch_pool.bn_var",
            "Mixed_6e.branch7x7dbl_5.bn_mean"} <= names


def test_basic_conv_eps_and_padded_average_pool_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 9, 5).astype(np.float32)
    jmod = jinc.BasicConv(6, (3, 3), padding=((1, 1), (1, 1)))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = draw_inception(shapes, seed=2)["params"]
    # running variances near eps 1e-3: another eps would show
    params["bn_var"] = rng.uniform(0.5e-3, 2e-3, 6).astype(np.float32)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = inception.BasicConv(5, 6, 3, padding=1)
    from imaginaire_tpu_torch.bridge import load_flax_variables
    load_flax_variables(tmod, {"params": params})
    with torch.no_grad():
        got = tmod(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)
    # the branch pool counts the padding: border outputs are divided by 9
    pooled = inception._avg_pool3(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(pooled, np.asarray(jinc._avg_pool3(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(pooled[0, 0, 0], x[0, :2, :2].sum((0, 1)) / 9, atol=1e-6)
    # the max pools take no padding
    assert inception._max_pool3s2(nchw(x)).shape[-2:] == jinc._max_pool3s2(
        jnp.asarray(x)).shape[1:3] == (4, 4)


def test_load_params_missing_file_and_seeded_random_init(tmp_path, inception_pair):
    missing = tmp_path / "no" / "inception_v3.npz"
    with pytest.raises(FileNotFoundError, match=str(missing)):
        inception.load_params(str(missing))
    a = inception.load_params(str(missing), random_init=True, seed=3)
    b = inception.load_params(str(missing), random_init=True, seed=3)
    c = inception.load_params(str(missing), random_init=True, seed=4)
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["Mixed_5b.branch1x1.conv.weight"],
                           pc["Mixed_5b.branch1x1.conv.weight"])
    # a file, when present, wins over random_init
    _, _, model, path = inception_pair
    loaded = inception.load_params(str(path), random_init=True)
    assert torch.equal(loaded.Conv2d_1a_3x3.conv.weight, model.Conv2d_1a_3x3.conv.weight)


# ------------------------------------------------------- preprocessing


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (2, 320, 320, 4), (1, 256, 320, 3),
                                   (1, 299, 299, 3)],
                         ids=["grow", "shrink_4ch", "mixed", "same"])
def test_preprocess_for_inception_matches_jax(shape):
    x = np.random.RandomState(2).uniform(-1.2, 1.2, shape).astype(np.float32)
    want = np.asarray(jcommon.preprocess_for_inception(jnp.asarray(x)))
    got = common.preprocess_for_inception(nchw(x))
    assert tuple(got.shape) == (shape[0], 3, 299, 299) and got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=3e-4, rtol=0)
    exact = common.preprocess_for_inception(nchw(x).double())
    np.testing.assert_allclose(got.numpy(), exact.numpy(), atol=1e-6, rtol=0)


# -------------------------------------------------------------- metrics


def activations(seed, n=40, d=16, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d) @ rng.randn(d, d) * 0.3 + shift).astype(np.float32)


def test_fid_matches_jax_including_the_imaginary_part():
    real, fake = activations(3), activations(4, shift=0.2)
    mu1, s1 = fid.activation_stats(fake)
    mu2, s2 = fid.activation_stats(real)
    jm1, js1 = jfid.activation_stats(fake)
    np.testing.assert_array_equal(mu1, jm1)
    np.testing.assert_array_equal(s1, js1)
    want = jfid.calculate_frechet_distance(mu1, s1, mu2, s2)
    assert fid.calculate_frechet_distance(mu1, s1, mu2, s2) == pytest.approx(want, rel=1e-9)
    assert want > 0
    # a product with negative eigenvalues: sqrtm is complex, the real
    # part is taken (and reported) in both
    a, b = np.diag([1.0, 2.0]), np.array([[0.0, 1.0], [-1.0, 0.0]]) * 3
    want = jfid.calculate_frechet_distance(np.zeros(2), a, np.ones(2), b)
    assert fid.calculate_frechet_distance(np.zeros(2), a, np.ones(2), b) == \
        pytest.approx(want, rel=1e-9)


def test_fid_retries_a_non_finite_sqrtm_with_eps(monkeypatch):
    """The first sqrtm returns NaNs: both retry on the eps-offset
    covariances and agree."""
    from scipy import linalg

    sqrtm = linalg.sqrtm
    calls = []

    def failing_first(m, **kwargs):
        calls.append(m.copy())
        out = np.full_like(m, np.nan) if len(calls) == 1 else sqrtm(m)
        return (out, 1.0) if kwargs.get("disp") is False else out

    monkeypatch.setattr(linalg, "sqrtm", failing_first)
    real, fake = activations(5, n=8), activations(6, n=8)  # rank-deficient
    args = (*fid.activation_stats(fake), *fid.activation_stats(real))
    got = fid.calculate_frechet_distance(*args)
    assert len(calls) == 2 and not np.array_equal(calls[0], calls[1])  # eps retry
    calls.clear()
    want = jfid.calculate_frechet_distance(*args)
    assert len(calls) == 2
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("n_real,n_fake,subset", [(40, 30, 1000), (50, 50, 20)])
def test_kid_matches_jax(n_real, n_fake, subset):
    real, fake = activations(7, n=n_real), activations(8, n=n_fake, shift=0.1)
    got = kid.kid_from_activations(real, fake, num_subsets=10, subset_size=subset, seed=3)
    want = jkid.kid_from_activations(real, fake, num_subsets=10, subset_size=subset, seed=3)
    assert got == pytest.approx(want, rel=1e-9)
    assert kid.polynomial_mmd(real, fake) == pytest.approx(jkid.polynomial_mmd(real, fake),
                                                           rel=1e-9)


@pytest.mark.parametrize("n,k", [(40, 5), (3, 5)], ids=["k5", "k_clamped"])
def test_prdc_matches_jax(n, k):
    real, fake = activations(9, n=n), activations(10, n=n, shift=0.3)
    got = prdc.prdc_from_activations(real, fake, nearest_k=k)
    assert got == jprdc.prdc_from_activations(real, fake, nearest_k=k)
    assert set(got) == {"precision", "recall", "density", "coverage"}


def stub_extractor_jax(x):
    return jnp.concatenate([x.mean((1, 2)), x.std((1, 2))], axis=-1)


def stub_extractor(x):
    return torch.cat([x.mean((2, 3)), x.std((2, 3), correction=0)], dim=1)


def test_real_stat_cache_versions_match_jax(tmp_path):
    rng = np.random.RandomState(11)
    loader = [{"images": rng.uniform(-1, 1, (4, 24, 24, 3)).astype(np.float32)}
              for _ in range(3)]
    stats = {}
    for name, mod, ext in (("jax", jfid, stub_extractor_jax), ("port", fid, stub_extractor)):
        path = tmp_path / name / "real_stats.npz"
        path.parent.mkdir()
        # a stale cache (graph version 1) is recomputed and rewritten
        np.savez(path, mu=np.zeros(6), sigma=np.eye(6), graph_version=1)
        mu, sigma = mod.load_or_compute_stats(str(path), loader, "images", "fake_images", ext)
        npz = np.load(path)
        assert int(npz["graph_version"]) == 2
        np.testing.assert_array_equal(npz["mu"], mu)
        stats[name] = (mu, sigma)
        # a current one is read as it stands
        np.savez(path, mu=np.full(6, 7.0), sigma=np.eye(6), graph_version=2)
        mu2, _ = mod.load_or_compute_stats(str(path), loader, "images", "fake_images", ext)
        np.testing.assert_array_equal(mu2, np.full(6, 7.0))
    assert fid.FEATURE_GRAPH_VERSION == jfid.FEATURE_GRAPH_VERSION
    np.testing.assert_allclose(stats["port"][0], stats["jax"][0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(stats["port"][1], stats["jax"][1], atol=1e-5, rtol=0)
