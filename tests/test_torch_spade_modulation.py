"""The port's fused SPADE modulation against the JAX package's op.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it on the CPU: the 'jnp' composition
and the Pallas kernel in interpret mode ('pallas_interpret', at <= 32^2
spatial). On the CPU the port's wrapper takes its plain version; the
CUDA kernel is held to that plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: fp32 atol 1e-5 (the two packages reduce the statistics in a
different order); bf16 2e-2 of the output's max magnitude (a few bf16
roundings, which the two frameworks place differently).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imaginaire_tpu.ops.spade_modulation import spade_modulation as jax_spade_modulation
from imaginaire_tpu_torch.ops import build
from imaginaire_tpu_torch.ops import spade_modulation as spade_mod

SHAPES = [((2, 16, 16, 8), 1), ((2, 32, 32, 4), 2)]  # NHWC, n_pairs


def _case(shape, n_pairs, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    gs = [(rng.randn(*shape) * 0.3).astype(np.float32) for _ in range(n_pairs)]
    bs = [(rng.randn(*shape) * 0.3).astype(np.float32) for _ in range(n_pairs)]
    return x, gs, bs


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape,n_pairs", SHAPES)
def test_plain_matches_jax_fp32(impl, shape, n_pairs):
    x, gs, bs = _case(shape, n_pairs)
    want = np.asarray(jax_spade_modulation(
        jnp.asarray(x), [jnp.asarray(g) for g in gs],
        [jnp.asarray(b) for b in bs], implementation=impl))
    got = spade_mod.spade_modulation(_nchw(x), [_nchw(g) for g in gs],
                                     [_nchw(b) for b in bs])
    np.testing.assert_allclose(_nhwc(got), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("shape,n_pairs", SHAPES)
def test_plain_matches_jax_bf16(impl, shape, n_pairs):
    x, gs, bs = _case(shape, n_pairs, seed=1)
    bf = jnp.bfloat16
    want = np.asarray(jax_spade_modulation(
        jnp.asarray(x, bf), [jnp.asarray(g, bf) for g in gs],
        [jnp.asarray(b, bf) for b in bs], implementation=impl)).astype(np.float32)
    got = spade_mod.spade_modulation(
        _nchw(x, torch.bfloat16), [_nchw(g, torch.bfloat16) for g in gs],
        [_nchw(b, torch.bfloat16) for b in bs])
    assert got.dtype == torch.bfloat16
    err = np.abs(_nhwc(got) - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    x, gs, bs = _case((1, 8, 8, 3), 2)
    before = spade_mod.launches
    args = (_nchw(x), [_nchw(g) for g in gs], [_nchw(b) for b in bs])
    got = spade_mod.spade_modulation(*args)
    assert torch.equal(got, spade_mod.spade_modulation_plain(*args))
    assert spade_mod.launches == before


@pytest.mark.parametrize("bad", ["shape", "count", "empty", "rank"])
def test_wrapper_rejects_malformed_inputs(bad):
    x = torch.zeros(1, 2, 4, 4)
    g = [torch.zeros(1, 2, 4, 4)]
    b = [torch.zeros(1, 2, 4, 4)]
    if bad == "shape":
        g = [torch.zeros(1, 2, 1, 1)]  # AdaIN-style broadcast maps refuse
    elif bad == "count":
        b = b * 2
    elif bad == "empty":
        g, b = [], []
    else:
        x = torch.zeros(2, 4, 4)
    with pytest.raises(ValueError):
        spade_mod.spade_modulation(x, g, b)


def test_kernel_source_and_build_command():
    src = build.source_path(spade_mod.KERNEL).read_text()
    assert int(re.search(r"#define SPADE_MAX_PAIRS (\d+)", src).group(1)) \
        == spade_mod.MAX_PAIRS
    assert "spade_modulation_fwd_pallas" in src  # names the TPU kernel it replaces
    cmd = build.nvcc_command("nvcc", "k.cu", "k.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in cmd
    lib = build.library_path(spade_mod.KERNEL)
    assert lib.parent == build.BUILD_DIR and lib.suffix == ".so"


def test_build_reports_missing_toolkit(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    if (build.Path("/usr/local/cuda/bin/nvcc")).is_file():
        assert build.find_nvcc() == "/usr/local/cuda/bin/nvcc"
    else:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.build_all([spade_mod.KERNEL])
        assert not (tmp_path / "build").exists() or not any(
            (tmp_path / "build").glob("*.so"))
    with pytest.raises(FileNotFoundError):
        build.build_all(["no_such_kernel"])


# modulation_plan: the kernels' launch, chosen on the CPU. The 7 shapes
# of a bs-4 SPADE forward at COCO-Stuff width (chip_smoke.MODULATION_SHAPES)
# and the route (and cluster) each takes, bf16 and fp32, in both
# directions: a warp a plane up to 128 vectors (1024 bf16, 512 fp32
# elements), one block a plane above, a cluster of 2 only for the fp32
# backward at 128x128, which one block cannot hold.
MAIN_PATH_PLANS = [
    ((4, 2048, 16, 16), "warp", "warp"), ((4, 2048, 32, 32), "warp", "block"),
    ((4, 1024, 32, 32), "warp", "block"), ((4, 1024, 64, 64), "block", "block"),
    ((4, 512, 64, 64), "block", "block"), ((4, 512, 128, 128), "block", "block"),
    ((4, 256, 128, 128), "block", "block")]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,bf16_route,fp32_route", MAIN_PATH_PLANS)
def test_plan_main_path_shapes(shape, bf16_route, fp32_route, dtype, backward):
    b, c, h, w = shape
    route = bf16_route if dtype == torch.bfloat16 else fp32_route
    plan = spade_mod.modulation_plan(b * c, h * w, dtype, 1, True, backward)
    assert plan["route"] == route and plan["path"] == spade_mod.PATHS[route]
    assert plan["vec"] == 16 // dtype.itemsize  # 16-byte vectors
    fp32_bwd_128 = dtype == torch.float32 and backward and h == 128
    assert plan["cluster"] == (2 if fp32_bwd_128 else 1)
    _assert_covers(plan, b * c, h * w, backward)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("plane,aligned", [
    (63, True),         # the ragged (3, 5, 7, 9)
    (1020, True),       # H W not a multiple of 8: bf16 ragged, fp32 not
    (1024, False),      # a view 4 bytes past 16
    (16384, False),
    (65536 + 4, True)])
def test_plan_misaligned_or_ragged_takes_scalar(plane, aligned, dtype, backward):
    plan = spade_mod.modulation_plan(10, plane, dtype, 2, aligned, backward)
    native = 16 // dtype.itemsize
    if aligned and plane % native == 0:
        assert plan["vec"] == native
    else:
        assert plan["route"] == "stream" and plan["vec"] == 1
    _assert_covers(plan, 10, plane, backward)


def _assert_covers(plan, n_planes, plane, backward):
    """The plan's index map covers every vector of every plane, and the
    plan keeps the card's limits and the kernels' register bounds."""
    vec, threads = plan["vec"], plan["threads"]
    pv = plane // vec
    assert pv * vec == plane
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert plan["cluster"] in (1, 2, 4)           # portable cluster sizes
    assert threads * plan["cluster"] <= 1024      # one warp partial a lane
    assert plan["grid"] <= 2 ** 31 - 1
    if plan["route"] == "warp":
        assert plan["planes_per_block"] == threads // 32 and plan["cluster"] == 1
        assert plan["grid"] * plan["planes_per_block"] >= n_planes
        group = 32
    elif plan["route"] == "block":
        assert plan["planes_per_block"] == 1
        assert plan["grid"] == n_planes * plan["cluster"]
        assert plan["per_thread"] == spade_mod.BLOCK_PER_THREAD
        group = threads * plan["cluster"]
    else:
        assert plan["grid"] == n_planes and plan["cluster"] == 1
        assert threads <= spade_mod.STREAM_THREADS
        return  # a loop over the plane: covers any size
    assert threads <= spade_mod.max_threads(plan["per_thread"], 3 if backward else 1)
    held = np.concatenate([np.arange(group) + j * group
                           for j in range(plan["per_thread"])])
    assert np.array_equal(np.sort(held[held < pv]), np.arange(pv))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_block_capacity_boundary(dtype, backward):
    """The largest plane the block path holds takes it; one vector more
    streams."""
    native = 16 // dtype.itemsize
    per_thread = spade_mod.BLOCK_PER_THREAD
    bound = spade_mod.max_threads(per_thread, 3 if backward else 1)
    capacity = max(native * per_thread * c * min(bound, 1024 // c)
                   for c in spade_mod.block_clusters(dtype, backward))
    at = spade_mod.modulation_plan(8, capacity, dtype, 1, True, backward)
    past = spade_mod.modulation_plan(8, capacity + native, dtype, 1, True, backward)
    assert at["route"] == "block" and past["route"] == "stream"
    _assert_covers(at, 8, capacity, backward)
    _assert_covers(past, 8, capacity + native, backward)


@pytest.mark.parametrize("plane", [1, 8, 256, 264, 1024, 1032, 4096, 4104,
                                   16384, 40960, 262144])
@pytest.mark.parametrize("n_planes", [1, 7, 8192])
def test_plan_sweep_keeps_limits(plane, n_planes):
    for dtype in DTYPES:
        for backward in (False, True):
            for aligned in (False, True):
                plan = spade_mod.modulation_plan(n_planes, plane, dtype, 1, aligned,
                                                 backward)
                _assert_covers(plan, n_planes, plane, backward)


def test_plan_refuses_what_the_kernels_cannot_take():
    with pytest.raises(TypeError):
        spade_mod.modulation_plan(4, 256, torch.float16)
    with pytest.raises(ValueError):
        spade_mod.modulation_plan(4, 256, torch.float32, n_pairs=5)
    with pytest.raises(ValueError):  # a grid past 2**31 - 1 blocks
        spade_mod.modulation_plan(2 ** 31, 4096, torch.float32)
    with pytest.raises(ValueError):  # a block plan that cannot hold the plane
        spade_mod.modulation_plan(4, 65536, torch.float32, cluster=1)
    for dtype, backward in ((torch.float32, False), (torch.bfloat16, False),
                            (torch.bfloat16, True)):  # no cluster there
        with pytest.raises(ValueError):
            spade_mod.modulation_plan(4, 16384, dtype, backward=backward, cluster=2)


def test_plan_mirrors_the_kernel_source():
    """PLAN_FIELDS, the register bound table, the block path's vectors a
    thread and its clusters are the C source's."""
    src = build.source_path(spade_mod.KERNEL).read_text()
    fields = re.search(r"struct Plan \{[^\n]*\n\s*int ([^;]+);", src).group(1)
    assert tuple(f.strip() for f in fields.split(",")) == spade_mod.PLAN_FIELDS
    bound = int(re.search(r"return nv \* arrays \* 4 <= (\d+) \? 1024 : 512;",
                          src).group(1))
    for nv in spade_mod.WARP_PER_THREAD + (spade_mod.BLOCK_PER_THREAD,):
        for arrays in (1, 3):
            want = 1024 if 4 * nv * arrays <= bound else 512
            assert spade_mod.max_threads(nv, arrays) == want
    cl, elem = map(int, re.search(
        r"return cluster == 1 \|\| \(cluster == (\d) && backward && "
        r"elem_bytes == (\d)\);", src).groups())
    for dtype in DTYPES:
        for backward in (False, True):
            want = (1, cl) if backward and dtype.itemsize == elem else (1,)
            assert spade_mod.block_clusters(dtype, backward) == want
    assert f"#define SPADE_BLOCK_NV {spade_mod.BLOCK_PER_THREAD} " in src
    assert f"#define SPADE_STREAM_THREADS {spade_mod.STREAM_THREADS}" in src
    assert f"#define SPADE_PLAN_LEN {len(spade_mod.PLAN_FIELDS)}" in src
