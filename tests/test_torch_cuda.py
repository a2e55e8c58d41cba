"""The port's CUDA kernels on the card (skipped where there is no GPU).

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py sets up JAX.) Each kernel is
held against its plain PyTorch version, including the paths the serving
main paths do not take (spade_modulation: every path of its plan, at
planes of 256, 1024, 4096 and 16384 elements, at and just past what the
block path holds, a view 4 bytes past 16, a ragged plane, the most
(gamma, beta) pairs, and every block plan and the stream plan at 64x64
and 128x128; odd warp sizes, one
channel, bf16 flows; odd maps, several column tiles and displacement
groups, p other than 2), and its wrapper's refusals are checked. TF32
is off. spade_modulation: fp32 tolerance 1e-4 (reduction order); bf16
one ulp element by element against the plain version given the
kernel's statistics (both round at the same steps), the statistics
within 1e-5; its backward kernel, through autograd: fp32 dx 1e-5 and
dgamma 1e-6 of the plain output's magnitude, bf16 one ulp (dx one ulp
of the magnitude of the terms it sums). resample2d: fp32 1e-5 (the same fp32 steps),
bf16 1e-2 of the output's magnitude. channelnorm and correlation: fp32
1e-5 (sums of the same fp32 products in another order, fused
multiply-adds; correlation's products are 3xTF32 on the tensor cores,
within ~2^-22 of each fp32 product), bf16 1e-2 of the output's magnitude
(both round once, at the end; the rounding of an fp32 difference can
cross a bf16 step). The correlation kernel's build is also read: ptxas
reports no spills, and its SASS carries tensor-core (HMMA) and cp.async
(LDGSTS) instructions.
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from chip_smoke import MODULATION_EDGE, at_offset, bf16_ulps, dx_term_scale
from imaginaire_tpu_torch.layers.activation_norm import SpatiallyAdaptiveNorm
from imaginaire_tpu_torch.ops import build
from imaginaire_tpu_torch.ops import channelnorm as cn
from imaginaire_tpu_torch.ops import correlation as corr
from imaginaire_tpu_torch.ops import resample2d as rs
from imaginaire_tpu_torch.ops import spade_modulation as spade_mod
from imaginaire_tpu_torch.utils.init_weight import init_weights


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, n_pairs, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw(scale, shift=0.0):
        return (torch.randn(shape, generator=gen, device=device) * scale
                + shift).to(dtype)

    return (draw(2.0, 0.5), [draw(0.3) for _ in range(n_pairs)],
            [draw(0.3) for _ in range(n_pairs)])


# (shape, n_pairs, bytes x starts past a 16-byte boundary): the planes
# of each path, then chip_smoke's edge cases (the scalar path, the
# stream path, the block path's capacities, the most pairs at 128x128)
MODULATION_CASES = [
    ((2, 16, 16, 16), 1, 0),     # 256 elements: warp path
    ((2, 16, 16, 32), 1, 0),     # 512 elements: warp path, fp32's largest
    ((2, 16, 32, 32), 2, 0),     # 1024 elements: bf16 warp path, its largest
                                 # plane; fp32 a block of two warps
    ((2, 16, 64, 64), 1, 0),     # 4096 elements: block path
    ((1, 8, 128, 128), 2, 0),    # 16384 elements: block path (fp32 backward:
                                 # cluster 2)
    ((1, 2, 128, 256), 1, 0),    # 32768 elements: the bf16 forward's block
                                 # capacity
] + MODULATION_EDGE


def _modulation_inputs(shape, n_pairs, offset, dtype, device):
    x, gs, bs = _inputs(shape, n_pairs, dtype, device)
    return at_offset(x, offset), gs, bs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_pairs,offset", MODULATION_CASES)
def test_spade_modulation_kernel_matches_plain(cuda_device, shape, n_pairs,
                                               offset, dtype):
    x, gs, bs = _modulation_inputs(shape, n_pairs, offset, dtype, cuda_device)
    before = spade_mod.launches
    with torch.no_grad():
        got = spade_mod.spade_modulation(x, gs, bs)
        _, mean, rstd = spade_mod._launch_fwd(x, gs, bs, 1e-5)
    torch.cuda.synchronize()
    assert spade_mod.launches == before + 2
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        want = spade_mod.spade_modulation_plain(x, gs, bs)
        assert (got - want).abs().max().item() <= 1e-4
    else:
        # given the kernel's statistics, the plain version rounds at the
        # same steps: one bf16 ulp at most
        want = spade_mod.spade_modulation_plain(x, gs, bs, stats=(mean, rstd))
        assert bf16_ulps(got, want) <= 1.0
    for got_s, want_s in zip((mean, rstd), spade_mod.spade_modulation_stats_plain(x)):
        assert ((got_s - want_s).abs().max() / want_s.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_pairs,offset", MODULATION_CASES)
def test_spade_modulation_backward_kernel_matches_plain(cuda_device, shape,
                                                        n_pairs, offset, dtype):
    """Through autograd: dx and every dgamma from the backward kernel,
    every dbeta = g; held as chip_smoke.py holds them."""
    x, gs, bs = _modulation_inputs(shape, n_pairs, offset, dtype, cuda_device)
    g = _inputs(shape, 1, dtype, cuda_device, seed=1)[0]
    leaves = [t.requires_grad_(True) for t in (x, *gs, *bs)]
    before = (spade_mod.launches, spade_mod.bwd_launches)
    out = spade_mod.spade_modulation(x, gs, bs)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (spade_mod.launches, spade_mod.bwd_launches) == (before[0] + 1, before[1] + 1)
    mean, rstd = spade_mod.spade_modulation_stats_plain(x.detach())
    dx, dgamma = spade_mod.spade_modulation_bwd_plain(
        x.detach(), [t.detach() for t in gs], mean, rstd, g)
    for t in grads:
        assert t.dtype == dtype and t.shape == x.shape
    for t in grads[1 + n_pairs:]:
        assert torch.equal(t, g)
    if dtype == torch.float32:
        assert ((grads[0] - dx).abs().max() / dx.abs().max()).item() <= 1e-5
        for t in grads[1:1 + n_pairs]:
            assert ((t - dgamma).abs().max() / dgamma.abs().max()).item() <= 1e-6
    else:
        scale = dx_term_scale(x.detach(), [t.detach() for t in gs], mean, rstd, g)
        assert bf16_ulps(grads[0], dx, scale) <= 1.0
        for t in grads[1:1 + n_pairs]:
            assert bf16_ulps(t, dgamma) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("bad,error", [
    ("pairs", ValueError), ("strided", ValueError), ("half", TypeError),
    ("mixed", ValueError), ("plan", RuntimeError),
    ("misaligned_plan", RuntimeError), ("cluster_plan", RuntimeError),
    ("backward_plan", RuntimeError)])
def test_spade_modulation_wrapper_refuses(cuda_device, bad, error):
    x, gs, bs = _inputs((1, 2, 8, 8), 1, torch.float32, cuda_device)
    call = lambda: spade_mod.spade_modulation(x, gs, bs)  # noqa: E731
    if bad == "pairs":
        gs, bs = gs * 5, bs * 5
    elif bad == "strided":
        x = x.transpose(2, 3)
    elif bad == "half":
        x, gs, bs = x.half(), [g.half() for g in gs], [b.half() for b in bs]
    elif bad == "mixed":
        gs = [gs[0].to(torch.bfloat16)]
    elif bad == "plan":  # a warp plan whose lanes cannot hold the plane
        x, gs, bs = _inputs((1, 2, 64, 64), 1, torch.float32, cuda_device)
        plan = dict(spade_mod.modulation_plan(2, 4096, torch.float32),
                    path=spade_mod.PATHS["warp"], per_thread=4, threads=64,
                    planes_per_block=2, grid=1)
        call = lambda: spade_mod._launch_fwd(x, gs, bs, 1e-5, plan)  # noqa: E731
    elif bad == "misaligned_plan":  # 16-byte vectors on a view 4 bytes past 16
        x = at_offset(x, 4)
        plan = spade_mod.modulation_plan(2, 64, torch.float32)
        call = lambda: spade_mod._launch_fwd(x, gs, bs, 1e-5, plan)  # noqa: E731
    elif bad == "cluster_plan":  # the forward splits no plane over a cluster
        x, gs, bs = _inputs((1, 2, 128, 128), 1, torch.float32, cuda_device)
        plan = dict(spade_mod.modulation_plan(2, 16384, torch.float32),
                    cluster=2, threads=512, grid=4)
        call = lambda: spade_mod._launch_fwd(x, gs, bs, 1e-5, plan)  # noqa: E731
    else:  # a backward block plan of more threads than its register bound
        x, gs, bs = _inputs((1, 2, 64, 64), 1, torch.float32, cuda_device)
        mean, rstd = spade_mod.spade_modulation_stats_plain(x)
        plan = dict(spade_mod.modulation_plan(2, 4096, torch.float32, backward=True),
                    threads=1024, cluster=1, grid=2)
        call = lambda: spade_mod._launch_bwd(x, gs, mean, rstd, x, plan)  # noqa: E731
    before = (spade_mod.launches, spade_mod.bwd_launches)
    with pytest.raises(error):
        call()
    assert (spade_mod.launches, spade_mod.bwd_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", [(2, 4, 64, 64), (2, 4, 128, 128)])
def test_spade_modulation_block_plans_match_plain(cuda_device, shape, backward,
                                                  dtype):
    """Every cluster of the block path that can hold the plane, and the
    stream path, launched through the C interface, against the plain
    version: the cluster reduction and each vector instantiation the plan
    may pick at these planes."""
    x, gs, bs = _inputs(shape, 1, dtype, cuda_device)
    g = _inputs(shape, 1, dtype, cuda_device, seed=1)[0]
    b, c, h, w = shape
    mean_p, rstd_p = spade_mod.spade_modulation_stats_plain(x)
    dx_p, dgamma_p = spade_mod.spade_modulation_bwd_plain(x, gs, mean_p, rstd_p, g)
    plans = []
    for cluster in spade_mod.block_clusters(dtype, backward):
        try:
            plans.append(spade_mod.modulation_plan(b * c, h * w, dtype, 1,
                                                   backward=backward, cluster=cluster))
        except ValueError:
            continue  # this cluster cannot hold the plane
    stream = spade_mod.modulation_plan(b * c, h * w, dtype, 1, backward=backward)
    plans.append(dict(stream, route="stream", path=spade_mod.PATHS["stream"],
                      per_thread=0, cluster=1, planes_per_block=1, grid=b * c,
                      threads=spade_mod.STREAM_THREADS))
    assert len(plans) >= 2  # a block plan and the stream plan
    for plan in plans:
        block = (plan["route"], plan["cluster"])
        if not backward:
            got, mean, rstd = spade_mod._launch_fwd(x, gs, bs, 1e-5, plan)
            torch.cuda.synchronize()
            for got_s, want_s in zip((mean, rstd), (mean_p, rstd_p)):
                assert ((got_s - want_s).abs().max() / want_s.abs().max()).item() <= 1e-5
            if dtype == torch.float32:
                want = spade_mod.spade_modulation_plain(x, gs, bs)
                assert (got - want).abs().max().item() <= 1e-4, block
            else:
                want = spade_mod.spade_modulation_plain(x, gs, bs, stats=(mean, rstd))
                assert bf16_ulps(got, want) <= 1.0, block
        else:
            dx, dgamma = spade_mod._launch_bwd(x, gs, mean_p, rstd_p, g, plan)
            torch.cuda.synchronize()
            if dtype == torch.float32:
                assert ((dx - dx_p).abs().max() / dx_p.abs().max()).item() <= 1e-5, block
                assert ((dgamma - dgamma_p).abs().max()
                        / dgamma_p.abs().max()).item() <= 1e-6, block
            else:
                scale = dx_term_scale(x, gs, mean_p, rstd_p, g)
                assert bf16_ulps(dx, dx_p, scale) <= 1.0, block
                assert bf16_ulps(dgamma, dgamma_p) <= 1.0, block


@pytest.mark.cuda
def test_spade_modulation_kernels_do_not_spill(cuda_device):
    lib = build.build_all([spade_mod.KERNEL])[spade_mod.KERNEL]
    log = Path(f"{lib}.log").read_text()
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
    assert spills and all(n == "0" for n in spills), log


@pytest.mark.cuda
def test_spade_layer_fused_equals_unfused_on_card(cuda_device):
    with torch.device(cuda_device):
        norm = SpatiallyAdaptiveNorm(32, [6], num_filters=16, kernel_size=5,
                                     base_norm="instance",
                                     weight_norm_type="spectral").eval()
    init_weights(norm, torch.Generator(device=cuda_device).manual_seed(1))
    x = torch.randn(2, 32, 32, 32, device=cuda_device)
    seg = torch.randn(2, 6, 64, 64, device=cuda_device)
    before = spade_mod.launches
    with torch.no_grad():
        fused = norm(x, seg)
        norm.fused_modulation = "none"
        unfused = norm(x, seg)
    assert spade_mod.launches == before + 1
    assert (fused - unfused).abs().max().item() <= 1e-4


def _warp_inputs(shape, dtype, flow_dtype, device, seed=0, scale=None):
    """x and a flow mixing fractional, integer, zero and out-of-frame
    displacements (or, given ``scale``, fractional ones up to that many
    pixels)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, _, h, w = shape
    x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).to(dtype)
    frac = torch.rand((b, 2, h, w), generator=gen, device=device) * 6 - 3
    if scale is not None:
        return x, (frac * (scale / 3)).to(flow_dtype)
    kind = torch.randint(0, 4, (b, 1, h, w), generator=gen, device=device)
    far = torch.tensor([1.5 * w, -1.5 * h], device=device).view(1, 2, 1, 1)
    flow = torch.where(kind == 0, frac, torch.where(
        kind == 1, frac.round(), torch.where(kind == 2, 0 * frac, far + 0 * frac)))
    return x, flow.to(flow_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,flow_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape,x_offset,flow_offset,scale", [
    ((1, 1, 37, 53), 0, 0, None),
    ((2, 3, 37, 53), 0, 0, None),
    ((3, 5, 1, 7), 0, 0, None),        # H = 1, C = 5
    ((1, 2, 9, 1027), 0, 0, None),     # W not a multiple of the tile
    ((2, 3, 40, 300), 4, 4, None),     # x and flow 4 bytes past 16
    ((1, 3, 64, 256), 0, 4, None),     # the flow alone past 16
    ((2, 2, 48, 520), 0, 0, 300.0),    # flows far larger than a tile
    ((1, 3, 512, 1024), 0, 0, None),   # the vid2vid warp
    ((6, 3, 512, 1024), 0, 0, None),   # the teacher's warps
])
def test_resample2d_kernel_matches_plain(cuda_device, shape, x_offset,
                                         flow_offset, scale, dtype, flow_dtype):
    x, flow = _warp_inputs(shape, dtype, flow_dtype, cuda_device, scale=scale)
    x, flow = at_offset(x, x_offset), at_offset(flow, flow_offset)
    before = rs.launches
    with torch.no_grad():
        got = rs.resample2d(x, flow)
    torch.cuda.synchronize()
    assert rs.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = rs.resample2d_plain(x, flow).float()
    err = (got.float() - want).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5, err
    else:
        assert err <= 1e-2 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("bad,error", [
    ("grad", NotImplementedError), ("strided_x", ValueError),
    ("strided_flow", ValueError), ("half", TypeError), ("cpu_flow", ValueError)])
def test_resample2d_wrapper_refuses(cuda_device, bad, error):
    x, flow = _warp_inputs((1, 3, 8, 8), torch.float32, torch.float32, cuda_device)
    if bad == "grad":
        flow.requires_grad_(True)
    elif bad == "strided_x":
        x = x.transpose(2, 3)
    elif bad == "strided_flow":
        flow = flow.transpose(2, 3)
    elif bad == "half":
        x = x.half()
    else:
        flow = flow.cpu()
    before = rs.launches
    with pytest.raises(error):
        rs.resample2d(x, flow)
    assert rs.launches == before


def _held_to_plain(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-5, err
    else:
        assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,p,offset", [
    ((1, 1, 5, 7), 2, 0), ((2, 5, 3, 3), 1, 0), ((2, 5, 3, 3), 3, 0),
    ((3, 2, 37, 53), 2, 0), ((1, 3, 512, 1024), 2, 0),
    ((2, 3, 5, 7), 2, 0),       # H W = 35: not a multiple of the vector
    ((2, 3, 8, 16), 2, 4),      # a contiguous view 4 bytes past 16
    ((1, 2, 6, 10), 3, 4)])     # both, p = 3
def test_channelnorm_kernel_matches_plain(cuda_device, shape, p, offset, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 3).to(dtype)
    x = at_offset(x, offset)
    before = cn.launches
    with torch.no_grad():
        got = cn.channelnorm(x, p)
    torch.cuda.synchronize()
    assert cn.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], 1) + shape[2:]
    _held_to_plain(got, cn.channelnorm_plain(x, p), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pad,md,s2", [
    ((1, 8, 7, 9), 2, 2, 1),         # odd map, one tile
    ((2, 16, 13, 17), 4, 4, 2),
    ((1, 256, 8, 12), 20, 20, 2),    # most displacements in the padding
    ((1, 3, 5, 300), 6, 4, 1),       # three column tiles, pad > md
    ((2, 5, 6, 40), 13, 13, 1),      # 27 displacements: two groups
    ((1, 40, 9, 130), 20, 20, 2),    # W not a multiple of the tile
    ((1, 16, 6, 5), 2, 2, 1),        # W smaller than one m16 tile
    ((1, 1, 7, 20), 2, 2, 1),        # C = 1
    ((2, 33, 5, 24), 4, 4, 2),       # C = 33: a partial channel chunk
    ((2, 8, 5, 21), 0, 0, 1),        # max_displacement 0: n_d = 1
    ((1, 16, 9, 37), 8, 8, 4),       # stride2 4
    ((3, 16, 6, 20), 4, 4, 2),       # B = 3
    ((1, 8, 6, 40), 17, 17, 17),     # stride2 17: two phase groups a tile
    ((2, 5, 7, 70), 34, 34, 17),     # stride2 17, 5 displacements
    ((1, 8, 5, 70), 64, 64, 32),     # stride2 32: a ring of 2 stages
    ((2, 6, 6, 11), 5, 5, 2),        # md 5, s2 2: 6 steps, -5 .. 5
    ((6, 256, 64, 128), 20, 20, 2),  # the teacher's attach
    ((1, 8, 4, 2048), 650, 650, 65),  # stride2 65: fp32 takes the direct path
    ((2, 16, 6, 300), 182, 182, 91),  # stride2 91
])
def test_correlation_kernel_matches_plain(cuda_device, shape, pad, md, s2, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x1 = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    x2 = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    kw = dict(pad_size=pad, max_displacement=md, stride2=s2)
    before = corr.launches
    with torch.no_grad():
        got = corr.correlation(x1, x2, **kw)
    torch.cuda.synchronize()
    assert corr.launches == before + 1
    n_d = 2 * md // s2 + 1
    assert got.dtype == dtype and got.shape == (shape[0], n_d * n_d) + shape[2:]
    _held_to_plain(got, corr.correlation_plain(x1, x2, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bad,error", [
    ("grad", NotImplementedError), ("strided", ValueError),
    ("half", TypeError)])
def test_channelnorm_wrapper_refuses(cuda_device, bad, error):
    x = torch.randn(1, 3, 8, 8, device=cuda_device)
    if bad == "grad":
        x.requires_grad_(True)
    elif bad == "strided":
        x = x.transpose(2, 3)
    else:
        x = x.half()
    before = cn.launches
    with pytest.raises(error):
        cn.channelnorm(x)
    assert cn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bad,error", [
    ("grad", NotImplementedError), ("strided", ValueError),
    ("half", TypeError), ("mixed", TypeError), ("cpu_x2", ValueError)])
def test_correlation_wrapper_refuses(cuda_device, bad, error):
    x1 = torch.randn(1, 4, 8, 8, device=cuda_device)
    x2 = torch.randn(1, 4, 8, 8, device=cuda_device)
    if bad == "grad":
        x2.requires_grad_(True)
    elif bad == "strided":
        x1 = x1.transpose(2, 3)
    elif bad == "half":
        x1, x2 = x1.half(), x2.half()
    elif bad == "mixed":
        x2 = x2.bfloat16()
    else:
        x2 = x2.cpu()
    before = corr.launches
    with pytest.raises(error):
        corr.correlation(x1, x2, pad_size=2, max_displacement=2, stride2=1)
    assert corr.launches == before


@pytest.mark.cuda
def test_empty_inputs_launch_nothing(cuda_device):
    before = (cn.launches, corr.launches)
    x = torch.empty(0, 3, 4, 4, device=cuda_device)
    assert cn.channelnorm(x).shape == (0, 1, 4, 4)
    out = corr.correlation(x, x, pad_size=2, max_displacement=2, stride2=1)
    assert out.shape == (0, 25, 4, 4)
    assert (cn.launches, corr.launches) == before


def _correlation_library():
    return build.build_all([corr.KERNEL])[corr.KERNEL]


@pytest.mark.cuda
def test_correlation_kernel_does_not_spill(cuda_device):
    log = Path(f"{_correlation_library()}.log").read_text()
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)", log)
    assert spills and all(n == "0" for n in spills), log


@pytest.mark.cuda
def test_correlation_kernel_uses_tensor_cores_and_cp_async(cuda_device):
    tool = shutil.which("cuobjdump") or str(Path(build.find_nvcc()).parent / "cuobjdump")
    if not Path(tool).is_file():
        pytest.skip("the CUDA toolkit here has no cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_correlation_library())],
                          capture_output=True, text=True, check=True).stdout
    assert "HMMA" in sass and "LDGSTS" in sass
