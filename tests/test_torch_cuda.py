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
bf16 1e-2 of the output's magnitude; its backward: dflow bit for bit
(the same fp32 steps in the same order), dx (fp32 atomics) element by
element fp32 1e-5 and bf16 one ulp of the magnitude of the terms summed. channelnorm and correlation: fp32
1e-5 (sums of the same fp32 products in another order, fused
multiply-adds; correlation's products are 3xTF32 on the tensor cores,
within ~2^-22 of each fp32 product), bf16 1e-2 of the output's magnitude
(both round once, at the end; the rounding of an fp32 difference can
cross a bf16 step). The correlation kernel's build is also read: ptxas
reports no spills, and its SASS carries tensor-core (HMMA) and cp.async
(LDGSTS) instructions. Evaluation: Inception-v3 on the card against its
CPU run (1e-3 of the features' magnitude), and the averaged copy's
BatchNorm re-estimation through the modulation kernel against the plain
composition (1e-4). fs-vid2vid: the hyper-SPADE generator through the
modulation kernel's re-reading path against the plain composition (1e-4).
vid2vid dancing: the face and hand crops at 512x512 and the region Ds
on the card against the CPU (crops fp32 1e-5, bf16 one ulp of their
magnitude; the D's outputs 1e-4 in relative L2). fs-vid2vid
YouTubeDancing: the few-shot face D with the reference frame's crop and
the DensePose face box at 512x256 on the card against the CPU (the boxes
exactly, the D's outputs 1e-4 in relative L2).
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from chip_smoke import (MODULATION_EDGE, at_offset, bf16_ulps, corners_flow,
                        dx_term_scale, resample_bwd_errors)
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
    ("half_grad", TypeError), ("strided_x", ValueError),
    ("strided_flow", ValueError), ("half", TypeError), ("cpu_flow", ValueError)])
def test_resample2d_wrapper_refuses(cuda_device, bad, error):
    """The forward's refusals (a flow that needs a gradient now launches:
    the backward is a kernel too)."""
    x, flow = _warp_inputs((1, 3, 8, 8), torch.float32, torch.float32, cuda_device)
    if bad == "half_grad":
        flow = flow.half().requires_grad_(True)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,scale", [
    ((1, 1, 37, 53), None),
    ((3, 5, 1, 7), None),         # B > 1, C = 5, H = 1
    ((1, 2, 9, 1027), None),      # an odd W
    ((2, 2, 48, 520), 300.0),     # flows far larger than a tile
    ((2, 3, 512, 1024), None),    # the vid2vid training warp
])
def test_resample2d_backward_kernel_matches_plain(cuda_device, shape, scale, dtype):
    """Through autograd, x and flow needing gradients (dx with atomics)
    and the flow alone (dflow only), against the plain backward: dflow
    bit for bit (the same fp32 steps in the same order); dx element by
    element, fp32 1e-5 and bf16 one ulp of the magnitude of the terms it
    sums (sum of |w_k g|)."""
    x, flow = _warp_inputs(shape, dtype, dtype, cuda_device, scale=scale)
    g = torch.randn(shape, generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device).to(dtype)
    want_dx, want_dflow = rs.resample2d_bwd_plain(x, flow, g)
    for need_dx in (True, False):
        xi = x.clone().requires_grad_(need_dx)
        fi = flow.clone().requires_grad_(True)
        before = (rs.launches, rs.bwd_launches)
        out = rs.resample2d(xi, fi)
        grads = torch.autograd.grad(out, [xi, fi] if need_dx else [fi], g)
        torch.cuda.synchronize()
        assert (rs.launches, rs.bwd_launches) == (before[0] + 1, before[1] + 1)
        dflow = grads[-1]
        assert dflow.dtype == dtype and torch.equal(dflow, want_dflow)
        if need_dx:
            dx = grads[0]
            assert dx.dtype == dtype
            terms = rs.resample2d_bwd_plain(x.float(), flow.float(),
                                            g.float().abs())[0]
            if dtype == torch.float32:
                err = ((dx - want_dx).abs() / terms.clamp_min(1e-30)).max().item()
                assert err <= 1e-5, err
            else:
                assert bf16_ulps(dx, want_dx, scale=terms) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,flow_kind", [
    ((2, 3, 512, 1024), "corners"),  # the training warp, every corner clamped
    ((1, 1, 37, 53), "corners"),     # C = 1
    ((2, 4, 20, 70), "mixed"),       # C = 4: a second group of planes;
    ((2, 4, 20, 70), "corners"),     # W not a multiple of the 64-column tile
    ((3, 7, 5, 130), "mixed"),       # B = 3, C = 7 (past two groups of 3),
    ((3, 7, 5, 130), "corners"),     # H < the tile's 8 rows
    ((1, 2, 6, 64), "mixed"),        # H < 8, W one whole tile
])
def test_resample2d_backward_edges_match_plain(cuda_device, shape, flow_kind, dtype):
    """The backward kernel through ``resample2d_bwd`` and through autograd,
    dflow alone and with dx, against the plain backward: dflow bit for bit,
    dx within chip_smoke.py's gate (fp32 1e-5 and bf16 one ulp of the
    magnitude of the terms it sums). The all-corners flow clamps every
    pixel's four corners to one of the frame's four corner pixels: the
    most dx atomics onto one address."""
    x, flow = _warp_inputs(shape, dtype, dtype, cuda_device)
    if flow_kind == "corners":
        gen = torch.Generator(device=cuda_device).manual_seed(2)
        flow = corners_flow(shape, gen).to(dtype)
    g = torch.randn(shape, generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device).to(dtype)
    for need_dx in (True, False):
        before = rs.bwd_launches
        dx, dflow = rs.resample2d_bwd(x, flow, g, need_dx)
        xi = x.clone().requires_grad_(need_dx)
        fi = flow.clone().requires_grad_(True)
        grads = torch.autograd.grad(rs.resample2d(xi, fi),
                                    [xi, fi] if need_dx else [fi], g)
        torch.cuda.synchronize()
        assert rs.bwd_launches == before + 2
        for got_dx, got_dflow in ((dx, dflow), (grads[0] if need_dx else None, grads[-1])):
            assert (got_dx is None) == (not need_dx)
            bitwise, dx_err, ok = resample_bwd_errors(rs, x, flow, g, got_dx, got_dflow)
            assert ok, (bitwise, dx_err)


@pytest.mark.cuda
def test_resample2d_backward_takes_a_strided_gradient(cuda_device):
    """The autograd Function makes a non-contiguous output gradient
    contiguous before the kernel reads it."""
    x, flow = _warp_inputs((2, 3, 16, 24), torch.float32, torch.float32, cuda_device)
    flow.requires_grad_(True)
    out = rs.resample2d(x, flow)
    g = torch.randn(2, 3, 24, 16, device=cuda_device).transpose(2, 3)
    assert not g.is_contiguous()
    (dflow,) = torch.autograd.grad(out, [flow], g)
    assert torch.equal(dflow, rs.resample2d_bwd_plain(x, flow.detach(),
                                                      g.contiguous())[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bad,error", [
    ("half", TypeError), ("g_dtype", ValueError), ("g_shape", ValueError),
    ("strided_g", ValueError), ("cpu_g", ValueError)])
def test_resample2d_backward_wrapper_refuses(cuda_device, bad, error):
    x, flow = _warp_inputs((1, 3, 8, 8), torch.float32, torch.float32, cuda_device)
    g = torch.ones_like(x)
    if bad == "half":
        x, flow, g = x.half(), flow.half(), g.half()
    elif bad == "g_dtype":
        g = g.bfloat16()
    elif bad == "g_shape":
        g = g[:, :2].contiguous()
    elif bad == "strided_g":
        g = torch.ones(1, 3, 8, 8, device=cuda_device).transpose(2, 3)
    else:
        g = g.cpu()
    before = rs.bwd_launches
    with pytest.raises(error):
        rs.resample2d_bwd(x, flow, g)
    assert rs.bwd_launches == before


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


# ------------------------------------------------------------ evaluation

UNIT_CONFIG = Path(__file__).resolve().parent.parent / "configs/unit_test/spade.yaml"


@pytest.mark.cuda
def test_inception_on_the_card_matches_the_cpu(cuda_device):
    """The extractor (bf16-rounded input, fp32 network, TF32 off) on the
    card against the port's CPU run of the same seeded weights: max-abs
    over the features' max magnitude 1e-3 (cuDNN's and the CPU's fp32
    convolutions sum in other orders through ~50 layers)."""
    from imaginaire_tpu_torch.evaluation import inception

    x = torch.randn((2, 3, 299, 299), generator=torch.Generator().manual_seed(0))
    got = inception.make_extractor(inception.load_params(
        random_init=True, device="cuda", seed=1))(x.cuda()).cpu()
    want = inception.make_extractor(inception.load_params(random_init=True, seed=1))(x)
    assert got.shape == (2, 2048) and torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-3


@pytest.mark.cuda
def test_ema_bn_reestimation_through_the_kernel_matches_plain(cuda_device):
    """The averaged copy's BatchNorm re-estimation on the unit config
    (small widths, the style code's norms ``sync_batch``, the SPADE
    blocks' instance norm through the modulation kernel) against the same
    run through the plain composition: each statistic within 1e-4 of the
    larger of its own and the live statistic's max magnitude; the live
    network bit for bit."""
    import numpy as np

    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.trainers.spade import Trainer

    cfg = Config(str(UNIT_CONFIG), overrides={
        "gen": {"num_filters": 8, "style_dims": 16, "style_enc": {"num_filters": 4},
                "activation_norm_params": {"num_filters": 8},
                "global_adaptive_norm_type": "sync_batch"},
        "trainer": {"model_average": True,
                    "model_average_batch_norm_estimation_iteration": 2}})
    trainer = Trainer(cfg, device="cuda")
    trainer.init_state(seed=0)
    rng = np.random.RandomState(0)
    loader = [{"label": np.eye(14, dtype=np.float32)[rng.randint(0, 14, (2, 32, 32))],
               "images": rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)}
              for _ in range(3)]
    live = {k: v.clone() for k, v in trainer.net_G.state_dict().items()}
    runs = {}
    for route, value in (("kernel", "auto"), ("plain", "none")):
        for m in trainer.net_G.modules():
            if isinstance(m, SpatiallyAdaptiveNorm):
                m.fused_modulation = value
        trainer._ema_bn_recal_iter = None
        before = spade_mod.launches
        trainer.recalculate_model_average_batch_norm_statistics(loader)
        runs[route] = (spade_mod.launches - before, trainer._ema_batch_stats)
    (launches, kernel), (plain_launches, plain) = runs["kernel"], runs["plain"]
    assert launches > 0 and launches % 2 == 0 and plain_launches == 0
    buffers = dict(trainer.net_G.named_buffers())
    assert len(kernel) == 8
    for name, value in kernel.items():
        scale = max(float(plain[name].abs().max()), float(buffers[name].abs().max()))
        assert float((value - plain[name]).abs().max()) <= 1e-4 * scale, name
    assert all(torch.equal(v, live[k]) for k, v in trainer.net_G.state_dict().items())


V2V_UNIT_CONFIG = UNIT_CONFIG.parent / "vid2vid_street.yaml"


@pytest.mark.cuda
def test_vid2vid_pinned_sequence_rollout_through_the_kernel_matches_plain(
        cuda_device, tmp_path):
    """``trainer.test`` on a pinned sequence of 4 frames (the unit config's
    narrow generator, 64x64 PNG frames) on the card: every frame from the
    third on warps once through the resample2d kernel; the same rollout
    through the plain warp launches nothing and gives the same frames
    within 1e-4 (the warp's 1e-5, carried through the generator by the
    frames it feeds back)."""
    import numpy as np

    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.data.loader import DataLoader
    from imaginaire_tpu_torch.data.paired_videos import Dataset
    from imaginaire_tpu_torch.data.png import write_png
    from imaginaire_tpu_torch.model_utils import fs_vid2vid
    from imaginaire_tpu_torch.trainers.vid2vid import Trainer

    rng = np.random.RandomState(0)
    frames = 4
    for t in range(frames):
        for kind, arr in (("images", rng.randint(0, 256, (64, 64, 3))),
                          ("seg_maps", rng.randint(0, 12, (64, 64)))):
            (tmp_path / "data" / kind / "seq0000").mkdir(parents=True, exist_ok=True)
            write_png(str(tmp_path / "data" / kind / "seq0000" / f"{t:05d}.png"),
                      arr.astype(np.uint8))
    cfg = Config(str(V2V_UNIT_CONFIG), overrides={"data": {
        "input_types": [{"images": {"ext": "png", "num_channels": 3,
                                    "interpolator": "BILINEAR", "normalize": True}},
                        {"seg_maps": {"ext": "png", "num_channels": 12,
                                      "interpolator": "NEAREST", "is_mask": True}}],
        "val": {"roots": [str(tmp_path / "data")]}}})
    trainer = Trainer(cfg, device="cuda")
    trainer.init_state(seed=0)
    loader = DataLoader(Dataset(cfg, is_inference=True), batch_size=1, shuffle=False,
                        drop_last=False)
    runs, save = {}, trainer._save_test_frame
    for route in ("kernel", "plain"):
        out = []
        trainer._save_test_frame = lambda d, key, t, fake: (
            out.append(fake.clone()), save(d, key, t, fake))
        warp = fs_vid2vid.resample2d
        if route == "plain":
            fs_vid2vid.resample2d = rs.resample2d_plain
        before = rs.launches
        try:
            trainer.test(loader, str(tmp_path / route))
        finally:
            fs_vid2vid.resample2d = warp
        runs[route] = (rs.launches - before, out)
    assert runs["kernel"][0] == frames - 2 and runs["plain"][0] == 0
    assert len(runs["kernel"][1]) == len(runs["plain"][1]) == frames
    assert sorted(p.name for p in (tmp_path / "kernel" / "seq0000").iterdir()) == [
        f"{t:04d}.png" for t in range(frames)]
    for got, want in zip(runs["kernel"][1], runs["plain"][1]):
        assert got.shape == (1, 3, 64, 64) and torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_fs_vid2vid_hyper_generator_through_the_modulation_kernel_matches_plain(
        cuda_device):
    """fs-vid2vid's generator under the unit config's
    ``hyper_spatially_adaptive`` norm, at 256x256 frames with a previous
    frame: its 4 HyperRes2dBlocks fuse the first pair of each of their 2
    hyper norms (8 launches); the 256x256 planes take the kernel's
    re-reading (stream) path. Against the same forward with every norm's
    plain composition (the modulation launched 0 times), fp32: the output
    conv's maps (before the tanh, which the fresh weights saturate)
    within 1e-4 of their magnitude."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.layers.activation_norm import HyperSpatiallyAdaptiveNorm
    from imaginaire_tpu_torch.models.generators.fs_vid2vid import Generator

    hw = (256, 256)
    cfg = Config("configs/unit_test/fs_vid2vid.yaml")
    with torch.device(cuda_device):
        net = Generator(cfg.gen, cfg.data).eval()
    init_weights(net, torch.Generator(device=cuda_device).manual_seed(3))
    gen = torch.Generator(device=cuda_device).manual_seed(4)

    def labels(*lead):
        idx = torch.randint(0, 12, lead + hw, generator=gen, device=cuda_device)
        return torch.nn.functional.one_hot(idx, 12).movedim(-1, -3).float()

    def images(*lead):
        return torch.tanh(torch.randn(lead + (3,) + hw, generator=gen, device=cuda_device))

    data = {"label": labels(1), "ref_labels": labels(1, 1), "ref_images": images(1, 1),
            "prev_labels": labels(1, 1), "prev_images": images(1, 1)}
    assert spade_mod.modulation_plan(1 * 8, hw[0] * hw[1], torch.float32, 1, True,
                                     False)["route"] == "stream"
    norms = [m for m in net.modules() if isinstance(m, HyperSpatiallyAdaptiveNorm)]
    assert len(norms) == 8
    maps = []
    net.conv_img.register_forward_hook(lambda m, i, o: maps.append(o))
    with torch.no_grad():
        before = spade_mod.launches
        fused = net(data)["fake_images"]
        launched = spade_mod.launches - before
        for m in norms:
            m.fused_modulation = "none"
        before = spade_mod.launches
        net(data)
        assert spade_mod.launches == before
    assert launched == 8
    assert fused.shape == (1, 3) + hw and torch.isfinite(fused).all()
    scale = maps[1].abs().max().item()
    assert scale > 1 and (maps[0] - maps[1]).abs().max().item() <= 1e-4 * scale


@pytest.mark.cuda
def test_wc_vid2vid_partial_conv_generator_through_the_warp_kernel_matches_plain(
        cuda_device):
    """wc-vid2vid's generator under ``gen.guidance.partial_conv`` (the
    guidance an (image, mask) pair through ``PartialConv2d`` in partial
    SPADE norms) on a warp frame of the unit config at 64x64: one
    resample2d launch, the same frame through the plain warp launching
    none, within 1e-5 (fp32, TF32 off)."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.layers.conv import PartialConv2d
    from imaginaire_tpu_torch.model_utils import fs_vid2vid
    from imaginaire_tpu_torch.models.generators.wc_vid2vid import Generator

    cfg = Config(str(UNIT_CONFIG.parent / "wc_vid2vid.yaml"), overrides={"gen": {
        "guidance": {"partial_conv": True},
        "activation_norm_params": {"partial": True, "num_filters": 4, "kernel_size": 3}}})
    with torch.device(cuda_device):
        net = Generator(cfg.gen, cfg.data).eval()
    init_weights(net, torch.Generator(device=cuda_device).manual_seed(5), gain=1.0)
    assert any(isinstance(m, PartialConv2d) for m in net.modules())
    gen = torch.Generator(device=cuda_device).manual_seed(6)

    def labels(*lead):
        idx = torch.randint(0, 12, lead + (64, 64), generator=gen, device=cuda_device)
        return torch.nn.functional.one_hot(idx, 12).movedim(-1, -3).float()

    mask = (torch.rand((1, 1, 64, 64), generator=gen, device=cuda_device) < 0.5).float()
    colors = torch.tanh(torch.randn((1, 3, 64, 64), generator=gen, device=cuda_device))
    data = {"label": labels(1), "prev_labels": labels(1, 2),
            "prev_images": torch.tanh(torch.randn((1, 2, 3, 64, 64), generator=gen,
                                                  device=cuda_device)),
            "guidance": torch.cat([colors * mask, mask], dim=1)}
    runs = {}
    for route in ("kernel", "plain"):
        warp = fs_vid2vid.resample2d
        if route == "plain":
            fs_vid2vid.resample2d = rs.resample2d_plain
        before = rs.launches
        try:
            with torch.no_grad():
                runs[route] = (net(data)["fake_images"], rs.launches - before)
        finally:
            fs_vid2vid.resample2d = warp
    assert runs["kernel"][1] == 1 and runs["plain"][1] == 0
    got, want = runs["kernel"][0], runs["plain"][0]
    assert got.shape == (1, 3, 64, 64) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_funit_generators_on_the_card_match_the_cpu(cuda_device):
    """FUNIT's and COCO-FUNIT's generators of the unit configs at 64x64,
    batch 2: the training forward (translation and reconstruction) and
    ``inference`` on the card against the CPU at the same weights, fp32
    with TF32 off, within 1e-4 in relative L2; AdaIN's gamma and beta
    broadcast over space, so no kernel launches."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.models.generators.coco_funit import Generator as COCOFUNIT
    from imaginaire_tpu_torch.models.generators.funit import Generator as FUNIT

    gen = torch.Generator().manual_seed(7)
    data = {k: torch.rand((2, 3, 64, 64), generator=gen) * 2 - 1
            for k in ("images_content", "images_style")}
    for name, cls in (("funit", FUNIT), ("coco_funit", COCOFUNIT)):
        cfg = Config(str(UNIT_CONFIG.parent / f"{name}.yaml"))
        cpu_net = cls(cfg.gen, cfg.data).eval()
        init_weights(cpu_net, torch.Generator().manual_seed(8), "kaiming", 1.0)
        net = cls(cfg.gen, cfg.data).to(cuda_device).eval()
        net.load_state_dict(cpu_net.state_dict())
        launches = (spade_mod.launches, spade_mod.bwd_launches, rs.launches,
                    rs.bwd_launches, corr.launches, cn.launches)
        dev = {k: v.to(cuda_device) for k, v in data.items()}
        with torch.no_grad():
            want = dict(cpu_net(data), inference=cpu_net.inference(data))
            got = dict(net(dev), inference=net.inference(dev))
        assert (spade_mod.launches, spade_mod.bwd_launches, rs.launches, rs.bwd_launches,
                corr.launches, cn.launches) == launches
        for k, w in want.items():
            g = got[k].cpu()
            assert g.shape == (2, 3, 64, 64) and torch.isfinite(g).all()
            assert float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)) \
                <= 1e-4, (name, k)


@pytest.mark.cuda
def test_pose_region_crops_and_discriminator_on_the_card_match_the_cpu(cuda_device):
    """The dancing path's face and hand crops at 512x512 (a small face
    the crop upsamples, a large one it antialiases, none, a hand missing)
    and the unit pose config's discriminator with its region Ds on
    64x64 one-hot labels, on the card against the CPU: the boxes and the
    hands' validity exactly, the crops fp32 within 1e-5 of their
    magnitude and bf16 within one bf16 ulp of it, the D's outputs within
    1e-4 in relative L2; no kernel launches."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.model_utils import fs_vid2vid
    from imaginaire_tpu_torch.models.discriminators.fs_vid2vid import Discriminator

    cfg = Config(str(UNIT_CONFIG.parent / "vid2vid_pose.yaml"))
    pose = torch.zeros(3, 27, 512, 512)
    pose[0, -1, 200:204, 250:256] = 1
    pose[1, -1, 20:500, 30:480] = 1
    pose[0, -3, 300:330, 100:120] = pose[1, -2, 400:440, 300:330] = 1
    gen = torch.Generator().manual_seed(11)
    img = torch.randn(3, 3, 512, 512, generator=gen)
    launches = (spade_mod.launches, rs.launches, corr.launches, cn.launches)
    for dtype in (torch.float32, torch.bfloat16):
        x = img.to(dtype)
        want = fs_vid2vid.crop_face_from_output(cfg.data, x, pose).float()
        got = fs_vid2vid.crop_face_from_output(cfg.data, x.to(cuda_device),
                                               pose.to(cuda_device)).float().cpu()
        scale = want.abs().max()
        assert got.shape == (3, 3, 128, 128)
        if dtype == torch.float32:
            assert float((got - want).abs().max()) <= 1e-5 * float(scale)
        else:
            assert bf16_ulps(got, want, scale=scale.expand_as(want)) <= 1.0
        (want_h, want_v) = fs_vid2vid.crop_hand_from_output(cfg.data, x, pose)
        got_h, got_v = fs_vid2vid.crop_hand_from_output(cfg.data, x.to(cuda_device),
                                                         pose.to(cuda_device))
        assert torch.equal(got_h.cpu(), want_h) and torch.equal(got_v.cpu(), want_v)
        assert want_v.tolist() == [1, 0, 0, 0, 1, 0]
    net = Discriminator(cfg.dis, cfg.data).eval()
    init_weights(net, torch.Generator().manual_seed(12), "kaiming", 1.0)
    dev_net = Discriminator(cfg.dis, cfg.data).to(cuda_device).eval()
    dev_net.load_state_dict(net.state_dict())
    label = torch.nn.functional.interpolate(pose[:2], size=(64, 64), mode="nearest")
    real, fake = (torch.tanh(torch.randn(2, 3, 64, 64, generator=gen)) for _ in range(2))
    with torch.no_grad():
        want = net({"label": label, "image": real}, {"fake_images": fake})
        got = dev_net({"label": label.to(cuda_device), "image": real.to(cuda_device)},
                      {"fake_images": fake.to(cuda_device)})
    assert set(got) == set(want) == {"indv", "face", "hand"}
    for name in want:
        for side in ("pred_real", "pred_fake"):
            for g, w in zip(got[name][side]["outputs"], want[name][side]["outputs"]):
                g = g.float().cpu()
                assert float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)) \
                    <= 1e-4, (name, side)
    assert (spade_mod.launches, rs.launches, corr.launches, cn.launches) == launches


@pytest.mark.cuda
def test_fewshot_face_discriminator_on_the_card_matches_the_cpu(cuda_device):
    """The YouTubeDancing config's few-shot D at 512x256 (DensePose +
    OpenPose labels: the face box from the part channel above 0.9, a face
    the crop upsamples, one it antialiases; the face D fed the frame's
    crop beside the reference image's crop at the same box) on the card
    against the CPU: the face boxes exactly, every output of the image
    and face Ds within 1e-4 in relative L2; no kernel launches."""
    from imaginaire_tpu_torch.config import Config
    from imaginaire_tpu_torch.model_utils import fs_vid2vid
    from imaginaire_tpu_torch.models.discriminators.fs_vid2vid import Discriminator

    cfg = Config(str(UNIT_CONFIG.parents[1] / "projects/fs_vid2vid/YouTubeDancing/bf16.yaml"))
    gen = torch.Generator().manual_seed(13)
    label = torch.rand(2, 6, 512, 256, generator=gen) * 2 - 1
    label[:, 2] = -1
    label[0, 2, 100:112, 120:134] = 23 / 12 - 1  # a small face (part 23)
    label[1, 2, 40:300, 20:240] = 1.0  # a large one (part 24)
    image, fake = (torch.tanh(torch.randn(2, 3, 512, 256, generator=gen)) for _ in range(2))
    data = {"label": label, "image": image, "ref_labels": label.flip(-1)[:, None],
            "ref_images": torch.tanh(torch.randn(2, 1, 3, 512, 256, generator=gen))}
    want_box = fs_vid2vid.get_face_bbox_for_output(cfg.data, label)
    got_box = fs_vid2vid.get_face_bbox_for_output(cfg.data, label.to(cuda_device))
    assert torch.equal(got_box.cpu(), want_box)
    assert want_box[0, 1] - want_box[0, 0] == 32 and want_box[1, 1] - want_box[1, 0] == 256
    launches = (spade_mod.launches, rs.launches, corr.launches, cn.launches)
    net = Discriminator(cfg.dis, cfg.data).eval()
    init_weights(net, torch.Generator().manual_seed(14), "kaiming", 1.0)
    dev_net = Discriminator(cfg.dis, cfg.data).to(cuda_device).eval()
    dev_net.load_state_dict(net.state_dict())
    assert net.net_D_face.d_0.layer0.conv.weight.shape[1] == 6
    with torch.no_grad():
        want = net(data, {"fake_images": fake})
        got = dev_net({k: v.to(cuda_device) for k, v in data.items()},
                      {"fake_images": fake.to(cuda_device)})
    assert set(got) == set(want) == {"indv", "face"}
    for name in want:
        for side in ("pred_real", "pred_fake"):
            for g, w in zip(got[name][side]["outputs"], want[name][side]["outputs"]):
                g = g.float().cpu()
                assert float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)) \
                    <= 1e-4, (name, side)
    assert (spade_mod.launches, rs.launches, corr.launches, cn.launches) == launches
