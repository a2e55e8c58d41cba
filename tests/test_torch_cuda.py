"""The port's CUDA kernels on the card (skipped where there is no GPU).

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest.py sets up JAX.) Each kernel is
held against its plain PyTorch version, including the paths the serving
main path does not take (planes larger than the shared-memory cache,
ragged planes, the most (gamma, beta) pairs), and its wrapper's refusals
are checked. TF32 is off; fp32 tolerance 1e-4 (reduction order), bf16
2e-2 of the output's magnitude (the plain version rounds between its
steps, the kernel once).
"""

import pytest
import torch

from imaginaire_tpu_torch.layers.activation_norm import SpatiallyAdaptiveNorm
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_pairs", [
    ((2, 16, 64, 64), 1),    # plane cached in shared memory
    ((1, 8, 256, 256), 2),   # plane larger than the cache: re-read path
    ((3, 5, 7, 9), 4),       # ragged plane (63 elements), most pairs
])
def test_spade_modulation_kernel_matches_plain(cuda_device, shape, n_pairs, dtype):
    x, gs, bs = _inputs(shape, n_pairs, dtype, cuda_device)
    before = spade_mod.launches
    with torch.no_grad():
        got = spade_mod.spade_modulation(x, gs, bs)
    torch.cuda.synchronize()
    assert spade_mod.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = spade_mod.spade_modulation_plain(x, gs, bs).float()
    err = (got.float() - want).abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4, err
    else:
        assert err <= 2e-2 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("bad,error", [
    ("pairs", ValueError), ("grad", NotImplementedError),
    ("strided", ValueError), ("half", TypeError), ("mixed", ValueError)])
def test_spade_modulation_wrapper_refuses(cuda_device, bad, error):
    x, gs, bs = _inputs((1, 2, 8, 8), 1, torch.float32, cuda_device)
    if bad == "pairs":
        gs, bs = gs * 5, bs * 5
    elif bad == "grad":
        x.requires_grad_(True)
    elif bad == "strided":
        x = x.transpose(2, 3)
    elif bad == "half":
        x, gs, bs = x.half(), [g.half() for g in gs], [b.half() for b in bs]
    else:
        gs = [gs[0].to(torch.bfloat16)]
    before = spade_mod.launches
    with pytest.raises(error):
        spade_mod.spade_modulation(x, gs, bs)
    assert spade_mod.launches == before


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
