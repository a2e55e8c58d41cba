"""The port's kernels: each op module holds a plain PyTorch version, a
wrapper that launches the hand-written CUDA kernel on CUDA tensors, and a
``launches`` counter. Import the op modules directly
(``from imaginaire_tpu_torch.ops import spade_modulation as spade_mod``)."""
