"""imaginaire_tpu_torch: the PyTorch/CUDA port of imaginaire_tpu for an
NVIDIA H100 (Hopper, sm_90a).

The JAX package ``imaginaire_tpu`` stays the reference; module paths here
mirror its paths. Tensors are NCHW inside, NHWC numpy at the serving
boundary. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Importing the package builds nothing: the CUDA kernels
under ``csrc/`` are compiled at first use (``ops/build.py``).
"""
