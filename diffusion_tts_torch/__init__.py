"""PyTorch/CUDA port of diffusion_tts_tpu: test-time scaling of diffusion
models via noise-trajectory search, on an NVIDIA H100.

The package mirrors ``diffusion_tts_tpu``'s module paths so each module's
JAX counterpart is found at the same relative path. It imports ``torch``
only: never ``jax`` and nothing of ``diffusion_tts_tpu``. Hand-written CUDA
kernels live in ``csrc/`` and are built at first use
(``ops/kernels/build.py``).
"""
