"""Parallelism through torch.distributed (counterpart of diffusion_tts_tpu/parallel)."""
