"""Training of the EDM model family in PyTorch (counterpart of
diffusion_tts_tpu/training)."""
