"""The port's standalone examples (counterparts of the repo's examples/),
each run as ``python -m diffusion_tts_torch.examples.<name>``."""
