"""The port's benchmark tools (counterparts of the repo's tools/), each run
as ``python -m diffusion_tts_torch.tools.<name>``."""
