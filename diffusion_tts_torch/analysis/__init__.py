"""Offline analysis of search records (counterpart of diffusion_tts_tpu/analysis)."""
