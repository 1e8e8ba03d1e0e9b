from diffusion_tts_torch.pipelines.sd_pipeline import StableDiffusionSearchPipeline  # noqa: F401
