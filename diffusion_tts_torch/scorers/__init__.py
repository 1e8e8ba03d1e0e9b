from diffusion_tts_torch.scorers.base import Scorer, quantize_to_uint8_grid  # noqa: F401
from diffusion_tts_torch.scorers.brightness import BrightnessScorer  # noqa: F401
