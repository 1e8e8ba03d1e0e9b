from diffusion_tts_torch.scorers.base import Scorer, quantize_to_uint8_grid  # noqa: F401
from diffusion_tts_torch.scorers.brightness import BrightnessScorer  # noqa: F401
from diffusion_tts_torch.scorers.compressibility import CompressibilityScorer  # noqa: F401
from diffusion_tts_torch.scorers.imagenet import ImageNetScorer  # noqa: F401
from diffusion_tts_torch.scorers.clip import CLIPScorer  # noqa: F401
