from diffusion_tts_torch.search.api import SearchResult, run_search  # noqa: F401
from diffusion_tts_torch.search.backend import EDMSearchBackend  # noqa: F401
from diffusion_tts_torch.search.noise import InjectedNoise  # noqa: F401
