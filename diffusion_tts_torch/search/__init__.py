from diffusion_tts_torch.search.api import SearchResult, run_search  # noqa: F401
from diffusion_tts_torch.search.backend import EDMSearchBackend  # noqa: F401
from diffusion_tts_torch.search.naive import replay_trajectory  # noqa: F401
from diffusion_tts_torch.search.noise import (  # noqa: F401
    InjectedNoise,
    record_mcts_table,
    record_step_draws,
    record_zero_order_draws,
)
