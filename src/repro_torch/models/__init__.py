"""Model zoo: composable PyTorch definitions for the ported architectures."""
from repro_torch.models.model import (  # noqa: F401
    decode_step, forward, init_cache, init_params, prefill,
)
