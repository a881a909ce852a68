"""Model zoo: composable PyTorch definitions for the ported architectures."""
from repro_torch.models.model import (  # noqa: F401
    abstract_cache, abstract_params, decode_step, forward, init_cache,
    init_params, param_logical_axes, prefill,
)
