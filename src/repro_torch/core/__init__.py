from repro_torch.core import cluster, dispatch, profiling, requests, resource_manager, variants

__all__ = ["cluster", "dispatch", "profiling", "requests",
           "resource_manager", "variants"]
