from repro_torch.core import cluster, profiling, requests, resource_manager, variants
