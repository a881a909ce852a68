"""Plain float32 references of the benchmark's configurations.

Each module here is one family's forward pass in plain PyTorch, with no
kernel, cache or batching of the program under test, and imports nothing of
it. A configuration file names its module under ``"reference"``.
"""
import importlib


def module(name: str):
    """The reference module a configuration file names."""
    return importlib.import_module(f"portbench.reference.{name}")
