"""Policy protocol + registry.

A scheduling policy is any object with ``name`` and
``plan(state, request) -> Plan``. Concrete policies register themselves
under a string key with :func:`register_policy`; consumers resolve names
through :func:`get_policy` (fresh instance, accepts constructor kwargs)
or :func:`resolve_policy` (pass-through for ready-made instances).

Registering a new policy:

    @register_policy("my-policy")
    @dataclasses.dataclass(frozen=True)
    class MyPolicy:
        name: str = "my-policy"
        def plan(self, state, request):
            ...
"""
from __future__ import annotations

from typing import Callable, Dict, List, Protocol, Union, runtime_checkable

from repro_torch.core.requests import InferenceRequest
from repro_torch.sched.plan import Plan
from repro_torch.sched.state import ClusterState


@runtime_checkable
class Policy(Protocol):
    """plan() maps an immutable snapshot + one request to a Plan."""
    name: str

    def plan(self, state: ClusterState,
             request: InferenceRequest) -> Plan: ...


_REGISTRY: Dict[str, Callable[..., Policy]] = {}


def register_policy(name: str) -> Callable:
    """Class decorator: register a Policy factory under ``name``."""
    def deco(factory: Callable[..., Policy]):
        assert name not in _REGISTRY, f"duplicate policy {name!r}"
        _REGISTRY[name] = factory
        return factory
    return deco


def registered_policies() -> List[str]:
    """Registered policy names, in registration order."""
    return list(_REGISTRY)


def get_policy(name: str, **kwargs) -> Policy:
    """Instantiate the policy registered under ``name``."""
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown policy {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


# name prefix routing to the retained pre-optimization planners in
# repro_torch.sched.reference — `GatewayNode(policy="reference:proportional")`
# or `run_sim.py --policies` rows measured as the unoptimized baseline
REFERENCE_PREFIX = "reference:"


def resolve_policy(policy: Union[str, Policy]) -> Policy:
    """Accept a registry name, a ``reference:<name>`` baseline name, or
    a ready Policy instance."""
    if isinstance(policy, str):
        if policy.startswith(REFERENCE_PREFIX):
            from repro_torch.sched.reference import ReferencePolicy
            return ReferencePolicy(policy[len(REFERENCE_PREFIX):])
        return get_policy(policy)
    assert hasattr(policy, "plan") and hasattr(policy, "name"), (
        f"not a Policy: {policy!r}")
    return policy
