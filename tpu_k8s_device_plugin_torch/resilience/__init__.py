"""The port's fault-injection hooks: its own copy of the JAX package's
``resilience/faults.py``.  The retry, breaker and watchdog policies of
the reference's ``resilience/policy.py`` come with the HTTP tier."""

from .faults import (
    FaultInjector,
    FaultSpec,
    InjectedFault,
    active,
    install,
    install_from_env,
    uninstall,
)

__all__ = [
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "active",
    "install",
    "install_from_env",
    "uninstall",
]
