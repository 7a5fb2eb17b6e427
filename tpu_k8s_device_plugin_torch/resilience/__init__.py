"""The port's resilience layer: its own copy of the JAX package's
``resilience/`` (retry, circuit breaker, watchdog, fault injection),
exporting the same names.  The port imports nothing of that package.
"""

from .faults import (
    FaultInjector,
    FaultSpec,
    InjectedFault,
    active,
    install,
    install_from_env,
    uninstall,
)
from .policy import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    CircuitBreaker,
    CircuitOpenError,
    ResilienceMetrics,
    RetryPolicy,
    Watchdog,
    WatchdogTimeout,
    set_suppressed_metrics,
    suppressed,
)

__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_HALF_OPEN",
    "BREAKER_OPEN",
    "CircuitBreaker",
    "CircuitOpenError",
    "FaultInjector",
    "FaultSpec",
    "InjectedFault",
    "ResilienceMetrics",
    "RetryPolicy",
    "Watchdog",
    "WatchdogTimeout",
    "active",
    "install",
    "install_from_env",
    "set_suppressed_metrics",
    "suppressed",
    "uninstall",
]
