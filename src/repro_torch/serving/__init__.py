"""``repro_torch.serving`` — the stateful streaming serving subsystem
(counterpart of ``repro.serving``).

Many named client streams multiplexed onto one ``Accelerator`` session,
each stream's recurrent carry held across windows (in a host LRU store or
a device-resident slot table that the fused slot kernel gathers from and
scatters to), waves double-buffered against device compute, tail latency
bounded by a deadline, and guarded execution down the bit-identical
engine ladder.

Chat sessions of an LM with carried state (LFM2's KV and conv state in a
device session table) are served the same way by :class:`SessionServer`.

Scale-out: :class:`ClusterServer` puts N replica servers behind a
consistent-hash front door (:class:`HashRing`), so each stream's carry
stays on one replica.  Chaos drills: a seeded :class:`FaultInjector`
wraps the execute path and the state store.
"""

from repro_torch.serving.cluster import ClusterConfig, ClusterServer  # noqa: F401
from repro_torch.serving.device_state import (DeviceStateStore,  # noqa: F401
                                              SlotAllocator)
from repro_torch.serving.faults import (FaultConfig, FaultInjector,  # noqa: F401
                                        InjectedFault)
from repro_torch.serving.metrics import MetricsSink, WaveRecord  # noqa: F401
from repro_torch.serving.routing import HashRing                # noqa: F401
from repro_torch.serving.resilience import (ExecutionGuard,      # noqa: F401
                                            GuardOutcome, ResiliencePolicy,
                                            WaveTimeout)
from repro_torch.serving.scheduler import (OverloadPolicy,       # noqa: F401
                                           ServerOverloaded, Wave,
                                           WaveScheduler)
from repro_torch.serving.server import (ServingConfig, StreamResult,  # noqa: F401
                                        StreamServer, serve_windows)
from repro_torch.serving.state import StateStore, StreamState    # noqa: F401

__all__ = [
    "ClusterConfig", "ClusterServer", "DeviceStateStore", "ExecutionGuard",
    "FaultConfig", "FaultInjector", "GuardOutcome", "HashRing",
    "InjectedFault", "MetricsSink", "OverloadPolicy", "ResiliencePolicy",
    "ServerOverloaded", "ServingConfig", "SessionResult", "SessionServer", "SlotAllocator", "StateStore",
    "StreamResult", "StreamServer", "StreamState", "Wave", "WaveRecord",
    "WaveScheduler", "WaveTimeout", "serve_windows",
]


def __getattr__(name):
    """``SessionServer`` and ``SessionResult`` on first use: their module
    imports the LM stack (``models.transformer``), which the streams'
    serving path does not need and would pay for at every import."""
    if name in ("SessionServer", "SessionResult"):
        from repro_torch.serving import sessions
        return getattr(sessions, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
