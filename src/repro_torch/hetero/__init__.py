"""Device-heterogeneity subsystem: profiles, samplers, and fleet timing.

Numpy only, copied from ``repro.hetero``: the same seed gives the same fleet,
service times and dropout draws in both packages.
"""
from .profiles import (
    DeviceProfile,
    TraceSchedule,
    PROFILE_REGISTRY,
    register_profile,
    sample_profile,
)
from .timing import ClusterDropout, FleetTiming

__all__ = [
    "DeviceProfile",
    "TraceSchedule",
    "PROFILE_REGISTRY",
    "register_profile",
    "sample_profile",
    "ClusterDropout",
    "FleetTiming",
]
