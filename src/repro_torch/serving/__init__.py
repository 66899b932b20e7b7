"""Serving: the batched engine, the continuous-batching scheduler, its
traffic generator and SLO metrics, and the coded prefix cache (the port of
``repro.serving``)."""
from .engine import Engine, Request, Completion, cache_cat, cache_take
from .metrics import percentiles, summarize
from .prefix_cache import PrefixCache, PrefixCacheStats
from .scheduler import (RequestRecord, ServeResult, ServingScheduler,
                        StepRecord)
from .traffic import (ArrivalProcess, BurstyArrivals, LengthDist,
                      PoissonArrivals, SharedPrefixDist, TraceArrivals,
                      Workload)

__all__ = [
    "Engine", "Request", "Completion", "cache_cat", "cache_take",
    "ServingScheduler", "ServeResult", "RequestRecord", "StepRecord",
    "percentiles", "summarize",
    "PrefixCache", "PrefixCacheStats",
    "ArrivalProcess", "PoissonArrivals", "BurstyArrivals", "TraceArrivals",
    "LengthDist", "SharedPrefixDist", "Workload",
]
