"""sched_host_ms: the median over the window's scheduler steps of the
scheduler's own host work (``StepRecord.sched_s``: the step's wall on the
host's clock less its model calls' walls: admission, the caches' joins,
retirement), in ms.  None where the program keeps no such counter.
Layer: the scheduler."""
from benchlib import stats


def read(obs):
    if obs.kind != "lm":
        return None
    host = [s.sched_s for s in obs.steps if hasattr(s, "sched_s")]
    if not host:
        return None
    return stats.median(host) * 1e3
