"""queue_wait_p50_ms: the median wait of a request from its arrival to
its admission into the running batch (``RequestRecord.admit_s -
arrival_s`` on the scheduler's timeline), in ms.  Layer: the scheduler."""
from benchlib import stats


def read(obs):
    if obs.kind != "lm" or not obs.records:
        return None
    return stats.median([r.admit_s - r.arrival_s for r in obs.records]) * 1e3
