"""ttft_p95_ms: the 95th percentile over every request of the window of
the time from its arrival to its first token (queue wait included), on
the scheduler's timeline, in ms.  Under a queue that never empties it
swings with the queue.  Layer: the scheduler."""
from benchlib import stats


def read(obs):
    if obs.kind != "lm" or not obs.records:
        return None
    return stats.percentile([r.ttft_s for r in obs.records], 95.0) * 1e3
