"""request_p95_ms: the 95th percentile over every request of the window
of its latency, sent to logits on the host, in ms: the paper's measure
of coded inference under a dead and a straggling worker.  Its run-to-run
spread (13-22% on a noisy machine) is more than a bound can hold, so it
stands here beside ``images_per_s``.  A traced run leaves its profiled
requests out.  Layer: the coded pipeline on the pool."""
from benchlib import stats


def read(obs):
    lat = getattr(obs, "latencies_s", None)
    if obs.kind != "cnn" or not lat:
        return None
    return stats.percentile(lat, 95.0) * 1e3
