"""pool.run_ms: the median wall of the window's coded runs on the worker
pool (``RunReport.wall_s``: dispatch of the n pieces to the decode of the
first k arrivals), in ms.  Layer: the coded pipeline on the pool."""
from benchlib import stats


def read(obs):
    walls = getattr(obs, "run_walls_s", None)
    if obs.kind != "cnn" or not walls:
        return None
    return stats.median(walls) * 1e3
