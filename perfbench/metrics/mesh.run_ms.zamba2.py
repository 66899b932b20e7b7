"""mesh.run_ms.zamba2: the median wall of the window's coded runs on the
one-program backend (``RunReport.wall_s``: the program's graph replay to
its stream's synchronise), in ms.  Layer: the one-program backend."""
from benchlib import stats


def read(obs):
    walls = getattr(obs, "run_walls_s", None)
    if obs.kind != "lm" or not walls:
        return None
    return stats.median(walls) * 1e3
