"""mesh.run_ms.granite4h: the median time on the card of the window's
coded runs on the one-program backend (``RunReport.wall_s``), here the
shared experts' GEMMs, in ms.  Layer: the one-program backend."""
from benchlib import stats


def read(obs):
    walls = getattr(obs, "run_walls_s", None)
    if obs.kind != "lm" or not walls:
        return None
    return stats.median(walls) * 1e3
