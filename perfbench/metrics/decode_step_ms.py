"""decode_step_ms: the median wall of the scheduler's steps that admitted
no request (one batched decode call each, ``StepRecord``), in ms.
Layer: the model."""
from benchlib import stats


def read(obs):
    if obs.kind != "lm":
        return None
    walls = [s.t_end - s.t_start for s in obs.steps
             if s.admitted == 0 and s.batch > 0]
    if not walls:
        return None
    return stats.median(walls) * 1e3
