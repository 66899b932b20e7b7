"""decode_wait_ms: the median over the steps that admitted no request of
the host's waits on the card in the step (``StepRecord.wait_s``: the
mesh's synchronise after each coded run, and the sampled tokens' copy to
the host), in ms.  None where the program keeps no such counter.
Layer: the one-program backend."""
from benchlib import stats


def read(obs):
    if obs.kind != "lm":
        return None
    waits = [s.wait_s for s in obs.steps
             if s.admitted == 0 and s.batch > 0 and hasattr(s, "wait_s")]
    if not waits:
        return None
    return stats.median(waits) * 1e3
