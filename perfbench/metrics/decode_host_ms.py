"""decode_host_ms: the median over the steps that admitted no request
(one batched decode call each, the steps ``decode_step_ms`` reads) of the
step's wall less the host's waits on the card in it (``StepRecord.wait_s``:
the mesh's synchronise a coded run, the sampled tokens' copy out), in
ms: the host's own time in a decode step.  None where the program keeps
no such counter.  Layer: the model."""
from benchlib import stats


def read(obs):
    if obs.kind != "lm":
        return None
    host = [s.t_end - s.t_start - s.wait_s for s in obs.steps
            if s.admitted == 0 and s.batch > 0 and hasattr(s, "wait_s")]
    if not host:
        return None
    return stats.median(host) * 1e3
