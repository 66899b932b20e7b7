"""tpot_p95_ms: the 95th percentile over requests of each one's mean gap
between output tokens after the first, in ms: long prefills admitted
while it decodes stall it.  Layer: the scheduler."""
from benchlib import stats


def read(obs):
    if obs.kind != "lm":
        return None
    tpot = [r.tpot_s for r in obs.records if r.n_tokens > 1]
    if not tpot:
        return None
    return stats.percentile(tpot, 95.0) * 1e3
