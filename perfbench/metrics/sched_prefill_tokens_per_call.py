"""sched_prefill_tokens_per_call: prompt tokens over the engine's prefill
calls in the window, as the program counts them into its steps
(``StepRecord.prefill_tokens`` / ``prefill_calls``).  None where the
program keeps no such counter.  Layer: the scheduler."""


def read(obs):
    if obs.kind != "lm" or not obs.steps \
            or not hasattr(obs.steps[0], "prefill_calls"):
        return None
    calls = sum(s.prefill_calls for s in obs.steps)
    if calls == 0:
        return None
    return sum(s.prefill_tokens for s in obs.steps) / calls
