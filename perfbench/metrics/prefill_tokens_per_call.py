"""prefill_tokens_per_call: prompt tokens over the engine's prefill calls
in the window (the benchmark's spans count ``Engine.prefill_batch``).
Prompts of one length prefill together; more tokens a call is fewer,
larger calls.  Layer: the scheduler."""


def read(obs):
    if obs.kind != "lm":
        return None
    pre = [(rows, T) for kind, rows, T, _ in obs.calls if kind == "prefill"]
    if not pre:
        return None
    return sum(rows * T for rows, T in pre) / len(pre)
