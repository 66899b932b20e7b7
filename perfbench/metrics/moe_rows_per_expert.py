"""moe_rows_per_expert: the rows the held experts computed in the window
over the mixture-of-experts layer calls times the experts held, from the
program's always-on counters (``Engine.moe_counters``): how many tokens an
expert here multiplies at once, on average.  Layer: the mixture of
experts."""


def read(obs):
    moe = getattr(obs, "moe", None)
    if obs.kind != "lm" or not moe or not moe.get("calls"):
        return None
    return moe["rows"] / (moe["calls"] * moe["held"])
