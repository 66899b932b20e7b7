"""idle_share.granite4h: the share of the traced window in which no
operation ran on the card, over all streams, in %.  Layer: the device."""
from benchlib.readers import idle_share


def read(obs):
    return idle_share(obs, "lm")
