"""k9_roofline.hchat: the least time of K9's (``ssd_step``) calls in the traced stretch
(``benchmark/roofline_hybrid.py``: the live lanes it stepped, counted on the device) over the
device time of its records, in %."""

from benchmark import roofline_hybrid

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "kernels", "tpot_p95_ms"


def read(obs: dict):
    return roofline_hybrid.share(obs, "ssd_step")
