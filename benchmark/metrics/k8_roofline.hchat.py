"""k8_roofline.hchat: the least time of K8's (``ssd_scan``) calls in the traced stretch
(``benchmark/roofline_hybrid.py``: the positions it scanned, its fresh calls and snapshots)
over the device time of its records, in %."""

from benchmark import roofline_hybrid

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "kernels", "ttft_p95_ms"


def read(obs: dict):
    return roofline_hybrid.share(obs, "ssd_scan")
