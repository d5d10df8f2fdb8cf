"""ssm_share.hchat: device time of the state-space layer's kernels (K8 ``ssd_scan``, K9
``ssd_step``, the conv pass ``ssd_conv`` and the gated-norm pass ``gated_norm``) over all
device time of the traced stretch after the window, in %."""

SOURCE, UNIT, LAYER, MOVES = "device_trace", "%", "state-space layer", "tpot_p95_ms"
KERNELS = ("ssd_scan", "ssd_step", "ssd_conv", "gated_norm")


def read(obs: dict):
    s = (obs.get("trace") or {}).get("summary")
    if not s or not s["device_s"] or not all(k in s["group_s"] for k in KERNELS):
        return None
    return 100.0 * sum(s["group_s"][k] for k in KERNELS) / s["device_s"]
