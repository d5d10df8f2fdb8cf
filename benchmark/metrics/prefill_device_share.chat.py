"""prefill_device_share.chat: the device time of the admission, prefill-chunk and install
replays and their copies (the worker's device intervals under ``serve.admit``,
``serve.prefill_chunk`` and ``serve.install``) over all of the worker's device time in the
window, in %. A replay's interval starts no earlier than the host's return from its launch;
the reader logs the bounds on the share that this leaves (``program_spans.py``)."""

from benchmark.program_spans import prefill_device_share

SOURCE, UNIT, LAYER, MOVES = "program_counter", "%", "scheduler", "tpot_p95_ms"


def read(obs: dict):
    return prefill_device_share(obs)
