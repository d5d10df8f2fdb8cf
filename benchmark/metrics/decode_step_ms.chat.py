"""decode_step_ms.chat: the median device time of one replay of the decode step's graph in
the window (the worker's ``device.replay`` intervals of ``decode_rows step``, CUDA events
around each replay)."""

from benchmark.program_spans import decode_step_ms

SOURCE, UNIT, LAYER, MOVES = "program_counter", "ms", "graphs", "tpot_p95_ms"


def read(obs: dict):
    return decode_step_ms(obs)
