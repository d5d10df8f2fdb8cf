"""captures_in_window.chat: CUDA graphs the program captured inside the window (the decode
runner's, the admission buffers' and the prefill runner's capture counters); 0 when the
set-up reached every key of the traffic."""

SOURCE, UNIT, LAYER, MOVES = "program_counter", "count", "graphs", "ttft_p95_ms"


def read(obs: dict):
    return obs["captures"]
