"""peak_mem_gb.train: the largest memory the allocator held during the window (the train
graphs' pool, the model, optimizer state and accumulators), in GB."""

SOURCE, UNIT, LAYER, MOVES = "program_counter", "GB", "train graph", "train_tokens_per_s"


def read(obs: dict):
    b = obs.get("peak_window_bytes")
    return b / 1e9 if b else None
