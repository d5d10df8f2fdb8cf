"""prefix_reuse_share.chat: prompt tokens the scheduler took from its prefix cache in the
window (its prefix_tokens_reused counter's delta) over the prompt tokens of the requests
admitted in the window, in %."""

SOURCE, UNIT, LAYER, MOVES = "program_counter", "%", "scheduler prefix cache", "ttft_p95_ms"


def read(obs: dict):
    if not obs["admitted_prompt"]:
        return None
    return 100.0 * obs["reused"] / obs["admitted_prompt"]
