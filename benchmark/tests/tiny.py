"""A benchmark root at CPU size for the tests: ``BENCHMARK.json`` and the data files of
tiny cells of each traffic kind, beside a copy of the metric readers. The code that runs
them is the repository's own ``benchmark`` package."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
CONFIG = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
              intermediate_size=128, vocab_size=256, rope_theta=1000000.0, rms_norm_eps=1e-05,
              max_position_embeddings=256, tie_word_embeddings=False, sliding_window=None, hidden_act="silu")
MIXES = {
    "tiny_sft": dict(kind="packed_sft", seq_len=128, microbatch_rows=1, accumulation=2, doc_median=24, doc_sigma=0.75,
                     doc_min=4, doc_max=64, label_share=0.5),
    "tiny_chat": dict(kind="chat_sessions", schedule_seed=0, session_rate=2.0, turns_mean=2.0, max_turns=4, turn_gap_mean_s=0.5,
                      prompt_median=24, prompt_sigma=0.8, prompt_min=4, prompt_max=64, user_median=8, user_sigma=0.8,
                      user_min=2, user_max=16, prompt_cap=160, answer_median=8, answer_sigma=0.7, answer_min=4,
                      answer_max=16),
    "tiny_batch": dict(kind="offline_batch", batch=3, prompt_min=8, prompt_max=24, prompt_pad=24, new_tokens=6,
                       chunk_size=4),
}
CELLS = {
    "tiny-train": dict(config="tiny", traffic="tiny_sft", chips=1,
                       engine=dict(lora_rank=4, lora_alpha=4, lr=1e-3, remat_policy="full", fused_ce_chunks=2),
                       limits=dict(loss_gap=0.002, grad_gap=0.03, grad2_gap=0.03, change_gap=0.03)),
    "tiny-chat": dict(config="tiny", traffic="tiny_chat", chips=1,
                      engine=dict(n_slots=4, chunk_size=4, prompt_multiple=16, prefill_chunk=32, prefix_cache=8,
                                  warmup_prompt=200, warmup_tokens=4, trace_seconds=0.2, park_seconds=0.05,
                                  check_requests=4),
                      limits=dict(logit_gap=0.05)),
    "tiny-batch": dict(config="tiny", traffic="tiny_batch", chips=1, engine=dict(check_requests=3),
                       limits=dict(logit_gap=0.05)),
}
E2E = {"tiny-train": ["train_tokens_per_s"], "tiny-chat": ["ttft_p95_ms", "tpot_p95_ms", "serve_tokens_per_s"],
       "tiny-batch": ["serve_tokens_per_s"]}


def make_root(tmp: Path) -> Path:
    """Write the tiny benchmark under ``tmp`` and return it."""
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for sub in ("configs", "workloads", "traffic"):
        (tmp / "benchmark" / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", tmp / "benchmark" / "metrics")
    (tmp / "benchmark/configs/tiny.json").write_text(json.dumps(CONFIG))
    for name, mix in MIXES.items():
        (tmp / "benchmark/traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, cell in CELLS.items():
        (tmp / "benchmark/workloads" / f"{name}.json").write_text(json.dumps(cell))
    units = {m["name"]: m for m in real["end_to_end"]}
    e2e = [dict(units["setup_s"])]
    for cell, names in E2E.items():
        for n in names:
            m = next((x for x in e2e if x["name"] == n), None)
            if m is None:
                e2e.append(m := {**units[n], "workloads": []})
            m["workloads"].append(cell)
    per_layer = []
    for m in real["per_layer"]:
        cell = "tiny-train" if m["name"].endswith(".train") else "tiny-chat"
        per_layer.append({**m, "workloads": [cell]})
    bench = dict(real, configs=[dict(name="tiny", source="test", file="benchmark/configs/tiny.json", reduced=[],
                                     why="test")],
                 workloads=[dict(name=n, config=c["config"], traffic=c["traffic"], chips=1, why="test")
                            for n, c in CELLS.items()],
                 end_to_end=e2e, per_layer=per_layer)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
