"""Continuous serving's TTFT, inter-token latency, tokens/s and a wave's device busy share, as
a given tree of the repository measures them: its own ``chip_smoke.phase_continuous`` on the
int8 model at Llama-3.1-8B width cut to its ``SERVING_LAYERS`` (dynamic int8 act, int8 KV
cache; random weights from seed 0), its kernels built from its own sources.

    python diagnostics/continuous_ttft.py [--tree DIR]

``--tree``: the root of a checkout (default: this one); two checkouts compared in one call
on one card show what a change moved (run them as parent, change, change, parent). Prints
the phase's log, then one JSON line: the tree, the card, and the graph run's and the eager
run's numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke
    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model
    from llama_x_tpu_torch.models import llama

    if not str(Path(chip_smoke.__file__).resolve()).startswith(str(tree)):
        raise RuntimeError(f"chip_smoke came from {chip_smoke.__file__}, not from {tree}")
    smi = chip_smoke.nvidia_smi()
    chip_smoke.phase_build()
    config = llama.LlamaConfig(**{**GEOMETRIES["8b"], "num_layers": chip_smoke.SERVING_LAYERS}, max_seq_len=4096,
                               dynamic_int8_act=True)
    model = build_model(config, True, seed=0, device="cuda")
    res = chip_smoke.phase_continuous(model)
    keys = ("ttft_ms_p50", "ttft_ms_p99", "itl_ms_p50", "itl_ms_p99", "tokens_per_s", "prefix_hits",
            "prefill_dispatches", "admission_captures", "admission_captures_in_waves")

    def pick(run: dict) -> dict:
        out = {k: run[k] for k in keys if k in run}
        if "profile" in run:
            out["wave_busy_share"] = run["profile"]["device_busy_share"]
            out["wave_wall_ms"] = run["profile"]["wall_ms_per_step"]
        return out

    print(json.dumps(dict(tree=str(tree), card=smi, torch=torch.__version__, graph=pick(res),
                          eager=pick(res["eager"]))))


if __name__ == "__main__":
    main()
