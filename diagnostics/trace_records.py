"""How completely a torch.profiler trace records the kernels of decode steps, replayed from
the captured graph or launched eagerly, held to the kernel wrappers' launch counts.

    python diagnostics/trace_records.py [--layers 32] [--steps 8] [--reps 16]

The int8 model at Llama-3.1-8B width (dynamic int8 act, int8 KV cache; random weights from
seed 0), B 4, prompts of 512 random tokens. For the graph and for the eager loop: one
prefill, then ``--reps`` windows of ``--steps`` decode steps on the same state, each under
the profiler (CUDA activity) with the counts reset before it. A window's trace is short
where it shows fewer kernels of a counted wrapper than the wrapper counted
(``launches.traced_counts``); its device records are printed beside, which every complete
trace of a window repeats exactly. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model  # noqa: E402
from llama_x_tpu_torch.models import llama  # noqa: E402
from llama_x_tpu_torch.models.generate import decode_chunk, prefill_start  # noqa: E402
from llama_x_tpu_torch.ops import launches  # noqa: E402


def window(model, state, steps: int, eager: bool) -> dict:
    for fn in launches.COUNTED.values():
        fn.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode_chunk(model, state, steps, eager=eager)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    seen = launches.traced_counts(names)
    want = {g: sum(launches.COUNTED[n].launches for n in g.split(" + ")) for g in seen}
    return dict(records=len(names), short={g: want[g] - seen[g] for g in seen if seen[g] != want[g]})


def main(argv: list[str]) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--reps", type=int, default=16)
    args = p.parse_args(argv)
    config = llama.LlamaConfig(**{**GEOMETRIES["8b"], "num_layers": args.layers}, max_seq_len=4096,
                               dynamic_int8_act=True)
    model = build_model(config, True, seed=0, device="cuda")
    prompt = torch.randint(0, 256, (4, 512), generator=torch.Generator().manual_seed(0)).cuda()
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), layers=args.layers, steps=args.steps)
    for kind in ("graph", "eager"):
        eager = kind == "eager"
        _, state = prefill_start(model, prompt, cache_dtype=torch.int8, max_new_tokens=args.steps * (args.reps + 1),
                                 eager=eager)
        decode_chunk(model, state, args.steps, eager=eager)  # the capture, outside the windows
        runs = [window(model, state, args.steps, eager) for _ in range(args.reps)]
        out[kind] = dict(traces=len(runs), short=sum(bool(r["short"]) for r in runs),
                         records=[r["records"] for r in runs], lost=[r["short"] for r in runs if r["short"]])
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
