"""Continuous serving's admissions on traffic whose buckets were not seen before, as a given
tree of the repository serves it: the int8 model at Llama-3.1-8B width cut to 8 layers
(dynamic int8 act; random weights from seed 0), a bf16 KV cache, ``ContinuousScheduler`` with
8 slots, 16-step decode chunks, ``prompt_multiple`` 64, no chunked prefill
(``prefill_chunk=0``, as ``serve_http.py`` defaults) and a prefix cache of 64 entries; the
kernels built from the tree's own sources. Each run, through the graphs and with
``eager=True``, on a scheduler of its own:

- the warm-up: one 40-token request (the decode step's first call; its bucket, 64, is in no
  later request);
- lone admissions on the idle scheduler, for prompts of about 300, 1500 and 3000 tokens: a
  prompt in a bucket not served before (through the graphs: the eager first run, the capture
  and the instantiation), another in the same bucket, a follow-up over the first one's
  harvested prefix (a suffix key not served before), and one over the second's (the same
  key); the TTFT of each (submit to its first streamed token);
- the mix, twice (the second pass the same lengths with other text: the same keys): 32
  prompts of 65 to 3800 tokens (lengths from seed 0) in 8 waves of 4, 0.25 s apart; once every
  one of them has streamed its first token (so that each prefix is harvested, whatever the
  timing), 16 follow-ups that extend 16 of them by 64 to 400 tokens, in 4 waves of 4; 32 new
  tokens each, greedy. TTFT and inter-token latency p50 / p99, tokens/s, prefix hits, the
  distinct admission keys, the captures and their seconds inside each pass, and the device
  memory outside PyTorch's allocator (CUDA graph executables) and the host memory that the
  passes' captures added;
- (through the graphs, where the tree has admission graphs) the shared pool's growth at each
  capture of ``admit_row`` at 7 buckets from 64 to 4032 positions, in rising and in falling
  order, each order over buffers and a pool of its own.

    python diagnostics/admission_mix.py [--tree DIR]

``--tree``: the root of a checkout (default: this one); two checkouts compared in one call on
one card show what a change moved (run them as parent, change, change, parent). Prints one
JSON line: the tree, the card and both runs' numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

LONE = (300, 1500, 3000)


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke
    from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model
    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.models import llama
    from llama_x_tpu_torch.serve.continuous import ContinuousScheduler
    from llama_x_tpu_torch.utils import build

    if not str(Path(chip_smoke.__file__).resolve()).startswith(str(tree)):
        raise RuntimeError(f"chip_smoke came from {chip_smoke.__file__}, not from {tree}")
    smi = chip_smoke.nvidia_smi()
    build.load_library()
    config = llama.LlamaConfig(**{**GEOMETRIES["8b"], "num_layers": 8}, max_seq_len=4096, dynamic_int8_act=True)
    model = build_model(config, True, seed=0, device="cuda")
    tok = ByteTokenizer()
    rng = np.random.default_rng(0)
    base_lens = [int(n) for n in rng.integers(65, 3801, 32)]
    extend = [(int(j), int(n)) for j, n in zip(rng.choice(32, 16, replace=False), rng.integers(64, 401, 16))]

    def admission_runner(sched):
        inputs = getattr(sched, "inputs", None)
        return getattr(inputs, "runner", None)

    def captured(sched) -> tuple[int, float]:
        r = admission_runner(sched)
        return (r.captures, sum(r.capture_s)) if r is not None else (0, 0.0)

    def serve(sched, prompts: list, gap_s: float = 0.25) -> tuple[list, list]:
        lines, handles = [], []
        for w in range(0, len(prompts), 4):
            for p in prompts[w:w + 4]:
                lines.append(chip_smoke._Timeline())
                handles.append(sched.submit(p, max_tokens=32, stream_q=lines[-1]))
            if w + 4 < len(prompts):
                time.sleep(gap_s)
        return lines, handles

    def wait(handles):
        for h in handles:
            if not h.event.wait(900) or h.error is not None:
                raise AssertionError(f"a request failed: {h.error}")

    def lone_ttft(sched, ids) -> float:
        line = chip_smoke._Timeline()
        h = sched.submit(ids, max_tokens=2, stream_q=line)
        wait([h])
        time.sleep(0.5)  # the worker collects the decode chunk it dispatched after the row's last
        return (line.blocks[0][0] - line.t0) * 1e3

    def lone(sched) -> list:
        out = []
        for k, n in enumerate(LONE):
            a, b = chip_smoke.byte_prompt(tok, 500 + 2 * k, n), chip_smoke.byte_prompt(tok, 501 + 2 * k, n - 5)
            row = dict(prompt=n)
            for name, ids in (("new_bucket", a), ("same_bucket", b),
                              ("new_suffix_key", a + chip_smoke.byte_prompt(tok, 600 + k, 101)[1:]),
                              ("same_suffix_key", b + chip_smoke.byte_prompt(tok, 700 + k, 106)[1:])):
                c0 = captured(sched)
                row[name + "_ttft_ms"] = lone_ttft(sched, ids)
                row[name + "_captures"] = captured(sched)[0] - c0[0]
            out.append(row)
        return out

    def mix(sched, offset: int) -> dict:
        bases = [chip_smoke.byte_prompt(tok, offset + i, n) for i, n in enumerate(base_lens)]
        follow = [bases[j] + chip_smoke.byte_prompt(tok, offset + 100 + j, n + 1)[1:] for j, n in extend]
        hits0, c0 = sched.prefix_hits, captured(sched)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines, handles = serve(sched, bases)
        while not all(tl.blocks for tl in lines):  # every base's prefix harvested
            time.sleep(0.005)
        more, more_handles = serve(sched, follow)
        wait(handles + more_handles)
        wall = time.perf_counter() - t0
        c1 = captured(sched)
        total = sum(len(h.tokens) for h in handles + more_handles)
        return dict(requests=len(bases) + len(follow), new_tokens=total, wall_s=wall, tokens_per_s=total / wall,
                    prefix_hits=sched.prefix_hits - hits0, captures=c1[0] - c0[0], capture_s=c1[1] - c0[1],
                    **chip_smoke.latency_stats(lines + more))

    def pool_order() -> dict | None:
        from llama_x_tpu_torch.serve import continuous as cont

        if not hasattr(cont, "AdmitBuffers"):
            return None
        buckets = [64, 128, 256, 512, 1024, 2048, 4032]
        out = {}
        for order in ("rising", "falling"):
            state = cont.init_state(config, 8, torch.bfloat16, "cuda")
            inputs = cont.AdmitBuffers(model, state[0])
            for n in (buckets if order == "rising" else buckets[::-1]):
                cont.admit_row(model, state, inputs, 0, chip_smoke.byte_prompt(tok, 800 + n, n), (0.0, 0, 1.0, 0.0), -1)
            torch.cuda.synchronize()
            out[order] = dict(buckets=buckets if order == "rising" else buckets[::-1],
                              pool_mb=[b / 2**20 for b in inputs.runner.pool_bytes], capture_s=inputs.runner.capture_s)
            del state, inputs
            torch.cuda.empty_cache()
        return out

    runs = {}
    for eager in (False, True):
        dg.release(model)
        sched = ContinuousScheduler(model, n_slots=8, chunk_size=16, prompt_multiple=64, cache_dtype=torch.bfloat16,
                                    prefill_chunk=0, prefix_cache=64, seed=0, eager=eager)
        try:
            lone_ttft(sched, chip_smoke.byte_prompt(tok, 99, 40))
            run = dict(lone=lone(sched))
            torch.cuda.synchronize()
            free0, res0, rss0, cap0 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved(), rss_bytes(), \
                captured(sched)[0]
            run["passes"] = [mix(sched, offset) for offset in (0, 1000)]
            torch.cuda.synchronize()
            free1, res1, rss1, cap1 = torch.cuda.mem_get_info()[0], torch.cuda.memory_reserved(), rss_bytes(), \
                captured(sched)[0]
            r = admission_runner(sched)
            run.update(admission_graphs=None if r is None else len(r.graphs),
                       admission_capture_s=None if r is None else r.capture_s,
                       admission_pool_mb=None if r is None else sum(r.pool_bytes) / 2**20,
                       mix_captures=cap1 - cap0, outside_allocator_mb=((free0 - free1) - (res1 - res0)) / 2**20,
                       allocator_reserved_mb=(res1 - res0) / 2**20, host_rss_mb=(rss1 - rss0) / 2**20)
        finally:
            sched.close()
        runs["eager" if eager else "graph"] = run
    dg.release(model)
    runs["pool_order"] = pool_order()
    print(json.dumps(dict(tree=str(tree), card=smi, torch=torch.__version__, base_lens=base_lens, extend=extend,
                          **runs)))


if __name__ == "__main__":
    main()
