"""Flash-kernel probe on the 8B audio step's attention shape (port of
tools/probe_flash.py): B 1, S 4096, 32/8 heads of 128, bf16, causal with a 2000-token
bidirectional prefix.

    python -m llama_x_tpu_torch.probe_flash [--bq 256 --bk 1024] [--sweep] [--out FILE]

Times the flash forward (K2), forward + backward (K2 + K5) and the matmul-only probe
(K6: the two products and the plan's whole-block skip, no softmax), and prints the three
times and the gap between the forward and the probe. K6 runs K2's own main loop (wgmma, a
TMA ring, tile classes) with the softmax taken out, so the gap isolates what K2's online
softmax, masking and rescaling cost. Timed with CUDA events over ``--reps``
launches after warm-ups (the TPU tool's chained differential timing works around its
host link and is not needed here). ``--bq`` / ``--bk`` are the JAX plan's blocks: they
key the probe's skip; they do not tile K2 or K5. ``--sweep`` times the probe over the TPU tool's (bq, bk) grid. Runs on the card
unless ``--device cpu`` (a host-clock time of the plain versions, for smoke tests).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from llama_x_tpu_torch.ops import flash_attention as fa
from llama_x_tpu_torch.ops import flash_probe as fp
from llama_x_tpu_torch.ops.attention import MaskInfo
from llama_x_tpu_torch.utils.device import resolve_device

HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
SWEEP = [(bq, bk) for bq in (128, 256) for bk in (512, 1024, 2048)]


def make_inputs(seq_len: int, device, seed: int = 0):
    """q, k, v and a cotangent, from numpy draws scaled by 0.3 (the TPU tool's inputs)."""
    rng = np.random.default_rng(seed)

    def mk(heads):
        a = rng.standard_normal((1, seq_len, heads, HEAD_DIM), np.float32) * 0.3
        return torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)

    return mk(HEADS), mk(KV_HEADS), mk(KV_HEADS), mk(HEADS)


def time_ms(fn, device, reps: int, warmup: int = 3) -> float:
    """Mean ms of one call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def run(args) -> dict:
    device = resolve_device(args.device)
    S, prefix = args.seq_len, args.prefix
    q, k, v, ct = make_inputs(S, device)
    mi = MaskInfo(causal=True, prefix_len=torch.tensor([prefix], dtype=torch.int32, device=device))
    reps = args.reps
    results = {"device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               "clock": "cuda events" if device.type == "cuda" else "host clock, plain versions",
               "shape": dict(B=1, S=S, Hq=HEADS, Hkv=KV_HEADS, D=HEAD_DIM, prefix=prefix)}
    if args.sweep:
        for bq, bk in SWEEP:
            ms = time_ms(lambda: fp.flash_probe(q, k, v, bq, bk, prefix), device, reps)
            results[f"bq{bq}_bk{bk}"] = {"probe_matmul_only_ms": ms}
            print(f"bq={bq} bk={bk}: mm-probe {ms:8.3f} ms", flush=True)
        return results

    def fwd():
        return fa.flash_fwd_with_lse(q, k, v, mi)

    def fwdbwd():
        out, lse = fwd()
        return fa.flash_bwd_from_res(q, k, v, out, lse, ct, mi)

    with torch.no_grad():
        results["fwd_ms"] = time_ms(fwd, device, reps)
        print(f"fwd        {results['fwd_ms']:8.3f} ms", flush=True)
        results["fwdbwd_ms"] = time_ms(fwdbwd, device, max(reps // 2, 1))
        print(f"fwd+bwd    {results['fwdbwd_ms']:8.3f} ms", flush=True)
        results["probe_matmul_only_ms"] = time_ms(lambda: fp.flash_probe(q, k, v, args.bq, args.bk, prefix), device,
                                                  reps)
        print(f"mm-probe   {results['probe_matmul_only_ms']:8.3f} ms", flush=True)
    results["fwd_minus_probe_ms"] = results["fwd_ms"] - results["probe_matmul_only_ms"]
    print(f"fwd - probe {results['fwd_minus_probe_ms']:7.3f} ms (K2's softmax, masking and rescaling)", flush=True)
    return results


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--bq", type=int, default=256)
    ap.add_argument("--bk", type=int, default=1024)
    ap.add_argument("--sweep", action="store_true", help="time the probe over the (bq, bk) grid")
    ap.add_argument("--seq_len", type=int, default=4096)
    ap.add_argument("--prefix", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    results = run(args)
    if args.out:
        p = Path(args.out)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(results, indent=1))
        print(f"wrote {p}")
    return results


if __name__ == "__main__":
    main()
