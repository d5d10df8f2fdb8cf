#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llama_x_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--only hybrid]

Phases, each of which raises on failure (the script then exits non-zero and prints
no result line):
1. build: the card's name and power limit (nvidia-smi), the nvcc build of every
   kernel from csrc/ with its time and the ptxas register / spill summary;
2. kernels: each hand-written kernel against its plain PyTorch version on the card,
   at the serving and training paths' shapes, with the tolerance stated beside it,
   timed with CUDA events beside the plain version, a PyTorch yardstick (never called
   by the port) and the least time the card could take (bound); K1 and K3 also with
   their plan (path, splits), rate, share of bound and profiler device time (theirs
   and the yardstick's: below about 0.05 ms a call the event times are the host's), K4
   likewise with its plan (m tile, splits), K1 and K4 each with their chosen plan against
   its alternatives, and K6 with its device time and tile census; K2 and K5 also at the
   vision and omni steps' masks (prefix 272 of S 304, B 8; prefix 1772 of S 4096), K1 and
   K4 at the omni step's 581-row CE chunk; K2's offsets form over a [B, 8, 4096, 128] cache
   (a continuation chunk of 512 rows at 1536 over kv_len 2048, bf16 and int8 cache; a prefix
   admission; a verify at gamma 8 over 8 slots) against its plain version, with SDPA on the
   sliced cache as the yardstick; K2's ring form and K5's offsets form (ring attention's
   blocks) at the four blocks of a ring of 2 (q / kv offsets (0, 0), (4096, 0), (4096, 4096),
   (0, 4096): diagonal, full, diagonal, skipped; S_local 4096, 32/8 heads, D 128) under causal,
   packed-document (crossing the shard boundary), prefix-LM 2000, prefix-LM 5000 (past the
   first shard: the global prefix test decides) and non-causal masks, with their tile
   census and SDPA on the block's bool mask as the yardstick; K1 and K4 at the tensor-parallel
   shard shapes of 8B width (tp 2: wq N 2048, wk / wv N 512, wo K 2048, w1 / w3 N 7168, w2
   K 7168 and the head's vocabulary shard N 64128; tp 4's N 32064, not a multiple of 128; K4
   at the matching input gradients and the CE dH over K 64128 / 32064), bit for bit, with
   plan, bound and ``_int_mm``;
3. serving main path: ``generate`` at Llama-3.1-8B width (32 layers) from seeded
   on-device weights, B 4, ragged byte-tokenized prompts padded to 512, 32 new
   tokens: bf16 weights with a bf16 cache, then int8 weights with dynamic int8
   activations and an int8 cache; the prefill one replay of the graph captured for its
   prompt shape and each decode step one replay of the captured CUDA graph
   (models/decode_graph.py; capture + instantiate seconds and the pool's memory printed);
   each run's kernel launch counts are reset before it and must be non-zero after it;
   three timed requests (the spread of decode tok/s), then the eager loop on the same batch
   as the reference: tokens equal (else the near-tie rule, counted), launches equal, and
   wall against device-busy per step of both (profiler); the prefill's replay against
   ``eager=True`` (``check_prefill``: the first token, state and every cache tensor over the
   prompt bit for bit, each timed, their device busy share, the replay's launches held to the
   device trace, capture seconds and the pool); then ``generate_speculative`` on
   the same int8 model (int8 cache) with an untrained 4-layer draft of width 1024, B 4,
   32 new tokens, gamma 4: every round one replay of the captured round, its launches held
   to the device trace, tokens and launches equal to ``eager=True``'s; its two prefills, first
   token and state fill one graph held to their eager body bit for bit (``check_spec_prefill``);
4. kernel path against plain path: on a 2-layer cut of the same weights, prefill and
   first-decode logits of the kernels and of their plain versions agree;
4a. the schedulers' admission programs on a 2-layer cut of the int8 model with a 2-layer
   draft, bf16 and int8 caches (``check_admissions``): ``admit_row`` at 3 buckets,
   ``admit_row_prefix`` at 2 (P0, Sb) pairs, a chunked prefill with its install and
   ``spec_admit_row``, each through its graph (captured per bucket) against ``eager=True``:
   first tokens and every state tensor bit for bit, a pass of replays launching what the
   eager pass launches, held to the device trace;
3a. continuous serving on the first 4 of the 32 layers of phase 3's int8 model (a depth cut,
   int8 KV): ``ContinuousScheduler`` with
   8 slots, 16-step chunks, chunked prefill of 512 and a prefix cache of 4; 16 byte-token
   requests in four waves 0.25 s apart (8 prompts of 130 to 1500 tokens, 8 follow-ups that
   extend them), TTFT / inter-token latency p50 and p99, tokens/s, prefix hits, the launches
   of K1, K2 (self and offsets) and K3, every row against an unbatched ``generate`` under
   the near-tie rule (a divergence only where the two tokens lie within K2's tolerance of
   each other in the unbatched logits of that step, counted); each decode step, prefill chunk
   and row install a replay of its captured graph (the admission programs captured in a
   warm-up, those captured inside the timed waves counted), then the same traffic with
   ``eager=True`` beside it (TTFT, ITL, tokens/s, the busy share of a profiled wave in both;
   its rows against the graph's);
3b. speculative serving: the same 4-layer int8 target (bf16 cache) and an untrained 4-layer draft
   of width 1024, gamma 4 (verify on K3) and gamma 8 (verify on K2's offsets form), each
   round a replay of ``spec_chunk``'s captured round and then the eager rounds beside it
   (tok/s, the tokens equal bit for bit), the acceptance rate, every row against plain
   greedy under the near-tie rule, TTFT beside the eager run's (each ``spec_admit_row`` a
   replay of its bucket's graph, captured in a warm-up); a round's wall against its device
   busy time (graph and eager), its launches held to the device trace; then
   ``generate_speculative`` at gamma 8
   over the int8 cache (K2's offsets form over the static kv bound), graph against eager;
3c. the HF round trip of a 2-layer cut at 8B width (bf16, about 3 GB, bit for bit) through a
   training run and ``export_checkpoint`` with its default device (the card; greedy tokens of
   the export equal to the cut's) and ``generate_cli --model`` on it; 3d. ``serve_http`` in-process on 127.0.0.1:0 over the
   4-layer int8 model (continuous, chunked prefill): 4 concurrent completions and a streamed chat,
   each answer's finish_reason and its tokens against a second serving (near-tie rule);
5. training main path: QLoRA optimizer steps at Llama-3.1-8B width (32 layers, int8
   base, LoRA r 8 on every projection, frozen bf16 head on the int8 kernels, dynamic
   int8 activations and input gradients, fused CE in 8 chunks, per-block activation
   checkpointing) on packed byte-token rows with segment ids at S 4096, microbatch 1,
   accumulation 2, AdamW, 4 steps on one repeated step batch, each a replay of the captured
   CUDA graphs (train/step_graph.py; the first step runs eagerly and captures: its seconds,
   the capture + instantiate seconds and the pool are printed): the launches of every step
   held to ``expected_launches``, losses and grad norms finite, the loss falling, the adapters
   moving and the int8 base as it was; then two replays under the profiler, their launches
   held to the device trace, and one eager step (``eager=True``) under the profiler with the
   rowwise quantizer's calls bracketed so that its device time is read apart: wall against
   busy, capture, pool and peak memory of graph and eager on one line (``GRAPH vs EAGER``);
5a. the train graph against the eager step: on a 2-layer cut of the same width, 4 steps through
   the graphs against 4 eager steps from the same weights and batches, bit for bit;
6. training kernel path against plain path: loss and adapter gradients of one
   microbatch on a 2-layer cut of the trained weights, through the kernels and through
   their plain versions;
7. the probe entry point: ``probe_flash`` at the audio step's attention shape (K2, K2 + K5
   and the matmul-only K6), which must launch K6;
8. the audio main path: the headline step of the repository, through
   ``train_librispeech``'s own functions: Llama-3.1-8B QLoRA (32 layers, int8 base, LoRA
   r 8, int8 act / dgrad / head, fused CE x8, stem and embeddings frozen) on 40 s of audio
   (2000 audio tokens prepended to 2096 text tokens), prefix-LM attention,
   ``remat_policy="flash_q8s"``, microbatch 1, AdamW 1e-4, 4 steps on one repeated batch,
   the launch counts held to what the policy must give, graph replays against a profiled
   eager step as in phase 5, then the same step on the first 4 layers (a depth cut) under
   ``full``, ``flash_proj``, without checkpointing, and under the int8-residual attention
   ``attn_q8`` / ``attn_q8s`` (each a key
   of the graphs: an eager step and the capture, a replay and a traced replay, launches held:
   no K1 in the attention backward; best step, positions/s and peak beside flash_q8s's; one
   profiled eager attn_q8s step with the rowwise quantizer's device time);
9. audio kernel path against plain path on a 2-layer cut with ``attn_dropout=0.1`` and
   fixed seeds, and on a 2-layer cut under ``attn_q8s``;
10. the vision main path: one 8B QLoRA trunk with both stems, cut to its first 8 layers, is
   built for phases 10 to 12; the vision step through ``train_vision``'s functions (8 canvases of 224, patch
   14: 272 image tokens before 32 caption bytes, S 304, prefix-LM, remat ``full``, fused
   CE x4), 4 steps through the graphs with the launch counts held every step, a replay held
   to its device trace, a profiled eager step, and a 2-layer kernel-vs-plain comparison of
   loss and adapter gradients;
11. the omni main path (BASELINE config 5 at tools/bench_omni.py's geometry) through
   ``train_omni``'s functions: 30 s of audio (1500 tokens) + one 224 image (272) + 2324
   text = S 4096, prefix-LM 1772, remat ``flash_proj``, fused CE in 4 chunks of 581 rows;
   the same checks;
12. the evaluations at 8B width on the trained trunk: ``eval_vision``'s captions (8
   eval-split canvases) and ``eval_librispeech``'s transcripts (4 x 20 s: 1000 audio
   tokens), 16 new tokens each through K1, K2 with the prefix and K3, with prefill ms (the
   prefill's replay against ``eager=True``, ``check_prefill``), decode tok/s and the score,
   and each first token's and first decode step's logits
   on a 2-layer cut against the plain path;
13. real data, host path: ``train_librispeech.main`` over a LibriSpeech-layout directory
   of WAV files written here, 2 steps on a 2-layer cut of the 8B geometry;
14. the four new entry points (``train_vision``, ``train_omni``, ``eval_vision``,
   ``eval_librispeech``) called as a user calls them, at their smoke sizes;
14a. the learned-task entry points (``wer_synthetic``, ``vision_synthetic``, ``omni_synthetic``,
   ``int8_bwd_quality``, ``int8_head_quality``) through their own ``main``, 30 steps each with
   heads of 64 in bf16, the checkpoint round trip and 4 held-out samples: the loss falls, the
   kernels of each run launch (K2 / K5 / K3; K1 / K4 / K2 / K5), every train step replays its
   graphs, each run's launches equal its device trace, the artifacts go to a temporary
   directory (the full runs are calls of their own);
14b. the trainer pieces: ``train_metamathqa`` from a MetaMathQA token cache written to a
   temporary directory (real-data path), 7 QLoRA steps at 8B width cut to 2 layers through
   the prefetched step batches, ``--profile`` (its trace of steps 5 and 6 must name K1's and
   K2's kernels), then ``generate_cli --resume`` on that run with ``--template alpaca``;
15. context parallelism: the text QLoRA step of phase 5 at Llama-3.1-8B width with its
   depth cut to 2 layers, S 8192 of packed documents crossing the shard boundary, at cp 2:
   two spawned processes share the one card over gloo (asked for by name: NCCL refuses two
   ranks on one device), each holding 4096 positions, through ``train_metamathqa``'s own
   functions (``parse_args`` with ``--mesh '{"cp": 2}'``, the mesh, ``validate_launch`` /
   ``validate_model``, the dp split, ``make_train_step`` over the mesh); ring attention for
   3 steps then Ulysses for 1 under remat "full", then one step of each under
   ``--remat_policy attn_q8s`` (the int8-residual attention over the ring or Ulysses), the
   launches of K2's ring form and K5's offsets form (ring) or K2 / K5 (Ulysses) held to
   ``cp_expected_launches`` every step on every rank, and the K1 launches of an attn_q8s
   rank-step to those of the attn_q8s step at cp 1 (no GEMM runs again in its backward); the
   loss and LoRA gradients at the first step (ring and Ulysses, under both policies) and every
   step's loss against the same step at cp 1 in this process over the whole 8192; per rank
   the step time, the peak memory and the exchange's share of the step (gloo through host
   memory). A rank that fails or outlives its timeout fails the phase;
16. slice 5b: the same text QLoRA step at Llama-3.1-8B width (2 layers, S 4096 packed
   documents, remat full, CE x8) through ``train_metamathqa``'s own functions in two spawned
   processes sharing the card over gloo, at ``--mesh '{"tp": 2}'`` (1 row), ``'{"fsdp": 2}'``
   (2 rows) and ``'{"pp": 2}' --pp_microbatches 2`` (2 rows), 2 steps each: the first step's
   loss and gathered LoRA gradients against the same step in this process at the mesh's
   batch (1e-3 of |loss|, relative L2 2^-6), the launches of K1 / K2 / K4 / K5 / K7 held every
   step to ``p5b_expected_launches`` (at tp K7's two passes on the rows "tp" splits), per rank the step time, the exchange's share, the bytes
   moved and the peak memory (fsdp's below one process's at a rank's one row); then
   ``generate`` at tp 2 on the first 4 layers of phase 3's int8 model (int8 KV on the local
   heads, B 4, prompts padded to 512, 32 new tokens), every rank's rows the same and each
   held against an unsharded ``generate`` under the near-tie rule, with decode tok/s and
   the exchange's share.
17. the hybrid (Nemotron-H-47B's state-space layer, ``--only hybrid`` runs this phase after
   the build alone): at the 47B's widths (256 heads of 64 over a state of 256 in 8 groups, the
   conv over 20480 channels, the gated norm over 16384 in 8 groups), K8 ``ssd_scan`` over
   512-token spans (fresh, from a lane, a snapshot at an interior offset, pads after the real
   positions), K9 ``ssd_step`` over 16 slots (one in three done), the Triton passes
   ``ssd_conv`` and ``gated_norm``, each against its plain version on the same inputs (K8 / K9
   within 2e-4 of each output's largest value, the conv lanes and a done slot's lanes bit for
   bit, the passes within one bf16 step), timed beside the plain version and the bound (f32
   at 67 TFLOP/s); then a hybrid of the 47B's 98-block pattern at small widths through the
   scheduler's programs: the launches of one prefill-chunk replay and of one decode-step
   replay, the counts reset just before, held to the device trace and to one K8, conv and
   gated norm a Mamba-2 block for the chunk and one K9 and gated norm for the step.

Every shape's numbers are printed as the phases run. The second-to-last line of
stdout is the kernels' JSON record (primary shape of each kernel, launches on the
main path), the last line ``{"ok": true, "device": {...}}``. Needs a CUDA card;
fails without one.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12,  # dense tensor-core rates, same source
            "f32": 67e12}  # float32 outside the tensor cores (K8, K9)

ROOT = Path(__file__).resolve().parent


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else f"nvidia-smi rc={out.returncode}"


def bound_ms(n_bytes: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_split_ms(fn, keys: tuple[str, ...], reps: int = 10) -> dict:
    """Device ms per call of each kernel whose name holds one of ``keys``, from
    torch.profiler over ``reps`` calls, and the host's ms per call to issue ``fn`` (the
    wrapper's Python, ctypes and launch; a reading of ``time_ms`` below the device time is
    the kernel's, one at the host time is the wrapper's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {k: sum(getattr(e, "device_time_total", 0) for e in prof.key_averages() if k in e.key) / reps / 1e3
           for k in keys}
    return {**out, "host_ms": host}


def library_device_ms(fn) -> float:
    """Device ms per call of every kernel a yardstick call launches (profiler): beside a
    kernel's own device time where the event times of both are paced by the host."""
    return device_split_ms(fn, ("",))[""]


def maybe_ms(fn) -> float | None:
    """A yardstick's time, or None where PyTorch offers no such call for the shape."""
    try:
        fn()
    except (RuntimeError, ValueError, TypeError) as e:
        log(f"    yardstick unavailable: {type(e).__name__}: {str(e).splitlines()[0][:120]}")
        return None
    return time_ms(fn)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check(name: str, err: float, tol: float):
    status = "ok" if err <= tol else "FAIL"
    log(f"    {name}: max_abs_err {err:.3e} (tol {tol:.1e}) {status}")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > tol {tol}")


def check_close(name: str, got, want, atol, rtol: float) -> float:
    """Per element |got - want| <= atol + rtol |want|, atol a number or a tensor that
    broadcasts against want; returns the max abs error. Logs the largest share of atol
    that any element uses once rtol |want| is taken off (above 1 fails)."""
    import torch

    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    used = float(((diff - rtol * ref) / torch.as_tensor(atol, device=diff.device).clamp(min=1e-30)).max().clamp(min=0.0))
    err = float(diff.max())
    status = "ok" if used <= 1.0 else "FAIL"
    log(f"    {name}: max_abs_err {err:.3e}, max((|err| - {rtol:.2e}|ref|) / atol) {used:.4f} "
        f"(atol up to {float(torch.as_tensor(atol).max()):.1e}) {status}")
    if not used <= 1.0:
        raise AssertionError(f"{name}: |err| - {rtol}|ref| reaches {used} of atol")
    return err


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------


def phase_build():
    from llama_x_tpu_torch.utils import build

    build.library_path().unlink(missing_ok=True)  # time and show a fresh build
    t0 = time.perf_counter()
    build.load_library()
    dt = time.perf_counter() - t0
    log(f"[build] nvcc sm_90a, {len(build._sources())} sources -> one .so in {dt:.1f} s")
    for line in build.build_log.splitlines():  # ptxas also says where it serializes wgmma
        if line.startswith("==") or "registers" in line or "spill" in line or "wgmma" in line:
            log("   ", line.strip())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def phase_k1():
    import torch

    from llama_x_tpu_torch.ops import int8_mm as mm

    log("[K1 int8_mm_dequant_nt (b as [N, K])] vs plain (float64-exact sum); tol 0: bit for bit")
    g = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    # (M, N, K): decode (M = batch), prefill (M = B * S) and a training microbatch of 4096
    # positions through wq / wo, wk / wv, w1 / w3 and w2; then the fused CE head with
    # int8_head (f32 out): the logits of one 512-row chunk against the [V, D] head, and a
    # contraction over the vocabulary; then the audio step's chunk (2096 text rows in 8
    # chunks); last M 17 (the stream path past one 16-row tile of a), 64 and 65 (the wgmma
    # path on either side of a warpgroup's 64 rows); phase_k1_plans places the threshold
    return int8_mm_cases(mm.int8_mm_dequant_nt, mm.int8_mm_dequant_nt_plain, True, g, [
        (M, N, K, bf16) for M in (4, 2048, 4096) for N, K in ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))
    ] + [(512, 128256, 4096, f32), (512, 4096, 128256, f32), (262, 128256, 4096, f32)]
      + [(M, 14336, 4096, bf16) for M in (17, 64, 65)]
      + [(581, 128256, 4096, f32)])  # the omni step's CE logits chunk: 2324 text rows in 4 chunks


def phase_k1_plans() -> list[dict]:
    """K1's plan against its alternatives (ops/int8_mm.py:int8_mm_plan), device ms from the
    profiler (the event times of these calls are the host's): the stream / wgmma threshold
    at N 14336, K 4096 (the w1 / w3 decode and prefill shape), split-K on the stream path,
    and split-K against a narrower tile on the wgmma path. Every forced plan bit for bit."""
    import torch

    from llama_x_tpu_torch.ops import int8_mm as mm

    log("[K1 plans] device ms of the plan int8_mm_plan picks and of its alternatives")
    g = torch.Generator(device="cuda").manual_seed(11)
    cases = [((M, 14336, 4096), [("stream", 64, 1), ("wgmma", 128, 1)]) for M in (4, 16, 32, 48, 49, 64)] + [
        ((4, 4096, 14336), [("stream", 64, 1), ("stream", 64, 3), ("stream", 64, 7)]),
        ((2048, 1024, 4096), [("wgmma", 256, 1), ("wgmma", 256, 2), ("wgmma", 128, 1)]),
        ((512, 4096, 128256), [("wgmma", 256, 1), ("wgmma", 256, 2), ("wgmma", 128, 1)]),
        ((128, 4096, 128256), [("wgmma", 256, 1), ("wgmma", 256, 8), ("wgmma", 128, 4)]),
        # the omni step's CE logits chunk: a last 256-row tile of 69 rows
        ((581, 128256, 4096), [("wgmma", 256, 1), ("wgmma", 128, 1)]),
    ]
    recs = []
    for (M, N, K), plans in cases:
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda", generator=g)
        b = torch.randint(-127, 128, (N, K), dtype=torch.int8, device="cuda", generator=g)
        rs, cs = torch.rand(M, device="cuda", generator=g), torch.rand(N, device="cuda", generator=g)
        want = mm.int8_mm_dequant_nt_plain(a, b, rs, cs)
        times = {}
        for plan in plans:
            if not torch.equal(mm.int8_mm_dequant_nt(a, b, rs, cs, plan=plan), want):
                raise AssertionError(f"M={M} N={N} K={K} plan {plan}: not bit-identical to the plain version")
            times["/".join(map(str, plan))] = device_split_ms(lambda: mm.int8_mm_dequant_nt(a, b, rs, cs, plan=plan),
                                                              ("int8_mm_",))["int8_mm_"]
        chosen = mm.int8_mm_plan(M, N, K)
        log(f"    M={M} N={N} K={K}: plan {'/'.join(map(str, chosen))}; device ms "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
        recs.append(dict(M=M, N=N, K=K, plan=list(chosen), device_ms=times))
        del a, b, want
    return recs


def phase_k4_plans() -> list[dict]:
    """K4's plan against its alternatives (ops/int8_mm.py:int8_mm_kn_plan), device ms from the
    profiler: the m tile at the input gradients of an S 4096 step (w1 / w3, w2, wq / wo,
    wk / wv), and the m tile against split-K at the CE head's dH (M 512), the audio step's
    262-row dH chunk and two M beside it. Every forced plan bit for bit."""
    import torch

    from llama_x_tpu_torch.ops import int8_mm as mm

    log("[K4 plans] device ms of the plan int8_mm_kn_plan picks and of its alternatives")
    g = torch.Generator(device="cuda").manual_seed(14)
    wide, dh = [(256, 1), (128, 1)], [(256, 1), (256, 2), (128, 1), (128, 2)]
    # the dH at 384 and 256 rows beside the audio step's 262: a last 256-m tile partial or whole
    cases = [((4096, 4096, 14336), wide), ((4096, 14336, 4096), wide), ((4096, 4096, 4096), wide),
             ((4096, 4096, 1024), wide), ((512, 4096, 128256), dh), ((384, 4096, 128256), dh),
             ((262, 4096, 128256), dh), ((256, 4096, 128256), [(256, 2), (256, 4), (128, 2)]),
             ((581, 4096, 128256), dh)]  # the omni step's dH chunk: 96 tiles of 256, more than half the SMs
    recs = []
    for (M, N, K), plans in cases:
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda", generator=g)
        b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda", generator=g)
        rs, cs = torch.rand(M, device="cuda", generator=g), torch.rand(N, device="cuda", generator=g)
        out_dtype = torch.float32 if K == 128256 else torch.bfloat16
        want = mm.int8_mm_dequant_plain(a, b, rs, cs, out_dtype)
        times = {}
        for plan in plans:
            if not torch.equal(mm.int8_mm_dequant(a, b, rs, cs, out_dtype, plan=plan), want):
                raise AssertionError(f"M={M} N={N} K={K} plan {plan}: not bit-identical to the plain version")
            times["/".join(map(str, plan))] = device_split_ms(
                lambda: mm.int8_mm_dequant(a, b, rs, cs, out_dtype, plan=plan), ("int8_mm_",))["int8_mm_"]
        chosen = mm.int8_mm_kn_plan(M, N, K)
        log(f"    M={M} N={N} K={K}: plan {'/'.join(map(str, chosen))}; device ms "
            + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
        recs.append(dict(M=M, N=N, K=K, plan=list(chosen), device_ms=times))
        del a, b, want
    return recs


def int8_mm_cases(kernel, plain, b_nk: bool, g, cases) -> list[dict]:
    """One int8 GEMM form at (M, N, K, out dtype) cases: bit for bit against its plain
    version (tol 0), timed beside bound, plain and torch._int_mm, with the plan it ran:
    K1's (path, tile width, splits) or K4's (m tile, splits)."""
    import torch

    from llama_x_tpu_torch.ops import int8_mm as mm

    shapes = []
    for M, N, K, out_dtype in cases:
        a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda", generator=g)
        b = torch.randint(-127, 128, (N, K) if b_nk else (K, N), dtype=torch.int8, device="cuda", generator=g)
        rs = torch.rand(M, device="cuda", generator=g) * 0.02
        cs = torch.rand(N, device="cuda", generator=g) * 0.001
        got = kernel(a, b, rs, cs, out_dtype=out_dtype)
        torch.cuda.synchronize()
        want = plain(a, b, rs, cs, out_dtype=out_dtype)
        name = f"M={M} N={N} K={K} {str(out_dtype).split('.')[1]}"
        err = max_err(got, want)
        check(name, err, 0.0)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: not bit-identical to the plain version")
        del got, want
        ms = time_ms(lambda: kernel(a, b, rs, cs, out_dtype=out_dtype))
        plain_ms = time_ms(lambda: plain(a, b, rs, cs, out_dtype=out_dtype), reps=2, warmup=1)
        lib_ms = maybe_ms(lambda: torch._int_mm(a, b.T if b_nk else b))
        out_bytes = 4 if out_dtype == torch.float32 else 2
        bms, by = bound_ms(M * K + N * K + 4 * (M + N) + out_bytes * M * N, 2 * M * N * K, "int8")
        split = device_split_ms(lambda: kernel(a, b, rs, cs, out_dtype=out_dtype), ("int8_mm_",))
        dev = split["int8_mm_"]
        lib_dev = library_device_ms(lambda: torch._int_mm(a, b.T if b_nk else b)) if lib_ms is not None else None
        plan = (dict(zip(("path", "tile", "splits"), mm.int8_mm_plan(M, N, K))) if b_nk else
                dict(zip(("tile", "splits"), mm.int8_mm_kn_plan(M, N, K))))
        tops = 2 * M * N * K / (ms * 1e-3) / 1e12
        log(f"      {ms:.4f} ms (plain {plain_ms:.3f}, _int_mm {lib_ms}, bound {bms:.4f} by {by}); {tops:.1f} TOP/s, "
            f"{bms / ms:.3f} of bound; device {dev:.4f} ms (profiler, {bms / dev if dev else 0:.3f} of bound; _int_mm "
            f"{lib_dev}), host {split['host_ms']:.4f} ms a call; {plan}")
        shapes.append(dict(M=M, N=N, K=K, out=str(out_dtype).split(".")[1], max_abs_err=err, tol=0.0, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by, tops=tops,
                           device_ms=dev, library_device_ms=lib_dev, host_ms=split["host_ms"], **plan))
        del a, b
    return shapes


def phase_k4():
    import torch

    from llama_x_tpu_torch.ops import int8_mm as mm

    log("[K4 int8_mm_dequant (b as [K, N])] vs plain (float64-exact sum); tol 0: bit for bit")
    g = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    # (M, N, K) with K = out-features, N = in-features: the input gradients of an S 4096
    # step through w2, w1 / w3, wq / wo and wk / wv, a ragged case, then the fused CE head:
    # dH of one 512-row chunk, which contracts over the vocabulary, and the same GEMM the
    # other way round (the JAX package's [D, V] head reads its logits in this form); last the
    # audio step's dH chunk (262 rows) and the omni step's (581 rows)
    return int8_mm_cases(mm.int8_mm_dequant, mm.int8_mm_dequant_plain, False, g, [
        (4096, 14336, 4096, bf16), (4096, 4096, 14336, bf16), (4096, 4096, 4096, bf16), (4096, 4096, 1024, bf16),
        (300, 4112, 1040, bf16), (512, 4096, 128256, f32), (512, 128256, 4096, f32), (262, 4096, 128256, f32),
        (581, 4096, 128256, f32)])


def packed_segments(S: int):
    """[1, S] sorted segment ids of 8 packed documents (the same ids wherever they are used)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(8)
    return torch.sort(torch.randint(1, 9, (1, S), device="cuda", generator=g), dim=1).values.to(torch.int32)


def _attn_inputs(g, B, S, Hq, Hkv, D):
    import torch

    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)
    return mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)


def tile_census(fa, mi, B: int, S: int, bq: int, bk: int) -> dict:
    """The tiles of one head at a kernel's tiling (bq query rows x bk kv positions), summed
    over the batch rows, by the predicate the kernels mirror (ops/flash_attention.py:
    tile_class): computed (partial + full), of them full (no mask code), and skipped."""
    seg = None if mi.segment_ids is None else mi.segment_ids.expand(B, S).cpu()
    kseg = seg if mi.kv_segment_ids is None else mi.kv_segment_ids.expand(B, S).cpu()
    prefix = None if mi.prefix_len is None else mi.prefix_len.reshape(-1).expand(B).tolist()

    def ranges(ids, b, n):
        return [None if ids is None else (int(ids[b, x:x + n].min()), int(ids[b, x:x + n].max()))
                for x in range(0, S, n)]

    n = {"skip": 0, "partial": 0, "full": 0}
    for b in range(B):
        kr = ranges(kseg, b, bk)
        for i, qr in enumerate(ranges(seg, b, bq)):
            for j in range(len(kr)):
                n[fa.tile_class(i * bq, j * bk, bq, bk, S, bool(mi.causal), None if prefix is None else prefix[b],
                                qr, kr[j])] += 1
    return dict(computed=n["partial"] + n["full"], full=n["full"], skipped=n["skip"])


def census_text(c: dict) -> str:
    return f"computed {c['computed']} (full {c['full']}), skipped {c['skipped']}"


def phase_k2():
    import torch
    import torch.nn.functional as F

    from llama_x_tpu_torch.ops import flash_attention as fa
    from llama_x_tpu_torch.ops.attention import MaskInfo, make_attention_mask

    # the tolerance and its argument: ops/flash_attention.py:flash_fwd_tolerance
    log("[K2 flash_attention fwd] vs plain; tol: out per element 2^-7 |ref| + 2^-5 rms(ref's row) (bf16 out, P "
        "rounded to bf16 at other maxima), lse 2e-3 (fp32 sums in another order); with dropout the same limits: "
        "a keep mask wrong on one plan block moves its rows by about 0.2 of their rms")
    g = torch.Generator(device="cuda").manual_seed(2)
    Hq, Hkv, D = 32, 8, 128
    # serving: a prefill of 4 prompts; training: one packed microbatch of 4096 positions
    cases = [
        ("causal S=512", 4, 512, MaskInfo(causal=True)),
        ("prefix-LM 200 S=512", 4, 512, MaskInfo(causal=True, prefix_len=torch.full((4,), 200, dtype=torch.int32, device="cuda"))),
        ("ragged causal S=37", 4, 37, MaskInfo(causal=True)),
        ("segments S=512", 4, 512, MaskInfo(causal=True, segment_ids=torch.sort(
            torch.randint(1, 4, (4, 512), device="cuda", generator=g), dim=1).values.to(torch.int32))),
        ("causal S=4096", 1, 4096, MaskInfo(causal=True)),
        ("packed segments S=4096", 1, 4096, MaskInfo(causal=True, segment_ids=packed_segments(4096))),
        # the audio step: 2000 audio tokens before 2096 text tokens; without and with dropout
        ("prefix-LM 2000 S=4096", 1, 4096, prefix_mask(1, 2000)),
        (f"prefix-LM 2000 S=4096 dropout {DROPOUT_RATE}", 1, 4096, prefix_mask(1, 2000)),
        (f"ragged causal S=37 dropout {DROPOUT_RATE}", 4, 37, MaskInfo(causal=True)),
        # the vision step (272 image tokens before 32 caption tokens, microbatch 8: the last
        # q and kv tiles ragged) and the omni step (1500 audio + 272 image tokens before 2324)
        ("prefix-LM 272 S=304", 8, 304, prefix_mask(8, 272)),
        ("prefix-LM 1772 S=4096", 1, 4096, prefix_mask(1, 1772)),
    ]
    shapes = []
    for name, B, S, mi in cases:
        q, k, v = _attn_inputs(g, B, S, Hq, Hkv, D)
        kw, dropout = dropout_case(name, fa, S, Hq // Hkv)
        out, lse = fa.flash_fwd_with_lse(q, k, v, mi, **kw)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_fwd_plain(q, k, v, mi, dropout=dropout)
        atol, rtol = fa.flash_fwd_tolerance(ref)
        err = check_close(f"{name} out", out, ref, atol, rtol)
        check(f"{name} lse", max_err(lse, ref_lse), 2e-3)
        ms = time_ms(lambda: fa.flash_fwd_with_lse(q, k, v, mi, **kw))
        plain_ms = time_ms(lambda: fa.flash_fwd_plain(q, k, v, mi, dropout=dropout), reps=3, warmup=1)
        mask = make_attention_mask(mi, S, S, B, device=q.device)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rate = dropout.rate if dropout else 0.0
        if mi.prefix_len is None and mi.segment_ids is None:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True, dropout_p=rate)
        else:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True, dropout_p=rate)
        lib_ms = maybe_ms(lib)
        visible = float(mask.expand(B, 1, S, S).sum())
        n_bytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D) + 4 * B * Hq * S
        bms, by = bound_ms(n_bytes, 4 * D * Hq * visible, "bf16")
        tflops = 4 * D * Hq * visible / (ms * 1e-3) / 1e12
        tiles = tile_census(fa, mi, B, S, 128, 128)
        split = device_split_ms(lambda: fa.flash_fwd_with_lse(q, k, v, mi, **kw), ("flash_fwd_kernel",))
        log(f"      {ms:.4f} ms (plain {plain_ms:.3f}, sdpa {lib_ms}, bound {bms:.4f} by {by}); {tflops:.1f} TFLOP/s "
            f"of needed work, {bms / ms:.3f} of bound; 128 x 128 tiles of a head: {census_text(tiles)}; device "
            f"{split['flash_fwd_kernel']:.4f} ms (profiler), host {split['host_ms']:.4f} ms a call")
        shapes.append(dict(case=name, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, max_abs_err=err,
                           lse_max_abs_err=max_err(lse, ref_lse), tol=float(atol.max()), rtol=rtol, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by, tflops=tflops,
                           tiles=tiles, split=split))
        del q, k, v, out, lse, ref, ref_lse, mask, qt, kt, vt, atol
        torch.cuda.empty_cache()
    return shapes


def offsets_census(fa, q_off, kv_len, Sq: int, S_max: int, bq: int = 128, bk: int = 128) -> dict:
    """Tile classes of the offsets form over the rows of a call (one head): the kernel skips
    (never loads) the kv tiles past each row's kv_len and above its shifted diagonal."""
    counts = {"skip": 0, "partial": 0, "full": 0}
    for off, n in zip(q_off, kv_len):
        for q0 in range(0, Sq, bq):
            for kv0 in range(0, S_max, bk):
                counts[fa.tile_class(q0, kv0, bq, bk, Sq, True, None, None, None, q_offset=off, kv_end=n)] += 1
    return counts


def phase_k2_offsets():
    """K2's offsets form over the KV cache at the serving paths' shapes (32/8 heads, D 128,
    S_max 4096): a continuation chunk of chunked prefill (bf16 and int8 cache), a prefix
    admission and a speculative verify at gamma 8 over eight slots."""
    import torch
    import torch.nn.functional as F

    from llama_x_tpu_torch.models import llama
    from llama_x_tpu_torch.ops import flash_attention as fa

    log("[K2 offsets form] over a [B, 8, 4096, 128] cache read in place, 32 query heads, per-row q_offset and kv_len, "
        "vs flash_fwd_offsets_plain; tol: out per element 2^-7 |ref| + 2^-5 rms(ref's row), lse 2e-3 (the self "
        "form's); the int8 cache through the wrapper that dequantizes the live prefix to bf16 first; library: SDPA on "
        "the cache sliced to the longest kv_len with a bool mask")
    g = torch.Generator(device="cuda").manual_seed(8)
    Hq, Hkv, D, S_max = 32, 8, 128, 4096
    verify_off = [513 + i * (1500 - 513) // 7 for i in range(8)]
    cases = [
        ("continuation chunk", 1, 512, [1536], [2048], False),
        ("continuation chunk, int8 cache", 1, 512, [1536], [2048], True),
        ("prefix admission (200 real of 256)", 1, 256, [512], [712], False),
        ("verify gamma 8", 8, 9, verify_off, [o + 9 for o in verify_off], False),
    ]
    shapes = []
    for name, B, Sq, q_off, kv_len, int8 in cases:
        q = torch.randn(B, Sq, Hq, D, device="cuda", generator=g).to(torch.bfloat16)
        k = torch.randn(B, Hkv, S_max, D, device="cuda", generator=g).to(torch.bfloat16)
        v = torch.randn(B, Hkv, S_max, D, device="cuda", generator=g).to(torch.bfloat16)
        qo = torch.tensor(q_off, dtype=torch.int32, device="cuda")
        ko = torch.zeros_like(qo)
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        n = max(kv_len)
        if int8:
            (k8, ks), (v8, vs) = llama.quantize_kv_rows(k), llama.quantize_kv_rows(v)
            call = lambda: fa.flash_fwd_offsets_int8(q, k8, ks, v8, vs, qo, ko, lens, n)  # noqa: E731
            plain = lambda: fa.flash_fwd_offsets_plain(q, fa.dequant_live(k8, ks, n), fa.dequant_live(v8, vs, n),  # noqa: E731
                                                       qo, ko, lens)
            kd, vd = fa.dequant_live(k8, ks, n), fa.dequant_live(v8, vs, n)
            kv_bytes = 2 * Hkv * sum(kv_len) * (D + 4)  # int8 data + f32 scales of the live prefixes
        else:
            call = lambda: fa.flash_fwd_offsets(q, k, v, qo, ko, lens)  # noqa: E731
            plain = lambda: fa.flash_fwd_offsets_plain(q, k, v, qo, ko, lens)  # noqa: E731
            kd, vd = k[:, :, :n], v[:, :, :n]
            kv_bytes = 2 * Hkv * sum(kv_len) * D * 2
        before = fa.flash_fwd_offsets.launches
        out, lse = call()
        torch.cuda.synchronize()
        if fa.flash_fwd_offsets.launches != before + 1:
            raise AssertionError("the offsets form did not launch K2")
        ref, ref_lse = plain()
        atol, rtol = fa.flash_fwd_tolerance(ref)
        err = check_close(f"{name} out", out, ref, atol, rtol)
        check(f"{name} lse", max_err(lse, ref_lse), 2e-3)
        ms = time_ms(call)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        mask = fa.offsets_mask(qo, ko, lens, Sq, n)[:, None]
        qt = q.transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(qt, kd, vd, attn_mask=mask, enable_gqa=True)  # noqa: E731
        lib_ms = maybe_ms(lib)
        lib_dev = library_device_ms(lib) if lib_ms is not None else None
        visible = float(mask.sum())
        n_bytes = 2 * (2 * B * Sq * Hq * D) + kv_bytes + 4 * B * Hq * Sq
        bms, by = bound_ms(n_bytes, 4 * D * Hq * visible, "bf16")
        split = device_split_ms(call, ("flash_fwd_kernel",))
        dev = split["flash_fwd_kernel"]
        tiles = offsets_census(fa, q_off, kv_len, Sq, S_max)
        log(f"      {ms:.4f} ms (plain {plain_ms:.3f}, sdpa {lib_ms}, device {lib_dev}; bound {bms:.4f} by {by}: "
            f"{n_bytes / 1e6:.2f} MB, {4 * D * Hq * visible / 1e9:.3f} GFLOP); K2 device {dev:.4f} ms (profiler, "
            f"{bms / dev if dev else 0:.3f} of bound), host {split['host_ms']:.4f} ms a call; 128 x 128 tiles of a "
            f"head over the rows: skip {tiles['skip']}, partial {tiles['partial']}, full {tiles['full']}")
        shapes.append(dict(case=name, B=B, Sq=Sq, q_offset=q_off, kv_len=kv_len, S_max=S_max, Hq=Hq, Hkv=Hkv, D=D,
                           int8_cache=int8, max_abs_err=err, lse_max_abs_err=max_err(lse, ref_lse),
                           tol=float(atol.max()), rtol=rtol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           library_device_ms=lib_dev, bound_ms=bms, bound_by=by, device_ms=dev,
                           host_ms=split["host_ms"], tiles=tiles))
        del q, k, v, out, lse, ref, ref_lse, kd, vd, mask, qt, atol
        torch.cuda.empty_cache()
    q = torch.zeros(1, 16, 4, 32, dtype=torch.bfloat16, device="cuda")
    kv = torch.zeros(1, 2, 64, 32, dtype=torch.bfloat16, device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    try:
        fa.flash_fwd_offsets(q, kv, kv, one, one * 0, one)
    except ValueError as e:
        log(f"    head_dim 32 raises: {e}")
    else:
        raise AssertionError("the offsets form took head_dim 32")
    return shapes


DROPOUT_RATE = 0.1
DROPOUT_SEED = 0x7FFFFFF1  # the block keys wrap around 2^32


def prefix_mask(B: int, prefix: int):
    import torch

    from llama_x_tpu_torch.ops.attention import MaskInfo

    return MaskInfo(causal=True, prefix_len=torch.full((B,), prefix, dtype=torch.int32, device="cuda"))


def dropout_case(name: str, fa, S: int, group: int):
    """(wrapper keywords, Dropout) of a case whose name says "dropout", else ({}, None);
    prints the plan and the dropped share of the mask beside the rate."""
    if "dropout" not in name:
        return {}, None
    dropout = fa.make_dropout(DROPOUT_RATE, DROPOUT_SEED, S, S, group)
    keep = fa.dropout_keep(dropout, 1, 1, group, S, S, device="cuda")
    log(f"    {name}: plan bq {dropout.bq}, bk {dropout.bk}; dropped share of the mask "
        f"{1.0 - float(keep.float().mean()):.6f} at rate {dropout.rate}")
    return dict(dropout_rate=DROPOUT_RATE, dropout_seed=DROPOUT_SEED), dropout


def phase_k5():
    import torch
    import torch.nn.functional as F

    from llama_x_tpu_torch.ops import flash_attention as fa
    from llama_x_tpu_torch.ops.attention import MaskInfo, make_attention_mask

    # the tolerance and its argument: ops/flash_attention.py:flash_bwd_tolerance
    log("[K5 flash_attention bwd] vs plain; tol per element 2^-7 |ref| + 2^-5 rms(ref) for each of dq, dk, dv "
        "(bf16 out; f32 sums in another order flip a few bf16 roundings of p and ds)")
    g = torch.Generator(device="cuda").manual_seed(5)
    S = 4096
    segs = packed_segments(S)
    cases = [
        ("causal S=4096", 1, S, 32, 8, 128, MaskInfo(causal=True)),
        ("packed segments S=4096", 1, S, 32, 8, 128, MaskInfo(causal=True, segment_ids=segs)),
        ("prefix-LM 2000 S=4096", 1, S, 32, 8, 128, prefix_mask(1, 2000)),
        ("ragged causal S=37", 1, 37, 32, 8, 128, MaskInfo(causal=True)),
        ("causal S=2048 D=64", 1, 2048, 32, 8, 64, MaskInfo(causal=True)),
        (f"prefix-LM 2000 S=4096 dropout {DROPOUT_RATE}", 1, S, 32, 8, 128, prefix_mask(1, 2000)),
        (f"ragged causal S=37 dropout {DROPOUT_RATE}", 1, 37, 32, 8, 128, MaskInfo(causal=True)),
        # the vision step's microbatch (prefix 272 of 304: ragged last tiles) and the omni step's
        ("prefix-LM 272 S=304", 8, 304, 32, 8, 128, prefix_mask(8, 272)),
        ("prefix-LM 1772 S=4096", 1, S, 32, 8, 128, prefix_mask(1, 1772)),
    ]
    shapes = []
    for name, B, S, Hq, Hkv, D, mi in cases:
        q, k, v = _attn_inputs(g, B, S, Hq, Hkv, D)
        do = torch.randn(B, S, Hq, D, device="cuda", generator=g).to(torch.bfloat16)
        kw, dropout = dropout_case(name, fa, S, Hq // Hkv)
        out, lse = fa.flash_fwd_with_lse(q, k, v, mi, **kw)
        got = fa.flash_bwd_from_res(q, k, v, out, lse, do, mi, dropout=dropout)
        torch.cuda.synchronize()
        want = fa.flash_bwd_plain(q, k, v, out, lse, do, mi, dropout=dropout)
        errs, atols = {}, {}
        for n, a, b in zip(("dq", "dk", "dv"), got, want):
            atols[n], rtol = fa.flash_bwd_tolerance(b)
            errs[n] = check_close(f"{name} {n}", a, b, atols[n], rtol)
        del want
        ms = time_ms(lambda: fa.flash_bwd_from_res(q, k, v, out, lse, do, mi, dropout=dropout), reps=5, warmup=1)
        plain_ms = time_ms(lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, mi, dropout=dropout), reps=2, warmup=1)
        mask = make_attention_mask(mi, S, S, B, device=q.device)
        visible = float(mask.expand(B, 1, S, S).sum())
        del mask
        lib_ms = sdpa_backward_ms(F, q, k, v, do, mi, dropout.rate if dropout else 0.0)
        # inputs q, k, v, out, dO, lse read once; dq, dk, dv written once
        n_bytes = 2 * (4 * B * S * Hq * D + 4 * B * S * Hkv * D) + 4 * B * Hq * S
        bms, by = bound_ms(n_bytes, 10 * D * Hq * visible, "bf16")
        tflops = 10 * D * Hq * visible / (ms * 1e-3) / 1e12
        tiles = {"dkv": tile_census(fa, mi, B, S, 64, 128), "dq": tile_census(fa, mi, B, S, 128, 64)}
        split = device_split_ms(lambda: fa.flash_bwd_from_res(q, k, v, out, lse, do, mi, dropout=dropout),
                                ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))
        log(f"      {ms:.4f} ms (plain {plain_ms:.3f}, sdpa backward {lib_ms}, bound {bms:.4f} by {by}); {tflops:.1f} "
            f"TFLOP/s of needed work, {bms / ms:.3f} of bound; tiles of a head: dkv 64 q x 128 kv "
            f"{census_text(tiles['dkv'])}; dq 128 q x 64 kv {census_text(tiles['dq'])}; device dq "
            f"{split['flash_bwd_dq_kernel']:.4f} + dkv {split['flash_bwd_dkv_kernel']:.4f} ms (profiler), host "
            f"{split['host_ms']:.4f} ms a call")
        shapes.append(dict(case=name, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, max_abs_err=max(errs.values()), errs=errs,
                           tol=max(atols.values()), rtol=rtol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bms, bound_by=by, tflops=tflops, tiles=tiles, split=split))
        del q, k, v, do, out, lse, got
        torch.cuda.empty_cache()
    return shapes


def sdpa_backward_ms(F, q, k, v, do, mi, rate: float = 0.0):
    """The yardstick of K5: the backward of one scaled_dot_product_attention call on the
    same inputs (timed here, never called by the port), or None where it is not offered."""
    import torch

    from llama_x_tpu_torch.ops.attention import make_attention_mask

    B, S = q.shape[:2]
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    try:
        if mi.prefix_len is None and mi.segment_ids is None:
            out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True, dropout_p=rate)
        else:
            mask = make_attention_mask(mi, S, S, B, device=q.device)
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True, dropout_p=rate)
        grad = do.transpose(1, 2)
        run = lambda: torch.autograd.grad(out, leaves, grad, retain_graph=True)
        run()
    except (RuntimeError, ValueError, TypeError) as e:
        log(f"    yardstick unavailable: {type(e).__name__}: {str(e).splitlines()[0][:120]}")
        return None
    return time_ms(run, reps=5, warmup=1)


K3_ATOL, K3_RTOL = 4e-3, 2**-7


def phase_k3():
    import torch
    import torch.nn.functional as F

    from llama_x_tpu_torch.models.llama import quantize_kv_rows
    from llama_x_tpu_torch.ops import decode_attention as da

    # The plain version rounds P to bf16 at the final row max, the kernel at its running
    # max: up to ~1e-3 beyond one bf16 ulp per element. A window one position short or
    # long, or a lost staircase, moves some element by 2e-2 or more at these lens.
    log(f"[K3 decode_attention{{,_int8}}] vs plain; tol per element {K3_ATOL:.0e} + 2^-7 |ref| "
        "(bf16 out, P rounded to bf16 at other maxima)")
    g = torch.Generator(device="cuda").manual_seed(3)
    B, Hq, Hkv, D, S_max = 4, 32, 8, 128, 4096
    k = torch.randn(B, Hkv, S_max, D, device="cuda", generator=g).to(torch.bfloat16)
    v = torch.randn(B, Hkv, S_max, D, device="cuda", generator=g).to(torch.bfloat16)
    k8, ks = quantize_kv_rows(k)
    v8, vs = quantize_kv_rows(v)
    shapes = {"bf16": [], "int8": []}
    splits, split_len = da.decode_split_plan(S_max, B, Hkv)
    log(f"    split plan at B {B}, {Hkv} kv heads, S_max {S_max}: {splits} splits of {split_len} positions")
    # lens 63/64/65 straddle the kernel's 64-position tile; the last case is the serving
    # request's own windows (prompts padded to 512, then 64 new tokens: 513 to 576)
    for Sq, last in ((1, [1, 513, 2048, 4096]), (5, [1, 513, 2048, 4096]), (5, [63, 64, 65, 4096]),
                     (1, [513, 531, 554, 576])):
        lens1 = torch.tensor(last, dtype=torch.int32, device="cuda")
        q = torch.randn(B, Sq, Hq, D, device="cuda", generator=g).to(torch.bfloat16)
        # per-query staircase: query i of row b sees min(len_b, len_b - Sq + 1 + i) positions
        lens = (lens1[:, None] - (Sq - 1) + torch.arange(Sq, device="cuda")[None, :]).clamp(min=1).to(torch.int32)
        window = float(lens.sum()) * (Hq // Hkv) * Hkv  # (position, query row) pairs
        read_pos = float(lens.max(dim=1).values.sum()) * Hkv  # cache rows read per side
        for kind in ("bf16", "int8"):
            if kind == "bf16":
                run = lambda: da.decode_attention(q, k, v, lens, 1.0 / math.sqrt(D))
                plain = lambda: da.decode_attention_plain(q, k, v, lens, 1.0 / math.sqrt(D))
                n_bytes = 2 * read_pos * D * 2
            else:
                run = lambda: da.decode_attention_int8(q, k8, ks, v8, vs, lens, 1.0 / math.sqrt(D))
                plain = lambda: da.decode_attention_int8_plain(q, k8, ks, v8, vs, lens, 1.0 / math.sqrt(D))
                n_bytes = 2 * read_pos * (D + 4)
            out = run()
            torch.cuda.synchronize()
            err = check_close(f"{kind} Sq={Sq} lens={last}", out, plain(), K3_ATOL, K3_RTOL)
            ms = time_ms(run)
            plain_ms = time_ms(plain, reps=3, warmup=1)
            lib_ms = lib_dev = None
            if kind == "bf16":
                pos = torch.arange(S_max, device="cuda")
                mask = (pos[None, None, :] < lens[:, :, None])[:, None]  # [B, 1, Sq, S]
                lib = lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True)
                lib_ms = maybe_ms(lib)
                lib_dev = library_device_ms(lib) if lib_ms is not None else None
            n_bytes += 2 * 2 * B * Sq * Hq * D + 4 * B * Sq
            bms, by = bound_ms(n_bytes, 4 * D * window, "bf16")
            split = device_split_ms(run, ("decode_kernel", "decode_merge_kernel"))
            dev = split["decode_kernel"] + split["decode_merge_kernel"]
            tflops = 4 * D * window / (ms * 1e-3) / 1e12
            log(f"      {ms:.4f} ms (plain {plain_ms:.3f}, sdpa {lib_ms}, bound {bms:.4f} by {by}); {tflops:.2f} TFLOP/s, "
                f"{bms / ms:.3f} of bound; device {split['decode_kernel']:.4f} + merge {split['decode_merge_kernel']:.4f} "
                f"ms (profiler, {bms / dev if dev else 0:.3f} of bound; sdpa {lib_dev}), host {split['host_ms']:.4f} "
                f"ms a call; {splits} splits")
            shapes[kind].append(dict(Sq=Sq, lens=lens.tolist(), B=B, S_max=S_max, max_abs_err=err, tol=K3_ATOL,
                                     rtol=K3_RTOL, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                                     bound_by=by, tflops=tflops, device_ms=dev, library_device_ms=lib_dev,
                                     host_ms=split["host_ms"], splits=splits, split_len=split_len))
    return shapes


def phase_k6():
    import torch

    from llama_x_tpu_torch import probe_flash as entry
    from llama_x_tpu_torch.ops import flash_probe as fp

    # the tolerance and its argument: ops/flash_probe.py:probe_tolerance
    log("[K6 flash_probe] vs plain; tol per element 2^-7 |ref| + 2^-8 rms(ref) (bf16 logits and bf16 out on both "
        "sides, f32 sums in another order)")
    # the two 8B plans of the probe entry point, then a 64-wide plan whose tiles the kernel
    # masks per element
    B, S, Hq, Hkv, D, prefix = 1, 4096, entry.HEADS, entry.KV_HEADS, entry.HEAD_DIM, 2000
    q, k, v, _ = entry.make_inputs(S, torch.device("cuda"))
    shapes = []
    for bq, bk in ((256, 1024), (128, 512), (64, 64)):
        out = fp.flash_probe(q, k, v, bq, bk, prefix)
        torch.cuda.synchronize()
        ref = fp.flash_probe_plain(q, k, v, bq, bk, prefix)
        atol, rtol = fp.probe_tolerance(ref)
        err = check_close(f"bq={bq} bk={bk} prefix={prefix}", out, ref, atol, rtol)
        ms = time_ms(lambda: fp.flash_probe(q, k, v, bq, bk, prefix))
        plain_ms = time_ms(lambda: fp.flash_probe_plain(q, k, v, bq, bk, prefix), reps=3, warmup=1)
        pairs = float(fp.needed_blocks(S, bq, bk, prefix).sum()) * bq * bk  # (q, kv) pairs of the needed blocks
        n_bytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
        bms, by = bound_ms(n_bytes, 4 * B * Hq * D * pairs, "bf16")
        split = device_split_ms(lambda: fp.flash_probe(q, k, v, bq, bk, prefix), ("flash_probe_kernel",))
        dev = split["flash_probe_kernel"]
        tiles = fp.tile_census(S, bq, bk, prefix)
        log(f"      {ms:.4f} ms (plain {plain_ms:.3f}, library none: no PyTorch call skips whole blocks, "
            f"bound {bms:.4f} by {by}; {pairs / S / S:.4f} of the pairs needed); {bms / ms:.3f} of bound; device "
            f"{dev:.4f} ms (profiler, {bms / dev if dev else 0:.3f} of bound), host {split['host_ms']:.4f} ms a call; "
            f"128 x 128 tiles of a head: skip {tiles['skip']}, partial {tiles['partial']}, full {tiles['full']}")
        shapes.append(dict(bq=bq, bk=bk, prefix=prefix, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, max_abs_err=err, tol=atol,
                           rtol=rtol, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by,
                           device_ms=dev, host_ms=split["host_ms"], tiles=tiles))
        del out, ref
    return shapes


# the tensor-parallel shard shapes at 8B width (tp 2: wq N 2048, wk / wv N 512, wo K 2048, w1 / w3
# N 7168, w2 K 7168, the head's vocabulary shard N 64128; tp 4: the head's N 32064, not a multiple
# of 128), M 4096 positions (the CE at its 512-row chunk); K4 at the matching input gradients
# (column-parallel K = out / tp: 2048, 512, 7168; row-parallel N = in / tp: 2048, 7168) and the
# CE dH over the vocabulary shard (K 64128, 32064)
TP_K1_CASES = [(4096, 2048, 4096), (4096, 512, 4096), (4096, 4096, 2048), (4096, 7168, 4096), (4096, 4096, 7168),
               (512, 64128, 4096), (512, 32064, 4096)]
TP_K4_CASES = [(4096, 4096, 2048), (4096, 4096, 512), (4096, 4096, 7168), (4096, 2048, 4096), (4096, 7168, 4096),
               (512, 4096, 64128), (512, 4096, 32064)]


def phase_int8_tp_shards() -> dict:
    """K1 and K4 at the shard shapes of tensor parallelism (the card holds one rank's shards
    at tp 2; tp 4's head shard is held here too): bit for bit against their plain versions,
    with bound, plan, plain and ``_int_mm`` times."""
    import torch

    from llama_x_tpu_torch.ops import int8_mm as mm

    log("[K1 / K4 at the tp shard shapes] vs plain; tol 0: bit for bit")
    g = torch.Generator(device="cuda").manual_seed(16)
    f32, bf16 = torch.float32, torch.bfloat16
    k1 = int8_mm_cases(mm.int8_mm_dequant_nt, mm.int8_mm_dequant_nt_plain, True, g,
                       [(M, N, K, f32 if N > 16384 else bf16) for M, N, K in TP_K1_CASES])
    k4 = int8_mm_cases(mm.int8_mm_dequant, mm.int8_mm_dequant_plain, False, g,
                       [(M, N, K, f32 if K > 16384 else bf16) for M, N, K in TP_K4_CASES])
    return {"int8_mm_dequant_nt_tp": k1, "int8_mm_dequant_tp": k4}


def phase_k7() -> list[dict]:
    """K7, the rowwise quantizer, against the plain chain it replaces (ops/int8.py:
    quantize_rows_plain, PyTorch's own passes): codes and scales bit for bit, timed beside the
    bytes' bound (each input byte read once, codes and scales written once) at the training
    cell's shapes (Mistral-NeMo-12B, S 4096: the projections' inputs and input gradients with
    their weight scale folded in, the int8 head and its f32 dlogits chunk) and the decode
    step's (Mistral-7B, 32 rows; the int8 cache's new rows with f32 scales)."""
    import torch

    from llama_x_tpu_torch.ops import int8 as i8

    log("[K7 quantize_rows] vs the plain chain; tol 0: codes and scales bit for bit")
    g = torch.Generator(device="cuda").manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    # (rows, width, dtype, column scale, f32 scale)
    cases = [(4096, 5120, bf16, False, False), (4096, 4096, bf16, False, False), (4096, 14336, bf16, False, False),
             (4096, 4096, bf16, True, False), (4096, 1024, bf16, True, False), (4096, 5120, bf16, True, False),
             (4096, 14336, bf16, True, False), (131072, 5120, bf16, False, False), (512, 5120, bf16, False, False),
             (512, 131072, f32, True, False), (32, 4096, bf16, False, False), (32, 14336, bf16, False, False),
             (256, 128, bf16, False, True), (8192, 128, bf16, False, True)]
    shapes = []
    for R, C, dtype, col, kv in cases:
        x = (torch.randn(R, C, device="cuda", generator=g)
             * (4 * torch.rand(R, 1, device="cuda", generator=g) + 0.01)).to(dtype)
        cs = (torch.rand(C, device="cuda", generator=g) * 0.02 + 1e-4).to(dtype) if col else None
        sd = f32 if kv else None
        got, want = i8.quantize_rows(x, cs, sd), i8.quantize_rows_plain(x, cs, sd)
        torch.cuda.synchronize()
        name = f"R={R} C={C} {str(dtype).split('.')[1]}{' x col scale' if col else ''}{' f32 scale' if kv else ''}"
        err = max(max_err(got[0], want[0]), max_err(got[1], want[1]))
        check(name, err, 0.0)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}: not bit-identical to the plain chain")
        del got, want
        ms = time_ms(lambda: i8.quantize_rows(x, cs, sd))
        plain_ms = time_ms(lambda: i8.quantize_rows_plain(x, cs, sd), reps=3, warmup=1)
        n_bytes = R * C * (x.element_size() + 1) + R * (4 if kv else x.element_size()) + (C * x.element_size() if col else 0)
        bms, by = bound_ms(n_bytes, 0.0, "bf16")
        split = device_split_ms(lambda: i8.quantize_rows(x, cs, sd), ("quantize_rows_kernel",))
        dev = split["quantize_rows_kernel"]
        plain_dev = library_device_ms(lambda: i8.quantize_rows_plain(x, cs, sd))
        plan = dict(zip(("vec", "spans"), i8.quantize_rows_plan(R, C, x.element_size(), True)))
        log(f"      {ms:.4f} ms (plain chain {plain_ms:.4f}, bound {bms:.4f} by {by}); device {dev:.4f} ms "
            f"({bms / dev if dev else 0:.3f} of bound; plain chain {plain_dev:.4f}), host {split['host_ms']:.4f} ms a call; "
            f"{plan}")
        shapes.append(dict(R=R, C=C, dtype=str(dtype).split(".")[1], col_scale=col, f32_scale=kv, max_abs_err=err,
                           tol=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by, device_ms=dev,
                           plain_device_ms=plain_dev, host_ms=split["host_ms"], **plan))
        del x, cs
    return shapes


def phase_kernels():
    """Returns {kernel name: per-shape records}."""
    return {"quantize_rows": phase_k7(), "int8_mm_dequant_nt": phase_k1(), "int8_mm_plans": phase_k1_plans(),
            "int8_mm_dequant": phase_k4(), "int8_mm_kn_plans": phase_k4_plans(), **phase_int8_tp_shards(),
            "flash_attention": phase_k2(),
            "flash_attention_offsets": phase_k2_offsets(),
            "flash_attention_bwd": phase_k5(), "flash_probe": phase_k6(), **phase_ring_kernels(), **{
        ("decode_attention" if kind == "bf16" else "decode_attention_int8"): recs
        for kind, recs in phase_k3().items()
    }}


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path at 8B width, and kernel path against plain path
# ---------------------------------------------------------------------------


def counted():
    """The counted wrappers by name (ops/launches.py), every module that defines one imported."""
    from llama_x_tpu_torch.ops import decode_attention, flash_attention, flash_probe, int8, int8_mm, ssd  # noqa: F401
    from llama_x_tpu_torch.ops import launches

    return dict(launches.COUNTED)


def reset_counts():
    for fn in counted().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counted().items()}


def device_kernels(prof) -> list[str]:
    """The name of every device activity of a torch.profiler trace, one per kernel (the raw
    events: parsing a trace of 10^5 kernels into the profiler's tree takes seconds)."""
    import torch

    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


# a trace of 10^5 device records or more loses a run of them, on an H100 up to 5 times in a row
# for one window of 3 * 10^5; a retake costs seconds (diagnostics/trace_records.py counts losses)
TRACE_ATTEMPTS = 16
# late in a long run, a short trace of one graph replay (the whole prefill in one launch) lost its
# edge records on every retake; a retake brackets the window with this many uncounted kernels,
# ATen's spin kernel (torch.cuda._sleep), which no path of the port launches
TRACE_PAD_KERNELS = 256
TRACE_PAD_NAME = "spin_kernel"


def trace_pad():
    """Uncounted kernels, synchronized: what a lossy edge of a trace takes instead of the window's.
    Their records (``TRACE_PAD_NAME``) are no part of the window: ``device_time`` and
    ``summarize_profile`` leave them out of the busy time."""
    import torch

    for _ in range(TRACE_PAD_KERNELS):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def check_trace_pad() -> None:
    """A trace of ``trace_pad`` alone: every device record of it carries ``TRACE_PAD_NAME``,
    the name by which the busy sums leave the pad out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trace_pad()
    names = device_kernels(prof)
    if not names or any(TRACE_PAD_NAME not in n for n in names):
        raise AssertionError(f"trace_pad's records are not all named {TRACE_PAD_NAME}: {sorted(set(names))[:4]}")
    ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6
    log(f"[trace pad] {len(names)} device records, all {TRACE_PAD_NAME}, {ms:.3f} ms (left out of busy sums)")


def traced(what: str, fn, cpu: bool = False) -> dict:
    """``fn()`` with the counts reset just before and read just after, under torch.profiler
    (CUDA activity, which sees every thread's launches; ``cpu``: host activity too), the
    counts (a graph replay's credits included) held to the kernels of the device trace
    (``launches.check_trace``; K3's merge kernels beside them). A trace of graph replays can
    lose a run of records of every kind of kernel (diagnostics/trace_records.py), but it never
    shows a kernel that did not run: where it shows fewer than counted, ``fn`` runs again, up
    to TRACE_ATTEMPTS times, bracketed by ``trace_pad`` inside the trace (the wall is ``fn``'s
    alone, and the busy time leaves the pad's records out); more than counted, or fewer
    every time, fails. -> {"result", "launches", "traced", "prof", "wall_ms", "attempts"}"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llama_x_tpu_torch.ops import launches

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        reset_counts()
        with profile(activities=activities) as prof:
            if attempt > 1:
                trace_pad()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            if attempt > 1:
                trace_pad()
        counts = read_counts()
        names = device_kernels(prof)
        seen = launches.traced_counts(names)
        want = {group: sum(counts[n] for n in group.split(" + ")) for group in seen}
        if seen == want or attempt == TRACE_ATTEMPTS or any(seen[g] > want[g] for g in seen):
            traced_ = launches.check_trace(names, counts, what)
            traced_["K3 merge"] = sum("decode_merge_kernel" in n for n in names)
            if attempt > 1:
                log(f"    {what}: attempt {attempt} kept every record; {sum(TRACE_PAD_NAME in n for n in names)} "
                    "pad records of the trace left out of its busy time")
            return dict(result=result, launches=counts, traced=traced_, prof=prof, wall_ms=wall_ms, attempts=attempt)
        lost = {g: want[g] - seen[g] for g in seen if seen[g] != want[g]}
        log(f"    {what}: the trace lost kernels {lost} of {len(names)} device records; again")


@contextlib.contextmanager
def plain_path():
    """Route the model through the kernels' plain versions (on the card's tensors) by
    swapping the module attributes the model calls; restored on exit."""
    from llama_x_tpu_torch.ops import decode_attention as da
    from llama_x_tpu_torch.ops import flash_attention as fa
    from llama_x_tpu_torch.ops import int8 as i8
    from llama_x_tpu_torch.ops import int8_mm as mm

    swaps = [(i8, "quantize_rows", i8.quantize_rows_plain),
             (mm, "int8_mm_dequant_nt", mm.int8_mm_dequant_nt_plain),
             (mm, "int8_mm_dequant", mm.int8_mm_dequant_plain),
             (fa, "_forward_impl", fa.flash_fwd_plain),
             (fa, "flash_fwd_offsets", fa.flash_fwd_offsets_plain),
             (fa, "flash_bwd_from_res", fa.flash_bwd_plain),
             (da, "decode_attention", da.decode_attention_plain),
             (da, "decode_attention_int8", da.decode_attention_int8_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def ragged_prompts(B: int = 4, P: int = 512):
    """Byte-tokenized prompts of four lengths, right-padded to P, with their lengths."""
    import torch

    from llama_x_tpu_torch.data.tokenizers import ByteTokenizer

    tok = ByteTokenizer()
    text = "The quick brown fox jumps over the lazy dog while the port serves Llama on Hopper. "
    lens = [P, P - 81, P - 215, P - 382][:B]
    rows = [tok(text * (n // len(text) + 1), add_bos=True)[:n] for n in lens]
    prompt = torch.full((B, P), tok.pad_id, dtype=torch.long)
    for i, r in enumerate(rows):
        prompt[i, : len(r)] = torch.tensor(r)
    return prompt.cuda(), torch.tensor(lens, device="cuda")


NEW_TOKENS = 32


GRAPH_RUNS = 3  # timed graph requests of each kind: the spread of decode tok/s


def timed_request(model, prompt, lens, cache_dtype, eager: bool) -> dict:
    """One request as ``generate`` makes it, ``prefill_start`` then ``decode_chunk`` of
    NEW_TOKENS - 1 steps, each timed apart on the host clock after a synchronize (decode
    tok/s from the decode alone); counts reset just before and read just after, peak memory
    from a reset."""
    import torch

    from llama_x_tpu_torch.models.generate import decode_chunk, prefill_start

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    first, state = prefill_start(model, prompt, prompt_lens=lens, cache_dtype=cache_dtype, max_new_tokens=NEW_TOKENS,
                                 eager=eager)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rest, _ = decode_chunk(model, state, NEW_TOKENS - 1, eager=eager)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    B = prompt.shape[0]
    return dict(out=torch.cat([first[:, None], rest], dim=1), launches=read_counts(), prefill_ms=(t1 - t0) * 1e3,
                total_s=t2 - t0, decode_tok_s=B * (NEW_TOKENS - 1) / (t2 - t1),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


PREFILL_RUNS = 3  # timed prefills through the graph and eager, each


def device_time(prof) -> tuple[float, dict]:
    """(device busy ms, ms by ``DEVICE_ITEM_GROUPS``) of a trace, summed over its raw device
    records (kernels, copies, sets; not ``trace_pad``'s): quicker than ``key_averages`` for a
    trace of thousands."""
    import torch

    groups: dict[str, float] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and TRACE_PAD_NAME not in e.name():
            label = next((lab for key, lab in DEVICE_ITEM_GROUPS if key in e.name()), "other")
            groups[label] = groups.get(label, 0.0) + e.duration_ns() / 1e6
    return sum(groups.values()), dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def prefill_graph_against_eager(tag: str, model, graph_fn, eager_fn) -> dict:
    """A prefill through its captured graph (``graph_fn``, its key captured already) against
    the same prefill launched op by op (``eager_fn``): PREFILL_RUNS of each timed on the host
    clock after a synchronize, the peak allocated memory from a reset beside them; one replay
    and one eager prefill traced (the replay's launches, its capture's tally, held to the
    device trace and to the eager prefill's), their device busy time against the unprofiled
    median wall (the busy share) and the profiled one; the key's capture + instantiate seconds
    and the pool its capture grew, and the prefill runner's shared pool."""
    import torch

    from llama_x_tpu_torch.models import decode_graph as dg

    t_check = time.perf_counter()

    def timed(fn) -> tuple[list[float], float]:
        ms, peak = [], 0.0
        for _ in range(PREFILL_RUNS):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
        return ms, peak

    runner = dg.prefill_runner_of(model)
    g_ms, g_peak = timed(graph_fn)
    e_ms, e_peak = timed(eager_fn)
    g = traced(f"{tag} prefill replay", graph_fn)
    entry = next(reversed(runner.graphs.values()))  # the key just replayed
    credits = {name: entry.captured.credits.get(fn, 0) for name, fn in counted().items()}
    e = traced(f"{tag} eager prefill", eager_fn)
    if g["launches"] != credits or e["launches"] != credits:
        raise AssertionError(f"{tag}: a replay credited {credits}, counted {g['launches']}; eager {e['launches']}")
    (g_busy, g_groups), (e_busy, e_groups) = device_time(g["prof"]), device_time(e["prof"])
    g_med, e_med = sorted(g_ms)[len(g_ms) // 2], sorted(e_ms)[len(e_ms) // 2]
    res = dict(graph_ms=g_ms, eager_ms=e_ms, graph_peak_gb=g_peak, eager_peak_gb=e_peak,
               replay_peak_within_eager=g_peak <= e_peak, graph_busy_ms=g_busy, eager_busy_ms=e_busy,
               graph_busy_share=g_busy / g_med, eager_busy_share=e_busy / e_med,
               graph_busy_share_profiled=g_busy / g["wall_ms"], eager_busy_share_profiled=e_busy / e["wall_ms"],
               graph_groups_ms=g_groups, eager_groups_ms=e_groups, trace_attempts=(g["attempts"], e["attempts"]),
               capture_s=entry.capture_s, key_pool_mb=entry.pool_bytes / 1e6, pool_mb=sum(runner.pool_bytes) / 1e6,
               keys=len(runner.graphs), launches={k: v for k, v in credits.items() if v},
               traced={k: v for k, v in g["traced"].items() if v}, check_s=time.perf_counter() - t_check)
    log(f"    {tag} prefill: graph {', '.join(f'{t:.2f}' for t in g_ms)} ms, eager {', '.join(f'{t:.2f}' for t in e_ms)} "
        f"ms; device busy {g_busy:.2f} / {e_busy:.2f} ms, busy share of the median wall {res['graph_busy_share']:.3f} / "
        f"{res['eager_busy_share']:.3f} (of the profiled wall {res['graph_busy_share_profiled']:.3f} / "
        f"{res['eager_busy_share_profiled']:.3f}); peak {g_peak:.2f} / {e_peak:.2f} GB; capture + instantiate "
        f"{entry.capture_s:.3f} s, the key's pool {res['key_pool_mb']:.1f} MB, the shared pool {res['pool_mb']:.1f} MB "
        f"over {res['keys']} key(s); launches a replay {res['launches']}, equal to the device trace {res['traced']} "
        f"and to the eager prefill's; {res['check_s']:.1f} s")
    log("      device ms by group, graph: " + ", ".join(f"{k} {v:.3f}" for k, v in g_groups.items()))
    log("      device ms by group, eager: " + ", ".join(f"{k} {v:.3f}" for k, v in e_groups.items()))
    return res


def check_prefill(tag: str, model, prompt, cache_dtype, lens=None, prefix=None, eos_id: int = -1) -> dict:
    """``prefill_start`` through its graph (the key captured first where the model's prefill
    runner has none) against ``eager=True`` on the same inputs: the first token, tok / pos /
    done and every cache tensor over [0, P) of each row bit for bit; one capture at most;
    then ``prefill_graph_against_eager``."""
    import torch

    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.models.generate import prefill_start

    kw = dict(prompt_lens=lens, prefix_embeds=prefix, prefix_lm=prefix is not None, cache_dtype=cache_dtype,
              eos_id=eos_id)
    runner = dg.prefill_runner_of(model)
    captures = runner.captures
    P = prompt.shape[1] + (0 if prefix is None else prefix.shape[1])

    def call(eager):
        return prefill_start(model, prompt, eager=eager, **kw)

    def run(eager):
        first, state = call(eager)
        torch.cuda.synchronize()
        return [first, state.tok, state.pos, state.done] + [t[:, :, :, :P].clone() for t in dg.cache_tensors(state.cache)]

    run(False)
    got, want = run(False), run(True)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{tag}: the prefill's replay differs from eager=True (first token, state or cache)")
    del got, want
    res = prefill_graph_against_eager(tag, model, lambda: call(False), lambda: call(True))
    if runner.captures - captures > 1:
        raise AssertionError(f"{tag}: the prefill was captured {runner.captures - captures} times")
    res["bit_for_bit"] = True
    log(f"    {tag} prefill: replay equal to eager=True bit for bit (first token, tok / pos / done, every cache "
        f"tensor over [0, {P}))")
    return res


def drive_generate(model, prompt, lens, cache_dtype, need: list[str]) -> dict:
    """The main path: ``generate`` on the ragged batch, each decode step a replay of the
    captured step (the warm-up captures it), under torch.profiler: its launches are the
    wrappers' counts (the replays' credits included), held to the kernels of the device
    trace. Then GRAPH_RUNS timed requests (``timed_request``) and the eager loop on the same
    batch as the reference: the same tokens (bit for bit expected; else every differing row
    under the near-tie rule, counted) and the same launches."""
    import torch

    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.models.generate import generate

    prefill0 = dg.prefill_stats(model)
    generate(model, prompt, max_new_tokens=2, prompt_lens=lens, cache_dtype=cache_dtype)  # warm-up and capture
    generate(model, prompt, max_new_tokens=2, prompt_lens=lens, cache_dtype=cache_dtype, eager=True)
    main = traced("generate through the captured step",
                  lambda: generate(model, prompt, max_new_tokens=NEW_TOKENS, prompt_lens=lens, cache_dtype=cache_dtype))
    out, counts = main["result"], main["launches"]
    B = prompt.shape[0]
    if tuple(out.shape) != (B, NEW_TOKENS) or int(out.min()) < 0 or int(out.max()) >= model.config.vocab_size:
        raise AssertionError(f"generate returned {tuple(out.shape)} in [{int(out.min())}, {int(out.max())}]")
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}: {counts}")
    runs = [timed_request(model, prompt, lens, cache_dtype, False) for _ in range(GRAPH_RUNS)]
    eager = timed_request(model, prompt, lens, cache_dtype, True)
    for r in runs + [eager]:
        if r["launches"] != counts:
            raise AssertionError(f"launches differ between requests: {r['launches']} against {counts}")
    for r in runs:
        if not torch.equal(r["out"], out):
            raise AssertionError("two graph requests of one batch gave different tokens")
    divergences = []
    for i in range(B):
        if not torch.equal(out[i], eager["out"][i]):
            ids = prompt[i, : int(lens[i])].tolist()
            c = check_served_row(model, ids, out[i].tolist(), cache_dtype, other=eager["out"][i].tolist())
            divergences.append((i, c["diverged_at"], c.get("margin"), c.get("tol")))
    tok_s = [r["decode_tok_s"] for r in runs]
    graph = dg.stats(model)
    if graph["captures"] != 1 or graph["replays"] < (GRAPH_RUNS + 1) * (NEW_TOKENS - 1):
        raise AssertionError(f"generate did not decode through one captured graph: {graph}")
    prefill = dg.prefill_stats(model)
    if prefill["captures"] - prefill0["captures"] != 1 or prefill["replays"] - prefill0["replays"] < GRAPH_RUNS + 1:
        raise AssertionError(f"generate's prefill was not one captured graph over the requests: {prefill}")
    main_run = runs[0]
    res = dict(B=B, prompt=int(prompt.shape[1]), new_tokens=NEW_TOKENS, launches=counts, traced=main["traced"],
               total_s=main_run["total_s"], prefill_ms=main_run["prefill_ms"], decode_tok_s=tok_s[0],
               decode_tok_s_runs=tok_s, peak_mem_gb=main_run["peak_mem_gb"],
               eager={k: eager[k] for k in ("total_s", "prefill_ms", "decode_tok_s", "peak_mem_gb")},
               tokens_equal_eager=not divergences, near_tie_divergences=divergences, captures=graph["captures"],
               capture_s=graph["capture_s"], pool_mb=[b / 1e6 for b in graph["pool_bytes"]],
               buffer_sets=graph["slots"], buffer_sets_gb=graph["slot_bytes"] / 1e9)
    log(f"    generate B={B} P={prompt.shape[1]} +{NEW_TOKENS}, graph: launches {counts}, equal to the device trace "
        f"{main['traced']}")
    prefill_ms = ", ".join(f"{r['prefill_ms']:.1f}" for r in runs)
    log(f"    {GRAPH_RUNS} timed requests: prefill {prefill_ms} ms, decode "
        f"{', '.join(f'{t:.1f}' for t in tok_s)} tok/s, peak {main_run['peak_mem_gb']:.2f} GB; capture + "
        f"instantiate {', '.join(f'{t:.3f}' for t in graph['capture_s'])} s, pool "
        f"{', '.join(f'{b / 1e6:.1f}' for b in graph['pool_bytes'])} MB; {graph['slots']} buffer set(s) held between "
        f"requests, {res['buffer_sets_gb']:.3f} GB")
    log(f"    eager loop: prefill {eager['prefill_ms']:.1f} ms, decode {eager['decode_tok_s']:.1f} tok/s, peak "
        f"{eager['peak_mem_gb']:.2f} GB; tokens {'equal bit for bit' if not divergences else f'part at near-ties {divergences}'}"
        "; launches equal")
    res["decode_profile"] = profile_decode(model, prompt, lens, cache_dtype)
    res["eager_decode_profile"] = profile_decode(model, prompt, lens, cache_dtype, steps=3, eager=True)
    res["prefill_graph"] = check_prefill(f"generate B={B} P={prompt.shape[1]}", model, prompt, cache_dtype, lens=lens)
    return res


def profile_decode(model, prompt, lens, cache_dtype, steps: int = 8, eager: bool = False) -> dict:
    """Device busy share and the kernels that take the device time over a few decode
    steps (torch.profiler, CUDA activity), replays of the captured step or (``eager``) the
    eager loop; host wall time around the same window, and the launches of the window held
    to its trace. The profiler's tracing costs the host time for every kernel, a graph's
    nodes too, so the same steps are also timed without it just before, and the busy share
    is given against that wall as well."""
    import torch

    from llama_x_tpu_torch.models.generate import decode_chunk, prefill_start

    _, state = prefill_start(model, prompt, prompt_lens=lens, cache_dtype=cache_dtype, max_new_tokens=NEW_TOKENS,
                             eager=eager)
    _, state = decode_chunk(model, state, 1, eager=eager)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_chunk(model, state, steps, eager=eager)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    what = "eager decode" if eager else "graph decode"
    win = traced(what, lambda: decode_chunk(model, state, steps, eager=eager), cpu=True)
    counts = win["launches"]
    res = summarize_profile(win["prof"], win["wall_ms"], steps, what, "step")
    res["launches_per_step"] = {k: v / steps for k, v in counts.items() if v}
    res["wall_ms_per_step_unprofiled"] = plain_ms
    res["device_busy_share_unprofiled"] = res["device_busy_ms_per_step"] / plain_ms
    log(f"      without the profiler: {plain_ms:.2f} ms/step wall, busy share "
        f"{res['device_busy_share_unprofiled']:.3f} (the profiled busy time over it)")
    traced_per_step = {k: v / steps for k, v in win["traced"].items() if v}
    log(f"      launches a step {res['launches_per_step']}, equal to the device trace {traced_per_step}")
    return res


# device items of a trace by the substring of their name: the port's kernels, then PyTorch's own
DEVICE_ITEM_GROUPS = [
    ("int8_mm_nt_", "K1"), ("int8_mm_kn_kernel", "K4"), ("flash_fwd_kernel", "K2"),
    ("flash_bwd_dkv_kernel", "K5 dkv"), ("flash_bwd_dq_kernel", "K5 dq"), ("decode_kernel", "K3"),
    ("decode_merge_kernel", "K3"), ("quantize_rows_kernel", "K7"),
    ("nvjet", "library GEMMs"), ("gemm", "library GEMMs"), ("cublas", "library GEMMs"), ("cutlass", "library GEMMs"),
    ("reduce_kernel", "reductions"), ("copy_kernel", "copies and casts"), ("elementwise", "elementwise"),
    ("Memcpy", "memcpy"), ("Memset", "memset"),
]


QUANTIZE_LABEL = "quantize_int8_rowwise"
# the plain quantizer chain's abs and round kernels, one of each a call (torch.logsumexp's guard
# on its maxima launches an abs too, one a fused CE chunk)
CHAIN_KERNELS = re.compile(r"AbsFunctor|abs_kernel|round_kernel")


@contextlib.contextmanager
def plain_quantizer():
    """The rowwise quantizer's plain chain in K7's place (the quantizer before K7)."""
    from llama_x_tpu_torch.ops import int8 as i8

    kernel = i8.quantize_rows
    try:
        i8.quantize_rows = i8.quantize_rows_plain
        yield
    finally:
        i8.quantize_rows = kernel


@contextlib.contextmanager
def labelled_quantizers():
    """Bracket every call of the rowwise quantizer with a profiler range, so that a trace
    can say how much device time its passes take (the name grouping below cannot: the
    quantizer's kernels carry PyTorch's generic names). The quantizer runs inside the
    autograd Functions, outside any graph, so the range holds all of its device work."""
    from torch.profiler import record_function

    from llama_x_tpu_torch.models import llama as lm
    from llama_x_tpu_torch.ops import cross_entropy as ce
    from llama_x_tpu_torch.ops import int8 as i8

    inner = i8.quantize_int8_rowwise

    def labelled(*args, **kwargs):
        with record_function(QUANTIZE_LABEL):
            return inner(*args, **kwargs)

    try:
        i8.quantize_int8_rowwise = ce.quantize_int8_rowwise = lm.quantize_int8_rowwise = labelled
        yield
    finally:
        i8.quantize_int8_rowwise = ce.quantize_int8_rowwise = lm.quantize_int8_rowwise = inner


def label_device_ms(prof, label: str) -> tuple[float | None, int]:
    """(device ms of the kernels launched inside the profiler ranges named ``label``,
    number of ranges), or (None, n) where the trace ties no device time to them."""
    import torch

    host = [e for e in prof.key_averages() if e.key == label and e.device_type == torch.autograd.DeviceType.CPU]
    us = sum(getattr(e, "device_time_total", 0) for e in host)
    return (us / 1e3 if us else None), sum(e.count for e in host)


def summarize_profile(prof, wall_ms: float, units: int, what: str, unit: str) -> dict:
    """Device busy share and the largest device items of a profiled window of ``units``
    steps (or microbatches) that took ``wall_ms`` on the host clock."""
    import torch

    # a profiler range shows on the device side too, under its own name: not a device item;
    # nor is a kernel of ``trace_pad``, outside the window
    dev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
           and e.key != QUANTIZE_LABEL and TRACE_PAD_NAME not in e.key]
    busy = {e.key: getattr(e, "self_device_time_total", 0) / 1e3 for e in dev}  # us -> ms
    busy_ms = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    groups: dict[str, float] = {}
    for k, v in busy.items():
        label = next((lab for key, lab in DEVICE_ITEM_GROUPS if key in k), "other")
        groups[label] = groups.get(label, 0.0) + v / units
    res = dict(steps=units, wall_ms_per_step=wall_ms / units, device_busy_ms_per_step=busy_ms / units,
               device_busy_share=busy_ms / wall_ms if busy_ms else None,
               top_kernels_ms_per_step={k[:80]: v / units for k, v in top}, groups_ms_per_step=groups)
    share = "not measured (no device time in the trace)" if not busy_ms else f"{busy_ms / wall_ms:.3f}"
    log(f"    {what} profile: {wall_ms / units:.2f} ms/{unit} wall, {busy_ms / units:.2f} ms/{unit} device busy, "
        f"busy share {share}")
    for k, v in top:
        log(f"      {v / units:8.3f} ms/{unit}  {k[:90]}")
    log("      by group, ms/" + unit + ": " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    return res


def two_path_logits(model, prompt, lens, cache_dtype, nxt=None):
    """Prefill logits [B, P, V] and the first decode step's logits [B, 1, V]; the
    decode step feeds ``nxt`` (default: the greedy token of each row)."""
    import torch

    from llama_x_tpu_torch.models import llama
    from llama_x_tpu_torch.ops.attention import MaskInfo

    B, P = prompt.shape
    with torch.inference_mode():
        cache = llama.init_kv_cache(model.config, B, dtype=cache_dtype, device=model.device)
        x = torch.nn.functional.embedding(prompt, model.tok_embeddings)
        pos = torch.arange(P, device=model.device)
        h, cache = llama.trunk(model, x, MaskInfo(causal=True), cache, input_pos=pos, prefill=True)
        lp = llama.head(model, h)
        if nxt is None:
            nxt = lp.gather(1, (lens - 1)[:, None, None].expand(B, 1, lp.shape[-1]))[:, 0].argmax(-1)
        x1 = torch.nn.functional.embedding(nxt[:, None], model.tok_embeddings)
        mi = MaskInfo(causal=True, q_positions=lens[:, None], kv_len=lens + 1)
        h1, _ = llama.trunk(model, x1, mi, cache, input_pos=lens[:, None])
        return lp, llama.head(model, h1), nxt


def compare_paths(model, prompt, lens, cache_dtype, tag: str) -> dict:
    """Kernel path against plain path on a 2-layer cut of the same weights."""
    cut = cut_of(model)
    lp_k, ld_k, nxt = two_path_logits(cut, prompt, lens, cache_dtype)
    reset_counts()
    with plain_path():
        lp_p, ld_p, _ = two_path_logits(cut, prompt, lens, cache_dtype, nxt)
    if any(read_counts().values()):
        raise AssertionError(f"the plain path launched kernels: {read_counts()}")
    res = {}
    for name, a, b in (("prefill", lp_k, lp_p), ("decode", ld_k, ld_p)):
        ref_max = float(b.float().abs().max())
        tol = 2**-6 * ref_max  # two bf16 ulps of the largest logit (bf16 logits out of bf16 layers)
        err = max_err(a, b)
        check(f"{tag} 2-layer {name} logits, kernels vs plain (max|ref| {ref_max:.2f})", err, tol)
        res[f"{name}_max_abs_err"], res[f"{name}_tol"] = err, tol
    return res


def phase_main_path():
    """-> (runs, the int8 model), which the serving phases reuse."""
    import torch

    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model
    from llama_x_tpu_torch.models import llama

    prompt, lens = ragged_prompts()
    runs = {}
    check_trace_pad()
    for kind in ("bf16", "int8"):
        quant = kind == "int8"
        log(f"[main path] Llama-3.1-8B width, 32 layers, {'int8 weights + dynamic int8 act + int8 KV' if quant else 'bf16 weights + bf16 KV'}")
        config = llama.LlamaConfig(**GEOMETRIES["8b"], max_seq_len=4096, dynamic_int8_act=quant)
        t0 = time.perf_counter()
        model = build_model(config, quant, seed=0, device="cuda")
        torch.cuda.synchronize()
        log(f"    weights built on the card from seed 0 in {time.perf_counter() - t0:.1f} s")
        cache_dtype = torch.int8 if quant else torch.bfloat16
        need = ["flash_attention", "decode_attention_int8", "int8_mm_dequant_nt"] if quant else \
            ["flash_attention", "decode_attention"]
        run = drive_generate(model, prompt, lens, cache_dtype, need)
        run["two_path"] = compare_paths(model, prompt, lens, cache_dtype, kind)
        runs[kind] = run
        if not quant:
            del model
            torch.cuda.empty_cache()
    log(f"[main path] generate_speculative at 32 layers: int8 target + int8 KV, untrained 4-layer draft of width "
        f"1024, B {prompt.shape[0]} ragged, +{SPEC_NEW_TOKENS} tokens, gamma 4; the captured round, then eager=True")
    draft = build_model(llama.LlamaConfig(**{**GEOMETRIES["8b"], **SPEC_DRAFT}, max_seq_len=4096), False, 7, "cuda")
    runs["speculative_32"] = drive_speculative(model, draft, prompt, lens, gamma=4)
    del draft
    torch.cuda.empty_cache()
    return runs, model


SPEC_NEW_TOKENS = 32


def drive_speculative(model, draft, prompt, lens, gamma: int) -> dict:
    """``generate_speculative`` of the int8 target (int8 cache) with an untrained draft, B 4
    ragged, SPEC_NEW_TOKENS new tokens, greedy; each round a replay of the captured round (a
    2-token request captures it first), counts reset just before and held to the device
    trace; then a timed request through the graph and the same request with ``eager=True``:
    the tokens equal bit for bit, and the same launches. From gamma 8 the verify reads the
    int8 cache through K2's offsets form over the static kv bound."""
    import torch

    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.models.speculative import generate_speculative

    kw = dict(gamma=gamma, prompt_lens=lens, cache_dtype=torch.int8)
    generate_speculative(model, draft, prompt, max_new_tokens=2, **kw)  # warm-up and capture
    capture_s = dg.stats(model)["capture_s"][-1]
    prefill = check_spec_prefill(model, draft, prompt, lens, gamma)

    def request(eager):
        """-> (tokens, stats, host seconds, the captures and replays it made)."""
        g0 = dg.stats(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = generate_speculative(model, draft, prompt, max_new_tokens=SPEC_NEW_TOKENS, eager=eager, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g1 = dg.stats(model)
        return out, stats, wall, (g1["captures"] - g0["captures"], g1["replays"] - g0["replays"])

    main = traced("generate_speculative through the captured round", lambda: request(False))
    out, stats, _, (captures, replays) = main["result"]
    _, _, wall, _ = request(False)
    reset_counts()
    eager_out, eager_stats, eager_wall, _ = request(True)
    eager_counts = read_counts()
    B, V = prompt.shape[0], model.config.vocab_size
    if tuple(out.shape) != (B, SPEC_NEW_TOKENS) or int(out.min()) < 0 or int(out.max()) >= V:
        raise AssertionError(f"generate_speculative returned {tuple(out.shape)} in [{int(out.min())}, {int(out.max())}]")
    rounds = stats["target_passes"] - 1
    if captures or replays != rounds:
        raise AssertionError(f"{rounds} rounds, {replays} replays and {captures} captures: a round ran outside the "
                             "captured graph")
    if not torch.equal(out, eager_out) or stats["target_passes"] != eager_stats["target_passes"]:
        raise AssertionError("the captured rounds' tokens differ from the eager rounds'")
    if eager_counts != main["launches"]:
        raise AssertionError(f"launches differ: {main['launches']} through the graph, {eager_counts} eager")
    need_launches(main["launches"], ["flash_attention", "decode_attention_int8", "int8_mm_dequant_nt"]
                  + (["flash_attention_offsets"] if gamma >= 8 else []), f"generate_speculative gamma {gamma}")
    emitted = int(stats["tokens_emitted"].sum())
    res = dict(B=B, new_tokens=SPEC_NEW_TOKENS, gamma=gamma, wall_s=wall, tokens_per_s=emitted / wall,
               target_passes=stats["target_passes"], replays=replays, launches=main["launches"],
               traced=main["traced"], capture_s=capture_s,
               eager=dict(wall_s=eager_wall, tokens_per_s=emitted / eager_wall), prefill_graph=prefill)
    log(f"    graph: {emitted} tokens in {wall:.2f} s ({emitted / wall:.1f} tok/s, both prefills included), "
        f"{rounds} rounds = {replays} replays, capture + instantiate {capture_s:.3f} s; launches {main['launches']}, "
        f"equal to the device trace {main['traced']}")
    log(f"    eager: {eager_wall:.2f} s ({emitted / eager_wall:.1f} tok/s); tokens and launches equal to the graph's")
    return res


def check_spec_prefill(model, draft, prompt, lens, gamma: int) -> dict:
    """``generate_speculative``'s two prefills, its first token and the fill of its state as
    one graph (a request of one token: no round) against the same body launched op by op on
    fresh buffers (what ``eager=True`` runs): both caches over [0, P) of each row, the first
    token, prev / cur / pos / n_out / done bit for bit; then ``prefill_graph_against_eager``
    against ``eager=True`` requests of one token."""
    import torch

    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.models import speculative as mspec

    B, P = prompt.shape
    kw = dict(gamma=gamma, prompt_lens=lens, cache_dtype=torch.int8)

    def run(eager):
        out, _ = mspec.generate_speculative(model, draft, prompt, max_new_tokens=1, eager=eager, **kw)
        torch.cuda.synchronize()
        return out

    def tensors(s):
        caches = dg.cache_tensors(s.t_cache) + dg.cache_tensors(s.d_cache)
        return [t[:, :, :, :P].clone() for t in caches] + [s.buf[:, :1].clone(), s.prev, s.cur, s.pos, s.n_out, s.done]

    run(False)
    got = tensors(dg.runner_of(model).slots[("speculative", B, torch.int8, draft.config)])
    ref = mspec.new_spec_state(model, draft, B, torch.int8)
    with torch.inference_mode():
        mspec._start(model, draft, ref, dg.PrefillInputs(prompt, None, lens.long()), None, temperature=0.0, top_k=0,
                     top_p=1.0, min_p=0.0, eos_id=-1, pad_id=0)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, tensors(ref))):
        raise AssertionError("generate_speculative's prefill replay differs from its eager body (caches or state)")
    if not torch.equal(run(False), run(True)):
        raise AssertionError("generate_speculative's first token differs between the graph and eager=True")
    del got, ref
    res = prefill_graph_against_eager(f"generate_speculative B={B} P={P}", model, lambda: run(False),
                                      lambda: run(True))
    res["bit_for_bit"] = True
    log("    generate_speculative prefills: replay equal to the eager body bit for bit (both caches over "
        f"[0, {P}), first token, prev / cur / pos / n_out / done)")
    return res


# ---------------------------------------------------------------------------
# phases 3a to 3d: serving beyond generate at 8B width (the int8 model of the main path)
# ---------------------------------------------------------------------------


def logit_tolerance(logits):
    """Per step: K2's tolerance applied to a row of logits, 2^-7 |top| + 2^-5 rms(row): how
    far two greedy decodes of one prefix that sum in other orders may put two tokens."""
    top = logits.max(dim=-1).values
    return 2**-7 * top.abs() + 2**-5 * logits.pow(2).mean(dim=-1).sqrt()


def reference_logits(model, prompt_ids: list[int], tokens: list[int], cache_dtype):
    """Logits [n, V] f32 of each step of a served row, unbatched: the prompt prefilled into a
    fresh single-row cache of the same type, then the row's tokens but the last read over
    that cache in one pass (teacher forcing: each step's logits from the row's own prefix)."""
    import torch

    from llama_x_tpu_torch.models import llama
    from llama_x_tpu_torch.ops.attention import MaskInfo

    dev = model.device
    P, n = len(prompt_ids), len(tokens)
    with torch.inference_mode():
        cache = llama.init_kv_cache(model.config, 1, dtype=cache_dtype, device=dev)
        x = torch.nn.functional.embedding(torch.tensor([prompt_ids], device=dev), model.tok_embeddings)
        h, _ = llama.trunk(model, x, MaskInfo(causal=True), cache, input_pos=torch.arange(P, device=dev), prefill=True)
        rows = [llama.head(model, h[:, -1:])[0].float()]
        if n > 1:
            pos = torch.arange(P, P + n - 1, device=dev)
            x = torch.nn.functional.embedding(torch.tensor([tokens[:-1]], device=dev), model.tok_embeddings)
            mi = MaskInfo(causal=True, q_positions=pos[None], kv_len=torch.tensor([P + n - 1], device=dev))
            h, _ = llama.trunk(model, x, mi, cache, input_pos=pos)
            rows.append(llama.head(model, h)[0].float())
    return torch.cat(rows, dim=0)


def check_served_row(model, prompt_ids, tokens, cache_dtype, other=None) -> dict:
    """A served greedy row under the near-tie rule. Every step: the served token is the
    argmax of the unbatched reference logits of its step (``reference_logits``: the row's
    own prefix, one row, no co-tenants) or lies within ``logit_tolerance`` of it (a near-tie
    that another summation order may flip). ``other``: a second greedy decode of the prompt
    (an unbatched ``generate``, or a second serving); where the two first part, both tokens
    must lie within the tolerance of each other in that step's reference logits. Raises
    otherwise; returns the counts."""
    import torch

    tokens = list(tokens)
    logits = reference_logits(model, prompt_ids, tokens, cache_dtype)
    tok = torch.tensor(tokens, device=logits.device)
    gap = logits.max(dim=-1).values - logits.gather(1, tok[:, None])[:, 0]
    tol = logit_tolerance(logits)
    if bool((gap > tol).any()):
        i = int((gap > tol).nonzero()[0, 0])
        raise AssertionError(f"served token {i} lies {float(gap[i]):.4f} below its step's top logit (tolerance "
                             f"{float(tol[i]):.4f}): not a greedy decode of the prompt")
    res = dict(steps=len(tokens), off_argmax=int((gap > 0).sum()), diverged_at=None)
    if other is None or list(other) == tokens:
        return res
    other = list(other)
    i = next((j for j, (a, b) in enumerate(zip(tokens, other)) if a != b), min(len(tokens), len(other)))
    if i >= min(len(tokens), len(other)):
        raise AssertionError(f"the decodes agree for {i} tokens, then one stops: {len(tokens)} against {len(other)}")
    margin = abs(float(logits[i, tokens[i]] - logits[i, other[i]]))
    res.update(diverged_at=i, margin=margin, tol=float(tol[i]))
    if margin > float(tol[i]):
        raise AssertionError(f"the decodes part at step {i} with a margin of {margin:.4f} over the tolerance "
                             f"{float(tol[i]):.4f}: not a near-tie")
    return res


def unbatched_generate(model, prompt_ids, n: int, cache_dtype) -> list[int]:
    import torch

    from llama_x_tpu_torch.models.generate import generate

    return generate(model, torch.tensor([prompt_ids], device="cuda"), max_new_tokens=n, cache_dtype=cache_dtype)[0].tolist()


def byte_prompt(tok, i: int, n: int) -> list[int]:
    """A byte-token prompt of n tokens (BOS first) of numbered text, distinct per i."""
    text = "".join(f"Request {i}, sentence {j}: the port serves Llama on Hopper with continuous batching. "
                   for j in range(n // 40 + 2))
    return tok(text, add_bos=True)[:n]


class _Timeline:
    """A stream queue that keeps when each block of tokens arrived."""

    def __init__(self):
        self.t0, self.blocks, self.done = time.perf_counter(), [], None

    def put(self, item):
        now = time.perf_counter()
        if item is None:
            self.done = now
        else:
            self.blocks.append((now, len(item)))


def latency_stats(lines: list) -> dict:
    """TTFT (submit to first token) and inter-token latency (a block's gap spread over its
    tokens) in ms, p50 and p99."""
    import numpy as np

    ttft = [(tl.blocks[0][0] - tl.t0) * 1e3 for tl in lines]
    itl = []
    for tl in lines:
        for (t_prev, _), (t, n) in zip(tl.blocks, tl.blocks[1:]):
            itl += [(t - t_prev) * 1e3 / n] * n
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None  # noqa: E731
    return dict(ttft_ms_p50=pct(ttft, 50), ttft_ms_p99=pct(ttft, 99), itl_ms_p50=pct(itl, 50),
                itl_ms_p99=pct(itl, 99))


def need_launches(counts: dict, need: list[str], what: str):
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"{what} never launched {missing}: {counts}")


def serve_waves(sched, prompts: list, new_tokens: list) -> dict:
    """The continuous phase's traffic through ``sched``: a warm-up (the paths' first calls: a
    40-token row for the decode step's capture, then one of 2100 tokens whose chunks start at
    every chunk position the traffic's admissions reach, 0 to 2048, so that each admission
    program the traffic runs is captured there), then ``prompts`` in four waves of four 0.25 s
    apart, counts reset just before; -> the handles, the timelines, wall and counts, and the
    admission programs captured before and inside the waves."""
    import torch

    from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
    from llama_x_tpu_torch.models import decode_graph as dg

    for n in (40, 2100):
        warm = sched.submit(byte_prompt(ByteTokenizer(), 99, n), max_tokens=4)
        if not warm.event.wait(600) or warm.error is not None:
            raise AssertionError(f"warm-up failed: {warm.error}")
    hits0, disp0, chunks0 = sched.prefix_hits, sched.prefill_dispatches, sched.dispatches
    adm0 = sched.inputs.runner.captures
    torch.cuda.synchronize()
    reset_counts()
    lines, handles = [], []
    t0 = time.perf_counter()
    for w in range(4):
        for i in range(4 * w, 4 * w + 4):
            lines.append(_Timeline())
            handles.append(sched.submit(prompts[i], max_tokens=new_tokens[i], stream_q=lines[-1]))
        if w < 3:
            time.sleep(0.25)
    for h in handles:
        if not h.event.wait(900) or h.error is not None:
            raise AssertionError(f"a request failed: {h.error}")
    wall = time.perf_counter() - t0
    total = sum(len(h.tokens) for h in handles)
    adm = sched.inputs.runner.stats()
    return dict(handles=handles, wall_s=wall, tokens_per_s=total / wall, new_tokens=total, launches=read_counts(),
                prefix_hits=sched.prefix_hits - hits0, prefill_dispatches=sched.prefill_dispatches - disp0,
                decode_dispatches=sched.dispatches - chunks0, admission_captures=adm["captures"],
                admission_captures_in_waves=adm["captures"] - adm0, **latency_stats(lines))


def phase_continuous(model) -> dict:
    """Continuous batching at 8B width (int8 weights + dynamic int8 act, int8 KV): 8 slots,
    16-step decode chunks, chunked prefill of 512, a prefix cache of 4. 16 byte-token
    requests in four waves of four 0.25 s apart: 8 prompts of 130 to 1500 tokens, then 8
    follow-ups that extend one of them by 64 to 200 tokens (prefix hits); 32 to 64 new
    tokens each, greedy. Each decode step, admission program (a prefill chunk, a row's
    install) is a replay of its captured graph, captured in a warm-up (``serve_waves``; those
    captured inside the timed waves are counted). Every row is held to an unbatched
    ``generate`` of its prompt and to its unbatched reference at every step, under the
    near-tie rule (``check_served_row``). Then the same traffic with ``eager=True`` (decode
    steps and admissions op by op) beside it: TTFT, ITL, tokens/s and the busy share of a
    profiled wave of 8 arrivals in both, its rows against the graph's (near-tie rule where they
    differ)."""
    import torch

    from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.serve.continuous import ContinuousScheduler

    tok = ByteTokenizer()
    cache = torch.int8
    log(f"[continuous serving] 8B width, {model.config.num_layers} layers, int8 + dynamic int8 act + int8 KV; ContinuousScheduler(n_slots=8, chunk_size=16, "
        "prompt_multiple=64, prefill_chunk=512, prefix_cache=4); 16 requests in 4 waves of 4, 0.25 s apart")
    base_lens = [130, 300, 500, 700, 900, 1100, 1300, 1500]
    bases = [byte_prompt(tok, i, n) for i, n in enumerate(base_lens)]
    ext = [64, 100, 150, 200, 64, 120, 180, 200]
    follow = [bases[j] + byte_prompt(tok, 100 + j, ext[j] + 1)[1:] for j in (4, 5, 6, 7, 0, 1, 2, 3)]
    prompts = bases + follow
    new_tokens = [32 + (7 * i) % 33 for i in range(16)]
    wave = [byte_prompt(tok, 300 + i, 300 + 100 * i) for i in range(8)]
    served = {}
    for eager in (False, True):
        dg.release(model)  # each run's graphs and counts its own
        sched = ContinuousScheduler(model, n_slots=8, chunk_size=16, prompt_multiple=64, cache_dtype=cache,
                                    prefill_chunk=512, prefix_cache=4, seed=0, eager=eager)
        try:
            run = serve_waves(sched, prompts, new_tokens)
            run["profile"] = profile_arrivals(sched, wave, 32)
            run["prefix_tokens_reused"] = sched.prefix_tokens_reused
            adm = sched.inputs.runner.stats()
            run.update(decode_captures=dg.stats(model)["captures"], admission_graphs=adm["graphs"],
                       admission_capture_s=adm["capture_s"], admission_pool_mb=sum(adm["pool_bytes"]) / 2**20,
                       row_pool_mb=sched.inputs.nbytes() / 2**20, parked_rows=len(sched.inputs.pool))
        finally:
            sched.close()
        what = "eager loop" if eager else "graph"
        log(f"    {what}: {run['new_tokens']} tokens in {run['wall_s']:.2f} s: {run['tokens_per_s']:.1f} tok/s; TTFT p50 "
            f"{run['ttft_ms_p50']:.1f} ms, p99 {run['ttft_ms_p99']:.1f} ms; ITL p50 {run['itl_ms_p50']:.2f} ms, p99 "
            f"{run['itl_ms_p99']:.2f} ms; prefix hits {run['prefix_hits']} ({run['prefix_tokens_reused']} tokens "
            f"reused), prefill chunks {run['prefill_dispatches']}, decode chunks {run['decode_dispatches']}")
        log(f"    {what}: admission programs captured {run['admission_captures']} ({run['admission_captures_in_waves']} "
            f"inside the timed waves, the rest in the warm-up), held {run['admission_graphs']}; capture + instantiate "
            f"{', '.join(f'{t:.3f}' for t in run['admission_capture_s'])} s; the admission pool "
            f"{run['admission_pool_mb']:.1f} MB; the working row and {run['parked_rows']} parked rows "
            f"{run['row_pool_mb']:.1f} MB")
        log(f"    launches {run['launches']}")
        need_launches(run["launches"], ["int8_mm_dequant_nt", "flash_attention", "flash_attention_offsets",
                                        "decode_attention_int8"], f"continuous serving ({what})")
        if run["prefix_hits"] == 0:
            raise AssertionError("no prefix-cache hit in the follow-up requests")
        served[what] = run
    graph, eager = served["graph"], served["eager loop"]
    if graph["decode_captures"] < 1 or graph["admission_captures"] < 1 or eager["admission_captures"] != 0:
        raise AssertionError("the decode chunks or the admissions did not run through captured graphs, or eager=True "
                             "captured an admission")
    res = dict(requests=16, prompt_tokens=sum(map(len, prompts)), captures=graph["decode_captures"],
               **{k: v for k, v in graph.items() if k != "handles"},
               eager={k: v for k, v in eager.items() if k != "handles"})
    # every row against its unbatched reference at every step and against an unbatched generate
    checks = [check_served_row(model, p, h.tokens, cache, unbatched_generate(model, p, len(h.tokens), cache))
              for p, h in zip(prompts, graph["handles"])]
    res["rows"] = checks
    res["near_tie_divergences"] = sum(c["diverged_at"] is not None for c in checks)
    total = graph["new_tokens"]
    log(f"    every row a greedy decode of its prompt step by step (unbatched reference logits; tokens off the "
        f"argmax but within the tolerance: {sum(c['off_argmax'] for c in checks)} of {total}); against an unbatched "
        f"generate: {16 - res['near_tie_divergences']} rows equal, {res['near_tie_divergences']} part at a near-tie "
        f"{[(c['diverged_at'], round(c['margin'], 5), round(c['tol'], 5)) for c in checks if c['diverged_at'] is not None]}")
    eager_rows = [check_served_row(model, p, e.tokens, cache, g.tokens)
                  for p, g, e in zip(prompts, graph["handles"], eager["handles"]) if e.tokens != g.tokens]
    res["eager_rows_differing"] = len(eager_rows)
    log(f"    the eager loop's rows: {16 - len(eager_rows)} equal the graph's, {len(eager_rows)} part at a near-tie")
    return res


def profile_arrivals(sched, prompts: list, new_tokens: int) -> dict:
    """Where the device time goes while a scheduler admits and decodes: one wave of
    ``prompts`` arriving together, under torch.profiler (CUDA activity, which sees the
    worker thread's launches), from the first submit to the last row's end; counts reset
    just before, and the wave's launches (the decode and admission replays' credits among
    them) held to the device trace."""
    def wave():
        handles = [sched.submit(p, max_tokens=new_tokens) for p in prompts]
        for h in handles:
            if not h.event.wait(600) or h.error is not None:
                raise AssertionError(f"a profiled request failed: {h.error}")

    what = f"arrivals ({len(prompts)} requests, {new_tokens} tokens each)"
    win = traced(what, wave)
    res = summarize_profile(win["prof"], win["wall_ms"], 1, what, "wave")
    res.update(launches=win["launches"], traced=win["traced"])
    log(f"      the wave's launches {win['launches']}, equal to the device trace {win['traced']}")
    return res


ADMIT_PROMPTS = ((0, 100), (1, 300), (2, 90), (3, 700))  # (slot, tokens): buckets 128, 320, 128, 704
ADMIT_PROGRAMS = 11  # programs of one pass of ``admission_programs``


def admission_programs(model, draft, cache_dtype, states=None, eager: bool = False) -> tuple:
    """Every admission program of the schedulers once, over 4-slot states of the continuous
    and of the speculative scheduler with their ``AdmitBuffers`` (made unless ``states`` are
    given): ``admit_row`` at the buckets 128, 320 and 704 (four prompts, two sharing 128),
    ``admit_row_prefix`` at (P0, Sb) = (64, 128) and (256, 64) over prefixes taken from the
    lanes (the keys (Sb, extent) = (128, 512) and (64, 512)), a 600-token prompt prefilled in chunks of 256 (a first and two continuations) and
    installed, and ``spec_admit_row`` at 192; through the graphs, or ``eager``; greedy, the
    prompts from one seed. -> (states, first tokens, {wrapper: launches of the pass})"""
    import torch

    from llama_x_tpu_torch.serve import continuous as cont
    from llama_x_tpu_torch.serve import speculative as spec

    dev = model.device
    if states is None:
        st = cont.init_state(model.config, 4, cache_dtype, dev)
        ss = spec.init_spec_state(model.config, draft.config, 4, cache_dtype, dev)
        states = (st, cont.AdmitBuffers(model, st[0]), ss, cont.AdmitBuffers(model, ss[0], ss[1]))
    st, inputs, ss, sinputs = states
    g = torch.Generator().manual_seed(17)
    ids = lambda n: torch.randint(0, 256, (n,), generator=g).tolist()  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(0)
    greedy = (0.0, 0, 1.0, 0.0)
    torch.cuda.synchronize()
    before = read_counts()
    firsts = [int(cont.admit_row(model, st, inputs, slot, ids(n), greedy, -1, gen, eager=eager)[0])
              for slot, n in ADMIT_PROMPTS]
    for src, p0, dst, n in ((0, 64, 1, 100), (3, 256, 2, 30)):
        prefix = cont.slice_prefix(st[0], src, p0)
        firsts.append(int(cont.admit_row_prefix(model, st, inputs, dst, prefix, p0, ids(n), greedy, -1, gen,
                                                eager=eager)[0]))
    long = ids(600)
    for start in range(0, 600, 256):
        cont.prefill_chunk(model, inputs, long[start:start + 256], start, 256, eager=eager)
    firsts.append(int(cont.install_row(model, st, 0, inputs, 600, greedy, -1, gen, eager=eager)[0]))
    firsts.append(int(spec.spec_admit_row(model, draft, ss, sinputs, 1, ids(150), greedy, -1, gen, eager=eager)[0]))
    torch.cuda.synchronize()
    after = read_counts()
    return states, firsts, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def admission_stats(states) -> dict:
    """The admission graphs' counts over both buffer sets of ``states`` (each its own runner
    and pool)."""
    a, b = (states[i].runner.stats() for i in (1, 3))
    return {k: a[k] + b[k] for k in ("captures", "replays", "graphs", "capture_s", "pool_bytes")}


def admission_state_tensors(states) -> list:
    from llama_x_tpu_torch.models.decode_graph import cache_tensors

    st, _, ss, _ = states
    return [*cache_tensors(st[0]), *st[1:5], *cache_tensors(ss[0]), *cache_tensors(ss[1]), *ss[2:7]]


def check_admissions(model, draft, cache_dtype) -> dict:
    """``admission_programs`` eagerly on states of their own, then through the graphs twice on
    another pair of states (the first pass captures a graph a key, the second replays only),
    then a traced pass of replays: the first tokens equal, every state tensor (both schedulers'
    lanes, tok / pos / done / emitted, prev / cur) equal bit for bit, the launches of a pass of
    replays equal the eager pass's and the device trace's, one graph a key (9 with a bf16 cache;
    10 with int8, whose continuation chunks split at the kv bounds 512 and 1024), no capture in
    the second pass. Raises otherwise; -> the numbers (host seconds of a pass, eager and
    replayed; each capture's seconds; the pool's growth)."""
    import torch

    from llama_x_tpu_torch.models import decode_graph as dg

    form = "int8" if cache_dtype == torch.int8 else "bf16"
    dg.release(model)  # the counts and graphs of this check alone
    t0 = time.perf_counter()
    eager_states, eager_first, eager_launches = admission_programs(model, draft, cache_dtype, eager=True)
    eager_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    states, first, _ = admission_programs(model, draft, cache_dtype)
    capture_pass_s = time.perf_counter() - t0
    s1 = admission_stats(states)
    t0 = time.perf_counter()
    _, again, replay_launches = admission_programs(model, draft, cache_dtype, states=states)
    replay_s = time.perf_counter() - t0
    s2 = admission_stats(states)
    if not eager_first == first == again:
        raise AssertionError(f"admissions ({form}): first tokens eager {eager_first}, graph {first}, replayed {again}")
    differ = [i for i, (a, b) in enumerate(zip(admission_state_tensors(eager_states), admission_state_tensors(states)))
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"admissions ({form}): state tensors {differ} differ between the graphs and eager")
    if replay_launches != eager_launches:
        raise AssertionError(f"admissions ({form}): replays launched {replay_launches}, eager {eager_launches}")
    want = 10 if form == "int8" else 9
    if (s1["captures"], s1["graphs"], s2["captures"], s2["replays"] - s1["replays"]) != (want, want, want,
                                                                                        ADMIT_PROGRAMS):
        raise AssertionError(f"admissions ({form}): {s1} then {s2}: not one graph a key, replayed once a program")
    win = traced(f"admission replays ({form})", lambda: admission_programs(model, draft, cache_dtype, states=states))
    return dict(cache=form, programs=ADMIT_PROGRAMS, graphs=s2["graphs"], capture_s=s2["capture_s"],
                pool_mb=sum(s2["pool_bytes"]) / 2**20, eager_pass_s=eager_s, capture_pass_s=capture_pass_s,
                replay_pass_s=replay_s, launches_per_pass=eager_launches, launches=win["launches"],
                traced=win["traced"])


def scheduler_admissions(model, cache_dtype) -> dict:
    """``ContinuousScheduler`` (4 slots, 8-step chunks, ``prefill_chunk=0``, ``prefix_cache=4``)
    through the admission graphs and with ``eager=True``: prompts of 100, 300 and 700 tokens
    (buckets 128, 320, 704), then follow-ups over the first two's harvested prefixes ((P0, Sb) =
    (64, 128) and (256, 64)), 16 new tokens each, greedy: the tokens bit for bit, one graph a
    bucket. Raises otherwise; -> the counts."""
    import torch

    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.serve.continuous import ContinuousScheduler

    g = torch.Generator().manual_seed(23)
    bases = [torch.randint(0, 256, (n,), generator=g).tolist() for n in (100, 300, 700)]
    follow = [bases[0][:64] + torch.randint(0, 256, (100,), generator=g).tolist(),
              bases[1][:256] + torch.randint(0, 256, (30,), generator=g).tolist()]
    rows = {}
    for eager in (True, False):
        dg.release(model)
        sched = ContinuousScheduler(model, n_slots=4, chunk_size=8, prompt_multiple=64, cache_dtype=cache_dtype,
                                    prefix_cache=4, eager=eager)
        try:
            out = []
            for wave in (bases, follow):
                handles = [sched.submit(ids, max_tokens=16) for ids in wave]
                for h in handles:
                    if not h.event.wait(600) or h.error is not None:
                        raise AssertionError(f"a scheduler admission failed: {h.error}")
                out += [h.tokens for h in handles]
        finally:
            sched.close()
        rows[eager] = (out, sched.prefix_hits, sched.inputs.runner.stats())
    (graph, hits, adm), (eager_rows, eager_hits, _) = rows[False], rows[True]
    if graph != eager_rows or hits != eager_hits or hits != 2:
        raise AssertionError(f"the scheduler's admissions through the graphs differ from eager=True ({hits} / "
                             f"{eager_hits} prefix hits)")
    if adm["graphs"] != 5 or adm["captures"] != 5:
        raise AssertionError(f"the scheduler's admissions: {adm}, not one graph a bucket (3 + 2)")
    return dict(rows=len(graph), prefix_hits=hits, admission_graphs=adm["graphs"])


def phase_admissions(model) -> dict:
    """The schedulers' admission programs on a 2-layer cut of the int8 serving model (8B width,
    dynamic int8 act) with a 2-layer draft of width 1024, over a bf16 and an int8 cache: each
    program through its graph against ``eager=True`` (``check_admissions``), then
    ``ContinuousScheduler``'s own admissions (``scheduler_admissions``)."""
    import torch

    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model
    from llama_x_tpu_torch.models import llama

    cut = cut_of(model, 2)
    draft = build_model(llama.LlamaConfig(**{**GEOMETRIES["8b"], **SPEC_DRAFT, "num_layers": 2}, max_seq_len=4096),
                        False, 7, "cuda")
    res, launches = {}, {}
    for cache in (torch.bfloat16, torch.int8):
        r = check_admissions(cut, draft, cache)
        r["scheduler"] = scheduler_admissions(cut, cache)
        log(f"[admissions] 2 layers of 8B width (int8 weights), {r['cache']} cache: {r['programs']} programs "
            f"(admit_row x4 at 3 buckets, admit_row_prefix x2, prefill_chunk x3 + install_row, spec_admit_row) "
            f"through {r['graphs']} graphs, first tokens and every state tensor equal to eager=True bit for bit; "
            f"a pass {r['eager_pass_s'] * 1e3:.1f} ms eager, {r['replay_pass_s'] * 1e3:.1f} ms replayed "
            f"({r['capture_pass_s']:.2f} s capturing); capture + instantiate {', '.join(f'{t:.3f}' for t in r['capture_s'])} s, "
            f"the admission pool {r['pool_mb']:.1f} MB; launches a pass {r['launches_per_pass']}, a traced pass "
            f"{r['launches']} = the device trace {r['traced']}; ContinuousScheduler (prefill_chunk=0, prefix_cache=4): "
            f"{r['scheduler']['rows']} rows, {r['scheduler']['prefix_hits']} prefix hits, through "
            f"{r['scheduler']['admission_graphs']} graphs, tokens equal to eager=True bit for bit")
        res[r["cache"]] = r
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    res["launches"] = launches
    del cut, draft
    torch.cuda.empty_cache()
    return res


# the serving phases' depth: the first 8 of the 8B model's 32 layers, at full width, which
# keeps the whole script inside half its time limit (the unbatched references of the
# continuous phase's 16 rows took most of its 196 s at 32 layers and 126 s at 16 on an H100)
SERVING_LAYERS = 4
SPEC_DRAFT = dict(num_layers=4, embed_dim=1024, num_heads=8, num_kv_heads=8, intermediate_dim=2816)


SPEC_ROUNDS = 4  # rounds of a profiled window of speculative rounds (each window costs seconds of tracing)


def profile_spec_rounds(model, draft, prompts: list, gamma: int, eager: bool) -> dict:
    """A speculative round's wall against its device busy time: the 4 prompts admitted into a
    state of their own (``spec_admit_row``, greedy), one chunk of SPEC_ROUNDS rounds to
    capture the graph (the eager rounds need none), one timed without the profiler, then one
    under it (``traced``: the launches held to the device trace); a round is one replay of the
    captured round, or (``eager``) the round launched op by op."""
    import torch

    from llama_x_tpu_torch.serve.speculative import AdmitBuffers, init_spec_state, spec_admit_row, spec_chunk

    n = len(prompts)
    state = init_spec_state(model.config, draft.config, n, torch.bfloat16, "cuda", width=SPEC_ROUNDS * (gamma + 1))
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = AdmitBuffers(model, state[0], state[1])
    for slot, p in enumerate(prompts):
        spec_admit_row(model, draft, state, inputs, slot, p, (0.0, 0, 1.0, 0.0), -1, gen)
    zeros = torch.zeros(n, device="cuda")
    row = (zeros, zeros.long(), zeros + 1, zeros, zeros.long() - 1, zeros.long() + 3 * SPEC_ROUNDS * (gamma + 1))
    live = torch.zeros((), dtype=torch.int64, device="cuda")

    def chunk():
        return spec_chunk(model, draft, state, SPEC_ROUNDS, gen, *row, gamma=gamma, live_rounds=live, eager=eager)

    if not eager:
        chunk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / SPEC_ROUNDS
    what = f"{'eager' if eager else 'graph'} speculative rounds, gamma {gamma}"
    win = traced(what, chunk)
    res = summarize_profile(win["prof"], win["wall_ms"], SPEC_ROUNDS, what, "round")
    res["launches_per_round"] = {k: v / SPEC_ROUNDS for k, v in win["launches"].items() if v}
    res["traced_per_round"] = {k: v / SPEC_ROUNDS for k, v in win["traced"].items() if v}
    res["wall_ms_per_round_unprofiled"] = plain_ms
    res["device_busy_share_unprofiled"] = res["device_busy_ms_per_step"] / plain_ms
    log(f"      without the profiler: {plain_ms:.2f} ms/round wall, busy share "
        f"{res['device_busy_share_unprofiled']:.3f} (the profiled busy time over it)")
    log(f"      launches a round {res['launches_per_round']}, equal to the device trace {res['traced_per_round']}")
    return res


def serve_spec(model, draft, prompts: list, gamma: int, eager: bool) -> dict:
    """The 4 prompts through ``SpeculativeScheduler`` (4 slots, 4 rounds a chunk, bf16
    cache, greedy, 32 new tokens) after a warm-up (a row for the round's capture, whose seconds
    are kept, and one prompt of each timed prompt's length, whose admissions capture the
    buckets' graphs); counts reset just before, timed on the host clock, TTFT from each row's
    stream."""
    import torch

    from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
    from llama_x_tpu_torch.models import decode_graph as dg
    from llama_x_tpu_torch.serve.speculative import SpeculativeScheduler

    sched = SpeculativeScheduler(model, draft, gamma=gamma, n_slots=4, chunk_size=4, cache_dtype=torch.bfloat16,
                                 seed=0, eager=eager)
    captures0 = dg.stats(model)["captures"]
    try:
        for n in [40] + [len(p) for p in prompts]:
            warm = sched.submit(byte_prompt(ByteTokenizer(), 98, n), max_tokens=4)
            if not warm.event.wait(600) or warm.error is not None:
                raise AssertionError(f"warm-up failed: {warm.error}")
        torch.cuda.synchronize()
        live0, rounds0 = int(sched.live_row_rounds), sched.rounds_run
        g0, a0 = dg.stats(model), sched.inputs.runner.stats()
        reset_counts()
        lines = [_Timeline() for _ in prompts]
        t0 = time.perf_counter()
        handles = [sched.submit(p, max_tokens=32, stream_q=tl) for p, tl in zip(prompts, lines)]
        for h in handles:
            if not h.event.wait(900) or h.error is not None:
                raise AssertionError(f"a request failed: {h.error}")
        wall = time.perf_counter() - t0
        counts = read_counts()
        live = int(sched.live_row_rounds) - live0
        g1, a1 = dg.stats(model), sched.inputs.runner.stats()
    finally:
        sched.close()
    rounds = sched.rounds_run - rounds0
    total = sum(len(h.tokens) for h in handles)
    per_pass = (total - len(handles)) / max(live, 1)
    replays = g1["replays"] - g0["replays"]
    if not eager and replays + g1["captures"] - g0["captures"] < rounds:
        raise AssertionError(f"{rounds} rounds but {replays} replays: a round ran outside the graph")
    return dict(gamma=gamma, eager=eager, tokens=[h.tokens for h in handles], new_tokens=total, wall_s=wall,
                tokens_per_s=total / wall, rounds=rounds, replays=replays, live_row_rounds=live,
                tokens_per_verify=per_pass, acceptance_rate=(per_pass - 1) / gamma, launches=counts,
                captures=g1["captures"], capture_s=g1["capture_s"][captures0:],
                admission_captures_in_timed=a1["captures"] - a0["captures"],
                admission_replays=a1["replays"] - a0["replays"], **latency_stats(lines))


def phase_speculative(model) -> dict:
    """Speculative continuous batching at 8B width: the int8 target with a bf16 cache and
    the cheap draft of tools/bench_spec_continuous_8b.py (4 layers, width 1024, heads of
    128, the target's vocabulary; untrained, so acceptance is near its floor); 4 requests
    of 200 to 900 tokens, 32 new tokens, greedy, at gamma 4 (verify of 5 rows: K3) and
    gamma 8 (9 rows: K2's offsets form). Each gamma through ``spec_chunk``'s captured round
    (every round a replay), then through ``eager=True``: tok/s of each, the tokens equal bit
    for bit, the graph's rows against plain greedy under the near-tie rule; then a round's
    wall and device busy time, graph and eager (``profile_spec_rounds``). Last,
    ``generate_speculative`` at gamma 8 over the int8 cache on the 4 prompts
    (``drive_speculative``)."""
    import torch

    from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model
    from llama_x_tpu_torch.models import llama

    tok = ByteTokenizer()
    draft = build_model(llama.LlamaConfig(**{**GEOMETRIES["8b"], **SPEC_DRAFT}, max_seq_len=4096), False, 7, "cuda")
    prompts = [byte_prompt(tok, 200 + i, n) for i, n in enumerate((200, 400, 600, 900))]
    plain = [unbatched_generate(model, p, 32, torch.bfloat16) for p in prompts]  # plain greedy, for both gammas
    runs = {}
    last = [time.perf_counter()]

    def lap() -> str:
        """The seconds since the last lap, for the log: where the phase's time goes."""
        now = time.perf_counter()
        took, last[0] = now - last[0], now
        return f"[{took:.1f} s]"

    for gamma in (4, 8):
        log(f"[speculative serving] 8B int8 target ({model.config.num_layers} layers), bf16 cache, 4-layer draft of "
            f"width 1024; gamma {gamma}, 4 slots, 4 rounds a chunk; the captured round, then eager=True")
        res = serve_spec(model, draft, prompts, gamma, eager=False)
        res["seconds"] = lap()
        eager = serve_spec(model, draft, prompts, gamma, eager=True)
        eager["seconds"] = lap()
        need = ["int8_mm_dequant_nt", "flash_attention", "decode_attention"]
        for r in (res, eager):
            need_launches(r["launches"], need + (["flash_attention_offsets"] if gamma >= 8 else []),
                          f"speculative gamma {gamma}{' (eager)' if r['eager'] else ''}")
        if res["tokens"] != eager["tokens"]:
            raise AssertionError(f"gamma {gamma}: the captured rounds' tokens differ from the eager rounds'")
        checks = [check_served_row(model, p, t, torch.bfloat16, ref) for p, t, ref in zip(prompts, res["tokens"], plain)]
        res["rows"] = checks
        res["near_tie_divergences"] = sum(c["diverged_at"] is not None for c in checks)
        log(f"    graph: {res['new_tokens']} tokens in {res['wall_s']:.2f} s ({res['tokens_per_s']:.1f} tok/s), "
            f"{res['rounds']} rounds, {res['replays']} replays; capture + instantiate "
            f"{', '.join(f'{t:.3f}' for t in res['capture_s'])} s; "
            f"{res['tokens_per_verify']:.3f} tokens a verify pass, acceptance rate {res['acceptance_rate']:.4f}; "
            f"launches {res['launches']} {res['seconds']}")
        log(f"    eager: {eager['new_tokens']} tokens in {eager['wall_s']:.2f} s ({eager['tokens_per_s']:.1f} tok/s), "
            f"{eager['rounds']} rounds; tokens equal to the graph's bit for bit; launches {eager['launches']} "
            f"{eager['seconds']}")
        if res["admission_replays"] != len(prompts) or res["admission_captures_in_timed"]:
            raise AssertionError(f"gamma {gamma}: {res['admission_replays']} admission replays for {len(prompts)} "
                                 f"rows, {res['admission_captures_in_timed']} captured in the timed window")
        log(f"    TTFT p50 / p99 ms: graph {res['ttft_ms_p50']:.1f} / {res['ttft_ms_p99']:.1f} (spec_admit_row a "
            f"replay of its bucket's graph: {res['admission_replays']} replays, "
            f"{res['admission_captures_in_timed']} captured in the timed window), eager {eager['ttft_ms_p50']:.1f} / "
            f"{eager['ttft_ms_p99']:.1f}")
        log(f"    against plain greedy (an unbatched generate of each prompt): {4 - res['near_tie_divergences']} rows "
            f"equal, {res['near_tie_divergences']} part at a near-tie; every row greedy step by step (tokens off the "
            f"argmax within the tolerance: {sum(c['off_argmax'] for c in checks)}) {lap()}")
        res["round_profile"] = profile_spec_rounds(model, draft, prompts, gamma, eager=False)
        log(f"      {lap()}")
        res["eager_round_profile"] = profile_spec_rounds(model, draft, prompts, gamma, eager=True)
        log(f"      {lap()}")
        res["eager"] = {k: v for k, v in eager.items() if k != "tokens"}
        del res["tokens"]
        runs[f"speculative_g{gamma}"] = res
    P = max(map(len, prompts))
    ids = torch.zeros(len(prompts), P, dtype=torch.long)
    for i, p in enumerate(prompts):
        ids[i, : len(p)] = torch.tensor(p)
    log(f"[speculative decoding] generate_speculative on the same target ({model.config.num_layers} layers) and draft, "
        f"int8 cache, the 4 prompts ragged (P {P}), +{SPEC_NEW_TOKENS} tokens, gamma 8: the verify on K2's offsets "
        "form over the int8 cache's static kv bound; the captured round, then eager=True")
    runs["speculative_gen_g8"] = drive_speculative(model, draft, ids.cuda(), torch.tensor(list(map(len, prompts)),
                                                                                          device="cuda"), gamma=8)
    log(f"      {lap()}")
    del draft
    torch.cuda.empty_cache()
    return runs


def check_export(cut, tmp: str) -> dict:
    """The HF round trip of ``cut`` through a training run: saved as a run under ``tmp``
    (``save_model_config`` + ``save_checkpoint``), exported by ``export_checkpoint`` as a user
    calls it (no ``--device``: ``restore_model`` and ``save_llama_hf`` on the card), its
    ``model.safetensors`` read back through ``load_llama``: every tensor bit for bit, and greedy
    tokens (2 rows of 32, 16 new) equal to the cut's own. -> timings, size and the HF directory"""
    import torch

    from llama_x_tpu_torch import export_checkpoint
    from llama_x_tpu_torch.models import hf
    from llama_x_tpu_torch.models.generate import generate
    from llama_x_tpu_torch.train.checkpoint import save_checkpoint
    from llama_x_tpu_torch.train.cli import save_model_config
    from llama_x_tpu_torch.train.optim import AdamW
    from llama_x_tpu_torch.train.trainer import TrainState

    run = Path(tmp) / "run"
    run.mkdir()
    t0 = time.perf_counter()
    save_model_config(run, cut.config)
    save_checkpoint(run, TrainState(cut, AdamW([], 0.0)), 0)
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        out = Path(export_checkpoint.main([str(run), str(Path(tmp) / "hf")]))
    export_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in out.iterdir())
    t0 = time.perf_counter()
    back = hf.load_llama(out, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    ours, theirs = cut.state_dict(), back.state_dict()
    if set(ours) != set(theirs) or not all(torch.equal(ours[k], theirs[k]) for k in ours):
        raise AssertionError("the HF round trip through export_checkpoint changed a tensor")
    del ours, theirs
    g = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, 256, (2, 32), device="cuda", generator=g)
    want, got = (generate(m, prompt, max_new_tokens=16) for m in (cut, back))
    if not torch.equal(got, want):
        raise AssertionError("the exported model's greedy tokens differ from the run's model's")
    files = sorted(f.name for f in out.iterdir())
    del back
    torch.cuda.empty_cache()
    log(f"    {said.getvalue().strip().splitlines()[-1]}; run saved in {run_s:.1f} s, exported in {export_s:.1f} s "
        f"({size / 1e9:.3f} GB: {files}), read back in {load_s:.1f} s; every tensor bit for bit, and 2 x 16 greedy "
        "tokens equal to the run's model")
    return dict(out=str(out), gb=size / 1e9, run_save_s=run_s, export_s=export_s, load_s=load_s, files=files)


def phase_hf_and_http(model) -> dict:
    """The HF round trip of a 2-layer cut at 8B width (bf16, about 3 GB) through a training run
    and ``export_checkpoint`` (``check_export``: every tensor back bit for bit, greedy tokens
    equal), ``generate_cli --model`` on it, then ``serve_http`` in-process on
    127.0.0.1:0 over the int8 model (``Engine(_preloaded=...)``, continuous batching of 4
    slots, chunked prefill of 512, int8 KV): 4 concurrent /v1/completions and one streamed
    /v1/chat/completions with the byte tokenizer, each answer with a finish_reason and its
    tokens a second serving's (near-tie rule)."""
    import tempfile
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from llama_x_tpu_torch import generate_cli, serve_http
    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model
    from llama_x_tpu_torch.models import llama

    runs = {}
    log("[HF round trip] a 2-layer cut at 8B width (bf16) saved as a training run, exported by export_checkpoint with "
        "its default device (the card), load_llama back; generate_cli --model on the export")
    cut = build_model(llama.LlamaConfig(**{**GEOMETRIES["8b"], "num_layers": 2}, max_seq_len=4096), False, 3, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        exported = check_export(cut, tmp)
        tr = traced("generate_cli --model", lambda: generate_cli.main([
            "--model", exported["out"], "--device", "cuda", "--prompt", "The capital of France is", "--prompt",
            "Speculative decoding drafts", "--max_new_tokens", "16", "--no_eos"]))
        counts = tr["launches"]
    need_launches(counts, ["flash_attention", "decode_attention"], "generate_cli --model")
    runs["hf_cli"] = dict(exported, launches=counts, traced=tr["traced"])
    del cut
    torch.cuda.empty_cache()

    log(f"[HTTP server] serve_http in-process on 127.0.0.1:0: Engine(_preloaded=the 8B int8 model, {model.config.num_layers} layers), --continuous 4 "
        "--prefill_chunk 512 --kv_dtype int8; 4 concurrent /v1/completions, one streamed /v1/chat/completions")
    args = serve_http.build_parser().parse_args(["--geometry", "8b", "--tokenizer", "byte", "--continuous", "4",
                                                 "--prefill_chunk", "512", "--decode_chunk", "16", "--kv_dtype", "int8",
                                                 "--batch_window_ms", "0"])
    engine = serve_http.Engine(args, _preloaded=model)
    served = []  # (prompt ids, handle) of every row the HTTP requests gave the scheduler
    submit = engine.sched.submit

    def recording_submit(ids, *a, **kw):
        h = submit(ids, *a, **kw)
        served.append((list(ids), h))
        return h

    engine.sched.submit = recording_submit
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve_http.make_handler(engine))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def post(payload, path="/v1/completions"):
        req = urllib.request.Request(base + path, json.dumps(payload).encode(), {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.read().decode()

    texts = [("Hello from the card. " * (n // 21 + 1))[:n] for n in (60, 250, 500, 800)]
    answers = {}
    try:
        warm = json.loads(post({"prompt": "warm-up", "max_tokens": 4}))

        def five_answers() -> str:
            served.clear()
            answers.clear()
            threads = [threading.Thread(target=lambda i=i: answers.__setitem__(i, json.loads(post(
                {"prompt": texts[i], "max_tokens": 24})))) for i in range(4)]
            for t in threads:
                t.start()
            chat = post({"messages": [{"role": "user", "content": "Say something about Hopper."}], "max_tokens": 24,
                         "stream": True}, "/v1/chat/completions")
            for t in threads:
                t.join()
            return chat

        tr = traced("the HTTP server", five_answers)  # the engine's decode steps are graph replays
        chat, counts, wall = tr["result"], tr["launches"], tr["wall_ms"] / 1e3
        events = [json.loads(line[6:]) for line in chat.splitlines() if line.startswith("data: ") and line != "data: [DONE]"]
        if not chat.rstrip().endswith("data: [DONE]") or "finish_reason" not in events[-1]["choices"][0]:
            raise AssertionError(f"the streamed chat answer is incomplete: {chat[-300:]}")
        for i, a in answers.items():
            if a["choices"][0].get("finish_reason") not in ("stop", "length"):
                raise AssertionError(f"answer {i} has no finish_reason: {a}")
        # each row again through the scheduler alone: the same tokens, up to near-ties
        agains = [submit(ids, max_tokens=h.max_tokens, sampling=h.sampling, eos_id=h.eos_id) for ids, h in served]
        for again in agains:
            if not again.event.wait(600) or again.error is not None:
                raise AssertionError(f"the second serving failed: {again.error}")
        checks = [check_served_row(model, ids, h.tokens, torch.int8, again.tokens)
                  for (ids, h), again in zip(served, agains)]
        by_prompt = {tuple(ids): h for ids, h in served}
        for i, a in answers.items():
            h = by_prompt[tuple(engine.tok(texts[i], add_bos=True))]
            kept = [t for t in h.tokens if t not in (engine.tok.pad_id, engine.tok.eos_id)]
            if a["choices"][0]["text"] != engine.tok.decode(kept):
                raise AssertionError(f"answer {i}'s text is not its row's tokens")
    finally:
        server.shutdown()
        server.server_close()
        engine.sched.close()
    need_launches(counts, ["int8_mm_dequant_nt", "flash_attention", "flash_attention_offsets", "decode_attention_int8"],
                  "the HTTP server")
    streamed = "".join(c["delta"].get("content", "") for e in events for c in e["choices"])
    runs["http"] = dict(requests=5, wall_s=wall, launches=counts, traced=tr["traced"], rows=checks, warm=warm["choices"][0]["finish_reason"],
                        near_tie_divergences=sum(c["diverged_at"] is not None for c in checks),
                        finish_reasons=[answers[i]["choices"][0]["finish_reason"] for i in range(4)]
                        + [events[-1]["choices"][0]["finish_reason"]])
    log(f"    5 answers in {wall:.2f} s, finish reasons {runs['http']['finish_reasons']}; streamed chat text "
        f"{len(streamed)} characters; rows equal to a second serving but at "
        f"{runs['http']['near_tie_divergences']} near-ties; launches {counts}, equal to the device trace {tr['traced']}")
    return runs


# ---------------------------------------------------------------------------
# phases 5 and 6: the training main path at 8B width, and its kernel path against the plain path
# ---------------------------------------------------------------------------

TRAIN_FLAGS = [
    "--synthetic", "24", "--synthetic_task", "count", "--geometry", "8b", "--quantize", "int8",
    "--quantize_kwargs", '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}',
    "--adapter", "lora", "--adapter_kwargs", '{"rank": 8}', "--freeze_prefixes", "tok_embeddings", "output", "norm",
    "--activation_checkpointing", "--fused_ce_chunks", "8", "--document_mask", "--max_seq_len", "4096",
    "--batch_size", "2", "--gradient_accumulation", "2", "--optim", "AdamW", "--lr", "1e-3", "--n_steps", "4",
    "--seed", "0",
]
TRAIN_KERNELS = ["int8_mm_dequant_nt", "int8_mm_dequant", "flash_attention", "flash_attention_bwd"]


def base_checksums(model) -> list[int]:
    """One wrap-around 64-bit sum per int8 base tensor (any write to it changes the sum)."""
    import torch

    return [int(b.view(torch.int64).sum()) for n, b in model.named_buffers() if n.endswith("int_data")]


@contextlib.contextmanager
def graph_census():
    """{"graph": steps taken through the runner's captured graphs (a capture's eager first
    step counted here too), "eager": steps that asked for the eager step} over every
    ``make_train_step`` inside the block: the entry points' loops show which they ran."""
    from llama_x_tpu_torch.train import step_graph

    counts = {"graph": 0, "eager": 0}
    inner = step_graph.run

    def run(*args, eager, **kwargs):
        counts["eager" if eager else "graph"] += 1
        return inner(*args, eager=eager, **kwargs)

    step_graph.run = run
    try:
        yield counts
    finally:
        step_graph.run = inner


def need_graph_steps(census: dict, what: str) -> None:
    if census["eager"] or not census["graph"]:
        raise AssertionError(f"{what}: every train step must replay captured graphs, got {census}")


def graph_note(state, before: dict) -> dict:
    """What the step just taken added to ``state``'s graph runner: a capture's eager first
    step and capture + instantiate seconds and the pool it added, or {} (a replay)."""
    from llama_x_tpu_torch.train import step_graph

    s = step_graph.stats(state)
    if s["captures"] == before["captures"]:
        return {}
    return dict(warmup_s=s["warmup_s"][-1], capture_s=s["capture_s"][-1], pool_mb=s["pool_bytes"][-1] / 2**20)


def traced_steps(train_step, state, batch, n: int, expect: dict, what: str) -> dict:
    """``n`` replays of the captured step under the profiler (CPU and CUDA activity): their
    launches, the replays' credits, held to ``expect`` a step and to the device trace of the
    window (``traced``); wall and device busy a step."""
    win = traced(what, lambda: [train_step(state, batch) for _ in range(n)], cpu=True)
    res = summarize_profile(win["prof"], win["wall_ms"], n, what, "step")
    wrong = {k: (win["launches"][k], v * n) for k, v in expect.items() if win["launches"][k] != v * n}
    if wrong:
        raise AssertionError(f"{what}: launches of {n} replays (got, expected): {wrong}")
    res["launches_per_step"] = {k: v // n for k, v in win["launches"].items() if v}
    res["traced_per_step"] = {k: v // n for k, v in win["traced"].items() if v}
    log(f"      launches a step {res['launches_per_step']}, equal to the device trace {res['traced_per_step']}")
    return res


def eager_profile(loss_fn, state, batch, what: str) -> dict:
    """One step launched op by op (``eager=True``, the reference) on the same state and
    buffers under the profiler, the rowwise quantizer's calls bracketed: wall, device busy, the
    quantizer's device time, and the step's peak allocated and reserved memory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llama_x_tpu_torch.train.trainer import make_train_step

    step = make_train_step(loss_fn, eager=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with labelled_quantizers(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rec = summarize_profile(prof, wall_ms, 1, what, "step")
    rec["abs_round_kernels"] = sum(bool(CHAIN_KERNELS.search(n)) for n in device_kernels(prof))
    q_ms, q_calls = label_device_ms(prof, QUANTIZE_LABEL)
    if "K7" in rec["groups_ms_per_step"]:  # K7's ctypes launches are not tied to the ranges: its kernels' time
        q_ms = (q_ms or 0.0) + rec["groups_ms_per_step"]["K7"]
    rec["quantize_int8_rowwise_ms_per_step"], rec["quantize_int8_rowwise_calls_per_step"] = q_ms, q_calls
    rec["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    log(f"      rowwise quantizer: {q_calls} calls/step, device "
        + ("not measured (the trace ties no device time to its ranges)" if q_ms is None else
           f"{q_ms:.3f} ms/step, {q_ms / rec['device_busy_ms_per_step']:.3f} of busy")
        + f"; eager peak {rec['peak_allocated_gb']:.2f} GB allocated, {rec['peak_reserved_gb']:.2f} GB reserved")
    return rec


def graph_memory() -> tuple[float, float]:
    """(GB allocated at most since the last reset of the peak, GB reserved once the allocator's
    cache is emptied): taken after replays, what a replayed step holds, its pool included (the
    pool's blocks count as allocated)."""
    import torch

    torch.cuda.empty_cache()
    return torch.cuda.max_memory_allocated() / 1e9, torch.cuda.memory_reserved() / 1e9


def graph_against_eager(tag: str, state, steps: list, graph_prof: dict, eager_prof: dict, graph_mem: tuple) -> dict:
    """One line a cell: a step through the graph (replays unprofiled; profiled wall and busy)
    against the eager step (the capture's eager first step unprofiled; one eager step
    profiled), the capture, the pool and memory (``graph_memory`` after the replays; the eager
    step's peaks, taken beside the graphs' pool)."""
    import torch

    from llama_x_tpu_torch.train import step_graph

    s = step_graph.stats(state)
    replays = [r["seconds"] * 1e3 for r in steps if "warmup_s" not in r]
    first = next(r for r in steps if "warmup_s" in r)
    g_busy = graph_prof["device_busy_ms_per_step"]
    rec = dict(graph_wall_ms=replays, graph_busy_ms=g_busy, graph_share=g_busy / min(replays),
               graph_profiled_wall_ms=graph_prof["wall_ms_per_step"], eager_wall_ms=first["warmup_s"] * 1e3,
               eager_profiled_wall_ms=eager_prof["wall_ms_per_step"],
               eager_busy_ms=eager_prof["device_busy_ms_per_step"],
               eager_share=eager_prof["device_busy_ms_per_step"] / (first["warmup_s"] * 1e3),
               capture_s=first["capture_s"], pool_mb=sum(s["pool_bytes"]) / 2**20, graph_allocated_gb=graph_mem[0],
               graph_reserved_gb=graph_mem[1], eager_peak_allocated_gb=eager_prof["peak_allocated_gb"],
               eager_peak_reserved_gb=eager_prof["peak_reserved_gb"], buffer_mb=s["buffer_bytes"] / 2**20)
    log(f"    GRAPH vs EAGER {tag}: graph {min(replays):.1f}-{max(replays):.1f} ms/step unprofiled at "
        f"{g_busy:.2f} busy (share {rec['graph_share']:.3f}; profiled {rec['graph_profiled_wall_ms']:.1f}); eager "
        f"{rec['eager_wall_ms']:.1f} ms (the capture's first step) at {rec['eager_busy_ms']:.2f} busy (share "
        f"{rec['eager_share']:.3f}; profiled {rec['eager_profiled_wall_ms']:.1f}); capture + instantiate "
        f"{rec['capture_s']:.3f} s, pool {rec['pool_mb']:.1f} MB, buffers {rec['buffer_mb']:.1f} MB; replays hold "
        f"{graph_mem[0]:.2f} GB allocated, {graph_mem[1]:.2f} GB reserved; the eager step's peak "
        f"{rec['eager_peak_allocated_gb']:.2f} GB allocated, {rec['eager_peak_reserved_gb']:.2f} GB reserved (beside "
        "the pool)")
    return rec


def phase_train_graph() -> dict:
    """The text step at Llama-3.1-8B width cut to 2 layers: 4 steps through the captured
    graphs against 4 eager steps from the same weights on the same 4 step batches (S 4096,
    accumulation 2): loss, grad norm, label count and every trainable tensor bit for bit, the
    launches of each step equal (the graph steps' launches are this phase's)."""
    import torch

    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.train import cli
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    log("[train graph against eager] the text step at 8B width cut to 2 layers, 4 steps through the graphs and 4 "
        "eager from the same weights and batches")
    args = entry.parse_args(TRAIN_FLAGS + ["--synthetic_config", '{"num_layers": 2}'])
    states = []
    for _ in range(2):
        model = cli.build_model_params(args, max_seq_len=args.max_seq_len)
        states.append(TrainState(model, cli.setup_optimizer(args, model)[0]))
    data_iter, _ = entry.make_data(args, states[0].model.config.vocab_size)
    accum = args.gradient_accumulation
    batches = [cli.assemble_step_batch([next(data_iter) for _ in range(accum)], pad_values={"labels": -100})
               for _ in range(4)]
    steps = (make_train_step(entry.loss_fn), make_train_step(entry.loss_fn, eager=True))
    losses, launches = [], {k: 0 for k in counted()}
    for i, batch in enumerate(batches):
        got = []
        for state, step in zip(states, steps):
            reset_counts()
            m = step(state, batch)
            torch.cuda.synchronize()
            got.append((m, read_counts()))
        (mg, lg), (me, le) = got
        differ = [k for k in me if not torch.equal(mg[k], me[k])]
        if differ or lg != le:
            raise AssertionError(f"step {i}: graph {({k: float(v) for k, v in mg.items()})} against eager "
                                 f"{({k: float(v) for k, v in me.items()})}, launches {lg} against {le}")
        losses.append(float(mg["loss"]))
        for k, v in lg.items():
            launches[k] += v
    moved = [n for (n, a), (_, b) in zip(*(s.trainable for s in states)) if not torch.equal(a, b)]
    if moved:
        raise AssertionError(f"the adapters parted between graph and eager: {moved[:4]}")
    log(f"    4 steps bit for bit (losses {losses}), {len(states[0].trainable)} trainable tensors equal, launches "
        f"equal every step")
    return dict(losses=losses, trainable_tensors=len(states[0].trainable), launches=launches)


def phase_train() -> dict:
    """The trainer's own pieces, put together as ``train_metamathqa.main`` puts them,
    from the command line a user would give; one step batch is repeated so that the loss
    must fall. Each step replays the captured graphs (the first: the eager step, then the
    capture), and an eager step on the same state is profiled beside them."""
    import torch

    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.train import cli
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    log("[training main path] Llama-3.1-8B width, 32 layers, int8 base + LoRA r 8, int8 act / dgrad / head, "
        "fused CE x8, checkpointing 'full', packed S 4096, microbatch 1 x accumulation 2, AdamW; each step "
        "replays captured CUDA graphs")
    args = entry.parse_args(TRAIN_FLAGS)
    t0 = time.perf_counter()
    model = cli.build_model_params(args, max_seq_len=args.max_seq_len)
    torch.cuda.synchronize()
    log(f"    weights built on the card from seed 0 in {time.perf_counter() - t0:.1f} s; config {model.config}")
    optimizer, _ = cli.setup_optimizer(args, model)
    state = TrainState(model, optimizer)
    train_step = make_train_step(entry.loss_fn)

    accum = args.gradient_accumulation
    data_iter, _ = entry.make_data(args, model.config.vocab_size)
    batch = cli.assemble_step_batch([next(data_iter) for _ in range(accum)], pad_values={"labels": -100})
    positions = int(batch["inputs"].size)
    log(f"    step batch {tuple(batch['inputs'].shape)}, {int((batch['labels'] != -100).sum())} label tokens, "
        f"{int(batch['segment_ids'].max())} documents in the fullest row")

    sums = base_checksums(model)
    first = model.layers[0].feed_forward.w1
    base0, lora_a0, lora_b0 = first.int_data.clone(), first.lora_a.detach().clone(), first.lora_b.detach().clone()

    L, C = model.config.num_layers, model.config.fused_ce_chunks
    expect = {k: v * accum for k, v in expected_launches("full", L, C).items()}
    torch.cuda.reset_peak_memory_stats()
    steps = timed_steps(train_step, state, batch, args.n_steps, positions, expect)
    for r in steps:
        r["label_tokens_per_s"] = r["n_tokens"] / r["seconds"]
    counts = {k: sum(r["launches"][k] for r in steps) for k in steps[0]["launches"]}
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"    launches over {args.n_steps} steps {counts}; peak memory {peak:.2f} GB allocated (the eager first step's)")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"the loss did not fall: {[r['loss'] for r in steps]}")
    if base_checksums(model) != sums or not torch.equal(first.int_data, base0):
        raise AssertionError("the int8 base changed during training")
    if torch.equal(first.lora_a, lora_a0) or torch.equal(first.lora_b, lora_b0):
        raise AssertionError("the adapter tensors did not move")

    torch.cuda.reset_peak_memory_stats()
    graph_prof = traced_steps(train_step, state, batch, 2, expect, "training (graph replays)")
    graph_mem = graph_memory()
    prof_rec = eager_profile(entry.loss_fn, state, batch, "training (eager)")
    with plain_quantizer():
        chain_rec = eager_profile(entry.loss_fn, state, batch, "training (eager, the plain quantizer chain)")
    prof_rec["quantize_int8_rowwise_ms_per_step_plain_chain"] = chain_rec["quantize_int8_rowwise_ms_per_step"]
    prof_rec["abs_round_kernels_plain_chain"] = chain_rec["abs_round_kernels"]
    calls = chain_rec["quantize_int8_rowwise_calls_per_step"]
    log(f"      rowwise quantizer a step ({calls} calls), plain chain against K7: "
        f"{chain_rec['quantize_int8_rowwise_ms_per_step']} against {prof_rec['quantize_int8_rowwise_ms_per_step']} ms of "
        f"device time; abs / round kernels {chain_rec['abs_round_kernels']} against {prof_rec['abs_round_kernels']} "
        f"(logsumexp's abs a CE chunk)")
    if chain_rec["abs_round_kernels"] - prof_rec["abs_round_kernels"] != 2 * calls:
        raise AssertionError("the step through K7 still launched abs / round kernels of the quantizer's chain")
    vs = graph_against_eager("text", state, steps, graph_prof, prof_rec, graph_mem)
    two_path = compare_train_paths(model, batch)
    return dict(flags=TRAIN_FLAGS, steps=steps, launches=counts, launches_per_step={k: v // args.n_steps for k, v in counts.items()},
                peak_mem_gb=peak, profile=prof_rec, graph_profile=graph_prof, graph_vs_eager=vs, two_path=two_path)


def compare_train_paths(model, batch) -> dict:
    """Loss and adapter gradients of one microbatch on a 2-layer cut of the trained
    weights (lora_b is no longer zero, so every adapter gradient is live), through the
    kernels and through their plain versions."""
    import torch

    from llama_x_tpu_torch import train_metamathqa as entry

    mb = {k: torch.as_tensor(v[0]).cuda() for k, v in batch.items()}
    return compare_grad_paths(cut_of(model), lambda m: entry.loss_fn(m, mb)[0], "training")


def compare_grad_paths(cut, loss_of, tag: str) -> dict:
    """Kernel path against plain path for ``loss_of(cut)`` and its adapter gradients.

    K1 and K4 equal their plain versions bit for bit, so the two paths part only at
    the flash kernels, whose bf16 outputs lie an ulp apart here and there; downstream a
    few activations and gradients then round to the neighbouring int8 code (1/127 of a
    row's largest entry). Loss within 2^-10 of its size (a quarter of a bf16 ulp of the
    bf16 hidden states it is computed from); each adapter gradient tensor within 2^-6 of
    its norm in the L2 sense (the flash backward's own per-element tolerance is 2^-7),
    which a wrong mask, a lost ln2, a dropped group member or a dropout mask that differs
    between the two paths would miss by a factor."""
    import torch

    named = [(n, p) for n, p in cut.named_parameters() if p.requires_grad and "lora_" in n]
    params = [p for _, p in named]

    def run():
        loss = loss_of(cut)
        return float(loss.detach()), torch.autograd.grad(loss, params)

    reset_counts()
    loss_k, grads_k = run()
    if any(read_counts()[k] == 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"the kernel path skipped a kernel: {read_counts()}")
    reset_counts()
    with plain_path():
        loss_p, grads_p = run()
    if any(read_counts().values()):
        raise AssertionError(f"the plain path launched kernels: {read_counts()}")
    tol = 2**-10 * abs(loss_p)
    check(f"{tag} 2-layer loss, kernels {loss_k:.5f} vs plain {loss_p:.5f}", abs(loss_k - loss_p), tol)
    worst, worst_name = 0.0, ""
    for (name, _), a, b in zip(named, grads_k, grads_p):
        rel = float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    check(f"{tag} 2-layer adapter gradients ({len(named)} tensors), worst relative L2 error ({worst_name})",
          worst, 2**-6)
    return dict(loss_kernels=loss_k, loss_plain=loss_p, loss_tol=tol, grad_rel_l2_worst=worst, grad_rel_l2_tol=2**-6)


# ---------------------------------------------------------------------------
# phases 7 to 9: the probe entry point, the audio main path (the repository's headline
# step) and its kernel path against the plain path with dropout
# ---------------------------------------------------------------------------


def phase_probe() -> dict:
    """``python -m llama_x_tpu_torch.probe_flash`` as a user runs it: K2, K2 + K5 and K6
    at the audio step's attention shape."""
    from llama_x_tpu_torch import probe_flash as entry

    log("[probe entry point] B 1, S 4096, 32/8 heads, D 128, prefix-LM 2000, plan bq 256 bk 1024")
    reset_counts()
    res = entry.run(entry.parse_args([]))
    counts = read_counts()
    for name in ("flash_probe", "flash_attention", "flash_attention_bwd"):
        if counts[name] == 0:
            raise AssertionError(f"the probe entry point never launched {name}: {counts}")
    res["launches"] = counts
    return res


SWEEP_LAYERS = 4  # the audio phase's policy sweep runs on the first 4 layers (a depth cut)
AUDIO_FLAGS = [
    "--synthetic", "8", "--geometry", "8b", "--quantize", "int8",
    "--quantize_kwargs", '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}',
    "--adapter", "lora", "--adapter_kwargs", '{"rank": 8}',
    "--freeze_prefixes", "tok_embeddings", "output", "norm", "audio_embed",
    "--activation_checkpointing", "--remat_policy", "flash_q8s", "--fused_ce_chunks", "8", "--prefix_lm",
    "--audio_duration", "40", "--seq_len_multiple", "2096", "--batch_size", "1", "--gradient_accumulation", "1",
    "--optim", "AdamW", "--lr", "1e-4", "--n_steps", "4", "--seed", "0",
]


def expected_launches(policy: str, layers: int, ce_chunks: int) -> dict:
    """Launches of one microbatch of the QLoRA step (every projection int8 with int8
    activations and input gradients, int8 head) under a remat policy.

    K1 (NT GEMM): the forward runs the 7 projections of every layer and the fused CE one
    logits GEMM per chunk, and the CE backward recomputes each chunk's logits: 7 L + 2 C
    under every policy. Then the recompute: "full" runs all 7 again (7 L); "flash_proj"
    keeps q/k/v, wo and w2 and reruns w1 and w3 (2 L); "flash_q8s" reruns the attention
    half's wq, wk, wv and wo (only the flash output is kept there: 4 L), and its MLP,
    outside the checkpoint, reruns nothing but one w3 GEMM for the h3 it did not keep
    (1 L): 5 L, fewer than "full" by the w1 and w2 recomputes (2 L); without checkpointing
    ("none") nothing runs again; "attn_q8" keeps int8 q / k / v / out, h1 and h3 and reruns
    nothing (0), "attn_q8s" reruns only the w3 GEMM of its MLP (1 L): no GEMM of the
    attention runs in its backward.
    K4 (KN GEMM): one input gradient per projection and one dH per CE chunk: 7 L + C.
    K2: one forward per layer, and a second one in the recompute only under "full".
    K5: one backward per layer."""
    recompute = {"full": 7, "flash_proj": 2, "flash_q8s": 5, "attn_q8": 0, "attn_q8s": 1, "none": 0}[policy]
    return {"int8_mm_dequant_nt": (7 + recompute) * layers + 2 * ce_chunks,
            "int8_mm_dequant": 7 * layers + ce_chunks,
            "flash_attention": (2 if policy == "full" else 1) * layers,
            "flash_attention_bwd": layers}


def timed_steps(train_step, state, batch, n: int, positions: int, expect: dict | None) -> list[dict]:
    """n optimizer steps, each timed on the host clock around a synchronize, the launch
    counts of each held to ``expect``; a step that captured (the first of a key) gives its
    eager step's and its capture's seconds and the pool it added."""
    import torch

    from llama_x_tpu_torch.train import step_graph

    steps = []
    for i in range(n):
        reset_counts()
        before = step_graph.stats(state)
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        rec = dict(step=i, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), n_tokens=int(m["n_tokens"]),
                   seconds=dt, positions_per_s=positions / dt, launches=counts, **graph_note(state, before))
        steps.append(rec)
        how = (f"eager step {rec['warmup_s']:.3f} s, then capture + instantiate {rec['capture_s']:.3f} s, pool "
               f"+{rec['pool_mb']:.1f} MB" if "warmup_s" in rec else "replay")
        log(f"    step {i}: loss {rec['loss']:.4f}, grad norm {rec['grad_norm']:.4f}, {dt:.3f} s, "
            f"{rec['positions_per_s']:.0f} positions/s ({how})")
        if expect is not None:
            wrong = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
            if wrong:
                raise AssertionError(f"launches of step {i} (got, expected): {wrong}")
        if not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            raise AssertionError(f"non-finite loss or grad norm: {rec}")
    return steps


def phase_audio() -> dict:
    """The repository's headline step, put together from ``train_librispeech``'s own
    functions as its ``main`` puts them; one batch is repeated so that the loss must fall.
    Each step replays the captured graphs; an eager step is profiled beside them."""
    import numpy as np
    import torch

    from llama_x_tpu_torch import train_librispeech as entry
    from llama_x_tpu_torch.models.audio import AudioConfig
    from llama_x_tpu_torch.train import cli, step_graph
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    log("[audio main path] Llama-3.1-8B width, 32 layers, int8 base + LoRA r 8, int8 act / dgrad / head, fused CE x8, "
        "40 s of audio -> 2000 audio tokens + 2096 text tokens, prefix-LM, remat flash_q8s, microbatch 1, AdamW 1e-4")
    args = entry.parse_args(AUDIO_FLAGS)
    audio_config = AudioConfig()
    t0 = time.perf_counter()
    model = cli.build_model_params(args, max_seq_len=entry.MAX_SEQ_LEN, audio_config=audio_config)
    torch.cuda.synchronize()
    log(f"    weights built on the card from seed 0 in {time.perf_counter() - t0:.1f} s; config {model.config}")
    optimizer, _ = cli.setup_optimizer(args, model)
    state = TrainState(model, optimizer)
    loss_fn = entry.make_loss_fn(args.prefix_lm)
    train_step = make_train_step(loss_fn)
    data_iter = entry.synthetic_audio_batches(np.random.default_rng(args.seed), audio_config, 1, args.audio_duration,
                                              args.seq_len_multiple, model.config.vocab_size)
    batch = cli.assemble_step_batch([next(data_iter)], pad_values={"labels": -100})
    n_audio = audio_config.num_audio_tokens(batch["audio"].shape[-1])
    positions = n_audio + batch["tokens"].shape[-1]
    log(f"    step batch: audio {tuple(batch['audio'].shape)} -> {n_audio} audio tokens, text "
        f"{tuple(batch['tokens'].shape)}, {positions} positions")
    if (n_audio, positions) != (2000, 4096):
        raise AssertionError(f"the headline shape is 2000 + 2096 positions, got {n_audio} + {positions - n_audio}")

    L, C = model.config.num_layers, model.config.fused_ce_chunks
    sums = base_checksums(model)
    first = model.layers[0].feed_forward.w1
    lora_b0 = first.lora_b.detach().clone()
    stem0 = model.audio_embed.conv2.weight.detach().clone()
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    steps = timed_steps(train_step, state, batch, args.n_steps, positions, expected_launches("flash_q8s", L, C))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"    flash_q8s: launches per step {steps[-1]['launches']}; peak memory {peak:.2f} GB")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"the loss did not fall: {[r['loss'] for r in steps]}")
    if base_checksums(model) != sums or not torch.equal(model.audio_embed.conv2.weight, stem0):
        raise AssertionError("the frozen int8 base or the frozen stem changed during training")
    if torch.equal(first.lora_b, lora_b0):
        raise AssertionError("the adapter tensors did not move")
    launches = {k: sum(r["launches"][k] for r in steps) for k in steps[0]["launches"]}
    runs["flash_q8s"] = dict(steps=steps, peak_mem_gb=peak)

    torch.cuda.reset_peak_memory_stats()
    graph_prof = traced_steps(train_step, state, batch, 2, expected_launches("flash_q8s", L, C),
                              "audio training (flash_q8s, graph replays)")
    graph_mem = graph_memory()
    prof_rec = eager_profile(loss_fn, state, batch, "audio training (flash_q8s, eager)")
    vs = graph_against_eager("audio", state, steps, graph_prof, prof_rec, graph_mem)

    # the same step under the policy the text slice used, under the named-save policy that
    # keeps every D-wide projection output, without checkpointing at all, and under the
    # int8-residual attention: one line each, on the first SWEEP_LAYERS layers (a depth cut;
    # the state of its own starts where the schedule has run out, so the weights stand still
    # and every step does the same work). A policy is a key of the state's graphs: its first
    # step is the eager step and the capture, the next a replay, and one more replay is held
    # to a device trace. The graphs of the other policies keep their pool meanwhile; "none"
    # (no checkpointing) runs with the pool freed before and after it (step_graph.release),
    # as a run without checkpointing would hold only its own
    step_graph.release(state)
    sweep = cut_of(model, SWEEP_LAYERS)
    optimizer, _ = cli.setup_optimizer(args, sweep)
    optimizer.count.copy_(state.optimizer.count)  # the schedule's end: the learning rate 0
    state = TrainState(sweep, optimizer)
    train_step = make_train_step(loss_fn)
    L = SWEEP_LAYERS
    log(f"    the policies on the first {L} of the {model.config.num_layers} layers (a depth cut):")
    for policy in ("full", "flash_proj", "none", "flash_q8s", "attn_q8", "attn_q8s"):
        sweep.config = sweep.config.replace(activation_checkpointing=policy != "none",
                                            remat_policy="full" if policy == "none" else policy)
        if policy == "none":
            step_graph.release(state)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        log(f"    remat_policy={policy}:")
        psteps = timed_steps(train_step, state, batch, 2, positions, expected_launches(policy, L, C))
        ppeak = torch.cuda.max_memory_allocated() / 1e9
        ptrace = traced_steps(train_step, state, batch, 1, expected_launches(policy, L, C),
                              f"audio ({policy}, replay, {L} layers)")
        if policy == "none":
            step_graph.release(state)
        best = min(r["seconds"] for r in psteps[1:])
        runs[f"{policy} (second pass)" if policy == "flash_q8s" else policy] = dict(
            steps=psteps, peak_mem_gb=ppeak, graph_busy_ms=ptrace["device_busy_ms_per_step"])
        log(f"    POLICY {policy}: step {best:.3f} s (the replay after the eager first step), "
            f"{positions / best:.0f} positions/s, peak memory {ppeak:.2f} GB (the eager first step's), reserved "
            f"{torch.cuda.memory_reserved() / 1e9:.2f} GB, launches per step {psteps[-1]['launches']}")
        if policy.startswith("attn_q8"):
            for r in psteps:
                for k, v in r["launches"].items():
                    launches[k] += v
    q8 = {p: min(r["seconds"] for r in runs[p]["steps"][1:]) for p in ("flash_q8s (second pass)", "attn_q8", "attn_q8s")}
    log("    int8-residual attention against flash_q8s (best step, positions/s, peak): " + "; ".join(
        f"{p.split()[0]} {t:.3f} s, {positions / t:.0f}/s, {runs[p]['peak_mem_gb']:.2f} GB" for p, t in q8.items()))
    q8_prof = eager_profile(loss_fn, state, batch, f"audio training (attn_q8s, eager, {L} layers)")
    graph_stats = step_graph.stats(state)
    log(f"    the sweep state's graphs: {graph_stats}")
    step_graph.release(state)
    del state, sweep
    two_path = compare_audio_paths(model, batch)
    q8_two_path = compare_q8_audio_paths(model, batch)
    return dict(flags=AUDIO_FLAGS, launches=launches, runs=runs, profile=prof_rec, graph_profile=graph_prof,
                graph_vs_eager=vs, attn_q8s_profile=q8_prof, graph_stats=graph_stats, two_path=two_path,
                attn_q8s_two_path=q8_two_path)


def compare_audio_paths(model, batch) -> dict:
    """Kernel path against plain path on a 2-layer cut of the audio step, with attention
    dropout 0.1 and fixed per-layer seeds: both paths must build the same keep mask."""
    import torch

    from llama_x_tpu_torch.models import audio as audio_mod

    cut = cut_of(model, attn_dropout=DROPOUT_RATE, remat_policy="flash_q8s")
    mb = {k: torch.as_tensor(v[0]).cuda() for k, v in batch.items()}
    seeds = [DROPOUT_SEED, 12345]

    def loss_of(m, dropout_seeds=seeds):
        return audio_mod.forward(m, mb["audio"], mb["tokens"].long(), labels=mb["labels"], prefix_lm=True,
                                 dropout_seeds=dropout_seeds)

    res = compare_grad_paths(cut, loss_of, f"audio (prefix-LM, dropout {DROPOUT_RATE})")
    with torch.no_grad():
        no_drop = float(loss_of(cut, None))
    log(f"    the same cut without dropout seeds: loss {no_drop:.5f}")
    if no_drop == res["loss_kernels"]:
        raise AssertionError("dropout changed nothing")
    res["loss_without_dropout"] = no_drop
    return res


def compare_q8_audio_paths(model, batch) -> dict:
    """Kernel path against plain path on a 2-layer cut of the audio step under attn_q8s
    (no dropout: with dropout the policy falls back to flash_q8s)."""
    import torch

    from llama_x_tpu_torch.models import audio as audio_mod

    cut = cut_of(model, remat_policy="attn_q8s", activation_checkpointing=True)
    mb = {k: torch.as_tensor(v[0]).cuda() for k, v in batch.items()}

    def loss_of(m):
        return audio_mod.forward(m, mb["audio"], mb["tokens"].long(), labels=mb["labels"], prefix_lm=True)

    return compare_grad_paths(cut, loss_of, "audio (prefix-LM, attn_q8s)")


# ---------------------------------------------------------------------------
# phases 10 to 14: the vision and omni steps on one 8B trunk, the evaluations that
# decode from a modality prefix, the real-data host path and the new entry points
# ---------------------------------------------------------------------------

QLORA_FLAGS = [
    "--geometry", "8b", "--quantize", "int8",
    "--quantize_kwargs", '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}',
    "--adapter", "lora", "--adapter_kwargs", '{"rank": 8}', "--activation_checkpointing", "--prefix_lm",
    "--optim", "AdamW", "--lr", "1e-4", "--n_steps", "4", "--seed", "0",
]
VISION_FLAGS = [
    "--synthetic", "64", *QLORA_FLAGS, "--freeze_prefixes", "tok_embeddings", "output", "norm", "patch_embed",
    "--remat_policy", "full", "--fused_ce_chunks", "4", "--image_size", "224", "--patch_size", "14",
    "--seq_len_multiple", "32", "--batch_size", "8", "--gradient_accumulation", "1",
]
OMNI_FLAGS = [  # tools/bench_omni.py's geometry: 30 s + one 224 image + 2324 text = 4096 positions
    "--synthetic", "8", *QLORA_FLAGS, "--freeze_prefixes", "tok_embeddings", "output", "norm", "audio_embed",
    "patch_embed", "--remat_policy", "flash_proj", "--fused_ce_chunks", "4", "--audio_duration", "30",
    "--image_size", "224", "--patch_size", "14", "--seq_len_multiple", "2324", "--max_text_len", "2324",
    "--batch_size", "1", "--gradient_accumulation", "1",
]


TRUNK_LAYERS = 8  # the vision, omni and evaluation phases' depth (a cut of the 32 layers)


def build_trunk():
    """The 8B QLoRA trunk with both stems (a ``LlamaOmni``), built once from train_omni's
    flags and cut to its first TRUNK_LAYERS layers; the vision step and the evaluations put
    their own model class around the same tensors."""
    import torch

    from llama_x_tpu_torch import train_omni as entry
    from llama_x_tpu_torch.train import cli

    log(f"[8B trunk] Llama-3.1-8B width, the first {TRUNK_LAYERS} of 32 layers (a depth cut), int8 base + LoRA r 8, "
        "int8 act / dgrad / head, the audio stem and the patch-embed stem (frozen), max_seq_len 4096")
    args = entry.parse_args(OMNI_FLAGS)
    audio_config, vision_config, max_seq_len = entry.configs(args)
    t0 = time.perf_counter()
    model = cli.build_model_params(args, max_seq_len=max_seq_len, audio_config=audio_config,
                                   vision_config=vision_config)
    torch.cuda.synchronize()
    log(f"    weights built on the card from seed 0 in {time.perf_counter() - t0:.1f} s; max_seq_len {max_seq_len}")
    return cut_of(model, TRUNK_LAYERS)


def step_phase(tag: str, model, args, loss_fn, batch, positions: int, policy: str) -> dict:
    """4 optimizer steps on one repeated step batch with the launch counts held to
    ``expected_launches`` every step, the loss falling, the int8 base and the frozen stems
    unchanged and the adapters moving; the first step is the eager step and the capture, the
    others replays; then a replay held to a device trace, and one profiled eager step."""
    import torch

    from llama_x_tpu_torch.train import cli, step_graph
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    optimizer, _ = cli.setup_optimizer(args, model)
    state = TrainState(model, optimizer)
    train_step = make_train_step(loss_fn)
    L, C = model.config.num_layers, model.config.fused_ce_chunks
    sums = base_checksums(model)
    stems = [p.detach().clone() for n, p in model.named_parameters() if n.split(".")[0].endswith("_embed")]
    first = model.layers[0].feed_forward.w1
    lora_b0 = first.lora_b.detach().clone()
    torch.cuda.reset_peak_memory_stats()
    steps = timed_steps(train_step, state, batch, args.n_steps, positions, expected_launches(policy, L, C))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"    {tag}: launches per step {steps[-1]['launches']}; peak memory {peak:.2f} GB")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"the loss did not fall: {[r['loss'] for r in steps]}")
    now = [p for n, p in model.named_parameters() if n.split(".")[0].endswith("_embed")]
    if base_checksums(model) != sums or not all(torch.equal(a, b) for a, b in zip(stems, now)):
        raise AssertionError("the frozen int8 base or a frozen stem changed during training")
    if torch.equal(first.lora_b, lora_b0):
        raise AssertionError("the adapter tensors did not move")
    launches = {k: sum(r["launches"][k] for r in steps) for k in steps[0]["launches"]}
    torch.cuda.reset_peak_memory_stats()
    graph_prof = traced_steps(train_step, state, batch, 1, expected_launches(policy, L, C),
                              f"{tag} ({policy}, graph replay)")
    graph_mem = graph_memory()
    prof_rec = eager_profile(loss_fn, state, batch, f"{tag} ({policy}, eager)")
    vs = graph_against_eager(tag, state, steps, graph_prof, prof_rec, graph_mem)
    step_graph.release(state)
    del state, optimizer
    return dict(steps=steps, launches=launches, peak_mem_gb=peak, profile=prof_rec, graph_profile=graph_prof,
                graph_vs_eager=vs)


def phase_vision(trunk) -> dict:
    """The vision step, put together from ``train_vision``'s own functions: 8 canvases of
    the synthetic shapes task (224, patch 14: 256 patches + 16 newlines) before 32 caption
    bytes, prefix-LM, remat ``full``, fused CE in 4 chunks."""
    from llama_x_tpu_torch import train_vision as entry
    from llama_x_tpu_torch.data.tokenizers import get_tokenizer
    from llama_x_tpu_torch.models.vision import LlamaVision, VisionConfig
    from llama_x_tpu_torch.train import cli

    log("[vision main path] the 8B trunk with the patch-embed stem, 8 x (272 image + 32 caption tokens), "
        "prefix-LM 272, remat full, fused CE x4, microbatch 8, AdamW 1e-4")
    args = entry.parse_args(VISION_FLAGS)
    model = LlamaVision.from_llama(trunk, trunk.patch_embed, VisionConfig(args.image_size, args.patch_size))
    model.config = model.config.replace(remat_policy=args.remat_policy, fused_ce_chunks=args.fused_ce_chunks)
    data_iter = entry.make_data(args, args.batch_size, get_tokenizer("byte"))
    batch = cli.assemble_step_batch([next(data_iter)], pad_values={"labels": -100})
    n_image = model.vision_config.num_image_tokens()
    B, L = batch["tokens"].shape[1:]
    log(f"    step batch: images {tuple(batch['images'].shape)} -> {n_image} image tokens each, captions "
        f"{tuple(batch['tokens'].shape)}, {B} x {n_image + L} positions")
    if (B, n_image + L) != (8, 304):
        raise AssertionError(f"the vision step is 8 x 304 positions, got {B} x {n_image + L}")
    res = step_phase("vision", model, args, entry.make_loss_fn(args.prefix_lm), batch, B * (n_image + L),
                     args.remat_policy)
    res["two_path"] = compare_prefix_step_paths(model, batch, "vision (prefix-LM 272)",
                                                lambda m, mb: entry.make_loss_fn(True)(m, mb)[0])
    res["flags"] = VISION_FLAGS
    return res


def phase_omni(trunk) -> dict:
    """The omni step (BASELINE config 5 at tools/bench_omni.py's geometry), put together
    from ``train_omni``'s own functions: 30 s of audio (1500 tokens), one 224 canvas (272)
    and 2324 text tokens, prefix-LM over 1772, remat ``flash_proj``, fused CE in 4 chunks
    of 581 rows, B 1."""
    from llama_x_tpu_torch import train_omni as entry
    from llama_x_tpu_torch.train import cli

    log("[omni main path] the 8B trunk with both stems, 1500 audio + 272 image + 2324 text = 4096 positions, "
        "prefix-LM 1772, remat flash_proj, fused CE x4 (581 rows a chunk), B 1, AdamW 1e-4")
    args = entry.parse_args(OMNI_FLAGS)
    data_iter, _ = entry.make_data(args, trunk.audio_config, 1, trunk.config.vocab_size)
    batch = cli.assemble_step_batch([next(data_iter)], pad_values={"labels": -100})
    n_audio = trunk.audio_config.num_audio_tokens(batch["audio"].shape[-1])
    n_image = trunk.vision_config.num_image_tokens()
    positions = n_audio + n_image + batch["tokens"].shape[-1]
    log(f"    step batch: audio {tuple(batch['audio'].shape)} -> {n_audio}, image {tuple(batch['images'].shape)} -> "
        f"{n_image}, text {tuple(batch['tokens'].shape)}: {positions} positions")
    if (n_audio, n_image, positions) != (1500, 272, 4096):
        raise AssertionError(f"the omni step is 1500 + 272 + 2324 positions, got {n_audio} + {n_image} + "
                             f"{positions - n_audio - n_image}")
    res = step_phase("omni", trunk, args, entry.make_loss_fn(args.prefix_lm), batch, positions, args.remat_policy)
    res["two_path"] = compare_prefix_step_paths(trunk, batch, "omni (prefix-LM 1772)",
                                                lambda m, mb: entry.make_loss_fn(True)(m, mb)[0])
    res["flags"] = OMNI_FLAGS
    return res


def cut_of(model, layers: int = 2, **config):
    """The first ``layers`` layers of ``model`` under its own class (config fields
    replaced by ``config``), every tensor shared: the embeddings, head, norm and stems."""
    from llama_x_tpu_torch.models.audio import LlamaAudio
    from llama_x_tpu_torch.models.llama import Llama
    from llama_x_tpu_torch.models.omni import LlamaOmni
    from llama_x_tpu_torch.models.vision import LlamaVision

    c = model.config.replace(num_layers=layers, **config)
    parts = (c, model.tok_embeddings.data, list(model.layers[:layers]), model.norm, model.output)
    if isinstance(model, LlamaOmni):
        return LlamaOmni(*parts, model.audio_embed, model.patch_embed, model.audio_config, model.vision_config)
    if isinstance(model, LlamaVision):
        return LlamaVision(*parts, model.patch_embed, model.vision_config)
    if isinstance(model, LlamaAudio):
        return LlamaAudio(*parts, model.audio_embed, model.audio_config)
    return Llama(*parts)


def compare_prefix_step_paths(model, batch, tag: str, loss_of) -> dict:
    """Loss and adapter gradients of the step's microbatch on a 2-layer cut of the
    trained weights, through the kernels and through their plain versions."""
    import torch

    mb = {k: torch.as_tensor(v[0]).cuda() for k, v in batch.items()}
    return compare_grad_paths(cut_of(model), lambda m: loss_of(m, mb), tag)


def prefix_first_logits(model, prefix, bos, nxt=None):
    """``generate``'s first two steps written out: the prefill of [prefix, bos] under
    prefix-LM through the cache, the logits of the first generated token [B, 1, V], then
    one decode step (K3) on ``nxt`` (default: the greedy first token) and its logits."""
    import torch

    from llama_x_tpu_torch.models import llama
    from llama_x_tpu_torch.ops.attention import MaskInfo

    B, n_prefix = prefix.shape[:2]
    with torch.inference_mode():
        cache = llama.init_kv_cache(model.config, B, dtype=torch.bfloat16, device=model.device)
        x = torch.cat([prefix.to(model.tok_embeddings.dtype), torch.nn.functional.embedding(bos, model.tok_embeddings)],
                      dim=1)
        P = x.shape[1]
        mi = MaskInfo(causal=True, prefix_len=torch.full((B,), n_prefix, dtype=torch.int32, device=model.device))
        h, cache = llama.trunk(model, x, mi, cache, input_pos=torch.arange(P, device=model.device), prefill=True)
        first = llama.head(model, h[:, -1:])
        if nxt is None:
            nxt = first[:, 0].argmax(-1)
        pos = torch.tensor(P, device=model.device)
        x1 = torch.nn.functional.embedding(nxt[:, None], model.tok_embeddings)
        mi1 = MaskInfo(causal=True, q_positions=pos[None, None], kv_len=pos[None] + 1)
        h1, _ = llama.trunk(model, x1, mi1, cache, input_pos=pos[None])
        return first, llama.head(model, h1), nxt


def compare_prefix_decode_paths(model, prefix, bos, tag: str) -> dict:
    """The first generated token's logits and the first decode step's on a 2-layer cut,
    kernel path (K1, K2 with the prefix, K3) against the plain path; two bf16 ulps of the
    largest logit, as the serving comparison."""
    cut = cut_of(model)
    reset_counts()
    first_k, dec_k, nxt = prefix_first_logits(cut, prefix, bos)
    counts = read_counts()
    if not all(counts[k] for k in ("int8_mm_dequant_nt", "flash_attention", "decode_attention")):
        raise AssertionError(f"the kernel path skipped a kernel: {counts}")
    reset_counts()
    with plain_path():
        first_p, dec_p, _ = prefix_first_logits(cut, prefix, bos, nxt)
    if any(read_counts().values()):
        raise AssertionError(f"the plain path launched kernels: {read_counts()}")
    res = {}
    for name, a, b in (("first token", first_k, first_p), ("first decode step", dec_k, dec_p)):
        ref_max = float(b.float().abs().max())
        tol = 2**-6 * ref_max
        err = max_err(a, b)
        check(f"{tag} 2-layer {name} logits, kernels vs plain (max|ref| {ref_max:.2f})", err, tol)
        res[f"{name.replace(' ', '_')}_max_abs_err"], res[f"{name.replace(' ', '_')}_tol"] = err, tol
    return res


EVAL_NEW_TOKENS = 16


def timed_eval(tag: str, model, prefix, decode_fn, eos_id: int) -> tuple[dict, list]:
    """One evaluation batch through its entry point's function: a warm-up (which captures
    the prefill's key and the decode step), the prefill of the same key through its graph
    against ``eager=True`` (``check_prefill``: bit for bit, each timed), then the whole call
    with the counts reset just before it and read just after; K1, K2 and K3 must launch. The
    call again under the profiler: the same texts, and the same counts, held to its device
    trace. -> (record, texts)"""
    import torch

    decode_fn(2)  # warm-up
    B = prefix.shape[0]
    bos = torch.full((B, 1), 256, dtype=torch.long, device="cuda")
    prefill = check_prefill(f"the {tag} evaluation", model, bos, torch.bfloat16, prefix=prefix, eos_id=eos_id)
    prefill_s = sorted(prefill["graph_ms"])[len(prefill["graph_ms"]) // 2] / 1e3
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    hyps = decode_fn(EVAL_NEW_TOKENS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    missing = [k for k in ("int8_mm_dequant_nt", "flash_attention", "decode_attention") if counts[k] == 0]
    if missing or len(hyps) != B:
        raise AssertionError(f"the {tag} evaluation never launched {missing} or returned {len(hyps)} texts: {counts}")
    res = dict(B=B, prefix=int(prefix.shape[1]), new_tokens=EVAL_NEW_TOKENS, launches=counts, total_s=total_s,
               prefill_ms=prefill_s * 1e3, decode_tok_s=B * (EVAL_NEW_TOKENS - 1) / (total_s - prefill_s),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, prefill_graph=prefill)
    tr = traced(f"the {tag} evaluation", lambda: decode_fn(EVAL_NEW_TOKENS))  # again, its decode steps replays
    if tr["launches"] != counts or tr["result"] != hyps:
        raise AssertionError(f"the traced {tag} evaluation launched {tr['launches']} against {counts}, or other texts")
    res["traced"] = tr["traced"]
    log(f"    {tag}: B {B}, prefix {prefix.shape[1]} + bos, +{EVAL_NEW_TOKENS}: total {total_s:.3f} s, prefill "
        f"{res['prefill_ms']:.1f} ms, decode {res['decode_tok_s']:.1f} tok/s, peak {res['peak_mem_gb']:.2f} GB; "
        f"launches {counts}, equal to the device trace of the same call {tr['traced']}")
    return res, hyps


def phase_evals(trunk) -> dict:
    """The two evaluations at 8B width on the trained trunk, through their own functions:
    ``eval_vision.caption_batch`` on 8 canvases of the shapes task's eval split and
    ``eval_librispeech.transcribe_batch`` on 4 synthetic 20 s utterances (1000 audio
    tokens), prefix-LM, 16 new tokens, then each on a 2-layer cut against the plain path.
    The scores of random weights mean nothing; the path is the point."""
    import numpy as np
    import torch

    from llama_x_tpu_torch import eval_librispeech as eval_ls
    from llama_x_tpu_torch import eval_vision as eval_vis
    from llama_x_tpu_torch.data.tokenizers import ByteTokenizer
    from llama_x_tpu_torch.data.vision import make_shapes_sample
    from llama_x_tpu_torch.models import audio as audio_mod
    from llama_x_tpu_torch.models import vision as vision_mod
    from llama_x_tpu_torch.models.audio import LlamaAudio
    from llama_x_tpu_torch.models.vision import LlamaVision
    from llama_x_tpu_torch.train.wer import wer

    tok = ByteTokenizer()
    runs = {}
    log("[evaluations] the trained 8B trunk: eval_vision's captions (8 eval-split canvases, 272 image tokens) and "
        "eval_librispeech's transcripts (4 x 20 s -> 1000 audio tokens), prefix-LM, 16 new tokens, bf16 cache")
    model = LlamaVision.from_llama(trunk, trunk.patch_embed, trunk.vision_config)
    rng = np.random.default_rng(0)
    samples = [make_shapes_sample(rng, 224, split="eval") for _ in range(8)]
    images = torch.from_numpy(np.stack([im for im, _ in samples]))
    with torch.inference_mode():
        prefix = vision_mod.patch_embed(model.patch_embed, model.vision_config, images.cuda())
    res, hyps = timed_eval("captions", model, prefix, lambda n: eval_vis.caption_batch(model, images, tok, n, True),
                           tok.eos_id)
    res["score"] = eval_vis._score([c for _, c in samples], hyps)
    log(f"    captions score {json.dumps(res['score'])}; first caption {hyps[0]!r}")
    res["two_path"] = compare_prefix_decode_paths(model, prefix, torch.full((8, 1), 256, device="cuda"), "captions")
    runs["eval_vision"] = res

    model = LlamaAudio.from_llama(trunk, trunk.audio_embed, trunk.audio_config)
    audio = torch.from_numpy((np.random.default_rng(1).standard_normal((4, 20 * 16_000)) * 0.1).astype(np.float32))
    with torch.inference_mode():
        prefix = audio_mod.audio_embed(model.audio_embed, model.audio_config, audio.cuda())
    if prefix.shape[1] != 1000:
        raise AssertionError(f"20 s of audio is 1000 audio tokens, got {prefix.shape[1]}")
    res, hyps = timed_eval("transcripts", model, prefix,
                           lambda n: eval_ls.transcribe_batch(model, audio, tok, n, True), tok.eos_id)
    res["score"] = {"wer": wer(["synthetic reference text"] * 4, hyps), "n_utts": 4}
    log(f"    transcripts score {json.dumps(res['score'])}")
    res["two_path"] = compare_prefix_decode_paths(model, prefix, torch.full((4, 1), 256, device="cuda"),
                                                  "transcripts")
    runs["eval_librispeech"] = res
    return runs


def write_librispeech_dir(root: Path, n: int = 8) -> Path:
    """A LibriSpeech-layout directory: one chapter of 16 kHz 16-bit WAV utterances of
    1 to 4 s (tones in noise) with their transcript file."""
    import wave

    import numpy as np

    rng = np.random.default_rng(5)
    d = root / "103" / "1240"
    d.mkdir(parents=True)
    lines = []
    for i in range(n):
        t = np.arange(int((1.0 + 3.0 * rng.random()) * 16_000)) / 16_000
        x = 0.2 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.02 * rng.standard_normal(t.shape)
        with wave.open(str(d / f"103-1240-{i:04d}.wav"), "wb") as w:
            w.setnchannels(1), w.setsampwidth(2), w.setframerate(16_000)
            w.writeframes((x * 32767).astype(np.int16).tobytes())
        lines.append(f"103-1240-{i:04d} CHAPTER {i} OF THE SYNTHETIC BOOK READ ALOUD")
    (d / "103-1240.trans.txt").write_text("\n".join(lines) + "\n")
    return root


def phase_real_data() -> dict:
    """``train_librispeech.main`` over a LibriSpeech-layout directory written here:
    ``LibriSpeechPacked`` (WAV decoding, the byte tokenizer, packing) feeds two QLoRA
    steps on a 2-layer cut of the 8B geometry; every training kernel must launch."""
    import tempfile

    from llama_x_tpu_torch import train_librispeech as entry

    log("[real data, host path] train_librispeech --dataset_dir (8 WAV utterances of 1-4 s), 8B width cut to "
        "2 layers, QLoRA, prefix-LM, 8 s windows, 2 steps")
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        root = write_librispeech_dir(Path(tmp) / "LibriSpeech")
        flags = ["--dataset_dir", str(root), *QLORA_FLAGS, "--synthetic_config", '{"num_layers": 2}',
                 "--freeze_prefixes", "tok_embeddings", "output", "norm", "audio_embed", "--remat_policy", "flash_q8s",
                 "--fused_ce_chunks", "2", "--audio_duration", "8", "--seq_len_multiple", "128", "--n_steps", "2",
                 "--log_interval", "1", "--ckpt_interval", "0"]
        reset_counts()
        t0 = time.perf_counter()
        with graph_census() as census:
            entry.main(flags)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        need_graph_steps(census, "train_librispeech --dataset_dir")
        (run,) = (Path(tmp) / "runs" / "librispeech").iterdir()
        recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if missing or [r["step"] for r in recs] != [0, 1] or not all(math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"the real-data run: missing {missing}, records {recs}")
    log(f"    2 steps in {seconds:.1f} s (model build, checkpoint included): losses {[r['loss'] for r in recs]}; "
        f"launches {counts}")
    return dict(flags=flags, seconds=seconds, launches=counts, records=recs)


SMALL_CARD_MODEL = ["--synthetic_config", '{"num_layers": 2, "head_dim": 64, "num_heads": 4, "num_kv_heads": 2}']


def phase_entry_points() -> dict:
    """The four new entry points, each called as a user calls it, on the card at the size
    of their CPU smokes (a small QLoRA model, heads of 64 for the attention kernels)."""
    import tempfile

    from llama_x_tpu_torch import eval_librispeech, eval_vision, train_omni, train_vision

    log("[entry points] train_vision, train_omni (small QLoRA models, 2 steps), eval_vision, eval_librispeech "
        "(--synthetic) on the card")
    small = ["--quantize", "int8", "--quantize_kwargs",
             '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}', "--adapter", "lora",
             "--activation_checkpointing", "--fused_ce_chunks", "2", "--prefix_lm", "--n_steps", "2",
             "--log_interval", "1", "--ckpt_interval", "0", *SMALL_CARD_MODEL]
    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), graph_census() as census:
        train_vision.main(["--synthetic", "16", "--image_size", "32", "--patch_size", "8", "--batch_size", "4", *small])
        train_omni.main(["--synthetic", "8", "--audio_duration", "1", "--image_size", "32", "--patch_size", "8",
                         "--seq_len_multiple", "64", "--batch_size", "2", *small])
        vis = eval_vision.main(["--synthetic", "4", "--image_size", "32", "--patch_size", "8", "--max_new_tokens", "8",
                                "--prefix_lm"])
        ls = eval_librispeech.main(["--synthetic", "2", "--max_new_tokens", "8", "--prefix_lm"])
    counts = read_counts()
    missing = [k for k in [*TRAIN_KERNELS, "decode_attention"] if counts[k] == 0]
    if missing:
        raise AssertionError(f"the entry points never launched {missing}: {counts}")
    need_graph_steps(census, "train_vision / train_omni")
    log(f"    {time.perf_counter() - t0:.1f} s; {census['graph']} graph steps; launches {counts}")
    return dict(launches=counts, eval_vision=vis, eval_librispeech=ls)


LEARNED_TASKS = [  # (entry point, kernels its run must launch): K2 / K5 train, K3 decodes; QLoRA adds K1 / K4
    ("wer_synthetic", ("flash_attention", "flash_attention_bwd", "decode_attention")),
    ("vision_synthetic", ("flash_attention", "flash_attention_bwd", "decode_attention")),
    ("omni_synthetic", ("flash_attention", "flash_attention_bwd", "decode_attention")),
    ("int8_bwd_quality", TRAIN_KERNELS),
    ("int8_head_quality", TRAIN_KERNELS),
]
LEARNED_TASK_STEPS = 30


def phase_learned_tasks() -> dict:
    """The five learned-task entry points through their own ``main`` at a short cut: 30 steps
    (heads of 64 in bf16), the checkpoint round trip and 4 held-out samples for the three
    learned tasks; the loss must fall, the kernels of each run launch, every train step replays
    captured graphs, the launches of each run (replay credits included) equal the kernels of
    its device trace, and every artifact is written under a temporary directory."""
    import importlib
    import tempfile

    log(f"[learned tasks] wer / vision / omni_synthetic and int8_bwd / head_quality, {LEARNED_TASK_STEPS} steps each "
        "(the full runs are calls of their own: README), each run traced")
    out, total = {}, {k: 0 for k in counted()}
    with tempfile.TemporaryDirectory() as tmp:
        for name, need in LEARNED_TASKS:
            entry = importlib.import_module(f"llama_x_tpu_torch.{name}")
            if name.startswith("int8"):
                argv = ["--steps", str(LEARNED_TASK_STEPS), "--out", f"{tmp}/{name}/quality.json"]
            else:
                flag = "--eval_utts" if name == "wer_synthetic" else "--eval_samples"
                argv = ["--steps", str(LEARNED_TASK_STEPS), flag, "4", "--out_dir", f"{tmp}/{name}"]
            with graph_census() as census:
                win = traced(name, lambda: entry.main(argv))
            need_graph_steps(census, name)
            art, counts, seconds = win["result"], win["launches"], win["wall_ms"] / 1e3
            if name.startswith("int8"):
                curve = art[next(k for k in art if k.startswith("curve_"))]
                first, last, written = curve[0], curve[-1], Path(tmp, name, "quality.json")
            else:
                first, last = art["losses_every_50"][0], art["final_loss"]
                written = next(Path(tmp, name).glob("*.json"))
            missing = [k for k in need if counts[k] == 0]
            if missing or not last < first or not written.exists() or art["model"]["head_dim"] != 64:
                raise AssertionError(f"{name}: missing launches {missing}, loss {first} -> {last}, {written}")
            for k in total:
                total[k] += counts[k]
            log(f"    {name}: loss {first:.4f} -> {last:.4f} in {seconds:.1f} s (profiled); {census['graph']} graph "
                f"steps; launches { {k: v for k, v in counts.items() if v} }, equal to the device trace "
                f"{ {k: v for k, v in win['traced'].items() if v} }")
            out[name] = dict({k: v for k, v in art.items() if not k.startswith(("curve", "losses", "task", "launches"))},
                             seconds=seconds, loss_first=first, loss_last=last, launches=counts, graph_steps=census["graph"])
    return dict(tasks=out, launches=total)


PIECES_FLAGS = [
    "--geometry", "8b", "--synthetic_config", '{"num_layers": 2}', "--quantize", "int8",
    "--quantize_kwargs", '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}',
    "--adapter", "lora", "--freeze_prefixes", "tok_embeddings", "output", "norm", "--activation_checkpointing",
    "--remat_policy", "flash_q8s", "--fused_ce_chunks", "8", "--document_mask", "--max_seq_len", "1024",
    "--batch_size", "2", "--n_steps", "7", "--lr", "1e-4", "--log_interval", "1", "--ckpt_interval", "0", "--profile",
]
# the kernels' names in a trace (csrc/int8_mm.cu's two K1 paths; csrc/flash_attention.cu)
TRACE_NAMES = {"int8_mm_dequant_nt": ("int8_mm_nt_wgmma_kernel", "int8_mm_nt_stream_kernel"),
               "flash_attention": ("flash_fwd_kernel",)}


def phase_trainer_pieces() -> dict:
    """``train_metamathqa`` on real data: a byte-tokenized MetaMathQA token cache written to a
    temporary directory, 7 QLoRA steps at Llama-3.1-8B width cut to 2 layers through the
    prefetched step batches, with ``--profile`` (its trace of steps 5 and 6 must name the K1
    and K2 kernels); then ``generate_cli --resume`` on that run with ``--template alpaca``."""
    import tempfile

    from llama_x_tpu_torch import generate_cli, train_metamathqa
    from llama_x_tpu_torch.data.metamathqa import PROMPT_TEMPLATE, tokenize_metamathqa
    from llama_x_tpu_torch.data.tokenizers import get_tokenizer

    log("[trainer pieces] train_metamathqa from a token cache (8B width, 2 layers, 7 steps, --profile), "
        "then generate_cli --template alpaca")
    records = [{"query": f"Tom has {i} apples and buys {i + 3} more. How many apples does he have?",
                "response": f"Tom has {i} + {i + 3} = {2 * i + 3} apples. The answer is: {2 * i + 3}"}
               for i in range(64)]
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        tokenize_metamathqa(get_tokenizer("byte"), "byte", 1024, tmp, records=records)
        reset_counts()
        t0 = time.perf_counter()
        with graph_census() as census:
            train_metamathqa.main(PIECES_FLAGS)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        need_graph_steps(census, "train_metamathqa from a token cache")
        (run,) = (Path(tmp) / "runs" / "metamathqa").iterdir()
        recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        traces = list((run / "profile").glob("*.json"))
        text = traces[0].read_text() if traces else ""
        named = {k: any(n in text for n in names) for k, names in TRACE_NAMES.items()}
        with contextlib.redirect_stdout(io.StringIO()) as said:
            generate_cli.main(["--resume", str(run), "--prompt", "What is 2+2?", "--max_new_tokens", "8",
                               "--template", "alpaca"])
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if missing or [r["step"] for r in recs] != list(range(7)) or not all(math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"the token-cache run: missing launches {missing}, records {recs}")
    if len(traces) != 1 or not all(named.values()):
        raise AssertionError(f"the --profile trace: {traces}, kernels named {named}")
    if PROMPT_TEMPLATE.format(query="What is 2+2?") not in said.getvalue():
        raise AssertionError(f"generate_cli --template alpaca printed {said.getvalue()!r}")
    log(f"    7 steps in {seconds:.1f} s (model build, profile, checkpoint included): losses "
        f"{[round(r['loss'], 4) for r in recs]}; trace {traces[0].name} ({len(text) / 1e6:.1f} MB) names {named}; "
        f"launches {counts}")
    return dict(flags=PIECES_FLAGS, seconds=seconds, launches=counts, records=recs, trace_names=named)


# ---------------------------------------------------------------------------
# phases 15 and 16: context parallelism. K2's ring form and K5's offsets form at the
# blocks of a ring of 2 at 8B attention width; the text QLoRA step at cp 2 (ring, then
# Ulysses) in two processes that share the card over gloo, against cp 1 in one process
# ---------------------------------------------------------------------------

RING_S = 4096  # S_local of each rank of a ring of 2: the 8192-position step at cp 2
RING_PAIRS = [(0, 0), (RING_S, 0), (RING_S, RING_S), (0, RING_S)]  # (q_offset, kv_offset): diagonal, full, diagonal, skipped


def ring_cases():
    """(name, causal, segment ids over the 2 * RING_S positions or None, prefix or None):
    the documents are 8 packed ones whose ids cross the shard boundary; prefix-LM 5000
    reaches past the first shard, so the global prefix test decides the second one."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(15)
    segs = torch.sort(torch.randint(1, 9, (1, 2 * RING_S), device="cuda", generator=g), dim=1).values.to(torch.int32)
    if int(segs[0, RING_S - 1]) != int(segs[0, RING_S]):
        raise AssertionError("the packed documents must cross the shard boundary")
    return [("causal", True, None, None), ("packed documents", True, segs, None), ("prefix-LM 2000", True, None, 2000),
            ("prefix-LM 5000", True, None, 5000), ("non-causal", False, None, None)]


def ring_block_mask_info(causal: bool, segs, prefix, qo: int, ko: int):
    import torch

    from llama_x_tpu_torch.ops.attention import MaskInfo

    return MaskInfo(causal=causal, segment_ids=None if segs is None else segs[:, qo:qo + RING_S].contiguous(),
                    kv_segment_ids=None if segs is None else segs[:, ko:ko + RING_S].contiguous(),
                    prefix_len=None if prefix is None else torch.full((1,), prefix, dtype=torch.int32, device="cuda"))


def ring_census(fa, mi, S: int, bq: int, bk: int, qo: int, ko: int) -> dict:
    """The tiles of one head of a ring block at a kernel's tiling, by the predicate the
    kernels mirror (tile_class with both offsets)."""
    seg = None if mi.segment_ids is None else mi.segment_ids[0].cpu()
    kseg = None if mi.kv_segment_ids is None else mi.kv_segment_ids[0].cpu()
    prefix = None if mi.prefix_len is None else int(mi.prefix_len[0])
    n = {"skip": 0, "partial": 0, "full": 0}
    for q0 in range(0, S, bq):
        qr = None if seg is None else (int(seg[q0:q0 + bq].min()), int(seg[q0:q0 + bq].max()))
        for kv0 in range(0, S, bk):
            kr = None if kseg is None else (int(kseg[kv0:kv0 + bk].min()), int(kseg[kv0:kv0 + bk].max()))
            n[fa.tile_class(q0, kv0, bq, bk, S, bool(mi.causal), prefix, qr, kr, q_offset=qo, kv_offset=ko)] += 1
    return dict(computed=n["partial"] + n["full"], full=n["full"], skipped=n["skip"])


def sdpa_masked_backward_ms(F, q, k, v, do, mask):
    """K5's yardstick on a ring block: the backward of one scaled_dot_product_attention call
    with the block's bool mask (None: unmasked), timed here and never called by the port."""
    import torch

    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    try:
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
        run = lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2), retain_graph=True)
        run()
    except (RuntimeError, ValueError, TypeError) as e:
        log(f"    yardstick unavailable: {type(e).__name__}: {str(e).splitlines()[0][:120]}")
        return None
    return time_ms(run, reps=5, warmup=1)


def phase_ring_kernels() -> dict:
    """K2's ring form and K5's offsets form against their plain versions at every block
    of a ring of 2 (B 1, S_local 4096, 32/8 heads, D 128, bf16) under five masks."""
    import torch
    import torch.nn.functional as F

    from llama_x_tpu_torch.ops import flash_attention as fa

    log("[K2 ring form / K5 offsets form] vs plain at (q_offset, kv_offset) in "
        f"{RING_PAIRS}, S_local {RING_S}, 32/8 heads, D 128; tol: out as K2's (2^-7 |ref| + 2^-5 rms of the row) on "
        "the rows that see a key of the block, lse 2e-3 there and below -1e29 on both sides elsewhere (a row that sees "
        "nothing is weighed by exactly 0 in the lse merge); dq, dk, dv (f32, added into zeroed accumulators) as K5's "
        "(2^-7 |ref| + 2^-5 rms(ref)), from the block's own out / lse and delta")
    g = torch.Generator(device="cuda").manual_seed(16)
    B, S, Hq, Hkv, D = 1, RING_S, 32, 8, 128
    q, k, v = _attn_inputs(g, B, S, Hq, Hkv, D)
    do = torch.randn(B, S, Hq, D, device="cuda", generator=g).to(torch.bfloat16)
    fwd, bwd = [], []
    for name, causal, segs, prefix in ring_cases():
        for qo, ko in RING_PAIRS:
            tag = f"{name} ({qo}, {ko})"
            mi = ring_block_mask_info(causal, segs, prefix, qo, ko)
            out, lse = fa.flash_fwd_ring(q, k, v, mi, qo, ko)
            torch.cuda.synchronize()
            ref, ref_lse = fa.flash_fwd_ring_plain(q, k, v, mi, qo, ko)
            mask = fa.ring_block_mask(mi, B, S, qo, ko, device="cuda")
            seen = torch.ones(B, S, dtype=torch.bool, device="cuda") if mask is None else mask[:, 0].any(-1)
            visible = float(S * S) if mask is None else float(mask.sum())
            atol, rtol = fa.flash_fwd_tolerance(ref)
            if bool(seen.any()):
                err = check_close(f"{tag} out", out[seen], ref[seen], atol[seen], rtol)
                lse_seen = seen[:, None, :, None].expand_as(lse)
                lse_err = max_err(lse[lse_seen], ref_lse[lse_seen])
                check(f"{tag} lse", lse_err, 2e-3)
            else:
                err, lse_err = 0.0, 0.0
                log(f"    {tag}: no row sees a key of this block")
            unseen = ~seen[:, None, :, None].expand_as(lse)
            if bool(unseen.any()) and not (float(lse[unseen].max()) < -1e29 and float(ref_lse[unseen].max()) < -1e29):
                raise AssertionError(f"{tag}: a row that sees no key has lse {float(lse[unseen].max())}")
            run = lambda: fa.flash_fwd_ring(q, k, v, mi, qo, ko)
            ms = time_ms(run)
            plain_ms = time_ms(lambda: fa.flash_fwd_ring_plain(q, k, v, mi, qo, ko), reps=2, warmup=1)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = maybe_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True))
            n_bytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D) + 4 * B * Hq * S
            bms, by = bound_ms(n_bytes, 4 * D * Hq * visible, "bf16")
            tiles = ring_census(fa, mi, S, 128, 128, qo, ko)
            split = device_split_ms(run, ("flash_fwd_kernel",), reps=5)
            log(f"      fwd {ms:.4f} ms (plain {plain_ms:.3f}, sdpa {lib_ms}, bound {bms:.4f} by {by}); device "
                f"{split['flash_fwd_kernel']:.4f} ms (profiler); 128 x 128 tiles: {census_text(tiles)}; visible pairs "
                f"{visible / (S * S):.4f}")
            fwd.append(dict(case=name, q_offset=qo, kv_offset=ko, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, max_abs_err=err,
                            lse_max_abs_err=lse_err, tol=float(atol.max()), rtol=rtol, ms=ms,
                            device_ms=split["flash_fwd_kernel"], plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                            bound_by=by, tiles=tiles, visible=visible))

            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            acc = [torch.zeros(t.shape, dtype=torch.float32, device="cuda") for t in (q, k, v)]
            fa.flash_bwd_ring(q, k, v, out, lse, do, delta, acc, mi, qo, ko)
            torch.cuda.synchronize()
            want = fa.flash_bwd_ring_plain(q, k, v, out, lse, do, delta, mi, qo, ko)
            errs, atols = {}, {}
            for n, a, b in zip(("dq", "dk", "dv"), acc, want):
                atols[n], brtol = fa.flash_bwd_tolerance(b)
                errs[n] = check_close(f"{tag} {n}", a, b, atols[n], brtol)
            del want
            brun = lambda: fa.flash_bwd_ring(q, k, v, out, lse, do, delta, acc, mi, qo, ko)
            bms_k = time_ms(brun, reps=5, warmup=1)
            bplain = time_ms(lambda: fa.flash_bwd_ring_plain(q, k, v, out, lse, do, delta, mi, qo, ko), reps=1,
                             warmup=1)
            blib = sdpa_masked_backward_ms(F, q, k, v, do, mask)
            # q, k, v, dO bf16 and lse, delta f32 read once; dq, dk, dv f32 read and written once
            n_bytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D) + 2 * 4 * B * Hq * S \
                + 2 * 4 * (B * S * Hq * D + 2 * B * S * Hkv * D)
            bbound, bby = bound_ms(n_bytes, 10 * D * Hq * visible, "bf16")
            btiles = {"dkv": ring_census(fa, mi, S, 64, 128, qo, ko), "dq": ring_census(fa, mi, S, 128, 64, qo, ko)}
            bsplit = device_split_ms(brun, ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"), reps=5)
            dev_ms = bsplit["flash_bwd_dq_kernel"] + bsplit["flash_bwd_dkv_kernel"]
            log(f"      bwd {bms_k:.4f} ms (plain {bplain:.3f}, sdpa backward {blib}, bound {bbound:.4f} by {bby}); "
                f"device dq {bsplit['flash_bwd_dq_kernel']:.4f} + dkv {bsplit['flash_bwd_dkv_kernel']:.4f} ms; tiles "
                f"dkv {census_text(btiles['dkv'])}, dq {census_text(btiles['dq'])}")
            bwd.append(dict(case=name, q_offset=qo, kv_offset=ko, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D,
                            max_abs_err=max(errs.values()), errs=errs, tol=max(atols.values()), rtol=brtol, ms=bms_k,
                            device_ms=dev_ms, plain_ms=bplain, library_ms=blib, bound_ms=bbound, bound_by=bby,
                            tiles=btiles, visible=visible))
            del out, lse, ref, ref_lse, acc, delta, mask
            torch.cuda.empty_cache()
    return {"flash_attention_ring": fwd, "flash_attention_bwd_ring": bwd}


CP = 2
CP_LAYERS = 2  # the depth cut of the cp phase: 2 of Llama-3.1-8B's 32 layers, at full width
CP_FLAGS = [
    "--synthetic", "16", "--geometry", "8b", "--synthetic_config", json.dumps({"num_layers": CP_LAYERS}),
    "--quantize", "int8", "--quantize_kwargs", '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}',
    "--adapter", "lora", "--adapter_kwargs", '{"rank": 8}', "--freeze_prefixes", "tok_embeddings", "output", "norm",
    "--activation_checkpointing", "--fused_ce_chunks", "8", "--document_mask", "--max_seq_len", str(CP * RING_S),
    "--batch_size", "1", "--gradient_accumulation", "1", "--optim", "AdamW", "--lr", "1e-3", "--seed", "0",
]
CP_STEPS = (("ring", 3), ("ulysses", 1))  # timed steps under remat "full"
CP_Q8 = "attn_q8s"  # the int8-residual attention under context parallelism
CP_Q8_STEPS = (("ring", 1), ("ulysses", 1))  # timed steps under CP_Q8, after CP_STEPS
CP_TIMEOUT_S = 420


def cp_expected_launches(impl: str, layers: int, cp: int, policy: str = "full") -> dict:
    """The attention launches of one step of one rank: the ring runs cp blocks of K2's ring
    form a layer, doubled by remat "full"'s recompute, and cp blocks of K5's offsets form;
    Ulysses runs K2 and K5 in their normal form once a layer (K2 twice under "full").
    attn_q8s recomputes nothing, so K2 runs once."""
    ring, fwd = impl == "ring", 1 if policy == CP_Q8 else 2
    return {"flash_attention_ring": fwd * cp * layers if ring else 0,
            "flash_attention_bwd_ring": cp * layers if ring else 0,
            "flash_attention": 0 if ring else fwd * layers, "flash_attention_bwd": 0 if ring else layers}


def cp_batch(entry, args, vocab: int) -> dict:
    """The first step batch of the text trainer's data whose packed documents cross the
    middle of the sequence (the shard boundary at cp 2)."""
    from llama_x_tpu_torch.train import cli

    data_iter, _ = entry.make_data(args, vocab)
    for _ in range(16):
        batch = cli.assemble_step_batch([next(data_iter)], pad_values={"labels": -100})
        seg = batch["segment_ids"][0, 0]
        half = seg.shape[0] // CP
        if seg.shape[0] == CP * RING_S and seg[half - 1] == seg[half] and seg.max() > 1:
            return batch
    raise AssertionError("no packed row crosses the shard boundary")


def cp_first_grads(model, entry, rows: dict, mesh):
    """Loss and adapter (LoRA) gradients of the step batch's microbatch at the current
    weights, summed over the mesh (each rank's loss is its share of the mean)."""
    import torch

    from llama_x_tpu_torch.parallel.mesh import all_reduce, use_mesh

    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad and "lora_" in n]
    mb = {k: torch.as_tensor(v[0]).cuda() for k, v in rows.items()}
    with use_mesh(mesh):
        loss, _ = entry.loss_fn(model, mb)
        grads = torch.autograd.grad(loss, [p for _, p in named])
    loss = float(all_reduce(mesh, loss.detach().float()))
    return loss, {n: all_reduce(mesh, g.float()).cpu() for (n, _), g in zip(named, grads)}


def cp_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the cp phase (a spawned process on the shared card, over gloo): the
    text trainer's own pieces at cp ``world``; writes its record to ``out_dir``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.parallel.mesh import init_distributed, make_mesh, use_mesh
    from llama_x_tpu_torch.parallel.sharding import shard_batch
    from llama_x_tpu_torch.train import cli
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step
    from llama_x_tpu_torch.train.validate import validate_launch, validate_model

    dev = init_distributed("gloo", "cuda", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        mesh = make_mesh(cp=world)

        def flags(impl: str, policy: str = "full"):
            args = entry.parse_args([*CP_FLAGS, "--mesh", json.dumps({"cp": world}), "--attn_impl", impl,
                                     "--remat_policy", policy, "--dist_backend", "gloo", "--device", str(dev),
                                     "--n_steps", "6"])
            validate_launch(args, mesh, max_seq_len=args.max_seq_len)
            return args

        args = flags("ring")
        model = cli.build_model_params(args, max_seq_len=args.max_seq_len)
        validate_model(model.config, mesh, args)
        base = model.config
        rows = shard_batch(cp_batch(entry, args, model.config.vocab_size), mesh)
        rec = {"rank": rank, "device": str(dev), "first": {}, "steps": []}
        for policy in ("full", CP_Q8):
            for impl, _ in CP_STEPS:
                # the trainer's flags for this policy and impl, validated as the trainer validates them
                a = flags(impl, policy)
                model.config = base.replace(attn_impl=a.attn_impl, remat_policy=a.remat_policy)
                validate_model(model.config, mesh, a)
                reset_counts()
                loss, grads = cp_first_grads(model, entry, rows, mesh)
                rec["first"][policy, impl] = (loss, grads if rank == 0 else None, read_counts())
        optimizer, _ = cli.setup_optimizer(args, model)
        state = TrainState(model, optimizer)
        train_step = make_train_step(entry.loss_fn, mesh=mesh, eager=True)
        for policy, plan in (("full", CP_STEPS), (CP_Q8, CP_Q8_STEPS)):
            for impl, n in plan:
                model.config = base.replace(attn_impl=impl, remat_policy=policy)
                expect = cp_expected_launches(impl, CP_LAYERS, world, policy)
                for i in range(n):
                    reset_counts()
                    mesh.comm.reset()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    with use_mesh(mesh):
                        m = train_step(state, rows)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    counts = read_counts()
                    step = dict(impl=impl, policy=policy, step=i, loss=float(m["loss"]),
                                grad_norm=float(m["grad_norm"]), seconds=dt, exchange_s=mesh.comm.seconds,
                                exchange_share=mesh.comm.seconds / dt, exchange_calls=mesh.comm.calls,
                                exchange_bytes=mesh.comm.bytes, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                                launches=counts)
                    log(f"    rank {rank} {impl} {policy} step {i}: loss {step['loss']:.4f}, grad norm "
                        f"{step['grad_norm']:.4f}, {dt:.3f} s, exchange {mesh.comm.seconds:.3f} s "
                        f"({step['exchange_share']:.3f} of the step, {mesh.comm.calls} calls, "
                        f"{mesh.comm.bytes / 1e6:.1f} MB), peak {step['peak_gb']:.2f} GB; K1 "
                        f"{counts['int8_mm_dequant_nt']}, K4 {counts['int8_mm_dequant']}, K2-ring "
                        f"{counts['flash_attention_ring']}, K5-offsets {counts['flash_attention_bwd_ring']}, K2 "
                        f"{counts['flash_attention']}, K5 {counts['flash_attention_bwd']}")
                    wrong = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
                    if wrong:
                        raise AssertionError(f"rank {rank} {impl} {policy} step {i} launches (got, expected): {wrong}")
                    if min(counts["int8_mm_dequant_nt"], counts["int8_mm_dequant"]) == 0:
                        raise AssertionError(f"rank {rank} {impl} {policy} step {i} skipped the int8 kernels: {counts}")
                    rec["steps"].append(step)
        torch.save(rec, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_cp_ranks(world: int) -> list[dict]:
    """Spawn the cp ranks on the card, wait with a timeout of their own; a rank that fails
    or hangs fails the phase (and the hung ones are killed)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=cp_rank, args=(r, world, str(Path(tmp) / "store"), tmp)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + CP_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.perf_counter()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        if hung:
            raise AssertionError(f"cp ranks {hung} did not finish within {CP_TIMEOUT_S} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise AssertionError(f"cp ranks failed (rank, exit code): {bad}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def phase_cp() -> dict:
    """The text QLoRA step at Llama-3.1-8B width (depth cut to 2 layers), S 8192 of packed
    documents crossing the shard boundary, at cp 2 over two processes on the one card
    (gloo, asked for by name: NCCL refuses two ranks on one device), ring for 3 steps then
    Ulysses for 1 under remat "full", then one step of each under attn_q8s, against the same
    steps at cp 1 in this process over the whole 8192."""
    import torch

    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.train import cli
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    card = nvidia_smi()
    log(f"[cp phase] text QLoRA at Llama-3.1-8B width, {CP_LAYERS} layers (depth cut), S {CP * RING_S} = {CP} x "
        f"{RING_S}, packed documents across the boundary, fused CE x8; {CP} ranks on cuda:0 over gloo, remat full: "
        f"ring x {CP_STEPS[0][1]} then ulysses x {CP_STEPS[1][1]}, then {CP_Q8}: ring x {CP_Q8_STEPS[0][1]} and "
        f"ulysses x {CP_Q8_STEPS[1][1]}, against cp 1; tol: loss 1e-3 of |loss|, adapter gradients relative L2 2^-6 "
        "per tensor")
    t0 = time.perf_counter()
    ranks = run_cp_ranks(CP)
    cp_wall = time.perf_counter() - t0
    # cp 1: the same flags, one process, the whole sequence
    args = entry.parse_args([*CP_FLAGS, "--n_steps", "6"])
    model = cli.build_model_params(args, max_seq_len=args.max_seq_len)
    base = model.config
    batch = cp_batch(entry, args, model.config.vocab_size)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad and "lora_" in n]
    mb = {k: torch.as_tensor(v[0]).cuda() for k, v in batch.items()}
    out = {"first": {}, "ranks": [], "cp1_steps": []}
    for policy in ("full", CP_Q8):
        model.config = base.replace(remat_policy=policy)
        reset_counts()
        loss1, _ = entry.loss_fn(model, mb)
        grads1 = dict(zip([n for n, _ in named], torch.autograd.grad(loss1, [p for _, p in named])))
        loss1, counts1 = float(loss1.detach()), read_counts()
        for impl, _ in CP_STEPS:
            loss, grads, counts = ranks[0]["first"][policy, impl]
            check(f"cp {CP} {impl} {policy} loss {loss:.5f} vs cp 1 {loss1:.5f}", abs(loss - loss1),
                  1e-3 * abs(loss1))
            worst, worst_name = 0.0, ""
            for name, g in grads.items():
                ref = grads1[name].float().cpu()
                rel = float((g - ref).norm() / ref.norm().clamp(min=1e-30))
                if rel > worst:
                    worst, worst_name = rel, name
            check(f"cp {CP} {impl} {policy} adapter gradients ({len(grads)} tensors), worst relative L2 "
                  f"({worst_name})", worst, 2**-6)
            out["first"][f"{policy} {impl}"] = dict(loss=loss, loss_cp1=loss1, grad_rel_l2_worst=worst,
                                                    k1_rank=counts["int8_mm_dequant_nt"],
                                                    k1_cp1=counts1["int8_mm_dequant_nt"])
            log(f"    first gradients, {impl} {policy}: K1 {counts['int8_mm_dequant_nt']} a rank, "
                f"{counts1['int8_mm_dequant_nt']} at cp 1")
        del grads1
    model.config = base
    optimizer, _ = cli.setup_optimizer(args, model)
    state = TrainState(model, optimizer)
    train_step = make_train_step(entry.loss_fn)
    torch.cuda.reset_peak_memory_stats()
    for i in range(sum(n for _, n in CP_STEPS)):
        t1 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        out["cp1_steps"].append(dict(step=i, policy="full", loss=float(m["loss"]), seconds=time.perf_counter() - t1))
    peak1 = torch.cuda.max_memory_allocated() / 1e9
    # the attn_q8s steps at cp 1, eager as the ranks' are, their launches counted
    model.config = base.replace(remat_policy=CP_Q8)
    eager_step = make_train_step(entry.loss_fn, eager=True)
    for i in range(sum(n for _, n in CP_Q8_STEPS)):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        m = eager_step(state, batch)
        torch.cuda.synchronize()
        out["cp1_steps"].append(dict(step=i, policy=CP_Q8, loss=float(m["loss"]), seconds=time.perf_counter() - t1,
                                     peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=read_counts()))
    model.config = base
    steps = [r["steps"] for r in ranks]
    for j, ref in enumerate(out["cp1_steps"]):
        got = steps[0][j]
        if any(abs(s[j]["loss"] - got["loss"]) > 1e-6 * abs(got["loss"]) for s in steps):
            raise AssertionError(f"the ranks logged different losses at step {j}")
        check(f"step {j} ({got['impl']} {got['policy']}) loss {got['loss']:.5f} vs cp 1 {ref['loss']:.5f}",
              abs(got["loss"] - ref["loss"]), 1e-3 * abs(ref["loss"]))
    q8_cp1 = [s for s in out["cp1_steps"] if s["policy"] == CP_Q8]
    k1_cp1 = q8_cp1[0]["launches"]["int8_mm_dequant_nt"]
    if any(s["launches"]["int8_mm_dequant_nt"] != k1_cp1 for s in q8_cp1):
        raise AssertionError(f"the {CP_Q8} steps at cp 1 launched K1 {[s['launches'] for s in q8_cp1]} times")
    launches = {}
    for r in ranks:
        for s in r["steps"]:
            for k, v in s["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for r in ranks:
        for policy, plan in (("full", CP_STEPS), (CP_Q8, CP_Q8_STEPS)):
            for impl, _ in plan:
                own = [s for s in r["steps"] if s["impl"] == impl and s["policy"] == policy]
                st = own[1:] or own
                ms = sum(s["seconds"] for s in st) / len(st) * 1e3
                share = sum(s["exchange_share"] for s in st) / len(st)
                c = st[-1]["launches"]
                log(f"    rank {r['rank']} {impl} {policy}: step {ms:.1f} ms{' (after the first)' if own[1:] else ''}, "
                    f"exchange share {share:.3f}, peak {max(s['peak_gb'] for s in st):.2f} GB, K1 "
                    f"{c['int8_mm_dequant_nt']}, K2-ring {c['flash_attention_ring']}, K5-offsets "
                    f"{c['flash_attention_bwd_ring']}, K2 {c['flash_attention']}, K5 {c['flash_attention_bwd']} a "
                    f"step; {card}")
                if policy == CP_Q8 and any(s["launches"]["int8_mm_dequant_nt"] != k1_cp1 for s in own):
                    raise AssertionError(f"rank {r['rank']} {impl} {CP_Q8} launched K1 "
                                         f"{[s['launches']['int8_mm_dequant_nt'] for s in own]} times a step, the cp 1 "
                                         f"{CP_Q8} step {k1_cp1}")
        out["ranks"].append(dict(rank=r["rank"], steps=r["steps"]))
    full1 = [s for s in out["cp1_steps"] if s["policy"] == "full"]
    cp1_ms = sum(s["seconds"] for s in full1[1:]) / (len(full1) - 1) * 1e3
    q8_ms = sum(s["seconds"] for s in q8_cp1) / len(q8_cp1) * 1e3
    log(f"    cp 1: step {cp1_ms:.1f} ms (full, graph replays after the first), peak {peak1:.2f} GB; {CP_Q8} eager "
        f"{q8_ms:.1f} ms, peak {max(s['peak_gb'] for s in q8_cp1):.2f} GB, K1 {k1_cp1} a step; the cp {CP} ranks' "
        f"processes took {cp_wall:.1f} s with their start and build; {card}")
    out.update(launches=launches, cp1_step_ms=cp1_ms, cp1_peak_gb=peak1, cp1_q8_step_ms=q8_ms, cp_wall_s=cp_wall)
    del model, state, optimizer
    return out


# ---------------------------------------------------------------------------
# phase 16: slice 5b. The text QLoRA step at 8B width under tp 2, fsdp 2 and pp 2 (GPipe, 2
# microbatches), and ``generate`` at tp 2, in two spawned processes that share the card over
# gloo, each against the same work in this one process
# ---------------------------------------------------------------------------

P5B_LAYERS = 2  # the depth cut of the 5b phase's training: 2 of Llama-3.1-8B's 32 layers, at full width
P5B_FLAGS = [
    "--synthetic", "16", "--geometry", "8b", "--synthetic_config", json.dumps({"num_layers": P5B_LAYERS}),
    "--quantize", "int8", "--quantize_kwargs", '{"dynamic_int8_act": true, "dynamic_int8_bwd": true, "int8_head": true}',
    "--adapter", "lora", "--adapter_kwargs", '{"rank": 8}', "--freeze_prefixes", "tok_embeddings", "output", "norm",
    "--activation_checkpointing", "--fused_ce_chunks", "8", "--document_mask", "--max_seq_len", "4096",
    "--gradient_accumulation", "1", "--optim", "AdamW", "--lr", "1e-3", "--seed", "0", "--n_steps", "2",
]
# mesh -> (batch rows of a step over the mesh, extra flags)
P5B_MESHES = (("tp", {"tp": 2}, 1, []), ("fsdp", {"fsdp": 2}, 2, []),
              ("pp", {"pp": 2}, 2, ["--pp_microbatches", "2"]))
P5B_STEPS = 2
P5B_SERVE_NEW = 32
P5B_TIMEOUT_S = 480


def p5b_expected_launches(name: str, mesh: dict, rank: int) -> dict:
    """One rank's launches in one step (remat "full", CE x8, one row a microbatch): tp and
    fsdp run every layer's 7 projections on their shards (``expected_launches``); a pp stage
    runs its L / P layers for each of the 2 microbatches, and only the last stage the CE.
    K7 (the rowwise quantizer): 21 a layer (7 inputs, again in the recompute, and 7 input
    gradients), and with the CE the head and each chunk's rows in both passes and each chunk's
    dlogits (3 C + 2); at tp each call whose rows "tp" splits is two launches, the absmax pass
    and the codes pass: wo's and w2's inputs (twice a layer), the 5 column-parallel input
    gradients a layer and each chunk's dlogits (9 L + C more)."""
    def k7(layers: int, chunks: int) -> int:
        return 21 * layers + (3 * chunks + 2 if chunks else 0)

    if name != "pp":
        out = expected_launches("full", P5B_LAYERS, 8)
        out["quantize_rows"] = k7(P5B_LAYERS, 8) + (9 * P5B_LAYERS + 8 if name == "tp" else 0)
        return out
    stages = mesh["pp"]
    chunks = 8 if rank == stages - 1 else 0
    one = expected_launches("full", P5B_LAYERS // stages, chunks)
    one["quantize_rows"] = k7(P5B_LAYERS // stages, chunks)
    return {k: 2 * v for k, v in one.items()}


def p5b_step_batch(entry, args, vocab: int) -> dict:
    from llama_x_tpu_torch.train import cli

    data_iter, _ = entry.make_data(args, vocab)
    return cli.assemble_step_batch([next(data_iter)], pad_values={"labels": -100})


class GradRecorder:
    """An optimizer in front of the real one: keeps the first gradients it is handed (what
    the train step hands its optimizer after the reduction over the mesh), then steps."""

    def __init__(self, optimizer):
        self.inner, self.params, self.first = optimizer, optimizer.params, None

    def step(self, grads, norm=None):
        if self.first is None:
            self.first = [g.detach().clone() for g in grads]
        self.inner.step(grads, norm=norm)


def p5b_lora_grads(state, grads, mesh) -> dict:
    """{name: whole gradient on the CPU} of the LoRA tensors: each gathered over the axes it is
    sharded over, every pipeline stage's (an all-gather over pp)."""
    import torch.distributed as dist

    from llama_x_tpu_torch.parallel.mesh import AXES
    from llama_x_tpu_torch.parallel.tensor import gather_now

    out = {}
    for (n, p), g in zip(state.trainable, grads):
        if "lora_" in n:
            out[n] = gather_now(g, mesh, AXES, like=p).float().cpu()
    if mesh is not None and mesh.axis_size("pp") > 1:
        parts = [None] * mesh.axis_size("pp")
        dist.all_gather_object(parts, out, group=mesh.group("pp"))
        for part in parts:
            out.update(part)
    return out


def p5b_rank(rank: int, world: int, store: str, out_dir: str) -> None:
    """One rank of the 5b phase (a spawned process on the shared card, over gloo): the text
    trainer's own pieces at tp 2, fsdp 2 and pp 2 in turn, then ``generate`` at tp 2 on the
    first SERVING_LAYERS layers of the main path's int8 model; writes its record to ``out_dir``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.parallel.mesh import init_distributed, make_mesh, use_mesh
    from llama_x_tpu_torch.parallel.sharding import shard_batch
    from llama_x_tpu_torch.train import cli
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step
    from llama_x_tpu_torch.train.validate import validate_launch, validate_model

    dev = init_distributed("gloo", "cuda", init_method=f"file://{store}", rank=rank, world_size=world)
    rec = {"rank": rank, "device": str(dev), "train": {}}
    try:
        for name, shape, rows, extra in P5B_MESHES:
            mesh = make_mesh(**shape)
            base = torch.cuda.memory_allocated()  # what the earlier configurations left
            args = entry.parse_args([*P5B_FLAGS, "--batch_size", str(rows), *extra, "--mesh", json.dumps(shape),
                                     "--dist_backend", "gloo", "--device", str(dev)])
            validate_launch(args, mesh, max_seq_len=args.max_seq_len)
            model = cli.build_model_params(args, max_seq_len=args.max_seq_len)
            validate_model(model.config, mesh, args)
            cli.place_model(model, mesh)
            gc.collect()
            torch.cuda.empty_cache()
            batch = shard_batch(p5b_step_batch(entry, args, model.config.vocab_size), mesh)
            optimizer, _ = cli.setup_optimizer(args, model)
            recorder = GradRecorder(optimizer)
            state = TrainState(model, recorder)
            train_step = make_train_step(entry.make_loss_fn(args, mesh), mesh=mesh, eager=True)
            expect = p5b_expected_launches(name, shape, mesh.index("pp"))
            steps = []
            torch.cuda.reset_peak_memory_stats()
            for i in range(P5B_STEPS):
                reset_counts()
                mesh.comm.reset()
                t0 = time.perf_counter()
                with use_mesh(mesh):
                    m = train_step(state, batch)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                counts = read_counts()
                step = dict(step=i, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), seconds=dt,
                            exchange_s=mesh.comm.seconds, exchange_share=mesh.comm.seconds / dt,
                            exchange_calls=mesh.comm.calls, exchange_bytes=mesh.comm.bytes,
                            peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9, launches=counts)
                log(f"    rank {rank} {name} step {i}: loss {step['loss']:.4f}, grad norm {step['grad_norm']:.4f}, "
                    f"{dt:.3f} s, exchange {mesh.comm.seconds:.3f} s ({step['exchange_share']:.3f} of the step, "
                    f"{mesh.comm.calls} calls, {mesh.comm.bytes / 1e6:.1f} MB), peak {step['peak_gb']:.2f} GB")
                wrong = {k: (counts[k], v) for k, v in expect.items() if counts[k] != v}
                if wrong:
                    raise AssertionError(f"rank {rank} {name} step {i} launches (got, expected): {wrong}")
                steps.append(step)
            grads = p5b_lora_grads(state, recorder.first, mesh)
            rec["train"][name] = dict(steps=steps, loss=steps[0]["loss"], grads=grads if rank == 0 else None,
                                      expect=expect)
            del model, state, optimizer, recorder, train_step, grads
            gc.collect()
            torch.cuda.empty_cache()
        rec["serve"] = p5b_serve_rank(rank, dev)
        torch.save(rec, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def p5b_serving_model(device):
    """The main path's int8 model (32 layers, seed 0, built as phase 3 builds it), cut to its
    first SERVING_LAYERS layers; the other layers are freed."""
    import torch

    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model
    from llama_x_tpu_torch.models import llama

    config = llama.LlamaConfig(**GEOMETRIES["8b"], max_seq_len=4096, dynamic_int8_act=True)
    full = build_model(config, True, seed=0, device=device)
    model = cut_of(full, SERVING_LAYERS)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    return model


def p5b_serve_rank(rank: int, dev) -> dict:
    """``generate`` at tp 2 (int8 weights, dynamic int8 activations, int8 KV on the local heads)
    over the ragged B 4 prompts of the main path, 32 new tokens; launches counted around it."""
    import torch

    from llama_x_tpu_torch.models.generate import generate, prefill_start
    from llama_x_tpu_torch.parallel.mesh import make_mesh
    from llama_x_tpu_torch.parallel.sharding import shard_params

    mesh = make_mesh(tp=2)
    model = shard_params(p5b_serving_model(dev), mesh)
    prompt, lens = ragged_prompts()
    # a model on a mesh decodes eagerly: gloo's collectives go through host memory, no graph captures them
    generate(model, prompt, max_new_tokens=2, prompt_lens=lens, cache_dtype=torch.int8, eager=True)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_start(model, prompt, prompt_lens=lens, cache_dtype=torch.int8, max_new_tokens=P5B_SERVE_NEW, eager=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    reset_counts()
    mesh.comm.reset()
    t0 = time.perf_counter()
    out = generate(model, prompt, max_new_tokens=P5B_SERVE_NEW, prompt_lens=lens, cache_dtype=torch.int8, eager=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    missing = [k for k in ("int8_mm_dequant_nt", "flash_attention", "decode_attention_int8") if counts[k] == 0]
    if missing:
        raise AssertionError(f"rank {rank}: tp generate never launched {missing}: {counts}")
    B = prompt.shape[0]
    res = dict(tokens=out.cpu().tolist(), wall_s=wall, prefill_ms=prefill_s * 1e3, exchange_s=mesh.comm.seconds,
               exchange_share=mesh.comm.seconds / wall, exchange_calls=mesh.comm.calls,
               exchange_bytes=mesh.comm.bytes, launches=counts, tok_s=B * (P5B_SERVE_NEW - 1) / (wall - prefill_s))
    log(f"    rank {rank} tp 2 generate B {B} +{P5B_SERVE_NEW}: {wall:.3f} s, prefill {prefill_s * 1e3:.1f} ms, decode "
        f"{res['tok_s']:.1f} tok/s, exchange {mesh.comm.seconds:.3f} s ({res['exchange_share']:.3f} of the generate, "
        f"{mesh.comm.calls} calls, {mesh.comm.bytes / 1e6:.1f} MB); launches {counts}")
    return res


def run_p5b_ranks(world: int) -> list[dict]:
    """Spawn the 5b ranks on the card, wait with a timeout of their own; a rank that fails or
    hangs fails the phase (and the hung ones are killed)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=p5b_rank, args=(r, world, str(Path(tmp) / "store"), tmp)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + P5B_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(1.0, deadline - time.perf_counter()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        if hung:
            raise AssertionError(f"5b ranks {hung} did not finish within {P5B_TIMEOUT_S} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise AssertionError(f"5b ranks failed (rank, exit code): {bad}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def p5b_reference(entry, rows: int) -> dict:
    """The first step's loss and LoRA gradients in this one process over the mesh's batch
    (``rows`` rows in one microbatch), and the peak memory of a step at one row (a rank's
    share under fsdp) on a fresh model."""
    import torch

    from llama_x_tpu_torch.train import cli
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    args = entry.parse_args([*P5B_FLAGS, "--batch_size", str(rows)])
    base = torch.cuda.memory_allocated()  # what earlier phases left in this process
    model = cli.build_model_params(args, max_seq_len=args.max_seq_len)
    batch = p5b_step_batch(entry, args, model.config.vocab_size)
    optimizer, _ = cli.setup_optimizer(args, model)
    recorder = GradRecorder(optimizer)
    state = TrainState(model, recorder)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = make_train_step(entry.loss_fn)(state, batch)
    torch.cuda.synchronize()
    out = dict(loss=float(m["loss"]), grads=p5b_lora_grads(state, recorder.first, None),
               seconds=time.perf_counter() - t0, peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
    del model, state, optimizer, recorder
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_5b() -> dict:
    """Slice 5b on the card: the text QLoRA step at Llama-3.1-8B width (depth cut to 2 layers,
    S 4096 packed byte-token documents) at tp 2, fsdp 2 and pp 2 (2 GPipe microbatches of one
    row) in two processes on the one card over gloo, each rank's first-step loss and gathered
    LoRA gradients against the same step in this process at the mesh's batch, the launches
    held every step, fsdp's peak memory below one process's at a rank's share of the batch;
    then ``generate`` at tp 2 on the first SERVING_LAYERS layers of the main path's int8 model (int8 KV,
    B 4, prompts padded to 512, 32 new tokens), each rank's rows against an unsharded
    ``generate`` under the near-tie rule."""
    import torch

    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.models.generate import generate

    log(f"[5b phase] text QLoRA at Llama-3.1-8B width, {P5B_LAYERS} layers (depth cut), S 4096, remat full, fused "
        f"CE x8, int8 act / dgrad / head; tp 2, fsdp 2, pp 2 (2 microbatches) on 2 ranks of cuda:0 over gloo, "
        f"{P5B_STEPS} steps each; then tp 2 generate; tol: loss 1e-3 of |loss|, LoRA gradients relative L2 2^-6")
    t0 = time.perf_counter()
    ranks = run_p5b_ranks(2)
    wall = time.perf_counter() - t0
    refs = {rows: p5b_reference(entry, rows) for rows in (1, 2)}
    out = {"train": {}, "ranks_wall_s": wall, "reference": {r: {k: v for k, v in ref.items() if k != "grads"}
                                                            for r, ref in refs.items()}}
    launches = {}
    for name, shape, rows, _ in P5B_MESHES:
        ref = refs[rows]
        losses = [r["train"][name]["loss"] for r in ranks]
        if any(abs(x - losses[0]) > 1e-6 * abs(losses[0]) for x in losses):
            raise AssertionError(f"{name}: the ranks logged different losses {losses}")
        check(f"{name} 2 loss {losses[0]:.5f} vs one process {ref['loss']:.5f}", abs(losses[0] - ref["loss"]),
              1e-3 * abs(ref["loss"]))
        grads = ranks[0]["train"][name]["grads"]
        if set(grads) != set(ref["grads"]):
            raise AssertionError(f"{name}: LoRA tensors differ from one process's: {sorted(set(grads) ^ set(ref['grads']))[:4]}")
        worst, worst_name = 0.0, ""
        for n, g in grads.items():
            want = ref["grads"][n]
            rel = float((g - want).norm() / want.norm().clamp(min=1e-30))
            if rel > worst:
                worst, worst_name = rel, n
        check(f"{name} 2 LoRA gradients ({len(grads)} tensors), worst relative L2 ({worst_name})", worst, 2**-6)
        per_rank = []
        for r in ranks:
            st = r["train"][name]["steps"]
            later = st[1:] or st
            per_rank.append(dict(rank=r["rank"], step_ms=sum(s["seconds"] for s in later) / len(later) * 1e3,
                                 exchange_share=sum(s["exchange_share"] for s in later) / len(later),
                                 exchange_mb=later[-1]["exchange_bytes"] / 1e6, peak_gb=max(s["peak_gb"] for s in st),
                                 launches=st[-1]["launches"]))
            for s in st:
                for k, v in s["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            log(f"    rank {r['rank']} {name}: step {per_rank[-1]['step_ms']:.1f} ms (after the first), exchange share "
                f"{per_rank[-1]['exchange_share']:.3f}, {per_rank[-1]['exchange_mb']:.1f} MB a step, peak "
                f"{per_rank[-1]['peak_gb']:.2f} GB; launches a step {st[-1]['launches']}")
        out["train"][name] = dict(loss=losses[0], loss_one_process=ref["loss"], grad_rel_l2_worst=worst, ranks=per_rank)
    one_row_peak = refs[1]["peak_gb"]
    fsdp_peak = max(r["peak_gb"] for r in out["train"]["fsdp"]["ranks"])
    log(f"    peak memory a rank at fsdp 2: {fsdp_peak:.2f} GB against {one_row_peak:.2f} GB in one process at the "
        f"same rows (one); one process's step {refs[1]['seconds'] * 1e3:.1f} ms at 1 row, "
        f"{refs[2]['seconds'] * 1e3:.1f} ms at 2 (first steps)")
    if not fsdp_peak < one_row_peak:
        raise AssertionError(f"fsdp's per-rank peak {fsdp_peak:.2f} GB is not below one process's {one_row_peak:.2f} GB")
    # serving: each rank's rows against an unsharded generate of the same model
    model = p5b_serving_model("cuda")
    prompt, lens = ragged_prompts()
    want = generate(model, prompt, max_new_tokens=P5B_SERVE_NEW, prompt_lens=lens, cache_dtype=torch.int8).cpu().tolist()
    served = {"rows": []}
    for r in ranks:
        toks = r["serve"]["tokens"]
        if r["rank"] > 0 and toks != ranks[0]["serve"]["tokens"]:
            raise AssertionError("the tp ranks sampled different tokens")
        for i, row in enumerate(toks):
            ids = prompt[i, :int(lens[i])].tolist()
            served["rows"].append(check_served_row(model, ids, row, torch.int8, other=want[i]))
        for k, v in r["serve"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    same = sum(a == b for a, b in zip(ranks[0]["serve"]["tokens"], want))
    log(f"    tp 2 generate: {same} of {len(want)} rows equal to the unsharded generate token for token, the others "
        f"near-ties ({[s['diverged_at'] for s in served['rows'][:len(want)]]}); decode "
        + ", ".join(f"rank {r['rank']} {r['serve']['tok_s']:.1f} tok/s, exchange share {r['serve']['exchange_share']:.3f}"
                    for r in ranks))
    served.update({k: [r["serve"][k] for r in ranks] for k in ("tok_s", "prefill_ms", "exchange_share",
                                                                "exchange_bytes", "wall_s")}, identical_rows=same)
    out["serve"] = served
    out["launches"] = launches
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 17: the hybrid's state-space layer
# ---------------------------------------------------------------------------

HYBRID_CONFIG = ROOT / "benchmark/configs/nemotron-h-47b.json"


def ssd_kernel_cases(g) -> dict:
    """K8, K9 and the two Triton passes at Nemotron-H-47B's widths against their plain
    versions -> {kernel name: per-shape records}."""
    import torch

    from llama_x_tpu_torch.ops import ssd

    cfg = json.loads(HYBRID_CONFIG.read_text())
    H, G, N, P, K = cfg["mamba_num_heads"], cfg["n_groups"], cfg["ssm_state_size"], cfg["mamba_head_dim"], ssd.CONV_KERNEL
    C, di, dev = H * P + 2 * G * N, H * P, "cuda"
    dims = dict(heads=H, head_dim=P, groups=G, state_dim=N)
    A = -(torch.rand(H, device=dev, generator=g) * 15 + 1)
    D = torch.rand(H, device=dev, generator=g) + 0.5
    dt_bias = torch.log(torch.expm1(torch.rand(H, device=dev, generator=g) * 0.099 + 0.001))
    state_bytes = H * P * N * 4
    out = {"ssd_scan": [], "ssd_step": [], "ssd_conv": [], "gated_norm": []}

    def close(name, got, want, rel):
        err, tol = max_err(got, want), rel * max(1e-3, float(want.float().abs().max()))
        check(name, err, tol)
        return err, tol

    log(f"[K8 ssd_scan] H {H} x {P} over N {N}, {G} groups vs its plain version; tol 2e-4 of each output's largest")
    for T, length, at, fresh in ((512, 512, 257, True), (512, 512, 100, False), (512, 300, 300, False),
                                 (64, 64, -1, False)):
        xbc = (torch.randn(T, C, device=dev, generator=g) * 0.5).to(torch.bfloat16)
        dt = torch.randn(T, 3 * H, device=dev, generator=g).to(torch.bfloat16)[:, H:2 * H]
        lanes = torch.randn(3, H, P, N, device=dev, generator=g) * 0.1
        slot = torch.tensor([1], device=dev)
        scalars = (torch.tensor([length], device=dev), torch.tensor([at], device=dev))
        want_l, got_l = lanes.clone(), lanes.clone()
        want_s, got_s = (torch.zeros(H, P, N, device=dev) for _ in range(2))
        want = ssd.ssd_scan_plain(xbc, dt, A, D, dt_bias, want_l, slot, *scalars, want_s, fresh=fresh, **dims)
        got = ssd.ssd_scan(xbc, dt, A, D, dt_bias, got_l, slot, *scalars, got_s, fresh=fresh, **dims)
        torch.cuda.synchronize()
        name = f"T={T} length={length} snap_at={at} {'fresh' if fresh else 'lane'}"
        err, tol = close(f"{name} y", got[:length], want[:length], 2e-4)
        errs = [close(f"{name} lane", got_l, want_l, 2e-4)[0]]
        if at > 0:
            errs.append(close(f"{name} snapshot", got_s, want_s, 2e-4)[0])
        if not (torch.equal(got_l[0], lanes[0]) and torch.equal(got_l[2], lanes[2])):
            raise AssertionError(f"{name}: K8 wrote a lane other than its slot's")
        ms = time_ms(lambda: ssd.ssd_scan(xbc, dt, A, D, dt_bias, got_l, slot, *scalars, got_s, fresh=fresh, **dims))
        plain_ms = time_ms(lambda: ssd.ssd_scan_plain(xbc, dt, A, D, dt_bias, want_l, slot, *scalars, want_s,
                                                      fresh=fresh, **dims), reps=3, warmup=1)
        # useful operations only (4 a state element a position), as benchmark/roofline_hybrid.py counts them
        n_bytes = T * ((C + H) * 2 + di * 4) + state_bytes * (1 if fresh else 2) + (state_bytes if at > 0 else 0)
        bms, by = bound_ms(n_bytes, 4.0 * T * H * P * N, "f32")
        log(f"      {ms:.4f} ms (plain {plain_ms:.4f}, bound {bms:.4f} by {by}, {bms / ms:.3f} of bound)")
        out["ssd_scan"].append(dict(T=T, length=length, snap_at=at, fresh=fresh, heads=H, state=N, max_abs_err=max(
            [err, *errs]), tol=tol, rtol=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by))

    log("[K9 ssd_step] 16 slots, one in three done, vs its plain version; tol 2e-4 of y's and the state's "
        "largest, the conv lanes and a done slot's lanes bit for bit")
    B = 16
    proj = torch.randn(B, C + 2 * H, device=dev, generator=g).to(torch.bfloat16)
    conv_w = (torch.rand(C, K, device=dev, generator=g) - 0.5).to(torch.bfloat16)
    conv_b = (torch.rand(C, device=dev, generator=g) - 0.5).to(torch.bfloat16)
    conv = torch.randn(B, K - 1, C, device=dev, generator=g).to(torch.bfloat16)
    state = torch.randn(B, H, P, N, device=dev, generator=g) * 0.1
    done = torch.arange(B, device=dev) % 3 == 1
    args = (proj[:, :C], proj[:, C:C + H], conv_w, conv_b, A, D, dt_bias)
    wc, ws, gc_, gs = conv.clone(), state.clone(), conv.clone(), state.clone()
    want = ssd.ssd_step_plain(*args, wc, ws, done, **dims)
    got = ssd.ssd_step(*args, gc_, gs, done, **dims)
    torch.cuda.synchronize()
    err, tol = close("B=16 y", got, want, 2e-4)
    serr = close("B=16 state", gs, ws, 2e-4)[0]
    if not (torch.equal(gc_, wc) and torch.equal(gs[done], state[done]) and torch.equal(gc_[done], conv[done])
            and not got[done].any()):
        raise AssertionError("K9: a conv lane differs from the plain version's, or a done slot's lanes moved")
    ms = time_ms(lambda: ssd.ssd_step(*args, gc_, gs, done, **dims))
    plain_ms = time_ms(lambda: ssd.ssd_step_plain(*args, wc, ws, done, **dims), reps=3, warmup=1)
    live = int((~done).sum())
    n_bytes = live * (2 * state_bytes + 2 * (K - 1) * C * 2 + (C + H) * 2 + di * 4) + (B - live) * di * 4
    bms, by = bound_ms(n_bytes, 4.0 * live * H * P * N, "f32")
    log(f"      {ms:.4f} ms (plain {plain_ms:.4f}, bound {bms:.4f} by {by}, {bms / ms:.3f} of bound; {live} live lanes)")
    out["ssd_step"].append(dict(B=B, live=live, heads=H, state=N, max_abs_err=max(err, serr), tol=tol, rtol=0.0, ms=ms,
                                plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by))

    log("[ssd_conv] the span's conv and SiLU (Triton) vs its plain version; within one bf16 step")
    for W in (512, 1):
        win = torch.randn(K - 1 + W, C, device=dev, generator=g).to(torch.bfloat16)
        got, want = ssd.ssd_conv(win, conv_w, conv_b), ssd.ssd_conv_plain(win, conv_w, conv_b)
        torch.cuda.synchronize()
        err = check_close(f"W={W} C={C}", got, want, 1e-6, 2 ** -7)
        ms = time_ms(lambda: ssd.ssd_conv(win, conv_w, conv_b))
        plain_ms = time_ms(lambda: ssd.ssd_conv_plain(win, conv_w, conv_b), reps=3, warmup=1)
        bms, by = bound_ms((K - 1 + 2 * W) * C * 2 + C * (K + 1) * 2, 2.0 * W * C * K, "f32")
        log(f"      {ms:.4f} ms (plain {plain_ms:.4f}, bound {bms:.4f} by {by})")
        out["ssd_conv"].append(dict(W=W, C=C, max_abs_err=err, tol=1e-6, rtol=2 ** -7, ms=ms, plain_ms=plain_ms,
                                    library_ms=None, bound_ms=bms, bound_by=by))

    log("[gated_norm] the gated RMSNorm (Triton) vs its plain version, z a view of the in_proj row; "
        "within one bf16 step")
    for rows in (512, 16):
        y = torch.randn(rows, di, device=dev, generator=g)
        zrow = torch.randn(rows, C + di + H, device=dev, generator=g).to(torch.bfloat16)
        w = (torch.rand(di, device=dev, generator=g) + 0.5).to(torch.bfloat16)
        got, want = ssd.gated_norm(y, zrow[:, :di], w, G, 1e-5), ssd.gated_norm_plain(y, zrow[:, :di], w, G, 1e-5)
        torch.cuda.synchronize()
        err = check_close(f"rows={rows} C={di} groups={G}", got, want, 1e-5, 2 ** -7)
        ms = time_ms(lambda: ssd.gated_norm(y, zrow[:, :di], w, G, 1e-5))
        plain_ms = time_ms(lambda: ssd.gated_norm_plain(y, zrow[:, :di], w, G, 1e-5), reps=3, warmup=1)
        bms, by = bound_ms(rows * di * (4 + 2 + 2) + di * 2, 0.0, "f32")
        log(f"      {ms:.4f} ms (plain {plain_ms:.4f}, bound {bms:.4f} by {by})")
        out["gated_norm"].append(dict(rows=rows, C=di, groups=G, max_abs_err=err, tol=1e-5, rtol=2 ** -7, ms=ms,
                                      plain_ms=plain_ms, library_ms=None, bound_ms=bms, bound_by=by))
    return out


def hybrid_replays() -> dict:
    """The launches of one prefill-chunk replay and one decode-step replay of a hybrid of the
    47B's block pattern (98 blocks, 45 Mamba-2) at small widths, int8 projections and cache,
    each held to the device trace (``traced``) and to the blocks: one K8, conv and gated norm a
    Mamba-2 block in the chunk, one K9 and gated norm in the step."""
    import torch

    from llama_x_tpu_torch.adapters.quantize import quantize_linear
    from llama_x_tpu_torch.models import nemotron_h as nh
    from llama_x_tpu_torch.serve import continuous as cs

    pattern = json.loads(HYBRID_CONFIG.read_text())["hybrid_override_pattern"]
    cfg = nh.HybridConfig(embed_dim=256, pattern=pattern, head_dim=64, num_heads=4, num_kv_heads=2,
                          intermediate_dim=512, mamba_heads=8, mamba_head_dim=64, ssm_state=128, n_groups=2,
                          max_seq_len=512, vocab_size=512)
    model = nh.init(cfg, seed=1, device="cuda")
    quantize_linear(model.layers, "int8")
    model.config = cfg.replace(dynamic_int8_act=True)
    n_m = pattern.count("M")
    slots = 4
    state = cs.init_state(model.config, slots, torch.int8, "cuda", None, model.tok_embeddings.dtype)
    inputs = cs.AdmitBuffers(model, state[0])
    chunk = torch.randint(0, cfg.vocab_size, (64,), generator=torch.Generator().manual_seed(3)).tolist()
    params = (*cs.sampling_tensors([(0.0, 0, 1.0, 0.0)] * slots, "cuda"),
              torch.full((slots,), -1, dtype=torch.int64, device="cuda"),
              torch.full((slots,), 8, dtype=torch.int64, device="cuda"))
    runs = {}
    for what, fn, want in (
            ("prefill chunk", lambda: cs.prefill_chunk(model, inputs, chunk, 0, 64, state=state, slot=1),
             dict(ssd_scan=n_m, ssd_conv=n_m, gated_norm=n_m, ssd_step=0)),
            ("decode step", lambda: cs.decode_rows(model, state, 1, None, *params),
             dict(ssd_step=n_m, gated_norm=n_m, ssd_scan=0, ssd_conv=0))):
        fn()  # the capture
        t = traced(f"hybrid {what} replay", fn)
        got = {k: t["launches"][k] for k in want}
        log(f"    one {what} replay at {len(pattern)} blocks ({n_m} Mamba-2): {json.dumps(got)}; every counted "
            f"launch {json.dumps({k: v for k, v in t['launches'].items() if v})}")
        if got != want:
            raise AssertionError(f"hybrid {what} replay: launches {got}, want {want}")
        runs[f"hybrid {what}"] = dict(launches=t["launches"], traced=t["traced"])
    return runs


def phase_hybrid() -> tuple[dict, dict]:
    """-> ({kernel name: per-shape records}, {run name: {"launches", "traced"}})."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(23)
    kern = ssd_kernel_cases(g)
    gc.collect()
    torch.cuda.empty_cache()
    return kern, hybrid_replays()


KERNELS = {
    # name: (source, TPU kernel it replaces, index of the primary shape in the kernel phase)
    "int8_mm_dequant_nt": ("llama_x_tpu_torch/csrc/int8_mm.cu", "llama_x_tpu/ops/int8_mm.py:40", 6),
    "int8_mm_dequant": ("llama_x_tpu_torch/csrc/int8_mm_kn.cu", "llama_x_tpu/ops/int8_mm.py:40", 1),
    "flash_attention": ("llama_x_tpu_torch/csrc/flash_attention.cu", "llama_x_tpu/ops/flash_attention.py:188", 0),
    "flash_attention_offsets": ("llama_x_tpu_torch/csrc/flash_attention.cu",
                                "llama_x_tpu/ops/flash_attention.py:188", 0),
    "flash_attention_bwd": ("llama_x_tpu_torch/csrc/flash_attention_bwd.cu",
                            "llama_x_tpu/ops/flash_attention.py:369", 1),
    # the ring forms: the primary shape is the causal block below the diagonal (4096, 0)
    "flash_attention_ring": ("llama_x_tpu_torch/csrc/flash_attention.cu",
                             "llama_x_tpu/ops/flash_attention.py:188", 1),
    "flash_attention_bwd_ring": ("llama_x_tpu_torch/csrc/flash_attention_bwd.cu",
                                 "llama_x_tpu/ops/flash_attention.py:369", 1),
    "decode_attention": ("llama_x_tpu_torch/csrc/decode_attention.cu", "llama_x_tpu/ops/decode_attention.py:44", 0),
    "decode_attention_int8": ("llama_x_tpu_torch/csrc/decode_attention.cu",
                              "llama_x_tpu/ops/decode_attention.py:44", 0),
    "flash_probe": ("llama_x_tpu_torch/csrc/flash_probe.cu", "tools/probe_flash.py:94", 0),
    # no TPU kernel: the JAX package leaves its rowwise quantizer to XLA
    "quantize_rows": ("llama_x_tpu_torch/csrc/quantize_rows.cu", "none (llama_x_tpu/ops/int8.py:quantize_int8_rowwise)",
                      0),
    # no TPU kernel: the JAX package has no state-space layer
    "ssd_scan": ("llama_x_tpu_torch/csrc/ssd_scan.cu", "none", 0),
    "ssd_step": ("llama_x_tpu_torch/csrc/ssd_step.cu", "none", 0),
    "ssd_conv": ("llama_x_tpu_torch/ops/ssd.py (Triton)", "none", 0),
    "gated_norm": ("llama_x_tpu_torch/ops/ssd.py (Triton)", "none", 0),
}


def record(kern: dict, runs: dict) -> dict:
    out = []
    for name, (source, replaces, primary) in KERNELS.items():
        if name not in kern:  # a phase left out (``--only``)
            continue
        shapes = kern[name]
        p = shapes[primary]
        per_run = {kind: run["launches"].get(name, 0) for kind, run in runs.items()}
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=sum(per_run.values()),
            launches_per_run=per_run, max_abs_err=p["max_abs_err"], tol=p["tol"], rtol=p.get("rtol", 0.0), ms=p["ms"],
            plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"], library_ms=p["library_ms"],
            shape={k: v for k, v in p.items() if k not in ("max_abs_err", "tol", "rtol", "ms", "plain_ms",
                                                            "bound_ms", "bound_by", "library_ms", "errs",
                                                            "tflops", "tops", "tiles", "split", "device_ms",
                                                            "library_device_ms", "host_ms", "visible",
                                                            "lse_max_abs_err")},
        ))
    return {"kernels": out}


class PhaseTimer:
    """Seconds between successive phase ends, by phase name (the time budget's account)."""

    def __init__(self, t0: float):
        self.last, self.seconds = t0, {}

    def __call__(self, name: str, result):
        now = time.perf_counter()
        self.seconds[name] = round(now - self.last, 1)
        self.last = now
        return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import llama_x_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)

    smi = nvidia_smi()
    log(smi)
    t0 = time.perf_counter()
    timer = PhaseTimer(t0)
    timer("build", phase_build())
    if sys.argv[1:] == ["--only", "hybrid"]:
        kern, runs = timer("hybrid", phase_hybrid())
        log(f"[phase seconds] {json.dumps(timer.seconds)}")
        log(smi)
        log(json.dumps(record(kern, runs)))
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0
    kern = timer("kernels", phase_kernels())
    runs, serving_model = timer("main path", phase_main_path())
    runs["admissions"] = timer("admissions", phase_admissions(serving_model))
    # the serving phases run on the first SERVING_LAYERS layers of the int8 model (a depth cut)
    serving_cut = cut_of(serving_model, SERVING_LAYERS)
    runs["continuous"] = timer("continuous", phase_continuous(serving_cut))
    runs.update(timer("speculative", phase_speculative(serving_cut)))
    runs.update(timer("hf and http", phase_hf_and_http(serving_cut)))
    del serving_model, serving_cut
    gc.collect()
    torch.cuda.empty_cache()
    runs["train"] = timer("train", phase_train())
    gc.collect()
    torch.cuda.empty_cache()
    runs["train_graph"] = timer("train graph", phase_train_graph())
    gc.collect()
    torch.cuda.empty_cache()
    runs["probe"] = timer("probe", phase_probe())
    runs["audio"] = timer("audio", phase_audio())
    gc.collect()
    torch.cuda.empty_cache()
    trunk = build_trunk()
    runs["vision"] = timer("vision", phase_vision(trunk))
    runs["omni"] = timer("omni", phase_omni(trunk))
    runs.update(timer("evals", phase_evals(trunk)))
    del trunk
    gc.collect()
    torch.cuda.empty_cache()
    runs["real_data"] = timer("real data", phase_real_data())
    runs["entry_points"] = timer("entry points", phase_entry_points())
    runs["learned_tasks"] = timer("learned tasks", phase_learned_tasks())
    runs["trainer_pieces"] = timer("trainer pieces", phase_trainer_pieces())
    gc.collect()
    torch.cuda.empty_cache()
    runs["cp"] = timer("cp", phase_cp())
    gc.collect()
    torch.cuda.empty_cache()
    runs["5b"] = timer("5b", phase_5b())
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_kern, hybrid_runs = timer("hybrid", phase_hybrid())
    kern.update(hybrid_kern)
    runs.update(hybrid_runs)
    log(f"[phase seconds] {json.dumps(timer.seconds)}")
    rec = record(kern, runs)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(smi)
    log(json.dumps(rec))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
