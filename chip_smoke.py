#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (llama_x_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and prints
no result line):
1. build: the card's name and power limit (nvidia-smi), the nvcc build of every
   kernel from csrc/ with its time and the ptxas register / spill summary;
2. kernels: each hand-written kernel against its plain PyTorch version on the card,
   at the serving and training paths' shapes, with the tolerance stated beside it,
   timed with CUDA events beside the plain version, a PyTorch yardstick (never called
   by the port) and the least time the card could take (bound);
3. serving main path: ``generate`` at Llama-3.1-8B width (32 layers) from seeded
   on-device weights, B 4, ragged byte-tokenized prompts padded to 512, 64 new
   tokens: bf16 weights with a bf16 cache, then int8 weights with dynamic int8
   activations and an int8 cache; each run's kernel launch counts are reset before it
   and must be non-zero after it;
4. kernel path against plain path: on a 2-layer cut of the same weights, prefill and
   first-decode logits of the kernels and of their plain versions agree;
5. training main path: QLoRA optimizer steps at Llama-3.1-8B width (32 layers, int8
   base, LoRA r 8 on every projection, frozen bf16 head on the int8 kernels, dynamic
   int8 activations and input gradients, fused CE in 8 chunks, per-block activation
   checkpointing) on packed byte-token rows with segment ids at S 4096, microbatch 1,
   accumulation 2, AdamW, 4 steps on one repeated step batch: all four training
   kernels must launch, losses and grad norms be finite, the loss fall, the adapters
   move and the int8 base stay as it was; then one step under the profiler, with the
   rowwise quantizer's calls bracketed so that its device time is read apart;
6. training kernel path against plain path: loss and adapter gradients of one
   microbatch on a 2-layer cut of the trained weights, through the kernels and through
   their plain versions.

Every shape's numbers are printed as the phases run. The second-to-last line of
stdout is the kernels' JSON record (primary shape of each kernel, launches on the
main path), the last line ``{"ok": true, "device": {...}}``. Needs a CUDA card;
fails without one.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}  # dense tensor-core rates, same source

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


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    """Per element |got - want| <= atol + rtol |want|; returns the max abs error."""
    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    excess = float((diff - rtol * ref).max())
    err = float(diff.max())
    status = "ok" if excess <= atol else "FAIL"
    log(f"    {name}: max_abs_err {err:.3e}, max(|err| - {rtol:.2e}|ref|) {excess:.3e} (atol {atol:.1e}) {status}")
    if not excess <= atol:
        raise AssertionError(f"{name}: |err| - {rtol}|ref| reaches {excess} > atol {atol}")
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
    for line in build.build_log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
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
    # contraction over the vocabulary
    return int8_mm_cases(mm.int8_mm_dequant_nt, mm.int8_mm_dequant_nt_plain, True, g, [
        (M, N, K, bf16) for M in (4, 2048, 4096) for N, K in ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))
    ] + [(512, 128256, 4096, f32), (512, 4096, 128256, f32)])


def int8_mm_cases(kernel, plain, b_nk: bool, g, cases) -> list[dict]:
    """One int8 GEMM form at (M, N, K, out dtype) cases: bit for bit against its plain
    version (tol 0), timed beside bound, plain and torch._int_mm."""
    import torch

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
        log(f"      {ms:.4f} ms (plain {plain_ms:.3f}, _int_mm {lib_ms}, bound {bms:.4f} by {by})")
        shapes.append(dict(M=M, N=N, K=K, out=str(out_dtype).split(".")[1], max_abs_err=err, tol=0.0, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by))
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
    # other way round (the JAX package's [D, V] head reads its logits in this form)
    return int8_mm_cases(mm.int8_mm_dequant, mm.int8_mm_dequant_plain, False, g, [
        (4096, 14336, 4096, bf16), (4096, 4096, 14336, bf16), (4096, 4096, 4096, bf16), (4096, 4096, 1024, bf16),
        (300, 4112, 1040, bf16), (512, 4096, 128256, f32), (512, 128256, 4096, f32)])


def packed_segments(S: int):
    """[1, S] sorted segment ids of 8 packed documents (the same ids wherever they are used)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(8)
    return torch.sort(torch.randint(1, 9, (1, S), device="cuda", generator=g), dim=1).values.to(torch.int32)


def _attn_inputs(g, B, S, Hq, Hkv, D):
    import torch

    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)
    return mk(B, S, Hq, D), mk(B, S, Hkv, D), mk(B, S, Hkv, D)


def phase_k2():
    import torch
    import torch.nn.functional as F

    from llama_x_tpu_torch.ops import flash_attention as fa
    from llama_x_tpu_torch.ops.attention import MaskInfo, make_attention_mask

    log("[K2 flash_attention fwd] vs plain; tol: out 3e-2 (bf16 out, P rounded to bf16 "
        "at other maxima), lse 2e-3 (fp32 sums in another order)")
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
    ]
    shapes = []
    for name, B, S, mi in cases:
        q, k, v = _attn_inputs(g, B, S, Hq, Hkv, D)
        out, lse = fa.flash_fwd_with_lse(q, k, v, mi)
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_fwd_plain(q, k, v, mi)
        check(f"{name} out", max_err(out, ref), 3e-2)
        check(f"{name} lse", max_err(lse, ref_lse), 2e-3)
        ms = time_ms(lambda: fa.flash_fwd_with_lse(q, k, v, mi))
        plain_ms = time_ms(lambda: fa.flash_fwd_plain(q, k, v, mi), reps=3, warmup=1)
        mask = make_attention_mask(mi, S, S, B, device=q.device)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if mi.prefix_len is None and mi.segment_ids is None:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib_ms = maybe_ms(lib)
        visible = float(mask.expand(B, 1, S, S).sum())
        n_bytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D) + 4 * B * Hq * S
        bms, by = bound_ms(n_bytes, 4 * D * Hq * visible, "bf16")
        log(f"      {ms:.4f} ms (plain {plain_ms:.3f}, sdpa {lib_ms}, bound {bms:.4f} by {by})")
        shapes.append(dict(case=name, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, max_abs_err=max_err(out, ref),
                           lse_max_abs_err=max_err(lse, ref_lse), tol=3e-2, ms=ms, plain_ms=plain_ms,
                           library_ms=lib_ms, bound_ms=bms, bound_by=by))
        del q, k, v, out, lse, ref, ref_lse, mask, qt, kt, vt
        torch.cuda.empty_cache()
    return shapes


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
        ("causal S=4096", S, 32, 8, 128, MaskInfo(causal=True)),
        ("packed segments S=4096", S, 32, 8, 128, MaskInfo(causal=True, segment_ids=segs)),
        ("prefix-LM 2000 S=4096", S, 32, 8, 128,
         MaskInfo(causal=True, prefix_len=torch.full((1,), 2000, dtype=torch.int32, device="cuda"))),
        ("ragged causal S=37", 37, 32, 8, 128, MaskInfo(causal=True)),
        ("causal S=2048 D=64", 2048, 32, 8, 64, MaskInfo(causal=True)),
    ]
    shapes = []
    for name, S, Hq, Hkv, D, mi in cases:
        B = 1
        q, k, v = _attn_inputs(g, B, S, Hq, Hkv, D)
        do = torch.randn(B, S, Hq, D, device="cuda", generator=g).to(torch.bfloat16)
        out, lse = fa.flash_fwd_with_lse(q, k, v, mi)
        got = fa.flash_bwd_from_res(q, k, v, out, lse, do, mi)
        torch.cuda.synchronize()
        want = fa.flash_bwd_plain(q, k, v, out, lse, do, mi)
        errs, atols = {}, {}
        for n, a, b in zip(("dq", "dk", "dv"), got, want):
            atols[n], rtol = fa.flash_bwd_tolerance(b)
            errs[n] = check_close(f"{name} {n}", a, b, atols[n], rtol)
        del want
        ms = time_ms(lambda: fa.flash_bwd_from_res(q, k, v, out, lse, do, mi), reps=5, warmup=1)
        plain_ms = time_ms(lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, mi), reps=2, warmup=1)
        mask = make_attention_mask(mi, S, S, B, device=q.device)
        visible = float(mask.expand(B, 1, S, S).sum())
        del mask
        lib_ms = sdpa_backward_ms(F, q, k, v, do, mi)
        # inputs q, k, v, out, dO, lse read once; dq, dk, dv written once
        n_bytes = 2 * (4 * B * S * Hq * D + 4 * B * S * Hkv * D) + 4 * B * Hq * S
        bms, by = bound_ms(n_bytes, 10 * D * Hq * visible, "bf16")
        log(f"      {ms:.4f} ms (plain {plain_ms:.3f}, sdpa backward {lib_ms}, bound {bms:.4f} by {by})")
        shapes.append(dict(case=name, B=B, S=S, Hq=Hq, Hkv=Hkv, D=D, max_abs_err=max(errs.values()), errs=errs,
                           tol=max(atols.values()), rtol=rtol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bms, bound_by=by))
        del q, k, v, do, out, lse, got
        torch.cuda.empty_cache()
    return shapes


def sdpa_backward_ms(F, q, k, v, do, mi):
    """The yardstick of K5: the backward of one scaled_dot_product_attention call on the
    same inputs (timed here, never called by the port), or None where it is not offered."""
    import torch

    from llama_x_tpu_torch.ops.attention import make_attention_mask

    B, S = q.shape[:2]
    leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    try:
        if mi.prefix_len is None and mi.segment_ids is None:
            out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
        else:
            mask = make_attention_mask(mi, S, S, B, device=q.device)
            out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
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
    # lens 63/64/65 straddle the kernel's 64-position tile
    for Sq, last in ((1, [1, 513, 2048, 4096]), (5, [1, 513, 2048, 4096]), (5, [63, 64, 65, 4096])):
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
            lib_ms = None
            if kind == "bf16":
                pos = torch.arange(S_max, device="cuda")
                mask = (pos[None, None, :] < lens[:, :, None])[:, None]  # [B, 1, Sq, S]
                lib_ms = maybe_ms(lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k, v, attn_mask=mask, enable_gqa=True))
            n_bytes += 2 * 2 * B * Sq * Hq * D + 4 * B * Sq
            bms, by = bound_ms(n_bytes, 4 * D * window, "bf16")
            log(f"      {ms:.4f} ms (plain {plain_ms:.3f}, sdpa {lib_ms}, bound {bms:.4f} by {by})")
            shapes[kind].append(dict(Sq=Sq, lens=lens.tolist(), B=B, S_max=S_max, max_abs_err=err, tol=K3_ATOL,
                                     rtol=K3_RTOL, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                                     bound_by=by))
    return shapes


def phase_kernels():
    """Returns {kernel name: per-shape records}."""
    return {"int8_mm_dequant_nt": phase_k1(), "int8_mm_dequant": phase_k4(), "flash_attention": phase_k2(),
            "flash_attention_bwd": phase_k5(), **{
        ("decode_attention" if kind == "bf16" else "decode_attention_int8"): recs
        for kind, recs in phase_k3().items()
    }}


# ---------------------------------------------------------------------------
# phases 3 and 4: the main path at 8B width, and kernel path against plain path
# ---------------------------------------------------------------------------


def counted():
    from llama_x_tpu_torch.ops import decode_attention as da
    from llama_x_tpu_torch.ops import flash_attention as fa
    from llama_x_tpu_torch.ops import int8_mm as mm

    return {"int8_mm_dequant_nt": mm.int8_mm_dequant_nt, "int8_mm_dequant": mm.int8_mm_dequant,
            "flash_attention": fa.flash_fwd_with_lse, "flash_attention_bwd": fa.flash_bwd_from_res,
            "decode_attention": da.decode_attention, "decode_attention_int8": da.decode_attention_int8}


def reset_counts():
    for fn in counted().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counted().items()}


@contextlib.contextmanager
def plain_path():
    """Route the model through the kernels' plain versions (on the card's tensors) by
    swapping the module attributes the model calls; restored on exit."""
    from llama_x_tpu_torch.ops import decode_attention as da
    from llama_x_tpu_torch.ops import flash_attention as fa
    from llama_x_tpu_torch.ops import int8_mm as mm

    swaps = [(mm, "int8_mm_dequant_nt", mm.int8_mm_dequant_nt_plain),
             (mm, "int8_mm_dequant", mm.int8_mm_dequant_plain),
             (fa, "_forward_impl", fa.flash_fwd_plain),
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


NEW_TOKENS = 64


def drive_generate(model, prompt, lens, cache_dtype, need: list[str]) -> dict:
    """The main path: ``generate`` on the ragged batch; counts reset just before and
    read just after; prefill timed apart through ``prefill_start``."""
    import torch

    from llama_x_tpu_torch.models.generate import generate, prefill_start

    generate(model, prompt, max_new_tokens=2, prompt_lens=lens, cache_dtype=cache_dtype)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_start(model, prompt, prompt_lens=lens, cache_dtype=cache_dtype, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = generate(model, prompt, max_new_tokens=NEW_TOKENS, prompt_lens=lens, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = read_counts()
    B = prompt.shape[0]
    if tuple(out.shape) != (B, NEW_TOKENS) or int(out.min()) < 0 or int(out.max()) >= model.config.vocab_size:
        raise AssertionError(f"generate returned {tuple(out.shape)} in [{int(out.min())}, {int(out.max())}]")
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}: {counts}")
    decode_s = total_s - prefill_s
    res = dict(B=B, prompt=int(prompt.shape[1]), new_tokens=NEW_TOKENS, launches=counts, total_s=total_s,
               prefill_ms=prefill_s * 1e3, decode_tok_s=B * (NEW_TOKENS - 1) / decode_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"    generate B={B} P={prompt.shape[1]} +{NEW_TOKENS}: total {total_s:.3f} s, prefill "
        f"{res['prefill_ms']:.1f} ms, decode {res['decode_tok_s']:.1f} tok/s, peak {res['peak_mem_gb']:.2f} GB")
    log(f"    launches {counts}")
    res["decode_profile"] = profile_decode(model, prompt, lens, cache_dtype)
    return res


def profile_decode(model, prompt, lens, cache_dtype, steps: int = 4) -> dict:
    """Device busy share and the kernels that take the device time over a few decode
    steps (torch.profiler, CUDA activity); host wall time around the same window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llama_x_tpu_torch.models.generate import decode_chunk, prefill_start

    _, state = prefill_start(model, prompt, prompt_lens=lens, cache_dtype=cache_dtype, max_new_tokens=NEW_TOKENS)
    _, state = decode_chunk(model, state, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_chunk(model, state, steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return summarize_profile(prof, wall_ms, steps, "decode", "step")


# device items of a trace by the substring of their name: the port's kernels, then PyTorch's own
DEVICE_ITEM_GROUPS = [
    ("int8_mm_nt_kernel", "K1"), ("int8_mm_kn_kernel", "K4"), ("flash_fwd_kernel", "K2"),
    ("flash_bwd_dkv_kernel", "K5 dkv"), ("flash_bwd_dq_kernel", "K5 dq"), ("decode_kernel", "K3"),
    ("nvjet", "library GEMMs"), ("gemm", "library GEMMs"), ("cublas", "library GEMMs"), ("cutlass", "library GEMMs"),
    ("reduce_kernel", "reductions"), ("copy_kernel", "copies and casts"), ("elementwise", "elementwise"),
    ("Memcpy", "memcpy"), ("Memset", "memset"),
]


QUANTIZE_LABEL = "quantize_int8_rowwise"


@contextlib.contextmanager
def labelled_quantizers():
    """Bracket every call of the rowwise quantizer with a profiler range, so that a trace
    can say how much device time its passes take (the name grouping below cannot: the
    quantizer's kernels carry PyTorch's generic names). The quantizer runs inside the
    autograd Functions, outside any graph, so the range holds all of its device work."""
    from torch.profiler import record_function

    from llama_x_tpu_torch.ops import cross_entropy as ce
    from llama_x_tpu_torch.ops import int8 as i8

    inner = i8.quantize_int8_rowwise

    def labelled(x):
        with record_function(QUANTIZE_LABEL):
            return inner(x)

    try:
        i8.quantize_int8_rowwise = ce.quantize_int8_rowwise = labelled
        yield
    finally:
        i8.quantize_int8_rowwise = ce.quantize_int8_rowwise = inner


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

    # a profiler range shows on the device side too, under its own name: not a device item
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.key != QUANTIZE_LABEL]
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
    from llama_x_tpu_torch.models import llama

    c = model.config.replace(num_layers=2)
    cut = llama.Llama(c, model.tok_embeddings, list(model.layers[:2]), model.norm, model.output)
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


def phase_main_path() -> dict:
    import torch

    from llama_x_tpu_torch.generate_cli import GEOMETRIES, build_model
    from llama_x_tpu_torch.models import llama

    prompt, lens = ragged_prompts()
    runs = {}
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
        del model
        torch.cuda.empty_cache()
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


def phase_train() -> dict:
    """The trainer's own pieces, put together as ``train_metamathqa.main`` puts them,
    from the command line a user would give; one step batch is repeated so that the loss
    must fall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.train import cli
    from llama_x_tpu_torch.train.trainer import TrainState, make_train_step

    log("[training main path] Llama-3.1-8B width, 32 layers, int8 base + LoRA r 8, int8 act / dgrad / head, "
        "fused CE x8, checkpointing 'full', packed S 4096, microbatch 1 x accumulation 2, AdamW")
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

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps = []
    for i in range(args.n_steps):
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec = dict(step=i, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), n_tokens=int(m["n_tokens"]),
                   seconds=dt, positions_per_s=positions / dt, label_tokens_per_s=int(m["n_tokens"]) / dt)
        steps.append(rec)
        log(f"    step {i}: loss {rec['loss']:.4f}, grad norm {rec['grad_norm']:.4f}, {dt:.3f} s, "
            f"{rec['positions_per_s']:.0f} positions/s ({rec['label_tokens_per_s']:.0f} label tokens/s)")
        if i == 0:
            missing = [k for k in TRAIN_KERNELS if read_counts()[k] == 0]
            if missing:
                raise AssertionError(f"a training step never launched {missing}: {read_counts()}")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"    launches over {args.n_steps} steps {counts}; peak memory {peak:.2f} GB")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps):
        raise AssertionError(f"non-finite loss or grad norm: {steps}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"the loss did not fall: {[r['loss'] for r in steps]}")
    if base_checksums(model) != sums or not torch.equal(first.int_data, base0):
        raise AssertionError("the int8 base changed during training")
    if torch.equal(first.lora_a, lora_a0) or torch.equal(first.lora_b, lora_b0):
        raise AssertionError("the adapter tensors did not move")
    if any(counts[k] % args.n_steps for k in TRAIN_KERNELS):
        raise AssertionError(f"launch counts are not the same every step: {counts}")

    with labelled_quantizers(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_rec = summarize_profile(prof, wall_ms, 1, "training", "step")
    q_ms, q_calls = label_device_ms(prof, QUANTIZE_LABEL)
    prof_rec["quantize_int8_rowwise_ms_per_step"], prof_rec["quantize_int8_rowwise_calls_per_step"] = q_ms, q_calls
    log(f"      rowwise quantizer: {q_calls} calls/step, device "
        + ("not measured (the trace ties no device time to its ranges)" if q_ms is None else
           f"{q_ms:.3f} ms/step, {q_ms / prof_rec['device_busy_ms_per_step']:.3f} of busy"))
    del prof
    two_path = compare_train_paths(model, batch)
    return dict(flags=TRAIN_FLAGS, steps=steps, launches=counts, launches_per_step={k: v // args.n_steps for k, v in counts.items()},
                peak_mem_gb=peak, profile=prof_rec, two_path=two_path)


def compare_train_paths(model, batch) -> dict:
    """Loss and adapter gradients of one microbatch on a 2-layer cut of the trained
    weights (lora_b is no longer zero, so every adapter gradient is live), through the
    kernels and through their plain versions.

    K1 and K4 equal their plain versions bit for bit, so the two paths part only at
    the flash kernels, whose bf16 outputs lie an ulp apart here and there; downstream a
    few activations and gradients then round to the neighbouring int8 code (1/127 of a
    row's largest entry). Loss within 2^-10 of its size (a quarter of a bf16 ulp of the
    bf16 hidden states it is computed from); each adapter gradient tensor within 2^-6 of
    its norm in the L2 sense (the flash backward's own per-element tolerance is 2^-7),
    which a wrong mask, a lost ln2 or a dropped group member would miss by a factor."""
    import torch

    from llama_x_tpu_torch import train_metamathqa as entry
    from llama_x_tpu_torch.models import llama

    c = model.config.replace(num_layers=2)
    cut = llama.Llama(c, model.tok_embeddings, list(model.layers[:2]), model.norm, model.output)
    mb = {k: torch.as_tensor(v[0]).cuda() for k, v in batch.items()}
    named = [(n, p) for n, p in cut.named_parameters() if p.requires_grad and "lora_" in n]
    params = [p for _, p in named]

    def run():
        loss, _ = entry.loss_fn(cut, mb)
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
    check(f"training 2-layer loss, kernels {loss_k:.5f} vs plain {loss_p:.5f}", abs(loss_k - loss_p), tol)
    worst, worst_name = 0.0, ""
    for (name, _), a, b in zip(named, grads_k, grads_p):
        rel = float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))
        if rel > worst:
            worst, worst_name = rel, name
    check(f"training 2-layer adapter gradients ({len(named)} tensors), worst relative L2 error ({worst_name})",
          worst, 2**-6)
    return dict(loss_kernels=loss_k, loss_plain=loss_p, loss_tol=tol, grad_rel_l2_worst=worst, grad_rel_l2_tol=2**-6)


# ---------------------------------------------------------------------------
# the record
# ---------------------------------------------------------------------------

KERNELS = {
    # name: (source, TPU kernel it replaces, index of the primary shape in the kernel phase)
    "int8_mm_dequant_nt": ("llama_x_tpu_torch/csrc/int8_mm.cu", "llama_x_tpu/ops/int8_mm.py:40", 6),
    "int8_mm_dequant": ("llama_x_tpu_torch/csrc/int8_mm_kn.cu", "llama_x_tpu/ops/int8_mm.py:40", 1),
    "flash_attention": ("llama_x_tpu_torch/csrc/flash_attention.cu", "llama_x_tpu/ops/flash_attention.py:188", 0),
    "flash_attention_bwd": ("llama_x_tpu_torch/csrc/flash_attention_bwd.cu",
                            "llama_x_tpu/ops/flash_attention.py:369", 1),
    "decode_attention": ("llama_x_tpu_torch/csrc/decode_attention.cu", "llama_x_tpu/ops/decode_attention.py:44", 0),
    "decode_attention_int8": ("llama_x_tpu_torch/csrc/decode_attention.cu",
                              "llama_x_tpu/ops/decode_attention.py:44", 0),
}


def record(kern: dict, runs: dict) -> dict:
    out = []
    for name, (source, replaces, primary) in KERNELS.items():
        shapes = kern[name]
        p = shapes[primary]
        per_run = {kind: run["launches"][name] for kind, run in runs.items()}
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=sum(per_run.values()),
            launches_per_run=per_run, max_abs_err=p["max_abs_err"], tol=p["tol"], rtol=p.get("rtol", 0.0), ms=p["ms"],
            plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"], library_ms=p["library_ms"],
            shape={k: v for k, v in p.items() if k not in ("max_abs_err", "tol", "rtol", "ms", "plain_ms",
                                                            "bound_ms", "bound_by", "library_ms", "errs")},
        ))
    return {"kernels": out}


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
    phase_build()
    kern = phase_kernels()
    runs = phase_main_path()
    runs["train"] = phase_train()
    rec = record(kern, runs)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(smi)
    log(json.dumps(rec))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
