"""int8 x int8 GEMMs with a fused dequant epilogue, in the two layouts of the right
operand: ``int8_mm_dequant_nt`` takes b as [N, K] (kernel K1, ``csrc/int8_mm.cu``),
``int8_mm_dequant`` takes b as [K, N] (kernel K4, ``csrc/int8_mm_kn.cu``).

Port of llama_x_tpu/ops/int8_mm.py: the Pallas ``_kernel`` as reached through
``int8_mm_dequant_nt_pallas`` (``b_nk=True``) and through ``int8_mm_dequant_pallas``.
Two forms exist so that the frozen int8 base keeps ONE stored layout, ``int_data
[out, in]``: the forward reads it as [N, K] (NT), the input gradient reads the same
bytes as [K = out, N = in] (KN), and no transposed copy of the base is ever made. The
TPU versions fell back to XLA when a shape was not a tile multiple; these kernels
mask their own ragged tile edges, so every shape whose int8 rows are 16-byte
multiples runs them (K % 16 for a and for an NT b; N % 16 for a KN b).

Both sum exactly in int32 and multiply ``float(acc) * row_scale[m] * col_scale[n]``
in that order, so kernel and plain version agree bit for bit. On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.utils import build

# the int32 sum of K products of int8 values in [-127, 127] cannot overflow up to here;
# the Llama-3 vocabulary (128256, the contraction of the CE head's dH product) fits
MAX_K = (2**31 - 1) // (127 * 127)


def int8_mm_dequant_nt_plain(a_i8, b_nk_i8, row_scale, col_scale, out_dtype=torch.bfloat16):
    """a_i8 [M, K] x b_nk_i8 [N, K] -> [M, N] out_dtype:
    float32(exact integer sum) * row_scale[m] * col_scale[n].

    The sum is exact: int32 on the CPU; on the card, where integer matmul is not
    offered, float64, which is exact while 127^2 * K < 2^53."""
    acc_dtype = torch.int32 if a_i8.device.type == "cpu" else torch.float64
    acc = torch.matmul(a_i8.to(acc_dtype), b_nk_i8.to(acc_dtype).T)
    out = acc.to(torch.float32) * row_scale.reshape(-1, 1).float() * col_scale.reshape(1, -1).float()
    return out.to(out_dtype)


def _launch(wrapper, entry: str, a_i8, b_i8, b_nk: bool, row_scale, col_scale, out_dtype):
    """Checks shared by K1 and K4, then the launch of ``entry`` counted on ``wrapper``."""
    M, K = a_i8.shape
    N, b_k = (b_i8.shape[0], b_i8.shape[1]) if b_nk else (b_i8.shape[1], b_i8.shape[0])
    if a_i8.dtype != torch.int8 or b_i8.dtype != torch.int8:
        raise TypeError(f"int8 operands required, got {a_i8.dtype} x {b_i8.dtype}")
    if b_k != K or K % 16 or (not b_nk and N % 16):
        raise ValueError(f"K mismatch, or an int8 row that is no 16-byte multiple: a {tuple(a_i8.shape)}, "
                         f"b {tuple(b_i8.shape)} ({'[N, K]' if b_nk else '[K, N]'})")
    if K > MAX_K:
        raise ValueError(f"K={K}: 127^2 * K would overflow the int32 sum (K <= {MAX_K})")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
    if not (a_i8.is_cuda and b_i8.is_cuda and a_i8.device == b_i8.device):
        raise ValueError("operands must lie on one CUDA device")
    a = a_i8.contiguous()
    b = b_i8.contiguous()
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("int8 operands must be 16-byte aligned")
    rs = row_scale.reshape(-1).to(device=a.device, dtype=torch.float32).contiguous()
    cs = col_scale.reshape(-1).to(device=a.device, dtype=torch.float32).contiguous()
    if rs.numel() != M or cs.numel() != N:
        raise ValueError(f"scales {rs.numel()}/{cs.numel()} do not match M={M}, N={N}")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    lib = build.load_library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    wrapper.launches += 1
    build.check(
        getattr(lib, entry)(
            a.data_ptr(), b.data_ptr(), rs.data_ptr(), cs.data_ptr(), out.data_ptr(),
            M, N, K, int(out_dtype == torch.float32), stream,
        ),
        wrapper.__name__,
    )
    return out


def int8_mm_dequant_nt(a_i8, b_nk_i8, row_scale, col_scale, out_dtype=torch.bfloat16):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if a_i8.device.type == "cpu":
        return int8_mm_dequant_nt_plain(a_i8, b_nk_i8, row_scale, col_scale, out_dtype)
    return _launch(int8_mm_dequant_nt, "lxt_int8_mm_dequant_nt", a_i8, b_nk_i8, True, row_scale, col_scale, out_dtype)


int8_mm_dequant_nt.launches = 0


def int8_mm_dequant_plain(a_i8, b_kn_i8, row_scale, col_scale, out_dtype=torch.bfloat16):
    """a_i8 [M, K] x b_kn_i8 [K, N] -> [M, N] out_dtype, the KN form of
    ``int8_mm_dequant_nt_plain``: the same exact sum and epilogue order."""
    return int8_mm_dequant_nt_plain(a_i8, b_kn_i8.T, row_scale, col_scale, out_dtype)


def int8_mm_dequant(a_i8, b_kn_i8, row_scale, col_scale, out_dtype=torch.bfloat16):
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if a_i8.device.type == "cpu":
        return int8_mm_dequant_plain(a_i8, b_kn_i8, row_scale, col_scale, out_dtype)
    return _launch(int8_mm_dequant, "lxt_int8_mm_dequant_kn", a_i8, b_kn_i8, False, row_scale, col_scale, out_dtype)


int8_mm_dequant.launches = 0
