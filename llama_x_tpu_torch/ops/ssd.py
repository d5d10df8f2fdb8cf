"""The state-space duality (SSD) scan of a Mamba-2 layer: K8, the chunked scan over a span of
one row's positions (``csrc/ssd_scan.cu``), and K9, the one-token update of every slot
(``csrc/ssd_step.cu``).

No TPU kernel corresponds: the JAX package has no state-space layer. Both kernels were
written for the hybrid decoder of ``models/nemotron_h.py`` (Nemotron-H), served through
``serve/continuous.py``.

The recurrence, per head h of P channels over a state of N, its group g = h // (H / G):

    dt_t = softplus(dt_raw_t + dt_bias)          (no clamp: time_step_limit (0, inf))
    S_t  = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T  (A = -exp(A_log) < 0; S [P, N], f32)
    y_t  = S_t C_t + D x_t

K8 computes it over a span in chunks of ``SSD_CHUNK`` positions: within a chunk the
quadratic (dual) form with the decay exp(cum_t - cum_s) of the chunk's cumulative dt A, the
state carried across chunks. Its operands: ``xbc`` [T, H P + 2 G N], the conv's output
(x | B | C) of the span; ``dt`` [T, H], a view of the input projection (rows ``dt_stride``
apart); the lanes ``state`` [lanes, H, P, N] f32 of the layer, of which it reads and writes
lane ``slot`` (a device scalar; ``fresh``: the span starts the sequence, from a zero state).
Only the first ``length`` positions (a device scalar) move the state: the pad positions after
them take dt = 0, so the final state is the one at ``length``. Where ``snap_at`` (a device
scalar) lies in [1, T], the state after that many positions goes to ``snap_out`` [H, P, N]:
the prefix cache's snapshot, taken in the same pass. y [T, H, P] f32.

Two Triton passes run beside K8 and K9 in a Mamba-2 layer: ``ssd_conv``, the span's causal
depthwise conv with its SiLU (K8's input), and ``gated_norm``, the RMSNorm over groups of
y * SiLU(z) (the output projection's input); each is one elementwise or row-reduction pass
with a plain version and a launch count of its own, so a trace names their time.

K9 steps every slot by one token: the causal depthwise conv over the slot's conv state (the
last K - 1 inputs, bf16) and the new input, SiLU, then the state update and y, in place; a
slot whose ``done`` is set is left as it is and reads y = 0.

Beside each kernel, its plain version (the CPU path of its wrapper; a CUDA tensor launches
the kernel or raises): ``ssd_scan_plain`` runs the kernel's chunked arithmetic in PyTorch,
``ssd_step_plain`` the step. Launch counts: ``ssd_scan.launches``, ``ssd_step.launches``;
for their rooflines K8 also credits the positions it scanned and its fresh launches
(``ssd_scan.scanned``, ``ssd_scan.fresh``), as launches are credited across graph replays
(``ops/launches.py``), and K9 counts on the device the lanes it stepped (``lanes_stepped``).

What bounds them on an H100: K9 bytes (each slot's f32 state read and written once: at 16
slots and Nemotron-H-47B's 45 layers, 24.2 GB a decode step); K8 its f32 operations on the
CUDA cores (the intra-chunk, inter-chunk and state products, about 2 P N + Q (N + P)
multiply-adds a position and head).
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.ops import launches
from llama_x_tpu_torch.utils import build

SSD_CHUNK = 16  # K8's positions a chunk (csrc/ssd_scan.cu: Q)
SSD_HEAD_DIM = 64  # the head width K8 and K9 hold (csrc: P)
SSD_STATES = (128, 256)  # the state widths they are built for (csrc: N)
CONV_KERNEL = 4  # K9's conv taps (csrc/ssd_step.cu: K)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """torch's softplus (threshold 20) in f32, as the kernels take it."""
    return torch.where(x > 20.0, x, torch.log1p(torch.exp(torch.clamp(x, max=20.0))))


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., G, N] -> [..., H, N]: head h reads group h // (H / G)."""
    return t.repeat_interleave(heads // t.shape[-2], dim=-2)


def ssd_scan_plain(xbc, dt, A, D, dt_bias, state, slot, length, snap_at=None, snap_out=None, *, heads: int,
                   head_dim: int, groups: int, state_dim: int, fresh: bool, chunk: int = SSD_CHUNK):
    """K8's arithmetic in PyTorch (any device): the chunked scan of a span (module docstring)."""
    T = xbc.shape[0]
    H, P, G, N = heads, head_dim, groups, state_dim
    xbc = xbc.float()
    x = xbc[:, :H * P].reshape(T, H, P)
    Bh = _heads(xbc[:, H * P:H * P + G * N].reshape(T, G, N), H)
    Ch = _heads(xbc[:, H * P + G * N:H * P + 2 * G * N].reshape(T, G, N), H)
    live = torch.arange(T, device=xbc.device) < length.reshape(())
    dtv = torch.where(live[:, None], softplus(dt.float() + dt_bias.float()), 0.0)  # [T, H]
    a = dtv * A.float()
    lane = state.index_select(0, slot.reshape(1))[0]
    S = torch.zeros_like(lane) if fresh else lane.clone()
    snap = -1 if snap_at is None else int(snap_at.reshape(()))
    y = torch.empty(T, H, P, dtype=torch.float32, device=xbc.device)
    for c0 in range(0, T, chunk):
        c1 = min(c0 + chunk, T)
        cum = a[c0:c1].cumsum(0)  # [q, H]
        xs, bs, cs, ds = x[c0:c1], Bh[c0:c1], Ch[c0:c1], dtv[c0:c1]
        q = c1 - c0
        causal = torch.ones(q, q, dtype=torch.bool, device=xbc.device).tril()
        decay = torch.exp((cum[:, None, :] - cum[None, :, :]).masked_fill(~causal[:, :, None], float("-inf")))
        m = torch.einsum("thn,shn->tsh", cs, bs) * decay * ds[None, :, :]  # [t, s, H]
        y[c0:c1] = (torch.einsum("tsh,shp->thp", m, xs) + torch.exp(cum)[:, :, None] * torch.einsum(
            "thn,hpn->thp", cs, S) + D.float()[None, :, None] * xs)
        if c0 < snap <= c1:
            r = snap - c0
            w = torch.exp(cum[r - 1][None, :] - cum[:r]) * ds[:r]  # [r, H]
            snap_out.copy_(torch.exp(cum[r - 1])[:, None, None] * S + torch.einsum("sh,shp,shn->hpn", w, xs[:r],
                                                                                   bs[:r]))
        w = torch.exp(cum[-1][None, :] - cum) * ds
        S = torch.exp(cum[-1])[:, None, None] * S + torch.einsum("sh,shp,shn->hpn", w, xs, bs)
    state.index_copy_(0, slot.reshape(1), S[None])
    return y


def ssd_step_plain(xbc, dt, conv_w, conv_b, A, D, dt_bias, conv_state, state, done=None, *, heads: int,
                   head_dim: int, groups: int, state_dim: int):
    """K9's arithmetic in PyTorch (any device): one token of every slot (module docstring).
    The conv sums in f32 in tap order and its SiLU output is rounded to the inputs' dtype."""
    Bn = xbc.shape[0]
    H, P, G, N = heads, head_dim, groups, state_dim
    win = torch.cat([conv_state, xbc[:, None]], dim=1)  # [B, K, C]
    acc = conv_b.float()[None]
    for k in range(win.shape[1]):
        acc = acc + conv_w[:, k].float()[None] * win[:, k].float()
    act = torch.nn.functional.silu(acc).to(xbc.dtype).float()
    x = act[:, :H * P].reshape(Bn, H, P)
    Bh = _heads(act[:, H * P:H * P + G * N].reshape(Bn, G, N), H)
    Ch = _heads(act[:, H * P + G * N:H * P + 2 * G * N].reshape(Bn, G, N), H)
    dtv = softplus(dt.float() + dt_bias.float())  # [B, H]
    dA = torch.exp(dtv * A.float())
    S = dA[:, :, None, None] * state + (dtv[:, :, None] * x)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", S, Ch) + D.float()[None, :, None] * x
    keep = torch.ones(Bn, dtype=torch.bool, device=xbc.device) if done is None else ~done
    state.copy_(torch.where(keep[:, None, None, None], S, state))
    conv_state.copy_(torch.where(keep[:, None, None], win[:, 1:], conv_state))
    return torch.where(keep[:, None, None], y, 0.0)


def _check_widths(head_dim: int, state_dim: int, groups: int, heads: int, what: str) -> None:
    if head_dim != SSD_HEAD_DIM or state_dim not in SSD_STATES or heads % groups:
        raise ValueError(f"{what} holds heads of {SSD_HEAD_DIM} over a state of {SSD_STATES} with whole groups, "
                         f"got head_dim {head_dim}, state {state_dim}, {heads} heads in {groups} groups")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _i64(t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.int64 or t.numel() != 1:
        raise ValueError(f"a device scalar is one int64, got {t.dtype} {tuple(t.shape)}")
    return t


def ssd_scan(xbc, dt, A, D, dt_bias, state, slot, length, snap_at=None, snap_out=None, *, heads: int,
             head_dim: int, groups: int, state_dim: int, fresh: bool) -> torch.Tensor:
    """K8 (module docstring) -> y [T, H, P] f32. CPU tensors take the plain version."""
    if not xbc.is_cuda:
        return ssd_scan_plain(xbc, dt, A, D, dt_bias, state, slot, length, snap_at, snap_out, heads=heads,
                              head_dim=head_dim, groups=groups, state_dim=state_dim, fresh=fresh)
    _check_widths(head_dim, state_dim, groups, heads, "ssd_scan")
    T, width = xbc.shape
    H, P, G, N = heads, head_dim, groups, state_dim
    if width != H * P + 2 * G * N or xbc.dtype != torch.bfloat16 or not xbc.is_contiguous():
        raise ValueError(f"ssd_scan takes contiguous bf16 x | B | C rows of {H * P + 2 * G * N}, got "
                         f"{xbc.dtype} {tuple(xbc.shape)}")
    if dt.shape != (T, H) or dt.dtype != torch.bfloat16 or dt.stride(1) != 1:
        raise ValueError(f"ssd_scan takes dt [{T}, {H}] bf16 rows, got {dt.dtype} {tuple(dt.shape)} {dt.stride()}")
    if state.dtype != torch.float32 or state.shape[1:] != (H, P, N) or not state.is_contiguous():
        raise ValueError(f"ssd_scan's lanes are contiguous f32 [lanes, {H}, {P}, {N}], got {tuple(state.shape)}")
    if snap_out is not None and (snap_out.shape != (H, P, N) or snap_out.dtype != torch.float32
                                 or not snap_out.is_contiguous()):
        raise ValueError(f"ssd_scan's snapshot is a contiguous f32 [{H}, {P}, {N}], got {tuple(snap_out.shape)}")
    y = torch.empty(T, H, P, dtype=torch.float32, device=xbc.device)
    if T == 0:
        return y
    A, D, dt_bias = _f32(A), _f32(D), _f32(dt_bias)
    take = snap_at is not None and snap_out is not None
    lib = build.load_library()
    launches.add(ssd_scan)
    launches.add(ssd_scan.scanned, T)
    if fresh:
        launches.add(ssd_scan.fresh)
    build.check(lib.lxt_ssd_scan(
        xbc.data_ptr(), dt.data_ptr(), A.data_ptr(), D.data_ptr(), dt_bias.data_ptr(), state.data_ptr(),
        _i64(slot).data_ptr(), _i64(length).data_ptr(), _i64(snap_at).data_ptr() if take else None,
        snap_out.data_ptr() if take else None, y.data_ptr(), T, H, G, N, dt.stride(0), state.shape[0],
        int(fresh), torch.cuda.current_stream(xbc.device).cuda_stream), "ssd_scan")
    return y


ssd_scan.scanned = launches.Work()  # positions K8 scanned, pads included
ssd_scan.fresh = launches.Work()  # K8's launches from a zero state (no lane read)
launches.counted("ssd_scan", ssd_scan, r"ssd_scan_kernel")


_counters: dict = {}
_retired: list = []
_stepped: dict = {}  # device -> K9's count of lanes stepped ([1] int64 on the device)


def _group_counters(device, n: int) -> torch.Tensor:
    """K9's arrival counters, one a (slot, group): zeros, and every launch leaves them at zero
    (the group's last CTA resets its own). A graph keeps the buffer's address, so a buffer
    that a larger one replaces is never freed."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = _counters[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def _stepped_counter(device) -> torch.Tensor:
    if device not in _stepped:
        _stepped[device] = torch.zeros(1, dtype=torch.int64, device=device)
    return _stepped[device]


def lanes_stepped() -> int:
    """The lanes K9 has stepped on every card so far (a live slot a layer a launch): reads the
    device counters back, so it waits for the work queued before it."""
    return sum(int(t.item()) for t in _stepped.values())


def ssd_step(xbc, dt, conv_w, conv_b, A, D, dt_bias, conv_state, state, done=None, *, heads: int,
             head_dim: int, groups: int, state_dim: int) -> torch.Tensor:
    """K9 (module docstring): ``xbc`` [B, C] and ``dt`` [B, H] rows of the input projection,
    the conv's ``conv_w`` [C, K] and ``conv_b`` [C], the lanes ``conv_state`` [B, K - 1, C]
    and ``state`` [B, H, P, N] f32, ``done`` [B] bool -> y [B, H, P] f32. CPU tensors take
    the plain version."""
    if not xbc.is_cuda:
        return ssd_step_plain(xbc, dt, conv_w, conv_b, A, D, dt_bias, conv_state, state, done, heads=heads,
                              head_dim=head_dim, groups=groups, state_dim=state_dim)
    _check_widths(head_dim, state_dim, groups, heads, "ssd_step")
    Bn, C = xbc.shape
    H, P, G, N = heads, head_dim, groups, state_dim
    bf16 = torch.bfloat16
    if C != H * P + 2 * G * N or xbc.dtype != bf16 or xbc.stride(1) != 1:
        raise ValueError(f"ssd_step takes bf16 x | B | C rows of {H * P + 2 * G * N}, got {xbc.dtype} "
                         f"{tuple(xbc.shape)}")
    if dt.shape != (Bn, H) or dt.dtype != bf16 or dt.stride(1) != 1:
        raise ValueError(f"ssd_step takes dt [{Bn}, {H}] bf16 rows, got {dt.dtype} {tuple(dt.shape)}")
    if conv_w.shape != (C, CONV_KERNEL) or conv_w.dtype != bf16 or conv_b.shape != (C,) or conv_b.dtype != bf16:
        raise ValueError(f"ssd_step takes a bf16 conv of {CONV_KERNEL} taps, got {tuple(conv_w.shape)} {conv_w.dtype}")
    if conv_state.shape != (Bn, CONV_KERNEL - 1, C) or conv_state.dtype != bf16 or not conv_state.is_contiguous():
        raise ValueError(f"ssd_step's conv lanes are contiguous bf16 [{Bn}, {CONV_KERNEL - 1}, {C}], got "
                         f"{tuple(conv_state.shape)}")
    if state.shape != (Bn, H, P, N) or state.dtype != torch.float32 or not state.is_contiguous():
        raise ValueError(f"ssd_step's lanes are contiguous f32 [{Bn}, {H}, {P}, {N}], got {tuple(state.shape)}")
    if done is not None and (done.shape != (Bn,) or done.dtype != torch.bool):
        raise ValueError(f"ssd_step's done mask is [{Bn}] bool, got {done.dtype} {tuple(done.shape)}")
    y = torch.empty(Bn, H, P, dtype=torch.float32, device=xbc.device)
    if Bn == 0:
        return y
    A, D, dt_bias = _f32(A), _f32(D), _f32(dt_bias)
    conv_w, conv_b = conv_w.contiguous(), conv_b.contiguous()
    counters = _group_counters(xbc.device, Bn * G)
    lib = build.load_library()
    launches.add(ssd_step)
    build.check(lib.lxt_ssd_step(
        xbc.data_ptr(), dt.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), A.data_ptr(), D.data_ptr(),
        dt_bias.data_ptr(), conv_state.data_ptr(), state.data_ptr(), None if done is None else done.data_ptr(),
        counters.data_ptr(), _stepped_counter(xbc.device).data_ptr(), y.data_ptr(), Bn, H, G, N, xbc.stride(0),
        dt.stride(0),
        torch.cuda.current_stream(xbc.device).cuda_stream), "ssd_step")
    return y


launches.counted("ssd_step", ssd_step, r"ssd_step_kernel")


# ---------------------------------------------------------------------------
# Triton passes beside K8 and K9 (built on first use: the CPU has no triton)
# ---------------------------------------------------------------------------

_triton: dict = {}


def _triton_kernels() -> dict:
    """The passes' Triton kernels, built on the first launch (``triton`` and its language join
    this module's globals then, where the kernels' bodies look them up)."""
    if not _triton:
        global triton, tl
        import triton
        import triton.language as tl

        @triton.jit
        def ssd_conv_kernel(win_ptr, w_ptr, b_ptr, out_ptr, W, C, K: tl.constexpr, BT: tl.constexpr,
                            BC: tl.constexpr):
            t = tl.program_id(0) * BT + tl.arange(0, BT)[:, None]
            c = tl.program_id(1) * BC + tl.arange(0, BC)[None, :]
            cm = c < C
            m = cm & (t < W)
            acc = tl.load(b_ptr + c, mask=cm, other=0.0).to(tl.float32) + tl.zeros((BT, BC), tl.float32)
            for k in tl.static_range(K):
                wk = tl.load(w_ptr + c * K + k, mask=cm, other=0.0).to(tl.float32)
                acc += wk * tl.load(win_ptr + (t + k) * C + c, mask=m, other=0.0).to(tl.float32)
            out = acc / (1.0 + tl.exp(-acc))
            tl.store(out_ptr + t * C + c, out.to(out_ptr.dtype.element_ty), mask=m)

        @triton.jit
        def gated_norm_kernel(y_ptr, z_ptr, z_stride, w_ptr, out_ptr, D, GS, eps, BLOCK: tl.constexpr):
            row = tl.program_id(0)
            i = tl.arange(0, BLOCK)
            m = i < GS
            c = tl.program_id(1) * GS + i
            y = tl.load(y_ptr + row * D + c, mask=m, other=0.0)
            z = tl.load(z_ptr + row * z_stride + c, mask=m, other=0.0).to(tl.float32)
            g = y * (z / (1.0 + tl.exp(-z)))
            r = g * tl.rsqrt(tl.sum(g * g, axis=0) / GS + eps)
            w = tl.load(w_ptr + c, mask=m, other=0.0).to(tl.float32)
            tl.store(out_ptr + row * D + c, (r * w).to(out_ptr.dtype.element_ty), mask=m)

        _triton.update(conv=ssd_conv_kernel, norm=gated_norm_kernel)
    return _triton


def ssd_conv_plain(win: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise conv over ``win`` [K - 1 + W, C] (the lane's last K - 1
    inputs, then the span's W) with ``weight`` [C, K] and ``bias`` [C] -> [W, C] in win's
    dtype: f32 sums in tap order, as K9's conv."""
    K = weight.shape[1]
    W = win.shape[0] - (K - 1)
    acc = bias.float()[None]
    for k in range(K):
        acc = acc + weight[:, k].float()[None] * win[k:k + W].float()
    return torch.nn.functional.silu(acc).to(win.dtype)


def ssd_conv(win: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``ssd_conv_plain``'s pass, one Triton launch on the card (CPU tensors: the plain version)."""
    if not win.is_cuda:
        return ssd_conv_plain(win, weight, bias)
    K = weight.shape[1]
    W, C = win.shape[0] - (K - 1), win.shape[1]
    if W < 1 or not win.is_contiguous() or weight.shape != (C, K) or bias.shape != (C,):
        raise ValueError(f"ssd_conv takes contiguous [K - 1 + W, C] rows, a [C, K] weight and a [C] bias, got "
                         f"{tuple(win.shape)}, {tuple(weight.shape)}, {tuple(bias.shape)}")
    out = torch.empty(W, C, dtype=win.dtype, device=win.device)
    BT, BC = 16, 256
    launches.add(ssd_conv)
    _triton_kernels()["conv"][(-(-W // BT), -(-C // BC))](win, weight.contiguous(), bias.contiguous(), out, W, C,
                                                           K=K, BT=BT, BC=BC)
    return out


launches.counted("ssd_conv", ssd_conv, r"ssd_conv_kernel")


def gated_norm_plain(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """RMSNorm over ``groups`` groups of channels of y * SiLU(z) (the gate first), in f32,
    times ``weight`` -> z's dtype. y [..., C] f32, z [..., C]."""
    g = y.float() * torch.nn.functional.silu(z.float())
    shape = g.shape
    g = g.reshape(*shape[:-1], groups, shape[-1] // groups)
    g = g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + eps)
    return (g.reshape(shape) * weight.float()).to(z.dtype)


def gated_norm(y: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, groups: int, eps: float) -> torch.Tensor:
    """``gated_norm_plain``'s pass, one Triton launch on the card (a program a row and group;
    z may be a view with its rows apart); CPU tensors take the plain version."""
    if not y.is_cuda:
        return gated_norm_plain(y, z, weight, groups, eps)
    C = y.shape[-1]
    y2, z2 = y.reshape(-1, C), z.reshape(-1, C)
    if (y2.dtype != torch.float32 or not y2.is_contiguous() or z2.stride(1) != 1 or C % groups
            or weight.shape != (C,)):
        raise ValueError(f"gated_norm takes contiguous f32 y and z rows of {C} channels in whole groups, got "
                         f"{y.dtype} {tuple(y.shape)}, z strides {z2.stride()}")
    out = torch.empty(z2.shape, dtype=z.dtype, device=z.device)
    GS = C // groups
    launches.add(gated_norm)
    _triton_kernels()["norm"][(y2.shape[0], groups)](y2, z2, z2.stride(0), weight.contiguous(), out, C, GS,
                                                      float(eps), BLOCK=1 << (GS - 1).bit_length())
    return out.reshape(z.shape)


launches.counted("gated_norm", gated_norm, r"gated_norm_kernel")
