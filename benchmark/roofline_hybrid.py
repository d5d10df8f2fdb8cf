"""The least time of the state-space kernels' calls on one H100 (pure arithmetic, no torch),
for a hybrid (Nemotron-H) cell: ``benchmark/roofline.py``'s yardstick for K8 and K9, with the
f32 peak those kernels run at.

Peaks: NVIDIA's H100 SXM data sheet: 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s
of HBM3, at the 700 W power limit. A call's least time is the larger of its bytes (each input
read once, each output written once) over the bandwidth and its operations over the peak.

K8 ``ssd_scan`` (a span of T positions of one row, H heads of P channels over a state of N, G
groups): operations 4 T H P N (the recurrence's state update, 2 a state element, and its
output, 2 more; the chunked form's extra intra-chunk products are not counted, so the share
reads the useful rate); bytes: the x | B | C rows (bf16) and dt read, y (f32) written, the
lane's state written, and read unless the span is fresh, and a snapshot written where taken.

K9 ``ssd_step`` (one token of each live lane): operations 4 H P N a lane; bytes: the state read
and written, the conv lane's K - 1 inputs read and written, the x | B | C row and dt read, y
written; a done lane only writes its y of zeros.
"""

from __future__ import annotations

from benchmark.roofline import HBM_BYTES_PER_S
from benchmark.weights_hybrid import dims

F32_OPS_PER_S = 67e12
BF16, F32 = 2, 4


def _seconds(ops: float, nbytes: float) -> float:
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def scan_seconds(cfg: dict, launches: int, scanned: int, fresh: int, snapshots: int) -> float:
    """The least time of ``launches`` K8 calls that scanned ``scanned`` positions in all, of
    which ``fresh`` started from a zero state and ``snapshots`` wrote a snapshot (the calls
    taken as spans of one width, as a cell's prefill chunks are)."""
    d = dims(cfg)
    H, P, G, N = d["H"], d["P"], d["G"], d["N"]
    state = H * P * N * F32
    row = (H * P + 2 * G * N) * BF16 + H * BF16 + H * P * F32
    T = scanned / launches
    ops = 4.0 * T * H * P * N
    kinds = ((fresh, 1), (launches - fresh, 2))  # (calls, state passes) for fresh and lane calls
    total = sum(n * _seconds(ops, T * row + k * state) for n, k in kinds)
    return total + snapshots * state / HBM_BYTES_PER_S


def step_seconds(cfg: dict, launches: int, lanes: int, slots: int) -> float:
    """The least time of ``launches`` K9 calls over ``slots`` slots that stepped ``lanes`` live
    lanes in all."""
    d = dims(cfg)
    H, P, G, N, K = d["H"], d["P"], d["G"], d["N"], d["K"]
    C = H * P + 2 * G * N
    live = H * P * N * F32 * 2 + (K - 1) * C * BF16 * 2 + C * BF16 + H * BF16 + H * P * F32
    nbytes = lanes * live + (launches * slots - lanes) * H * P * F32
    return max(lanes * 4.0 * H * P * N / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def share(obs: dict, kernel: str) -> float | None:
    """K8's (``ssd_scan``) or K9's (``ssd_step``) least time in the traced stretch over the device
    time of its records, in %; None where the stretch made no such call or its trace holds
    another count of the kernel's records than the launches counted."""
    t, counts = obs.get("trace"), obs.get("ssd")
    if not t or not t.get("summary") or not counts:
        return None
    s = t["summary"]
    n = counts["scan" if kernel == "ssd_scan" else "step"]
    if not n or s["launched"].get(kernel) != n or s["group_records"].get(kernel) != n or not s["group_s"][kernel]:
        return None
    if kernel == "ssd_scan":
        least = scan_seconds(obs["cfg"], n, counts["scanned"], counts["fresh"], counts["snapshots"])
    else:
        least = step_seconds(obs["cfg"], n, counts["lanes"], obs["engine"]["n_slots"])
    return 100.0 * least / s["group_s"][kernel]
