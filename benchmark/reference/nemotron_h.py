"""The plain reference of a Nemotron-H cell: the hybrid decoder's served logits in plain
PyTorch and float32, TF32 off. It imports nothing of the program, and no JAX: it reads the
inputs the benchmark draws (``benchmark/weights_hybrid.py``) and works out again what the
program derives from them.

The architecture as its configuration publishes it (and as ``models/nemotron_h.py`` computes
it): pre-RMSNorm blocks in ``hybrid_override_pattern``'s order; a Mamba-2 block's in_proj
[z | xBC | dt], the causal depthwise conv with bias and SiLU, the SSD recurrence in its exact
quadratic (dual) form over the whole sequence (y_t = sum_{s <= t} (C_t . B_s)
exp(cum_t - cum_s) dt_s x_s + D x_t, cum the cumulative sum of dt A taken in float64), the
gated RMSNorm over groups of y * SiLU(z) and out_proj; attention causal GQA with no position
embedding; the MLP down(relu(up x)^2); a final RMSNorm and the bf16 head as stored.

The precision the configuration states, computed exactly (in float32 in place of the integer
sums), through ``benchmark/reference/model.py``'s rounding: ``act`` bits on every projection's
input rows against the stored int8 rows and their scales, ``kv`` bits on each cached key and
value row of one head. The SSM state, the conv and the norms run in float32. The control is
the same code with 4 bits where the configuration states 8. ``ssd_state`` gives the state after
a sequence's last position (the exact sum over its positions), against which a prefix-cache
snapshot of the program is held, beside the last K - 1 conv inputs; ``mamba_state`` the same
for one block from given in_proj rows, against which a decode lane is held.

The state-precision control (``bits["state"]``, a dtype below float32, with ``lanes_from``):
a sequence's positions from ``lanes_from`` on (a served row's decode steps) run one at a time
from the state after the positions before (``ssd_steps``), the state rounded to that dtype at
the start and after each update, as a decode lane kept in that dtype would hold it.

To fit beside the 49 GB of drawn weights, the sequences run block by block together (each
block's weights made float32 once), and the dual form in blocks of heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.model import fake_quant, no_tf32, rms_norm  # noqa: F401 (no_tf32 for callers)

HEAD_BLOCK = 8  # heads of one dual-form block


def _proj(w: dict, name: str, x: torch.Tensor, bits) -> torch.Tensor:
    q, s = w[name]
    return (fake_quant(x, bits) @ q.T) * s


def block_weights(cfg: dict, t: dict, kind: str, i: int) -> dict:
    """The ``i``-th block of ``kind``'s tensors in float32: {projection: (rows, scales)} and a
    Mamba-2 block's conv, A_log, dt_bias and D."""
    names = {"M": ("in_proj", "out_proj"), "*": ("wq", "wk", "wv", "wo"), "-": ("up", "down")}[kind]
    w = {n: (t[f"{n}.int8"][i].float(), t[f"{n}.scale"][i].float()) for n in names}
    if kind == "M":
        w.update({n: t[n][i].float() for n in ("conv_w", "conv_b", "A_log", "dt_bias", "D")})
    return w


def ssd_dual(x, dt, A, Bm, Cm, D) -> torch.Tensor:
    """x [S, H, P], dt [S, H] (after softplus), A [H], Bm / Cm [S, G, N], D [H] -> y [S, H, P]."""
    S, H, P = x.shape
    G = Bm.shape[1]
    rep = H // G
    cum = torch.cumsum(dt.double() * A.double(), dim=0)  # [S, H]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    y = torch.empty_like(x)
    cb = {}
    for h0 in range(0, H, HEAD_BLOCK):
        h1 = min(H, h0 + HEAD_BLOCK)
        # each group's C B^T [t, s], kept while its heads run
        cb = {g: cb[g] if g in cb else Cm[:, g] @ Bm[:, g].T for g in {h // rep for h in range(h0, h1)}}
        cbs = torch.stack([cb[h // rep] for h in range(h0, h1)]) if h1 - h0 > 1 else cb[h0 // rep][None]
        seg = (cum[:, h0:h1].T[:, :, None] - cum[:, h0:h1].T[:, None, :]).float()  # [hb, t, s]
        m = cbs * torch.exp(seg.masked_fill(~causal, float("-inf"))) * dt[:, h0:h1].T[:, None, :]
        y[:, h0:h1] = torch.einsum("hts,shp->thp", m, x[:, h0:h1]) + D[h0:h1, None] * x[:, h0:h1]
        del cbs, seg, m
    return y


def ssd_state(x, dt, A, Bm) -> torch.Tensor:
    """The state after the last of S positions from a zero state, [H, P, N]: sum_s
    exp(cum_last - cum_s) dt_s x_s B_s^T (cum in float64)."""
    H, G = x.shape[1], Bm.shape[1]
    cum = torch.cumsum(dt.double() * A.double(), dim=0)
    w = torch.exp((cum[-1][None] - cum).float()) * dt  # [S, H]
    rep = H // G
    return torch.cat([torch.einsum("sh,shp,sn->hpn", w[:, g * rep:(g + 1) * rep], x[:, g * rep:(g + 1) * rep], Bm[:, g])
                      for g in range(G)])


def ssd_steps(x, dt, A, Bm, Cm, D, state, dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence one position at a time from ``state`` [H, P, N], rounded to ``dtype``
    after each update (y from the update before its rounding) -> (y [S, H, P], the last state)."""
    rep = x.shape[1] // Bm.shape[1]
    ys = []
    for t in range(x.shape[0]):
        b, c = Bm[t].repeat_interleave(rep, 0), Cm[t].repeat_interleave(rep, 0)  # [H, N]
        state = torch.exp(dt[t] * A)[:, None, None] * state + (dt[t][:, None] * x[t])[:, :, None] * b[:, None, :]
        ys.append(torch.einsum("hpn,hn->hp", state, c) + D[:, None] * x[t])
        state = state.to(dtype).float()
    return torch.stack(ys), state


def _conv(cfg: dict, w: dict, xbc: torch.Tensor, dt: torch.Tensor) -> tuple:
    """The causal conv with SiLU over in_proj's xBC rows [S, C] from zero inputs, and dt [S, H]
    -> (x [S, H, P], B, C [S, G, N], dt after softplus, A, the conv's padded inputs)."""
    H, P, G, N = cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["n_groups"], cfg["ssm_state_size"]
    S, di, K = xbc.shape[0], H * P, w["conv_w"].shape[1]
    pad = torch.cat([torch.zeros(K - 1, xbc.shape[1], device=xbc.device), xbc], dim=0)
    act = F.silu(w["conv_b"] + sum(w["conv_w"][:, k] * pad[k:k + S] for k in range(K)))
    return (act[:, :di].reshape(S, H, P), act[:, di:di + G * N].reshape(S, G, N), act[:, di + G * N:].reshape(S, G, N),
            F.softplus(dt + w["dt_bias"]), -torch.exp(w["A_log"]), pad)


def _recurrence(x, dt, A, Bm, Cm, D, lanes_from, dtype) -> tuple:
    """-> (y [S, H, P], the state after the last position): the dual form and the exact state,
    or with ``dtype`` the positions from ``lanes_from`` on as ``ssd_steps``."""
    if dtype is None or lanes_from is None:
        return ssd_dual(x, dt, A, Bm, Cm, D), ssd_state(x, dt, A, Bm)
    p = lanes_from
    start = ssd_state(x[:p], dt[:p], A, Bm[:p]).to(dtype).float()
    y, last = ssd_steps(x[p:], dt[p:], A, Bm[p:], Cm[p:], D, start, dtype)
    return torch.cat([ssd_dual(x[:p], dt[:p], A, Bm[:p], Cm[:p], D), y]), last


def mamba_state(cfg: dict, w: dict, xbc: torch.Tensor, dt: torch.Tensor, lanes_from: int | None = None,
                dtype=None) -> tuple:
    """One Mamba-2 block's states after a row's last position, from its in_proj's xBC [S, C]
    and dt [S, H] columns (float32) and the block's conv, A_log, dt_bias: (SSM [H, P, N], the
    last K - 1 rows of xBC); ``lanes_from`` and ``dtype`` as ``mamba``'s state control."""
    x, Bm, Cm, dtv, A, pad = _conv(cfg, w, xbc, dt)
    return _recurrence(x, dtv, A, Bm, Cm, w["D"], lanes_from, dtype)[1], pad[xbc.shape[0]:]


def mamba(cfg: dict, w: dict, h: torch.Tensor, bits, keep: list | None = None,
          lanes_from: int | None = None) -> torch.Tensor:
    """A Mamba-2 block's mixer on the normed rows h [S, D] (float32), from a zero state; where
    ``keep`` is a list, (the state after the last position, the last K - 1 conv inputs) joins
    it, on the host. With ``bits["state"]`` the positions from ``lanes_from`` on run as
    ``ssd_steps``."""
    H, P, G, N = cfg["mamba_num_heads"], cfg["mamba_head_dim"], cfg["n_groups"], cfg["ssm_state_size"]
    S, di = h.shape[0], H * P
    proj = _proj(w, "in_proj", h, bits["act"])
    z, xbc, dt = proj[:, :di], proj[:, di:2 * di + 2 * G * N], proj[:, 2 * di + 2 * G * N:]
    x, Bm, Cm, dtv, A, pad = _conv(cfg, w, xbc, dt)
    y, last = _recurrence(x, dtv, A, Bm, Cm, w["D"], lanes_from, bits.get("state"))
    if keep is not None:
        keep.append((last.cpu(), pad[S:].cpu()))
    g = (y.reshape(S, di) * F.silu(z)).reshape(S, G, di // G)
    g = (g * torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + float(cfg["layer_norm_epsilon"]))).reshape(S, di)
    return _proj(w, "out_proj", g, bits["act"])


def attention(cfg: dict, w: dict, h: torch.Tensor, bits) -> torch.Tensor:
    hq, hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["attention_head_dim"]
    S = h.shape[0]
    q = _proj(w, "wq", h, bits["act"]).reshape(S, hkv, hq // hkv, hd)
    k = _proj(w, "wk", h, bits["act"]).reshape(S, hkv, hd)
    v = _proj(w, "wv", h, bits["act"]).reshape(S, hkv, hd)
    if bits.get("kv") is not None:
        k, v = fake_quant(k, bits["kv"]), fake_quant(v, bits["kv"])
    sc = torch.einsum("qhgd,khd->hgqk", q, k) / math.sqrt(hd)
    sc = sc.masked_fill(~torch.ones(S, S, dtype=torch.bool, device=h.device).tril(), float("-inf"))
    out = torch.einsum("hgqk,khd->qhgd", torch.softmax(sc, dim=-1), v).reshape(S, hq * hd)
    return _proj(w, "wo", out, bits["act"])


def mlp(cfg: dict, w: dict, h: torch.Tensor, bits) -> torch.Tensor:
    return _proj(w, "down", torch.relu(_proj(w, "up", h, bits["act"])).square(), bits["act"])


MIXERS = {"M": mamba, "*": attention, "-": mlp}


def logits(cfg: dict, tensors: dict, seqs: list[torch.Tensor], ats: list[torch.Tensor], bits: dict,
           keep=(), lanes_from: list | None = None) -> tuple[list, dict]:
    """Float32 logits [len(at), V] at positions ``at`` of each causal sequence of ``seqs``
    (token ids on the device), the sequences run together block by block; and for each index
    ``r`` in ``keep`` the states after sequence ``r``'s last position, one (SSM [H, P, N], conv
    [K - 1, C]) a Mamba-2 block. ``lanes_from``: each sequence's first decode position, which
    the state-precision control reads (``mamba``)."""
    eps = float(cfg["layer_norm_epsilon"])
    hs = [tensors["embed"][s.long()].float() for s in seqs]
    seen = {k: 0 for k in MIXERS}
    states: dict = {r: [] for r in keep}
    with torch.no_grad():
        for kind in cfg["hybrid_override_pattern"]:
            i = seen[kind]
            seen[kind] += 1
            w = block_weights(cfg, tensors, kind, i)
            for r, h in enumerate(hs):
                kw = {}
                if kind == "M":
                    kw = dict(keep=states.get(r), lanes_from=None if lanes_from is None else lanes_from[r])
                hs[r] = h + MIXERS[kind](cfg, w, rms_norm(h, eps), bits, **kw)
            del w
        head = tensors["head"].float()
        return [rms_norm(h[at], eps) @ head.T for h, at in zip(hs, ats)], states
