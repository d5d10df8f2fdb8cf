"""Optimizers and the trapezoidal LR schedule (port of llama_x_tpu/train/optim.py).

{AdamW, AdamW8bit, AdamW4bit} and a warmup -> constant -> linear-decay schedule given
as fractions of n_steps. The JAX package builds these from optax; here one ``AdamW``
class does optax.adamw's arithmetic itself, because ``torch.optim.AdamW`` on bf16
parameters computes in bf16 and would not track it:
- moments and all update math in fp32 over (possibly bf16) parameters; the new
  parameter is ``(p_f32 + update).to(p.dtype)``, one rounding per step;
- the learning rate is read at the pre-increment step count, the bias correction
  uses the post-increment count (optax's conventions);
- ``clip_grad_norm`` is optax.clip_by_global_norm in front of it;
- ``state_bits`` 8 or 4 keeps both moments blockwise quantized with a signed
  square-root companding code (dense code points near zero, where the moment mass
  lives) and dequantizes them inside the update.

The optimizer takes fp32 gradients explicitly (the trainer accumulates them in fp32
buffers) and updates the parameters in place.
"""

from __future__ import annotations

import torch


def trapezoid_schedule(lr: float, n_steps: int, warmup: float = 0.0, decay: float = 0.0):
    """Linear warmup to lr over warmup * n_steps -> constant -> linear decay to 0 over
    the last decay * n_steps; 0 past n_steps. Returns step -> lr (a Python float)."""
    t1 = int(n_steps * warmup)
    t2 = int(n_steps * (1 - decay))
    t3 = n_steps

    def schedule(step: int) -> float:
        step = float(step)
        if step < t1:
            return lr * step / max(t1, 1)
        if step < t2:
            return lr
        return max(lr * (t3 - step) / max(t3 - t2, 1), 0.0)

    return schedule


# ---------------------------------------------------------------------------
# 8-bit / 4-bit optimizer state
# ---------------------------------------------------------------------------

_BLOCK = 256


def quantize_state(x: torch.Tensor, block: int = _BLOCK, bits: int = 8):
    """Blockwise signed-sqrt low-bit code of a fp32 state tensor: (int8 codes
    [n_blocks, block or block // 2], fp32 absmax [n_blocks, 1]). bits=8: codes in
    [-127, 127]; bits=4: two signed nibbles in [-7, 7] per byte (low = even element)."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    xf = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = xf.abs().amax(dim=1, keepdim=True).clamp(min=1e-20)
    r = xf / scale
    qmax = 127.0 if bits == 8 else 7.0
    q = (torch.sign(r) * torch.round(qmax * torch.sqrt(r.abs()))).to(torch.int8)
    if bits == 4:
        lo = q[:, 0::2] & 0x0F
        hi = (q[:, 1::2] & 0x0F) << 4
        q = (lo | hi).to(torch.int8)
    return q, scale


def dequantize_state(q: torch.Tensor, scale: torch.Tensor, shape, block: int = _BLOCK, bits: int = 8):
    if bits == 4:
        lo = (q << 4) >> 4  # int8 shifts are arithmetic: sign-extends the low nibble
        hi = q >> 4
        q = torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)
        qmax = 7.0
    else:
        qmax = 127.0
    r = q.float() / qmax
    x = (torch.sign(r) * r * r * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return x[:n].reshape(shape)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares over every tensor), fp32 (optax.global_norm)."""
    return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))


class AdamW:
    """AdamW over ``params`` (a list of tensors updated in place) with fp32 math.

    ``learning_rate`` is a float or a schedule step -> float. ``state_bits`` None
    keeps fp32 moments; 8 or 4 keeps them quantized (``quantize_state``)."""

    def __init__(self, params: list[torch.Tensor], learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, clip_grad_norm: float | None = None,
                 state_bits: int | None = None):
        if state_bits not in (None, 8, 4):
            raise ValueError(f"state_bits must be None, 8 or 4, got {state_bits}")
        self.params = list(params)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.clip_grad_norm, self.state_bits = clip_grad_norm, state_bits
        self.count = 0
        self.mu = [self._pack(torch.zeros(p.shape, dtype=torch.float32, device=p.device)) for p in self.params]
        self.nu = [self._pack(torch.zeros(p.shape, dtype=torch.float32, device=p.device)) for p in self.params]

    def _pack(self, x: torch.Tensor):
        return x if self.state_bits is None else quantize_state(x, bits=self.state_bits)

    def _unpack(self, state, shape) -> torch.Tensor:
        return state if self.state_bits is None else dequantize_state(*state, shape, bits=self.state_bits)

    def lr(self) -> float:
        """The learning rate of the next step (read at the pre-increment count)."""
        return self.learning_rate(self.count) if callable(self.learning_rate) else self.learning_rate

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """One update from fp32 gradients (one per parameter, in order)."""
        if self.clip_grad_norm is not None:
            norm = global_norm(grads)
            # optax.clip_by_global_norm: untouched below the bound, else g / norm * bound
            grads = [torch.where(norm < self.clip_grad_norm, g, g / norm * self.clip_grad_norm) for g in grads]
        lr = self.lr()
        self.count += 1
        c1, c2 = 1 - self.b1**self.count, 1 - self.b2**self.count
        for i, (p, g) in enumerate(zip(self.params, grads)):
            g = g.float()
            mu = self.b1 * self._unpack(self.mu[i], g.shape) + (1 - self.b1) * g
            nu = self.b2 * self._unpack(self.nu[i], g.shape) + (1 - self.b2) * g * g
            pf = p.float()
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * pf
            p.copy_((pf + (-lr * update)).to(p.dtype))
            self.mu[i], self.nu[i] = self._pack(mu), self._pack(nu)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        def place(new, old):
            if isinstance(old, tuple):
                return tuple(place(n, o) for n, o in zip(new, old))
            return new.to(device=old.device, dtype=old.dtype)

        self.count = int(state["count"])
        self.mu = [place(n, o) for n, o in zip(state["mu"], self.mu)]
        self.nu = [place(n, o) for n, o in zip(state["nu"], self.nu)]


def get_optimizer(name: str, params: list[torch.Tensor], learning_rate, weight_decay: float = 0.0,
                  clip_grad_norm: float | None = None) -> AdamW:
    """The registry: AdamW, AdamW8bit, AdamW4bit, with optional global-norm clipping."""
    bits = {"AdamW": None, "AdamW8bit": 8, "AdamW4bit": 4}
    if name not in bits:
        raise KeyError(name)
    return AdamW(params, learning_rate, weight_decay=weight_decay, clip_grad_norm=clip_grad_norm,
                 state_bits=bits[name])
