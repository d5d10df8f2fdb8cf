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

Its state lives on the device and is written in place, as optax's lives inside the jitted
step, so that a captured CUDA graph of the step (train/step_graph.py) replays it: the count
is an int32 tensor, from which the learning rate (``trapezoid_schedule``'s tensor form) and
the bias corrections are computed on the device; the moments (fp32, or the 8 / 4-bit codes
and scales) and the parameters are copied into their storage (``load_state_dict`` too), never
rebound. With fp32 state the update runs on ``torch._foreach_*``: a few launches per
operation over every tensor, in place of a chain of launches for each. ``step(apply=)``
takes a 0-d bool on the device and keeps the old parameters, moments and count where it is
False (the JAX trainer's ``jnp.where`` select of ``skip_nonfinite``); nothing is read back.

Over a mesh (``mesh``, with parameters that ``parallel/sharding.py:shard_params`` sharded
over fsdp and / or tp) the fp32 moments are sharded as their parameter is (the update is
elementwise). The 8 / 4-bit state is not: its blocks are those of the WHOLE flattened
tensor, as the JAX package (which quantizes the unsharded tensor) has them, so each rank of
the parameter's shard group keeps a contiguous range of whole blocks, updates those
elements from the gathered gradient and parameter, and the group gathers the updated
ranges back into every rank's slice. The codes, the scales and the update are then the
unsharded ones, bit for bit (``tests/test_torch_sharding.py``). ``state_dict`` gives the
state whole (fp32 moments gathered, block ranges concatenated: the unsharded layout) and
``load_state_dict`` takes it whole, on every rank of the mesh.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.parallel.mesh import AXES, all_gather, all_reduce
from llama_x_tpu_torch.parallel.tensor import gather_now, local_part, sharded_axes, stage_local, whole_shape


def trapezoid_schedule(lr: float, n_steps: int, warmup: float = 0.0, decay: float = 0.0):
    """Linear warmup to lr over warmup * n_steps -> constant -> linear decay to 0 over
    the last decay * n_steps; 0 past n_steps. Returns step -> lr: for an int a Python float
    (for logging), for a tensor step (the optimizer's count on the device) a 0-d float32
    tensor, the same float64 arithmetic rounded once (the ``jnp.where`` of the JAX schedule's
    three pieces)."""
    t1 = int(n_steps * warmup)
    t2 = int(n_steps * (1 - decay))
    t3 = n_steps

    def schedule(step):
        if isinstance(step, torch.Tensor):
            s = step.double()
            dec = (lr * (t3 - s) / max(t3 - t2, 1)).clamp(min=0.0)
            return torch.where(s < t1, lr * s / max(t1, 1), torch.where(s < t2, lr, dec)).float()
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
        q = torch.stack([lo, hi], dim=-1).reshape(q.shape[0], 2 * q.shape[1])
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


def global_norm(grads: list[torch.Tensor], mesh=None, params: list[torch.Tensor] | None = None) -> torch.Tensor:
    """sqrt(sum of squares over every tensor), fp32 (optax.global_norm). Over a mesh the
    sum runs over every rank's shards, each replicated tensor counted once (on the ranks at
    index 0 of the axes it is replicated over); ``params`` give the placement."""
    if mesh is None or mesh.size == 1:
        return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    coords = mesh.coords()
    for g, p in zip(grads, params):
        if all(coords[a] == 0 for a in replicated_axes(p, mesh)):
            total = total + g.float().pow(2).sum()
    return torch.sqrt(all_reduce(mesh, total))


def replicated_axes(p: torch.Tensor, mesh) -> tuple[str, ...]:
    held = set(sharded_axes(p, mesh))
    if stage_local(p):
        held.add("pp")
    return tuple(a for a in mesh.axes("mesh") if a not in held)


class AdamW:
    """AdamW over ``params`` (a list of tensors updated in place) with fp32 math.

    ``learning_rate`` is a float or a schedule that maps the count, a 0-d int32 tensor on
    the parameters' device, to a 0-d tensor (``trapezoid_schedule`` does). ``state_bits``
    None keeps fp32 moments; 8 or 4 keeps them quantized (``quantize_state``). ``mesh``: the
    mesh the parameters are sharded over (see the module docstring)."""

    def __init__(self, params: list[torch.Tensor], learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, clip_grad_norm: float | None = None,
                 state_bits: int | None = None, mesh=None):
        if state_bits not in (None, 8, 4):
            raise ValueError(f"state_bits must be None, 8 or 4, got {state_bits}")
        self.params = list(params)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.clip_grad_norm, self.state_bits = clip_grad_norm, state_bits
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        dev = self.params[0].device if self.params else None
        self.count = torch.zeros((), dtype=torch.int32, device=dev)  # steps taken, on the device
        # the whole-block range each sharded parameter's 8 / 4-bit state covers here
        self.ranges = [self._range(p) for p in self.params]
        self.mu = [self._pack(self._zeros(p, r)) for p, r in zip(self.params, self.ranges)]
        self.nu = [self._pack(self._zeros(p, r)) for p, r in zip(self.params, self.ranges)]

    def _range(self, p: torch.Tensor):
        """(group axis, n, lo, hi, span) for a sharded parameter with quantized state: this
        rank's elements [lo, hi) of the whole flattened tensor, ``span`` elements a rank."""
        if self.state_bits is None or self.mesh is None or not sharded_axes(p, self.mesh):
            return None
        axis = "+".join(sharded_axes(p, self.mesh))
        numel = _numel(whole_shape(p, self.mesh, AXES))
        n, i = self.mesh.axis_size(axis), self.mesh.index(axis)
        n_blocks = -(-numel // _BLOCK)
        span = -(-n_blocks // n) * _BLOCK  # whole blocks a rank
        return axis, n, min(i * span, numel), min((i + 1) * span, numel), span

    @staticmethod
    def _zeros(p: torch.Tensor, r) -> torch.Tensor:
        shape = p.shape if r is None else (r[3] - r[2],)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def _pack(self, x: torch.Tensor):
        return x if self.state_bits is None else quantize_state(x, bits=self.state_bits)

    def _unpack(self, state, shape) -> torch.Tensor:
        return state if self.state_bits is None else dequantize_state(*state, shape, bits=self.state_bits)

    def lr(self) -> float:
        """The learning rate of the next step (read at the pre-increment count), for logging:
        reads the count back."""
        if callable(self.learning_rate):
            return float(self.learning_rate(int(self.count)))
        return self.learning_rate

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], norm: torch.Tensor | None = None,
             apply: torch.Tensor | None = None) -> None:
        """One update from fp32 gradients (one per parameter, in order); ``norm``: their
        global norm when the caller has it (over a mesh: ``global_norm`` with the mesh);
        ``apply``: a 0-d bool tensor, False to leave every parameter, moment and the count as
        they were. Reads nothing back from the device."""
        grads = [g.float() for g in grads]
        if self.clip_grad_norm is not None:
            if norm is None:
                norm = global_norm(grads, self.mesh, self.params)
            # optax.clip_by_global_norm: untouched below the bound, else g / norm * bound;
            # below it the divisor and the factor are 1, which leaves g exact
            below = norm < self.clip_grad_norm
            grads = torch._foreach_mul(torch._foreach_div(grads, torch.where(below, 1.0, norm)),
                                       torch.where(below, 1.0, torch.full_like(norm, self.clip_grad_norm)))
        lr = self.learning_rate(self.count) if callable(self.learning_rate) else self.learning_rate
        count = self.count + 1
        # the bias corrections in float64, rounded once to float32 where they divide the moments
        cd = count.double()
        c1, c2 = (1 - self.b1**cd).float(), (1 - self.b2**cd).float()
        if self.state_bits is None:
            self._step_fp32(grads, lr, c1, c2, apply)
        else:
            self._step_quantized(grads, lr, c1, c2, apply)
        _write([self.count], [count], apply)

    def _step_fp32(self, grads, lr, c1, c2, apply) -> None:
        """fp32 moments, sharded as their parameters are: every tensor at once, elementwise (the
        per-tensor update's arithmetic, operation for operation)."""
        pf = [p.float() for p in self.params]
        mu = torch._foreach_add(torch._foreach_mul(self.mu, self.b1), torch._foreach_mul(grads, 1 - self.b1))
        nu = torch._foreach_add(torch._foreach_mul(self.nu, self.b2),
                                torch._foreach_mul(torch._foreach_mul(grads, 1 - self.b2), grads))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, c2)), self.eps)
        update = torch._foreach_div(torch._foreach_div(mu, c1), den)
        if self.weight_decay:
            update = torch._foreach_add(update, torch._foreach_mul(pf, self.weight_decay))
        new = torch._foreach_add(pf, torch._foreach_mul(update, -lr))
        _write(self.mu, mu, apply)
        _write(self.nu, nu, apply)
        _write(self.params, new, apply)

    def _step_quantized(self, grads, lr, c1, c2, apply) -> None:
        """8 / 4-bit moments: each tensor dequantized, updated and quantized again (over a
        mesh in whole-tensor blocks, see the module docstring)."""
        for i, (p, g) in enumerate(zip(self.params, grads)):
            r = self.ranges[i]
            if r is not None:  # this rank's whole blocks of the gathered tensor
                pw = gather_now(p, self.mesh, AXES)
                g = gather_now(g, self.mesh, AXES, like=p).reshape(-1)[r[2]:r[3]]
                pf = pw.reshape(-1)[r[2]:r[3]].float()
            else:
                pf = p.float()
            mu = self.b1 * self._unpack(self.mu[i], g.shape) + (1 - self.b1) * g
            nu = self.b2 * self._unpack(self.nu[i], g.shape) + (1 - self.b2) * g * g
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps) + self.weight_decay * pf
            new = (pf + (-lr * update)).to(p.dtype)
            if r is not None:
                axis, n, lo, hi, span = r
                padded = torch.cat([new, new.new_zeros(span - new.numel())])
                whole = all_gather(self.mesh, padded, axis, 0)[:pw.numel()].reshape(pw.shape)
                new = local_part(whole, self.mesh, p)
            _write([p], [new], apply)
            _write(list(self.mu[i]), list(self._pack(mu)), apply)
            _write(list(self.nu[i]), list(self._pack(nu)), apply)

    def _whole_state(self, i: int, state):
        """Moment ``state`` of parameter i as the unsharded optimizer would hold it."""
        p, r = self.params[i], self.ranges[i]
        if self.mesh is None:
            return state
        if r is None:
            return state if self.state_bits is not None else gather_now(state, self.mesh, AXES, like=p)
        axis, n, lo, hi, span = r
        q, scale = state
        rows, nb = span // _BLOCK, -(-_numel(whole_shape(p, self.mesh, AXES)) // _BLOCK)

        def blocks(t):
            pad = t.new_zeros((rows - t.shape[0], *t.shape[1:]))
            return all_gather(self.mesh, torch.cat([t, pad]), axis, 0)[:nb]

        return blocks(q), blocks(scale)

    def _local_state(self, i: int, whole):
        p, r = self.params[i], self.ranges[i]
        if self.mesh is None:
            return whole
        if r is None:
            return whole if self.state_bits is not None else local_part(whole, self.mesh, p)
        axis, n, lo, hi, span = r
        first = lo // _BLOCK
        last = -(-hi // _BLOCK) if hi > lo else first  # a rank past the tensor's end holds no block
        return tuple(t[first:last] for t in whole)

    def state_dict(self) -> dict:
        return {"count": int(self.count), "mu": [self._whole_state(i, s) for i, s in enumerate(self.mu)],
                "nu": [self._whole_state(i, s) for i, s in enumerate(self.nu)]}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` (``state_dict``'s layout) into the existing storage: a captured step
        keeps reading the same addresses."""
        def place(new, old):
            for n, o in zip(_parts(new), _parts(old)):
                if tuple(n.shape) != tuple(o.shape):
                    raise ValueError(f"optimizer state of shape {tuple(n.shape)} for a tensor of {tuple(o.shape)}")
                o.copy_(n)

        self.count.fill_(int(state["count"]))
        for i, (n, o) in enumerate(zip(state["mu"], self.mu)):
            place(self._local_state(i, n), o)
        for i, (n, o) in enumerate(zip(state["nu"], self.nu)):
            place(self._local_state(i, n), o)

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor of the state, the count included (a captured step reads their addresses)."""
        return [self.count, *(t for s in (*self.mu, *self.nu) for t in _parts(s))]


def _parts(state) -> list[torch.Tensor]:
    """The tensors of one moment: [fp32 tensor] or [codes, scales]."""
    return list(state) if isinstance(state, tuple) else [state]


def _write(dst: list[torch.Tensor], src: list[torch.Tensor], apply: torch.Tensor | None) -> None:
    """dst[i] <- src[i] in place (cast to dst's dtype); where ``apply`` is False, dst stays."""
    if apply is None:
        torch._foreach_copy_(dst, src)
        return
    for d, t in zip(dst, src):
        d.copy_(torch.where(apply, t, d))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def get_optimizer(name: str, params: list[torch.Tensor], learning_rate, weight_decay: float = 0.0,
                  clip_grad_norm: float | None = None, mesh=None) -> AdamW:
    """The registry: AdamW, AdamW8bit, AdamW4bit, with optional global-norm clipping."""
    bits = {"AdamW": None, "AdamW8bit": 8, "AdamW4bit": 4}
    if name not in bits:
        raise KeyError(name)
    return AdamW(params, learning_rate, weight_decay=weight_decay, clip_grad_norm=clip_grad_norm,
                 state_bits=bits[name], mesh=mesh)
