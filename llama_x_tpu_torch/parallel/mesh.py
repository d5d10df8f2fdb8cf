"""The device mesh over ``torch.distributed`` (port of llama_x_tpu/parallel/mesh.py).

The JAX package builds one ``jax.sharding.Mesh`` with the axes (dp, fsdp, pp, cp, tp) and
lets GSPMD insert the collectives. Here every rank is one process: ``make_mesh`` lays the
ranks out in the same axis order (tp innermost, dp outermost), infers the unnamed axes the
same way, and makes one process group per axis that a collective runs over. The port
carries data and context parallelism: a mesh with fsdp, pp or tp above 1 raises (slice 5b:
parameter sharding, the pipeline and tensor parallelism).

The backend is named by the caller and never switched: ``nccl`` when each rank has a card
of its own, ``gloo`` on the CPU, and ``gloo`` when ranks share a card (NCCL refuses two ranks
on one device; ``init_distributed`` raises when asked for it there). Gloo takes CPU tensors
only, so the collectives below stage a CUDA tensor through host memory, explicitly, in one
place (``_to_backend``), and count the seconds they spend (``Mesh.comm``): with gloo that
is the exchange as the step sees it, copies included.

``use_mesh`` / ``current_mesh`` keep the ambient mesh that model code reads (the
context-parallel attention), as the JAX package does.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "pp", "cp", "tp")
LATER_AXES = ("fsdp", "pp", "tp")  # parameter sharding, the pipeline, tensor parallelism: slice 5b


def mesh_shape(n: int, dp: int | None = None, fsdp: int | None = None, pp: int = 1, cp: int = 1,
               tp: int = 1) -> dict[str, int]:
    """The (dp, fsdp, pp, cp, tp) sizes over ``n`` devices, inferred as the JAX package's
    ``make_mesh`` infers them: tp / cp / pp default to 1, fsdp absorbs the remaining
    devices unless dp is given. Raises when the product is not ``n``."""
    if dp is None and fsdp is None:
        dp, fsdp = 1, n // (pp * cp * tp)
    elif dp is None:
        dp = n // (fsdp * pp * cp * tp)
    elif fsdp is None:
        fsdp = n // (dp * pp * cp * tp)
    if dp * fsdp * pp * cp * tp != n:
        raise ValueError(f"mesh {dp}x{fsdp}x{pp}x{cp}x{tp} != {n} devices")
    return dict(zip(AXES, (dp, fsdp, pp, cp, tp)))


@dataclass
class CommStats:
    """Host seconds spent in the mesh's collectives and the bytes they moved, per rank."""

    seconds: float = 0.0
    calls: int = 0
    bytes: int = 0

    def reset(self) -> None:
        self.seconds, self.calls, self.bytes = 0.0, 0, 0


@dataclass
class Mesh:
    """This rank's view of the mesh: the axis sizes, its rank (whose coordinates ``index``
    gives), the backend, and the process group of each axis above size 1 and of the whole
    mesh ("mesh")."""

    shape: dict[str, int]
    rank: int
    backend: str | None
    groups: dict[str, object] = field(default_factory=dict)
    comm: CommStats = field(default_factory=CommStats)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def coords(self) -> dict[str, int]:
        return dict(zip(AXES, (int(c) for c in np.unravel_index(self.rank, tuple(self.shape[a] for a in AXES)))))

    def index(self, axis: str) -> int:
        return self.coords()[axis]

    def axis_size(self, axis: str) -> int:
        return self.size if axis == "mesh" else self.shape[axis]


def rank_device(backend: str, device: str | torch.device, local_rank: int, local_world_size: int) -> torch.device:
    """The device of a rank: the CPU, or card ``local_rank`` (``local_rank`` modulo the cards
    with gloo, which lets ranks share one). Raises for nccl on the CPU and for nccl with more
    ranks on this host than cards."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs between CUDA devices; on the CPU ask for backend 'gloo'")
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device; pass device 'cpu' (with backend 'gloo') for the CPU")
    if backend == "nccl" and local_world_size > n:
        raise ValueError(f"nccl needs one card per rank, but {local_world_size} ranks on this host share {n} "
                         f"card(s): NCCL refuses two ranks on one device; ask for backend 'gloo' to share a card")
    return torch.device("cuda", local_rank % n)


def init_distributed(backend: str, device: str | torch.device = "cuda", init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None, local_rank: int | None = None,
                     local_world_size: int | None = None) -> torch.device:
    """Join the process group (once per process; a no-op for a single process) and return
    this rank's device. Rank, world size and local rank default to torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE; ``init_method`` then defaults to
    ``env://``, which reads MASTER_ADDR / MASTER_PORT). ``backend`` is "nccl" or "gloo",
    named by the caller (see the module docstring)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    local_world_size = int(env.get("LOCAL_WORLD_SIZE", world_size)) if local_world_size is None else local_world_size
    dev = rank_device(backend, device, local_rank, local_world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world_size > 1 and not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=world_size)
    return dev


def refuse_later_axes(shape: dict[str, int]) -> None:
    """Raise, naming slice 5b, for a mesh with fsdp, pp or tp above 1."""
    later = [f"{a}={shape[a]}" for a in LATER_AXES if shape[a] > 1]
    if later:
        raise NotImplementedError(f"mesh {shape}: {', '.join(later)} is not ported yet (slice 5b: fsdp / tp "
                                  f"parameter sharding and the pipeline); pass dp and cp only, e.g. "
                                  f'{{"dp": {shape["dp"] * shape["fsdp"]}, "cp": {shape["cp"]}}}')


def make_mesh(dp: int | None = None, fsdp: int | None = None, pp: int = 1, cp: int = 1, tp: int = 1) -> Mesh:
    """The (dp, fsdp, pp, cp, tp) mesh over the ranks of the process group (one rank when
    none is initialized), with the JAX package's inference of unnamed axes. Every rank must
    call it, in the same order: it makes the axes' process groups."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    shape = mesh_shape(n, dp, fsdp, pp, cp, tp)
    refuse_later_axes(shape)
    rank = dist.get_rank() if dist.is_initialized() else 0
    backend = dist.get_backend() if dist.is_initialized() else None
    mesh = Mesh(shape, rank, backend)
    if n > 1:
        grid = np.arange(n).reshape(tuple(shape[a] for a in AXES))
        for i, axis in enumerate(AXES):
            if shape[axis] == 1:
                continue
            lines = np.moveaxis(grid, i, -1).reshape(-1, shape[axis])
            for line in lines:  # every rank makes every group, in one order
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    mesh.groups[axis] = g
        mesh.groups["mesh"] = dist.group.WORLD
    return mesh


# ---------------------------------------------------------------------------
# the ambient mesh (model code reaches it without threading it through every call)
# ---------------------------------------------------------------------------

_MESH_STACK: list[Mesh] = []


class use_mesh:
    """Context manager installing ``mesh`` as the ambient mesh for model code."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self):
        _MESH_STACK.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _MESH_STACK.pop()


def current_mesh() -> Mesh | None:
    return _MESH_STACK[-1] if _MESH_STACK else None


# ---------------------------------------------------------------------------
# collectives over one axis ("dp", "cp", or "mesh" for all of it)
# ---------------------------------------------------------------------------


def _to_backend(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can read it: gloo takes CPU tensors only, so a CUDA tensor is
    copied to host memory here (the copy waits for the kernels that write it); nccl takes
    the card's tensor as it is."""
    if mesh.backend == "gloo" and t.is_cuda:
        return t.contiguous().cpu()
    return t.contiguous()


class _Timed:
    def __init__(self, mesh: Mesh, n_bytes: int):
        self.mesh, self.n_bytes = mesh, n_bytes

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        c = self.mesh.comm
        c.seconds += time.perf_counter() - self.t0
        c.calls += 1
        c.bytes += self.n_bytes


def _bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def all_reduce(mesh: Mesh, t: torch.Tensor, axis: str = "mesh") -> torch.Tensor:
    """Sum of ``t`` over the axis' ranks (a new tensor on t's device)."""
    if mesh.axis_size(axis) == 1:
        return t
    with _Timed(mesh, _bytes(t)):
        buf = _to_backend(mesh, t).clone()
        dist.all_reduce(buf, group=mesh.groups[axis])
        return buf.to(t.device)


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The axis' ranks' ``t`` concatenated along ``dim`` in rank order."""
    n = mesh.axis_size(axis)
    if n == 1:
        return t
    with _Timed(mesh, _bytes(t) * n):
        src = _to_backend(mesh, t)
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=mesh.groups[axis])
        return torch.cat(parts, dim=dim).to(t.device)


def all_to_all(mesh: Mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """``t`` [n, ...] -> [n, ...]: slice i goes to rank i of the axis, slice j of the result
    came from rank j."""
    n = mesh.axis_size(axis)
    if n == 1:
        return t
    if t.shape[0] != n:
        raise ValueError(f"all_to_all takes [{n}, ...] over the {axis} axis, got {tuple(t.shape)}")
    with _Timed(mesh, _bytes(t)):
        src = _to_backend(mesh, t)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=mesh.groups[axis])
        return out.to(t.device)


def _span(t: torch.Tensor) -> int:
    return -(-t.numel() * t.element_size() // 16) * 16  # each part 16-byte aligned in the message


def _pack(ts) -> torch.Tensor:
    buf = torch.empty(sum(_span(t) for t in ts), dtype=torch.uint8, device=ts[0].device)
    at = 0
    for t in ts:
        n = t.numel() * t.element_size()
        buf[at:at + n] = t.contiguous().reshape(-1).view(torch.uint8)
        at += _span(t)
    return buf


def _unpack(buf: torch.Tensor, like) -> list[torch.Tensor]:
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].view(t.dtype).reshape(t.shape))
        at += _span(t)
    return out


class RingExchange:
    """One step of a ring over an axis: every rank sends ``tensors`` to the next rank (the
    previous one with ``reverse``) and receives the same shapes from the other side, as one
    message. ``wait()`` returns the received tensors on the senders' device; the transfer
    runs between the constructor and ``wait()``, so work launched in between overlaps it.
    ``tag`` tells apart two exchanges in flight at once."""

    def __init__(self, mesh: Mesh, tensors, axis: str = "cp", reverse: bool = False, tag: int = 0):
        self.mesh, self.like = mesh, list(tensors)
        self.device = self.like[0].device
        n, i = mesh.axis_size(axis), mesh.index(axis)
        if n == 1:
            self.recv, self.reqs = None, []
            return
        t0 = time.perf_counter()
        send = _to_backend(mesh, _pack(self.like))
        self.recv = torch.empty_like(send)
        group = mesh.groups[axis]
        ranks = dist.get_process_group_ranks(group)
        to, frm = ranks[(i - 1) % n if reverse else (i + 1) % n], ranks[(i + 1) % n if reverse else (i - 1) % n]
        self.reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to, group, tag),
                                            dist.P2POp(dist.irecv, self.recv, frm, group, tag)])
        self.send = send  # kept alive until the send completes
        self.elapsed = time.perf_counter() - t0

    def wait(self) -> list[torch.Tensor]:
        if self.recv is None:
            return self.like
        with _Timed(self.mesh, _bytes(self.recv)):
            for r in self.reqs:
                r.wait()
            out = _unpack(self.recv.to(self.device), self.like)
        self.mesh.comm.seconds += self.elapsed
        return out
