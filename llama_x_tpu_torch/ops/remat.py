"""Named saves for checkpointed regions: the port's counterpart of the JAX package's
``checkpoint_name`` + ``save_only_these_names`` remat policies.

``torch.utils.checkpoint`` can keep selected results of dispatcher ops, but the port's
kernels are ``ctypes`` launches inside ``autograd.Function``s, which no dispatcher
policy sees. So a checkpointed region gets a ``SaveStore``: on the first pass each named
point computes its value and leaves a detached copy in the store; on the recompute the
same point takes that copy and hands it to its ``autograd.Function`` as a preset, and
the Function returns it without launching its kernel while keeping its backward. Values
do not change: gradients equal those of full recomputation bit for bit, and the
kernels' ``.launches`` counters show what was not recomputed.
"""

from __future__ import annotations

from typing import Callable

# the names the model attaches (llama_x_tpu/models/llama.py:190,331 and
# llama_x_tpu/ops/flash_attention.py:609); MLP_IN has no JAX name: the "dots" policies
# save every projection output, and w1 / w3 are the ones no name covers
FLASH = "flash_residuals"
QKV = "qkv_proj"
O_PROJ = "o_proj"
MLP_OUT = "mlp_out"
MLP_IN = "mlp_in"

# remat_policy -> what a checkpointed region keeps. "dots" / "dots_flash" keep every
# base projection's output (the GEMMs that matter); the rank-r LoRA products are
# recomputed, which the JAX policy would also save.
POLICY_SAVES = {
    "full": (),
    "dots": (QKV, O_PROJ, MLP_IN, MLP_OUT),
    "dots_flash": (QKV, O_PROJ, MLP_IN, MLP_OUT, FLASH),
    "flash": (FLASH,),
    "flash_qkv": (FLASH, QKV),
    "flash_proj": (FLASH, QKV, O_PROJ, MLP_OUT),
}


def _detached(value):
    return tuple(t.detach() for t in value) if isinstance(value, tuple) else value.detach()


class SaveStore:
    """The named values one checkpointed region keeps between its forward pass and its
    recompute. ``enter()`` opens a pass (the first records, every later one replays);
    ``run(name, fn)`` is a named point: ``fn(preset)`` computes the value when ``preset``
    is None and otherwise wraps the preset in the same autograd node without computing."""

    def __init__(self, names=()):
        self.names = frozenset(names)
        self._kept: dict[str, list] = {}
        self._cursor: dict[str, int] = {}
        self._passes = 0

    def enter(self) -> None:
        self._passes += 1
        self._cursor = {}

    def run(self, name: str, fn: Callable):
        if name not in self.names:
            return fn(None)
        if self._passes > 1:
            i = self._cursor.get(name, 0)
            self._cursor[name] = i + 1
            return fn(self._kept[name][i])
        out = fn(None)
        self._kept.setdefault(name, []).append(_detached(out))
        return out


def run_saved(save: tuple[SaveStore, str] | None, fn: Callable):
    """``fn(None)`` outside a checkpointed region (``save`` is None), else the named
    point ``save = (store, name)``."""
    return fn(None) if save is None else save[0].run(save[1], fn)

