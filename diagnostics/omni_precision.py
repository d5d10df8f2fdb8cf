"""omni_synthetic with its attention kernels swapped for their plain PyTorch versions, to tell
a kernel's numerics from the model's precision when a learned-task score misses its bar.

    python diagnostics/omni_precision.py --plain --steps 3000 --out_dir DIR   # bf16, heads of 64
    python diagnostics/omni_precision.py --f32 --steps 3000 --out_dir DIR     # fp32, heads of 32

``--plain``: K2, K5 and K3 replaced by ``flash_fwd_plain``, ``flash_bwd_plain`` and
``decode_attention_plain`` on the card's tensors (the bf16 model with heads of 64, as the tool
runs it). ``--f32``: the JAX tool's model (heads of 32 in fp32), which the kernels do not take,
so the plain versions too. The other flags are the tool's. The artifact carries no launch counts:
the plain versions have no counter.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from llama_x_tpu_torch import omni_synthetic  # noqa: E402
from llama_x_tpu_torch.ops import decode_attention as da  # noqa: E402
from llama_x_tpu_torch.ops import flash_attention as fa  # noqa: E402
from llama_x_tpu_torch.train import learned_task  # noqa: E402


def main(argv: list[str]) -> dict:
    argv = list(argv)
    f32 = "--f32" in argv
    plain = f32 or "--plain" in argv
    argv = [a for a in argv if a not in ("--f32", "--plain")]
    if f32:
        learned_task.task_heads = lambda e, d: dict(head_dim=32, num_heads=e // 32, num_kv_heads=e // 64,
                                                    dtype=torch.float32)
    if plain:
        fa._forward_impl = fa.flash_fwd_plain
        fa.flash_bwd_from_res = fa.flash_bwd_plain
        da.decode_attention = da.decode_attention_plain
        learned_task.launch_counts = dict
    return omni_synthetic.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
