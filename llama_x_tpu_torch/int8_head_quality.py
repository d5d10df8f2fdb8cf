"""Training quality of the int8 fused-CE head (``int8_head``; port of
tools/int8_head_quality.py).

The method of ``int8_bwd_quality``: the same copy-permutation task trained twice, with the
same initial weights, data order and optimizer, once with the float vocabulary products of
the fused CE and once through the int8 GEMMs (hidden chunks quantized rowwise against the
head quantized colwise, dH through the scale-folded product: K1 and K4 on the card). The
int8 rounding of h, the head and the logits' gradient is the only difference, so a cost in
quality shows as a gap between the curves. The QLoRA model of the 8B runs with a frozen
head and the CE in 4 chunks, the input gradients int8 in both runs.

    python -m llama_x_tpu_torch.int8_head_quality --steps 400          # on the card
    python -m llama_x_tpu_torch.int8_head_quality --device cpu         # the JAX tool's model

Writes ``<out>``: both curves, their largest gap, the tail means, the device.
"""

from __future__ import annotations

from llama_x_tpu_torch.int8_bwd_quality import TASK, parse_args, study

# what both runs share: int8 input gradients, a frozen head, the CE in 4 chunks
FIXED = dict(dynamic_int8_bwd=True, fused_ce_chunks=4, frozen_head=True)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv, "runs/torch_int8_head_quality/quality.json")
    return study(args, "int8_head", 64, ("bf16_head", "int8_head"), task=TASK + ", frozen head", **FIXED)


if __name__ == "__main__":
    main()
