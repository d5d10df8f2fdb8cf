"""Export a training run of the port as a HuggingFace Llama checkpoint (port of
tools/export_checkpoint.py).

Restores the run's latest (or the given) step through ``train/checkpoint.py:restore_model``
and writes config.json + model.safetensors with ``models/hf.py:save_llama_hf``: an int8
base is dequantized and LoRA / DoRA adapters are merged into the weights, so the result
loads with ``load_llama`` (``generate_cli --model``) or ``transformers``. The audio and
patch stems of the multimodal runs have no HF form: the text trunk is exported and the
stems are left out with a notice (the run's own checkpoint keeps them).

    python -m llama_x_tpu_torch.export_checkpoint runs/metamathqa/<run> out_dir/
    python -m llama_x_tpu_torch.export_checkpoint runs/librispeech/<run>/step_00001000 out_dir/ --dtype float16

Runs on the card (``--device cuda``, the default; no card: it raises) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def main(argv: list[str] | None = None):
    from llama_x_tpu_torch.models.hf import save_llama_hf
    from llama_x_tpu_torch.train.checkpoint import restore_model

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("run_or_ckpt", help="a run directory (its latest step) or a step_NNNNNNNN directory")
    parser.add_argument("out_dir")
    parser.add_argument("--dtype", default="bfloat16", choices=sorted(_DTYPES))
    parser.add_argument("--device", default="cuda", help="where the run is restored and merged (cpu: on the host)")
    args = parser.parse_args(argv)

    model = restore_model(args.run_or_ckpt, args.device)
    stems = [name for name in ("audio_embed", "patch_embed") if hasattr(model, name)]
    if stems:
        print(f"note: left out the modality stems {stems} (no HF form; the run's checkpoint keeps them)")
    out = save_llama_hf(model, args.out_dir, dtype=_DTYPES[args.dtype])
    print(f"exported {args.run_or_ckpt} -> {out} (config.json + model.safetensors)")
    return out


if __name__ == "__main__":
    main()
