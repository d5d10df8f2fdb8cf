"""Audio + image + text early-fusion prefix-LM (port of llama_x_tpu/models/omni.py,
BASELINE config 5).

The union of the audio path (models/audio.py) and the Fuyu-style image path
(models/vision.py): both stems emit token embeddings that are prepended, audio first,
then image, then text, under one rope, with the loss on the text positions only.
Either modality may be absent in a batch (pass None); with ``prefix_lm`` attention is
bidirectional over every modality token.
"""

from __future__ import annotations

import torch

from llama_x_tpu_torch.models import fusion, llama
from llama_x_tpu_torch.models.audio import AudioConfig, AudioStem, audio_embed, init_audio_stem
from llama_x_tpu_torch.models.vision import PatchEmbed, VisionConfig, init_patch_embed, patch_embed
from llama_x_tpu_torch.utils.device import resolve_device


class LlamaOmni(llama.Llama):
    """The decoder with both stems (``audio_embed``, ``patch_embed``) and their configs."""

    def __init__(self, config: llama.LlamaConfig, tok_embeddings: torch.Tensor, layers, norm, output,
                 audio_embed: AudioStem, patch_embed: PatchEmbed, audio_config: AudioConfig = AudioConfig(),
                 vision_config: VisionConfig = VisionConfig()):
        super().__init__(config, tok_embeddings, layers, norm, output)
        self.audio_embed = audio_embed
        self.patch_embed = patch_embed
        self.audio_config = audio_config
        self.vision_config = vision_config

    @classmethod
    def from_llama(cls, model: llama.Llama, audio_stem: AudioStem, patch_stem: PatchEmbed,
                   audio_config: AudioConfig = AudioConfig(), vision_config: VisionConfig = VisionConfig()):
        """The same decoder tensors (shared, not copied) with both stems beside them."""
        return cls(model.config, model.tok_embeddings.data, list(model.layers), model.norm, model.output,
                   audio_stem, patch_stem, audio_config, vision_config)

    @classmethod
    def init(cls, config: llama.LlamaConfig, audio_config: AudioConfig = AudioConfig(),
             vision_config: VisionConfig = VisionConfig(), *, seed: int = 0, dtype=torch.bfloat16, device=None,
             generator: torch.Generator | None = None):
        """Random decoder (``llama.init`` from ``seed``), then the audio stem and the
        patch stem drawn in that order from ``generator`` (default: seeded ``seed + 1``)."""
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed + 1)
        base = llama.init(config, seed=seed, dtype=dtype, device=dev)
        audio_stem = init_audio_stem(config, audio_config, gen, dtype)
        return cls.from_llama(base, audio_stem, init_patch_embed(config, vision_config, gen, dtype), audio_config,
                              vision_config)

    @classmethod
    def from_hf(cls, path, seed: int = 0, dtype=torch.bfloat16, device=None, **kwargs):
        """Text weights from a local HF checkpoint; the audio stem, then the patch stem,
        drawn from one generator seeded with ``seed``. ``AudioConfig`` / ``VisionConfig``
        fields among the keyword arguments configure the stems, the rest go to
        ``load_llama``."""
        from llama_x_tpu_torch.models.hf import load_llama

        audio_config = AudioConfig(**{k: kwargs.pop(k) for k in list(kwargs) if k in AudioConfig.__dataclass_fields__})
        vision_config = VisionConfig(**{k: kwargs.pop(k) for k in list(kwargs)
                                        if k in VisionConfig.__dataclass_fields__})
        base = load_llama(path, dtype=dtype, device=device, **kwargs)
        gen = torch.Generator(device=base.device).manual_seed(seed)
        audio_stem = init_audio_stem(base.config, audio_config, gen, dtype)
        return cls.from_llama(base, audio_stem, init_patch_embed(base.config, vision_config, gen, dtype), audio_config,
                              vision_config)

    def forward(self, audio, images, tokens, **kw):
        return forward(self, audio, images, tokens, **kw)


def forward(model: LlamaOmni, audio: torch.Tensor | None, images: torch.Tensor | None, tokens: torch.Tensor, *,
            labels: torch.Tensor | None = None, prefix_lm: bool = False, kv_cache=None, input_pos=None,
            kv_len=None, dropout_seeds=None):
    """Loss / logits (+ cache): audio tokens, then image tokens, then ``tokens`` [B, S];
    each stem recomputed in the backward under ``activation_checkpointing``."""
    dtype = model.tok_embeddings.dtype
    prefix = []
    if audio is not None:
        prefix.append(fusion.embed_prefix(lambda a: audio_embed(model.audio_embed, model.audio_config, a, dtype=dtype),
                                          audio, model.config))
    if images is not None:
        prefix.append(fusion.embed_prefix(lambda im: patch_embed(model.patch_embed, model.vision_config, im,
                                                                 dtype=dtype), images, model.config))
    return fusion.fuse_forward(model, prefix, tokens, labels=labels, prefix_lm=prefix_lm, kv_cache=kv_cache,
                               input_pos=input_pos, kv_len=kv_len, dropout_seeds=dropout_seeds)
