"""Fuyu-style image early fusion (port of llama_x_tpu/models/vision.py, BASELINE config 3).

No vision encoder: raw image patches are projected linearly into the decoder's
embedding space and prepended to the text as tokens, the way the audio stem's mel
frames are. Images arrive on a fixed square canvas [B, H, W, C]; patchify is a
reshape and permute ([B, nh, ps, nw, ps, C] -> [B, nh, nw, ps, ps, C], so each patch's
ps·ps·C features run row, column, channel); the projection is one matmul
[B·N, ps·ps·C] @ [ps·ps·C, D], rounded to the embedding dtype before the bias is added,
as the JAX function does; a learned newline embedding follows each patch row (Fuyu's
image-newline token): 256 patches + 16 newlines = 272 tokens at 224 / 14.

The JAX package keeps the projection's kernel as [fan_in, D]; here it is an
``nn.Linear`` whose ``weight`` [D, fan_in] is that kernel's transpose. The product is
``torch.matmul``: the JAX package leaves it to XLA, and no TPU kernel stands behind it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from llama_x_tpu_torch.models import fusion, llama
from llama_x_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224  # static square canvas
    patch_size: int = 14
    in_channels: int = 3
    use_newline: bool = True  # Fuyu's image-newline token after each patch row

    @property
    def patches_per_side(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(f"patch size {self.patch_size} does not divide the canvas {self.image_size}")
        return self.image_size // self.patch_size

    def num_image_tokens(self) -> int:
        n = self.patches_per_side
        return n * n + (n if self.use_newline else 0)


class PatchEmbed(nn.Module):
    """The stem's tensors: ``proj`` (an ``nn.Linear`` fan_in -> D) and, with
    ``use_newline``, the newline embedding [D]. Applied by ``patch_embed``."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor, newline: torch.Tensor | None):
        super().__init__()
        d, fan_in = weight.shape
        self.proj = nn.Linear(fan_in, d, device="meta")
        self.proj.weight, self.proj.bias = nn.Parameter(weight), nn.Parameter(bias)
        self.newline = None if newline is None else nn.Parameter(newline)


def init_patch_embed(config: llama.LlamaConfig, vision_config: VisionConfig, generator: torch.Generator,
                     dtype=torch.bfloat16) -> PatchEmbed:
    """The JAX stem's distributions, drawn from ``generator`` on its device: kernel
    U(+-1/sqrt(fan_in)) (kaiming-uniform with a = sqrt(5), torch Linear's default), bias
    U(+-1/sqrt(fan_in)), newline N(0, 0.02^2)."""
    vc, dev = vision_config, generator.device
    fan_in = vc.patch_size * vc.patch_size * vc.in_channels
    bound = (6.0 / (6.0 * fan_in)) ** 0.5
    w = torch.empty(config.embed_dim, fan_in, device=dev).uniform_(-bound, bound, generator=generator)
    b = torch.empty(config.embed_dim, device=dev).uniform_(-fan_in**-0.5, fan_in**-0.5, generator=generator)
    nl = torch.randn(config.embed_dim, device=dev, generator=generator) * 0.02 if vc.use_newline else None
    return PatchEmbed(w.to(dtype), b.to(dtype), None if nl is None else nl.to(dtype))


def patch_embed(stem: PatchEmbed, vision_config: VisionConfig, images: torch.Tensor,
                dtype=torch.bfloat16) -> torch.Tensor:
    """images [B, H, W, C] float -> image tokens [B, nh·(nw + newline), D], row-major
    patch order with the newline embedding after each row."""
    vc = vision_config
    B, H, W, C = images.shape
    ps = vc.patch_size
    if H % ps or W % ps:
        raise ValueError(f"patch size {ps} does not divide the canvas {H} x {W}")
    nh, nw = H // ps, W // ps
    x = images.to(dtype).reshape(B, nh, ps, nw, ps, C).permute(0, 1, 3, 2, 4, 5).reshape(B, nh, nw, ps * ps * C)
    tok = torch.matmul(x, stem.proj.weight.to(dtype).t()) + stem.proj.bias.to(dtype)
    if vc.use_newline:
        nl = stem.newline.to(dtype).expand(B, nh, 1, tok.shape[-1])
        tok = torch.cat([tok, nl], dim=2)
        nw += 1
    return tok.reshape(B, nh * nw, -1)


class LlamaVision(llama.Llama):
    """The decoder with a patch-embed stem (``patch_embed``) and its ``VisionConfig``."""

    def __init__(self, config: llama.LlamaConfig, tok_embeddings: torch.Tensor, layers, norm, output,
                 patch_embed: PatchEmbed, vision_config: VisionConfig = VisionConfig()):
        super().__init__(config, tok_embeddings, layers, norm, output)
        self.patch_embed = patch_embed
        self.vision_config = vision_config

    @classmethod
    def from_llama(cls, model: llama.Llama, stem: PatchEmbed, vision_config: VisionConfig = VisionConfig()):
        """The same decoder tensors (shared, not copied) with a stem beside them."""
        return cls(model.config, model.tok_embeddings.data, list(model.layers), model.norm, model.output, stem,
                   vision_config)

    @classmethod
    def init(cls, config: llama.LlamaConfig, vision_config: VisionConfig = VisionConfig(), *, seed: int = 0,
             dtype=torch.bfloat16, device=None, generator: torch.Generator | None = None):
        """Random decoder (``llama.init`` from ``seed``) and a stem drawn from
        ``generator`` (default: one seeded with ``seed + 1`` on the device)."""
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed + 1)
        base = llama.init(config, seed=seed, dtype=dtype, device=dev)
        return cls.from_llama(base, init_patch_embed(config, vision_config, gen, dtype), vision_config)

    @classmethod
    def from_hf(cls, path, seed: int = 0, dtype=torch.bfloat16, device=None, **kwargs):
        """Text weights from a local HF checkpoint (models/hf.py:load_llama); the patch
        stem drawn fresh from a generator seeded with ``seed`` on the device. Keyword
        arguments that name a ``VisionConfig`` field configure the stem, the rest go to
        ``load_llama``."""
        from llama_x_tpu_torch.models.hf import load_llama

        vision_config = VisionConfig(**{k: kwargs.pop(k) for k in list(kwargs)
                                        if k in VisionConfig.__dataclass_fields__})
        base = load_llama(path, dtype=dtype, device=device, **kwargs)
        gen = torch.Generator(device=base.device).manual_seed(seed)
        return cls.from_llama(base, init_patch_embed(base.config, vision_config, gen, dtype), vision_config)

    def forward(self, images, tokens, **kw):
        return forward(self, images, tokens, **kw)


def forward(model: LlamaVision, images: torch.Tensor | None, tokens: torch.Tensor, *,
            labels: torch.Tensor | None = None, prefix_lm: bool = False, kv_cache=None, input_pos=None,
            kv_len=None, dropout_seeds=None):
    """Loss / logits (+ cache) of the early-fusion model: the image tokens of ``images``
    [B, H, W, C] (None: text only) prepended to ``tokens`` [B, S]."""
    prefix = []
    if images is not None:
        dtype = model.tok_embeddings.dtype
        prefix.append(fusion.embed_prefix(lambda im: patch_embed(model.patch_embed, model.vision_config, im,
                                                                 dtype=dtype), images, model.config))
    return fusion.fuse_forward(model, prefix, tokens, labels=labels, prefix_lm=prefix_lm, kv_cache=kv_cache,
                               input_pos=input_pos, kv_len=kv_len, dropout_seeds=dropout_seeds)
