"""Early-fusion audio-text Llama (port of llama_x_tpu/models/audio.py).

Whisper-style stem: log-mel (ops/audio_frontend.py) -> Conv1d(n_mels -> D, k3 s1 p1) ->
GELU -> Conv1d(D -> D, k3 s2 p1) -> GELU: 100 mel frames/s in, 50 audio tokens/s out.
Audio tokens are prepended to the text embeddings and share one rope over the
concatenated sequence; after the trunk the audio positions are sliced off so that the
loss covers text only (models/fusion.py). ``prefix_lm=True`` makes attention
bidirectional over the audio prefix and causal over text.

The JAX package keeps the stem's kernels as [W, C_in, C_out] and convolves in NHC
layout; here they are ``nn.Conv1d`` weights [C_out, C_in, W] on [B, C, T] (the log-mel
comes out channel-first already), and ``audio_embed`` returns [B, T_tokens, D] as the
JAX function does. The convolutions are PyTorch's: the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from llama_x_tpu_torch.models import fusion, llama
from llama_x_tpu_torch.ops.audio_frontend import log_mel_cmn, mel_spectrogram
from llama_x_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    sample_rate: int = 16_000
    n_fft: int = 512
    win_length: int = 400
    hop_length: int = 160
    n_mels: int = 128

    def num_audio_tokens(self, num_samples: int) -> int:
        """mel frames = 1 + samples//hop, last frame dropped, conv stride 2 (ceil)."""
        frames = num_samples // self.hop_length  # after [..., :-1]
        return (frames + 1) // 2


class AudioStem(nn.Module):
    """The two convolutions of the stem. Applied by ``audio_embed``."""

    def __init__(self, conv1: nn.Conv1d, conv2: nn.Conv1d):
        super().__init__()
        self.conv1, self.conv2 = conv1, conv2


def _conv(weight: torch.Tensor, bias: torch.Tensor, stride: int) -> nn.Conv1d:
    c_out, c_in, width = weight.shape
    conv = nn.Conv1d(c_in, c_out, width, stride=stride, padding=1, device="meta")
    conv.weight, conv.bias = nn.Parameter(weight), nn.Parameter(bias)
    return conv


def stem_from_tensors(w1, b1, w2, b2) -> AudioStem:
    """A stem over given tensors: weights [C_out, C_in, 3], biases [C_out]."""
    return AudioStem(_conv(w1, b1, 1), _conv(w2, b2, 2))


def init_audio_stem(config: llama.LlamaConfig, audio_config: AudioConfig, generator: torch.Generator,
                    dtype=torch.bfloat16) -> AudioStem:
    """torch Conv1d default init (kaiming_uniform(a=sqrt(5)), bias U(+-1/sqrt(fan_in))),
    drawn from ``generator`` on its device."""
    dev = generator.device

    def draw(c_in, c_out):
        bound = 1.0 / (c_in * 3) ** 0.5  # sqrt(6 / (6 fan_in)); the bias bound is the same number
        w = torch.empty(c_out, c_in, 3, device=dev).uniform_(-bound, bound, generator=generator)
        b = torch.empty(c_out, device=dev).uniform_(-bound, bound, generator=generator)
        return w.to(dtype), b.to(dtype)

    return stem_from_tensors(*draw(audio_config.n_mels, config.embed_dim), *draw(config.embed_dim, config.embed_dim))


def _conv1d(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    # the bias is added after the product's rounding to x's dtype, as the JAX stem adds it
    out = torch.nn.functional.conv1d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)
    return out + conv.bias.to(x.dtype)[:, None]


def audio_embed(stem: AudioStem, audio_config: AudioConfig, audio: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """audio [B, T_samples] f32 -> audio tokens [B, T_tokens, D]: frontend (mel + log +
    CMN, fp32) -> cast to the embedding dtype -> conv stem with the exact erf GELU."""
    c = audio_config
    mel = mel_spectrogram(audio, sample_rate=c.sample_rate, n_fft=c.n_fft, win_length=c.win_length,
                          hop_length=c.hop_length, n_mels=c.n_mels)
    x = log_mel_cmn(mel, drop_last_frame=True, dtype=dtype)  # [B, n_mels, T]
    x = torch.nn.functional.gelu(_conv1d(x, stem.conv1))
    x = torch.nn.functional.gelu(_conv1d(x, stem.conv2))
    return x.transpose(1, 2)  # [B, T // 2, D]


class LlamaAudio(llama.Llama):
    """The decoder with an audio stem (``audio_embed``) and its ``AudioConfig``."""

    def __init__(self, config: llama.LlamaConfig, tok_embeddings: torch.Tensor, layers, norm, output,
                 audio_embed: AudioStem, audio_config: AudioConfig = AudioConfig()):
        super().__init__(config, tok_embeddings, layers, norm, output)
        self.audio_embed = audio_embed
        self.audio_config = audio_config

    @classmethod
    def from_llama(cls, model: llama.Llama, stem: AudioStem, audio_config: AudioConfig = AudioConfig()):
        """The same decoder tensors (shared, not copied) with a stem beside them."""
        return cls(model.config, model.tok_embeddings.data, list(model.layers), model.norm, model.output, stem,
                   audio_config)

    @classmethod
    def init(cls, config: llama.LlamaConfig, audio_config: AudioConfig = AudioConfig(), *, seed: int = 0,
             dtype=torch.bfloat16, device=None, generator: torch.Generator | None = None):
        """Random decoder (``llama.init`` from ``seed``) and a stem drawn from
        ``generator`` (default: one seeded with ``seed + 1`` on the device)."""
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed + 1)
        base = llama.init(config, seed=seed, dtype=dtype, device=dev)
        return cls.from_llama(base, init_audio_stem(config, audio_config, gen, dtype), audio_config)

    @classmethod
    def from_hf(cls, path, seed: int = 0, dtype=torch.bfloat16, device=None, **kwargs):
        """Text weights from a local HF checkpoint (models/hf.py:load_llama); the audio
        stem drawn fresh from a generator seeded with ``seed`` on the device. Keyword
        arguments that name an ``AudioConfig`` field configure the stem, the rest go to
        ``load_llama``."""
        from llama_x_tpu_torch.models.hf import load_llama

        audio_config = AudioConfig(**{k: kwargs.pop(k) for k in list(kwargs) if k in AudioConfig.__dataclass_fields__})
        base = load_llama(path, dtype=dtype, device=device, **kwargs)
        gen = torch.Generator(device=base.device).manual_seed(seed)
        return cls.from_llama(base, init_audio_stem(base.config, audio_config, gen, dtype), audio_config)

    def forward(self, audio, tokens, **kw):
        return forward(self, audio, tokens, **kw)


def forward(model: LlamaAudio, audio: torch.Tensor | None, tokens: torch.Tensor, *,
            labels: torch.Tensor | None = None, prefix_lm: bool = False, kv_cache=None, input_pos=None,
            kv_len=None, dropout_seeds=None):
    """Loss / logits (+ cache) of the early-fusion model: the audio tokens of ``audio``
    [B, T_samples] (None: text only) prepended to ``tokens`` [B, S]. With
    ``activation_checkpointing`` the stem is recomputed in the backward."""
    prefix = []
    if audio is not None:
        dtype = model.tok_embeddings.dtype
        prefix.append(fusion.embed_prefix(lambda a: audio_embed(model.audio_embed, model.audio_config, a, dtype=dtype),
                                          audio, model.config))
    return fusion.fuse_forward(model, prefix, tokens, labels=labels, prefix_lm=prefix_lm, kv_cache=kv_cache,
                               input_pos=input_pos, kv_len=kv_len, dropout_seeds=dropout_seeds)
