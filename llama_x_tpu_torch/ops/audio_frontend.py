"""Audio frontend: log-mel spectrogram + cepstral mean normalization (port of
llama_x_tpu/ops/audio_frontend.py).

Numerics spec = torchaudio MelSpectrogram(norm="slaney", mel_scale="slaney") at
sample_rate 16k, n_fft 512, win 400, hop 160, n_mels 128:

  reflect-pad n_fft//2 both sides (center=True) -> hann(win, periodic) window zero-padded
  to n_fft -> rFFT -> power (|.|^2) -> slaney mel filterbank (f 0..sr/2) with slaney area
  norm -> (the model drops the last frame, clips at 1e-12, log10, per-channel mean subtract).

fp32 throughout. No kernel of the JAX package is on this path: its rFFT and its strided
convolution are XLA's, so here they are ``torch.fft.rfft`` and ``conv1d``. The mel
product and the DFT convolution run with TF32 off (the JAX package asks for
``Precision.HIGHEST``): TF32 keeps three decimal digits, and a power spectrum spans many.
Window and filterbank are numpy constants (float64 inside), cached per device.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann (torch.hann_window default)."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length)).astype(np.float32)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz * 3.0 / 200.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f * 3.0 / 200.0)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz * 3.0 / 200.0
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), m * 200.0 / 3.0)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int, f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """[n_mels, n_fft//2 + 1] slaney-scale triangular filters with slaney area norm."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max), n_mels + 2)
    f_pts = _mel_to_hz_slaney(mel_pts)  # [n_mels + 2]

    rising = (fft_freqs[None, :] - f_pts[:-2, None]) / np.maximum(f_pts[1:-1, None] - f_pts[:-2, None], 1e-10)
    falling = (f_pts[2:, None] - fft_freqs[None, :]) / np.maximum(f_pts[2:, None] - f_pts[1:-1, None], 1e-10)
    fb = np.maximum(0.0, np.minimum(rising, falling))

    # slaney normalization: scale each filter to constant area
    enorm = 2.0 / (f_pts[2:] - f_pts[:-2])
    fb = fb * enorm[:, None]
    return fb.astype(np.float32)


@contextlib.contextmanager
def _full_fp32():
    """TF32 off for float32 matmuls and convolutions on the card (a no-op on the CPU)."""
    mm, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, conv


@functools.lru_cache(maxsize=8)
def _constants(n_fft: int, win_length: int, n_mels: int, sample_rate: int, device: torch.device):
    """(window zero-padded to n_fft [n_fft], mel filterbank [n_mels, n_bins], windowed
    DFT bases as conv kernels [2 * n_bins, 1, n_fft]) on ``device``."""
    lpad = (n_fft - win_length) // 2
    win_full = np.zeros(n_fft, np.float32)
    win_full[lpad: lpad + win_length] = hann_window(win_length)
    n_bins = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :] / n_fft
    basis = (np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * win_full[:, None]).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(win_full), to(mel_filterbank(n_mels, n_fft, sample_rate)), to(basis.T[:, None, :])


def mel_spectrogram(audio: torch.Tensor, sample_rate: int = 16_000, n_fft: int = 512, win_length: int = 400,
                    hop_length: int = 160, n_mels: int = 128, impl: str = "fft") -> torch.Tensor:
    """audio [B, T] float32 -> mel power spectrogram [B, n_mels, 1 + T//hop].

    Two spectral backends that compute the same function:
    - "fft": ``torch.fft.rfft`` over gathered frames (the default);
    - "dft": the window folded into cos / sin DFT bases, so that framing and transform
      are ONE strided convolution [B, 1, T] -> [B, 2 n_bins, n_frames] (the JAX
      package's TPU default).
    """
    if impl not in ("fft", "dft"):
        raise ValueError(f"impl must be 'fft' or 'dft', got {impl!r}")
    B, T = audio.shape
    pad = n_fft // 2
    x = torch.nn.functional.pad(audio.float()[:, None, :], (pad, pad), mode="reflect")  # [B, 1, T + n_fft]
    n_frames = 1 + T // hop_length
    win_full, fb, basis = _constants(n_fft, win_length, n_mels, sample_rate, audio.device)
    with _full_fp32():
        if impl == "dft":
            n_bins = n_fft // 2 + 1
            y = torch.nn.functional.conv1d(x, basis, stride=hop_length)  # [B, 2 n_bins, n_frames]
            re, im = y[:, :n_bins], y[:, n_bins:]
            power = (re * re + im * im).transpose(1, 2)  # [B, n_frames, n_bins]
        else:
            frames = x[:, 0].unfold(-1, n_fft, hop_length)[:, :n_frames]  # [B, n_frames, n_fft]
            spec = torch.fft.rfft(frames * win_full, n_fft, dim=-1)
            power = spec.real.square() + spec.imag.square()
        return torch.einsum("bfn,mn->bmf", power, fb)


def log_mel_cmn(mel: torch.Tensor, drop_last_frame: bool = True, dtype=torch.bfloat16) -> torch.Tensor:
    """clip(1e-12) -> log10 -> cepstral mean norm over time -> cast (the last frame is
    dropped first, as the reference model does)."""
    if drop_last_frame:
        mel = mel[..., :-1]
    logmel = torch.log10(torch.clamp(mel, min=1e-12))
    logmel = logmel - logmel.mean(dim=-1, keepdim=True)
    return logmel.to(dtype)
