"""FLAC decoding through the repository's C++ decoder ``native/flacdec.cc`` (port of
llama_x_tpu/data/flac.py), built at first use by utils/native.py. No torchaudio,
libsndfile or ffmpeg is needed, and a pure-Python decoder could not feed a training
step."""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from llama_x_tpu_torch.utils.native import load_native

    lib = load_native("flacdec.cc")
    lib.flac_decode.restype = ctypes.c_longlong
    lib.flac_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
                                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
    return lib


def decode_flac(path_or_bytes) -> tuple[np.ndarray, int]:
    """A FLAC file or its bytes -> (float32 waveform in [-1, 1], channels averaged; sample rate)."""
    data = bytes(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray)) else Path(path_or_bytes).read_bytes()
    lib = _lib()
    sr, nch, bps = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    meta = (ctypes.byref(sr), ctypes.byref(nch), ctypes.byref(bps))
    total = lib.flac_decode(data, len(data), None, 0, *meta)
    if total < 0:
        raise ValueError("malformed FLAC stream")
    if total == 0:
        # STREAMINFO may say 0 samples (unknown): start from a guess off the compressed
        # size and grow it while the decoder answers -2 (buffer too small)
        total = len(data) * 8 // max(bps.value, 1) + 65536
    while True:
        out = np.empty(int(total) * nch.value, np.int32)
        n = lib.flac_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size, *meta)
        if n != -2:
            break
        total = int(total) * 2
    if n < 0:
        raise ValueError("malformed FLAC stream (frame decode)")
    x = out[: int(n) * nch.value].reshape(-1, nch.value).astype(np.float32)
    x /= float(2 ** (bps.value - 1))
    return (x.mean(axis=1) if nch.value > 1 else x[:, 0]), sr.value


def flac_available() -> bool:
    """Whether the decoder builds and loads here (it needs g++)."""
    try:
        _lib()
        return True
    except (OSError, RuntimeError):
        return False
