"""Builds the repository's native C++ components at first use and loads them with
ctypes (port of llama_x_tpu/utils/native.py): the FLAC decoder ``native/flacdec.cc``
and the SentencePiece encoder ``native/spmenc.cc``, each compiled by g++ from that
source alone.

The library lands in ``llama_x_tpu_torch/build/`` (listed in ``.gitignore``) under a
name that carries a digest of the source and the flags, so an edited source builds
anew and an unchanged one is reused. g++ writes to a temporary name in the same
directory and ``os.replace`` moves the finished file into place, so a process that
builds at the same moment as another never loads a half-written library: whichever
finishes last replaces an identical file. A failed build raises with g++'s output;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path(src_name: str) -> Path:
    """Where the library of ``native/<src_name>`` lives for its current source (built or not)."""
    src = NATIVE_DIR / src_name
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_native(src_name: str) -> Path:
    """Compile ``native/<src_name>`` unless its library exists; returns the library's path."""
    target = library_path(src_name)
    if target.exists():
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH; native/{src_name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{target.name}.", suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, str(NATIVE_DIR / src_name), "-o", tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on native/{src_name}:\n{proc.stdout}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


@functools.lru_cache(maxsize=None)
def load_native(src_name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<src_name>``, built on first use."""
    return ctypes.CDLL(str(build_native(src_name)))
