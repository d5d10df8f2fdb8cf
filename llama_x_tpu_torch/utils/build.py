"""Builds the hand-written CUDA kernels at first use and binds them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a`` (Hopper; ``wgmma`` and ``setmaxnreg`` exist only for that target),
and the objects are linked into ONE shared library with a plain C interface under
``llama_x_tpu_torch/build/`` (listed in ``.gitignore``). No PyTorch header is
included, so a build takes seconds, not the minutes of ``cpp_extension.load``.
The library's name carries a hash of the sources and flags: an edit rebuilds, an
unchanged tree reuses the library. A build error raises; nothing falls back.

Pointers and the stream cross the boundary as ``ctypes.c_void_p`` (a plain Python
int would be cut to 32 bits). Each C entry point returns ``cudaGetLastError()``
after its launch, and ``check`` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the kernels' entry points (csrc/*.cu, extern "C")
_SIGNATURES = {
    "lxt_int8_mm_dequant_nt": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "lxt_int8_mm_dequant_kn": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "lxt_flash_attention_fwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    "lxt_flash_attention_bwd": ([_P] * 12 + [_I] * 6 + [_F, _F, _I, _I, _I, _P], _I),
    "lxt_decode_attention": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P], _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output (ptxas register / shared-memory / spill summary) of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(f"nvcc not found on PATH or under {home}; the CUDA kernels cannot be built")
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> str:
    """Compile every source in parallel, link one .so, move it into place atomically.
    Returns nvcc's combined output."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
        tmp_so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, target)
    return "\n".join(log)


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    return BUILD_DIR / f"liblxt_kernels_{_digest()}.so"


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this checkout."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                build_log = _build(target)
            lib = ctypes.CDLL(str(target))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(code: int, kernel: str) -> None:
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA error {code} at launch")
