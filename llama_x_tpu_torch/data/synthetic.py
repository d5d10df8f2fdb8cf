"""Learnable synthetic text (port of llama_x_tpu/data/synthetic.py, the part the text
trainer reads).

The trainer's ``--synthetic N`` mode uses random tokens by default, which exercise
the step and teach nothing. ``count`` is comma-separated incrementing integers from a
random start, byte-level ("184,185,186,..."): every continuation is determined by its
prefix, so a model can really learn it and a loss curve means something.
"""

from __future__ import annotations

import numpy as np


def counting_text(start: int, n_chars: int) -> str:
    """"{start},{start+1},..." truncated to n_chars."""
    out = []
    total = 0
    v = start
    while total < n_chars:
        s = f"{v},"
        out.append(s)
        total += len(s)
        v += 1
    return "".join(out)[:n_chars]


def counting_samples(n: int, seed: int, max_chars: int, lo: int = 1, hi: int = 5000) -> list[str]:
    """n independent counting sequences with random starts (carry-heavy ranges)."""
    rng = np.random.default_rng(seed)
    return [counting_text(int(rng.integers(lo, hi)), max_chars) for _ in range(n)]


def counting_tokens(n: int, seed: int, max_chars: int, tok) -> list[np.ndarray]:
    """Byte-tokenized counting samples for get_metamathqa(tokens_list=...)."""
    return [np.asarray(tok(s, add_bos=True), np.int32) for s in counting_samples(n, seed, max_chars)]
