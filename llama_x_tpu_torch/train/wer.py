"""Word error rate, the ASR quality metric of the LibriSpeech evaluation (port of
llama_x_tpu/train/wer.py)."""

from __future__ import annotations


def edit_distance(ref: list[str], hyp: list[str]) -> int:
    """Word-level Levenshtein distance (substitutions + insertions + deletions)."""
    m, n = len(ref), len(hyp)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            sub = prev[j - 1] + (ref[i - 1] != hyp[j - 1])
            cur[j] = min(sub, prev[j] + 1, cur[j - 1] + 1)
        prev = cur
    return prev[n]


def wer(refs: list[str], hyps: list[str]) -> float:
    """Corpus WER: total edits / total reference words over utterance pairs."""
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references for {len(hyps)} hypotheses")
    edits = words = 0
    for r, h in zip(refs, hyps):
        rw, hw = r.split(), h.split()
        edits += edit_distance(rw, hw)
        words += len(rw)
    return edits / max(words, 1)
