"""MetaMathQA SFT batching (port of llama_x_tpu/data/metamathqa.py; numpy only, the
same batches from the same seed).

Two batching modes:

- **bucketed padding** (``iter_padding``): shuffle each epoch, batch, pad to the
  batch's longest sample rounded up to ``seq_len_multiple``. Labels are -100 on pads;
  the input / label shift happens here, in the data.
- **packed + segment ids** (``iter_packed``): whole samples packed into
  ``batch_rows`` rows of ``seq_len`` with a per-token document id that the attention
  kernels read directly (``MaskInfo.segment_ids``). Segment id 0 is padding; real
  documents count from 1.

Every consumer passes ``tokens_list`` (tests, synthetic data). Tokenizing the real
dataset needs its files and the llama2 / llama3 tokenizers' files, which the
repository does not hold: that path is not ported yet and raises.
"""

from __future__ import annotations

import numpy as np


def next_multiple(x: int, n: int) -> int:
    return (x + n - 1) // n * n


def iter_padding(tokens_list: list[np.ndarray], batch_size: int, seq_len_multiple: int = 256,
                 max_seq_len: int | None = None, seed: int = 0, num_shards: int = 1, shard_index: int = 0):
    """Yields {"inputs": [B, L], "labels": [B, L]} with L a bucket multiple."""
    rng = np.random.default_rng(seed)
    n = len(tokens_list)
    while True:
        order = rng.permutation(n)[shard_index::num_shards]
        for i in range(0, len(order) - batch_size + 1, batch_size):
            chunk = [tokens_list[j] for j in order[i : i + batch_size]]
            length = max(next_multiple(len(t) - 1, seq_len_multiple) for t in chunk)
            if max_seq_len is not None:
                length = min(length, max_seq_len)
            inputs = np.zeros((batch_size, length), np.int32)
            labels = np.full((batch_size, length), -100, np.int32)
            for r, toks in enumerate(chunk):
                m = min(len(toks) - 1, length)
                inputs[r, :m] = toks[:m]
                labels[r, :m] = toks[1 : m + 1]
            yield {"inputs": inputs, "labels": labels}


def iter_packed(tokens_list: list[np.ndarray], seq_len: int, batch_rows: int = 1, seed: int = 0,
                num_shards: int = 1, shard_index: int = 0):
    """Yields {"inputs": [R, S], "labels": [R, S], "segment_ids": [R, S]} fully packed:
    attention is same-document AND causal; id 0 marks padding (labels are -100 there)."""
    rng = np.random.default_rng(seed)

    def row_stream():
        inputs = np.zeros(seq_len, np.int32)
        labels = np.full(seq_len, -100, np.int32)
        seg = np.zeros(seq_len, np.int32)
        fill, doc = 0, 1
        while True:
            order = rng.permutation(len(tokens_list))[shard_index::num_shards]
            for j in order:
                toks = tokens_list[j]
                m = len(toks) - 1
                if m > seq_len:
                    continue  # sample longer than a row can hold
                if fill + m > seq_len:
                    yield inputs, labels, seg
                    inputs = np.zeros(seq_len, np.int32)
                    labels = np.full(seq_len, -100, np.int32)
                    seg = np.zeros(seq_len, np.int32)
                    fill, doc = 0, 1
                inputs[fill : fill + m] = toks[:-1][:m]
                labels[fill : fill + m] = toks[1:][:m]
                seg[fill : fill + m] = doc
                fill += m
                doc += 1

    rows = row_stream()
    while True:
        batch = [next(rows) for _ in range(batch_rows)]
        yield {
            "inputs": np.stack([b[0] for b in batch]),
            "labels": np.stack([b[1] for b in batch]),
            "segment_ids": np.stack([b[2] for b in batch]),
        }


def get_metamathqa(tokenizer_name: str, document_mask: bool, batch_size: int, max_seq_len: int,
                   seq_len_multiple: int = 256, tokens_list: list[np.ndarray] | None = None, seed: int = 0,
                   num_shards: int = 1, shard_index: int = 0):
    """Returns (iterator, dataset_size) over ``tokens_list``."""
    if tokens_list is None:
        raise NotImplementedError(
            "tokenizing the MetaMathQA dataset needs its files and a llama2 / llama3 tokenizer model, which "
            "the repository does not hold; pass tokens_list (real-data tokenization comes with slice 2b)"
        )
    if document_mask:
        it = iter_packed(tokens_list, max_seq_len, batch_rows=batch_size, seed=seed, num_shards=num_shards,
                         shard_index=shard_index)
    else:
        it = iter_padding(tokens_list, batch_size, seq_len_multiple, max_seq_len, seed=seed,
                          num_shards=num_shards, shard_index=shard_index)
    return it, len(tokens_list)
