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

Real data is read from the token cache, as in the JAX package: an ``.npz`` of the
tokenized samples (flat and offsets) keyed by tokenizer and ``max_seq_len``
(``cache_path``), written once by ``tokenize_metamathqa``. On a cache miss the JAX package
downloads the dataset (``datasets.load_dataset``); the port downloads nothing: it writes the
cache from the records it is handed (``{"query", "response"}`` dicts) and otherwise raises,
naming the file and the dataset. Tests and synthetic data pass ``tokens_list`` instead.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

DATASET = "meta-math/MetaMathQA"
PROMPT_TEMPLATE = (
    "Below is an instruction that describes a task. "
    "Write a response that appropriately completes the request.\n\n"
    "### Instruction:\n{query}\n\n"
    "### Response: Let's think step by step."
)


def next_multiple(x: int, n: int) -> int:
    return (x + n - 1) // n * n


def cache_path(tokenizer_name: str, max_seq_len: int, cache_dir: str | Path = ".") -> Path:
    """The token cache of one tokenizer and length (samples are truncated when tokenized,
    so the length is part of the key)."""
    return Path(cache_dir) / f"metamathqa_{tokenizer_name}_s{max_seq_len}.npz"


def tokenize_metamathqa(tokenizer, tokenizer_name: str, max_seq_len: int, cache_dir: str | Path = ".",
                        records=None) -> list[np.ndarray]:
    """The tokenized samples from the cache; on a miss, ``records`` (an iterable of
    {"query", "response"} dicts) tokenized as prompt + answer, truncated to max_seq_len + 1,
    and written to the cache (to a temporary name, then ``os.replace``). Without records a
    miss raises: the port does not download the dataset."""
    cache = cache_path(tokenizer_name, max_seq_len, cache_dir)
    if cache.exists():
        with np.load(cache, allow_pickle=False) as z:
            flat, offsets = z["flat"], z["offsets"]
        return [flat[offsets[i]: offsets[i + 1]] for i in range(len(offsets) - 1)]
    if records is None:
        raise FileNotFoundError(
            f"no MetaMathQA token cache {cache}: the JAX package downloads {DATASET} to write it, the port "
            "downloads nothing; write it from local records (data/metamathqa.py: tokenize_metamathqa(records=)) "
            "or pass --synthetic N")
    tokens_list = []
    for ex in records:
        prompt = PROMPT_TEMPLATE.format(query=ex["query"])
        toks = list(tokenizer(prompt, add_bos=True)) + list(tokenizer(" " + ex["response"], add_eos=True))
        tokens_list.append(np.asarray(toks[: max_seq_len + 1], np.int32))
    flat = np.concatenate(tokens_list)
    offsets = np.zeros(len(tokens_list) + 1, np.int64)
    np.cumsum([len(t) for t in tokens_list], out=offsets[1:])
    tmp = f"{cache}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, flat=flat, offsets=offsets)
    os.replace(tmp, cache)
    return tokens_list


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
                   num_shards: int = 1, shard_index: int = 0, cache_dir: str | Path = "."):
    """Returns (iterator, dataset_size) over ``tokens_list``, or without it over the token
    cache of ``tokenizer_name`` in ``cache_dir`` (a miss raises, naming the file)."""
    if tokens_list is None:
        # the tokenizer runs only to write a cache, which needs records: a miss raises first
        tokens_list = tokenize_metamathqa(None, tokenizer_name, max_seq_len, cache_dir)
    if document_mask:
        it = iter_packed(tokens_list, max_seq_len, batch_rows=batch_size, seed=seed, num_shards=num_shards,
                         shard_index=shard_index)
    else:
        it = iter_padding(tokens_list, batch_size, seq_len_multiple, max_seq_len, seed=seed,
                          num_shards=num_shards, shard_index=shard_index)
    return it, len(tokens_list)
