"""Mixed audio + image + text data for the omni model (port of llama_x_tpu/data/omni.py;
numpy only, the same batches from the same seed).

A ``manifest.jsonl`` drives it, one record per sample: ``{"text": caption or
transcript, "audio": relpath?, "image": relpath?}``. Every record carries the same
modality keys (a batch has one shape); a manifest that mixes them is refused: split it
into one manifest per modality set.

Audio lands on the librispeech window (zero-padded to ``audio_duration *
sample_rate`` samples), images on the vision canvas, text right-padded to a multiple
of ``seq_len_multiple`` with shifted, -100-masked labels. Yields {"audio"?: [B, T] f32,
"images"?: [B, H, W, C] f32, "tokens": [B, L] i32, "labels": [B, L] i32}.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from llama_x_tpu_torch.data.librispeech import load_audio
from llama_x_tpu_torch.data.vision import load_image


def index_manifest(data_dir: str | Path) -> list[dict]:
    """Records from manifest.jsonl, validated for a homogeneous modality set."""
    data_dir = Path(data_dir)
    path = data_dir / "manifest.jsonl"
    if not path.exists():
        raise FileNotFoundError(f"no manifest.jsonl in {data_dir}")
    records = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    if not records:
        raise ValueError(f"empty manifest {path}")
    keyset = {frozenset(k for k in r if k in ("audio", "image")) for r in records}
    if len(keyset) != 1:
        raise ValueError(f"heterogeneous modality sets in {path}: {sorted(map(sorted, keyset))}; split it into "
                         "one manifest per modality set (a batch has one shape)")
    return records


class OmniManifest:
    """Iterable of mixed-modality batches (see module docstring for the format)."""

    def __init__(
        self,
        data_dir: str,
        tokenizer,
        audio_duration: float = 40.0,
        image_size: int = 224,
        seq_len_multiple: int = 32,
        batch_size: int = 1,
        sample_rate: int = 16_000,
        max_text_len: int | None = None,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.data_dir = Path(data_dir)
        self.audio_duration = audio_duration
        self.image_size = image_size
        self.seq_len_multiple = seq_len_multiple
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.max_text_len = max_text_len
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.records = index_manifest(data_dir)
        self.has_audio = "audio" in self.records[0]
        self.has_image = "image" in self.records[0]
        self.tokenizer = tokenizer
        self.pad_id = tokenizer.pad_id

    def _prepare_batch(self, batch: list[dict]) -> dict:
        out: dict = {}
        if self.has_audio:
            T = int(self.audio_duration * self.sample_rate)
            audio = np.zeros((len(batch), T), np.float32)
            for i, s in enumerate(batch):
                wav = s["_wav"][:T]
                audio[i, : len(wav)] = wav
            out["audio"] = audio
        if self.has_image:
            out["images"] = np.stack([s["_img"] for s in batch])

        max_tok = max(len(s["_toks"]) for s in batch)
        L = -(-max_tok // self.seq_len_multiple) * self.seq_len_multiple
        if self.max_text_len is not None:
            L = min(L, self.max_text_len)
        tokens = np.full((len(batch), L), self.pad_id, np.int32)
        labels = np.full((len(batch), L), -100, np.int32)
        for i, s in enumerate(batch):
            toks = s["_toks"][:L]
            tokens[i, : len(toks)] = toks
            labels[i, : len(toks) - 1] = toks[1:]
        out["tokens"], out["labels"] = tokens, labels
        return out

    def _load(self, rec: dict) -> dict:
        s = dict(rec)
        s["_toks"] = self.tokenizer(f" {rec['text'].strip()}", add_bos=True, add_eos=True)
        if self.has_audio:
            wav, sr = load_audio(self.data_dir / rec["audio"])
            if sr != self.sample_rate:
                raise ValueError(f"{rec['audio']}: {sr} Hz, the pipeline reads {self.sample_rate} Hz")
            s["_wav"] = wav
        if self.has_image:
            s["_img"] = load_image(self.data_dir / rec["image"], self.image_size)
        return s

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        batch: list = []
        while True:
            order = rng.permutation(len(self.records))[self.shard_index :: self.num_shards]
            for idx in order:
                batch.append(self._load(self.records[idx]))
                if len(batch) == self.batch_size:
                    yield self._prepare_batch(batch)
                    batch = []
