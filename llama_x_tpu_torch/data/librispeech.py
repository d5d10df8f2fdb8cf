"""LibriSpeech ASR data pipeline (port of llama_x_tpu/data/librispeech.py): utterances
packed into fixed-duration audio windows, one token stream per window; numpy only, the
same batches from the same seed.

- every line of each ``.trans.txt`` is read;
- windows are sharded across workers (``num_shards`` / ``shard_index``);
- audio: WAV through the stdlib ``wave`` module, FLAC through the repository's C++
  decoder (data/flac.py), anything else through soundfile where it is installed.

Packing: utterances (waveform and tokens) are concatenated until the window is full;
one bos ... eos per window; utterances longer than the window are skipped; audio is
zero-padded to exactly ``audio_duration * sample_rate`` samples; tokens are
right-padded with pad_id to a multiple of ``seq_len_multiple``; labels are the
shifted tokens with -100 over padding. Each epoch draws a new permutation from one
``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


def load_audio(path: str | Path) -> tuple[np.ndarray, int]:
    """Returns (mono float32 waveform in [-1, 1], sample_rate)."""
    path = str(path)
    if path.endswith(".wav"):
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            raw = w.readframes(n)
            dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
            x = np.frombuffer(raw, dtype=dtype).astype(np.float32)
            if width == 1:
                x = (x - 128.0) / 128.0
            else:
                x = x / float(2 ** (8 * width - 1))
            if w.getnchannels() > 1:
                x = x.reshape(-1, w.getnchannels()).mean(axis=1)
            return x, sr
    if path.endswith(".flac"):
        # the repository's C++ decoder (native/flacdec.cc, data/flac.py)
        from llama_x_tpu_torch.data.flac import decode_flac

        return decode_flac(path)
    try:
        import soundfile as sf
    except ImportError as e:
        raise RuntimeError(f"cannot decode {path}: unknown format and soundfile not installed") from e
    x, sr = sf.read(path, dtype="float32")
    if x.ndim > 1:
        x = x.mean(axis=1)
    return x, sr


def index_librispeech(data_dir: str | Path, tokenizer) -> list[tuple[str, list[int]]]:
    """Scan **/*.trans.txt; every line is '<utt_id> <TRANSCRIPT>'. Tokenizes
    ' {text.lower()}.' per utterance (the reference's text normalization,
    train_librispeech.py:60)."""
    data_dir = Path(data_dir)
    samples = []
    for trans in data_dir.glob("**/*.trans.txt"):
        for line in open(trans):
            line = line.rstrip()
            if not line:
                continue
            utt_id, text = line.split(" ", 1)
            audio_path = None
            for ext in (".flac", ".wav"):
                cand = trans.parent / f"{utt_id}{ext}"
                if cand.exists():
                    audio_path = str(cand.relative_to(data_dir))
                    break
            if audio_path is None:
                continue
            samples.append((audio_path, tokenizer(f" {text.lower()}.")))
    samples.sort()
    return samples


class LibriSpeechPacked:
    """Iterable of packed windows -> batches.

    yields {"audio": [B, T_samples] f32, "tokens": [B, L] i32, "labels": [B, L] i32}
    """

    def __init__(
        self,
        data_dir: str,
        tokenizer,
        audio_duration: float = 40.0,
        seq_len_multiple: int = 128,
        batch_size: int = 1,
        sample_rate: int = 16_000,
        max_text_len: int | None = None,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
    ):
        self.data_dir = Path(data_dir)
        self.audio_duration = audio_duration
        self.seq_len_multiple = seq_len_multiple
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.max_text_len = max_text_len
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.samples = index_librispeech(data_dir, tokenizer)
        self.bos_id = tokenizer.bos_id
        self.eos_id = tokenizer.eos_id
        self.pad_id = tokenizer.pad_id

    def _prepare_batch(self, batch):
        audio_len = int(self.audio_duration * self.sample_rate)
        audio = np.zeros((len(batch), audio_len), np.float32)
        for i, (wavs, _) in enumerate(batch):
            cat = np.concatenate(wavs)
            audio[i, : len(cat)] = cat

        max_tok = max(len(t) for _, t in batch)
        L = -(-max_tok // self.seq_len_multiple) * self.seq_len_multiple
        if self.max_text_len is not None:
            L = min(L, self.max_text_len)
        tokens = np.full((len(batch), L), self.pad_id, np.int32)
        labels = np.full((len(batch), L), -100, np.int32)
        for i, (_, toks) in enumerate(batch):
            toks = toks[:L]
            tokens[i, : len(toks)] = toks
            labels[i, : len(toks) - 1] = toks[1:]
        return {"audio": audio, "tokens": tokens, "labels": labels}

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        batch = []
        wavs: list[np.ndarray] = []
        toks = [self.bos_id]
        duration = 0.0
        while True:
            order = rng.permutation(len(self.samples))[self.shard_index :: self.num_shards]
            for idx in order:
                audio_path, utt_tokens = self.samples[idx]
                wav, sr = load_audio(self.data_dir / audio_path)
                if sr != self.sample_rate:
                    raise ValueError(f"{audio_path}: {sr} Hz, the pipeline reads {self.sample_rate} Hz")
                this_dur = len(wav) / sr
                if this_dur > self.audio_duration:
                    continue
                if duration + this_dur > self.audio_duration:
                    toks.append(self.eos_id)
                    batch.append((wavs, toks))
                    if len(batch) == self.batch_size:
                        yield self._prepare_batch(batch)
                        batch = []
                    wavs, toks, duration = [], [self.bos_id], 0.0
                wavs.append(wav)
                toks.extend(utt_tokens)
                duration += this_dur
