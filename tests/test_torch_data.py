"""The port's data side against the JAX package's, on the CPU, on files the tests write:
the SentencePiece reader and its C++ encoder, the llama2 / llama3 / byte tokenizers,
the native build, FLAC and WAV decoding, the LibriSpeech packer, image captions, the
synthetic shapes task, the omni manifest, ``wer``, the trainers' ``--dataset_dir`` and
``--tokenizer`` paths, and the port's import rules.

Everything here is exact: ids, arrays and scores equal the JAX package's. The JAX
package's own native encoder and FLAC decoder are never called (each call would build
``native/*.so`` in place beside ``tests/test_flac.py``'s build): its SentencePiece ids
come from the pure-Python ``_encode_bpe`` / ``_encode_unigram``, its pipelines read WAV
files, and the port's FLAC decoder is held against the samples the encoder was given."""

import ast
import json
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from llama_x_tpu.data import librispeech as jls
from llama_x_tpu.data import omni as jomni
from llama_x_tpu.data import vision as jvis
from llama_x_tpu.data.sentencepiece import BYTE, CONTROL, NORMAL, UNKNOWN
from llama_x_tpu.data.sentencepiece import SentencePieceModel as JSentencePieceModel
from llama_x_tpu.data.tokenizers import ByteTokenizer as JByteTokenizer
from llama_x_tpu.data.tokenizers import Llama3Tokenizer as JLlama3Tokenizer
from llama_x_tpu.train import wer as jwer
from llama_x_tpu_torch.data import flac as tflac
from llama_x_tpu_torch.data import librispeech as tls
from llama_x_tpu_torch.data import omni as tomni
from llama_x_tpu_torch.data import sentencepiece as tsp
from llama_x_tpu_torch.data import tokenizers as ttok
from llama_x_tpu_torch.data import vision as tvis
from llama_x_tpu_torch.train import wer as twer
from llama_x_tpu_torch.utils import native as tnative
from tests.flac_encoder import encode_flac
from tests.test_sentencepiece import _bpe_pieces, _model

REPO = Path(__file__).resolve().parent.parent

# ---------------------------------------------------------------------------
# SentencePiece and the tokenizers
# ---------------------------------------------------------------------------

TEXTS = ["hello world", "hello hello wor", "  two  spaces", "héllo wörld", "日本語 and emoji 🙂", "q", "",
         "world hello\nnew line"]


def _unigram_pieces():
    pieces = [("<unk>", 0.0, UNKNOWN), ("<s>", 0.0, CONTROL), ("</s>", 0.0, CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, BYTE) for b in range(256)]
    for text, score in [("▁hello", -1.0), ("▁he", -2.0), ("llo", -2.5), ("▁", -3.0), ("h", -4.0), ("e", -4.1),
                        ("l", -4.2), ("o", -4.3), ("▁wor", -1.5), ("ld", -2.0), ("w", -4.4), ("r", -4.5),
                        ("d", -4.6), ("é", -3.0), ("▁and", -1.2), ("n", -4.7), ("a", -4.8)]:
        pieces.append((text, score, NORMAL))
    return pieces


@pytest.fixture(params=["bpe", "unigram"])
def sp_model(request, tmp_path):
    path = tmp_path / f"{request.param}.model"
    pieces, kind = (_bpe_pieces(), 2) if request.param == "bpe" else (_unigram_pieces(), 1)
    path.write_bytes(_model(pieces, model_type=kind))
    return path


@pytest.mark.parametrize("text", TEXTS)
def test_sentencepiece_ids_equal_the_jax_oracle(sp_model, text):
    """The port's ``encode`` (the C++ encoder) gives the ids of the JAX package's
    pure-Python encoder on the normalized text, and so does the port's own Python
    oracle; byte fallback covers what the vocabulary lacks."""
    want_sp = JSentencePieceModel.from_file(sp_model)
    got_sp = tsp.SentencePieceModel.from_file(sp_model)
    assert (got_sp.model_type, got_sp.add_dummy_prefix, len(got_sp)) == (want_sp.model_type,
                                                                          want_sp.add_dummy_prefix, len(want_sp))
    got = got_sp.encode(text)
    if not text:
        assert got == []
        return
    oracle = want_sp._encode_bpe if want_sp.model_type == 2 else want_sp._encode_unigram
    want = oracle(want_sp._normalize(text))
    own = got_sp._encode_bpe if got_sp.model_type == 2 else got_sp._encode_unigram
    assert got == want == own(got_sp._normalize(text))
    assert got_sp.decode(got) == want_sp.decode(want)
    if any(ord(c) > 127 for c in text):
        assert any(got_sp.pieces[i].type == BYTE for i in got) or text == "héllo wörld"


def test_llama2_tokenizer_matches_the_jax_reader(sp_model):
    tok = ttok.get_tokenizer("llama2", str(sp_model))
    want_sp = JSentencePieceModel.from_file(sp_model)
    oracle = want_sp._encode_bpe if want_sp.model_type == 2 else want_sp._encode_unigram
    for text in TEXTS[:5]:
        want = oracle(want_sp._normalize(text))
        assert tok(text) == want
        assert tok(text, add_bos=True, add_eos=True) == [1, *want, 2]
    assert (tok.bos_id, tok.eos_id, tok.pad_id, tok.vocab_size) == (1, 2, 0, len(want_sp))
    assert tok.decode(tok("hello world", add_bos=True, add_eos=True)) == "hello world"


def _write_tiktoken_bpe(path: Path) -> None:
    """A BPE rank file in tiktoken's format (base64 token, rank): every byte, then merges."""
    import base64

    merges = [b"he", b"ll", b"hell", b"hello", b" w", b"or", b" wor", b" world", b"\n\n", b"ass", b"ist", b"assist",
              b"assistant", b"us", b"er", b"user", b" h", b" hello"]
    ranks = [bytes([b]) for b in range(256)] + merges
    path.write_text("".join(f"{base64.b64encode(t).decode()} {i}\n" for i, t in enumerate(ranks)))


@pytest.fixture
def llama3_file(tmp_path, monkeypatch):
    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", "")  # read the file, never a cache keyed on its path
    path = tmp_path / "tokenizer.model"
    _write_tiktoken_bpe(path)
    return str(path)


@pytest.mark.parametrize("text", TEXTS + ["<|eot_id|> is text here", "I'll say 12345 things"])
def test_llama3_tokenizer_equals_the_jax_one(llama3_file, text):
    got, want = ttok.get_tokenizer("llama3", llama3_file), JLlama3Tokenizer(llama3_file)
    assert got(text, add_bos=True, add_eos=True) == want(text, add_bos=True, add_eos=True)
    assert got.decode(got(text)) == want.decode(want(text)) == text
    assert (got.bos_id, got.eos_id, got.pad_id, got.eot_id) == (want.bos_id, want.eos_id, want.pad_id, want.eot_id)
    assert got.vocab_size == 128_010


def test_llama3_chat_template_equals_the_jax_one(llama3_file):
    got, want = ttok.Llama3Tokenizer(llama3_file), JLlama3Tokenizer(llama3_file)
    msgs = [{"role": "system", "content": " hello world "}, {"role": "user", "content": "hello?"}]
    for gen in (True, False):
        ids = got.apply_chat_template(msgs, add_generation_prompt=gen)
        assert ids == want.apply_chat_template(msgs, add_generation_prompt=gen)
    assert ids[0] == got.bos_id and ids[-1] == got.eot_id and ids.count(got.start_header_id) == 2
    assert got.apply_chat_template(msgs)[-3:-1] != [got.eot_id, got.start_header_id]


def test_byte_tokenizer_and_registry():
    tok, jtok = ttok.get_tokenizer("byte"), JByteTokenizer()
    for text in TEXTS:
        assert tok(text, add_bos=True, add_eos=True) == jtok(text, add_bos=True, add_eos=True)
        assert tok.decode(tok(text)) == jtok.decode(jtok(text)) == text
    with pytest.raises(KeyError, match="llama2/llama3/byte"):
        ttok.get_tokenizer("gpt2")


# ---------------------------------------------------------------------------
# the native build
# ---------------------------------------------------------------------------

_BUILD_ONE = """
import hashlib, sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
from llama_x_tpu_torch.utils import native
native.BUILD_DIR = Path(sys.argv[1])
while time.time() < float(sys.argv[2]):
    time.sleep(0.005)
lib = native.load_native("flacdec.cc")
assert lib.flac_decode is not None
path = native.library_path("flacdec.cc")
print(path.name, hashlib.sha256(path.read_bytes()).hexdigest())
"""


def test_six_processes_building_at_once_load_the_same_library(tmp_path):
    """Six processes that find no library build it at the same instant: each loads a
    whole library (none sees a half-written file), all under one name with the same
    bytes, and no temporary file is left behind."""
    import time

    script = tmp_path / "build_one.py"
    script.write_text(_BUILD_ONE.format(repo=str(REPO)))
    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path / "build"), str(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-400:] for _, err in outs]
    assert len({out.strip() for out, _ in outs}) == 1
    assert [f.name for f in (tmp_path / "build").iterdir()] == [outs[0][0].split()[0]]


def test_a_failed_native_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cc").write_text("int main( { return 0; }\n")
    monkeypatch.setattr(tnative, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on native/broken.cc") as info:
        tnative.build_native("broken.cc")
    assert "error" in str(info.value)
    assert list((tmp_path / "build").iterdir()) == []
    # the library's name follows its source
    assert tnative.library_path("broken.cc") != (tmp_path / "build" / "libbroken.so")


# ---------------------------------------------------------------------------
# audio files
# ---------------------------------------------------------------------------


def _sine(n, freq=440.0, sr=16_000, amp=0.3):
    return np.round(np.sin(2 * np.pi * freq * np.arange(n) / sr) * amp * 32767).astype(np.int32)


@pytest.mark.parametrize("mode", ["verbatim", "constant", "fixed0", "fixed1", "fixed2", "lpc2"])
def test_flac_decodes_the_exact_samples(mode):
    x = np.full(3000, -1234, np.int32) if mode == "constant" else _sine(5000)
    y, sr = tflac.decode_flac(encode_flac(x, mode=mode))
    assert sr == 16_000 and y.dtype == np.float32
    np.testing.assert_array_equal(y, x.astype(np.float32) / 32768.0)


def test_flac_noise_stereo_and_malformed():
    x = np.random.default_rng(0).integers(-32768, 32768, 4096).astype(np.int32)
    np.testing.assert_array_equal(tflac.decode_flac(encode_flac(x, mode="fixed1"))[0], x / np.float32(32768.0))
    left, right = _sine(2048, 440.0), _sine(2048, 880.0)
    y, _ = tflac.decode_flac(encode_flac(np.stack([left, right], axis=1), mode="fixed2"))
    np.testing.assert_array_equal(y, np.stack([left, right], 1).astype(np.float32).__truediv__(32768.0).mean(axis=1))
    with pytest.raises(ValueError, match="malformed"):
        tflac.decode_flac(b"not a flac stream at all........")
    assert tflac.flac_available()


def _write_wav(path: Path, samples: np.ndarray, sr: int = 16_000, width: int = 2, channels: int = 1):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(samples.astype({1: np.uint8, 2: np.int16, 4: np.int32}[width]).tobytes())


@pytest.mark.parametrize("width,channels", [(2, 1), (1, 1), (4, 1), (2, 2)])
def test_load_audio_wav_equals_the_jax_loader(tmp_path, width, channels):
    rng = np.random.default_rng(width)
    lo, hi = {1: (0, 256), 2: (-32768, 32768), 4: (-2**31, 2**31)}[width]
    samples = rng.integers(lo, hi, 1000 * channels, dtype=np.int64)
    path = tmp_path / "a.wav"
    _write_wav(path, samples, width=width, channels=channels)
    got, want = tls.load_audio(path), jls.load_audio(path)
    assert got[1] == want[1] == 16_000 and got[0].shape == (1000,)
    np.testing.assert_array_equal(got[0], want[0])


def _librispeech_dir(root: Path, ext: str, durations=(1.0, 1.5, 0.8, 2.0, 0.6, 1.2)) -> Path:
    """speaker/chapter/spk-chap.trans.txt beside one audio file per line, two chapters."""
    for chap, durs in (("198", durations[:3]), ("199", durations[3:])):
        d = root / "19" / chap
        d.mkdir(parents=True)
        lines = []
        for i, dur in enumerate(durs):
            utt = f"19-{chap}-{i:04d}"
            x = _sine(int(dur * 16_000), 200.0 + 50 * i)
            if ext == ".wav":
                _write_wav(d / f"{utt}{ext}", x)
            else:
                (d / f"{utt}{ext}").write_bytes(encode_flac(x, mode="fixed2"))
            lines.append(f"{utt} HELLO WORLD NUMBER {chap} {i}")
        (d / f"19-{chap}.trans.txt").write_text("\n".join(lines) + "\n")
    return root


def test_index_librispeech_equals_the_jax_index(tmp_path):
    root = _librispeech_dir(tmp_path, ".wav")
    got, want = tls.index_librispeech(root, ttok.ByteTokenizer()), jls.index_librispeech(root, JByteTokenizer())
    assert got == want and len(got) == 6
    assert ttok.ByteTokenizer().decode(got[0][1]) == " hello world number 198 0."


@pytest.mark.parametrize("batch_size,duration", [(1, 2.0), (2, 3.0)])
def test_librispeech_packed_equals_the_jax_batches(tmp_path, batch_size, duration):
    """More than one epoch of windows, array for array, from one seed: the per-epoch
    permutations, the packing, the skip of an utterance longer than the window. The
    port reads the corpus as FLAC, the JAX package the same samples as WAV (both scale
    by 2^-15), so the port's decoder feeds the same floats."""
    wav_root = _librispeech_dir(tmp_path / "wav", ".wav", durations=(1.0, 1.5, 0.8, 2.5, 0.6, 1.2))
    flac_root = _librispeech_dir(tmp_path / "flac", ".flac", durations=(1.0, 1.5, 0.8, 2.5, 0.6, 1.2))
    kw = dict(audio_duration=duration, seq_len_multiple=16, batch_size=batch_size, seed=3)
    want = iter(jls.LibriSpeechPacked(str(wav_root), JByteTokenizer(), **kw))
    got_ds = tls.LibriSpeechPacked(str(flac_root), ttok.ByteTokenizer(), **kw)
    assert [p.replace(".flac", ".wav") for p, _ in got_ds.samples] == [p for p, _ in jls.index_librispeech(
        wav_root, JByteTokenizer())]
    got = iter(got_ds)
    for _ in range(6):
        a, b = next(got), next(want)
        assert set(a) == set(b) == {"audio", "tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_librispeech_packed_with_the_llama2_tokenizer(tmp_path):
    """The packer over the port's llama2 tokenizer (the C++ encoder) against the JAX
    packer over the JAX reader's Python encoder: the same windows."""
    model = tmp_path / "bpe.model"
    model.write_bytes(_model(_bpe_pieces(), model_type=2))
    jsp = JSentencePieceModel.from_file(model)

    class Oracle:  # the JAX Llama2Tokenizer's ids, through the pure-Python encoder
        bos_id, eos_id, pad_id = 1, 2, 0

        def __call__(self, text, add_bos=False, add_eos=False):
            return [self.bos_id] * add_bos + jsp._encode_bpe(jsp._normalize(text)) + [self.eos_id] * add_eos

    root = _librispeech_dir(tmp_path / "wav", ".wav")
    kw = dict(audio_duration=2.0, seq_len_multiple=8, batch_size=2, seed=0)
    got = iter(tls.LibriSpeechPacked(str(root), ttok.get_tokenizer("llama2", str(model)), **kw))
    want = iter(jls.LibriSpeechPacked(str(root), Oracle(), **kw))
    for _ in range(3):
        a, b = next(got), next(want)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# images and the omni manifest
# ---------------------------------------------------------------------------


def _write_png(path: Path, arr_u8: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr_u8).save(path)


def _caption_dir(root: Path, n: int = 5, tsv: bool = False) -> Path:
    rng = np.random.default_rng(1)
    root.mkdir(parents=True, exist_ok=True)
    recs = []
    for i in range(n):
        h, w = (20, 12) if i % 2 else (9, 16)
        _write_png(root / f"im{i}.png", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        recs.append((f"im{i}.png", f"  a picture number {i} "))
    if tsv:
        (root / "captions.tsv").write_text("\n".join(f"{p}\t{t}" for p, t in recs) + "\n")
    else:
        (root / "captions.jsonl").write_text("\n".join(json.dumps({"image": p, "text": t}) for p, t in recs) + "\n")
    return root


@pytest.mark.parametrize("tsv", [False, True])
def test_image_captions_equal_the_jax_batches(tmp_path, tsv):
    root = _caption_dir(tmp_path, tsv=tsv)
    assert tvis.index_captions(root) == jvis.index_captions(root)
    kw = dict(image_size=16, seq_len_multiple=8, batch_size=2, seed=4, max_text_len=24)
    got, want = iter(tvis.ImageCaptions(str(root), ttok.ByteTokenizer(), **kw)), iter(
        jvis.ImageCaptions(str(root), JByteTokenizer(), **kw))
    for _ in range(4):  # past the first epoch
        a, b = next(got), next(want)
        assert set(a) == set(b) == {"images", "tokens", "labels"} and a["images"].shape == (2, 16, 16, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(tvis.load_image(root / "im1.png", 24), jvis.load_image(root / "im1.png", 24))
    with pytest.raises(FileNotFoundError, match="captions"):
        tvis.index_captions(tmp_path / "nowhere")


@pytest.mark.parametrize("split", ["train", "eval"])
def test_synthetic_shapes_equal_the_jax_task(split):
    """``make_shapes_sample`` rejection-samples its split from the generator, so every
    later draw depends on it: canvases and captions equal the JAX ones in order."""
    rg, rw = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(6):
        (gi, gc), (wi, wc) = tvis.make_shapes_sample(rg, 32, split), jvis.make_shapes_sample(rw, 32, split)
        np.testing.assert_array_equal(gi, wi)
        assert gc == wc
    got = tvis.synthetic_shapes_batches(np.random.default_rng(2), ttok.ByteTokenizer(), 3, 32, 32, split)
    want = jvis.synthetic_shapes_batches(np.random.default_rng(2), JByteTokenizer(), 3, 32, 32, split)
    for _ in range(3):
        a, b = next(got), next(want)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    pairs = [(a, b, c, d) for a in range(6) for b in range(4) for c in range(6) for d in range(4)]
    assert all(tvis.shapes_split(p) == jvis.shapes_split(p) for p in pairs)


def _omni_dir(root: Path, audio: bool, image: bool, n: int = 5) -> Path:
    rng = np.random.default_rng(0)
    root.mkdir(parents=True, exist_ok=True)
    recs = []
    for i in range(n):
        rec = {"text": f"sample number {i} "}
        if audio:
            _write_wav(root / f"a{i}.wav", rng.integers(-9000, 9000, 4000 + 1000 * i))
            rec["audio"] = f"a{i}.wav"
        if image:
            _write_png(root / f"i{i}.png", rng.integers(0, 256, (16, 12, 3), dtype=np.uint8))
            rec["image"] = f"i{i}.png"
        recs.append(rec)
    (root / "manifest.jsonl").write_text("\n".join(json.dumps(r) for r in recs))
    return root


@pytest.mark.parametrize("audio,image", [(True, True), (False, True), (True, False)])
def test_omni_manifest_equals_the_jax_batches(tmp_path, audio, image):
    root = _omni_dir(tmp_path, audio, image)
    kw = dict(audio_duration=0.5, image_size=16, seq_len_multiple=8, batch_size=2, seed=1, max_text_len=32)
    got_ds = tomni.OmniManifest(str(root), ttok.ByteTokenizer(), **kw)
    want_ds = jomni.OmniManifest(str(root), JByteTokenizer(), **kw)
    assert (got_ds.has_audio, got_ds.has_image) == (want_ds.has_audio, want_ds.has_image) == (audio, image)
    got, want = iter(got_ds), iter(want_ds)
    for _ in range(4):
        a, b = next(got), next(want)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_omni_manifest_refuses_heterogeneous_records(tmp_path):
    _write_png(tmp_path / "i0.png", np.zeros((8, 8, 3), np.uint8))
    recs = [{"text": "a", "image": "i0.png"}, {"text": "b"}]
    (tmp_path / "manifest.jsonl").write_text("\n".join(json.dumps(r) for r in recs))
    with pytest.raises(ValueError, match="heterogeneous"):
        tomni.index_manifest(tmp_path)
    with pytest.raises(AssertionError, match="heterogeneous"):  # the JAX package refuses it too
        jomni.index_manifest(tmp_path)
    (tmp_path / "manifest.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="empty"):
        tomni.index_manifest(tmp_path)


# ---------------------------------------------------------------------------
# wer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("refs,hyps", [
    (["the cat sat"], ["the cat sat"]), (["the cat sat"], ["the sat"]), (["the cat sat"], ["a the cat sat on"]),
    (["a b c", "d e"], ["a x c", ""]), ([""], ["word"]), (["one two three four"], ["four three two one"]),
])
def test_wer_equals_the_jax_metric(refs, hyps):
    assert twer.wer(refs, hyps) == jwer.wer(refs, hyps)
    for r, h in zip(refs, hyps):
        assert twer.edit_distance(r.split(), h.split()) == jwer.edit_distance(r.split(), h.split())
    with pytest.raises(ValueError, match="hypotheses"):
        twer.wer(refs, hyps + ["x"])


# ---------------------------------------------------------------------------
# the trainers' real-data paths
# ---------------------------------------------------------------------------

SMALL = ["--device", "cpu", "--dtype", "float32", "--n_steps", "2", "--log_interval", "1", "--ckpt_interval", "0",
         "--synthetic_config", '{"num_layers": 1, "embed_dim": 64, "intermediate_dim": 128}']


@pytest.mark.parametrize("tokenizer", ["byte", "llama2"])
def test_train_librispeech_reads_a_dataset_dir(tmp_path, monkeypatch, tokenizer):
    """``--dataset_dir`` over FLAC files with the byte or the llama2 tokenizer: the
    packed windows feed two steps, and the model's vocabulary holds the tokenizer's ids."""
    from llama_x_tpu_torch import train_librispeech as entry

    root = _librispeech_dir(tmp_path / "data", ".flac")
    flags = ["--dataset_dir", str(root), "--audio_duration", "2", "--seq_len_multiple", "16", "--prefix_lm", *SMALL]
    if tokenizer == "llama2":
        model = tmp_path / "bpe.model"
        model.write_bytes(_model(_bpe_pieces(), model_type=2))
        flags += ["--tokenizer", "llama2", "--tokenizer_path", str(model)]
    monkeypatch.chdir(tmp_path)
    entry.main(flags)
    (run,) = (tmp_path / "runs" / "librispeech").iterdir()
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1] and all(np.isfinite(r["loss"]) for r in recs)
    config = json.loads((run / "model_config.json").read_text())["llama"]
    assert config["vocab_size"] == 512 and config["num_layers"] == 1


def test_train_vision_and_omni_read_a_dataset_dir(tmp_path, monkeypatch):
    from llama_x_tpu_torch import train_omni, train_vision

    monkeypatch.chdir(tmp_path)
    captions = _caption_dir(tmp_path / "captions")
    train_vision.main(["--dataset_dir", str(captions), "--image_size", "16", "--patch_size", "8",
                       "--seq_len_multiple", "8", "--batch_size", "2", "--prefix_lm", *SMALL])
    corpus = _omni_dir(tmp_path / "corpus", audio=True, image=True)
    train_omni.main(["--dataset_dir", str(corpus), "--image_size", "16", "--patch_size", "8", "--audio_duration", "0.5",
                     "--seq_len_multiple", "8", "--max_text_len", "32", "--batch_size", "2", "--prefix_lm", *SMALL])
    for task in ("vision", "omni"):
        (run,) = (tmp_path / "runs" / task).iterdir()
        recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        assert [r["step"] for r in recs] == [0, 1] and all(np.isfinite(r["loss"]) for r in recs)


def test_check_supported_refuses_only_what_is_missing():
    """--tokenizer and --tokenizer_path pass, and so do a dp x cp --mesh with ring / ulysses,
    --model, a --mesh with fsdp / pp / tp above 1, --pp_microbatches and attn_q8(s); real text
    data needs its token cache and raises naming the file where there is none."""
    import argparse

    from llama_x_tpu_torch.train import cli

    def args(*argv, dataset=False):
        parser = argparse.ArgumentParser()
        cli.add_common_args(parser)
        if dataset:
            parser.add_argument("--dataset_dir")
        return parser.parse_args(["--device", "cpu", *argv])

    cli.check_supported(args("--synthetic", "4", "--tokenizer", "llama3", "--tokenizer_path", "t.model"))
    cli.check_supported(args("--dataset_dir", "d", "--tokenizer", "llama2", dataset=True), real_data=None)
    cli.check_supported(args("--synthetic", "4", "--mesh", '{"dp": 2, "cp": 2}', "--attn_impl", "ulysses"))
    for flags in (["--mesh", '{"pp": 2}'], ["--pp_microbatches", "2"], ["--mesh", '{"dp": 2, "fsdp": 2}']):
        cli.check_supported(args("--synthetic", "4", *flags))  # slice 5b: ported
    cli.check_supported(args("--synthetic", "4", "--remat_policy", "attn_q8"))  # slice 2c: ported
    cli.check_supported(args("--synthetic", "4", "--model", "m"))  # HF import: slice 3, ported
    from llama_x_tpu_torch.data.metamathqa import cache_path

    missing = cache_path("llama3", 1024, str(Path(__file__).parent / "no_such_dir"))
    with pytest.raises(FileNotFoundError, match="metamathqa_llama3_s1024.npz"):
        cli.check_supported(args("--tokenizer", "llama3"), real_data=missing)
    with pytest.raises(ValueError, match="--dataset_dir"):
        cli.check_supported(args(dataset=True), real_data=None)


# ---------------------------------------------------------------------------
# the port's import rules
# ---------------------------------------------------------------------------


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def test_the_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "llama_x_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    for path in files:
        bad = {n for n in _imports(path) if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "llama_x_tpu")}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_the_new_entry_points_import_neither_pil_nor_tiktoken():
    """The card's machine has neither: no module the trainers, the evaluations or
    chip_smoke.py import may import them when it is imported."""
    code = ("import sys; import llama_x_tpu_torch.train_omni, llama_x_tpu_torch.train_vision, "
            "llama_x_tpu_torch.eval_vision, llama_x_tpu_torch.eval_librispeech, llama_x_tpu_torch.train_librispeech, "
            "llama_x_tpu_torch.data.omni, llama_x_tpu_torch.data.tokenizers, llama_x_tpu_torch.train.checkpoint; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'tiktoken', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-500:]
    assert out.stdout.strip() == "[]"
