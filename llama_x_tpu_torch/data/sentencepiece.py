"""SentencePiece model reader and encoders (port of llama_x_tpu/data/sentencepiece.py).

Reads the ``tokenizer.model`` protobuf directly (a hand-rolled wire-format parse: the
sentencepiece package is not needed) and encodes with either algorithm sentencepiece
ships:

- BPE (Llama-2's model_type): greedy highest-score adjacent-pair merging over unicode
  symbols;
- Unigram (sentencepiece's default): Viterbi max-score segmentation.

Both honor the normalizer's add_dummy_prefix and the space -> U+2581 escape, and fall
back to <0xXX> byte pieces for characters outside the vocabulary.

``encode`` runs the C++ encoder ``native/spmenc.cc`` (built by utils/native.py; a
failed build raises). ``_encode_bpe`` / ``_encode_unigram`` are the same algorithms in
Python, kept as the semantics oracle that the tests hold the C++ encoder against.

ModelProto fields used (sentencepiece_model.proto, public schema):
  1: repeated SentencePiece { 1: piece (str), 2: score (float), 3: type (enum) }
  2: TrainerSpec { 3: model_type (1=UNIGRAM, 2=BPE) }
  3: NormalizerSpec { 3: add_dummy_prefix (bool) }
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import struct
from dataclasses import dataclass

_SPACE = "\u2581"  # the escaped space


@functools.lru_cache(maxsize=1)
def _native_lib() -> ctypes.CDLL:
    """The C++ encoder, built on first use; raises if it cannot be built."""
    from llama_x_tpu_torch.utils.native import load_native

    lib = load_native("spmenc.cc")
    lib.spm_create.restype = ctypes.c_void_p
    lib.spm_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.spm_free.argtypes = [ctypes.c_void_p]
    for fn in (lib.spm_encode_unigram, lib.spm_encode_bpe):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32),
                       ctypes.c_uint64]
    return lib


# SentencePiece.Type values
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# protobuf wire-format parsing
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.
    value: int for varint/fixed, bytes for length-delimited."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, i)[0]
            i += 8
        elif wire == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i : i + ln]
            i += ln
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


@dataclass
class Piece:
    text: str
    score: float
    type: int


class SentencePieceModel:
    """Parsed tokenizer.model: pieces + encode/decode."""

    def __init__(self, data: bytes):
        self.pieces: list[Piece] = []
        self.model_type = 1  # UNIGRAM default
        self.add_dummy_prefix = True
        for field, _, val in _fields(data):
            if field == 1:  # SentencePiece
                text, score, typ = "", 0.0, NORMAL
                for f2, w2, v2 in _fields(val):
                    if f2 == 1:
                        text = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", struct.pack("<I", v2))[0]
                    elif f2 == 3:
                        typ = v2
                self.pieces.append(Piece(text, score, typ))
            elif field == 2:  # TrainerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3 and w2 == 0:
                        self.model_type = v2
            elif field == 3:  # NormalizerSpec
                for f2, w2, v2 in _fields(val):
                    if f2 == 3 and w2 == 0:
                        self.add_dummy_prefix = bool(v2)

        self.piece_to_id = {p.text: i for i, p in enumerate(self.pieces)}
        self.unk_id = next((i for i, p in enumerate(self.pieces) if p.type == UNKNOWN), 0)
        self._byte_ids = {
            int(p.text[3:5], 16): i for i, p in enumerate(self.pieces) if p.type == BYTE
        }
        self._max_piece_len = max((len(p.text) for p in self.pieces), default=1)
        self._unk_penalty = min((p.score for p in self.pieces if p.type == NORMAL), default=-10.0) - 10.0
        self._native = None  # (library, handle), made on first encode

    def _native_handle(self):
        """(library, handle) of the C++ encoder over this model's pieces; builds the
        library on first use and raises if it cannot be built."""
        if self._native is None:
            lib = _native_lib()
            parts = [struct.pack("<I", len(self.pieces))]
            for p in self.pieces:
                raw = p.text.encode("utf-8")
                parts.append(struct.pack("<fBI", p.score, p.type, len(raw)) + raw)
            blob = b"".join(parts)
            self._native = (lib, lib.spm_create(blob, len(blob)))
        return self._native

    def __del__(self):
        native = getattr(self, "_native", None)
        if native is not None:
            native[0].spm_free(native[1])

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls(f.read())

    def __len__(self):
        return len(self.pieces)

    # -- encoding ------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self.add_dummy_prefix and not text.startswith(" "):
            text = " " + text
        return text.replace(" ", _SPACE)

    def _byte_fallback(self, sym: str) -> list[int]:
        ids = []
        for b in sym.encode("utf-8"):
            ids.append(self._byte_ids.get(b, self.unk_id))
        return ids if self._byte_ids else [self.unk_id]

    def encode(self, text: str) -> list[int]:
        if not text:
            return []
        norm = self._normalize(text)
        lib, handle = self._native_handle()
        raw = norm.encode("utf-8")
        cap = len(raw) + 8  # every id covers at least one byte
        out = (ctypes.c_int32 * cap)()
        fn = lib.spm_encode_bpe if self.model_type == 2 else lib.spm_encode_unigram
        n = fn(handle, raw, len(raw), out, cap)
        if n < 0:
            raise RuntimeError(f"native SentencePiece encoder: {n} for {len(raw)} bytes into {cap} ids")
        return list(out[:n])

    def _encode_bpe(self, norm: str) -> list[int]:
        """Greedy highest-score adjacent merges (the sentencepiece BPE semantics:
        scores encode merge priority, higher merges first; position breaks ties)."""
        # doubly-linked symbol list over unicode characters
        syms = [[c, i - 1, i + 1, True] for i, c in enumerate(norm)]  # text, prev, next, alive

        def pair_score(i: int):
            j = syms[i][2]
            if j >= len(syms):
                return None
            merged = syms[i][0] + syms[j][0]
            idx = self.piece_to_id.get(merged)
            if idx is None or self.pieces[idx].type not in (NORMAL, USER_DEFINED):
                return None
            return (-self.pieces[idx].score, i, merged)

        heap = []
        for i in range(len(syms) - 1):
            item = pair_score(i)
            if item:
                heapq.heappush(heap, item)
        while heap:
            negscore, i, merged = heapq.heappop(heap)
            j = syms[i][2]
            # stale entry: either symbol merged away or texts changed since push
            if not syms[i][3] or j >= len(syms) or not syms[j][3] or syms[i][0] + syms[j][0] != merged:
                continue
            syms[i][0] = merged
            syms[j][3] = False
            syms[i][2] = syms[j][2]
            if syms[i][2] < len(syms):
                syms[syms[i][2]][1] = i
            for cand in (pair_score(syms[i][1]) if syms[i][1] >= 0 else None, pair_score(i)):
                if cand:
                    heapq.heappush(heap, cand)

        ids: list[int] = []
        for text, _, _, alive in syms:
            if not alive:
                continue
            idx = self.piece_to_id.get(text)
            if idx is not None and self.pieces[idx].type != UNUSED:
                ids.append(idx)
            else:
                ids.extend(self._byte_fallback(text))
        return ids

    def _encode_unigram(self, norm: str) -> list[int]:
        """Viterbi max-total-score segmentation with byte-fallback for uncovered
        characters (unk penalty keeps known pieces preferred)."""
        n = len(norm)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: list[tuple[int, int | None]] = [(0, None)] * (n + 1)
        best[0] = 0.0
        unk_penalty = self._unk_penalty  # precomputed: O(vocab) scan does not belong per call
        for i in range(n):
            if best[i] == NEG:
                continue
            for ln in range(1, min(self._max_piece_len, n - i) + 1):
                piece = norm[i : i + ln]
                idx = self.piece_to_id.get(piece)
                if idx is None or self.pieces[idx].type not in (NORMAL, USER_DEFINED):
                    continue
                s = best[i] + self.pieces[idx].score
                if s > best[i + ln]:
                    best[i + ln] = s
                    back[i + ln] = (i, idx)
            # unk single char (byte-fallback at emit time)
            s = best[i] + unk_penalty
            if s > best[i + 1]:
                best[i + 1] = s
                back[i + 1] = (i, None)
        ids_rev: list[int] = []
        pos = n
        while pos > 0:
            start, idx = back[pos]
            if idx is None:
                ids_rev.extend(reversed(self._byte_fallback(norm[start:pos])))
            else:
                ids_rev.append(idx)
            pos = start
        return ids_rev[::-1]

    # -- decoding ------------------------------------------------------------

    def decode(self, ids: list[int]) -> str:
        out: list[bytes] = []
        for i in ids:
            if not 0 <= i < len(self.pieces):
                continue
            p = self.pieces[i]
            if p.type == BYTE:
                out.append(bytes([int(p.text[3:5], 16)]))
            elif p.type in (NORMAL, USER_DEFINED, UNKNOWN):
                out.append(p.text.encode("utf-8"))
        text = b"".join(out).decode("utf-8", errors="replace").replace(_SPACE, " ")
        if self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text
