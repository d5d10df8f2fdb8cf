"""Tokenizer registry (port of llama_x_tpu/data/tokenizers.py).

- llama2: the SentencePiece model of meta-llama/Llama-2-7b-chat-hf, bos 1, eos 2, pad 0,
  read by data/sentencepiece.py (no sentencepiece package needed); needs the
  tokenizer.model file (``model_path``, or the hub where there is a network).
- llama3: tiktoken BPE of Meta-Llama-3.1-8B-Instruct ``original/tokenizer.model`` with the
  Llama-3 split pattern, bos 128000, eos 128001, pad 128004. ``tiktoken`` is imported
  when one is made, never when this module is.
- byte: the offline byte-level tokenizer: 256 byte ids and bos / eos / pad above them.

All three: ``__call__(text, add_bos=False, add_eos=False) -> list[int]``, ``decode``,
``bos_id`` / ``eos_id`` / ``pad_id`` and ``vocab_size`` (the ids the model's
embedding must hold).
"""

from __future__ import annotations


def get_tokenizer(name: str, model_path: str | None = None):
    try:
        factory = {"llama2": Llama2Tokenizer, "llama3": Llama3Tokenizer, "byte": ByteTokenizer}[name]
    except KeyError:
        raise KeyError(f"unknown tokenizer {name!r}; choose from llama2/llama3/byte") from None
    return factory(model_path) if name != "byte" else factory()


class ByteTokenizer:
    """UTF-8 bytes as ids 0..255; specials above. Deterministic + offline."""

    bos_id = 256
    eos_id = 257
    pad_id = 258
    vocab_size = 259

    def __call__(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        tokens = list(text.encode("utf-8"))
        if add_bos:
            tokens.insert(0, self.bos_id)
        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def decode(self, tokens: list[int]) -> str:
        return bytes(t for t in tokens if t < 256).decode("utf-8", errors="replace")


class Llama2Tokenizer:
    """The SentencePiece model of Llama-2 (BPE or unigram, with byte fallback)."""

    bos_id = 1
    eos_id = 2
    pad_id = 0

    def __init__(self, model_path: str | None = None):
        from llama_x_tpu_torch.data.sentencepiece import SentencePieceModel

        if model_path is None:
            try:
                from huggingface_hub import hf_hub_download

                model_path = hf_hub_download("meta-llama/Llama-2-7b-chat-hf", "tokenizer.model")
            except Exception as e:
                raise RuntimeError(
                    "llama2 tokenizer: no --tokenizer_path given and the hub download "
                    "failed (offline or gated repo). Download tokenizer.model from "
                    "meta-llama/Llama-2-7b-chat-hf and pass --tokenizer_path; or use "
                    "--tokenizer llama3/byte."
                ) from e
        self.sp = SentencePieceModel.from_file(model_path)
        self.vocab_size = len(self.sp)

    def __call__(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        tokens = self.sp.encode(text)
        if add_bos:
            tokens.insert(0, self.bos_id)
        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def decode(self, tokens: list[int]) -> str:
        # control pieces (bos / eos) are skipped by the reader; pad (id 0, unk) renders
        # as its piece text, so callers strip pads before decoding
        return self.sp.decode(tokens)


# the Llama-3 pretokenizer split pattern (public, from the Llama 3 release)
_LLAMA3_PAT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


class Llama3Tokenizer:
    bos_id = 128_000
    eos_id = 128_001
    pad_id = 128_004  # <|finetune_right_pad_id|>
    start_header_id = 128_006
    end_header_id = 128_007
    eot_id = 128_009  # end of turn: the chat format's stop token

    def __init__(self, model_path: str | None = None):
        import tiktoken
        from tiktoken.load import load_tiktoken_bpe

        if model_path is None:
            from huggingface_hub import hf_hub_download

            model_path = hf_hub_download("meta-llama/Meta-Llama-3.1-8B-Instruct", "original/tokenizer.model")
        self.enc = tiktoken.Encoding(
            "llama3",
            pat_str=_LLAMA3_PAT,
            mergeable_ranks=load_tiktoken_bpe(model_path),
            special_tokens={
                "<|begin_of_text|>": self.bos_id,
                "<|end_of_text|>": self.eos_id,
                "<|finetune_right_pad_id|>": self.pad_id,
                "<|start_header_id|>": self.start_header_id,
                "<|end_header_id|>": self.end_header_id,
                "<|eot_id|>": self.eot_id,
            },
        )
        self.vocab_size = self.enc.n_vocab

    def apply_chat_template(self, messages, add_generation_prompt: bool = True) -> list[int]:
        """The Llama-3 instruct chat format (public Meta spec): per message
        ``<|start_header_id|>role<|end_header_id|>\\n\\n{content}<|eot_id|>``, opened by
        bos and (for generation) closed with an empty assistant header. Generation
        should stop on ``eot_id``."""
        ids = [self.bos_id]
        for m in messages:
            ids += [self.start_header_id, *self.enc.encode(m["role"]), self.end_header_id]
            ids += self.enc.encode("\n\n" + m["content"].strip()) + [self.eot_id]
        if add_generation_prompt:
            ids += [self.start_header_id, *self.enc.encode("assistant"), self.end_header_id]
            ids += self.enc.encode("\n\n")
        return ids

    def __call__(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        tokens = self.enc.encode(text, disallowed_special=())
        if add_bos:
            tokens.insert(0, self.bos_id)
        if add_eos:
            tokens.append(self.eos_id)
        return tokens

    def decode(self, tokens: list[int]) -> str:
        return self.enc.decode(tokens)
