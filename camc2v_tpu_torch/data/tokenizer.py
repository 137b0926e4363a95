"""CLIP byte-pair-encoding tokenizer (host-side, pure Python); a copy of
`camc2v_tpu/data/tokenizer.py`, held to it by the CPU tests.

Replaces `open_clip.tokenize` (reference: lvdm/modules/encoders/
condition.py:210) — the standard CLIP BPE: lowercase + whitespace/HTML
cleanup, byte-to-unicode mapping, greedy merge by rank, wrapped in
<start_of_text>/<end_of_text>, padded/truncated to 77 ids.

The merges file (`bpe_simple_vocab_16e6.txt`, optionally gzipped) is a data
dependency supplied like model checkpoints (this image has no network). Tests
exercise the algorithm with a synthetic merge table; `HashTokenizer` is the
dependency-free stand-in for smoke tests.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Sequence

import numpy as np


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP standard)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
    if False
    else r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


class SimpleTokenizer:
    """CLIP BPE. `bpe_path` points at the merges file (txt or txt.gz)."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                merges = f.read().split("\n")
        else:
            with open(bpe_path, encoding="utf-8") as f:
                merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        bpe_tokens: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def __call__(self, texts: str | Sequence[str]) -> np.ndarray:
        """Tokenize to (N, context_length) int32, CLIP padding semantics."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot] + self.encode(text) + [self.eot]
            if len(tokens) > self.context_length:
                tokens = tokens[: self.context_length]
                tokens[-1] = self.eot
            result[i, : len(tokens)] = tokens
        return result if len(result) > 1 else result


class HashTokenizer:
    """Dependency-free stand-in: deterministic word-hash ids (tests/demos only)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def __call__(self, texts: str | Sequence[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), np.int32)
        import zlib

        for i, text in enumerate(texts):
            words = whitespace_clean(basic_clean(text)).lower().split()
            # crc32: stable across processes (builtin hash() is salted)
            ids = [zlib.crc32(w.encode()) % (self.vocab_size - 2) for w in words]
            tokens = ([self.sot] + ids + [self.eot])[: self.context_length]
            out[i, : len(tokens)] = tokens
        return out


def default_tokenizer(bpe_path: str | None = None, context_length: int = 77):
    """SimpleTokenizer when a merges file is available, else HashTokenizer."""
    if bpe_path and os.path.exists(bpe_path):
        return SimpleTokenizer(bpe_path, context_length)
    env = os.environ.get("CLIP_BPE_PATH")
    if env and os.path.exists(env):
        return SimpleTokenizer(env, context_length)
    return HashTokenizer(context_length=context_length)
