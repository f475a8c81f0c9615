"""CLIP BPE tokenizer (self-contained, offline).

A copy of chiaswarm_tpu/models/tokenizer.py (the port imports nothing of
the JAX package), with its textual-inversion placeholder tokenizer.

The reference gets tokenization implicitly through diffusers pipelines; a
worker must not depend on hub downloads at job time, so the byte-pair
encoder is implemented here and reads `vocab.json` + `merges.txt` from the
local model root. When no vocab ships with a model (hermetic tests, tiny
models), a deterministic hash tokenizer keeps the full text->ids->embedding
path exercised with the same padding/BOS/EOS layout.
"""

from __future__ import annotations

import functools
import hashlib
import json
import re
from pathlib import Path

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte -> unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# CLIP's word pattern; \p{L}/\p{N} classes approximated with str.isalpha-
# compatible ASCII ranges plus a catch-all (stdlib `re` has no \p support)
_WORD_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
    r"""|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


def _clean(text: str) -> str:
    return re.sub(r"\s+", " ", text.strip()).lower()


class CLIPTokenizer:
    """Byte-pair encoding with </w> word terminals, CLIP layout:
    [BOS, tokens..., EOS, pad(EOS or 0)...] to max_length."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 max_length: int = 77):
        self.vocab = vocab
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos = vocab.get("<|startoftext|>", len(vocab) - 2)
        self.eos = vocab.get("<|endoftext|>", len(vocab) - 1)
        # per-token BPE memo (HF tokenizers keep the same memo
        # unbounded): entries are a few hundred bytes and the key space
        # is natural-language vocabulary, not request volume
        self._cache: dict[str, list[str]] = {}  # swarmlint: disable=SW007

    @classmethod
    def from_dir(cls, path: str | Path, max_length: int = 77) -> "CLIPTokenizer":
        path = Path(path)
        vocab = json.loads((path / "vocab.json").read_text())
        merges = []
        for line in (path / "merges.txt").read_text().splitlines():
            if line.startswith("#") or not line.strip():
                continue
            a, b = line.split()
            merges.append((a, b))
        return cls(vocab, merges, max_length)

    def bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = [self.byte_encoder[b] for b in token.encode("utf-8")]
        if not word:
            return []
        word[-1] = word[-1] + "</w>"

        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged

        self._cache[token] = word
        return word

    def encode(self, text: str) -> list[int]:
        ids = []
        for token in _WORD_PATTERN.findall(_clean(text)):
            for piece in self.bpe(token):
                ids.append(self.vocab.get(piece, self.eos))
        return ids

    def __call__(self, texts: str | list[str]) -> np.ndarray:
        """-> int32 [B, max_length] with BOS/EOS and EOS padding."""
        if isinstance(texts, str):
            texts = [texts]
        batch = np.full((len(texts), self.max_length), self.eos, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)[: self.max_length - 2]
            batch[row, 0] = self.bos
            batch[row, 1 : 1 + len(ids)] = ids
            batch[row, 1 + len(ids)] = self.eos
        return batch


class HashTokenizer:
    """Deterministic fallback: word -> stable hash id. Keeps the BOS/EOS/pad
    layout of CLIPTokenizer so models see realistic id patterns in tests."""

    def __init__(self, vocab_size: int = 1000, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos = vocab_size - 2
        self.eos = vocab_size - 1

    def encode(self, text: str) -> list[int]:
        words = _clean(text).split()
        ids = []
        for w in words:
            digest = hashlib.sha256(w.encode()).digest()
            ids.append(int.from_bytes(digest[:4], "little") % (self.vocab_size - 2))
        return ids

    def __call__(self, texts: str | list[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        batch = np.full((len(texts), self.max_length), self.eos, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)[: self.max_length - 2]
            batch[row, 0] = self.bos
            batch[row, 1 : 1 + len(ids)] = ids
            batch[row, 1 + len(ids)] = self.eos
        return batch


class PlaceholderTokenizer:
    """A base tokenizer extended with textual-inversion placeholders: each
    placeholder string maps to a fixed run of ids past the base vocabulary
    (rows of the job's extra embedding table, models/clip.py). The text is
    split on the placeholders before BPE, so bracketed or multi-word ones
    like `<gta5-artwork>` survive intact."""

    def __init__(self, base, placeholders: dict[str, list[int]]):
        self.base = base
        self.placeholders = dict(placeholders)
        self.max_length = base.max_length
        self.bos = base.bos
        self.eos = base.eos
        self._splitter = None
        if self.placeholders:
            pattern = "|".join(re.escape(p)
                               for p in sorted(self.placeholders, key=len, reverse=True))
            self._splitter = re.compile(f"({pattern})")

    def encode(self, text: str) -> list[int]:
        if self._splitter is None:
            return self.base.encode(text)
        ids: list[int] = []
        for part in self._splitter.split(text):
            if part in self.placeholders:
                ids.extend(self.placeholders[part])
            elif part:
                ids.extend(self.base.encode(part))
        return ids

    def __call__(self, texts: str | list[str]) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        batch = np.full((len(texts), self.max_length), self.eos, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = self.encode(text)[: self.max_length - 2]
            batch[row, 0] = self.bos
            batch[row, 1 : 1 + len(ids)] = ids
            batch[row, 1 + len(ids)] = self.eos
        return batch


def load_tokenizer(model_dir: str | Path | None, vocab_size: int = 49408,
                   max_length: int = 77):
    """CLIPTokenizer when vocab files exist under the model dir, else hash."""
    if model_dir is not None:
        tok_dir = Path(model_dir) / "tokenizer"
        if (tok_dir / "vocab.json").is_file() and (tok_dir / "merges.txt").is_file():
            return CLIPTokenizer.from_dir(tok_dir, max_length)
    return HashTokenizer(vocab_size, max_length)
