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


# --- fast tokenizers (tokenizer.json), Kandinsky 2.1's MCLIP ---
#
# The card's machine has neither `transformers` nor `tokenizers`, so the
# port reads a fast tokenizer's tokenizer.json itself, as far as MCLIP's
# needs go: XLM-R's layout (the Unigram model; the Sequence, Replace and
# Precompiled normalizers, the last sentencepiece's compiled normalisation
# map; the Metaspace pre-tokenizer; the TemplateProcessing or
# RobertaProcessing post-processor) and the WordLevel model with the
# Whitespace pre-tokenizer; added tokens matched in the raw text. Anything
# else raises ValueError when the file is read, never a silent difference.

_UNK_PENALTY = 10.0  # tokenizers' Unigram: an unknown char scores min - 10


class _Precompiled:
    """sentencepiece's precompiled charsmap: a darts-clone double-array trie
    over UTF-8 keys whose values index NUL-terminated replacement strings,
    applied per grapheme as tokenizers' `Precompiled` normalizer does."""

    def __init__(self, blob: bytes):
        size = int.from_bytes(blob[:4], "little")
        self.units = np.frombuffer(blob[4:4 + size], dtype="<u4").astype(np.int64)
        self.normalized = blob[4 + size:]

    def _search(self, key: bytes) -> list[int]:
        units = self.units
        unit = int(units[0])
        pos = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        found = []
        for c in key:
            if c == 0:
                break
            pos ^= c
            unit = int(units[pos])
            if (unit & ((1 << 31) | 0xFF)) != c:
                break
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                found.append(int(units[pos]) & ((1 << 31) - 1))
        return found

    def _transform(self, chunk: str) -> str | None:
        found = self._search(chunk.encode("utf-8"))
        if not found:
            return None
        start = found[0]
        end = self.normalized.index(b"\0", start) if b"\0" in self.normalized[start:] else len(
            self.normalized)
        return self.normalized[start:end].decode("utf-8")

    def __call__(self, text: str) -> str:
        import unicodedata

        # graphemes, approximated as a base character and the combining
        # marks after it
        graphemes: list[str] = []
        for ch in text:
            if graphemes and unicodedata.combining(ch):
                graphemes[-1] += ch
            else:
                graphemes.append(ch)
        out = []
        for g in graphemes:
            if len(g.encode("utf-8")) < 6:
                norm = self._transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self._transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


def _pattern(spec: dict):
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    return re.compile(spec["Regex"])


def _normalizer(spec: dict | None):
    import base64

    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_normalizer(n) for n in spec["normalizers"]]

        def seq(s):
            for part in parts:
                s = part(s)
            return s
        return seq
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.sub(lambda _: content, s)
    if kind == "Precompiled":
        blob = spec.get("precompiled_charsmap")
        if not blob:
            return lambda s: s
        return _Precompiled(base64.b64decode(blob))
    raise ValueError(f"tokenizer.json normalizer {kind!r} is not supported")


def _pre_tokenizer(spec: dict | None):
    """-> fn(text) -> list of pieces."""
    if spec is None:
        return lambda s: [s] if s else []
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(s):
            pieces = [s]
            for part in parts:
                pieces = [q for p in pieces for q in part(p)]
            return pieces
        return seq
    if kind == "Whitespace":
        return re.compile(r"\w+|[^\w\s]+").findall
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme", "always" if spec.get("add_prefix_space", True)
                          else "never")
        split = spec.get("split", True)

        def meta(s):
            s = s.replace(" ", rep)
            if scheme in ("always", "first") and not s.startswith(rep):
                s = rep + s
            if not split:
                return [s] if s else []
            pieces, cur = [], ""
            for ch in s:
                if ch == rep and cur:
                    pieces.append(cur)
                    cur = ""
                cur += ch
            return pieces + ([cur] if cur else [])
        return meta
    raise ValueError(f"tokenizer.json pre_tokenizer {kind!r} is not supported")


class FastTokenizer:
    """A tokenizer.json reader: `(texts, max_length)` -> (ids int64 [B, L],
    attention mask f32 [B, L]), truncated with room for the special tokens
    and right-padded with the pad id, as `transformers`' fast tokenizer
    does with `padding="max_length", truncation=True`."""

    def __init__(self, spec: dict, pad_token: str | None = None):
        model = spec["model"]
        self.kind = model["type"]
        if self.kind == "WordLevel":
            self.vocab = dict(model["vocab"])
            self.unk_id = self.vocab.get(model.get("unk_token"))
        elif self.kind == "Unigram":
            pieces = model["vocab"]
            self.vocab = {p: i for i, (p, _) in enumerate(pieces)}
            self.scores = [float(s) for _, s in pieces]
            self.unk_id = model.get("unk_id")
            if model.get("byte_fallback"):
                raise ValueError("tokenizer.json Unigram byte_fallback is not supported")
            self.min_score = min(self.scores) if self.scores else 0.0
            self.max_piece = max((len(p) for p, _ in pieces), default=1)
        else:
            raise ValueError(f"tokenizer.json model {self.kind!r} is not supported")
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.added = {t["content"]: t["id"] for t in spec.get("added_tokens") or []}
        self._added_split = None
        if self.added:
            alt = "|".join(re.escape(t) for t in sorted(self.added, key=len, reverse=True))
            self._added_split = re.compile(f"({alt})")
        self.prefix, self.suffix = self._template(spec.get("post_processor"))
        pad = (spec.get("padding") or {}).get("pad_id")
        if pad is None:
            pad = self.token_id(pad_token) if pad_token is not None else None
        self.pad_id = 1 if pad is None else int(pad)

    def token_id(self, token: str) -> int | None:
        return self.added.get(token, self.vocab.get(token))

    def _template(self, spec: dict | None) -> tuple[list[int], list[int]]:
        """The single-sequence special ids before and after the text."""
        if spec is None:
            return [], []
        kind = spec["type"]
        if kind == "TemplateProcessing":
            specials = spec.get("special_tokens", {})
            before, after, seen = [], [], False
            for item in spec["single"]:
                if "Sequence" in item:
                    seen = True
                    continue
                ids = specials[item["SpecialToken"]["id"]]["ids"]
                (after if seen else before).extend(ids)
            return before, after
        if kind == "RobertaProcessing":
            return [int(spec["cls"][1])], [int(spec["sep"][1])]
        raise ValueError(f"tokenizer.json post_processor {kind!r} is not supported")

    def _unigram(self, s: str) -> list[int]:
        n = len(s)
        best = [(0.0, -1, -1)] * (n + 1)  # (score, start, id)
        best[0] = (0.0, 0, -1)
        unk_score = self.min_score - _UNK_PENALTY
        for start in range(n):
            here = best[start][0]
            single = False
            for length in range(1, min(self.max_piece, n - start) + 1):
                tid = self.vocab.get(s[start:start + length])
                if tid is None:
                    continue
                cand = here + self.scores[tid]
                end = start + length
                if best[end][1] < 0 or cand > best[end][0]:
                    best[end] = (cand, start, tid)
                single = single or length == 1
            if not single:
                cand = here + unk_score
                if best[start + 1][1] < 0 or cand > best[start + 1][0]:
                    best[start + 1] = (cand, start, self.unk_id)
        ids, pos = [], n
        while pos > 0:
            _, pos, tid = best[pos]
            ids.append(tid)
        out = []
        for tid in reversed(ids):
            if tid == self.unk_id and out and out[-1] == self.unk_id:
                continue  # consecutive unknowns fuse
            out.append(tid)
        return out

    def _word_level(self, piece: str) -> list[int]:
        tid = self.vocab.get(piece, self.unk_id)
        if tid is None:
            raise ValueError(f"token {piece!r} has no id and the vocabulary no unk token")
        return [tid]

    def encode(self, text: str) -> list[int]:
        parts = self._added_split.split(text) if self._added_split else [text]
        ids: list[int] = []
        for part in parts:
            if part in self.added:
                ids.append(self.added[part])
                continue
            if not part:
                continue
            for piece in self.pre_tokenize(self.normalize(part)):
                ids.extend(self._unigram(piece) if self.kind == "Unigram"
                           else self._word_level(piece))
        return ids

    def __call__(self, texts: str | list[str], max_length: int = 77):
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), max_length), self.pad_id, dtype=np.int64)
        mask = np.zeros((len(texts), max_length), dtype=np.float32)
        room = max_length - len(self.prefix) - len(self.suffix)
        for row, text in enumerate(texts):
            seq = self.prefix + self.encode(text)[:max(room, 0)] + self.suffix
            ids[row, :len(seq)] = seq
            mask[row, :len(seq)] = 1.0
        return ids, mask


def load_fast_tokenizer(tok_dir: str | Path) -> FastTokenizer:
    """The fast tokenizer of `tok_dir`/tokenizer.json, its pad token from
    tokenizer_config.json where the file names none. Raises
    FileNotFoundError without the file."""
    tok_dir = Path(tok_dir)
    spec = json.loads((tok_dir / "tokenizer.json").read_text())
    pad_token = None
    config = tok_dir / "tokenizer_config.json"
    if config.is_file():
        pad = json.loads(config.read_text()).get("pad_token")
        pad_token = pad.get("content") if isinstance(pad, dict) else pad
    return FastTokenizer(spec, pad_token)
