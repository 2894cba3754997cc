"""CLIP byte-pair-encoding tokenizer (host-side, pure Python and numpy).

The port's own copy of ``oryon_tpu/models/tokenizer.py`` (the port imports
nothing of the JAX package); a test holds the two to the same token ids.
Implements the published CLIP BPE scheme: byte->unicode mapping, lower-cased
word split, BPE merges, <|startoftext|>/<|endoftext|> framing, context
length 77.

The merges file (``bpe_simple_vocab_16e6.txt.gz``) ships with CLIP weights.
When it is unavailable the tokenizer falls
back to a deterministic byte-level vocabulary — same id layout (SOT/EOT at
the top of the table), so models and tests exercise identical shapes; swap
in the real merges file for CLIP-exact token ids.
"""
from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

try:
    import regex as re
    _WORD_PATTERN = (
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
    )
except ImportError:  # pragma: no cover
    import re  # type: ignore
    # stdlib re cannot compile \p{..}: use the Unicode-category-equivalent
    # classes ([^\W\d_] = letters, \d = digits under re.UNICODE). '_' is in
    # \w but NOT a letter/digit, so the punctuation class must name it
    # explicitly ([^\s\w]|_) to match the regex-module pattern. Tokens then
    # differ from the regex-module pattern only for exotic numerals.
    _WORD_PATTERN = (
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        r"""[^\W\d_]+|\d|(?:[^\s\w]|_)+"""
    )

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408  # 256 bytes + 256 byte</w> + 48894 merges + SOT + EOT


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (standard GPT-2/CLIP table)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


try:  # ftfy is optional; resolve ONCE (a per-call failing import costs
    import ftfy  # ~2 ms of sys.path scanning every encode — profiled)
except ImportError:  # pragma: no cover
    ftfy = None


def _basic_clean(text: str) -> str:
    # html unescape twice like the published pipeline
    if ftfy is not None:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    def __init__(self, bpe_path: str | None = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        base = list(bytes_to_unicode().values())
        vocab = base + [v + "</w>" for v in base]

        merges: List[Tuple[str, str]] = []
        if bpe_path and os.path.exists(bpe_path):
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:  # type: ignore[arg-type]
                lines = f.read().split("\n")
            # published file: first line is a header; merges occupy
            # lines 1..49152-256*2-2
            for line in lines[1 : VOCAB_SIZE - 256 * 2 - 2 + 1]:
                parts = tuple(line.split())
                if len(parts) == 2:
                    merges.append(parts)  # type: ignore[arg-type]
            vocab.extend("".join(m) for m in merges)
        self.bpe_ranks = dict(zip(merges, range(len(merges))))

        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(vocab)
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self._encode_cache: Dict[str, List[int]] = {}
        self.pat = re.compile(_WORD_PATTERN, re.IGNORECASE)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            out = " ".join(word)
            self.cache[token] = out
            return out
        pairs = _get_pairs(word)
        while pairs:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        # memoized per tokenizer: the pipeline re-tokenizes the same ~1.6k
        # template x class strings every pair (80 prompts/pair)
        hit = self._encode_cache.get(text)
        if hit is not None:
            return list(hit)
        tokens: List[int] = []
        clean = _whitespace_clean(_basic_clean(text)).lower()
        for tok in re.findall(self.pat, clean):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        if len(self._encode_cache) < 100_000:
            # store an immutable copy: callers may mutate the returned list
            # (e.g. append EOT) and must never poison the memo
            self._encode_cache[text] = tuple(tokens)
        return tokens

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Sequence[str], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Tokenize to a fixed [len(texts), context_length] int32 array with
        SOT/EOT framing; over-long prompts are truncated keeping EOT last
        (reference models/tokenizer.py:136-151 semantics)."""
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                ids = ids[: context_length - 1] + [self.eot]
            out[i, : len(ids)] = ids
        return out
