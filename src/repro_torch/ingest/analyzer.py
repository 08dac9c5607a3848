"""Hashed-vocab text analyzer: raw strings -> shape-stable term ids. The
port's own copy of ``repro/ingest/analyzer.py`` (no numpy, no torch).

The index's sparse paths (learned + lexical) need *fixed* id spaces so every
``SparseVec`` stays ELL shape-stable across streaming inserts — a growing
string vocabulary would change array widths and evict compiled executables.
Feature hashing (Weinberger et al.; what Vowpal Wabbit and SEISMIC-style
pipelines ship) gives that for free: a term's id is a stable 64-bit FNV-1a
hash folded into a fixed ``vocab_size``, so any document ever seen maps into
the same id space with zero vocabulary state. Collisions merge term counts,
which BM25/TF-IDF tolerate gracefully at the vocab sizes used here.

Two id spaces are derived from the same token stream:

  * ``learned_id`` — the big hashed vocab (SPLADE-analogue learned-sparse
    path, ``FusedVectors.learned``);
  * ``lexical_id`` — a smaller keyword vocab (BM25/full-text path,
    ``FusedVectors.lexical``) whose ids double as the keyword set K(·) used
    by ``pruning.keyword_flags`` and keyword-constrained search.

Analysis is lowercase + stopword removal + optional char n-grams; it is a
pure function of (text, config) — the determinism the round-trip tests and
the frozen-corpus-stats streaming contract both rely on.
"""

from __future__ import annotations

import dataclasses
import functools
import re

# a compact English stopword list (function words only — deliberately small
# so domain terms are never swallowed)
STOPWORDS = frozenset(
    """a an and are as at be been but by for from had has have he her his i if
    in into is it its me my nor not of on or our she so that the their them
    then there these they this to was we were what when where which who will
    with you your""".split()
)

_TOKEN_RE = re.compile(r"[A-Za-z][A-Za-z']*|[0-9]+")
_QUOTED_RE = re.compile(r'"([^"]+)"')

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv1a(s: str) -> int:
    """Stable 64-bit FNV-1a hash (platform/process independent, unlike
    Python's salted ``hash``)."""
    h = _FNV_OFFSET
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


@dataclasses.dataclass(frozen=True)
class AnalyzerConfig:
    vocab_size: int = 32768  # learned-sparse hashed vocab
    lexical_vocab_size: int = 8192  # keyword/full-text hashed vocab
    lowercase: bool = True
    min_token_len: int = 2
    char_ngrams: int = 0  # 0 or 1 = off; n >= 2 also emits "#<gram>" n-grams
    use_stopwords: bool = True
    extra_stopwords: tuple[str, ...] = ()

    def stopword_set(self) -> frozenset:
        return _stopword_set(self.use_stopwords, self.extra_stopwords)


@functools.lru_cache(maxsize=64)
def _stopword_set(use_stopwords: bool, extra: tuple[str, ...]) -> frozenset:
    # cached: tokenize() runs once per document on the ingestion hot path
    base = STOPWORDS if use_stopwords else frozenset()
    return base | frozenset(extra)


def raw_tokens(text: str) -> list[str]:
    """Case-preserving word tokens (the entity extractor's view)."""
    return _TOKEN_RE.findall(text)


def tokenize(text: str, cfg: AnalyzerConfig) -> list[str]:
    """Analyzed terms: lowercased, stopword-filtered, length-filtered, plus
    optional char n-grams (prefixed ``#`` so they never collide with words
    at the string level)."""
    stop = cfg.stopword_set()
    out: list[str] = []
    for tok in _TOKEN_RE.findall(text):
        if cfg.lowercase:
            tok = tok.lower()
        if len(tok) < cfg.min_token_len or tok in stop:
            continue
        out.append(tok)
        if cfg.char_ngrams > 1 and len(tok) > cfg.char_ngrams:
            n = cfg.char_ngrams
            out.extend(f"#{tok[i:i + n]}" for i in range(len(tok) - n + 1))
    return out


def learned_id(term: str, cfg: AnalyzerConfig) -> int:
    return fnv1a(term) % cfg.vocab_size


def lexical_id(term: str, cfg: AnalyzerConfig) -> int:
    # salt the lexical space so the two hashed vocabs fold independently
    return fnv1a("kw\x00" + term) % cfg.lexical_vocab_size


def term_counts(terms: list[str], id_fn, cfg: AnalyzerConfig) -> dict[int, int]:
    """term list -> {hashed id: count}; hash collisions merge counts, so ids
    are unique per document by construction (the ELL row invariant)."""
    counts: dict[int, int] = {}
    for t in terms:
        i = id_fn(t, cfg)
        counts[i] = counts.get(i, 0) + 1
    return counts


def quoted_phrases(text: str) -> list[str]:
    """Phrases the user put in double quotes — the analyzer's convention for
    *required* keywords (query side only)."""
    return _QUOTED_RE.findall(text)
