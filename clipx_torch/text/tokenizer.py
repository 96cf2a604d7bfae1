r"""CLIP byte-pair-encoding tokenizer (host side), the port's own copy.

Counterpart of ``clipx/text/tokenizer.py``: lower-cased byte-level BPE over
a 49,408-token vocabulary (256 byte symbols, 256 end-of-word byte symbols,
48,894 learned merges, ``<|startoftext|>`` = 49406, ``<|endoftext|>`` =
49407), sequences padded to 77. The learned merge table
(``bpe_simple_vocab_16e6.txt.gz``) is an optional input, found as in clipx:
an explicit path, ``$CLIPX_BPE_PATH``, this package's directory, or
``~/.cache/clip``; without it the tokenizer uses the merge-free byte
vocabulary, with the same vocab size, special ids and padding.

clipx splits words with the third-party ``regex`` module (``\p{L}``,
``\p{N}``). The port needs only the standard library: ``_split_words``
scans the text with ``unicodedata.category`` (classes L* and N*) and the
``regex`` module's whitespace set, and reproduces clipx's ``_PAT.findall``
exactly for every character both Unicode databases assign (the two can
differ only on characters newer than Python's ``unicodedata``).
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import unicodedata

import numpy as np

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
VOCAB_SIZE = 49408
CONTEXT_LENGTH = 77
_N_MERGES = VOCAB_SIZE - 256 * 2 - 2  # 48894 learned merges
_CACHE_CAP = 65536  # distinct-word BPE cache bound (see bpe())

# Word splitting, as clipx's pattern (case-insensitive):
#   <\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d
#   |[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# the regex module's \s (Unicode White_Space); str.isspace() also counts
# U+001C..U+001F, which \s does not
_WS_CHARS = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004"
    "\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f"
    "\u3000")
# U+0345 (a combining mark whose case fold is a letter) matches none of the
# case-insensitive classes, so the regex module skips it, like whitespace
_UNMATCHED = "\u0345"


def _kind(ch: str) -> str:
    """'L' letter, 'N' number, ' ' whitespace or unmatched, '' anything
    else."""
    if ch in _WS_CHARS or ch == _UNMATCHED:
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in ("L", "N") else ""


def _ci_match(text: str, i: int, literal: str) -> bool:
    """Case-insensitive literal match at text[i:] (simple case folding:
    U+017F LONG S matches 's', as it does in the regex module)."""
    if i + len(literal) > len(text):
        return False
    for ch, want in zip(text[i: i + len(literal)], literal):
        if ch != want and ch.upper() != want.upper():
            return False
    return True


def _split_words(text: str) -> List[str]:
    """``_PAT.findall(text)`` of clipx's tokenizer, on the stdlib."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        lit = next((x for x in _SPECIALS + _CONTRACTIONS
                    if _ci_match(text, i, x)), None)
        if lit is not None:
            out.append(text[i: i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # letters and other symbols run on; digits do not
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode-char map (GPT-2 scheme).

    Printable ASCII + two Latin-1 ranges map to themselves; the remaining
    68 byte values map to codepoints 256+i so every byte has a visible,
    non-whitespace character.
    """
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    # OpenAI CLIP runs ftfy.fix_text + double html.unescape; ftfy is not
    # available here, so we apply the html unescapes and strip. Mojibake
    # repair is skipped (only affects already-corrupt input text).
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    """Collapse every whitespace run (the regex module's \\s) to one
    space, then strip."""
    out: List[str] = []
    in_ws = False
    for ch in text:
        if ch in _WS_CHARS:
            if not in_ws:
                out.append(" ")
            in_ws = True
        else:
            out.append(ch)
            in_ws = False
    return "".join(out).strip()


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word, word[1:])}


def _find_merge_file(path: Optional[str]) -> Optional[str]:
    if path:
        return path
    env = os.environ.get("CLIPX_BPE_PATH")
    if env:
        if os.path.exists(env):
            return env
        # an explicitly configured path that doesn't exist is a config
        # error — falling back silently would swap in the byte-fallback
        # vocabulary and quietly mismatch real checkpoint weights
        raise FileNotFoundError(
            f"$CLIPX_BPE_PATH={env!r} does not exist (unset it to use "
            f"the byte-fallback vocabulary, or fix the path)")
    for cand in (
        os.path.join(os.path.dirname(__file__), "bpe_simple_vocab_16e6.txt.gz"),
        os.path.expanduser("~/.cache/clip/bpe_simple_vocab_16e6.txt.gz"),
    ):
        if os.path.exists(cand):
            return cand
    return None


class ClipTokenizer:
    """Byte-level BPE tokenizer with the CLIP vocabulary layout.

    Vocabulary order: 256 byte symbols, 256 byte+``</w>`` symbols, learned
    merge products in rank order, then ``<|startoftext|>``/``<|endoftext|>``.
    """

    def __init__(self, bpe_path: Optional[str] = None,
                 merges: Optional[Sequence[Tuple[str, str]]] = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        if merges is None:
            merge_file = _find_merge_file(bpe_path)
            merges = _load_merges(merge_file) if merge_file else []
        merges = list(merges)

        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT_TEXT, EOT_TEXT]
        # Pad the id space out to the full model vocab so embedding shapes
        # are identical whether or not the learned merges are present.
        self._real_vocab = len(vocab)
        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        if self._real_vocab < VOCAB_SIZE:
            # specials pinned to their canonical ids
            self.encoder[SOT_TEXT] = VOCAB_SIZE - 2
            self.encoder[EOT_TEXT] = VOCAB_SIZE - 1
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {
            tuple(m): i for i, m in enumerate(merges)
        }
        self._cache: Dict[str, str] = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}

    # -- properties -------------------------------------------------------
    @property
    def sot_token(self) -> int:
        return self.encoder[SOT_TEXT]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT_TEXT]

    @property
    def vocab_size(self) -> int:
        return VOCAB_SIZE

    @property
    def has_learned_merges(self) -> bool:
        return bool(self.bpe_ranks)

    # -- BPE core ---------------------------------------------------------
    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
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
                if i < len(word) - 1 and word[i + 1] == second:
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
        # bound the cache: the serve process tokenizes arbitrary user
        # queries for weeks — OpenAI's unbounded dict is fine in a
        # short-lived script, not in a long-lived server
        if len(self._cache) >= _CACHE_CAP:
            self._cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self._cache[token] = out
        return out

    # -- public API -------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for token in _split_words(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(i, "") for i in ids
                       if i not in (self.sot_token, self.eot_token))
        raw = bytearray(self.byte_decoder[c] for c in text
                        if c in self.byte_decoder)
        return (raw.decode("utf-8", errors="replace")
                .replace("</w>", " ").strip())

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        """Tokenize into a padded int32 (len(texts), context_length) array.

        Matches ``clip.tokenize``'s output contract: ``[sot] + bpe + [eot]``
        zero-padded. The reference calls it without ``truncate`` and crashes
        on >75-token queries; we default to truncating (keeping the final
        eot) since a crashing REPL serves nobody — deviation documented in
        SURVEY.md section 7 spirit ("quirks" preserved are the search
        semantics, not crashes).
        """
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for row, text in enumerate(texts):
            toks = [self.sot_token] + self.encode(text) + [self.eot_token]
            if len(toks) > context_length:
                if not truncate:
                    raise RuntimeError(
                        f"input {text!r} is too long for context length "
                        f"{context_length}")
                toks = toks[:context_length]
                toks[-1] = self.eot_token
            result[row, : len(toks)] = toks
        return result


def _load_merges(path: str) -> List[Tuple[str, str]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read().decode("utf-8")
    lines = data.split("\n")
    while lines and not lines[-1].strip():  # trailing EOF blanks are fine
        lines.pop()
    # OpenAI file layout: header line, then merge pairs; only the first
    # 48,894 merges participate in the 49,408 vocab. A malformed line
    # inside that range is a hard error: silently dropping it would
    # shift every later merge product's id by one — misaligning ~half
    # the vocabulary against a converted checkpoint's embedding rows
    # with no symptom beyond quietly wrong rankings.
    merges: List[Tuple[str, str]] = []
    for lineno, line in enumerate(lines[1 : _N_MERGES + 1], start=2):
        m = tuple(line.split())
        if len(m) != 2:
            raise ValueError(
                f"{path}:{lineno}: malformed merge line {line!r} — the "
                f"first {_N_MERGES} merges must all be 2-field (a "
                f"truncated or edited BPE file would silently shift "
                f"every later token id)")
        merges.append(m)
    return merges

