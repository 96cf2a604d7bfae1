"""The port's tokenizer (standard library only) against clipx's, which
splits words with the third-party ``regex`` module.

Token ids must be identical: tolerance none.
"""

import unicodedata

import numpy as np
import pytest

from clipx.text import tokenizer as jtok
from clipx_torch.text import tokenizer as ttok

TEXTS = [
    "a photo of a cat",
    "Two DOGS playing in the snow!!",
    "it's what we'd've done, isn't it? they'll see; I'm sure",
    "route 66 at 3:45pm -- 1,234.5 km",
    "<|startoftext|>hello<|endoftext|> world",
    "café crème brûlée à la mode, naïve façade, Ærøskøbing",
    "Ünïcödé ÀÉÎÕÜ ß ſ ﬁ",
    "東京の夜景 北京烤鸭 서울의 밤",
    "Москва зимой, Αθήνα τη νύχτα",
    "emoji 🐱🐶 and symbols ©®™ ½ ², ٣ ४",
    "tabs\tand\nnewlines nbsp em　ideographic",
    "&amp;lt;b&amp;gt; html &quot;quoted&quot;",
    "",
    "   ",
    "x" * 200,
]


def test_ids_match_clipx():
    ours = ttok.ClipTokenizer()(TEXTS)
    ref = jtok.ClipTokenizer()(TEXTS)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape == (
        len(TEXTS), 77)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("text", TEXTS)
def test_encode_and_decode_match_clipx(text):
    ours, ref = ttok.ClipTokenizer(), jtok.ClipTokenizer()
    ids = ours.encode(text)
    assert ids == ref.encode(text)
    assert ours.decode(ids) == ref.decode(ids)


def test_learned_merges_match_clipx():
    """A small merge table (the layout of OpenAI's file) gives the same
    merged ids in both."""
    merges = [("c", "a"), ("ca", "t</w>"), ("p", "h"), ("o", "t"),
              ("ph", "ot"), ("pho", "t"), ("é", "t")]
    ours = ttok.ClipTokenizer(merges=merges)(TEXTS)
    ref = jtok.ClipTokenizer(merges=merges)(TEXTS)
    np.testing.assert_array_equal(ours, ref)


def test_word_splitter_matches_regex_pattern():
    """_split_words == clipx's _PAT.findall over every assigned character
    below U+0800 and every 37th one above, each among letters, digits,
    contractions and itself."""
    chars = [chr(c) for c in range(0x110000)
             if not 0xD800 <= c < 0xE000 and (c < 0x800 or c % 37 == 0)
             and unicodedata.category(chr(c)) != "Cn"]
    text = "".join(c + "a" + c + c + "1'" + c + "s " for c in chars)
    assert ttok._split_words(text) == jtok._PAT.findall(text)
