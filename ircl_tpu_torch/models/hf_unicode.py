"""Character classes of the Rust ``tokenizers`` library, for the port's
HuggingFace tokenizers (``models/hf_tokenizer.py``).

``BertTokenizerFast`` and ``RobertaTokenizerFast`` classify characters with
the Rust crates' Unicode tables, not Python's: BERT's normalizer and
pre-tokenizer take their categories (control, non-spacing mark,
punctuation) from an older Unicode than ``unicodedata``'s 15.0.0, while
GPT-2's pattern (onig's ``\\p{L}``, ``\\p{N}``) and lowercasing use a newer one.
Each table below lists the code points where the Rust class differs from
the class ``unicodedata`` gives, as inclusive ranges; ``LOWER_SHIFTS`` adds
``(first, last, shift)`` lowercase mappings Python does not know, and
``NFD_KEPT`` the characters the Rust NFD leaves whole.
``tests/_torch_unicode_tables.py`` reads every class back from ``tokenizers``
over all code points, and ``tests/test_torch_hf.py`` holds these tables to
it. They are relative to ``unicodedata`` 15.0.0 (Python 3.12), which
``corpus/uniclass.py::check_unicode_version`` requires.

Whitespace is Unicode's White_Space property in both libraries
(``char::is_whitespace``, onig's ``\\s``), which ``str.isspace`` is not: it
adds U+001C-U+001F.
"""

from __future__ import annotations

import bisect
import unicodedata

WHITESPACE = frozenset(map(chr, [
    0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000]))
_CONTROL = frozenset(("Cc", "Cf", "Co", "Cs"))
_ASCII_PUNCT = frozenset(map(chr, [*range(33, 48), *range(58, 65), *range(91, 97),
                                   *range(123, 127)]))

CONTROL_FLIP = ((0x890, 0x891), (0x8E2, 0x8E2), (0x110CD, 0x110CD), (0x13430, 0x1343F),)
MARK_FLIP = ((0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8E1), (0x9FE, 0x9FE),
    (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C), (0xD00, 0xD00),
    (0xD3B, 0xD3C), (0xD81, 0xD81), (0xEBA, 0xEBA), (0xECE, 0xECE), (0x1734, 0x1734),
    (0x180F, 0x180F), (0x1885, 0x1886), (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFB),
    (0xA82C, 0xA82C), (0xA8C5, 0xA8C5), (0xA8FF, 0xA8FF), (0xA9BD, 0xA9BD),
    (0x10D24, 0x10D27), (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF), (0x10F46, 0x10F50),
    (0x10F82, 0x10F85), (0x11070, 0x11070), (0x11073, 0x11074), (0x110C2, 0x110C2),
    (0x111C9, 0x111C9), (0x111CF, 0x111CF), (0x1123E, 0x1123E), (0x11241, 0x11241),
    (0x1133B, 0x1133B), (0x11438, 0x1143F), (0x11442, 0x11444), (0x11446, 0x11446),
    (0x1145E, 0x1145E), (0x1182F, 0x11837), (0x11839, 0x1183A), (0x1193B, 0x1193C),
    (0x1193E, 0x1193E), (0x11943, 0x11943), (0x119D4, 0x119D7), (0x119DA, 0x119DB),
    (0x119E0, 0x119E0), (0x11A01, 0x11A0A), (0x11A33, 0x11A38), (0x11A3B, 0x11A3E),
    (0x11A47, 0x11A47), (0x11A51, 0x11A56), (0x11A59, 0x11A5B), (0x11A8A, 0x11A96),
    (0x11A98, 0x11A99), (0x11C30, 0x11C36), (0x11C38, 0x11C3D), (0x11C3F, 0x11C3F),
    (0x11C92, 0x11CA7), (0x11CAA, 0x11CB0), (0x11CB2, 0x11CB3), (0x11CB5, 0x11CB6),
    (0x11D31, 0x11D36), (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45),
    (0x11D47, 0x11D47), (0x11D90, 0x11D91), (0x11D95, 0x11D95), (0x11D97, 0x11D97),
    (0x11EF3, 0x11EF4), (0x11F00, 0x11F01), (0x11F36, 0x11F3A), (0x11F40, 0x11F40),
    (0x11F42, 0x11F42), (0x13440, 0x13440), (0x13447, 0x13455), (0x16F4F, 0x16F4F),
    (0x16FE4, 0x16FE4), (0x1CF00, 0x1CF2D), (0x1CF30, 0x1CF46), (0x1E000, 0x1E006),
    (0x1E008, 0x1E018), (0x1E01B, 0x1E021), (0x1E023, 0x1E024), (0x1E026, 0x1E02A),
    (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF),
    (0x1E4EC, 0x1E4EF), (0x1E944, 0x1E94A),)
NFD_KEPT = ((0x11938, 0x11938),)
LOWER_SHIFTS = ((0x1C89, 0x1C89, 0x1), (0xA7CB, 0xA7CB, -0xA567),
    (0xA7CC, 0xA7CC, 0x1), (0xA7CE, 0xA7CE, 0x1), (0xA7D2, 0xA7D2, 0x1),
    (0xA7D4, 0xA7D4, 0x1), (0xA7DA, 0xA7DA, 0x1), (0xA7DC, 0xA7DC, -0xA641),
    (0x10D50, 0x10D65, 0x20), (0x16EA0, 0x16EB8, 0x1B),)
CHINESE = ((0x3400, 0x4DBF), (0x4E00, 0x9FFF), (0xF900, 0xFAFF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B81F), (0x2B920, 0x2CEAF), (0x2F800, 0x2FA1F),)
PUNCT_FLIP = ((0x61D, 0x61D), (0x9FD, 0x9FD), (0xA76, 0xA76), (0xC77, 0xC77),
    (0xC84, 0xC84), (0x166D, 0x166D), (0x1B7D, 0x1B7E), (0x2E43, 0x2E4F),
    (0x2E52, 0x2E5D), (0x10EAD, 0x10EAD), (0x10F55, 0x10F59), (0x10F86, 0x10F89),
    (0x111C9, 0x111C9), (0x1144B, 0x1144F), (0x1145A, 0x1145B), (0x1145D, 0x1145D),
    (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1183B, 0x1183B), (0x11944, 0x11946),
    (0x119E2, 0x119E2), (0x11A3F, 0x11A46), (0x11A9A, 0x11A9C), (0x11A9E, 0x11AA2),
    (0x11B00, 0x11B09), (0x11C41, 0x11C45), (0x11C70, 0x11C71), (0x11EF7, 0x11EF8),
    (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF), (0x12FF1, 0x12FF2), (0x16E97, 0x16E9A),
    (0x16FE2, 0x16FE2), (0x1E95E, 0x1E95F),)
LETTER_FLIP = ((0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC),
    (0x105C0, 0x105F3), (0x10D4A, 0x10D65), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4),
    (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5),
    (0x113B7, 0x113B7), (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0),
    (0x13460, 0x143FA), (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF),
    (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D),)
NUMBER_FLIP = ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
    (0x16130, 0x16139), (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA),)


class _Ranges:
    """Membership of a code point in sorted inclusive ranges."""

    def __init__(self, ranges):
        self.lo = [r[0] for r in ranges]
        self.rows = ranges

    def find(self, c: int):
        i = bisect.bisect_right(self.lo, c) - 1
        return self.rows[i] if i >= 0 and c <= self.rows[i][1] else None

    def __contains__(self, c: int) -> bool:
        return self.find(c) is not None


_control_flip = _Ranges(CONTROL_FLIP)
_mark_flip = _Ranges(MARK_FLIP)
_nfd_kept = _Ranges(NFD_KEPT)
_lower_shifts = _Ranges(LOWER_SHIFTS)
_chinese = _Ranges(CHINESE)
_punct_flip = _Ranges(PUNCT_FLIP)
_letter_flip = _Ranges(LETTER_FLIP)
_number_flip = _Ranges(NUMBER_FLIP)


def is_removed(ch: str) -> bool:
    """BERT's ``clean_text`` drops it: NUL, U+FFFD or a control character
    (tab, newline and carriage return are whitespace)."""
    c = ord(ch)
    base = c in (0, 0xFFFD) or (
        unicodedata.category(ch) in _CONTROL and ch not in "\t\n\r")
    return base != (c in _control_flip)


def is_chinese(ch: str) -> bool:
    """A CJK ideograph that BERT's normalizer pads with spaces."""
    return ord(ch) in _chinese


def is_punctuation(ch: str) -> bool:
    """BERT's pre-tokenizer isolates it: ASCII punctuation or ``P*``."""
    base = ch in _ASCII_PUNCT or unicodedata.category(ch)[0] == "P"
    return base != (ord(ch) in _punct_flip)


def is_mark(ch: str) -> bool:
    """A non-spacing mark, which ``strip_accents`` drops."""
    return (unicodedata.category(ch) == "Mn") != (ord(ch) in _mark_flip)


def strip_accents(text: str) -> str:
    """NFD, then every non-spacing mark dropped."""
    out = []
    start = 0
    for i, ch in enumerate(text):
        if ord(ch) in _nfd_kept:
            out.append(_stripped(text[start:i]) + ch)
            start = i + 1
    out.append(_stripped(text[start:]))
    return "".join(out)


def _stripped(text: str) -> str:
    return "".join(x for x in unicodedata.normalize("NFD", text) if not is_mark(x))


def lower(text: str) -> str:
    """Each character lowercased alone, as Rust's ``char::to_lowercase``
    (no final-sigma context, which ``str.lower`` applies)."""
    if text.isascii():
        return text.lower()
    out = []
    for ch in text:
        shift = _lower_shifts.find(ord(ch))
        out.append(chr(ord(ch) + shift[2]) if shift else ch.lower())
    return "".join(out)


def is_letter(ch: str) -> bool:
    """Onig's ``\\p{L}``."""
    return (unicodedata.category(ch)[0] == "L") != (ord(ch) in _letter_flip)


def is_number(ch: str) -> bool:
    """Onig's ``\\p{N}``."""
    return (unicodedata.category(ch)[0] == "N") != (ord(ch) in _number_flip)
