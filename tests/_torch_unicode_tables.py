"""Character classes read back from the libraries the JAX package uses,
over every code point, as the port stores them: each class as the ranges
where it differs from what Python's ``unicodedata`` gives.

- ``rust_tables()``: the Rust ``tokenizers`` library's, as
  ``ircl_tpu_torch/models/hf_unicode.py`` stores them;
- ``regex_tables()``: the ``regex`` package's ``\\p{L}``, ``\\p{N}``,
  ``\\p{M}``, ``\\p{Z}``, ``\\p{C}``, ``\\p{P}`` and ``\\w``, as
  ``ircl_tpu_torch/corpus/uniclass.py`` stores them.

``tests/test_torch_hf.py`` and ``tests/test_torch_corpus.py`` hold the
port's tables to these; ``python tests/_torch_unicode_tables.py`` prints
both in the modules' form.
"""

import sys
import unicodedata

CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
WHITESPACE = frozenset([0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
                        *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000])


def _ranges(code_points):
    out = []
    for c in sorted(code_points):
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return tuple((lo, hi) for lo, hi in out)


def _per_char(normalizer, code_points, sep):
    """``normalizer`` on each code point alone, in batches between ``sep``."""
    out = {}
    for i in range(0, len(code_points), 8192):
        part = code_points[i:i + 8192]
        text = "".join(sep + chr(c) for c in part) + sep
        pieces = normalizer.normalize_str(text).split(sep)[1:-1]
        assert len(pieces) == len(part)
        out.update(zip(part, pieces))
    return out


def _one_piece(pre_tokenizer, code_points, fmt, sep):
    """The code points ``c`` for which ``fmt % c`` is one pre-token."""
    out = set()
    sep_token = pre_tokenizer.pre_tokenize_str(sep)[0][0]
    for i in range(0, len(code_points), 8192):
        part = code_points[i:i + 8192]
        pieces = [p for p, _ in pre_tokenizer.pre_tokenize_str(
            sep.join(fmt % chr(c) for c in part))]
        counts, n = [], 0
        for p in pieces:
            if p == sep_token:
                counts.append(n)
                n = 0
            else:
                n += 1
        counts.append(n)
        assert len(counts) == len(part)
        out.update(c for c, k in zip(part, counts) if k == 1)
    return out


def _is_punct(c):
    return (33 <= c <= 47 or 58 <= c <= 64 or 91 <= c <= 96 or 123 <= c <= 126
            or unicodedata.category(chr(c)).startswith("P"))


def rust_tables():
    """The tables of ``hf_unicode.py``, computed from ``tokenizers``."""
    from tokenizers import normalizers, pre_tokenizers

    def bert(**kw):
        flags = dict(clean_text=False, handle_chinese_chars=False, strip_accents=False,
                     lowercase=False)
        flags.update(kw)
        return normalizers.BertNormalizer(**flags)

    cps = [c for c in CODE_POINTS if c not in (0x01, 0x51)]
    tables = {}
    # clean_text drops a control character and turns whitespace into " "
    clean = _per_char(bert(clean_text=True), cps, "Q")
    control = {c for c in cps if clean[c] == ""}
    py_control = {c for c in cps if unicodedata.category(chr(c)) in ("Cc", "Cf", "Co", "Cs")
                  and c not in (0x09, 0x0A, 0x0D)} | {0, 0xFFFD}
    tables["CONTROL_FLIP"] = _ranges(control ^ py_control)
    assert all(clean[c] == " " for c in WHITESPACE - control)
    # strip_accents: NFD, then every non-spacing mark dropped
    strip = _per_char(bert(strip_accents=True), cps, "Q")
    alone = [c for c in cps if unicodedata.normalize("NFD", chr(c)) == chr(c)]
    mark = {c for c in alone if strip[c] == ""}
    mark_flip = mark ^ {c for c in alone if unicodedata.category(chr(c)) == "Mn"}
    tables["MARK_FLIP"] = _ranges(mark_flip)

    def py_strip(c):
        return "".join(x for x in unicodedata.normalize("NFD", chr(c))
                       if (unicodedata.category(x) == "Mn") == (ord(x) in mark_flip))

    differ = [c for c in cps if strip[c] != py_strip(c)]
    assert all(strip[c] == chr(c) for c in differ)  # Rust leaves them whole
    tables["NFD_KEPT"] = _ranges(differ)
    # lowercase, a character at a time
    lower = _per_char(bert(lowercase=True), [c for c in CODE_POINTS if c != 0x01], "\x01")
    extra = sorted(c for c, low in lower.items() if low != chr(c).lower())
    assert all(len(lower[c]) == 1 for c in extra)
    shifts = []
    for c in extra:
        d = ord(lower[c]) - c
        if shifts and shifts[-1][1] == c - 1 and shifts[-1][2] == d:
            shifts[-1][1] = c
        else:
            shifts.append([c, c, d])
    tables["LOWER_SHIFTS"] = tuple(tuple(s) for s in shifts)
    # handle_chinese_chars pads these with spaces
    chinese = _per_char(bert(handle_chinese_chars=True), cps, "Q")
    tables["CHINESE"] = _ranges(c for c in cps if chinese[c] != chr(c))
    # BertPreTokenizer isolates punctuation: "a" c "a" splits in three
    non_ws = [c for c in CODE_POINTS if c not in WHITESPACE and chr(c) not in "a1"]
    bert_pre = pre_tokenizers.BertPreTokenizer()
    joined = _one_piece(bert_pre, [c for c in non_ws if c != 0x21], "a%sa", "!")
    tables["PUNCT_FLIP"] = _ranges({c for c in non_ws if c not in joined and c != 0x21}
                                   ^ {c for c in non_ws if _is_punct(c) and c != 0x21})
    # GPT-2's pattern as onig matches it: \p{L}+ and \p{N}+ runs
    byte_level = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    letters = _one_piece(byte_level, non_ws, "a%sa", "\n")
    numbers = _one_piece(byte_level, non_ws, "1%s1", "\n")
    tables["LETTER_FLIP"] = _ranges(letters ^ {
        c for c in non_ws if unicodedata.category(chr(c)).startswith("L")})
    tables["NUMBER_FLIP"] = _ranges(numbers ^ {
        c for c in non_ws if unicodedata.category(chr(c)).startswith("N")})
    # both pre-tokenizers split on exactly these (White_Space ends at U+3000)
    for c in range(0x3001):
        if chr(c) in "a":
            continue
        if (len(bert_pre.pre_tokenize_str("a%sa" % chr(c))) == 2) != (c in WHITESPACE):
            raise AssertionError(f"BertPreTokenizer and U+{c:04X}")
        if (len(byte_level.pre_tokenize_str("a%s%sa" % (chr(c), chr(c)))) == 4) != (
                c in WHITESPACE - {0x20}):
            raise AssertionError(f"ByteLevel and U+{c:04X}")
    return tables


def _format(name, rows):
    if not rows:
        return f"{name} = ()"
    cells = ", ".join("(" + ", ".join(f"0x{x:X}" if x >= 0 else f"-0x{-x:X}" for x in r)
                      + ")" for r in rows)
    lines, line = [], f"{name} = ("
    for cell in cells.split("), ("):
        cell = cell.strip("()")
        piece = f"({cell}), "
        if len(line) + len(piece) > 88:
            lines.append(line.rstrip())
            line = "    "
        line += piece
    lines.append(line.rstrip().rstrip(",") + ",)" if len(rows) == 1 else line.rstrip() + ")")
    return "\n".join(lines)


def regex_tables():
    """The tables of ``uniclass.py``, computed from ``regex``."""
    import regex

    cats = [unicodedata.category(chr(c)) for c in range(0x110000)]
    tables = {}
    for prop in "LNMZCPW":
        pattern = regex.compile(r"\w" if prop == "W" else r"\p{%s}" % prop)
        got = {c for c in range(0x110000) if pattern.match(chr(c))}
        base = {c for c in range(0x110000)
                if (word_base(cats[c], c) if prop == "W" else cats[c][0] == prop)}
        tables[prop] = _ranges(got ^ base)
    return tables


def word_base(category, c):
    """``uniclass.py``'s starting point for ``\\w``: letters, marks,
    decimal and letter numbers, connector punctuation and the joiners."""
    return category[0] in "LM" or category in ("Nd", "Nl", "Pc") or c in (0x200C, 0x200D)


if __name__ == "__main__":
    sys.modules.setdefault("tensorflow", None)
    for name, rows in rust_tables().items():
        print(_format(name, rows))
    print()
    for name, rows in regex_tables().items():
        print(_format(name, rows))
