"""Japanese transcript normalization for CSJ-style corpora: the port's copy
of the reference's ``data/jptext.py`` (``preprocess --normalize-text``).

The raw CSJ annotation carries filler/disfluency tags, multiple readings
and mixed-width punctuation; this is the standard CSJ-style cleanup:

* ``(F …)``  filler            → dropped
* ``(D …)``/``(D2 …)`` disfluency fragments → dropped
* ``(? …)``  uncertain hearing → content kept (first alternative)
* ``(A 左;右)`` annotation pair → LEFT side kept (pronunciation-side in
  kana transcripts); other one-letter tags (M/O/R/X/K/W…) keep content
* ``<…>`` events (laugh, cough, pause) → dropped
* NFKC fold, punctuation/whitespace strip, optional hiragana↔katakana

Everything is pure host-side text processing (runs once, in preprocess).
"""

from __future__ import annotations

import re
import unicodedata

# tags whose CONTENT is removed along with the tag itself
_DROP_CONTENT = {"F", "D", "D2", "L", "笑", "泣", "咳"}

# a drop-tag word glued to its content with no separating space, e.g.
# "(D2それ)" or the bare "(笑)" — matched inside the bare-parenthetical
# branch of _strip_tags so annotation characters never leak into labels.
# KNOWN FALSE-POSITIVE CLASS (accepted heuristic for CSJ-style kana
# transcripts): a legitimate bare parenthetical whose content merely
# STARTS with a drop-tag character followed by a non-alphanumeric — e.g.
# "(笑い声が…)" or "(Dで始まる…)" — is deleted whole. Real CSJ kana
# annotation never produces such content-bearing bare parentheses, but
# corpora with free-form parenthetical prose should pre-clean them or
# skip --normalize-text.
_GLUED_DROP_TAG = re.compile(r"(?:F|D2|D|L|笑|泣|咳)(?![A-Za-z0-9])")

_ANGLE = re.compile(r"<[^<>]*>")

# punctuation & separators (ASCII + CJK variants) removed after tag
# handling. The kana long-vowel mark ー is NOT punctuation — it must
# survive; only the fullwidth dash lookalikes (—) are stripped.
_PUNCT = re.compile(
    r"[\s　。、，．,.!！?？・「」『』（）()\[\]｛｝{}〈〉《》：；:;\"'＿—…‥→↑↓←]"
)


def _strip_tags(text: str) -> str:
    """Remove CSJ-style ``(TAG …)`` annotations, innermost-first.

    ``(A left;right)`` keeps ``left``; tags in ``_DROP_CONTENT`` drop their
    content; any other tag keeps its content. Unbalanced parens are left
    as-is (then swept out by the punctuation pass).
    """
    # innermost-first: repeat until no "(TAG content-without-parens)" remains
    pat = re.compile(r"\(\s*([^\s()]{0,4})\s+([^()]*)\)|\(([^()]*)\)")
    while True:
        m = pat.search(text)
        if m is None:
            return text
        if m.group(3) is not None:        # bare parenthetical, no tag word
            # drop-tags glued to content without a space — "(笑)",
            # "(D2それ)" — still drop everything (ADVICE r1)
            repl = "" if _GLUED_DROP_TAG.match(m.group(3)) else m.group(3)
        else:
            tag, content = m.group(1), m.group(2)
            if tag in _DROP_CONTENT:
                repl = ""
            elif ";" in content:          # (A 読み;表記) — keep left side
                repl = content.split(";", 1)[0]
            elif "," in content:
                repl = content.split(",", 1)[0]
            else:
                repl = content
        text = text[: m.start()] + repl + text[m.end():]


def hira_to_kata(text: str) -> str:
    return "".join(
        chr(ord(c) + 0x60) if "ぁ" <= c <= "ゖ" else c for c in text)


def kata_to_hira(text: str) -> str:
    return "".join(
        chr(ord(c) - 0x60) if "ァ" <= c <= "ヶ" else c for c in text)


def normalize(text: str, *, kana: str | None = None,
              strip_tags: bool = True) -> str:
    """CSJ-style transcript → clean label string.

    kana: None (leave), "katakana", or "hiragana" — fold the kana script so
    the vocab doesn't split probability mass across two scripts.
    """
    # NFKC FIRST: CSJ annotations may be written with fullwidth parens /
    # tag letters / semicolons (（Ｆ えー）); the tag regexes match the
    # ASCII forms, so folding must happen before stripping or the tag
    # letters would leak into labels
    text = unicodedata.normalize("NFKC", text)
    if strip_tags:
        text = _strip_tags(text)
        text = _ANGLE.sub("", text)
    text = _PUNCT.sub("", text)
    if kana == "katakana":
        text = hira_to_kata(text)
    elif kana == "hiragana":
        text = kata_to_hira(text)
    return text
