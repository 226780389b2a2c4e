"""Vocabulary + tokenizer with the frozen CTC label conventions: the
port's copy of the reference's ``vocab.py`` without the BPE learner
(``learn_bpe``, used only by the reference's preprocessing CLI).

* id 0 == ``<blank>`` — never produced by ``encode``.
* real symbols get ids 1..V-1 in first-seen or sorted order.
* vocab file format: one symbol per line, line number == id, line 0 is the
  literal string ``<blank>``. ``encode`` greedy-longest-matches against the
  symbol set, so a saved mora vocab round-trips without segmenter metadata.
"""

from __future__ import annotations

from .constants import BLANK_ID

BLANK_SYMBOL = "<blank>"
UNK_SYMBOL = "<unk>"

# kana that merge into the preceding unit under mora segmentation
_SMALL_KANA = set("ゃゅょぁぃぅぇぉゎャュョァィゥェォヮ")


def segment_chars(text: str) -> list[str]:
    return list(text)


def segment_mora(text: str) -> list[str]:
    units: list[str] = []
    for ch in text:
        if units and ch in _SMALL_KANA:
            units[-1] += ch
        else:
            units.append(ch)
    return units


SEGMENTERS = {"char": segment_chars, "mora": segment_mora}


def _resolve_segmenter(unit):
    return SEGMENTERS[unit] if isinstance(unit, str) else unit


class Vocab:
    def __init__(self, symbols: list[str]):
        if not symbols or symbols[0] != BLANK_SYMBOL:
            raise ValueError("vocab line 0 must be <blank>")
        if len(set(symbols)) != len(symbols):
            raise ValueError("duplicate symbols in vocab")
        self.symbols = list(symbols)
        self._to_id = {s: i for i, s in enumerate(symbols)}
        self.unk_id = self._to_id.get(UNK_SYMBOL)
        self._max_unit = max((len(s) for s in symbols[1:]
                              if s != UNK_SYMBOL), default=1)

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, texts, add_unk: bool = True, unit="char") -> "Vocab":
        """Build from an iterable of transcript strings (sorted units)."""
        seg = _resolve_segmenter(unit)
        units = sorted({u for t in texts for u in seg(t)})
        symbols = [BLANK_SYMBOL] + ([UNK_SYMBOL] if add_unk else []) + units
        return cls(symbols)

    @classmethod
    def load(cls, path) -> "Vocab":
        with open(path, encoding="utf-8") as f:
            return cls([line.rstrip("\n") for line in f if line != "\n"])

    def save(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(self.symbols) + "\n")

    # -- codec -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.symbols)

    def encode(self, text: str) -> list[int]:
        """Greedy longest-match against the symbol set — exact for char
        vocabs (all units length 1) and correct for mora vocabs, with no
        segmenter metadata needed at decode/eval time."""
        ids: list[int] = []
        i, n = 0, len(text)
        while i < n:
            for w in range(min(self._max_unit, n - i), 0, -1):
                uid = self._to_id.get(text[i : i + w])
                if uid is not None and uid != BLANK_ID:
                    ids.append(uid)
                    i += w
                    break
            else:
                if self.unk_id is None:
                    raise KeyError(f"no vocab unit matches {text[i:i+1]!r}")
                ids.append(self.unk_id)
                i += 1
        assert BLANK_ID not in ids, "blank id must never appear in labels"
        return ids

    def decode(self, ids) -> str:
        """ids → string, skipping blank/pad; used after CTC collapse."""
        out = []
        for i in ids:
            i = int(i)
            if i == BLANK_ID or i < 0:
                continue
            out.append(self.symbols[i])
        return "".join(out)
