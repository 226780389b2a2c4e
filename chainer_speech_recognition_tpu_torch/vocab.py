"""Vocabulary + tokenizer with the frozen CTC label conventions: the
port's copy of the reference's ``vocab.py``, the BPE unit learner of
``preprocess --unit bpe`` (``learn_bpe``) included.

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


def learn_bpe(texts, vocab_size: int, unit: str = "char") -> list[str]:
    """Byte-pair-encoding unit learning over transcripts: start from the
    ``unit`` base inventory (char/mora) and repeatedly merge the most
    frequent adjacent pair until the vocab (incl. <blank>/<unk>) reaches
    ``vocab_size`` or no pair repeats. Returns the sorted unit list for
    ``Vocab`` — subword units shorten CTC label sequences (fewer symbols
    per utterance → easier alignments, shorter LM contexts).

    Segmentation at ENCODE time is ``Vocab.encode``'s greedy
    longest-match, not canonical merge-order BPE — deterministic,
    metadata-free (a saved vocab file fully defines the codec), and
    self-consistent between training labels and eval references, which is
    all CTC requires of a unit inventory. Ties in pair frequency break
    lexicographically so learned vocabs are reproducible.
    """
    import warnings
    from collections import defaultdict

    seg = _resolve_segmenter(unit)
    seqs = [seg(t) for t in texts if t]
    base = sorted({u for s in seqs for u in s})
    n_special = 2                        # <blank> + <unk>
    if len(base) + n_special > vocab_size:
        warnings.warn(
            f"BPE base inventory ({len(base)} units + {n_special} specials) "
            f"already exceeds the requested vocab_size {vocab_size}; no "
            "merges will be learned and the vocab will be larger than "
            "asked", stacklevel=2)
    symbols = set(base)
    # incremental pair bookkeeping: a merge only changes pair counts
    # INSIDE the sequences that contain it, so only those re-scan —
    # O(corpus + Σ affected-text) total instead of O(merges × corpus)
    counts: dict[tuple[str, str], int] = defaultdict(int)
    where: dict[tuple[str, str], set[int]] = defaultdict(set)

    def account(si, s, sign):
        for p in zip(s, s[1:]):
            counts[p] += sign
            if sign > 0:
                where[p].add(si)

    for si, s in enumerate(seqs):
        account(si, s, +1)

    while len(symbols) + n_special < vocab_size:
        # most frequent pair whose merge is a NEW symbol (mora bases can
        # collide with concatenations); lexicographic tie-break
        pick, best = None, None
        for p, c in counts.items():
            if c >= 2 and p[0] + p[1] not in symbols:
                key = (-c, p)
                if best is None or key < best:
                    best, pick = key, p
        if pick is None:
            break
        a, b = pick
        new = a + b
        symbols.add(new)
        for si in sorted(where[pick]):
            s = seqs[si]
            account(si, s, -1)
            out, i = [], 0
            while i < len(s):
                if i + 1 < len(s) and s[i] == a and s[i + 1] == b:
                    out.append(new)
                    i += 2
                else:
                    out.append(s[i])
                    i += 1
            seqs[si] = out
            account(si, out, +1)
    return sorted(symbols)


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
