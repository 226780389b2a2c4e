"""Character n-gram language model for CTC shallow fusion (port of
``decode/lm.py``, config 4). It stays numpy on the host; the beam
(``decode/beam.py``) places the chosen representation on the decode
device once per LM object.

Three representations:
* host: backoff dict (ARPA-loadable, or trained from text with
  absolute discounting) — used by the reference beam decoder (oracle);
* dense: ``[V^(order-1), V]`` log-prob table (``to_dense``), so the beam
  keeps one context window per hypothesis and scores every extension with
  one row lookup. Practical for char-level kana vocabs (V ≲ a few hundred,
  order ≤ 3: 32 MB at V=200/order 3 but 6.4 GB at order 4);
* sparse (``to_hashed`` → HashedLM): open-addressing context hash +
  backoff-resolved score rows, sized by the n-grams the LM actually
  contains — the scalable path for order ≥ 4 / larger V. Keyed by a
  double window hash over the hypothesis's last (order-1) chars
  (``ctx_keys`` — exact numeric id while V^k < 2^31, wrap-hash beyond),
  same scores, MBs instead of GBs.

Sentence-boundary conventions: contexts are char tuples over vocab ids;
id 0 (<blank>) doubles as the begin-of-sentence context entry (blank never
appears inside label sequences, so there is no collision).
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from ..vocab import Vocab

LOG10 = math.log(10.0)

# Context-window hash pair: the beam carries
# each hypothesis's last (order-1) chars and derives one key PAIR per
# backoff level k from the k-char window:
#   key1 = fold h·V + c      in WRAPPING int32 (for V^k < 2^31 this equals
#                            the exact numeric context id — the scheme the
#                            rounds-2..4 design used — and beyond it it
#                            degrades into a hash);
#   key2 = fold (h·MULT2 + c) mod MOD2   (independent verifier).
# Leading BOS zeros are identity under both folds (0·m + 0 = 0), so a
# partial context's window keys equal the shorter context's keys — the
# same semantic-identity-by-construction the numeric-id scheme had. A
# simultaneous collision of both keys is ~2⁻⁶⁰-rare (decode/beam.py's
# double-rolling-hash precedent); the build detects and drops the
# (astronomically unlikely) offender. This removes the V^order < 2^31
# bound that made order-4 fusion impossible at BPE vocab scale
# (2048⁴ ≫ 2³¹).
_CTX_MULT2 = 754_877
_CTX_MOD2 = 2**30 - 173


def _wrap32(x: int) -> int:
    """Two's-complement int32 wrap (the beam's int32 arithmetic)."""
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x >= 0x80000000 else x


def ctx_keys(ctx: tuple, V: int) -> tuple[int, int]:
    """(key1, key2) for a context char-tuple — host replica of the
    beam's fold (oldest char first; the key2 product WRAPS in int32
    before the modulus, exactly like the beam's int32 arithmetic —
    decode/beam.py's prefix-hash idiom)."""
    h1 = h2 = 0
    for c in ctx:
        h1 = _wrap32(h1 * V + int(c))
        h2 = _wrap32(h2 * _CTX_MULT2 + int(c)) % _CTX_MOD2
    return h1, h2


class NGramLM:
    """Backoff char n-gram over vocab ids (1..V-1); natural-log scores."""

    def __init__(self, order: int, vocab_size: int):
        assert order >= 1
        self.order = order
        self.V = vocab_size
        # logp[(ctx tuple)][char] and backoff[(ctx tuple)] in natural log
        self.logp: list[dict] = [dict() for _ in range(order)]
        self.backoff: list[dict] = [defaultdict(float) for _ in range(order)]

    # ---------------- scoring ----------------
    def score(self, context: tuple[int, ...], char: int) -> float:
        """log P(char | context) with backoff; context = previous ids."""
        ctx = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        while True:
            n = len(ctx)
            probs = self.logp[n].get(ctx)
            if probs is not None and char in probs:
                return probs[char]
            if n == 0:
                return math.log(1.0 / self.V)       # uniform floor
            ctx_b = ctx
            ctx = ctx[1:]
            bo = self.backoff[len(ctx_b)].get(ctx_b, 0.0)
            if probs is not None or bo:
                # apply backoff weight of the context we just left
                return bo + self.score(ctx, char)

    def sequence_logp(self, ids) -> float:
        ctx: tuple[int, ...] = ()
        total = 0.0
        for c in ids:
            total += self.score(ctx, int(c))
            ctx = (ctx + (int(c),))[-(self.order - 1):] if self.order > 1 else ()
        return total

    # ---------------- training ----------------
    @classmethod
    def train(cls, texts, vocab: Vocab, order: int = 3,
              discount: float = 0.5) -> "NGramLM":
        """Absolute-discount backoff estimation from raw transcripts."""
        lm = cls(order, len(vocab))
        counts = [defaultdict(lambda: defaultdict(int)) for _ in range(order)]
        for text in texts:
            ids = vocab.encode(text)
            ctx: tuple[int, ...] = ()
            for c in ids:
                for n in range(min(len(ctx), order - 1) + 1):
                    sub = ctx[len(ctx) - n:]
                    counts[n][sub][c] += 1
                if order > 1:
                    ctx = (ctx + (c,))[-(order - 1):]
        for n in range(order):
            for ctx, cc in counts[n].items():
                total = sum(cc.values())
                kinds = len(cc)
                probs = {}
                for c, k in cc.items():
                    probs[c] = math.log(max(k - discount, 1e-10) / total)
                lm.logp[n][ctx] = probs
                if n > 0:
                    lm.backoff[n][ctx] = math.log(discount * kinds / total)
        return lm

    # ---------------- ARPA I/O ----------------
    @classmethod
    def from_arpa(cls, path: str, vocab: Vocab) -> "NGramLM":
        """Load a character ARPA LM, mapping symbols through the vocab."""
        sections: dict[int, list] = {}
        order = 1
        with open(path, encoding="utf-8") as f:
            cur = None
            for line in f:
                line = line.strip()
                if line.startswith("\\") and "-grams:" in line:
                    n = int(line[1:line.index("-")])
                    cur = sections.setdefault(n, [])
                    order = max(order, n)
                elif line.startswith("\\") or not line:
                    cur = None
                elif cur is not None:
                    cur.append(line.split("\t"))
        lm = cls(order, len(vocab))

        def sym_id(s: str) -> int | None:
            """Vocab id for one ARPA symbol; None drops the gram. OOV
            symbols must be DROPPED, not crash (no <unk> in vocab →
            encode raises) and not silently pile distinct grams onto
            <unk> (with <unk> → encode maps every OOV there, so the
            round-trip check below rejects them)."""
            if s in ("<s>", "</s>", "<unk>"):
                return None
            try:
                ids = vocab.encode(s)
            except KeyError:
                return None
            if len(ids) != 1 or vocab.symbols[ids[0]] != s:
                return None
            return ids[0]

        kept = dropped = 0
        for n, rows in sections.items():
            for row in rows:
                logp10 = float(row[0])
                toks = row[1].split(" ")
                ids = [sym_id(t) for t in toks]
                if any(i is None for i in ids):
                    dropped += 1
                    continue
                kept += 1
                ctx, char = tuple(ids[:-1]), ids[-1]
                lm.logp[n - 1].setdefault(ctx, {})[char] = logp10 * LOG10
                # backoff weight of the n-gram *as a context*: key length is
                # n, so it lives at backoff[n] (train()/score()/to_arpa()
                # all index backoff by key length). Max-order grams can
                # never be a context, so ARPA backoff on them is dropped.
                if len(row) > 2 and n < order:
                    lm.backoff[n][ctx + (char,)] = float(row[2]) * LOG10
        # sentence markers always drop, so some loss is normal — but a
        # wholly mismatched vocab/ARPA pair (wrong corpus, wrong unit
        # segmentation) must not load silently as a near-empty LM
        if kept == 0:
            raise ValueError(
                f"{path}: every n-gram was dropped — no ARPA symbol maps "
                "to this vocab (wrong vocab file or unit segmentation?)")
        if dropped > kept:
            import sys
            print(f"warning: {path}: dropped {dropped} ARPA n-grams with "
                  f"out-of-vocab symbols (kept {kept}) — vocab and LM may "
                  "mismatch", file=sys.stderr)
        return lm

    def to_arpa(self, path: str, vocab: Vocab) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\\data\\\n")
            for n in range(self.order):
                cnt = sum(len(probs) for probs in self.logp[n].values())
                f.write(f"ngram {n+1}={cnt}\n")
            for n in range(self.order):
                f.write(f"\n\\{n+1}-grams:\n")
                for ctx, probs in self.logp[n].items():
                    for c, lp in probs.items():
                        gram = " ".join(vocab.symbols[i] for i in ctx + (c,))
                        bo = self.backoff[n + 1].get(ctx + (c,), 0.0) \
                            if n + 1 < self.order else 0.0
                        if bo:
                            f.write(f"{lp/LOG10:.6f}\t{gram}\t{bo/LOG10:.6f}\n")
                        else:
                            f.write(f"{lp/LOG10:.6f}\t{gram}\n")
            f.write("\n\\end\\\n")

    # ---------------- device tensorization ----------------
    def to_dense(self, max_order: int | None = None) -> tuple[np.ndarray, int]:
        """→ (table [V^(n-1), V] fp32 natural-log, effective order n).

        Context id = Σ_i ctx[i] · V^(k-1-i): the OLDEST char has the
        highest stride (row-major tuple indexing; exactly the id
        ``next_context_id`` rolls and the same convention ``to_hashed``
        documents); row 0 (all-zero context) is the BOS/empty context.
        """
        n = min(self.order, max_order or self.order)
        V = self.V
        C = V ** (n - 1)
        # Level-by-level backoff unrolling (replaces ~C*V recursive score()
        # calls with a handful of NumPy broadcasts). score()'s recursion is
        #   S_k[ctx, ch] = logp[k][ctx][ch]                 if present
        #                  backoff[k].get(ctx, 0) + S_{k-1}[ctx[1:], ch]  else
        # so each level table is: broadcast the shorter level, add backoff
        # weights, then overwrite explicit probabilities.
        levels: list[np.ndarray] = []
        t0 = np.full((V,), math.log(1.0 / V), np.float32)
        for ch, lp in self.logp[0].get((), {}).items():
            t0[ch] = lp
        levels.append(t0)
        for k in range(1, n):
            tk = np.broadcast_to(levels[k - 1], (V,) * k + (V,)).copy()
            for ctx, bo in self.backoff[k].items():
                if len(ctx) == k and bo:
                    tk[ctx] += bo
            for ctx, probs in self.logp[k].items():
                if len(ctx) != k:
                    continue
                row = tk[ctx]
                for ch, lp in probs.items():
                    row[ch] = lp
            levels.append(tk)
        # Dense table rows: full-length contexts map straight onto the top
        # level; contexts containing blank=0 (BOS padding) are re-looked-up
        # with zeros stripped — only ~C - (V-1)^(n-1) of them, loop is cheap.
        table = levels[n - 1].reshape(C, V).copy()
        if n > 1:
            digits = np.stack(
                [(np.arange(C) // V ** i) % V for i in range(n - 2, -1, -1)],
                axis=1)                       # [C, n-1] oldest char first
            for cid in np.nonzero((digits == 0).any(axis=1))[0]:
                ctx = tuple(int(c) for c in digits[cid] if c != 0)
                table[cid] = levels[len(ctx)][ctx]
        table[:, 0] = 0.0        # blank: no LM cost (CTC blank ≠ a word)
        return table, n

    @staticmethod
    def next_context_id(ctx_id, char, V: int, order: int):
        """Roll the dense context id (host or tensor arithmetic)."""
        if order <= 1:
            return ctx_id * 0
        C = V ** (order - 1)
        return (ctx_id * V + char) % C

    # ---------------- sparse device tensorization ----------------
    def to_hashed(self, max_order: int | None = None,
                  max_probes: int = 8,
                  rows_dtype=np.float32) -> "HashedLM":
        """→ HashedLM: the scalable device representation.

        The dense ``to_dense`` table is [V^(n-1), V] — 32 MB at V=200 /
        order 3 but 6.4 GB at order 4: too large for device memory. This
        builds instead:

        * ``rows`` [R, V] fp32 — one fully BACKOFF-RESOLVED score row per
          KNOWN context (a context with explicit probs or a backoff
          weight, at any level), rows[0] = the empty-context row. R
          scales with the n-grams the LM actually contains, not V^(n-1).
        * ``table`` [cap, 3] int32 — open-addressing (linear probe) hash
          from the context's double window-hash KEY PAIR (``ctx_keys``:
          key1 = the wrapping-int32 positional fold, which IS the exact
          numeric id while V^k < 2^31; key2 = an independent verifier)
          to its row. The beam recomputes the same pair per backoff
          level from its carried last-(order-1)-chars window.

        Exactness: for a known context, rows[ctx][ch] == score(ctx, ch)
        by construction. For an UNKNOWN context, score() descends through
        suffixes adding zero backoff until it reaches a known one, so its
        resolved row EQUALS the longest known suffix's row — which is
        what the device probe (longest-suffix-first, levels n-1..1, then
        rows[0]) returns. A BOS-partial context (fewer than n-1 chars so
        far) has leading zero digits, which are identity under both key
        folds — the key equality IS the semantic identity, so one
        level-untagged table suffices.

        Build guarantees every key is found within ``max_probes`` slots
        (capacity doubles until the max displacement fits), so the device
        probe loop is a static unroll. NO V^order bound: beyond int32
        range key1 degrades from exact id to hash, and the double pair
        keeps false hits ~2⁻⁶⁰-rare (detected and dropped at build).

        ``rows_dtype``: storage dtype of the [R, V] score rows. At
        CSJ/BPE vocab scale the rows dominate device residency (120k
        contexts × V=4096 fp32 = 1.9 GB);
        ``np.float16`` halves that at ~2⁻¹¹ RELATIVE log-prob error
        (10 mantissa bits; ≤1e-2 absolute on scores spanning [-20, 0]),
        far below any beam-reordering threshold the fuzz suite can
        detect. The beam casts gathered rows back to fp32.
        """
        n = min(self.order, max_order or self.order)
        if n < 2:
            # an order-1 LM has no contexts — nothing to hash, and the
            # beam's probe ladder would trace over an empty level axis;
            # the [1, V] dense table IS the right representation
            raise ValueError(
                "HashedLM requires order >= 2; use to_dense() (the order-1 "
                "dense table is a single [1, V] row)")
        V = self.V
        # resolved row for the empty context: uniform floor + unigrams
        r0 = np.full((V,), math.log(1.0 / V), np.float32)
        for ch, lp in self.logp[0].get((), {}).items():
            r0[ch] = lp
        rows = [r0]
        rowmap: dict[tuple, int] = {(): 0}
        # ascending levels: a context's base row (its longest known
        # suffix, via score()'s zero-backoff descent) is already built
        for k in range(1, n):
            known = set(self.logp[k].keys())
            known.update(c for c, b in self.backoff[k].items()
                         if len(c) == k and b)
            for ctx in sorted(known):
                if len(ctx) != k:
                    continue
                base = ()
                for j in range(1, k):       # longest known proper suffix
                    if ctx[j:] in rowmap:
                        base = ctx[j:]
                        break
                row = rows[rowmap[base]].copy()
                row += np.float32(self.backoff[k].get(ctx, 0.0))
                for ch, lp in self.logp[k].get(ctx, {}).items():
                    row[ch] = lp
                rowmap[ctx] = len(rows)
                rows.append(row)
        rows_arr = np.stack(rows)
        rows_arr[:, 0] = 0.0     # blank: no LM cost (CTC blank ≠ a word)
        # double window-hash keys (module-level ``ctx_keys``); a real
        # context whose pair is (0, 0) — indistinguishable from the
        # BOS/empty window — or a pair collision between two stored
        # contexts is ~2⁻⁶⁰-rare (and impossible while V^k < 2^31, where
        # key1 is the exact id): detected here and the later context left
        # out of the table. A (0, 0) context's lookups then fall back to
        # its longest known suffix; a collided context's lookups compute
        # the same pair as the earlier context and take THAT context's
        # row, not its own
        keys: list[tuple[int, int]] = []
        ridx: list[int] = []
        seen: dict[tuple[int, int], tuple] = {}
        dropped = 0
        for ctx, r in rowmap.items():
            if not ctx:
                continue         # () probes nothing; it IS rows[0]
            kp = ctx_keys(ctx, V)
            if kp == (0, 0) or kp in seen:
                dropped += 1
                continue
            seen[kp] = ctx
            keys.append(kp)
            ridx.append(r)
        if dropped:
            import sys
            print(f"warning: to_hashed dropped {dropped} context(s) on "
                  "a window-hash collision (~2^-60-rare)", file=sys.stderr)
        cap = 1 << max(4, int(np.ceil(np.log2(max(2 * len(keys), 2)))))
        while True:
            table = np.full((cap, 3), -1, np.int32)
            table[:, 0] = 0      # empty slots can never match a kept key
            table[:, 1] = -1
            ok = True
            for (k1, k2), r in zip(keys, ridx):
                # == uint32-wraparound hash & (cap-1): cap divides 2^32
                slot = (k1 & 0xFFFFFFFF) * 2654435761 % cap
                for p in range(max_probes):
                    s = (slot + p) % cap
                    if table[s, 2] == -1:
                        table[s] = (k1, k2, r)
                        break
                else:
                    ok = False
                    break
            if ok:
                break
            cap *= 2
        return HashedLM(table=table, rows=rows_arr.astype(rows_dtype),
                        order=n, max_probes=max_probes)


def device_lm(lm: NGramLM, repr: str = "auto",
              dense_budget_bytes: int = 256 << 20,
              hashed_rows_budget_bytes: int = 512 << 20):
    """Pick the device representation for shallow fusion.

    ``auto`` uses the dense [V^(n-1), V] table while it fits the budget
    (a single gather per step — fastest) and falls back to the sparse
    HashedLM beyond it (order ≥ 4 / large V, where dense is GBs). If
    the HashedLM's fp32 score rows would exceed
    ``hashed_rows_budget_bytes`` (CSJ/BPE vocab scale: 120k contexts ×
    V=4096 = 1.9 GB), they are stored fp16 — halving residency at
    ~2⁻¹¹ relative log-prob error (``to_hashed`` docstring). The
    returned object plugs straight into beam_decode's ``lm=``.
    """
    if repr not in ("dense", "hashed", "auto"):
        raise ValueError(f"unknown LM repr {repr!r}")
    if lm.order < 2:
        # order-1 has no contexts: the [1, V] dense row is the only valid
        # device form (HashedLM refuses it), whatever repr was asked for
        return lm.to_dense()
    if repr == "dense":
        return lm.to_dense()
    if repr != "hashed":
        dense_bytes = lm.V ** (lm.order - 1) * lm.V * 4
        if dense_bytes <= dense_budget_bytes:
            return lm.to_dense()
    h = lm.to_hashed()
    if h.rows.nbytes > hashed_rows_budget_bytes:
        h = HashedLM(table=h.table, rows=h.rows.astype(np.float16),
                     order=h.order, max_probes=h.max_probes)
    return h


class HashedLM:
    """Sparse device n-gram: open-addressing context hash + resolved rows
    (see NGramLM.to_hashed). ``bytes`` property reports device residency;
    scoring semantics are exactly NGramLM.score (differential-tested)."""

    def __init__(self, table: np.ndarray, rows: np.ndarray, order: int,
                 max_probes: int = 8):
        self.table = table
        self.rows = rows
        self.order = order
        self.max_probes = max_probes

    @property
    def vocab_size(self) -> int:
        return self.rows.shape[1]

    @property
    def bytes(self) -> int:
        return self.table.nbytes + self.rows.nbytes
