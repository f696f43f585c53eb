"""Synthetic Zipf corpus + token tables.

The paper's collection (71.5 GB, 195k documents of fiction/articles) is not
available offline, so experiments run on a synthetic corpus whose word
frequency distribution follows Zipf's law (paper §1, Fig. 1). Lemma ids are
frequency ranks *by construction*, which matches the Lexicon convention
(id == FL-number) and lets us plant the exact SWCount/FUCount regime.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.lexicon import Lexicon, DEFAULT_FU_COUNT, DEFAULT_SW_COUNT


@dataclass
class TokenTable:
    """Flat occurrence table: one row per (token position, lemma).

    Multi-lemma words contribute several rows with the same (doc, pos).
    Rows are sorted by (doc, pos, lemma).
    """

    doc_ids: np.ndarray  # int32 (T,)
    positions: np.ndarray  # int32 (T,) ordinal within document
    lemma_ids: np.ndarray  # int32 (T,)
    doc_lengths: np.ndarray  # int32 (n_docs,) in token positions

    @property
    def n_docs(self) -> int:
        return int(self.doc_lengths.size)

    @property
    def n_rows(self) -> int:
        return int(self.doc_ids.size)

    def sorted_copy(self) -> "TokenTable":
        order = np.lexsort((self.lemma_ids, self.positions, self.doc_ids))
        return TokenTable(
            self.doc_ids[order], self.positions[order], self.lemma_ids[order], self.doc_lengths
        )

    def to_doc_lists(self) -> list[list[int]]:
        """Per-document lemma-id lists in position order — the shape
        ``SegmentedIndex.add_document`` consumes. Single-lemma corpora
        only (multi-lemma positions would need the alternatives shape)."""
        order = np.lexsort((self.positions, self.doc_ids))
        docs, toks = self.doc_ids[order], self.lemma_ids[order]
        splits = np.searchsorted(docs, np.arange(1, self.n_docs))
        return [d.tolist() for d in np.split(toks, splits)]

    @classmethod
    def from_docs(cls, docs: list[np.ndarray]) -> "TokenTable":
        """docs: list of int lemma-id arrays (single lemma per position)."""
        lengths = np.array([len(d) for d in docs], np.int32)
        doc_ids = np.repeat(np.arange(len(docs), dtype=np.int32), lengths)
        positions = np.concatenate([np.arange(len(d), dtype=np.int32) for d in docs]) if docs else np.zeros(0, np.int32)
        lemma_ids = np.concatenate(docs).astype(np.int32) if docs else np.zeros(0, np.int32)
        return cls(doc_ids, positions, lemma_ids, lengths)

    @classmethod
    def from_lemmatized(cls, docs: list[list[list[int]]]) -> "TokenTable":
        """docs: per doc, per token position, a list of lemma ids."""
        d_l, p_l, l_l, lens = [], [], [], []
        for di, doc in enumerate(docs):
            lens.append(len(doc))
            for pi, alts in enumerate(doc):
                for lem in alts:
                    d_l.append(di)
                    p_l.append(pi)
                    l_l.append(lem)
        return cls(
            np.array(d_l, np.int32),
            np.array(p_l, np.int32),
            np.array(l_l, np.int32),
            np.array(lens, np.int32),
        )


def zipf_probs(vocab_size: int, alpha: float = 1.1, shift: float = 2.7) -> np.ndarray:
    """Zipf-Mandelbrot pmf over ranks 0..vocab_size-1."""
    ranks = np.arange(vocab_size, dtype=np.float64)
    w = 1.0 / np.power(ranks + shift, alpha)
    return w / w.sum()


def generate_corpus(
    n_docs: int = 2000,
    mean_doc_len: int = 200,
    vocab_size: int = 50_000,
    alpha: float = 1.1,
    seed: int = 0,
) -> tuple[TokenTable, Lexicon]:
    """Generate a Zipf corpus; returns (token table, lexicon).

    Lemma ids are re-ranked by *observed* frequency so the Lexicon id ==
    FL-number invariant holds exactly even at small corpus sizes.
    """
    rng = np.random.default_rng(seed)
    lengths = np.maximum(8, rng.poisson(mean_doc_len, n_docs)).astype(np.int64)
    total = int(lengths.sum())
    probs = zipf_probs(vocab_size, alpha)
    raw = rng.choice(vocab_size, size=total, p=probs).astype(np.int32)

    # re-rank by observed frequency (stable: ties broken by original id)
    counts = np.bincount(raw, minlength=vocab_size)
    order = np.lexsort((np.arange(vocab_size), -counts))  # observed rank -> raw id
    rank_of = np.empty(vocab_size, np.int32)
    rank_of[order] = np.arange(vocab_size, dtype=np.int32)
    tokens = rank_of[raw]

    doc_ids = np.repeat(np.arange(n_docs, dtype=np.int32), lengths)
    positions = np.concatenate([np.arange(n, dtype=np.int32) for n in lengths])
    table = TokenTable(doc_ids, positions, tokens, lengths.astype(np.int32))

    sorted_counts = counts[order]
    n_seen = int((sorted_counts > 0).sum())
    # doc freqs
    pair = doc_ids.astype(np.int64) * vocab_size + tokens
    uniq = np.unique(pair)
    dfs = np.bincount((uniq % vocab_size).astype(np.int64), minlength=vocab_size)
    lex = Lexicon.from_rank_counts(
        counts=sorted_counts[:n_seen],
        doc_freqs=dfs[:n_seen],
        n_docs=n_docs,
        sw_count=min(DEFAULT_SW_COUNT, n_seen // 3),
        fu_count=min(DEFAULT_FU_COUNT, n_seen // 3),
    )
    return table, lex


def sample_typed_queries(
    table: TokenTable,
    lex: Lexicon,
    n_queries: int,
    qtype: str = "qt1",
    min_len: int = 3,
    max_len: int = 5,
    window: int = 9,
    seed: int = 0,
) -> list[list[int]]:
    """Sample queries of one QT class from real co-occurrence windows
    (the query-log-derived shape of sample_stop_queries, generalized):

    * ``"qt1"`` — all stop lemmas;
    * ``"qt2"`` — all frequently used lemmas (the (w,v) serve path);
    * ``"qt3"`` — all ordinary lemmas (the ordinary-window serve path);
    * ``"qt4"`` — at least one frequently used and one ordinary lemma,
      no stop lemmas (the other ordinary-window query class);
    * ``"qt5"`` — at least one stop lemma plus non-stop lemmas (the NSW
      serve path)."""
    rng = np.random.default_rng(seed)
    sw = lex.sw_count
    fu_hi = sw + lex.fu_count
    preds = {
        "qt1": lambda l: l < sw,
        "qt2": lambda l: (l >= sw) & (l < fu_hi),
        "qt3": lambda l: l >= fu_hi,
    }
    # mixed classes draw one sub-pool from each side of the split:
    # qt4 = frequent + ordinary (seeded on frequent rows, the rarer
    # side of its split in a Zipf stream), qt5 = stop + non-stop
    split = {
        "qt4": (preds["qt2"], lambda l: l >= fu_hi),
        "qt5": (lambda l: l < sw, lambda l: l >= sw),
    }
    seed_pred = split[qtype][0] if qtype in split else preds[qtype]
    seed_rows = np.nonzero(seed_pred(table.lemma_ids))[0]
    queries: list[list[int]] = []
    guard = 0
    while len(queries) < n_queries and guard < n_queries * 200 and seed_rows.size:
        guard += 1
        r = int(rng.choice(seed_rows))
        d, p = int(table.doc_ids[r]), int(table.positions[r])
        m = (table.doc_ids == d) & (np.abs(table.positions - p) <= window)
        lems = table.lemma_ids[m]
        L = int(rng.integers(min_len, max_len + 1))
        if qtype in split:
            pa, pb = split[qtype]
            a = lems[pa(lems)]
            b = lems[pb(lems)]
            if a.size < 1 or b.size < 1:
                continue
            k_a = int(rng.integers(1, min(L - 1, a.size) + 1))
            k_b = min(L - k_a, int(b.size))
            q = [int(x) for x in rng.choice(a, size=k_a, replace=False)]
            q += [int(x) for x in rng.choice(b, size=k_b, replace=False)]
        else:
            pool = lems[preds[qtype](lems)]
            if pool.size < min_len:
                continue
            take = rng.choice(pool.size, size=min(L, pool.size), replace=False)
            q = [int(x) for x in pool[take]]
        if len(q) >= min_len:
            queries.append(q)
    return queries


def sample_mixed_queries(
    table: TokenTable,
    lex: Lexicon,
    n_queries: int,
    kinds: tuple = ("qt1", "qt2", "qt3", "qt4", "qt5"),
    min_len: int = 3,
    max_len: int = 5,
    window: int = 9,
    seed: int = 0,
) -> list[list[int]]:
    """Round-robin interleave of per-type samples across all five query
    classes — the mixed-traffic shape the serving engine's query-type
    dispatch is built for."""
    per = -(-n_queries // len(kinds))
    cols = [
        sample_typed_queries(table, lex, per, k, min_len, max_len, window, seed + i)
        for i, k in enumerate(kinds)
    ]
    out: list[list[int]] = []
    for i in range(per):
        for c in cols:
            if i < len(c):
                out.append(c[i])
    return out[:n_queries]


def sample_stop_queries(
    table: TokenTable,
    lex: Lexicon,
    n_queries: int,
    min_len: int = 3,
    max_len: int = 5,
    window: int = 9,
    seed: int = 0,
) -> list[list[int]]:
    """Sample QT1 queries (all stop lemmas) from real co-occurrence windows,
    mirroring the paper's query-log-derived set: queries of 3..5 frequently
    occurring words that do have proximate matches in the collection."""
    rng = np.random.default_rng(seed)
    stop_rows = np.nonzero(table.lemma_ids < lex.sw_count)[0]
    # order rows to allow windowed scans
    queries: list[list[int]] = []
    guard = 0
    while len(queries) < n_queries and guard < n_queries * 50:
        guard += 1
        r = int(rng.choice(stop_rows))
        d, p = int(table.doc_ids[r]), int(table.positions[r])
        m = (table.doc_ids == d) & (np.abs(table.positions - p) <= window)
        lems = table.lemma_ids[m]
        lems = lems[lems < lex.sw_count]
        if lems.size < min_len:
            continue
        L = int(rng.integers(min_len, max_len + 1))
        take = rng.choice(lems.size, size=min(L, lems.size), replace=False)
        q = [int(x) for x in lems[take]]
        if len(q) >= min_len:
            queries.append(q)
    return queries
