"""The benchmark's own copy of the synthetic corpus and query samplers.

A copy of the port's ``data/corpus.py`` generators (``generate_corpus``,
``sample_typed_queries``, ``sample_mixed_queries``) and of
``tune/workloads.py``'s ``stopword_flood``, kept here so that a change to
the program cannot move the yardstick. Outputs are plain numpy arrays and
lemma-id lists: the same seed gives the same corpus and the same typed
queries as the originals (the window sampler finds a token's neighbours
by slicing its document instead of scanning the whole table, which
selects the same rows in the same order); the flood draws the original's
distribution, vectorised, so that a stream of a few hundred thousand
queries costs under a second.

The corpus is a Zipf-Mandelbrot stand-in for the paper's private
collection (DESIGN.md §1): lemma ids are frequency ranks by construction,
so a lemma's type is one comparison against SWCount / SWCount + FUCount.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DEFAULT_SW_COUNT = 700
DEFAULT_FU_COUNT = 2100


@dataclass
class Corpus:
    """One row per token, sorted by (doc, pos); one lemma per position.
    ``counts`` / ``doc_freqs`` are per lemma id (== frequency rank)."""

    doc_ids: np.ndarray  # int32 (T,)
    positions: np.ndarray  # int32 (T,)
    lemma_ids: np.ndarray  # int32 (T,)
    doc_lengths: np.ndarray  # int32 (n_docs,)
    counts: np.ndarray  # int64 (n_lemmas,)
    doc_freqs: np.ndarray  # int64 (n_lemmas,)
    sw_count: int
    fu_count: int

    @property
    def n_docs(self) -> int:
        return int(self.doc_lengths.size)

    @property
    def n_tokens(self) -> int:
        return int(self.lemma_ids.size)

    def doc_starts(self) -> np.ndarray:
        starts = np.zeros(self.n_docs + 1, np.int64)
        np.cumsum(self.doc_lengths.astype(np.int64), out=starts[1:])
        return starts


def zipf_probs(vocab_size: int, alpha: float = 1.1, shift: float = 2.7) -> np.ndarray:
    ranks = np.arange(vocab_size, dtype=np.float64)
    w = 1.0 / np.power(ranks + shift, alpha)
    return w / w.sum()


def generate_corpus(n_docs: int, mean_doc_len: int, vocab_size: int,
                    alpha: float, seed: int) -> Corpus:
    """Zipf corpus; lemma ids re-ranked by observed frequency so that id ==
    FL-number holds exactly."""
    rng = np.random.default_rng(seed)
    lengths = np.maximum(8, rng.poisson(mean_doc_len, n_docs)).astype(np.int64)
    total = int(lengths.sum())
    probs = zipf_probs(vocab_size, alpha)
    raw = rng.choice(vocab_size, size=total, p=probs).astype(np.int32)

    counts = np.bincount(raw, minlength=vocab_size)
    order = np.lexsort((np.arange(vocab_size), -counts))
    rank_of = np.empty(vocab_size, np.int32)
    rank_of[order] = np.arange(vocab_size, dtype=np.int32)
    tokens = rank_of[raw]

    doc_ids = np.repeat(np.arange(n_docs, dtype=np.int32), lengths)
    starts = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lengths, out=starts[1:])
    positions = (np.arange(total, dtype=np.int64) - np.repeat(starts[:-1], lengths)).astype(np.int32)

    sorted_counts = counts[order]
    n_seen = int((sorted_counts > 0).sum())
    pair = doc_ids.astype(np.int64) * vocab_size + tokens
    uniq = np.unique(pair)
    dfs = np.bincount((uniq % vocab_size).astype(np.int64), minlength=vocab_size)
    return Corpus(
        doc_ids=doc_ids, positions=positions, lemma_ids=tokens,
        doc_lengths=lengths.astype(np.int32),
        counts=sorted_counts[:n_seen].astype(np.int64),
        doc_freqs=dfs[:n_seen].astype(np.int64),
        sw_count=min(DEFAULT_SW_COUNT, n_seen // 3),
        fu_count=min(DEFAULT_FU_COUNT, n_seen // 3),
    )


class _Windows:
    """The tokens of a document within ``window`` positions of a token,
    in (pos) order: what ``(doc_ids == d) & (|positions - p| <= window)``
    selects from a (doc, pos)-sorted table."""

    def __init__(self, corpus: Corpus):
        self.lemmas = corpus.lemma_ids
        self.doc_ids = corpus.doc_ids
        self.positions = corpus.positions
        self.starts = corpus.doc_starts()
        self.lengths = corpus.doc_lengths.astype(np.int64)

    def around(self, row: int, window: int) -> np.ndarray:
        d, p = int(self.doc_ids[row]), int(self.positions[row])
        base = self.starts[d]
        lo = base + max(0, p - window)
        hi = base + min(int(self.lengths[d]), p + window + 1)
        return self.lemmas[lo:hi]


def sample_typed_queries(corpus: Corpus, n_queries: int, qtype: str, min_len: int,
                         max_len: int, window: int, seed: int,
                         windows: _Windows | None = None) -> list[list[int]]:
    """Queries of one QT class drawn from real co-occurrence windows."""
    rng = np.random.default_rng(seed)
    sw = corpus.sw_count
    fu_hi = sw + corpus.fu_count
    preds = {
        "qt1": lambda l: l < sw,
        "qt2": lambda l: (l >= sw) & (l < fu_hi),
        "qt3": lambda l: l >= fu_hi,
    }
    split = {
        "qt4": (preds["qt2"], lambda l: l >= fu_hi),
        "qt5": (lambda l: l < sw, lambda l: l >= sw),
    }
    seed_pred = split[qtype][0] if qtype in split else preds[qtype]
    seed_rows = np.nonzero(seed_pred(corpus.lemma_ids))[0]
    win = windows if windows is not None else _Windows(corpus)
    queries: list[list[int]] = []
    guard = 0
    while len(queries) < n_queries and guard < n_queries * 200 and seed_rows.size:
        guard += 1
        r = int(rng.choice(seed_rows))
        lems = win.around(r, window)
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


def mixed_queries(corpus: Corpus, n_queries: int, weights: dict, min_len: int,
                  max_len: int, window: int, seed: int) -> list[list[int]]:
    """Five-type traffic: per-class counts by largest remainder over
    ``weights``, each class sampled from co-occurrence windows, interleaved
    proportionally (with equal weights this is ``sample_mixed_queries``'s
    round-robin)."""
    kinds = [k for k in ("qt1", "qt2", "qt3", "qt4", "qt5") if weights.get(k, 0) > 0]
    total = float(sum(weights[k] for k in kinds))
    exact = {k: n_queries * weights[k] / total for k in kinds}
    counts = {k: int(exact[k]) for k in kinds}
    short = n_queries - sum(counts.values())
    for k in sorted(kinds, key=lambda k: exact[k] - counts[k], reverse=True)[:short]:
        counts[k] += 1
    win = _Windows(corpus)
    cols = {k: sample_typed_queries(corpus, counts[k], k, min_len, max_len, window,
                                    seed + i, win)
            for i, k in enumerate(kinds)}
    out: list[list[int]] = []
    taken = {k: 0 for k in kinds}
    for i in range(n_queries):
        # the class whose share of the stream lags most goes next
        k = min(kinds, key=lambda k: ((taken[k] + 1) / max(counts[k], 1), kinds.index(k)))
        if taken[k] < len(cols[k]):
            out.append(cols[k][taken[k]])
        taken[k] += 1
    return out


def stopword_flood(corpus: Corpus, n_queries: int, hottest: int, min_len: int,
                   max_len: int, seed: int) -> list[list[int]]:
    """All-stop QT1 queries: ``min_len``..``max_len`` distinct lemmas drawn
    by frequency from the ``hottest`` stop lemmas. The distribution of
    ``tune/workloads.py``'s ``stopword_flood`` (successive draws by
    frequency without replacement), drawn for all queries at once by the
    Gumbel top-k rule: the lemmas of a query are its ``L`` largest
    ``log p + Gumbel`` keys, in descending order."""
    rng = np.random.default_rng(seed)
    sw = int(corpus.sw_count)
    if sw < min_len:
        raise ValueError(f"lexicon has only {sw} stop lemmas (< min_len={min_len})")
    n_pool = min(hottest, sw)
    counts = corpus.counts[:n_pool].astype(np.float64)
    lengths = np.minimum(rng.integers(min_len, max_len + 1, size=n_queries), n_pool)
    keys = np.log(counts / counts.sum()) + rng.gumbel(size=(n_queries, n_pool))
    ranked = np.argsort(-keys, axis=1, kind="stable")[:, :max(max_len, 1)].tolist()
    return [row[:L] for row, L in zip(ranked, lengths.tolist())]
