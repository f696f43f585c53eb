"""FL-list and lemma typing (paper §1.1).

All lemmas are sorted in decreasing order of their occurrence frequency in
the corpus — the *FL-list*. The rank of a lemma is its *FL-number*; we use
0-based ranks and make the integer lemma id coincide with the FL-number,
so typing a lemma is a single comparison:

    id <  sw_count                     -> stop lemma
    id <  sw_count + fu_count          -> frequently used lemma
    otherwise                          -> ordinary lemma

The paper uses SWCount=700, FUCount=2100.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import IntEnum
from pathlib import Path

import numpy as np

UNKNOWN_FL = 2**31 - 1  # the paper's "~": a very large number

DEFAULT_SW_COUNT = 700
DEFAULT_FU_COUNT = 2100


class LemmaType(IntEnum):
    STOP = 0
    FREQUENT = 1
    ORDINARY = 2


@dataclass
class Lexicon:
    """FL-ordered lemma dictionary with corpus statistics."""

    lemmas: list[str]  # index == lemma id == 0-based FL-number
    counts: np.ndarray  # occurrences per lemma, non-increasing
    doc_freqs: np.ndarray  # number of documents containing the lemma
    n_docs: int
    sw_count: int = DEFAULT_SW_COUNT
    fu_count: int = DEFAULT_FU_COUNT
    _fl: dict[str, int] = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if not self._fl:
            self._fl = {w: i for i, w in enumerate(self.lemmas)}

    # -- lookups ----------------------------------------------------------
    def fl(self, lemma: str) -> int:
        """0-based FL-number; UNKNOWN_FL ('~') for out-of-corpus lemmas."""
        return self._fl.get(lemma, UNKNOWN_FL)

    def lemma_of(self, lemma_id: int) -> str:
        return self.lemmas[lemma_id]

    @property
    def n_lemmas(self) -> int:
        return len(self.lemmas)

    # -- typing (paper §1.1) ----------------------------------------------
    def type_of_id(self, lemma_id: int) -> LemmaType:
        if lemma_id < self.sw_count:
            return LemmaType.STOP
        if lemma_id < self.sw_count + self.fu_count:
            return LemmaType.FREQUENT
        return LemmaType.ORDINARY

    def type_of(self, lemma: str) -> LemmaType:
        return self.type_of_id(self.fl(lemma))

    def is_stop_id(self, lemma_id) -> np.ndarray:
        return np.asarray(lemma_id) < self.sw_count

    def is_nonstop_id(self, lemma_id) -> np.ndarray:
        return np.asarray(lemma_id) >= self.sw_count

    # -- relevance support --------------------------------------------------
    def idf(self, lemma_id: int) -> float:
        if lemma_id >= len(self.lemmas):
            return float(np.log1p(self.n_docs))
        df = max(int(self.doc_freqs[lemma_id]), 1)
        return float(np.log1p(self.n_docs / df))

    # -- construction -------------------------------------------------------
    @classmethod
    def build(
        cls,
        doc_lemma_ids_or_strs,
        sw_count: int = DEFAULT_SW_COUNT,
        fu_count: int = DEFAULT_FU_COUNT,
    ) -> "Lexicon":
        """Build from an iterable of documents; each document is a list of
        lemma strings (or a list of per-token lemma-alternative lists)."""
        counts: dict[str, int] = {}
        dfs: dict[str, int] = {}
        n_docs = 0
        for doc in doc_lemma_ids_or_strs:
            n_docs += 1
            seen: set[str] = set()
            for tok in doc:
                alts = tok if isinstance(tok, (list, tuple)) else (tok,)
                for lem in alts:
                    counts[lem] = counts.get(lem, 0) + 1
                    if lem not in seen:
                        seen.add(lem)
                        dfs[lem] = dfs.get(lem, 0) + 1
        order = sorted(counts, key=lambda w: (-counts[w], w))
        return cls(
            lemmas=order,
            counts=np.array([counts[w] for w in order], np.int64),
            doc_freqs=np.array([dfs[w] for w in order], np.int64),
            n_docs=n_docs,
            sw_count=sw_count,
            fu_count=fu_count,
        )

    @classmethod
    def from_rank_counts(
        cls,
        counts: np.ndarray,
        doc_freqs: np.ndarray,
        n_docs: int,
        sw_count: int = DEFAULT_SW_COUNT,
        fu_count: int = DEFAULT_FU_COUNT,
        names: list[str] | None = None,
    ) -> "Lexicon":
        """For synthetic corpora where lemma id == frequency rank already."""
        if names is None:
            names = [f"w{i}" for i in range(len(counts))]
        return cls(
            lemmas=names,
            counts=np.asarray(counts, np.int64),
            doc_freqs=np.asarray(doc_freqs, np.int64),
            n_docs=n_docs,
            sw_count=sw_count,
            fu_count=fu_count,
        )

    # -- persistence --------------------------------------------------------
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = {
            "lemmas": self.lemmas,
            "counts": self.counts.tolist(),
            "doc_freqs": self.doc_freqs.tolist(),
            "n_docs": self.n_docs,
            "sw_count": self.sw_count,
            "fu_count": self.fu_count,
        }
        path.write_text(json.dumps(payload))

    @classmethod
    def load(cls, path: str | Path) -> "Lexicon":
        payload = json.loads(Path(path).read_text())
        return cls(
            lemmas=payload["lemmas"],
            counts=np.array(payload["counts"], np.int64),
            doc_freqs=np.array(payload["doc_freqs"], np.int64),
            n_docs=payload["n_docs"],
            sw_count=payload["sw_count"],
            fu_count=payload["fu_count"],
        )
