"""Tokenizer + morphological analyzer (paper §1.1).

The paper uses a dictionary morphology: for each word the analyzer yields a
list of lemmas (canonical forms) — possibly several, e.g. "tinged" ->
[ting, tinge], "are" -> [are, be], "mine" -> [mine, my]. Words absent from
the dictionary lemmatize to themselves.

We implement a compact English analyzer: an irregular-form dictionary plus
suffix rules that emit *all* plausible stems (the paper's multi-lemma
behaviour falls out naturally: stripping "-ed" from "tinged" yields both
"ting" and "tinge" because the e-restored variant is also emitted).
"""

from __future__ import annotations

import re

_TOKEN_RE = re.compile(r"[a-z]+")

# Irregular forms -> lemma list. Includes the paper's worked examples.
IRREGULAR: dict[str, list[str]] = {
    # be-forms; "are" is also a noun (unit of area) -> two lemmas, as in the paper
    "am": ["be"], "is": ["be"], "are": ["are", "be"], "was": ["be"],
    "were": ["be"], "been": ["be"], "being": ["be"],
    "has": ["have"], "had": ["have"], "having": ["have"],
    "does": ["do"], "did": ["do"], "done": ["do"], "doing": ["do"],
    "goes": ["go"], "went": ["go"], "gone": ["go"],
    "said": ["say"], "says": ["say"],
    "made": ["make"], "making": ["make"],
    "took": ["take"], "taken": ["take"], "taking": ["take"],
    "came": ["come"], "coming": ["come"],
    "saw": ["saw", "see"], "seen": ["see"], "seeing": ["see"],
    "knew": ["know"], "known": ["know"],
    "thought": ["think"], "got": ["get"], "gotten": ["get"],
    "gave": ["give"], "given": ["give"],
    "found": ["find"], "told": ["tell"], "felt": ["feel"],
    "left": ["left", "leave"], "kept": ["keep"], "held": ["hold"],
    "brought": ["bring"], "began": ["begin"], "begun": ["begin"],
    "wrote": ["write"], "written": ["write"],
    "stood": ["stand"], "heard": ["hear"], "met": ["meet"],
    "ran": ["run"], "running": ["run"], "sat": ["sit"], "spoke": ["speak"],
    "men": ["man"], "women": ["woman"], "children": ["child"],
    "feet": ["foot"], "teeth": ["tooth"], "mice": ["mouse"],
    "people": ["people", "person"], "lives": ["life", "live"],
    "mine": ["mine", "my"],  # paper example: FL 2482 / 264
    "her": ["her", "she"], "his": ["his", "he"], "them": ["they"],
    "me": ["i", "me"], "us": ["we", "us"], "him": ["he"],
    "better": ["better", "good"], "best": ["best", "good"],
    "worse": ["worse", "bad"], "worst": ["worst", "bad"],
    "an": ["a"], "this": ["this"], "these": ["this"], "those": ["that"],
    "cannot": ["can", "not"],
}

_VOWELS = set("aeiou")


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


def _dedup(seq: list[str]) -> list[str]:
    out: list[str] = []
    for s in seq:
        if s and s not in out:
            out.append(s)
    return out


def lemmatize_word(word: str) -> list[str]:
    """Return the list of lemmas for a word (paper: possibly several)."""
    w = word.lower()
    if w in IRREGULAR:
        return list(IRREGULAR[w])
    cands: list[str] = []
    n = len(w)
    # plural / 3sg
    if w.endswith("ies") and n > 4:
        cands.append(w[:-3] + "y")
    elif w.endswith("sses") or w.endswith("shes") or w.endswith("ches") or w.endswith("xes") or w.endswith("zes"):
        cands.append(w[:-2])
    elif w.endswith("ss"):
        pass  # "glass", "press" are their own lemma
    elif w.endswith("s") and n > 3:
        cands.append(w[:-1])
    # past tense
    if w.endswith("ied") and n > 4:
        cands.append(w[:-3] + "y")
    elif w.endswith("ed") and n > 3:
        stem = w[:-2]
        cands.append(stem)           # "tinged" -> "ting"
        cands.append(stem + "e")     # "tinged" -> "tinge"
        if len(stem) > 2 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
            cands.append(stem[:-1])  # "stopped" -> "stop"
    # gerund
    if w.endswith("ing") and n > 4:
        stem = w[:-3]
        cands.append(stem)
        cands.append(stem + "e")     # "tinging" -> "tinge"
        if len(stem) > 2 and stem[-1] == stem[-2] and stem[-1] not in _VOWELS:
            cands.append(stem[:-1])  # "sitting" -> "sit"
    cands = _dedup([c for c in cands if len(c) >= 2])
    return cands if cands else [w]


def lemmatize_text(text: str) -> list[list[str]]:
    """Tokenize + lemmatize; one lemma-alternative list per token position."""
    return [lemmatize_word(t) for t in tokenize(text)]
