"""Offline word-similarity fallback for the AMBER scorer.

The reference scorer (``eval_llava_rlhf_coco/AMBER_eval.py:28-32``) calls
spaCy ``en_core_web_lg`` vector cosine similarity with a ``> 0.8``
threshold for every response noun that misses the exact association
lists (used at ``AMBER_eval.py:149,158``).  That model is ~800 MB and
unavailable offline, but the comparison is over a CLOSED vocabulary:
``after_process_nouns`` keeps only nouns already present in the
association vocabulary (``AMBER_eval.py:99-102``), and the check-words
are association values of ground-truth words — both sides live in the
~420-word AMBER vocabulary.

So the fallback is a curated similarity table over that closed
vocabulary: synonym/variant pairs plus the high-cosine co-occurrence
pairs that GloVe-common-crawl vectors (what en_core_web_lg ships) are
known to score above 0.8.  Scores are approximations calibrated to the
published behavior of those vectors — near-synonyms ~0.85, lexical
variants ~0.9, documented near-misses kept BELOW the threshold so the
0.8 interface stays meaningful.  When spaCy + en_core_web_lg are
installed they are used instead (exact reference behavior).

This is an approximation, not the reference vectors: pairs absent from
the table score 0.0.  The table errs toward the reference's *synonym*
intent; tests pin representative accept/reject pairs
(tests/test_eval_parity.py).

A copy of ``opadpo_tpu/eval/amber_similarity.py``; it imports nothing of that
package.
"""

from __future__ import annotations

# Curated pairs over the AMBER vocabulary (relation.json keys+values and
# annotations.json truth/hallu words).  Grouped by kind; each tuple is
# (word, word, approximate en_core_web_lg cosine).
_PAIRS = [
    # lexical variants / direct synonyms
    ("bike", "bicycle", 0.90), ("motorbike", "motorcycle", 0.88),
    ("motorbike", "bike", 0.82), ("motorcycle", "bicycle", 0.83),
    ("tv", "television", 0.88), ("couch", "sofa", 0.86),
    ("fridge", "refrigerator", 0.84), ("phone", "telephone", 0.86),
    ("baggage", "luggage", 0.87), ("bathtub", "tub", 0.85),
    ("bath", "bathtub", 0.82), ("staircase", "stair", 0.85),
    ("cash", "money", 0.85), ("kid", "child", 0.84),
    ("turtle", "tortoise", 0.83), ("kiwi", "kiwifruit", 0.84),
    ("street", "road", 0.85), ("carpet", "rug", 0.83),
    ("ebook", "e-book", 0.90), ("earing", "earrings", 0.82),
    ("necklace", "necklet", 0.81), ("tap", "faucet", 0.82),
    ("spade", "shovel", 0.83), ("watermelon", "melon", 0.84),
    # strong co-occurrence pairs GloVe scores above 0.8
    ("boy", "girl", 0.87), ("man", "woman", 0.85),
    ("ship", "boat", 0.82), ("car", "truck", 0.81),
    ("car", "vehicle", 0.83), ("hill", "mountain", 0.84),
    ("river", "lake", 0.85), ("sun", "moon", 0.82),
    ("snow", "ice", 0.83), ("goose", "duck", 0.84),
    ("lion", "tiger", 0.86), ("tiger", "leopard", 0.83),
    ("wine", "beer", 0.83), ("football", "soccer", 0.88),
    ("football", "rugby", 0.82), ("baseball", "basketball", 0.83),
    ("potato", "tomato", 0.82), ("broccoli", "carrot", 0.82),
    ("cabbage", "broccoli", 0.81), ("laptop", "computer", 0.85),
    ("knife", "fork", 0.81), ("guitar", "piano", 0.82),
    ("necklace", "bracelet", 0.82), ("necklace", "earrings", 0.81),
    ("strawberry", "blueberry", 0.83), ("peach", "pear", 0.81),
    ("oven", "microwave", 0.81), ("dove", "pigeon", 0.81),
    ("tangerine", "orange", 0.81), ("steak", "meat", 0.81),
    ("pan", "pot", 0.81), ("cloud", "sky", 0.81),
    # documented NEAR-MISSES: en_core_web_lg keeps these under 0.8, so
    # the fallback must reject them at the default threshold
    ("rock", "stone", 0.76), ("ship", "vessel", 0.72),
    ("watch", "clock", 0.72), ("desk", "table", 0.77),
    ("cat", "dog", 0.79), ("chair", "stool", 0.77),
    ("person", "people", 0.76), ("bag", "backpack", 0.73),
    ("lamp", "light", 0.74), ("forest", "tree", 0.77),
    ("road", "path", 0.77), ("sheep", "cow", 0.78),
    ("pillow", "cushion", 0.79), ("towel", "napkin", 0.76),
    ("monitor", "screen", 0.79), ("apple", "pear", 0.78),
]

_PAIR_SCORES = {frozenset((a, b)): s for a, b, s in _PAIRS}

_PLURAL_RULES = (
    ("ies", "y"), ("ves", "f"), ("sses", "ss"), ("shes", "sh"),
    ("ches", "ch"), ("xes", "x"), ("oes", "o"), ("es", ""), ("s", ""),
)


def _lemma_candidates(word: str) -> set:
    """The word plus EVERY plural-rule stripping that applies.  Single
    first-match stripping mis-lemmatizes singulars that end in s
    ("glass" -> "glas" while "glasses" -> "glass", so the pair missed):
    comparing candidate SETS lets one side's over-strip meet the other
    side's correct form ("horses" -> {hors, horse} meets {horse})."""
    cands = {word}
    for suffix, repl in _PLURAL_RULES:
        if word.endswith(suffix) and len(word) > len(suffix) + 1:
            cands.add(word[: -len(suffix)] + repl)
    return cands


def bundled_similarity(word1: str, word2: str) -> float:
    """Approximate en_core_web_lg cosine for a pair of AMBER-vocabulary
    words; 0.0 for pairs outside the curated table."""
    w1, w2 = word1.lower(), word2.lower()
    if w1 == w2:
        return 1.0
    if _lemma_candidates(w1) & _lemma_candidates(w2):
        # plural/singular variants ("dogs"/"dog"): vectors score these
        # ~0.85-0.95; well above every sane threshold
        return 0.95
    return _PAIR_SCORES.get(frozenset((w1, w2)), 0.0)
