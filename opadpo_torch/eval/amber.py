"""AMBER benchmark scorer (generative CHAIR/Cover/Hal/Cog +
discriminative acc/P/R/F1 + repeat ratio).

Behavioral port of ``eval_llava_rlhf_coco/AMBER_eval.py:58-366`` against
the same data files (``relation.json`` word associations,
``safe_words.txt``, ``annotations.json``, ``metrics.txt`` counters).

Environment notes (degradations are opt-in, never silent):
- noun extraction uses nltk's POS tagger when its data packs are
  installed; otherwise a self-contained tokenizer + plural lemmatizer
  filtered against the association vocabulary (extracted nouns are
  intersected with that vocabulary immediately afterwards in the
  reference too, so only non-noun vocabulary words can differ);
- the spaCy embedding-similarity synonym check (reference
  ``check_synonyms_word``) uses en_core_web_lg when installed; otherwise
  a bundled curated similarity table over the closed AMBER vocabulary
  stands in behind the same 0.8-threshold interface
  (``amber_similarity.bundled_similarity`` — see that module's docstring
  for the approximation contract).

A copy of ``opadpo_tpu/eval/amber.py``; it imports nothing of that
package.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

_WORD_RE = re.compile(r"[A-Za-z]+")

_PLURAL_RULES = (
    ("ies", "y"), ("ves", "f"), ("sses", "ss"), ("shes", "sh"),
    ("ches", "ch"), ("xes", "x"), ("oes", "o"), ("s", ""),
)


def _naive_lemma(word: str) -> str:
    for suffix, repl in _PLURAL_RULES:
        if word.endswith(suffix) and len(word) > len(suffix) + 1:
            return word[: -len(suffix)] + repl
    return word


def _extract_nouns_nltk(text: str) -> Optional[List[str]]:
    try:
        import nltk
        from nltk.stem import WordNetLemmatizer
        lemmatizer = WordNetLemmatizer()
        tokens = nltk.word_tokenize(text)
        tagged = nltk.pos_tag(tokens)
        return [lemmatizer.lemmatize(w) for w, pos in tagged
                if pos.startswith("NN")]
    except LookupError:
        return None
    except ImportError:
        return None


def extract_nouns(text: str, vocabulary: Optional[set] = None) -> List[str]:
    nouns = _extract_nouns_nltk(text)
    if nouns is not None:
        return nouns
    words = [w.lower() for w in _WORD_RE.findall(text)]
    out = []
    for w in words:
        lemma = _naive_lemma(w)
        if vocabulary is None or lemma in vocabulary or w in vocabulary:
            out.append(lemma if (vocabulary is None or lemma in vocabulary)
                       else w)
    return out


_SPACY_NLP = None


def similarity_backend() -> str:
    """Which synonym backend this environment resolves to — recorded in
    the metrics dict so AMBER artifacts are self-describing (scores from
    the bundled table are not comparable to real spaCy vectors)."""
    _load_spacy()
    return "spacy:en_core_web_lg" if _SPACY_NLP else "bundled-table"


def _load_spacy():
    global _SPACY_NLP
    if _SPACY_NLP is None:
        try:
            import spacy
            _SPACY_NLP = spacy.load("en_core_web_lg")
        except Exception:
            _SPACY_NLP = False


def check_synonyms_word(word1: str, word2: str,
                        similarity_score: float = 0.8) -> bool:
    """Reference ``AMBER_eval.py:28-32`` — spaCy vector similarity with
    a strict > threshold; the bundled table is the offline stand-in."""
    _load_spacy()
    if not _SPACY_NLP:
        from opadpo_torch.eval.amber_similarity import bundled_similarity
        return bundled_similarity(word1, word2) > similarity_score
    return _SPACY_NLP(word1).similarity(_SPACY_NLP(word2)) > similarity_score


_METRIC_KEYS = [
    "chair_score", "chair_num", "safe_cover_score", "safe_cover_num",
    "hallu_cover_score", "hallu_cover_num", "non_hallu_score",
    "non_hallu_num",
]
_QA_GROUPS = ("", "as_", "an_", "aa_", "ha_", "asso_")
for _g in _QA_GROUPS:
    _METRIC_KEYS += [f"{_g}qa_correct_score", f"{_g}qa_correct_num",
                     f"{_g}qa_no_score", f"{_g}qa_no_num",
                     f"{_g}qa_ans_no_score", f"{_g}qa_ans_no_num"]

_TYPE_TO_GROUP = {
    "discriminative-attribute-state": "as_",
    "discriminative-attribute-number": "an_",
    "discriminative-attribute-action": "aa_",
    "discriminative-hallucination": "ha_",
}


def evaluate_amber(
    inference_data: List[Dict],
    annotations: List[Dict],
    association: Dict[str, List[str]],
    safe_words: List[str],
    similarity_score: float = 0.8,
) -> Dict[str, float]:
    metrics = {k: 0 for k in _METRIC_KEYS}
    hallucination_words = set()
    for w1, syns in association.items():
        hallucination_words.add(w1)
        hallucination_words.update(syns)
    global_safe = set(safe_words)

    for row in inference_data:
        idx = row["id"]
        truth_rec = annotations[idx - 1]

        if truth_rec["type"] == "generative":
            nouns = [n for n in extract_nouns(row["response"],
                                              hallucination_words)
                     if n in hallucination_words]

            safe_syn, safe_idx = [], []
            for j, word in enumerate(truth_rec["truth"]):
                safe_syn += association[word]
                safe_idx += [j] * len(association[word])
            ha_syn, ha_idx = [], []
            for j, word in enumerate(truth_rec["hallu"]):
                ha_syn += association[word]
                ha_idx += [j] * len(association[word])

            safe_words_all = safe_syn + truth_rec["truth"]
            safe_len = len(truth_rec["truth"])
            safe_list = safe_idx + [0] * safe_len
            ha_words_all = ha_syn + truth_rec["hallu"]
            ha_len = len(truth_rec["hallu"])
            ha_list = ha_idx + [0] * ha_len
            flagged = [0] * len(nouns)

            for i, noun in enumerate(nouns):
                if noun in global_safe:
                    continue
                if noun in safe_words_all:
                    j = safe_words_all.index(noun)
                    if j < len(safe_list) - safe_len:
                        safe_list[safe_list[j] + len(safe_list) - safe_len] = 1
                    else:
                        safe_list[j] = 1
                    continue
                if noun in ha_words_all:
                    j = ha_words_all.index(noun)
                    if j < len(ha_list) - ha_len:
                        ha_list[ha_list[j] + len(ha_list) - ha_len] = 1
                    else:
                        ha_list[j] = 1
                for j, check in enumerate(ha_words_all):
                    if check_synonyms_word(noun, check, similarity_score):
                        if j < len(ha_list) - ha_len:
                            ha_list[ha_list[j] + len(ha_list) - ha_len] = 1
                        else:
                            ha_list[j] = 1
                        break
                matched_safe = False
                for j, check in enumerate(safe_words_all):
                    if check_synonyms_word(noun, check, similarity_score):
                        matched_safe = True
                        if j < len(safe_list) - safe_len:
                            safe_list[safe_list[j] + len(safe_list) - safe_len] = 1
                        else:
                            safe_list[j] = 1
                        break
                if matched_safe:
                    continue
                flagged[i] = 1

            metrics["chair_score"] += sum(flagged)
            metrics["chair_num"] += len(flagged)
            metrics["safe_cover_score"] += sum(safe_list[-safe_len:])
            metrics["safe_cover_num"] += safe_len
            metrics["hallu_cover_score"] += sum(ha_list[-ha_len:])
            metrics["hallu_cover_num"] += ha_len
            if sum(flagged) == 0:
                metrics["non_hallu_score"] += 1
            metrics["non_hallu_num"] += 1
        else:
            group = _TYPE_TO_GROUP.get(truth_rec["type"], "asso_")
            truth = truth_rec["truth"]
            response = row["response"]
            for g in ("", group):
                metrics[f"{g}qa_correct_num"] += 1
            if truth == "yes":
                if response == "Yes":
                    for g in ("", group):
                        metrics[f"{g}qa_correct_score"] += 1
            else:
                for g in ("", group):
                    metrics[f"{g}qa_no_num"] += 1
                if response == "No":
                    for g in ("", group):
                        metrics[f"{g}qa_correct_score"] += 1
                        metrics[f"{g}qa_no_score"] += 1
            if response == "No":
                for g in ("", group):
                    metrics[f"{g}qa_ans_no_num"] += 1
                if truth == "no":
                    for g in ("", group):
                        metrics[f"{g}qa_ans_no_score"] += 1

    out: Dict[str, float] = {}

    def ratio(a, b):
        return round(a / b * 100, 1) if b else 0.0

    if metrics["chair_num"]:
        out["CHAIR"] = ratio(metrics["chair_score"], metrics["chair_num"])
        out["Cover"] = ratio(metrics["safe_cover_score"],
                             metrics["safe_cover_num"])
        out["Hal"] = round(100 - metrics["non_hallu_score"]
                           / metrics["non_hallu_num"] * 100, 1)
        out["Cog"] = ratio(metrics["hallu_cover_score"],
                           metrics["hallu_cover_num"])
    if metrics["qa_correct_num"]:
        acc = ratio(metrics["qa_correct_score"], metrics["qa_correct_num"])
        prec = ratio(metrics["qa_ans_no_score"], metrics["qa_ans_no_num"])
        rec = ratio(metrics["qa_no_score"], metrics["qa_no_num"])
        f1 = round(2 * (prec / 100) * (rec / 100)
                   / ((prec / 100) + (rec / 100) + 1e-4) * 100, 1)
        out.update({"d_Accuracy": acc, "d_Precision": prec,
                    "d_Recall": rec, "d_F1": f1})

    repeats = sum(1 for r in inference_data if len(r["response"]) >= 800)
    out["repeat_ratio"] = round(repeats / max(len(inference_data), 1) * 100, 2)
    out["similarity_backend"] = similarity_backend()
    return out


def main():
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--inference_data", required=True)
    p.add_argument("--word_association", required=True)
    p.add_argument("--safe_words", required=True)
    p.add_argument("--annotation", required=True)
    p.add_argument("--similarity_score", type=float, default=0.8)
    args = p.parse_args()

    inference = [json.loads(l) for l in open(args.inference_data)]
    association = json.load(open(args.word_association, encoding="utf-8"))
    safe = [l.rstrip("\n") for l in open(args.safe_words, encoding="utf-8")]
    annotations = json.load(open(args.annotation, encoding="utf-8"))
    out = evaluate_amber(inference, annotations, association, safe,
                         args.similarity_score)
    print("AMBER Bench")
    for k, v in out.items():
        print(f"{k}:\t{v}")


if __name__ == "__main__":
    main()
