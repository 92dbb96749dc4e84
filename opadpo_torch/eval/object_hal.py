"""Object-HalBench: CHAIR metrics over COCO objects.

Reference: ``eval_llava_rlhf_coco/eval_gpt_obj_halbench.py`` (751 LoC
``CHAIR`` class, ``:132-565``) + ``summarize_gpt_obj_halbench_review.py``.
Metrics: CHAIRs (fraction of responses with ≥1 hallucinated object),
CHAIRi (fraction of mentioned object instances that are hallucinated),
object recall, and average response length.

Object grounding uses the standard MSCOCO 80-class synonym table from the
original CHAIR evaluation (Rohrbach et al. 2018, public) with the usual
double-word and plural handling.  The reference's GPT-4 object
extraction mode (``:323-408``: prompt → JSON object list → synonym-table
grounding, cached per response) is ``make_gpt_extractor`` /
``--use-gpt-extraction``; any custom extractor plugs in via
``extract_objects_fn``.

A copy of ``opadpo_tpu/eval/object_hal.py``; it imports nothing of that
package.
"""

from __future__ import annotations

import inspect
import json
import re
from typing import Callable, Dict, List, Optional, Sequence, Set

# MSCOCO 80 objects + common synonyms (standard CHAIR table).
COCO_SYNONYMS: Dict[str, Sequence[str]] = {
    "person": ("person", "girl", "boy", "man", "woman", "kid", "child",
               "chef", "baker", "people", "adult", "rider", "children",
               "baby", "worker", "passenger", "sister", "biker", "policeman",
               "cop", "officer", "lady", "cowboy", "bride", "groom", "male",
               "female", "guy", "traveler", "mother", "father", "gentleman",
               "pitcher", "player", "skier", "snowboarder", "skater",
               "skateboarder", "foreigner", "caller", "offender", "coworker",
               "trespasser", "patient", "politician", "soldier", "grandchild",
               "serviceman", "walker", "drinker", "doctor", "lawyer",
               "judge", "fireman", "driver", "commuter"),
    "bicycle": ("bicycle", "bike", "unicycle", "minibike", "trike"),
    "car": ("car", "automobile", "van", "minivan", "sedan", "suv", "hatchback",
            "cab", "jeep", "coupe", "taxicab", "limo", "taxi"),
    "motorcycle": ("motorcycle", "scooter", "moped", "motorbike"),
    "airplane": ("airplane", "jetliner", "plane", "air plane", "monoplane",
                 "aircraft", "jet", "airbus", "biplane", "seaplane"),
    "bus": ("bus", "minibus", "trolley"),
    "train": ("train", "locomotive", "tramway", "caboose"),
    "truck": ("truck", "pickup", "lorry", "hauler", "firetruck"),
    "boat": ("boat", "ship", "liner", "sailboat", "motorboat", "dinghy",
             "powerboat", "speedboat", "canoe", "skiff", "yacht", "kayak",
             "catamaran", "pontoon", "houseboat", "vessel", "rowboat",
             "trawler", "ferryboat", "watercraft", "tugboat", "schooner",
             "barge", "ferry", "sailboard", "paddleboat", "lifeboat",
             "freighter", "steamboat", "riverboat", "battleship", "steamship"),
    "traffic light": ("traffic light", "street light", "traffic signal",
                      "stop light", "streetlight", "stoplight"),
    "fire hydrant": ("fire hydrant", "hydrant"),
    "stop sign": ("stop sign",),
    "parking meter": ("parking meter",),
    "bench": ("bench", "pew"),
    "bird": ("bird", "ostrich", "owl", "seagull", "goose", "duck", "parakeet",
             "falcon", "robin", "pelican", "waterfowl", "heron", "hummingbird",
             "mallard", "finch", "pigeon", "sparrow", "seabird", "osprey",
             "blackbird", "fowl", "shorebird", "woodpecker", "egret",
             "chickadee", "quail", "bluebird", "kingfisher", "buzzard",
             "willet", "gull", "swan", "bluejay", "flamingo", "cormorant",
             "parrot", "loon", "gosling", "waterbird", "pheasant", "rooster",
             "sandpiper", "puffin", "condor", "vulture", "macaw", "peacock",
             "cockatoo", "songbird", "jay", "crow", "raven", "turkey",
             "eagle", "hawk", "chicken", "dove"),
    "cat": ("cat", "kitten", "feline", "tabby"),
    "dog": ("dog", "puppy", "beagle", "pup", "chihuahua", "schnauzer",
            "dachshund", "rottweiler", "canine", "pitbull", "collie",
            "pug", "terrier", "poodle", "labrador", "doggie", "doberman",
            "mutt", "doggy", "spaniel", "bulldog", "sheepdog", "weimaraner",
            "corgi", "cocker", "greyhound", "retriever", "brindle", "hound",
            "whippet", "husky"),
    "horse": ("horse", "colt", "pony", "racehorse", "stallion", "equine",
              "mare", "foal", "palomino", "mustang", "clydesdale", "bronc",
              "bronco"),
    "sheep": ("sheep", "lamb", "ram", "goat", "ewe"),
    "cow": ("cow", "cattle", "oxen", "ox", "calf", "holstein", "heifer",
            "buffalo", "bull", "zebu", "bison"),
    "elephant": ("elephant",),
    "bear": ("bear", "panda"),
    "zebra": ("zebra",),
    "giraffe": ("giraffe",),
    "backpack": ("backpack", "knapsack"),
    "umbrella": ("umbrella",),
    "handbag": ("handbag", "wallet", "purse", "briefcase"),
    "tie": ("tie", "bow tie"),
    "suitcase": ("suitcase", "suit case", "luggage"),
    "frisbee": ("frisbee",),
    "skis": ("skis", "ski"),
    "snowboard": ("snowboard",),
    "sports ball": ("sports ball", "ball"),
    "kite": ("kite",),
    "baseball bat": ("baseball bat",),
    "baseball glove": ("baseball glove",),
    "skateboard": ("skateboard",),
    "surfboard": ("surfboard", "longboard", "skimboard", "shortboard",
                  "wakeboard"),
    "tennis racket": ("tennis racket", "racket"),
    "bottle": ("bottle",),
    "wine glass": ("wine glass",),
    "cup": ("cup",),
    "fork": ("fork",),
    "knife": ("knife", "pocketknife", "knive"),
    "spoon": ("spoon",),
    "bowl": ("bowl", "container"),
    "banana": ("banana",),
    "apple": ("apple",),
    "sandwich": ("sandwich", "burger", "sub", "cheeseburger", "hamburger"),
    "orange": ("orange",),
    "broccoli": ("broccoli",),
    "carrot": ("carrot",),
    "hot dog": ("hot dog",),
    "pizza": ("pizza",),
    "donut": ("donut", "doughnut", "bagel"),
    "cake": ("cake", "cheesecake", "cupcake", "shortcake", "coffeecake",
             "pancake"),
    "chair": ("chair", "seat", "stool"),
    "couch": ("couch", "sofa", "recliner", "futon", "loveseat", "settee",
              "chesterfield"),
    "potted plant": ("potted plant", "houseplant"),
    "bed": ("bed",),
    "dining table": ("dining table", "table", "desk"),
    "toilet": ("toilet", "urinal", "commode", "lavatory", "potty"),
    "tv": ("tv", "television", "monitor", "televison"),
    "laptop": ("laptop",),
    "mouse": ("mouse",),
    "remote": ("remote",),
    "keyboard": ("keyboard",),
    "cell phone": ("cell phone", "mobile phone", "phone", "cellphone",
                   "telephone", "phon", "smartphone", "iphone"),
    "microwave": ("microwave",),
    "oven": ("oven", "stovetop", "stove", "stove top oven"),
    "toaster": ("toaster",),
    "sink": ("sink",),
    "refrigerator": ("refrigerator", "fridge", "freezer"),
    "book": ("book",),
    "clock": ("clock",),
    "vase": ("vase",),
    "scissors": ("scissors",),
    "teddy bear": ("teddy bear", "teddybear"),
    "hair drier": ("hair drier", "hairdryer"),
    "toothbrush": ("toothbrush",),
}

# tokens: word runs OR punctuation runs — punctuation must stay a token
# so double-word adjacency does not jump across it ("a dog, stop sign"),
# matching the reference's nltk.word_tokenize stream (:222)
_TOKEN_RE = re.compile(r"[a-z]+|[^\sa-z]+")

_ANIMAL_WORDS = ("bird", "cat", "dog", "horse", "sheep", "cow", "elephant",
                 "bear", "zebra", "giraffe", "animal", "cub")
_VEHICLE_WORDS = ("jet", "train")


class SynonymTables:
    """Lookup structures for one synonym vocabulary (reference CHAIR
    constructor, ``eval_gpt_obj_halbench.py:150-178``): synonym →
    canonical object, plus the double-word map with the standard special
    cases (baby/adult animals, passenger vehicles, bow tie → tie,
    toilet seat → toilet, wine glas → wine glass)."""

    def __init__(self, synonyms: Dict[str, Sequence[str]]):
        self.lookup: Dict[str, str] = {}
        for obj, syns in synonyms.items():
            for s in syns:
                self.lookup[s] = obj
        double_words = [s for s in self.lookup if len(s.split(" ")) >= 2]
        double_words += ["home plate", "train track"]
        self.double_word_dict: Dict[str, str] = {
            dw: dw for dw in double_words}
        for a in _ANIMAL_WORDS:
            self.double_word_dict[f"baby {a}"] = a
            self.double_word_dict[f"adult {a}"] = a
        for v in _VEHICLE_WORDS:
            self.double_word_dict[f"passenger {v}"] = v
        self.double_word_dict["bow tie"] = "tie"
        self.double_word_dict["toilet seat"] = "toilet"
        self.double_word_dict["wine glas"] = "wine glass"
        # words occurring inside multi-word synonyms: the singularizer
        # accepts candidates from this set too ("wine glasses" must
        # lemmatize to "glass" before the pair scan can see "wine glass")
        self._phrase_words = {w for dw in double_words
                              for w in dw.split(" ")}

    def singularize(self, word: str) -> str:
        for suffix, repl in (("ies", "y"), ("ves", "f"), ("sses", "ss"),
                             ("es", "e"), ("s", "")):
            if word.endswith(suffix) and len(word) > len(suffix) + 1:
                cand = word[: -len(suffix)] + repl
                if cand in self.lookup or cand in self._phrase_words:
                    return cand
        return word


def load_synonym_file(path: str) -> Dict[str, Sequence[str]]:
    """Parse a CHAIR synonyms file (one comma-separated group per line,
    first entry canonical — the ``synonyms_refine.txt`` format)."""
    out: Dict[str, Sequence[str]] = {}
    with open(path) as f:
        for line in f:
            group = [s.strip() for s in line.strip().split(", ") if s.strip()]
            if group:
                out[group[0]] = tuple(group)
    return out


_DEFAULT_TABLES = SynonymTables(COCO_SYNONYMS)


def extract_coco_objects(text: str,
                         tables: Optional[SynonymTables] = None) -> List[str]:
    """Canonical COCO object names mentioned in free text (reference
    ``caption_to_words``, ``:215-253``: tokenize → lemmatize →
    double-word scan → toilet-seat rule → synonym lookup)."""
    t = tables or _DEFAULT_TABLES
    words = [t.singularize(w) for w in _TOKEN_RE.findall(text.lower())]
    merged: List[str] = []
    i = 0
    while i < len(words):
        pair = " ".join(words[i:i + 2])
        if pair in t.double_word_dict:
            merged.append(t.double_word_dict[pair])
            i += 2
        else:
            merged.append(words[i])
            i += 1
    # "the seat of the toilet" must not fire for "chair" (reference :243)
    if "toilet" in merged and "seat" in merged:
        merged = [w for w in merged if w != "seat"]
    return [t.lookup[w] for w in merged if w in t.lookup]


# GPT-4 object-extraction prompt: re-worded from the reference template
# (eval_gpt_obj_halbench.py:54-79) with the SCHEMA preserved — question +
# answer in delimited blocks, output a JSON string list of bare object
# names (no attributes), empty list when nothing is visible.
EXTRACTION_PROMPT = """You specialize in pulling out the physical objects \
referenced in a visual question-answering exchange. A respondent was shown \
a picture and produced the answer below.

[Start of Question]

<image> {question}

[End of Question]

[Start of Respondent's Answer]

{answer}

[End of Respondent's Answer]


Treat the answer as accurate and list every visible object it says appears \
in the picture, under these rules:

1. Only list objects the respondent's answer explicitly names.
2. Give bare object names, leaving out any attributes.
3. Drop qualities such as color or material from each name.
4. Be exact. Reply with a JSON list of strings: ["object_1", ..., "object_n"].
5. Reply with an empty JSON list [] when the answer names no visible objects.
"""


def parse_object_list(content: str) -> List[str]:
    """Parse the model's JSON-list reply, tolerating code fences and
    leading prose (reference ``parse_object_list``, ``:40-52``)."""
    content = content.replace("```json", "").replace("```", "")
    flat = content.replace("\n", "")
    try:
        out = json.loads(flat)
    except json.JSONDecodeError:
        if '["' not in content:
            raise ValueError("extraction reply is not a JSON list")
        try:
            out = json.loads(content.strip().split("\n")[-1])
        except json.JSONDecodeError:
            raise ValueError("extraction reply is not a JSON list")
    if not isinstance(out, list):
        raise ValueError("extraction reply is not a JSON list")
    return [str(x) for x in out]


def make_gpt_extractor(service, fail_limit: int = 100,
                       short_answer_words: int = 3,
                       tables: Optional["SynonymTables"] = None) -> Callable:
    """GPT-4 object extraction (reference ``get_gpt_resp``, ``:322-380``):
    short answers yield no objects; otherwise ask the API for a JSON
    object list and ground each phrase through the COCO synonym table
    (reference ``get_pred_objs_match`` + ``caption_objects_to_coco_objects``
    — only phrases that map to a COCO class count, deduplicated).

    Responses are cached in the service's sqlite store (same prompt →
    same cache key), so interrupted runs resume without re-spending API
    calls.  Persistent API/parse failure raises — the reference asserts
    on its ``<no_response>`` marker at the same point (``:430``)."""
    def extract(text: str, record: Optional[Dict] = None) -> List[str]:
        if len(text.strip().split()) <= short_answer_words:
            return []
        question = ""
        if record:
            question = record.get("question", record.get("prompt", ""))
        prompt = EXTRACTION_PROMPT.replace("{question}", question)
        prompt = prompt.replace("{answer}", text)
        messages = [{"role": "system", "content": prompt}]
        last_err = None
        use_cache = True
        for attempt in range(fail_limit):
            try:
                # the sqlite cache stores ANY 200 reply before it is
                # parsed — a cached malformed reply would replay
                # identically forever, so retries after a PARSE failure
                # must bypass the cache (a fresh success re-caches).
                # Transient API errors (RuntimeError) keep the cache on:
                # the cache was never the problem there, and bypassing it
                # re-spends API calls on every network blip.
                content = service.call_llm_with_messages(
                    messages, temperature=0.0, use_cache=use_cache)
                phrases = parse_object_list(content)
                break
            except ValueError as e:      # malformed reply — don't replay it
                last_err = e
                use_cache = False
            except RuntimeError as e:    # transient API failure
                last_err = e
        else:
            raise RuntimeError(
                f"object extraction failed after {fail_limit} tries: "
                f"{last_err}")
        objs: List[str] = []
        for phrase in phrases:
            for obj in extract_coco_objects(str(phrase), tables):
                if obj not in objs:
                    objs.append(obj)
        return objs
    return extract


def evaluate_chair(
    responses: List[Dict],            # {'question_id'|'image_id', 'text'}
    gt_objects: Dict,                 # image_id → list of GT coco objects
    extract_objects_fn: Optional[Callable[[str], List[str]]] = None,
    tables: Optional[SynonymTables] = None,
) -> Dict[str, float]:
    if extract_objects_fn is None:
        extract = lambda text: extract_coco_objects(text, tables)  # noqa: E731
    else:
        extract = extract_objects_fn
    # richer extractors (the GPT one) take the full record for the
    # question context, marked by a parameter literally named "record" —
    # arity alone would misroute (text, tables)-style extractors by
    # binding the record dict to their second positional parameter
    wants_record = (extract_objects_fn is not None and
                    "record" in inspect.signature(extract).parameters)
    n_resp = 0
    n_resp_hallu = 0
    n_inst = 0
    n_inst_hallu = 0
    n_gt_total = 0
    n_gt_covered = 0
    total_words = 0

    for rec in responses:
        img_id = rec.get("image_id", rec.get("question_id"))
        gts: Set[str] = {g.lower() for g in gt_objects.get(img_id, [])}
        mentioned = (extract(rec["text"], rec) if wants_record
                     else extract(rec["text"]))
        total_words += len(rec["text"].split())
        n_resp += 1
        hallu = [m for m in mentioned if m not in gts]
        n_inst += len(mentioned)
        n_inst_hallu += len(hallu)
        if hallu:
            n_resp_hallu += 1
        n_gt_total += len(gts)
        n_gt_covered += len(gts & set(mentioned))

    return {
        "CHAIRs": round(n_resp_hallu / max(n_resp, 1) * 100, 1),
        "CHAIRi": round(n_inst_hallu / max(n_inst, 1) * 100, 1),
        "object_recall": round(n_gt_covered / max(n_gt_total, 1) * 100, 1),
        "avg_length": round(total_words / max(n_resp, 1), 1),
        "num_responses": n_resp,
    }


def main():
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--answers-file", required=True)
    p.add_argument("--gt-objects", required=True,
                   help="json: image_id → [coco object names]")
    p.add_argument("--use-gpt-extraction", action="store_true",
                   help="extract mentioned objects with the GPT-4 API "
                        "(reference eval_gpt_obj_halbench.py gpt_process "
                        "mode) instead of the regex+synonym matcher; "
                        "needs API_KEY/AZURE_POINT env vars")
    p.add_argument("--extraction-cache", default="obj_hal_extract.sqlite",
                   help="sqlite cache for GPT extraction replies "
                        "(makes interrupted runs resumable)")
    p.add_argument("--synonyms-file", default=None,
                   help="CHAIR synonyms table (synonyms_refine.txt "
                        "format); defaults to the built-in MSCOCO-80 "
                        "table")
    args = p.parse_args()
    responses = [json.loads(l) for l in open(args.answers_file)]
    gts = json.load(open(args.gt_objects))
    # json keys are strings; normalize
    gts = {type(responses[0].get("image_id",
                                 responses[0].get("question_id")))(k)
           if k.isdigit() else k: v for k, v in gts.items()}
    tables = (SynonymTables(load_synonym_file(args.synonyms_file))
              if args.synonyms_file else None)
    extractor = None
    if args.use_gpt_extraction:
        from opadpo_torch.pipeline.gpt4v_client import get_api_service
        extractor = make_gpt_extractor(
            get_api_service(cache_path=args.extraction_cache),
            tables=tables)
    print(json.dumps(evaluate_chair(responses, gts,
                                    extract_objects_fn=extractor,
                                    tables=tables),
                     indent=2))


if __name__ == "__main__":
    main()
