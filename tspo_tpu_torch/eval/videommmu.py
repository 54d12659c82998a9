"""VideoMMMU — college-level multi-discipline video QA (perception /
comprehension / adaptation tracks).

Reference: lmms-eval/lmms_eval/tasks/videommmu/utils.py —
  - prompts: perception/comprehension append the ignore-quiz-frame post
    prompt; adaptation composes pre + mcq/open-ended instruction
    (:90-129 + _default_template_yaml kwargs); ``parse_options`` appends
    letters only when the options don't already carry them (:132-142);
  - the multi-choice parser is MMMU's SIXTH flavor in this repo: the
    period-suffixed and colon-suffixed passes BOTH accumulate first, then
    bracketed, then space-bounded, then content; no-candidate yields the
    sentinel "No Answer Found." and ties take the LAST occurrence
    (:337-420);
  - open-ended answers are parsed into candidate strings/numbers (key
    sub-response indicators, number extraction incl. commas/scientific,
    normalization to rounded floats, deduped) and matched against the
    normalized gold (:423-565);
  - aggregation: per-subdomain accuracy (subdomain parsed out of the doc
    id) rolled up into MMMU's domain taxonomy and an instance-level
    overall (:176-246).
"""

from __future__ import annotations

import re

import numpy as np

from .tasks import TASK_REGISTRY, BenchmarkTask

VIDEOMMMU_KWARGS = {
    "pre_prompt": "You should watch and learn the video content. Then apply "
                  "what you learned to ",
    "perception_and_comprehension_prompt": "\nPlease ignore the Quiz "
                                           "question in last frame of the "
                                           "video.",
    "mcq_prompt": "answer the following multi-choice question. The image "
                  "for this question is at the end of the video.\n",
    "open_ended_prompt": "answer the following open-ended question. The "
                         "image for this question is at the end of the "
                         "video.\n",
}

DOMAIN_CAT2SUB_CAT = {
    "Art and Design": ["Art", "Art_Theory", "Design", "Music"],
    "Business": ["Accounting", "Economics", "Finance", "Manage", "Marketing"],
    "Science": ["Biology", "Chemistry", "Geography", "Math", "Physics"],
    "Health and Medicine": ["Basic_Medical_Science", "Clinical_Medicine",
                            "Diagnostics_and_Laboratory_Medicine", "Pharmacy",
                            "Public_Health"],
    "Humanities and Social Science": ["History", "Literature", "Sociology",
                                      "Psychology"],
    "Tech and Engineering": ["Agriculture", "Architecture_and_Engineering",
                             "Computer_Science", "Electronics",
                             "Energy_and_Power", "Materials",
                             "Mechanical_Engineering"],
}


def parse_options(options: list) -> str:
    """utils.py:132-142."""
    letters = [chr(ord("A") + i) for i in range(len(options))]
    if all(o.startswith(f"{c}.") for o, c in zip(options, letters)):
        return "\n".join(options)
    return "\n".join(f"{c}. {o}" for c, o in zip(letters, options))


def doc_to_text_perception_comprehension(doc,
                                         lmms_eval_specific_kwargs=None) -> str:
    kw = {**VIDEOMMMU_KWARGS, **(lmms_eval_specific_kwargs or {})}
    q = doc["question"] + "\n" + parse_options(doc["options"])
    return f"{q}{kw['perception_and_comprehension_prompt']}"


def doc_to_text_adaptation(doc, lmms_eval_specific_kwargs=None) -> str:
    kw = {**VIDEOMMMU_KWARGS, **(lmms_eval_specific_kwargs or {})}
    pre = kw["pre_prompt"]
    q = doc["question"]
    if doc["question_type"] == "multiple-choice":
        pre += kw["mcq_prompt"]
        q += "\n" + parse_options(doc["options"])
    else:
        pre += kw["open_ended_prompt"]
    return f"{pre}{q}"


def get_multi_choice_info(options: list):
    index2ans = {chr(ord("A") + i): o for i, o in enumerate(options)}
    return index2ans, list(index2ans)


def parse_multi_choice_response(response: str, all_choices: list,
                                index2ans: dict):
    """utils.py:337-420 — MMMU flavor with period+colon passes accumulating
    first and a "No Answer Found." sentinel."""
    if response == "API Error" or response == "":
        return "API Error"
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = " " + response + " "
    index_ans = True
    ans_with_brack = ans_with_period = ans_with_colon = False
    candidates = []
    for c in all_choices:
        if f"{c}." in response:
            candidates.append(c)
            ans_with_period = True
    for c in all_choices:
        if f"{c}:" in response:
            candidates.append(c)
            ans_with_colon = True
    if not candidates:
        for c in all_choices:
            if f"({c})" in response:
                candidates.append(c)
                ans_with_brack = True
    if not candidates:
        for c in all_choices:
            if f"{c} " in response:
                candidates.append(c)
    if not candidates and len(response.split()) > 5:
        for idx, ans in index2ans.items():
            if ans.lower() in response.lower():
                candidates.append(idx)
                index_ans = False
    if not candidates:
        return "No Answer Found."
    if len(candidates) == 1:
        return candidates[0]
    if index_ans:
        probe = (lambda c: f"{c}.") if ans_with_period else \
            (lambda c: f"{c}:") if ans_with_colon else \
            (lambda c: f"({c})") if ans_with_brack else (lambda c: f" {c} ")
        positions = [response.rfind(probe(c)) for c in candidates]
    else:
        positions = [response.lower().rfind(index2ans[c].lower())
                     for c in candidates]
    return candidates[int(np.argmax(positions))]


def extract_numbers(string: str) -> list:
    """utils.py:424-441: comma-grouped, scientific, and plain numbers."""
    pattern_commas = r"-?\b\d{1,3}(?:,\d{3})+\b"
    pattern_scientific = r"-?\d+(?:\.\d+)?[eE][+-]?\d+"
    pattern_simple = r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])"
    return (re.findall(pattern_commas, string)
            + re.findall(pattern_scientific, string)
            + re.findall(pattern_simple, string))


def check_is_number(string: str) -> bool:
    try:
        float(string.replace(",", ""))
        return True
    except ValueError:
        return False


def normalize_str(string: str) -> list:
    """utils.py:453-471: numbers -> rounded floats; 1-char strings get
    space-padded variants to avoid trivial substring matches."""
    string = string.strip()
    if check_is_number(string):
        return [round(float(string.replace(",", "")), 2)]
    string = string.lower()
    if len(string) == 1:
        return [" " + string, string + " "]
    return [string]


_KEY_INDICATORS = [
    "could be ", "so ", "is ", "thus ", "therefore ", "final ", "answer ",
    "result ", "are ", "in total ", "total ", "identify ", "recognize ",
    "calculated as ", "counted as ", "measured as ", "observed as ",
    "concluded as ", "found to be ", "equals ", "determined to be ",
    "number of ", "value is ", "adds up to ", "have ", "has ",
]


def parse_open_response(response: str):
    """utils.py:478-565."""
    if response == "API Error" or response == "":
        return "API Error"

    def get_key_subresponses(response):
        response = response.strip().strip(".").lower()
        sub_responses = re.split(r"\.\s(?=[A-Z])|\n", response)
        indicators = list(_KEY_INDICATORS)
        key_responses = []
        for index, resp in enumerate(sub_responses):
            if index == len(sub_responses) - 1:
                indicators.extend(["="])
            shortest = None
            for ind in indicators:
                if ind in resp:
                    tail = resp.split(ind)[-1].strip()
                    # reference truthiness quirk (utils.py:526-531): an
                    # EMPTY current shortest is overwritten, not kept
                    if not shortest:
                        shortest = tail
                    elif len(tail) < len(shortest):
                        shortest = tail
            if shortest and shortest.strip() not in [":", ",", ".", "!", "?",
                                                     ";", ":", "'"]:
                key_responses.append(shortest)
        return key_responses or [response]

    key_responses = get_key_subresponses(response)
    pred_list = list(key_responses)
    for resp in key_responses:
        pred_list.extend(extract_numbers(resp))
    out = []
    for p in pred_list:
        out.extend(normalize_str(p))
    return list(set(out))


def eval_multi_choice(gold, pred) -> bool:
    golds = gold if isinstance(gold, list) else [gold]
    return any(g == pred for g in golds)


def eval_open(gold, pred_list) -> bool:
    """utils.py:287-309."""
    norm_answers = []
    for g in (gold if isinstance(gold, list) else [gold]):
        norm_answers.extend(normalize_str(g))
    for pred in pred_list:
        if isinstance(pred, str):
            if any(isinstance(na, str) and na in pred
                   for na in norm_answers):
                return True
        elif pred in norm_answers:
            return True
    return False


def extract_subset_name(doc_id: str) -> str:
    """utils.py:165-173: "<split>_<Subdomain>_<n>" -> Subdomain."""
    split = doc_id.split("_")[0]
    m = re.compile(rf"^{split}_(.+?)_\d+$").search(doc_id)
    if not m:
        raise ValueError(f'No match found in "{doc_id}"')
    return m.group(1)


def _process(doc, response, rng=None) -> dict:
    qt = doc.get("question_type", "None")
    if qt == "multiple-choice":
        index2ans, all_choices = get_multi_choice_info(doc["options"])
        parsed = parse_multi_choice_response(response, all_choices, index2ans)
    else:
        parsed = parse_open_response(response)
    return {"id": doc["id"], "subdomain": extract_subset_name(doc["id"]),
            "question_type": qt, "answer": doc["answer"],
            "pred_answer": parsed}


def aggregate_videommmu(results: list) -> dict:
    valid = [r for r in results if r["pred_answer"] != "API Error"]
    by_sub: dict = {}
    for r in valid:
        by_sub.setdefault(r["subdomain"], []).append(r)

    def correct(r) -> bool:
        if r["question_type"] in ("multiple-choice", "perception"):
            return eval_multi_choice(r["answer"], r["pred_answer"])
        return eval_open(r["answer"], r["pred_answer"])

    sub_stats = {s: (sum(correct(r) for r in rows), len(rows))
                 for s, rows in by_sub.items()}
    out = {}
    for domain, cats in DOMAIN_CAT2SUB_CAT.items():
        c = sum(sub_stats[s][0] for s in cats if s in sub_stats)
        n = sum(sub_stats[s][1] for s in cats if s in sub_stats)
        if n:
            out[f"Overall-{domain}"] = round(c / n, 5)
    for s, (c, n) in sorted(sub_stats.items()):
        out[s] = round(c / n, 5) if n else 0.0
    tc = sum(c for c, _ in sub_stats.values())
    tn = sum(n for _, n in sub_stats.values())
    out["overall"] = round(tc / tn, 5) if tn else 0.0
    return out


def register_videommmu() -> None:
    for track, d2t in (("perception", doc_to_text_perception_comprehension),
                       ("comprehension", doc_to_text_perception_comprehension),
                       ("adaptation", doc_to_text_adaptation)):
        TASK_REGISTRY[f"VideoMMMU-{track}"] = BenchmarkTask(
            name=f"VideoMMMU-{track}", doc_to_text=d2t,
            process_response=_process, aggregate=aggregate_videommmu,
            video_path_keys=("id", "video_path"), video_suffix=".mp4")


register_videommmu()
