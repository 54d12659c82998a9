"""Pure-Python caption metrics: coco-style BLEU-4 and ROUGE-L.

The reference FunQA task scores BLEU-4 and ROUGE-L through pycocoevalcap
(funqa/utils.py:132-165), whose scorers wrap the original coco-caption code
and whose PTBTokenizer shells out to the Stanford CoreNLP **Java** jar.
Neither pycocoevalcap nor a JVM ships in this environment, so this module
reimplements the two scoring algorithms exactly as coco-caption defines them:

  - BLEU: bleu_scorer.py's per-n cumulative geometric precision with the
    tiny/small epsilons (tiny=1e-15, small=1e-9) and the exp(1 - 1/ratio)
    brevity penalty for ratio < 1 ("closest" reflen — identity for the
    single-reference pairs FunQA scores);
  - ROUGE-L: rouge.py's LCS F-score with beta=1.2.

The tokenizer is the one deliberate approximation: ``ptb_tokenize`` applies
the same normalization PTBTokenizer is configured with
(``-preserveLines -lowerCase`` + dropping the PUNCTUATIONS list) using a
regex splitter instead of the CoreNLP finite-state tokenizer.  For the plain
English captions these tasks compare, outputs match on everything but exotic
constructions (unicode quotes, abbreviations with internal periods).
"""

from __future__ import annotations

import math
import re
from collections import Counter

# pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS
PUNCTUATIONS = ["''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"]

_TOKEN_RE = re.compile(r"[^\s]+")
_SPLIT_PUNCT_RE = re.compile(r"([.,!?;:]+)|(\.\.\.)|(--)")


def ptb_tokenize(text: str) -> list:
    """Lowercase, split words from trailing/leading punctuation, drop
    punctuation tokens (PTBTokenizer approximation, see module doc)."""
    text = text.lower().strip()
    # separate punctuation runs from words so they become droppable tokens
    text = re.sub(r"([a-z0-9])([.,!?;:]+)(\s|$)", r"\1 \2 ", text)
    text = re.sub(r"(\s|^)([.,!?;:]+)([a-z0-9])", r" \2 \3", text)
    toks = _TOKEN_RE.findall(text)
    return [t for t in toks if t not in PUNCTUATIONS]


def _ngram_counts(tokens: list, n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def bleu4(reference: str, hypothesis: str, n: int = 4,
          tokenizer=ptb_tokenize) -> float:
    """Single-pair BLEU-n, coco bleu_scorer.py semantics (compute_score with
    option="closest" degenerates to the single reference's length).  Thin
    wrapper over :func:`corpus_bleu` with a one-pair corpus."""
    return corpus_bleu([([reference], hypothesis)], n=n,
                       tokenizer=tokenizer)[n - 1]


def _lcs_len(a: list, b: list) -> int:
    """Classic O(len(a)*len(b)) LCS table (rouge.py::my_lcs)."""
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(reference: str, hypothesis: str, beta: float = 1.2,
            tokenizer=ptb_tokenize) -> float:
    """ROUGE-L F-beta (coco rouge.py::calc_score, beta=1.2)."""
    ref, hyp = tokenizer(reference), tokenizer(hypothesis)
    if not ref or not hyp:
        return 0.0
    lcs = _lcs_len(hyp, ref)
    prec = lcs / len(hyp)
    rec = lcs / len(ref)
    if prec == 0 or rec == 0:
        return 0.0
    return ((1 + beta ** 2) * prec * rec) / (rec + beta ** 2 * prec)


# ---------------------------------------------------------------------------
# Corpus-level scorers (YouCook2: per-video corpus BLEU_1..4 / ROUGE-L /
# CIDEr through pycocoevalcap — youcook2/utils.py:64-101)
# ---------------------------------------------------------------------------

def corpus_bleu(pairs: list, n: int = 4, tokenizer=ptb_tokenize) -> list:
    """[Bleu_1..Bleu_n] over (refs, hyp) pairs, coco bleu_scorer.py
    compute_score semantics as invoked by the pycocoevalcap Bleu wrapper
    (bleu.py always passes option="closest"): clipped counts and guesses
    accumulated over the whole corpus, per-pair closest reference length
    (ties -> the smaller length), cumulative geometric precisions with
    tiny=1e-15 / small=1e-9, corpus-level brevity penalty.

    ``pairs`` is [(list_of_reference_strings, hypothesis_string), ...].
    """
    tiny, small = 1e-15, 1e-9
    testlen_total, reflen_total = 0, 0.0
    guess = [0] * n
    correct = [0] * n
    for refs, hyp in pairs:
        ref_toks = [tokenizer(r) for r in refs]
        hyp_toks = tokenizer(hyp)
        testlen = len(hyp_toks)
        testlen_total += testlen
        # closest, ties -> smaller length (tuple min, bleu_scorer.py)
        reflen_total += min((abs(len(r) - testlen), len(r))
                            for r in ref_toks)[1]
        for m in range(1, n + 1):
            hyp_counts = _ngram_counts(hyp_toks, m)
            # per-ngram max over references (cook_refs)
            max_ref: Counter = Counter()
            for r in ref_toks:
                for g, c in _ngram_counts(r, m).items():
                    max_ref[g] = max(max_ref[g], c)
            correct[m - 1] += sum(min(c, max_ref[g])
                                  for g, c in hyp_counts.items())
            guess[m - 1] += max(testlen - m + 1, 0)
    bleus = []
    bleu = 1.0
    for k in range(n):
        bleu *= (float(correct[k]) + tiny) / (float(guess[k]) + small)
        bleus.append(bleu ** (1.0 / (k + 1)))
    ratio = (testlen_total + tiny) / (reflen_total + small)
    if ratio < 1:
        bleus = [b * math.exp(1 - 1 / ratio) for b in bleus]
    return bleus


def cider(pairs: list, n: int = 4, sigma: float = 6.0,
          tokenizer=ptb_tokenize) -> float:
    """Mean CIDEr over (refs, hyp) pairs — an exact rebuild of
    pycocoevalcap/cider/cider_scorer.py (the "Cider" scorer youcook2 uses):
    document frequency from THIS call's reference sets, tf-idf weight
    ``tf * (log(len(corpus)) - log(df))`` per n-gram, clipped cosine per n,
    gaussian length penalty exp(-delta^2/(2*sigma^2)) where "length" is the
    scorer's bigram-count quirk (len-1 for non-empty captions), x10.

    Note the corpus-size dependence: a single-pair corpus has ref_len =
    log(1) = 0, which zeroes every weight — identical to pycocoevalcap.
    """
    crefs = [[dict(_all_ngram_counts(tokenizer(r), n)) for r in refs]
             for refs, _ in pairs]
    ctest = [dict(_all_ngram_counts(tokenizer(hyp), n)) for _, hyp in pairs]
    df: Counter = Counter()
    for refs in crefs:
        for g in set(g for ref in refs for g in ref):
            df[g] += 1
    ref_len = math.log(float(len(crefs)))

    def counts2vec(cnts):
        vec = [dict() for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for g, tf in cnts.items():
            w = float(tf) * (ref_len - math.log(max(1.0, df[g])))
            k = len(g) - 1
            vec[k][g] = w
            norm[k] += w * w
            if k == 1:  # the reference counts BIGRAMS as "length"
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    scores = []
    for test, refs in zip(ctest, crefs):
        vec, norm, length = counts2vec(test)
        score = [0.0] * n
        for ref in refs:
            vec_r, norm_r, length_r = counts2vec(ref)
            delta = float(length - length_r)
            for k in range(n):
                val = sum(min(w, vec_r[k].get(g, 0.0)) * vec_r[k].get(g, 0.0)
                          for g, w in vec[k].items())
                if norm[k] != 0 and norm_r[k] != 0:
                    val /= norm[k] * norm_r[k]
                score[k] += val * math.exp(-(delta ** 2) / (2 * sigma ** 2))
        scores.append(10.0 * sum(score) / n / len(refs))
    return sum(scores) / len(scores) if scores else 0.0


def _all_ngram_counts(tokens: list, n: int) -> Counter:
    """1..n-gram counts in one Counter (cider_scorer.py::precook)."""
    out: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(tokens) - k + 1):
            out[tuple(tokens[i:i + k])] += 1
    return out
