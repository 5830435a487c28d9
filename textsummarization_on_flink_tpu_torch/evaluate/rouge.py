"""Native ROUGE-1/2/L scoring with bootstrap confidence intervals.

A copy of the JAX package's evaluate/rouge.py (pure Python and numpy),
kept here under the port's import rule.  It replaces the reference's
Perl ROUGE-1.5.5 via pyrouge (decode.py:268-301) with the same
measures, so nothing is downloaded:

  * ROUGE-N (N=1,2): clipped n-gram recall/precision/F1 over the whole
    summary (Lin 2004 eq. 1), computed per document;
  * ROUGE-L: summary-level LCS with union-LCS across sentence pairs
    (Lin 2004 3.2): for each reference sentence, the union of LCS
    matches against all candidate sentences counts as hits;
  * 95% confidence intervals by bootstrap resampling over documents
    (ROUGE-1.5.5's default 1000 resamples) from
    ``np.random.RandomState(seed)``, so a run's intervals repeat; reported
    like pyrouge's ``rouge_log`` output (decode.py:280-293), which also
    writes ``ROUGE_results.txt``.

Tokenization mirrors ROUGE-1.5.5's default: lowercase, alphanumeric
tokens (no stemming, no stopword removal: the reference calls pyrouge
without -m/-s).
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def tokenize(text: str) -> List[str]:
    return _TOKEN_RE.findall(text.lower())


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


@dataclasses.dataclass(frozen=True)
class Score:
    recall: float
    precision: float
    f: float


def _prf(hits: int, peer_total: int, model_total: int) -> Score:
    p = hits / peer_total if peer_total else 0.0
    r = hits / model_total if model_total else 0.0
    f = 2 * p * r / (p + r) if p + r else 0.0
    return Score(recall=r, precision=p, f=f)


def rouge_n(peer_sents: Sequence[str], model_sents: Sequence[str],
            n: int) -> Score:
    """Clipped n-gram overlap for one document.

    peer = system/decoded summary; model = gold reference summary
    (ROUGE-1.5.5 vocabulary).  Sentences are concatenated: ROUGE-N is a
    bag-of-ngrams measure over the full summary.
    """
    peer = _ngrams([t for s in peer_sents for t in tokenize(s)], n)
    model = _ngrams([t for s in model_sents for t in tokenize(s)], n)
    hits = sum(min(c, peer[g]) for g, c in model.items())
    return _prf(hits, sum(peer.values()), sum(model.values()))


def _lcs_table(a: Sequence[str], b: Sequence[str]) -> np.ndarray:
    la, lb = len(a), len(b)
    dp = np.zeros((la + 1, lb + 1), dtype=np.int32)
    for i in range(1, la + 1):
        ai = a[i - 1]
        row = dp[i]
        prev = dp[i - 1]
        for j in range(1, lb + 1):
            if ai == b[j - 1]:
                row[j] = prev[j - 1] + 1
            else:
                row[j] = row[j - 1] if row[j - 1] >= prev[j] else prev[j]
    return dp


def _lcs_match_positions(a: Sequence[str], b: Sequence[str]) -> set:
    """Positions in `a` participating in one LCS of a vs b."""
    dp = _lcs_table(a, b)
    out = set()
    i, j = len(a), len(b)
    while i > 0 and j > 0:
        if a[i - 1] == b[j - 1] and dp[i][j] == dp[i - 1][j - 1] + 1:
            out.add(i - 1)
            i -= 1
            j -= 1
        elif dp[i - 1][j] >= dp[i][j - 1]:
            i -= 1
        else:
            j -= 1
    return out


def rouge_l(peer_sents: Sequence[str], model_sents: Sequence[str]) -> Score:
    """Summary-level ROUGE-L with union LCS (Lin 2004 3.2).

    For each model (reference) sentence r_i, the union over all peer
    sentences of LCS(r_i, c_j) positions counts as hits; totals are the
    summary word counts.
    """
    peer_tok = [tokenize(s) for s in peer_sents]
    model_tok = [tokenize(s) for s in model_sents]
    peer_total = sum(len(t) for t in peer_tok)
    model_total = sum(len(t) for t in model_tok)
    hits = 0
    for r in model_tok:
        union: set = set()
        for c in peer_tok:
            if r and c:
                union |= _lcs_match_positions(r, c)
        hits += len(union)
    return _prf(hits, peer_total, model_total)


def score_document(peer_sents: Sequence[str], model_sents: Sequence[str],
                   ) -> Dict[str, Score]:
    return {
        "rouge_1": rouge_n(peer_sents, model_sents, 1),
        "rouge_2": rouge_n(peer_sents, model_sents, 2),
        "rouge_l": rouge_l(peer_sents, model_sents),
    }


def _bootstrap_ci(values: np.ndarray, n_samples: int = 1000,
                  seed: int = 0) -> Tuple[float, float]:
    """95% CI of the mean by bootstrap resampling over documents
    (ROUGE-1.5.5 default resampling protocol)."""
    if len(values) == 0:
        return (0.0, 0.0)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(values), size=(n_samples, len(values)))
    means = values[idx].mean(axis=1)
    return (float(np.percentile(means, 2.5)),
            float(np.percentile(means, 97.5)))


def score_corpus(peer_docs: Sequence[Sequence[str]],
                 model_docs: Sequence[Sequence[str]],
                 n_bootstrap: int = 1000) -> Dict[str, Dict[str, float]]:
    """Corpus scores in pyrouge's results_dict key layout
    (decode.py:283-289 reads `<metric>_f_score` / `_recall` / `_precision`
    plus `_cb`/`_ce` CI bounds)."""
    if len(peer_docs) != len(model_docs):
        raise ValueError(
            f"{len(peer_docs)} decoded vs {len(model_docs)} reference docs")
    per_doc: Dict[str, Dict[str, List[float]]] = {
        m: {"f_score": [], "recall": [], "precision": []}
        for m in ("rouge_1", "rouge_2", "rouge_l")}
    for peer, model in zip(peer_docs, model_docs):
        doc = score_document(peer, model)
        for m, s in doc.items():
            per_doc[m]["f_score"].append(s.f)
            per_doc[m]["recall"].append(s.recall)
            per_doc[m]["precision"].append(s.precision)
    results: Dict[str, Dict[str, float]] = {}
    for m, stats in per_doc.items():
        results[m] = {}
        for stat, vals in stats.items():
            arr = np.asarray(vals, dtype=np.float64)
            mean = float(arr.mean()) if len(arr) else 0.0
            lo, hi = _bootstrap_ci(arr, n_samples=n_bootstrap)
            results[m][stat] = mean
            results[m][f"{stat}_cb"] = lo
            results[m][f"{stat}_ce"] = hi
    return results


# --------------------------------------------------------------------------
# pyrouge-layout directory evaluation (decode.py:187-222, 268-301)
# --------------------------------------------------------------------------

def read_summary_file(path: str) -> List[str]:
    """One sentence per line (write_for_rouge layout, decode.py:202-211)."""
    with open(path, "r", encoding="utf-8") as f:
        return [line.rstrip("\n") for line in f if line.strip()]


def rouge_eval(ref_dir: str, dec_dir: str,
               n_bootstrap: int = 1000) -> Dict[str, Dict[str, float]]:
    """Evaluate the write_for_rouge file layout: `ref_dir/<i>_reference.txt`
    vs `dec_dir/<i>_decoded.txt` (decode.py:215-221 naming)."""
    refs = sorted(glob.glob(os.path.join(ref_dir, "*_reference.txt")))
    peers, models = [], []
    for ref_path in refs:
        stem = os.path.basename(ref_path).split("_")[0]
        dec_path = os.path.join(dec_dir, f"{stem}_decoded.txt")
        if not os.path.exists(dec_path):
            raise FileNotFoundError(f"missing decoded file {dec_path}")
        models.append(read_summary_file(ref_path))
        peers.append(read_summary_file(dec_path))
    return score_corpus(peers, models, n_bootstrap=n_bootstrap)


def rouge_log(results_dict: Dict[str, Dict[str, float]],
              dir_to_write: str) -> str:
    """Format + log + write ROUGE_results.txt (decode.py:280-301)."""
    lines = []
    for x in ("1", "2", "l"):
        lines.append(f"\nROUGE-{x}:")
        for y in ("f_score", "recall", "precision"):
            key = f"rouge_{x}"
            val = results_dict[key][y]
            cb = results_dict[key][f"{y}_cb"]
            ce = results_dict[key][f"{y}_ce"]
            lines.append(
                f"{key}_{y}: {val:.4f} with confidence interval "
                f"({cb:.4f}, {ce:.4f})")
    text = "\n".join(lines)
    log.info(text)
    os.makedirs(dir_to_write, exist_ok=True)
    results_file = os.path.join(dir_to_write, "ROUGE_results.txt")
    log.info("Writing final ROUGE results to %s...", results_file)
    with open(results_file, "w", encoding="utf-8") as f:
        f.write(text)
    return text
