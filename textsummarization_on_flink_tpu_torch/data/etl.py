"""CNN/DailyMail ETL: story files -> tokenized, chunked tf.Example bins.

A copy of the JAX package's data/etl.py, after the reference's offline
pipeline (data/cnn-dailymail/make_datafiles.py):

  * a PTB-style regex tokenizer, a dependency-free stand-in for the
    reference's Stanford CoreNLP PTBTokenizer (:67-87);
  * ``get_art_abs`` (:109-147): lowercase, the missing periods of the
    reference's END_TOKENS, ``@highlight`` blocks as the abstract in
    ``<s> ... </s>``;
  * ``hashhex`` url -> sha1 story-file naming (:98-106);
  * ``write_to_bin`` (:150-209): length-prefixed serialized
    tf.Example{article, abstract} records in 1000-example chunk files
    ``<set>_000.bin`` (:28-64), and a vocab Counter over the article and
    abstract tokens;
  * ``make_datafiles``: url lists name the train/val/test splits by
    story hash; ``write_vocab`` writes the 200k most common words;
  * the raw-text example source of ``--inference=1`` (the reference's
    RawTextBatcher, batcher.py:382-395).

The chunk files are byte for byte the JAX package's, and
data/chunks.example_generator reads them.  Counted in obs:
``etl/stories_total``, ``etl/tokens_total``, gauge ``etl/vocab_words``,
span ``etl/write_to_bin``.

    from textsummarization_on_flink_tpu_torch.data import etl
    etl.make_datafiles("cnn_stories/", "url_lists/", "finished_files/")
"""

from __future__ import annotations

import collections
import glob
import hashlib
import logging
import os
import re
from typing import Iterable, List, Optional, Tuple

from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.data import chunks
from textsummarization_on_flink_tpu_torch.data.tfexample import Example
from textsummarization_on_flink_tpu_torch.data.vocab import (
    SENTENCE_END,
    SENTENCE_START,
)

log = logging.getLogger(__name__)

dm_single_close_quote = "\u2019"
dm_double_close_quote = "\u201d"
# make_datafiles.py:13 verbatim list
END_TOKENS = [".", "!", "?", "...", "'", "`", '"', dm_single_close_quote,
              dm_double_close_quote, ")"]

VOCAB_SIZE = 200_000  # make_datafiles.py:32
CHUNK_SIZE = 1000  # make_datafiles.py:33

_CONTRACTIONS = re.compile(
    r"\b(can)(not)\b|(\w+)(n't)\b|(\w+)('(?:ll|re|ve|s|m|d))\b",
    re.IGNORECASE)
_TOKEN = re.compile(
    r"n't|'(?:ll|re|ve|s|m|d)\b|"  # contraction fragments (post-split)
    r"\.\.\.|"             # ellipsis
    r"[a-zA-Z]+\.(?:[a-zA-Z]+\.)+|"  # abbreviations like u.s. / u.k.
    r"\d+(?:[.,]\d+)*|"    # numbers incl 1,000.5
    r"\w+(?:-\w+)*|"       # words and hyphenated compounds
    r"[^\w\s]",            # any single punctuation mark
    re.IGNORECASE)


def word_tokenize(text: str) -> List[str]:
    """PTB-style tokenization (CoreNLP PTBTokenizer stand-in)."""
    text = _CONTRACTIONS.sub(
        lambda m: " ".join(g for g in m.groups() if g), text)
    return _TOKEN.findall(text)


def tokenize_text(text: str) -> str:
    return " ".join(word_tokenize(text))


# -- story parsing (make_datafiles.py:109-147) -------------------------------

def fix_missing_period(line: str) -> str:
    """:109-116 — headlines/datelines often lack a closing period."""
    if not line:
        return line
    if line == "@highlight":
        return line
    if any(line.endswith(t) for t in END_TOKENS):
        return line
    return line + " ."


def get_art_abs(story_text: str, tokenize: bool = True) -> Tuple[str, str]:
    """Story text -> (article, abstract) (:119-147): lowercase, fix
    periods, split at @highlight markers, wrap highlights in <s>..</s>."""
    lines = [ln.strip() for ln in story_text.split("\n")]
    if tokenize:  # keep the @highlight markers intact through tokenization
        lines = [ln if ln.startswith("@highlight") else tokenize_text(ln)
                 for ln in lines]
    lines = [ln.lower() for ln in lines]
    lines = [fix_missing_period(ln) for ln in lines]
    article_lines: List[str] = []
    highlights: List[str] = []
    next_is_highlight = False
    for line in lines:
        if not line:
            continue
        elif line.startswith("@highlight"):
            next_is_highlight = True
        elif next_is_highlight:
            highlights.append(line)
        else:
            article_lines.append(line)
    article = " ".join(article_lines)
    abstract = " ".join(f"{SENTENCE_START} {sent} {SENTENCE_END}"
                        for sent in highlights)
    return article, abstract


# -- url hashing (make_datafiles.py:89-106) ----------------------------------

def hashhex(s: str) -> str:
    h = hashlib.sha1()
    h.update(s.encode("utf-8"))
    return h.hexdigest()


def get_url_hashes(url_list: Iterable[str]) -> List[str]:
    return [hashhex(url) for url in url_list]


def read_text_file(path: str) -> List[str]:
    with open(path, "r", encoding="utf-8") as f:
        return [line.strip() for line in f]


# -- bin writing (make_datafiles.py:150-209) ---------------------------------

def story_to_example(story_text: str, tokenize: bool = True) -> Example:
    article, abstract = get_art_abs(story_text, tokenize=tokenize)
    ex = Example()
    ex.set_bytes("article", article.encode("utf-8"))
    ex.set_bytes("abstract", abstract.encode("utf-8"))
    return ex


def write_to_bin(story_paths: List[str], out_prefix: str,
                 makevocab: bool = False,
                 vocab_counter: Optional[collections.Counter] = None,
                 chunk_size: int = CHUNK_SIZE,
                 tokenize: bool = True) -> List[str]:
    """Stories -> chunked bins `<out_prefix>_000.bin...`; optionally counts
    vocab (article+abstract tokens, <s>/</s> excluded, :182-194).

    Streams one chunk at a time (O(chunk_size) memory — the full CNN/DM
    train split is ~287k stories, far too large to hold as Examples).
    """

    c_stories = obs.counter("etl/stories_total")
    c_tokens = obs.counter("etl/tokens_total")

    def examples():
        for path in story_paths:
            with open(path, "r", encoding="utf-8") as f:
                ex = story_to_example(f.read(), tokenize=tokenize)
            art = ex.get_str("article")
            c_stories.inc()
            c_tokens.inc(art.count(" ") + 1)
            if makevocab and vocab_counter is not None:
                abs_ = ex.get_str("abstract")
                tokens = art.split() + [
                    t for t in abs_.split()
                    if t not in (SENTENCE_START, SENTENCE_END)]
                vocab_counter.update(t.strip() for t in tokens if t.strip())
            yield ex

    n_chunks = max((len(story_paths) + chunk_size - 1) // chunk_size, 1)
    with obs.span("etl/write_to_bin", prefix=os.path.basename(out_prefix)):
        return chunks.write_chunked_iter(out_prefix,
                                         (ex.features for ex in examples()),
                                         chunk_size=chunk_size,
                                         total_chunks=n_chunks)


def write_vocab(counter: collections.Counter, path: str,
                size: int = VOCAB_SIZE) -> None:
    """`<word> <count>` lines, most common first (:199-203)."""
    with open(path, "w", encoding="utf-8") as f:
        n = 0
        for word, count in counter.most_common(size):
            f.write(f"{word} {count}\n")
            n += 1
    obs.gauge("etl/vocab_words").set(n)
    log.info("Finished writing vocab file %s", path)


def make_datafiles(stories_dir: str, url_dir: str, out_dir: str,
                   chunk_size: int = CHUNK_SIZE,
                   vocab_size: int = VOCAB_SIZE) -> None:
    """Full pipeline: url lists name the train/val/test splits by story
    hash (make_datafiles.py:218-244 flow, single stories dir)."""
    os.makedirs(out_dir, exist_ok=True)
    vocab_counter: collections.Counter = collections.Counter()
    for set_name, url_file in (("train", "all_train.txt"),
                               ("val", "all_val.txt"),
                               ("test", "all_test.txt")):
        urls = read_text_file(os.path.join(url_dir, url_file))
        hashes = get_url_hashes(urls)
        paths = []
        for h in hashes:
            p = os.path.join(stories_dir, h + ".story")
            if not os.path.exists(p):
                raise FileNotFoundError(
                    f"story file {p} for a url in {url_file} not found")
            paths.append(p)
        write_to_bin(paths, os.path.join(out_dir, set_name),
                     makevocab=(set_name == "train"),
                     vocab_counter=vocab_counter, chunk_size=chunk_size)
        log.info("wrote %d %s examples", len(paths), set_name)
    write_vocab(vocab_counter, os.path.join(out_dir, "vocab"),
                size=vocab_size)


# -- raw-text inference source (batcher.py:382-395) --------------------------

def raw_text_example_source(data_path: str):
    """example_source for Batcher: each file under the glob is one article
    (RawTextBatcher semantics: tokenized article, raw text as 'abstract')."""

    def source():
        filelist = sorted(glob.glob(data_path))
        if not filelist:
            raise FileNotFoundError(f"Error: Empty filelist at {data_path}")
        for path in filelist:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
            article = tokenize_text(text)
            # the raw text rides along as a single abstract sentence
            yield article, f"{SENTENCE_START} {text} {SENTENCE_END}"

    return source
