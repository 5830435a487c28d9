"""The port's offline ETL against the JAX package's, on the CPU.

The same .story files and url lists go through both packages'
``make_datafiles`` and ``write_to_bin``: the chunk files and the vocab
file are equal byte for byte, and the port's ``chunks.example_generator``
reads back what the port wrote."""

import collections
import os

import numpy as np
import pytest

from textsummarization_on_flink_tpu import obs as jax_obs
from textsummarization_on_flink_tpu.data import etl as jax_etl
from textsummarization_on_flink_tpu_torch import obs
from textsummarization_on_flink_tpu_torch.data import chunks, etl
from textsummarization_on_flink_tpu_torch.data.vocab import Vocab

LINES = ["The Quick Brown Fox jumped over the U.S. border",
         "It's 1,000.5 miles; they don't stop",
         "“Quoted,” said the dog’s owner (twice)",
         "A headline without a period", "Numbers 3 4 5 and a-b-c",
         "Wait...", "Questions? Answers!"]


def write_stories(root, n, seed=0):
    """n story files of seeded lines and 1-3 highlights each; returns
    their paths."""
    rng = np.random.RandomState(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        body = [LINES[j] for j in rng.randint(0, len(LINES),
                                              rng.randint(1, 6))]
        highs = [f"Fox {i} jumps", "Dog sleeps."][: rng.randint(1, 3)]
        text = "\n\n".join(body + [f"@highlight\n\n{h}" for h in highs])
        if i == 3:
            text = "@highlight\n\nonly a highlight"  # an empty article
        p = os.path.join(root, f"story{i}.story")
        with open(p, "w", encoding="utf-8") as f:
            f.write(text)
        paths.append(p)
    return paths


def read_dir(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("chunk_size,n", [(2, 7), (3, 3), (1000, 5)])
def test_write_to_bin_is_byte_equal(tmp_path, chunk_size, n):
    paths = write_stories(str(tmp_path / "stories"), n)
    out = {}
    for name, mod, omod in (("jax", jax_etl, jax_obs), ("port", etl, obs)):
        d = tmp_path / name
        d.mkdir()
        counter = collections.Counter()
        reg = omod.Registry()
        with omod.use_registry(reg):
            written = mod.write_to_bin(paths, str(d / "train"),
                                       makevocab=True, vocab_counter=counter,
                                       chunk_size=chunk_size)
            mod.write_vocab(counter, str(d / "vocab"))
        out[name] = (read_dir(d), [os.path.basename(p) for p in written],
                     counter, reg)
    got, want = out["port"], out["jax"]
    assert got[0] == want[0]  # every chunk file and the vocab, bytes
    assert got[1] == want[1] == [
        f"train_{i:03d}.bin" for i in range(-(-n // chunk_size))]
    assert got[2] == want[2]
    reg = got[3]
    assert reg.counter("etl/stories_total").value == n
    assert reg.counter("etl/tokens_total").value == \
        want[3].counter("etl/tokens_total").value
    assert reg.gauge("etl/vocab_words").value == len(got[2])


def test_make_datafiles_is_byte_equal_and_reads_back(tmp_path):
    paths = write_stories(str(tmp_path / "raw"), 9, seed=3)
    url_dir, stories_dir = tmp_path / "urls", tmp_path / "hashed"
    url_dir.mkdir()
    stories_dir.mkdir()
    urls = {"train": [f"http://news/{i}" for i in range(5)],
            "val": ["http://news/5", "http://news/6"],
            "test": ["http://news/7", "http://news/8"]}
    for split, us in urls.items():
        (url_dir / f"all_{split}.txt").write_text("\n".join(us) + "\n")
    for i, u in enumerate(u for us in urls.values() for u in us):
        assert etl.hashhex(u) == jax_etl.hashhex(u)
        (stories_dir / f"{etl.hashhex(u)}.story").write_bytes(
            open(paths[i], "rb").read())
    for name, mod in (("jax", jax_etl), ("port", etl)):
        mod.make_datafiles(str(stories_dir), str(url_dir),
                           str(tmp_path / name), chunk_size=2,
                           vocab_size=30)
    got, want = read_dir(tmp_path / "port"), read_dir(tmp_path / "jax")
    assert got == want
    assert sorted(got) == ["test_000.bin", "train_000.bin", "train_001.bin",
                           "train_002.bin", "val_000.bin", "vocab"]
    assert len(got["vocab"].decode().splitlines()) == 30
    # the port's reader gives back the port's records, in url order
    exs = list(chunks.example_generator(str(tmp_path / "port" / "train_*.bin"),
                                        single_pass=True))
    want_pairs = [jax_etl.get_art_abs(open(paths[i], encoding="utf-8").read())
                  for i in range(5)]
    assert [(e.get_str("article"), e.get_str("abstract")) for e in exs] == \
        want_pairs
    assert want_pairs[3][0] == ""  # the highlight-only story
    assert Vocab(str(tmp_path / "port" / "vocab"), 0).size() == 34


def test_story_parsing_equals_jax():
    for text in LINES + ["@highlight\n\nx", "a\n\n@highlight\n\nb\n\nc"]:
        assert etl.get_art_abs(text) == jax_etl.get_art_abs(text)
        assert etl.get_art_abs(text, tokenize=False) == \
            jax_etl.get_art_abs(text, tokenize=False)
        assert etl.story_to_example(text).serialize() == \
            jax_etl.story_to_example(text).serialize()
    for line in LINES:
        assert etl.fix_missing_period(line.lower()) == \
            jax_etl.fix_missing_period(line.lower())


def test_a_missing_story_raises(tmp_path):
    url_dir = tmp_path / "urls"
    url_dir.mkdir()
    for split in ("train", "val", "test"):
        (url_dir / f"all_{split}.txt").write_text("http://missing\n")
    with pytest.raises(FileNotFoundError, match="story file"):
        etl.make_datafiles(str(tmp_path), str(url_dir), str(tmp_path / "o"))
