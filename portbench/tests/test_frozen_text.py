"""The reference's frozen tokenizer, hasher and embedder equal the
program's on a few hundred texts (the one test that imports the program's
text code)."""

import numpy as np
import torch

from tiny import REPO  # noqa: F401  (puts the repository on the path)
from portbench.corpora import notes
from portbench.reference import text

from c99_vectordb_tpu_torch.ops.embed import embed_texts
from c99_vectordb_tpu_torch.utils import hashing, text as port_text

TEXTS = (notes.queries({"query_min_words": 0, "query_max_words": 12}, 200, 5)
         + [r["body"] for r in notes.make({"notes": 100, "min_words": 4, "max_words": 12}, 9).records]
         + ["", "   ", "Hello, World_x 12", "tabs\tand\nnewlines  here", "ÄÖ ünï mixed ascii",
            "UPPER lower MiXeD 0123 __x__", "emoji 🙂 and punctuation!?"])


def test_tokens_hashes_and_blank_rule():
    h = text.Hasher()
    for t in TEXTS:
        assert text.tokenize(t) == port_text.tokenize(t)
        assert text.is_blank_body(t) == port_text.is_blank_body(t)
        buckets, signs = hashing.token_features(t, text.DIM)
        got = [h.feature(tok) for tok in text.tokenize(t)]
        assert [b for b, _ in got] == buckets.tolist()
        assert [s for _, s in got] == signs.tolist()


def test_embedding_equals_program_bit_for_bit_in_float32():
    want = embed_texts(TEXTS, device="cpu")
    got = text.embed(TEXTS, text.Hasher(), "cpu", torch.float32).numpy()
    assert np.array_equal(got, want)
    exact = text.embed(TEXTS, text.Hasher(), "cpu").numpy()
    assert np.abs(exact - want).max() < 1e-7
