"""PyTorch port, ops/embed.py against the JAX package on the CPU.

Tolerance: max |diff| <= 1e-7, and 0 is expected — every bucket is a sum of
+-1 signs (exact in f32 in any order), and the sqrt and division are
correctly rounded in both frameworks."""

import numpy as np
import pytest
import torch

from c99_vectordb_tpu.constants import DIM
from c99_vectordb_tpu.ops.embed import embed_texts as jax_embed_texts
from c99_vectordb_tpu_torch.ops.embed import embed_text, embed_texts, embed_texts_device

CORPORA = {
    "unit_norm": ["the quick brown fox"],
    "blanks": ["", "  \n ", "!!! ???"],
    "batch": ["alpha beta", "gamma delta epsilon", "", "alpha beta"],
    "similar": [
        "exercise fitness running health",
        "running exercise for health and fitness",
        "tax accounting quarterly filings",
    ],
    "mixed": [
        "Hello World hello", "unicode üñîсö 中文 tokens", "dup dup dup unique",
        "a" * 300 + " b c d", "the_quick brown-fox; jumps!! over 42 lazy_dogs",
    ],
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_embed_matches_jax_package(name):
    texts = CORPORA[name]
    got = embed_texts(texts, device="cpu")
    want = np.asarray(jax_embed_texts(texts))
    assert got.shape == want.shape == (len(texts), DIM)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-7
    np.testing.assert_array_equal((got == 0).all(1), (want == 0).all(1))


def test_embed_device_tensor_and_single():
    t = embed_texts_device(["alpha beta", ""], device="cpu")
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert t.shape == (2, DIM) and t.dtype == torch.float32
    assert abs(float(torch.linalg.vector_norm(t[0])) - 1.0) < 1e-6
    assert bool((t[1] == 0).all())
    np.testing.assert_array_equal(embed_text("alpha beta", device="cpu"), t[0].numpy())
    assert embed_texts([], device="cpu").shape == (0, DIM)
    assert embed_texts_device([], device="cpu").shape == (0, DIM)
