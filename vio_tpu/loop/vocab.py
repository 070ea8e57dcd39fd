"""Binary bag-of-words place recognition over ORB descriptors.

Re-derivation in JAX of the reference's DBoW3 demo
(reference: 08-loop-closure/01-dbow-demo/dbow_demo.cpp:31-60 — vocabulary
build with K=10 branching / L=5 depth over ORB descriptors, database
query; README.md:44-50 knowhow: raw scores need relative normalization
against the previous-frame score).

The vocabulary is a flat K^L-leaf codebook trained by binary k-medians
(majority-bit centers) — hierarchical traversal is replaced by ONE
Hamming-distance matmul-style pass against all words (dense (N, W) int
ops vectorize better on an accelerator than tree descent).  BoW vectors are TF-IDF
weighted, scored with the DBoW L1 similarity.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..features import orb


def _unpack_bits(packed: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 → (N, 256) {0,1}."""
    n = packed.shape[0]
    bits = np.zeros((n, 256), np.uint8)
    for lane in range(8):
        for b in range(32):
            bits[:, lane * 32 + b] = (packed[:, lane] >> b) & 1
    return bits


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    n = bits.shape[0]
    packed = np.zeros((n, 8), np.uint32)
    for lane in range(8):
        for b in range(32):
            packed[:, lane] |= bits[:, lane * 32 + b].astype(np.uint32) << b
    return packed


class Vocabulary:
    """Binary k-medians codebook + TF-IDF weights."""

    def __init__(self, words_packed: np.ndarray, idf: np.ndarray):
        self.words = jnp.asarray(words_packed)    # (W, 8) uint32
        self.idf = np.asarray(idf)                # (W,)

    @property
    def n_words(self) -> int:
        return self.words.shape[0]

    @staticmethod
    def train(descriptors: np.ndarray, n_words: int = 100,
              iters: int = 8, seed: int = 0) -> "Vocabulary":
        """Binary k-medians over training descriptors (N, 8)-packed.
        n_words ≈ K^L scaled to the corpus (the demo's K=10/L=5 tree has
        1e5 leaves for big corpora; scale to data here)."""
        rng = np.random.default_rng(seed)
        n = descriptors.shape[0]
        n_words = min(n_words, n)
        centers = descriptors[rng.choice(n, n_words, replace=False)]
        for _ in range(iters):
            D = np.asarray(orb.hamming_matrix(jnp.asarray(descriptors),
                                              jnp.asarray(centers)))
            assign = D.argmin(axis=1)
            bits = _unpack_bits(descriptors)
            new_bits = np.zeros((n_words, 256), np.uint8)
            for w in range(n_words):
                sel = assign == w
                if sel.any():
                    new_bits[w] = (bits[sel].mean(axis=0) > 0.5)
                else:
                    new_bits[w] = bits[rng.integers(n)]
            centers = _pack_bits(new_bits)
        # IDF from training corpus occupancy
        D = np.asarray(orb.hamming_matrix(jnp.asarray(descriptors),
                                          jnp.asarray(centers)))
        assign = D.argmin(axis=1)
        df = np.bincount(assign, minlength=n_words).astype(np.float64)
        idf = np.log(n / np.maximum(df, 1.0))
        return Vocabulary(centers, idf)

    def bow(self, descriptors: np.ndarray) -> np.ndarray:
        """TF-IDF normalized BoW vector (W,) for one image's packed
        descriptors."""
        if len(descriptors) == 0:
            return np.zeros(self.n_words)
        D = np.asarray(orb.hamming_matrix(jnp.asarray(descriptors),
                                          self.words))
        assign = D.argmin(axis=1)
        tf = np.bincount(assign, minlength=self.n_words).astype(np.float64)
        v = tf * self.idf
        s = np.abs(v).sum()
        return v / s if s > 0 else v


def l1_score(v1: np.ndarray, v2: np.ndarray) -> float:
    """DBoW L1 similarity in [0, 1]."""
    return 1.0 - 0.5 * np.abs(v1 - v2).sum()


class LoopDatabase:
    """Sequential place-recognition database with the relative-score
    normalization the reference's README prescribes (08-.../README.md:44-50):
    a candidate counts only if score(query, cand) ≥ alpha ·
    score(query, previous frame)."""

    def __init__(self, vocab: Vocabulary, alpha: float = 0.3,
                 min_gap: int = 30):
        self.vocab = vocab
        self.alpha = alpha
        self.min_gap = min_gap
        self._bows = np.zeros((0, vocab.n_words))

    @property
    def bows(self):
        return self._bows

    def add(self, descriptors: np.ndarray) -> int:
        v = self.vocab.bow(descriptors)[None, :]
        self._bows = np.concatenate([self._bows, v], axis=0)
        return len(self._bows) - 1

    def add_bow(self, v: np.ndarray) -> int:
        self._bows = np.concatenate([self._bows, v[None, :]], axis=0)
        return len(self._bows) - 1

    def query(self, idx: int):
        """Best loop candidate for frame idx (already added).  Returns
        (best_idx, score) or None.  One vectorized L1 pass over the whole
        database (no per-entry Python loop)."""
        if idx < 1 or idx - self.min_gap <= 0:
            return None
        v = self._bows[idx]
        ref = l1_score(v, self._bows[idx - 1])     # previous-frame norm
        cand = self._bows[:idx - self.min_gap]
        scores = 1.0 - 0.5 * np.abs(cand - v[None, :]).sum(axis=1)
        best = int(scores.argmax())
        best_s = float(scores[best])
        if ref <= 1e-6:
            return None
        if best_s >= self.alpha * ref:
            return best, best_s
        return None
