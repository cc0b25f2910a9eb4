"""Synthetic data (numpy; the same seed gives the same arrays as
``repro.data.synthetic.teacher_classification`` and ``token_lm``).

The paper's accuracy experiments run on a synthetic task engineered to show
a generalization gap at small scale: inputs are drawn from class-conditional
Gaussian clusters warped by a random 2-layer teacher net; labels are the
teacher's argmax, plus label noise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class ClassificationData:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_train(self) -> int:
        return self.x_train.shape[0]


def teacher_classification(seed: int, *, n_train: int = 8192,
                           n_test: int = 2048,
                           input_shape: Tuple[int, int, int] = (16, 16, 3),
                           n_classes: int = 10,
                           label_noise: float = 0.05) -> ClassificationData:
    """Class clusters -> random teacher warp -> argmax labels (+ noise)."""
    rng = np.random.RandomState(seed)
    h, w, c = input_shape
    dim = h * w * c
    n = n_train + n_test
    protos = rng.randn(n_classes, dim).astype(np.float32)
    cls = rng.randint(0, n_classes, size=n)
    x = protos[cls] + 1.0 * rng.randn(n, dim).astype(np.float32)
    # random teacher relabels: makes the boundary non-linear in x
    w1 = rng.randn(dim, 128).astype(np.float32) / np.sqrt(dim)
    w2 = rng.randn(128, n_classes).astype(np.float32) / np.sqrt(128)
    logits = np.maximum(x @ w1, 0.0) @ w2 + 2.0 * np.eye(n_classes,
                                                         dtype=np.float32)[cls]
    y = logits.argmax(axis=1)
    flip = rng.rand(n) < label_noise
    y[flip] = rng.randint(0, n_classes, size=int(flip.sum()))
    x = x.reshape(n, h, w, c)
    # standardize like image preprocessing
    x = (x - x.mean()) / (x.std() + 1e-6)
    return ClassificationData(
        x_train=x[:n_train], y_train=y[:n_train].astype(np.int32),
        x_test=x[n_train:], y_test=y[n_train:].astype(np.int32))


def token_lm(seed: int, *, vocab_size: int, n_tokens: int,
             zipf_a: float = 1.2, branch: int = 32) -> np.ndarray:
    """First-order Markov chain with Zipf-ish marginals: every token has
    ``branch`` plausible successors. Returns a flat int32 token stream."""
    rng = np.random.RandomState(seed)
    V = vocab_size
    succ = rng.randint(0, V, size=(V, branch)).astype(np.int32)
    probs = 1.0 / np.arange(1, branch + 1) ** zipf_a
    probs /= probs.sum()
    out = np.empty(n_tokens, dtype=np.int32)
    tok = rng.randint(0, V)
    choices = rng.choice(branch, size=n_tokens, p=probs)
    jumps = rng.rand(n_tokens) < 0.02     # occasional resets
    rand_toks = rng.randint(0, V, size=n_tokens)
    for i in range(n_tokens):
        out[i] = tok
        tok = int(rand_toks[i]) if jumps[i] else int(succ[tok, choices[i]])
    return out


def lm_sequences(stream: np.ndarray, seq_len: int) -> np.ndarray:
    """Chop a token stream into (N, seq_len) rows."""
    n = stream.size // seq_len
    return stream[: n * seq_len].reshape(n, seq_len)
