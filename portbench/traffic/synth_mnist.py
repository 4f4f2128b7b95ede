"""Frozen copy of ``src/repro_torch/data/synth_mnist.py`` (the port's
procedural MNIST), kept beside the benchmark so that a later change to the program
cannot change the traffic it is measured on. Copied as it stood, only
this header changed.
"""
from __future__ import annotations

import numpy as np

# segment -> (row0, row1, col0, col1) in a 20x12 glyph box
_SEGS = {
    "A": (0, 2, 1, 11),
    "B": (1, 10, 10, 12),
    "C": (10, 19, 10, 12),
    "D": (18, 20, 1, 11),
    "E": (10, 19, 0, 2),
    "F": (1, 10, 0, 2),
    "G": (9, 11, 1, 11),
}

_DIGIT_SEGS = {
    0: "ABCDEF",
    1: "BC",
    2: "ABGED",
    3: "ABGCD",
    4: "FGBC",
    5: "AFGCD",
    6: "AFGEDC",
    7: "ABC",
    8: "ABCDEFG",
    9: "ABCDFG",
}


def _glyph(digit: int) -> np.ndarray:
    g = np.zeros((20, 12), np.float32)
    for s in _DIGIT_SEGS[digit]:
        r0, r1, c0, c1 = _SEGS[s]
        g[r0:r1, c0:c1] = 1.0
    return g

_GLYPHS = np.stack([_glyph(d) for d in range(10)])


def make_dataset(n_per_class: int, seed: int = 0):
    """Returns (images (N,28,28) f32 in [0,1], labels (N,) int32), shuffled."""
    rng = np.random.default_rng(seed)
    imgs, labels = [], []
    for d in range(10):
        base = _GLYPHS[d]
        for _ in range(n_per_class):
            canvas = np.zeros((28, 28), np.float32)
            dy = rng.integers(0, 8)
            dx = rng.integers(0, 16)
            inten = rng.uniform(0.7, 1.0)
            canvas[dy : dy + 20, dx : dx + 12] = base * inten
            canvas += rng.normal(0.0, 0.12, (28, 28)).astype(np.float32)
            imgs.append(np.clip(canvas, 0.0, 1.0))
            labels.append(d)
    imgs = np.stack(imgs)
    labels = np.array(labels, np.int32)
    order = rng.permutation(len(labels))
    return imgs[order], labels[order]


def train_test(n_train_per_class: int = 600, n_test_per_class: int = 100, seed: int = 0):
    tr = make_dataset(n_train_per_class, seed=seed)
    te = make_dataset(n_test_per_class, seed=seed + 10_000)
    return tr, te
