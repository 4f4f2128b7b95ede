"""Frozen copy of ``src/repro_torch/fl/partition.py`` (the port's
non-iid split), kept beside the benchmark so that a later change to the program
cannot change the traffic it is measured on. Copied as it stood, only
this header changed.
"""
from __future__ import annotations

import numpy as np


def non_iid_partition(images, labels, n_clients: int = 100,
                      digits_per_client: int = 2, seed: int = 0):
    """Each client gets ``digits_per_client`` digit classes, shards split
    evenly among the clients assigned to each digit. Returns a list of
    (images, labels) per client."""
    rng = np.random.default_rng(seed)
    # assign digits to clients round-robin over a shuffled multiset
    assignments = []
    pool = []
    for _ in range(n_clients * digits_per_client // 10 + 1):
        pool.extend(rng.permutation(10).tolist())
    for c in range(n_clients):
        assignments.append(pool[c * digits_per_client : (c + 1) * digits_per_client])

    by_digit = {d: np.where(labels == d)[0] for d in range(10)}
    cursor = {d: 0 for d in range(10)}
    counts = {d: sum(a.count(d) for a in [list(x) for x in assignments]) for d in range(10)}
    out = []
    for c in range(n_clients):
        idx = []
        for d in assignments[c]:
            share = len(by_digit[d]) // max(counts[d], 1)
            lo = cursor[d]
            idx.extend(by_digit[d][lo : lo + share].tolist())
            cursor[d] += share
        idx = np.array(idx, np.int64)
        rng.shuffle(idx)
        out.append((images[idx], labels[idx]))
    return out


def stack_clients(parts, per_client: int, seed: int = 0):
    """Stack each client's first ``per_client`` samples -> (M, n, 28, 28)."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for img, lab in parts:
        n = len(lab)
        take = rng.choice(n, per_client, replace=n < per_client)
        xs.append(img[take])
        ys.append(lab[take])
    return np.stack(xs), np.stack(ys)
