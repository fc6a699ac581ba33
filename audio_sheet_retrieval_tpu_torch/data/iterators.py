"""Batched inference helper.

The port's own copy of ``batch_compute1`` from the JAX package's
``data/iterators.py`` (reference:utils/batch_iterators.py:17-62).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def batch_compute1(X, compute, batch_size: int, prepare: Optional[Callable] = None):
    """Fixed-size batched inference with a zero-padded tail: ``compute``
    sees only [batch_size, ...] arrays."""
    n_samples = X.shape[0]
    in_shape = list(X.shape)[1:]
    n_batches = int(np.ceil(n_samples / batch_size))
    R = None
    for i_batch in range(n_batches):
        start = i_batch * batch_size
        E = X[start:start + batch_size]
        n_missing = batch_size - E.shape[0]
        if n_missing > 0:
            E = np.vstack((E, np.zeros([n_missing] + in_shape, dtype=X.dtype)))
        if prepare is not None:
            E = prepare(E)
        r = np.asarray(compute(E))
        if R is None:
            R = np.zeros([n_samples] + list(r.shape[1:]), dtype=r.dtype)
        R[start:start + batch_size - n_missing] = r[: batch_size - n_missing]
    return R
