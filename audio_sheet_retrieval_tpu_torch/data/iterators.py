"""Batch iterators and batched inference helpers.

The port's own copy of the JAX package's ``data/iterators.py``
(reference:utils/batch_iterators.py): ``MultiviewPoolIteratorUnsupervised``
(k_samples sub-epochs, wrap-around batch fill, reshuffle after a full pool
pass, :163-221), its three-view variant (:224-283), a threaded prefetch
generator (:114-141) and the zero-pad
batched-compute utilities (:17-111). Batches are numpy arrays; the training
loop uploads them to its device.
"""

from __future__ import annotations

import queue
import threading
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


def batch_compute2(X1, X2, compute, batch_size: int,
                   prepare1: Optional[Callable] = None,
                   prepare2: Optional[Callable] = None):
    """Two-input variant (batch_iterators.py:65-111)."""
    n_samples = X1.shape[0]
    in1, in2 = list(X1.shape)[1:], list(X2.shape)[1:]
    n_batches = int(np.ceil(n_samples / batch_size))
    R = None
    for i_batch in range(n_batches):
        start = i_batch * batch_size
        E1 = X1[start:start + batch_size]
        E2 = X2[start:start + batch_size]
        n_missing = batch_size - E1.shape[0]
        if n_missing > 0:
            E1 = np.vstack((E1, np.zeros([n_missing] + in1, dtype=X1.dtype)))
            E2 = np.vstack((E2, np.zeros([n_missing] + in2, dtype=X2.dtype)))
        if prepare1 is not None:
            E1 = prepare1(E1)
        if prepare2 is not None:
            E2 = prepare2(E2)
        r = np.asarray(compute(E1, E2))
        if R is None:
            R = np.zeros([n_samples] + list(r.shape[1:]), dtype=r.dtype)
        R[start:start + batch_size - n_missing] = r[: batch_size - n_missing]
    return R


def threaded_generator(generator, num_cached: int = 10):
    """Producer-thread prefetch (batch_iterators.py:114-141): a thread runs
    ``generator`` ahead by up to ``num_cached`` items while the caller
    consumes. An exception in the producer is raised in the consumer (the
    JAX copy ends the stream silently instead). Drain the generator: a
    producer left blocked on a full queue holds its thread until exit."""
    q: "queue.Queue" = queue.Queue(maxsize=num_cached)
    end_marker = object()
    failure = []

    def producer():
        try:
            for item in generator:
                q.put(item)
        except BaseException as e:  # handed to the consumer below
            failure.append(e)
        finally:
            q.put(end_marker)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    item = q.get()
    while item is not end_marker:
        yield item
        item = q.get()
    thread.join()
    if failure:
        raise failure[0]


def threaded_generator_from_iterator(iterator, num_cached: int = 10):
    return threaded_generator(iter(iterator), num_cached)


class MultiviewPoolIteratorUnsupervised:
    """k_samples sub-epoch iterator over a pool (batch_iterators.py:163-221)."""

    def __init__(self, batch_size: int, prepare: Optional[Callable] = None,
                 k_samples: Optional[int] = None, shuffle: bool = True):
        self.batch_size = batch_size
        if prepare is None:
            def prepare(x, y):
                return x, y
        self.prepare = prepare
        self.shuffle = shuffle
        self.k_samples = k_samples
        self.epoch_counter = 0
        self.n_epochs = None

    def __call__(self, pool):
        self.pool = pool
        if self.k_samples is None or self.k_samples > pool.shape[0]:
            self.k_samples = pool.shape[0]
        self.n_batches = self.k_samples // self.batch_size
        self.n_epochs = max(1, pool.shape[0] // self.k_samples)
        return self

    def __iter__(self):
        n_samples = self.k_samples
        bs = self.batch_size
        idx_epoch = self.epoch_counter % self.n_epochs

        for i in range((n_samples + bs - 1) // bs):
            sl = slice(i * bs + idx_epoch * self.k_samples,
                       (i + 1) * bs + idx_epoch * self.k_samples)
            xb, zb = self.pool[sl]
            if xb.shape[0] < bs:
                x_con, z_con = self.pool[0:bs - xb.shape[0]]
                xb = np.concatenate((xb, x_con))
                zb = np.concatenate((zb, z_con))
            yield self.prepare(xb, zb)

        self.epoch_counter += 1
        if self.shuffle and (idx_epoch + 1) == self.n_epochs:
            self.pool.reset_batch_generator()


class TripleviewPoolIteratorUnsupervised:
    """Three-view variant (batch_iterators.py:224-283): the pool's
    ``[sl]`` gives three arrays."""

    def __init__(self, batch_size: int, prepare: Optional[Callable] = None,
                 k_samples: Optional[int] = None, shuffle: bool = True):
        self.batch_size = batch_size
        if prepare is None:
            def prepare(x, y, z):
                return x, y, z
        self.prepare = prepare
        self.shuffle = shuffle
        self.k_samples = k_samples
        self.epoch_counter = 0
        self.n_epochs = None

    def __call__(self, pool):
        self.pool = pool
        if self.k_samples is None or self.k_samples > pool.shape[0]:
            self.k_samples = pool.shape[0]
        self.n_batches = self.k_samples // self.batch_size
        self.n_epochs = max(1, pool.shape[0] // self.k_samples)
        return self

    def __iter__(self):
        bs = self.batch_size
        idx_epoch = self.epoch_counter % self.n_epochs
        for i in range((self.k_samples + bs - 1) // bs):
            sl = slice(i * bs + idx_epoch * self.k_samples,
                       (i + 1) * bs + idx_epoch * self.k_samples)
            xb, zb, wb = self.pool[sl]
            if xb.shape[0] < bs:
                x_con, z_con, w_con = self.pool[0:bs - xb.shape[0]]
                xb = np.concatenate((xb, x_con))
                zb = np.concatenate((zb, z_con))
                wb = np.concatenate((wb, w_con))
            yield self.prepare(xb, zb, wb)
        self.epoch_counter += 1
        if self.shuffle and (idx_epoch + 1) == self.n_epochs:
            self.pool.reset_batch_generator()
