"""What the query drivers share: the seeded query order, the counts the
metrics read, and the comparison of answers and gallery rows."""

from __future__ import annotations

import numpy as np
import torch


class Order:
    """Pieces in a seeded order, a new permutation each round."""

    def __init__(self, seed: int, n: int):
        self.rng = np.random.default_rng([seed, 1])
        self.n = n
        self.todo = []

    def next(self) -> int:
        if not self.todo:
            self.todo = list(self.rng.permutation(self.n)[::-1])
        return int(self.todo.pop())


def keep(answer):
    """(piece, vote counts) -> (piece, (pieces voted for, their votes)):
    the client keeps the nonzero counts and lets the downloaded vector go,
    as a client that reads the ranking does, so that host memory does not
    grow by a vector a query."""
    p, counts = answer
    nz = np.flatnonzero(counts)
    return p, (nz, counts[nz])


def dense(kept, n: int) -> np.ndarray:
    nz, votes = kept
    out = np.zeros(n, np.int64)
    out[nz] = votes
    return out


def work(state, answers, *, view: int, excerpts: int) -> dict:
    n = len(answers)
    return {"calls": n, "queries": sum(a is not None for a in answers),
            "excerpts": n * excerpts, "view": view,
            "query_rows": excerpts, "gallery_rows": state.gallery.n,
            "k": state.mix["candidates"],
            "d": state.config["dim_latent"]}


def gallery_gap(codes: torch.Tensor, ids, ref_codes: torch.Tensor, ref_ids):
    """-> (largest code difference, rows whose id or presence differs)."""
    ids, ref_ids = np.asarray(ids), np.asarray(ref_ids)
    if codes.shape != ref_codes.shape:
        return float("inf"), abs(codes.shape[0] - ref_codes.shape[0])
    gap = float((codes.to(ref_codes.device) - ref_codes).abs().max())
    return gap, int(np.sum(ids != ref_ids))


def compare(prod: dict, ref: dict) -> dict:
    """Gallery rows as in ``gallery_gap``; ``votes_moved``: the most votes
    that any answer gives to other pieces than the reference's answer to
    the same query does (half the L1 distance of the two count vectors)."""
    gap, bad = gallery_gap(*prod["rows"], *ref["rows"])
    want = dict(ref["answers"])
    moved = []
    for p, kept in prod["answers"]:
        ref_counts = want[p]
        if isinstance(kept, tuple):
            kept = dense(kept, ref_counts.size)
        moved.append(float(np.abs(kept.astype(np.int64)
                                  - ref_counts).sum()) / 2.0
                     if kept.shape == ref_counts.shape else float("inf"))
    return {"code_gap": gap, "id_mismatch": float(bad),
            "votes_moved": max(moved) if moved else float("inf")}
