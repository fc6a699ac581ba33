"""Piece loading for the servers' ``npz:<dir>`` source.

The port's own copy of ``load_piece_npz`` from the JAX package's
``data/msmd.py``: one ``<piece>.npz`` per piece with arrays ``image``
[H, W] uint8, ``spec_<k>`` [bins, T] float32 and ``o2c_<k>`` [N, 2] int for
each performance k (what ``cli/export_msmd_npz.py`` writes). The MSMD
loader itself needs the ``msmd`` package and is not copied.
"""

from __future__ import annotations

import numpy as np


def load_piece_npz(path: str):
    """-> (image, [spectrograms], [o2c maps]) of one exported piece."""
    data = np.load(path)
    image = data["image"]
    specs, o2cs = [], []
    k = 0
    while f"spec_{k}" in data:
        specs.append(data[f"spec_{k}"])
        o2cs.append(data[f"o2c_{k}"])
        k += 1
    return image, specs, o2cs
