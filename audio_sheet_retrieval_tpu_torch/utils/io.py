"""Reader and writer for the JAX package's native ``asr-tpu-v1`` checkpoint
pickles, and the training curves file (``save_results`` / ``load_results``).

The JAX package pickles ``{"format", "version", "tree", "meta"}`` where
``tree`` is a ``models.cca_model.ModelParams`` holding an ``ops.cca.CCAState``
with plain numpy leaves. Both classes live in JAX-importing modules, so a
plain ``pickle.load`` would import jax. The unpickler below maps those two
names onto this package's NamedTuples and refuses every other class from the
JAX package (or from jax itself) instead of importing it; the pickler writes
this package's two NamedTuples under the JAX package's names, so that the
JAX package's ``load_pytree`` reads the file back.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np

FORMAT_TAG = "asr-tpu-v1"
SCHEMA_VERSION = 1

_RENAMES = {
    ("audio_sheet_retrieval_tpu.models.cca_model", "ModelParams"):
        ("audio_sheet_retrieval_tpu_torch.models.cca_model", "ModelParams"),
    ("audio_sheet_retrieval_tpu.ops.cca", "CCAState"):
        ("audio_sheet_retrieval_tpu_torch.ops.cca", "CCAState"),
}


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _RENAMES:
            module, name = _RENAMES[(module, name)]
        elif module.split(".")[0] in ("jax", "jaxlib",
                                      "audio_sheet_retrieval_tpu"):
            raise pickle.UnpicklingError(
                f"checkpoint holds {module}.{name}, which this package "
                f"cannot load without jax")
        return super().find_class(module, name)


def load_payload(path: str) -> Any:
    """Unpickle ``path`` with the JAX-free class mapping (latin1 for py2
    lasagne dumps, which hold only lists of numpy arrays)."""
    with open(path, "rb") as fp:
        return _PortUnpickler(fp, encoding="latin1").load()


def is_pytree_payload(payload: Any) -> bool:
    return isinstance(payload, dict) and payload.get("format") == FORMAT_TAG


def load_pytree(path: str) -> Any:
    """-> the numpy tree of an ``asr-tpu-v1`` checkpoint (the port's
    ``ModelParams`` / ``CCAState`` NamedTuples holding numpy arrays).
    ``models.lasagne_import.params_from_numpy`` turns it into modules."""
    return pytree_from_payload(load_payload(path), path)


def pytree_from_payload(payload: Any, path: str) -> Any:
    """The tree of an unpickled ``asr-tpu-v1`` payload, after the schema
    version check."""
    if not is_pytree_payload(payload):
        raise ValueError(f"{path} is not an {FORMAT_TAG} checkpoint")
    version = int(payload.get("version", 1))  # pre-"version" dumps are v1
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"{path} is schema v{version}, newer than this build's "
            f"v{SCHEMA_VERSION} — upgrade audio_sheet_retrieval_tpu_torch "
            f"to load it")
    return payload["tree"]


class _PortPickler(pickle._Pickler):
    """The pure-Python pickler, so that ``save_global`` can be overridden:
    this package's NamedTuple classes go out under the JAX package's names
    (the reverse of ``_RENAMES``), without importing that package."""

    def save_global(self, obj, name=None):
        target = _JAX_NAMES.get((getattr(obj, "__module__", None),
                                 getattr(obj, "__qualname__", None)))
        if target is None:
            return super().save_global(obj, name)
        self.save(target[0])
        self.save(target[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


_JAX_NAMES = {port: jax_name for jax_name, port in _RENAMES.items()}


def to_numpy_tree(tree: Any) -> Any:
    """Every tensor leaf of a tree of NamedTuples, dicts, lists and tuples
    as a numpy array (other leaves through ``np.asarray``)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> None:
    """Write ``tree`` (the unfolded parameter tree: ``ModelParams`` of
    ``{"blocks": [...]}`` views and a ``CCAState``) as an ``asr-tpu-v1``
    checkpoint that this package and the JAX package both load."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"format": FORMAT_TAG, "version": SCHEMA_VERSION,
               "tree": to_numpy_tree(tree), "meta": dict(meta or {})}
    with open(path, "wb") as fp:
        _PortPickler(fp, protocol=4).dump(payload)


def save_results(path: str, results: dict) -> None:
    """The per-epoch curves (``results_<tag>.pkl``, reference
    train_dcca_pool.py:476-489): a plain pickle of lists of floats and
    numpy arrays, as the JAX package writes it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fp:
        pickle.dump(results, fp, protocol=pickle.HIGHEST_PROTOCOL)


def load_results(path: str) -> dict:
    with open(path, "rb") as fp:
        return pickle.load(fp)
