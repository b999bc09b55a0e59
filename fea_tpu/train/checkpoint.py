"""Checkpoints as one `.npz` of a flattened pytree.

Every leaf is stored under its key path joined with '/', e.g.
`params/encoder/initial_conv/kernel` or `opt_states/decoder/1/0/mu/...`.
A checkpoint is a directory `model-<milestone>/` holding
`checkpoint.npz`, so resume, the zip artifact and the app runner all
address it by directory.
"""

import os
from pathlib import Path
from typing import Any, Dict

import jax
import numpy as np

FILENAME = "checkpoint.npz"


def _key_str(key) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(key, attr):
            return str(getattr(key, attr))
    raise TypeError(f"unsupported pytree key {key!r}")


def flatten(tree) -> Dict[str, Any]:
    """{'a/b/c': leaf} for every leaf of `tree`."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(_key_str(k) for k in path): leaf for path, leaf in leaves}


def unflatten(flat: Dict[str, Any]) -> Dict:
    """Nested dicts from '/'-joined key paths (sequence nodes come back
    as dicts keyed by their index)."""
    root: Dict = {}
    for path, value in flat.items():
        node = root
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return root


def save(directory, tree) -> Path:
    """Write `tree` (host values) to `<directory>/checkpoint.npz`
    atomically: a reader never sees a half-written file."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = {k: np.asarray(v) for k, v in flatten(jax.device_get(tree)).items()}
    path = directory / FILENAME
    tmp = directory / (FILENAME + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_flat(directory, prefixes=None) -> Dict[str, np.ndarray]:
    """All stored leaves, or only those whose key starts with one of
    `prefixes` (e.g. ("params/",) skips the optimizer state)."""
    with np.load(Path(directory) / FILENAME) as data:
        keys = [
            k for k in data.files
            if prefixes is None or k.startswith(tuple(prefixes))
        ]
        return {k: data[k] for k in keys}


def restore(template, flat: Dict[str, np.ndarray]):
    """Fill `template`'s structure with the stored leaves. Keys the
    template does not have are ignored; a missing key or a shape that
    differs raises ValueError."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for path, leaf in leaves:
        key = "/".join(_key_str(k) for k in path)
        if key not in flat:
            raise ValueError(f"checkpoint has no entry {key!r}")
        value = flat[key]
        if np.shape(value) != np.shape(leaf):
            raise ValueError(
                f"checkpoint entry {key!r} has shape {np.shape(value)}, "
                f"expected {np.shape(leaf)}"
            )
        out.append(value)
    return jax.tree_util.tree_unflatten(treedef, out)
