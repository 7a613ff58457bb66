"""Checkpoint and resume of the training state (the JAX package's
``utils/checkpoint.py``, on the same files).

The reference keeps its best-validation snapshot only in memory
(trainable.py:61,97,101-102).  Here the full early-stopping state (the
current and the best parameters, the optimizer state, the epoch, the
patience left, the least validation loss, the seed of the run's draws) is
written, so a stopped run resumes with the same numbers.

Format: one ``ckpt_%08d.npz`` per checkpoint holding every array under
``<group>|<key>|...`` (groups ``params``, ``opt``, ``best``; nested dicts
joined with ``|``) and a ``ckpt_%08d.json`` manifest for the scalars, each
written to a temporary file and renamed into place.  The parameter keys are
the parameter names, which equal the JAX package's, so either package
reads the other's ``params`` and ``best`` groups.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_SEP = "|"  # the key separator in the npz (parameter names may hold '/')


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of tensors, arrays and numbers as ``{path: array}``."""
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            flat.update(_flatten(v, key))
        return flat
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        *path, leaf = key.split(_SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def save_checkpoint(directory: str, step: int, *, params, opt_state=None,
                    meta: Optional[Dict[str, Any]] = None,
                    best_params=None, keep: int = 3) -> str:
    """Write checkpoint ``step``; returns its path.  Checkpoints beyond the
    last ``keep`` are removed."""
    os.makedirs(directory, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    for group, tree in (("params", params), ("opt", opt_state),
                        ("best", best_params)):
        if tree is not None:
            for k, v in _flatten(dict(tree)).items():
                arrays[f"{group}{_SEP}{k}"] = v
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)

    manifest = {"step": step, "meta": meta or {},
                "groups": sorted({k.split(_SEP, 1)[0] for k in arrays})}
    mpath = os.path.join(directory, f"ckpt_{step:08d}.json")
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)

    _prune(directory, keep)
    return path


def _prune(directory: str, keep: int) -> None:
    steps = all_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        for ext in (".npz", ".json"):
            try:
                os.remove(os.path.join(directory, f"ckpt_{s:08d}{ext}"))
            except FileNotFoundError:
                pass


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("ckpt_") and name.endswith(".npz"):
            try:
                out.append(int(name[5:-4]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None
                       ) -> Optional[Tuple[int, Dict[str, Any]]]:
    """Load checkpoint ``step`` (default: the latest).  Returns ``(step,
    {"params", "opt_state", "best_params", "meta"})`` with the groups as
    nested dicts of numpy arrays (None for a group not written), or None
    when the directory holds no checkpoint."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(directory, f"ckpt_{step:08d}.json")) as f:
        manifest = json.load(f)

    def group(name):
        if name not in manifest["groups"]:
            return None
        prefix = name + _SEP
        return _unflatten({k[len(prefix):]: v for k, v in arrays.items()
                           if k.startswith(prefix)})

    return step, {"params": group("params"), "opt_state": group("opt"),
                  "best_params": group("best"), "meta": manifest["meta"]}
