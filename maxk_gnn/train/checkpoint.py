"""Checkpoint/resume — upgrade over the reference's minimal persistence.

The reference only does a final `torch.save` behind `--save_model`
(`maxk_gnn_integrated.py:325-332`) plus an unused `save_checkpoint` helper
(`utils/general_utils.py:101-106`) and declares-but-ignores an
`--evaluate PATH` flag. Here: save/restore of (params + opt_state + epoch
+ best metrics) as one `state.npz` of the flattened pytree per checkpoint
directory (`ckpt_<step>/`, `best/`), best-copy semantics, and a working
eval-only path.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import jax
import numpy as np

_FILE = "state.npz"


def _write(path: str, payload: Dict[str, Any]) -> str:
    flat, _ = jax.tree_util.tree_flatten_with_path(payload)
    arrays = {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _FILE), **arrays)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def save_checkpoint(
    directory: str,
    payload: Dict[str, Any],
    step: int,
    is_best: bool = False,
) -> str:
    """Save under `directory/ckpt_<step>`; mirror to `best/` when best
    (the reference's `best.pth.tar` copy semantics)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = _write(os.path.join(directory, f"ckpt_{step}"), payload)
    if is_best:
        best = os.path.join(directory, "best")
        if os.path.exists(best):
            shutil.rmtree(best)
        shutil.copytree(path, best)
    return path


def save_best(directory: str, payload: Dict[str, Any]) -> str:
    """Overwrite `directory/best` with the current payload — called on
    every val improvement, not just periodic-checkpoint boundaries (the
    reference's best.pth.tar copy done right)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    return _write(os.path.join(directory, "best"), payload)


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("ckpt_"):
            try:
                steps.append(int(d.split("_", 1)[1]))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(directory, f"ckpt_{max(steps)}")


def restore_checkpoint(path: str, template: Dict[str, Any]) -> Dict[str, Any]:
    """Restore a payload with the same pytree structure as `template`.
    Array leaves come back as device arrays, scalars as numpy scalars."""
    with np.load(os.path.join(os.path.abspath(path), _FILE)) as f:
        stored = {k: f[k] for k in f.files}
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    keys = [jax.tree_util.keystr(k) for k, _ in flat]
    missing = sorted(set(keys) - set(stored))
    if missing or len(keys) != len(stored):
        raise ValueError(
            f"checkpoint {path} does not match the model: missing "
            f"{missing[:5]}, {len(stored)} stored vs {len(keys)} expected"
        )
    leaves = []
    for (_, like), key in zip(flat, keys):
        a = stored[key]
        leaves.append(jax.numpy.asarray(a) if isinstance(like, jax.Array) else a)
    return jax.tree_util.tree_unflatten(treedef, leaves)
