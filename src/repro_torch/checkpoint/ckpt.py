"""Flattened-tree .npz checkpoints with a JSON manifest, in the JAX
package's format: keys are '/'-joined dict paths, bf16 leaves are
widened to fp32 in the file, and the manifest rides next to the .npz.
A checkpoint or serving artifact written by either package loads in the
other.

``params_from_numpy`` carries a parameter tree across: it turns the JAX
package's tree (as numpy arrays) into the port's, leaf for leaf and with
the same keys. The port's parameter trees are plain nested dicts of
tensors with the JAX layout (stacked groups lead with ``(num_groups,)``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        elif v is not None:
            flat[key] = v
    return flat


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of the '/'-joined flattening for dict-only trees."""
    root: Dict[str, Any] = {}
    for key in sorted(flat):
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = flat[key]
    return root


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            # npz has no bf16 codec; widen losslessly to fp32.
            t = t.float()
        return t.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _to_tensor(arr, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        a = a.astype(np.float32)  # ml_dtypes bf16 has no torch bridge
    t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, *, device, dtype: Optional[torch.dtype] = None):
    """A nested tree of dicts and lists of arrays (numpy, or anything
    ``np.asarray`` takes) -> the same tree of tensors on ``device``: the
    LM trees of the serving slice and the Table-II trees
    (``{'base': [layer, ...], 'modular': [...]}``, e.g. the reference's
    ``init_client_model(PRNGKey(100 + k), cid)``) alike. ``dtype`` casts
    the floating leaves; integer leaves keep their type."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device=device, dtype=dtype)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device=device, dtype=dtype)
                          for v in tree)
    return _to_tensor(tree, device, dtype)


def manifest_path(path: str) -> str:
    """The JSON manifest that rides next to a checkpoint's .npz."""
    return (path[:-4] if path.endswith(".npz") else path) + ".json"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def load_extra(path: str) -> Dict[str, Any]:
    """The ``extra`` dict save_checkpoint recorded in the manifest."""
    with open(manifest_path(path)) as f:
        return json.load(f).get("extra", {})


def save_checkpoint(path: str, tree, *, step: Optional[int] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    np.savez(_npz_path(path), **flat)
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                 for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(manifest_path(path), "w") as f:
        json.dump(manifest, f, indent=1)


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """Every array of the checkpoint, by its '/'-joined key."""
    with np.load(_npz_path(path)) as npz:
        return dict(npz)


def load_checkpoint(path: str, template) -> Any:
    """Restore into the structure of ``template`` (shape-checked; each
    leaf takes the template leaf's dtype and device)."""
    flat = load_flat(path)

    def restore(t, prefix):
        out = {}
        for k, leaf in t.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(leaf, dict):
                out[k] = restore(leaf, key)
                continue
            arr = flat[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"template shape {tuple(leaf.shape)}")
            out[k] = _to_tensor(arr, leaf.device, leaf.dtype)
        return out

    return restore(template, "")
