"""Weights carried across: a parameter tree of the JAX package, flattened to
numpy arrays, becomes the port's parameter tree on a device.

The flat form is the one ``repro.training.checkpoint`` writes: one array per
leaf under its ``"/"``-joined path (``"layers/mix/wq/w"``,
``"bneck_modes/0/down/w"``), with bf16 leaves either as ``ml_dtypes``
bfloat16 arrays or as their uint16 view plus the checkpoint's ``__meta__``
dtype table. Both packages keep the same tree (stacked ``[L, ...]`` layer
leaves for homogeneous archs, a tuple of per-layer trees for heterogeneous
ones such as recurrentgemma-2b, the mode bank as a tuple of heads; float32
leaves such as the RG-LRU's ``lam`` stay float32), so conversion is a
re-nesting plus a dtype-exact copy.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _tensor(arr: np.ndarray, bf16: bool, device) -> torch.Tensor:
    """One leaf, bit-exact. ``bf16``: the array holds bfloat16 values, as
    ``ml_dtypes`` bfloat16 or as their uint16 view."""
    arr = np.ascontiguousarray(arr)
    if bf16 or arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _tuples(node):
    """Dicts keyed "0".."n-1" (the JAX tree's tuples) become tuples."""
    if not isinstance(node, dict):
        return node
    node = {k: _tuples(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        idx = sorted(node, key=int)
        if [int(k) for k in idx] != list(range(len(idx))):
            raise ValueError(f"sparse tuple indices {idx}")
        return tuple(node[k] for k in idx)
    return node


def params_from_flat(flat: Mapping[str, np.ndarray], *, device="cuda",
                     dtypes: Optional[Mapping[str, str]] = None
                     ) -> Dict[str, Any]:
    """Nest ``{"a/b/c": array}`` into the port's parameter tree on
    ``device``. ``dtypes``: the checkpoint's ``{key: dtype name}`` table,
    which marks uint16 arrays that hold bfloat16 bits."""
    dtypes = dtypes or {}
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _tensor(np.asarray(arr),
                                  dtypes.get(key) == "bfloat16", device)
    return _tuples(root)


def load_npz(path: str, *, device="cuda") -> Dict[str, Any]:
    """A checkpoint ``.npz`` of the JAX package as the port's parameters."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {k: z[k] for k in z.files if k != "__meta__"}
    return params_from_flat(flat, device=device, dtypes=meta["dtypes"])
