"""Parameter checkpoints in the JAX package's ``.npz`` layout (mirrors
``repro.training.checkpoint``), so each package reads the other's files:
one array a leaf under its ``"/"``-joined path (``"layers/mix/wq/w"``,
``"bneck_modes/0/down/w"``), bf16 leaves stored as their uint16 view, and
``__meta__``, the JSON of ``{"dtypes": {key: dtype name}, "meta": ...}``
as uint8 bytes. Every dtype crosses bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.convert import flat_tensors, leaf_tensor


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _host(t: torch.Tensor):
    """(array, dtype name) of one leaf: bf16 as its uint16 view."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(path: str, tree, metadata: Dict[str, Any] | None = None) -> None:
    """Write ``tree`` (nested dicts, lists, tuples of tensors on any
    device) to ``path`` with ``metadata`` under ``__meta__``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    store, dtypes = {}, {}
    for k, t in flat_tensors(tree).items():
        store[k], dtypes[k] = _host(t)
    store["__meta__"] = np.frombuffer(
        json.dumps({"dtypes": dtypes, "meta": metadata or {}}).encode(),
        dtype=np.uint8)
    np.savez(path, **store)


def restore(path: str, like):
    """The checkpoint's leaves in the structure of ``like`` (a template
    tree), each on its template leaf's device with the dtype the file
    stores. Raises ``KeyError`` for a leaf the file lacks and
    ``ValueError`` for one whose shape differs from the template's."""
    with np.load(_npz(path)) as z:
        dtypes = json.loads(bytes(z["__meta__"]).decode())["dtypes"]

        def build(node, key):
            if isinstance(node, dict):
                return {k: build(v, f"{key}/{k}" if key else str(k))
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(build(v, f"{key}/{i}" if key else str(i))
                                  for i, v in enumerate(node))
            if key not in z.files:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = z[key]
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(f"shape mismatch for {key!r}: "
                                 f"{arr.shape} vs {tuple(node.shape)}")
            return leaf_tensor(arr, dtypes.get(key) == "bfloat16", node.device)

        return build(like, "")


def load_metadata(path: str) -> Dict[str, Any]:
    with np.load(_npz(path)) as z:
        return json.loads(bytes(z["__meta__"]).decode())["meta"]
