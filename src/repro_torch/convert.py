"""Carry parameters between the JAX package and the port as numpy arrays.

The JAX reference keeps parameters as a nested dict pytree; the port keeps a
flat ``{path: tensor}`` dict with ``/``-joined paths in the same leaf order.
Nothing here imports JAX: pass ``jax.device_get(params)`` (or any nested
dict of array-likes) in, and get nested numpy dicts out.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.api import sort_paths


def _flatten(tree: Any, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    else:
        out[prefix] = tree


def params_from_jax(tree: Any, device: Optional[str | torch.device] = "cpu"
                    ) -> dict[str, torch.Tensor]:
    """Nested dict of arrays -> ``{path: tensor}`` on ``device``."""
    flat: dict = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(flat[k], copy=True)).to(device)
            for k in sort_paths(flat)}


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict:
    """``{path: tensor}`` -> nested dict of numpy arrays (the JAX layout)."""
    out: dict = {}
    for path, t in params.items():
        node = out
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = t.detach().cpu().numpy()
    return out
