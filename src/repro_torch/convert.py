"""Carry parameters and decode caches between the JAX package and the port
as numpy arrays.

The JAX reference keeps parameters as a nested dict pytree; the port keeps a
flat ``{path: tensor}`` dict with ``/``-joined paths in the same leaf order.
Decode caches keep the reference's nesting in both: flat ``{"k", "v"}`` or
``{"conv", "ssm"}``, the moe family's grouped ``{"dense": {"k", "v"},
"moe": {"k", "v"}}``, the hybrid's ``{"mamba": {"conv", "ssm"}, "attn":
{"k", "v"}}`` and the vlm's ``{"self": {"k", "v"}, "xk", "xv"}``.
Nothing here imports JAX: pass ``jax.device_get(tree)`` (or any nested
dict of array-likes) in, and get nested numpy dicts out.  bfloat16 arrays
(numpy's ``ml_dtypes`` bfloat16) become ``torch.bfloat16`` tensors, and a
``torch.bfloat16`` tensor comes back as its raw words in a ``uint16`` array
(numpy has no bfloat16: ``.view(ml_dtypes.bfloat16)`` on the JAX side gives
the values, bit for bit).
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


def _tensor(arr: Any, device) -> torch.Tensor:
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree: Any, device: Optional[str | torch.device] = "cpu"
                    ) -> dict[str, torch.Tensor]:
    """Nested dict of arrays -> ``{path: tensor}`` on ``device`` (the
    parameter tree of every family: the hybrid's unstacked ``shared/...``,
    the vlm's ``blocks/self|cross/...`` with its (G,) gates, the audio
    front end's ``embed/{frame_proj, pos_embed, lm_head}`` carry across like
    the rest)."""
    flat: dict = {}
    _flatten(tree, "", flat)
    return {k: _tensor(flat[k], device) for k in sort_paths(flat)}


def cache_from_jax(cache: dict, device: Optional[str | torch.device] = "cpu") -> dict:
    """A reference decode cache (``init_cache`` / ``decode_step``'s) -> the
    port's: the same nested keys, shapes and dtypes."""
    return {k: cache_from_jax(v, device) if isinstance(v, dict) else _tensor(v, device)
            for k, v in cache.items()}


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict:
    """``{path: tensor}`` -> nested dict of numpy arrays (the JAX layout;
    a bfloat16 leaf as its ``uint16`` words)."""
    out: dict = {}
    for path, t in params.items():
        node = out
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        t = t.detach().cpu()
        node[leaf] = (t.view(torch.int16).numpy().view(np.uint16)
                      if t.dtype == torch.bfloat16 else t.numpy())
    return out
