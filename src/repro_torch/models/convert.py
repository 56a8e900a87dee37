"""Carry the reference's parameters into the port's ``LM``.

``params_from_jax(tree)`` takes the nested dict that the reference's
``LM.init_params`` (or ``EncDecLM.init_params``) returns, with every leaf
turned into a numpy array (``np.asarray``), and returns a state dict for
the port's ``load_state_dict``: paths joined with ".", and every leaf
stacked in the reference (``layers/...`` over periods, ``enc_layers/...``
and ``dec_layers/...`` over the encoder's and the decoder's layers) split
along axis 0 into ``<stack>.<i>....``; a vlm period's ``gate`` comes with
its layer.  A JAX
bfloat16 leaf arrives as a numpy array of the ``ml_dtypes`` bfloat16 type,
which ``torch.from_numpy`` rejects; it is recognised by its dtype's name and
reinterpreted bit for bit through uint16, so neither JAX nor ``ml_dtypes``
is imported here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


STACKED = ("layers", "enc_layers", "dec_layers")   # the reference's stacks


def to_tensor(a: Any) -> torch.Tensor:
    """A numpy (or ml_dtypes bfloat16) array as a CPU tensor, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves) -> the port's state
    dict (CPU tensors in the leaves' dtypes)."""
    state = {}
    for path, leaf in _flatten(tree).items():
        t = to_tensor(leaf)
        stack, _, rest = path.partition(".")
        if stack in STACKED:
            for i in range(t.shape[0]):
                state[f"{stack}.{i}.{rest}"] = t[i].clone()
        else:
            state[path] = t
    return state
