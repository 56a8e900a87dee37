"""Carry parameters between the reference's trees and the port's ``LM``.

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

``params_to_jax(state_dict)`` is the inverse: the reference's nested tree,
every ``<stack>.<i>....`` stacked back along a new axis 0 in ``i`` order,
leaves as CPU tensors in their own dtypes; ``to_numpy`` turns a leaf into
a numpy array, a bfloat16 one into its uint16 bits (the reference's
checkpoint stores bfloat16 so, and the JAX side views the bits as
``ml_dtypes.bfloat16``).  The same holds for any tree keyed like the
parameters, such as AdamW's ``m`` and ``v``, so whole train states carry
both ways.

``rank_state_dict(full, model)`` cuts whole parameters (the reference's
tree, or a port state dict) into the blocks that ``model``, one rank of a
(1, tp) mesh, holds by its ``Topo``'s pspecs, for its ``load_state_dict``
(``model.blocks()``: a slice a dim, or a list of indices where the block
is two runs, as a Mamba block's ``w_in``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


STACKED = ("layers", "enc_layers", "dec_layers")   # the reference's stacks


def to_tensor(a: Any) -> torch.Tensor:
    """A numpy (or ml_dtypes bfloat16) array as a CPU tensor, bit for bit;
    a tensor as it is, on the CPU."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array, bit for bit: bfloat16 as its uint16
    bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    """A nested dict's leaves by their keys joined with "."."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = value
    return out


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy leaves) -> the port's state
    dict (CPU tensors in the leaves' dtypes)."""
    state = {}
    for path, leaf in flatten(tree).items():
        t = to_tensor(leaf)
        stack, _, rest = path.partition(".")
        if stack in STACKED:
            for i in range(t.shape[0]):
                state[f"{stack}.{i}.{rest}"] = t[i].clone()
        else:
            state[path] = t
    return state


def params_to_jax(state_dict: dict[str, torch.Tensor],
                  stack: bool = True) -> dict:
    """The port's state dict (or one keyed like it) -> the reference's
    nested tree: ``<stack>.<i>.<rest>`` stacked along axis 0 at
    ``<stack>/<rest>`` in ``i`` order, every leaf a CPU tensor in its own
    dtype.  ``stack=False`` leaves a stacked leaf as the list of its
    per-layer tensors where they lie (no copy); a leaf that is not a
    tensor (a function that returns one, ``train.step.state_tree``) is
    kept as it is."""
    stacks: dict[str, dict[int, torch.Tensor]] = {}
    flat: dict[str, torch.Tensor] = {}
    for path, t in state_dict.items():
        head, _, rest = path.partition(".")
        if head in STACKED:
            i, _, leaf = rest.partition(".")
            stacks.setdefault(f"{head}.{leaf}", {})[int(i)] = t
        else:
            flat[path] = t
    for path, per in stacks.items():
        if sorted(per) != list(range(len(per))):
            raise ValueError(f"params_to_jax: {path} has layers "
                             f"{sorted(per)}, not 0..{len(per) - 1}")
        layers = [per[i].detach() if isinstance(per[i], torch.Tensor)
                  else per[i] for i in range(len(per))]
        flat[path] = torch.stack([t.cpu() for t in layers]) if stack \
            else layers
    tree: dict = {}
    for path, t in flat.items():
        parts = path.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.detach().cpu() if isinstance(t, torch.Tensor) \
            else t
    return tree


def rank_state_dict(full: dict, model) -> dict[str, torch.Tensor]:
    """Rank ``model``'s blocks of whole parameters: ``full`` is the
    reference's nested tree (numpy leaves, stacked over layers) or a port
    state dict; a leaf already on ``model``'s device is cut without a host
    copy."""
    if any(isinstance(v, dict) for v in full.values()):
        full = params_from_jax(full)
    return {name: (full[name] if isinstance(full[name], torch.Tensor)
                   else to_tensor(full[name]))[index]
            for name, index in model.blocks().items()}
