"""Atomic checkpoints in the reference's on-disk layout.

Layout (one directory per step), as ``repro.checkpoint.ckpt`` writes it:
    <dir>/step_00000100.tmp-<nonce>/   -> written, fsync'd
    <dir>/step_00000100/               -> atomic rename on commit
        MANIFEST.json                  -> step, leaf paths, shapes, dtypes
        shard_0.npz                    -> every leaf, keyed a0, a1, ...

A state is a nested dict whose leaves are tensors, numpy arrays, or lists
of tensors (stacked along a new axis 0 as they are written); a tensor of
either may also be given as a function that returns it, called when its
leaf is written (``leaves`` gives the order: a rank's blocks gathered
whole one leaf at a time, ``train.step.save_state``).  Leaf paths join
the keys with "/" in sorted order, and bfloat16 is stored as its uint16
bits with the dtype named in the manifest (npz has no bfloat16).  The
npz is written a leaf at a time, as ``np.savez`` lays it out, so the host
holds one leaf, not the state.  ``restore`` returns the nested dict with
CPU tensors, bit for bit (``lazy``: functions that read one leaf each).
So a checkpoint written by either package restores in the other; the
trainer writes its state in the reference's tree
(``train.step.state_tree``).
"""
from __future__ import annotations

import json
import functools
import os
import shutil
import tempfile
import time
import zipfile
from typing import Any

import numpy as np
import torch


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array, bit for bit: bfloat16 as its uint16
    bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def leaves(tree: Any) -> dict[str, Any]:
    """The leaves of a state by path, in the order ``save`` writes them."""
    return _flatten(tree)


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    out[prefix[:-1]] = tree
    return out


def _unflatten(leaves: dict[str, Any]) -> Any:
    tree: dict[str, Any] = {}
    for path, v in leaves.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _as_numpy(v) -> tuple[np.ndarray, str]:
    """A leaf that is not a list as (numpy array as stored, dtype name of
    the manifest)."""
    if callable(v):
        v = v()
    if isinstance(v, torch.Tensor):
        return to_numpy(v), str(v.dtype).removeprefix("torch.")
    arr = np.asarray(v)
    name = str(arr.dtype)
    if name == "bfloat16":
        arr = arr.view(np.uint16)
    return arr, name


def _write_leaf(f, v) -> tuple[list, str]:
    """Write leaf ``v`` to ``f`` as ``np.save`` lays it out; (its shape,
    the manifest's dtype name).  A list is stacked along a new axis 0 one
    part at a time (the parts' bytes in order, after the stacked array's
    header), so the host holds one part, not the stack."""
    if not isinstance(v, (list, tuple)):
        arr, name = _as_numpy(v)
        np.lib.format.write_array(f, np.asanyarray(arr), allow_pickle=False)
        return list(arr.shape), name
    for i, part in enumerate(v):
        arr, name = _as_numpy(part)
        arr = np.ascontiguousarray(arr)
        if i == 0:
            first = (arr.shape, arr.dtype, name)
            np.lib.format.write_array_header_1_0(f, {
                "descr": np.lib.format.dtype_to_descr(arr.dtype),
                "fortran_order": False, "shape": (len(v), *arr.shape)})
        elif (arr.shape, arr.dtype, name) != first:
            raise ValueError(f"part {i} of a stacked leaf is {name} "
                             f"{arr.shape}, part 0 {first[2]} {first[0]}")
        f.write(memoryview(arr.reshape(-1).view(np.uint8)))
        del arr
    return [len(v), *first[0]], first[2]


def save(state: Any, directory: str, step: int) -> str:
    """Atomic checkpoint commit. Returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=directory)
    manifest = {"step": step, "time": time.time(), "leaves": {}}
    with zipfile.ZipFile(os.path.join(tmp, "shard_0.npz"), mode="w",
                         compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, (path, v) in enumerate(_flatten(state).items()):
            key = f"a{i}"
            with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                shape, dtype = _write_leaf(f, v)
            manifest["leaves"][path] = {
                "key": key, "shape": shape, "dtype": dtype}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _steps(directory: str) -> list[int]:
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and ".tmp-" not in d]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array (read fresh, so no copy is taken) as a CPU tensor;
    a 0-d leaf stays 0-d."""
    if dtype == "bfloat16":                     # its uint16 bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _read_leaf(npz: str, meta: dict) -> torch.Tensor:
    with np.load(npz) as data:
        return _tensor(data[meta["key"]], meta["dtype"])


def restore(directory: str, step: int | None = None,
            lazy: bool = False) -> tuple[Any, int]:
    """(state as a nested dict of CPU tensors, step); ``lazy``: each leaf
    a function that reads it, so a caller holds one leaf at a time."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    npz = os.path.join(path, "shard_0.npz")
    if lazy:
        leaves = {lpath: functools.partial(_read_leaf, npz, meta)
                  for lpath, meta in manifest["leaves"].items()}
        return _unflatten(leaves), manifest["step"]
    with np.load(npz) as data:
        leaves = {lpath: _tensor(data[meta["key"]], meta["dtype"])
                  for lpath, meta in manifest["leaves"].items()}
    return _unflatten(leaves), manifest["step"]


def garbage_collect(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    for s in sorted(_steps(directory))[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    # orphaned tmp dirs from crashed writers
    for d in os.listdir(directory):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
