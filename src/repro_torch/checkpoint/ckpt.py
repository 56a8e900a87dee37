"""Atomic checkpoints in the reference's on-disk layout.

Layout (one directory per step), as ``repro.checkpoint.ckpt`` writes it:
    <dir>/step_00000100.tmp-<nonce>/   -> written, fsync'd
    <dir>/step_00000100/               -> atomic rename on commit
        MANIFEST.json                  -> step, leaf paths, shapes, dtypes
        shard_0.npz                    -> every leaf, keyed a0, a1, ...

A state is a nested dict whose leaves are tensors, numpy arrays, or lists
of tensors (stacked along a new axis 0 as they are written); leaf paths
join the keys with "/" in sorted order, and bfloat16 is stored as its
uint16 bits with the dtype named in the manifest (npz has no bfloat16).
The npz is written a leaf at a time, as ``np.savez`` lays it out, so the
host holds one leaf, not the state.  ``restore`` returns the nested dict
with CPU tensors, bit for bit.  So a checkpoint written by either package
restores in the other; the trainer writes its state in the reference's
tree (``train.step.state_tree``).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.models.convert import to_numpy


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
    """A leaf as (numpy array as stored, dtype name of the manifest); a
    list of tensors is stacked along a new axis 0."""
    if isinstance(v, (list, tuple)):
        return np.stack([to_numpy(t) for t in v]), \
            str(v[0].dtype).removeprefix("torch.")
    if isinstance(v, torch.Tensor):
        return to_numpy(v), str(v.dtype).removeprefix("torch.")
    arr = np.asarray(v)
    name = str(arr.dtype)
    if name == "bfloat16":
        arr = arr.view(np.uint16)
    return arr, name


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
            arr, dtype = _as_numpy(v)
            key = f"a{i}"
            with zf.open(f"{key}.npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(arr),
                                          allow_pickle=False)
            manifest["leaves"][path] = {
                "key": key, "shape": list(arr.shape), "dtype": dtype}
            del arr
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


def restore(directory: str, step: int | None = None) -> tuple[Any, int]:
    """(state as a nested dict of CPU tensors, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    leaves = {}
    with np.load(os.path.join(path, "shard_0.npz")) as data:
        for lpath, meta in manifest["leaves"].items():
            arr = data[meta["key"]]             # a copy keeps 0-d leaves 0-d
            if meta["dtype"] == "bfloat16":     # its uint16 bits
                leaves[lpath] = torch.from_numpy(
                    arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                leaves[lpath] = torch.from_numpy(arr.copy())
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
