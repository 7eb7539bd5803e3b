"""Checkpointing: atomic, keep-k, in the JAX package's on-disk layout.

Layout:  <dir>/step_<N>/arrays_p0.npz + manifest.json, published by atomic
rename of a tmp directory — a reader never sees a partial checkpoint, and a
writer dying mid-save leaves the previous checkpoint intact. Leaves are
numbered in sorted-key order and named by their key path
(``['params']['conv0']['w']``), exactly as the reference names them, so a
checkpoint written by either package restores in the other.

Restore takes a *template* tree (the state itself will do): each leaf is
checked against the template's shape, cast to its dtype and placed on its
device.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from .tree import keystr, tree_leaves_with_path

PROCESS = 0   # one process; the file name keeps the reference's multi-host shape


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)

    arrays = {}
    manifest = {"step": step, "leaves": [], "process": PROCESS}
    for i, (path, leaf) in enumerate(tree_leaves_with_path(tree)):
        key = f"leaf_{i}"
        arrays[key] = _to_numpy(leaf)
        manifest["leaves"].append({"key": key, "path": keystr(path),
                                   "shape": list(arrays[key].shape),
                                   "dtype": str(arrays[key].dtype)})
    np.savez(os.path.join(tmp, f"arrays_p{PROCESS}.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                     # atomic publish
    _cleanup(ckpt_dir, keep)
    return final


def _cleanup(ckpt_dir: str, keep: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and ".tmp" not in name:
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, template: Any) -> Any:
    """Restore into the structure of ``template`` (a tree of tensors): shapes
    checked (ValueError), missing leaves refused (KeyError), dtypes and
    devices taken from the template."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(final, f"arrays_p{PROCESS}.npz")) as data:
        loaded = {m["path"]: data[m["key"]] for m in manifest["leaves"]}

    def build(t, path):
        if isinstance(t, dict):
            return {k: build(v, path + (k,)) for k, v in t.items()}
        key = keystr(path)
        if key not in loaded:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = loaded[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                             f"template {tuple(t.shape)}")
        return torch.from_numpy(np.array(arr)).to(dtype=t.dtype, device=t.device)

    return build(template, ())
