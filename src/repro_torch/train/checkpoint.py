"""Checkpointing: atomic, keep-k, in the JAX package's on-disk layout.

Layout:  <dir>/step_<N>/arrays_p0.npz + manifest.json, published by atomic
rename of a tmp directory — a reader never sees a partial checkpoint, and a
writer dying mid-save leaves the previous checkpoint intact. Leaves are
numbered in the tree's order (dict keys sorted, sequences by index) and
named by their key path (``['params']['conv0']['w']``,
``['params']['tail'][0]['norm1']``), exactly as the reference names them,
so a checkpoint written by either package restores in the other.

Restore takes a *template* tree (the state itself will do): each leaf is
checked against the template's shape, cast to its dtype and placed on its
device.

Tensor parallelism: a tree with DTensor leaves (`dist.sharding.place`) is
saved whole: every rank calls `save`, each sharded leaf is gathered (a
collective), and rank 0 alone writes the reference's bytes. `restore`
places each leaf onto a mesh, as the reference's ``shardings=`` does: by
a tree of DTensor placements on the ambient mesh (``compute_mesh``), or by
the template's own DTensor layout; None (or a plain template leaf) keeps
it a whole tensor, replicated. The mesh need not be the one that wrote
the checkpoint (elastic restore).

bfloat16 leaves are stored as the reference stores them: numpy has no
bfloat16, and JAX's ``np.asarray`` of one is an ``ml_dtypes`` array that
``np.savez`` writes as 2-byte void records (header descr ``'<V2'``, the
manifest's dtype ``bfloat16``). The port writes the same bytes under the
same header, and reads such a leaf back by the manifest's dtype, bit for
bit. (The reference's own `restore` cannot read it back: ``astype`` of a
``|V2`` array to bfloat16 raises.)
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .tree import keystr, tree_leaves_with_path, tree_map, tree_map_with_path

PROCESS = 0   # one process; the file name keeps the reference's multi-host shape
BF16 = "bfloat16"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array and its manifest dtype; a bfloat16 tensor as
    its 16-bit patterns."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy(), BF16
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_npz(path: str, arrays: dict, bf16: set) -> None:
    """``np.savez(path, **arrays)``, member by member as numpy writes it
    (stored, zip64), with the keys in ``bf16`` (16-bit patterns) under the
    header an ``ml_dtypes.bfloat16`` array gets."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if key in bf16:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
                    fid.write(np.ascontiguousarray(arr).tobytes())
                else:
                    np.lib.format.write_array(fid, arr)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _has_dtensor(tree):
        import torch.distributed as dist
        from ..dist.sharding import gather
        tree = gather(tree)
        if dist.get_rank() != 0:
            return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)

    arrays, bf16 = {}, set()
    manifest = {"step": step, "leaves": [], "process": PROCESS}
    for i, (path, leaf) in enumerate(tree_leaves_with_path(tree)):
        key = f"leaf_{i}"
        arrays[key], dtype = _to_numpy(leaf)
        if dtype == BF16:
            bf16.add(key)
        manifest["leaves"].append({"key": key, "path": keystr(path),
                                   "shape": list(arrays[key].shape), "dtype": dtype})
    _write_npz(os.path.join(tmp, f"arrays_p{PROCESS}.npz"), arrays, bf16)
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


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored leaf as a tensor; 2-byte records the manifest calls
    bfloat16 as their bits."""
    if dtype == BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _has_dtensor(tree) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(x, DTensor) for _, x in tree_leaves_with_path(tree))


def restore(ckpt_dir: str, step: int, template: Any, *, shardings: Any = None) -> Any:
    """Restore into the structure of ``template`` (a tree of tensors): shapes
    checked (ValueError), missing leaves refused (KeyError), dtypes and
    devices taken from the template. ``shardings``: a tree like the
    template of DTensor placements on the ambient mesh
    (`dist.sharding.placements`), None entries whole; without it a
    DTensor template leaf gives its own layout."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(final, f"arrays_p{PROCESS}.npz")) as data:
        loaded = {m["path"]: (data[m["key"]], m["dtype"]) for m in manifest["leaves"]}

    def build(path, t):
        key = keystr(path)
        if key not in loaded:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr, dtype = loaded[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs "
                             f"template {tuple(t.shape)}")
        return _to_tensor(arr, dtype).to(dtype=t.dtype, device=t.device)

    out = tree_map_with_path(build, template)
    if shardings is None and not _has_dtensor(template):
        return out
    from torch.distributed.tensor import DTensor
    from ..dist.context import current_mesh
    from ..dist.sharding import _from_full

    def place(full, t, pl=None):
        if pl is not None:
            mesh = current_mesh()
            if getattr(mesh, "device_mesh", None) is None:
                raise ValueError("restore(shardings=...) places onto the ambient mesh: run it "
                                 "under compute_mesh(make_process_mesh(...))")
            return _from_full(full, mesh.device_mesh, pl)
        if shardings is None and isinstance(t, DTensor):
            return _from_full(full, t.device_mesh, t.placements)
        return full
    if shardings is None:
        return tree_map(place, out, template)
    return tree_map(place, out, template, shardings)
