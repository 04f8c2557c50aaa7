"""Checkpoints with atomic manifests, in the reference's layout.

Layout per step:
    <dir>/step_000000123/
        manifest.json        leaf names (``keystr`` paths), shapes, dtypes,
                             the saved mesh shape, save timestamp
        shard_00000.npz      the flat leaf arrays, ``leaf_<i>``
    <dir>/LATEST             atomic pointer file (rename-swapped)

  * Atomicity: a checkpoint becomes visible only when the LATEST pointer
    is renamed over it, after every file is fsync'd; a process killed
    mid-save never leaves a half-readable latest checkpoint.
  * Names: leaves are named as the reference names them, so a tree that
    the reference saves (nested dicts, or its TrainState) restores here,
    and the other way round.  bfloat16 leaves are stored as their 16-bit
    patterns (numpy has no bfloat16), their manifest dtype "bfloat16".
  * Placement: ``restore_checkpoint`` puts each leaf on the device the
    caller names (one device, or a tree of devices matching the tree), or
    where the matching leaf of ``tree_like`` lies.  The reference does the
    same through its ``shardings`` argument and a new mesh.
  * Snapshots: ``CheckpointManager.save`` copies every leaf to host memory
    before its thread starts.  The train step updates the parameters in
    place, and ``tensor.numpy()`` of a CPU tensor shares its memory, so a
    save without the copy could be torn by the next update.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.train.tree import leaves_with_paths, tree_map, tree_map_with_path


def _as_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array, manifest dtype) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy(), "bfloat16"
        a = t.cpu().numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def save_checkpoint(directory, step: int, tree, *, mesh_shape=None) -> Path:
    directory = Path(directory)
    tag = f"step_{step:09d}"
    tmp = directory / f".tmp_{tag}_{os.getpid()}"
    final = directory / tag
    tmp.mkdir(parents=True, exist_ok=True)

    names, arrays, dtypes = [], {}, []
    for i, (name, leaf) in enumerate(leaves_with_paths(tree)):
        a, dtype = _as_numpy(leaf)
        names.append(name)
        arrays[f"leaf_{i}"] = a
        dtypes.append(dtype)
    with open(tmp / "shard_00000.npz", "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "names": names,
        "shapes": [list(a.shape) for a in arrays.values()],
        "dtypes": dtypes,
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        # an epoch timestamp: when this was written
        "time": time.time(),
    }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)

    # atomic LATEST pointer
    ptr_tmp = directory / f".LATEST_{os.getpid()}"
    ptr_tmp.write_text(tag)
    os.replace(ptr_tmp, directory / "LATEST")
    return final


def latest_step(directory) -> int | None:
    ptr = Path(directory) / "LATEST"
    if not ptr.exists():
        return None
    tag = ptr.read_text().strip()
    if not (Path(directory) / tag / "manifest.json").exists():
        return None
    return int(tag.split("_")[1])


def _restored(arr: np.ndarray, dtype: str, like, device) -> torch.Tensor:
    arr = np.array(arr)  # an owned copy; ascontiguousarray would make 0-d 1-d
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        t = t.to(like.dtype)
        device = like.device if device is None else device
    return t.to("cpu" if device is None else device)


def restore_checkpoint(directory, tree_like, *, step: int | None = None, device=None):
    """Restore into the structure of ``tree_like``, each leaf found by its
    name, as a tensor (in the dtype of its leaf of ``tree_like`` where that
    is a tensor, else as saved) on ``device``: one device, a tree of devices
    matching ``tree_like``, or None for the device of each tensor leaf of
    ``tree_like`` (the CPU for other leaves).  Returns (tree, step)."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    tag = f"step_{step:09d}"
    manifest = json.loads((directory / tag / "manifest.json").read_text())
    index = {name: i for i, name in enumerate(manifest["names"])}
    with np.load(directory / tag / "shard_00000.npz") as data:
        def leaf(name, like, dev=None):
            if name not in index:
                raise KeyError(f"checkpoint {directory / tag} has no leaf {name}")
            i = index[name]
            return _restored(data[f"leaf_{i}"], manifest["dtypes"][i], like, dev)

        if device is None or isinstance(device, (str, torch.device)):
            tree = tree_map_with_path(lambda n, like: leaf(n, like, device), tree_like)
        else:
            tree = tree_map_with_path(leaf, tree_like, device)
    return tree, step


def _snapshot(leaf):
    """A host copy that no later in-place update can reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class CheckpointManager:
    """Periodic and preemption-triggered saves with a bounded retention set
    and asynchronous (thread-offloaded) writes."""

    def __init__(self, directory, *, every: int = 100, keep: int = 3,
                 async_save: bool = True):
        self.directory = Path(directory)
        self.every = every
        self.keep = keep
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        self.directory.mkdir(parents=True, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save(self, step: int, tree, *, blocking: bool = False):
        host_tree = tree_map(_snapshot, tree)  # copied before the thread starts

        def _do():
            save_checkpoint(self.directory, step, host_tree)
            self._gc()

        self.wait()
        if self.async_save and not blocking:
            self._pending = threading.Thread(target=_do, daemon=True)
            self._pending.start()
        else:
            _do()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, tree_like, device=None):
        self.wait()
        return restore_checkpoint(self.directory, tree_like, device=device)

    def _gc(self):
        tags = sorted(
            (p for p in self.directory.glob("step_*") if p.is_dir()),
            key=lambda p: p.name,
        )
        for p in tags[: -self.keep]:
            shutil.rmtree(p, ignore_errors=True)
