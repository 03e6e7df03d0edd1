"""Fault-tolerant checkpointing on npy files and a JSON manifest,
counterpart of ``repro/checkpoint/manager.py``.

  * one ``.npy`` file per leaf under a step directory; ``manifest.json``
    records each leaf's path in the tree (``params/layers/3/attn/wq``),
    its shape and its dtype. ``restore`` loads into the structure of a
    target tree and places each leaf on a device.
  * atomic commit: writes go to ``step_N.tmp``, then one rename; a crash
    mid-write never leaves a half-written ``step_N``.
  * ``save_async`` copies the tree to host memory before it returns (the
    train step updates the params in place right after) and writes on a
    thread, overlapping the next steps; a blocking ``save`` streams leaf
    by leaf, so host memory holds one leaf at a time.
  * keep-N garbage collection.
  * distributed: a DTensor leaf is gathered whole (``full_tensor``, a
    collective, so every rank calls ``save``) and only rank 0 writes;
    ``save`` and ``wait`` end in a barrier when there are several ranks.
    ``restore(..., shardings=)`` places each leaf onto its placements on
    the current mesh — the elastic restore onto any mesh shape.

numpy has no bfloat16 without ``ml_dtypes``, which the port does not
need: a bf16 leaf is stored as its uint16 bits, with ``bfloat16`` in the
manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..distributed.api import current_mesh


def _flatten(tree, prefix=""):
    """{"a/b/0/c": tensor} for a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _unflatten_like(tree, leaves, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}/{k}" if prefix
                                   else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _unflatten_like(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    return leaves[prefix]


def _at(tree, key):
    """The entry of ``tree`` at a flattened path ``a/b/0/c``."""
    for k in key.split("/"):
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The whole array of a leaf: a DTensor is gathered (collective)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _is_writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(t: torch.Tensor):
    """(array to save, dtype name) of a host tensor."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy(), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)  # np.load gives a writable C-order array
    if dtype == "bfloat16":
        return t.view(torch.bfloat16)
    want = getattr(torch, dtype)
    if t.dtype != want:
        raise ValueError(f"stored {t.dtype}, manifest says {dtype}")
    return t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = True):
        items = _flatten(tree)
        if blocking:
            self.wait()
            if _is_writer():
                self._write(step, items, copy=False)
            else:  # take part in the gathers rank 0 makes
                for t in items.values():
                    if isinstance(t, DTensor):
                        t.full_tensor()
            if _distributed():
                dist.barrier()
            return
        # snapshot to host memory now: the caller updates the tree in place
        host = {k: _whole(v).detach().to("cpu", copy=True)
                for k, v in items.items()
                if _is_writer() or isinstance(v, DTensor)}
        self.wait()  # one in-flight save at a time
        if not _is_writer():
            return
        self._thread = threading.Thread(
            target=self._write_safe, args=(step, host), daemon=True)
        self._thread.start()

    def save_async(self, step: int, tree: Any):
        self.save(step, tree, blocking=False)

    def _write_safe(self, step, host):
        try:
            self._write(step, host, copy=False)
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def _write(self, step: int, items, copy: bool):
        final = os.path.join(self.directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "arrays": {}}
        for i, (key, t) in enumerate(items.items()):
            host = _whole(t).detach().to("cpu", copy=copy)
            arr, dtype = _to_numpy(host)
            fname = f"arr_{i:06d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["arrays"][key] = {"file": fname,
                                       "shape": list(host.shape),
                                       "dtype": dtype}
            del host, arr
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _distributed():  # rank 0's write is on disk for every rank
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def restore(self, step: int, target_tree: Any, device=None,
                shardings: Any = None):
        """Load step ``step`` into the structure of ``target_tree`` (whose
        leaves give the expected shapes). With ``shardings`` (a tree of
        DTensor placements matching the target, e.g. from
        ``train.state_shardings``) each leaf lands on its placements on
        the current mesh, whatever mesh wrote it. Otherwise each leaf
        lands on ``device``, or on the device of the target's leaf when
        ``device`` is None."""
        mesh = current_mesh() if shardings is not None else None
        if shardings is not None and mesh is None:
            raise ValueError("restore(shardings=...) places leaves on the "
                             "current mesh: call it under use_mesh(mesh)")
        d = os.path.join(self.directory, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for key, ref in _flatten(target_tree).items():
            meta = manifest["arrays"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing array {key!r}")
            t = _from_numpy(np.load(os.path.join(d, meta["file"])),
                            meta["dtype"])
            if list(t.shape) != list(ref.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{tuple(t.shape)} vs target "
                                 f"{tuple(ref.shape)}")
            if mesh is not None:
                # every rank read the same file: each keeps its shard,
                # with no communication
                out[key] = distribute_tensor(
                    t.to(mesh.device_type), mesh,
                    tuple(_at(shardings, key)), src_data_rank=None)
            else:
                out[key] = t.to(device if device is not None
                                else ref.device)
        return _unflatten_like(target_tree, out)

    def restore_latest(self, target_tree: Any, device=None,
                       shardings: Any = None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, device, shardings)

    # -- gc -----------------------------------------------------------------

    def _gc(self):
        steps = sorted(
            name for name in os.listdir(self.directory)
            if name.startswith("step_") and not name.endswith(".tmp"))
        for name in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, name))
