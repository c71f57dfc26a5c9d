"""Fault-tolerant checkpointing: atomic tree save/restore and a manager.

The port of ``repro.ckpt.checkpoint``, in its file format, so a checkpoint
written by either package restores in the other bit for bit:

* a tree flattens to path-keyed arrays (``repro_torch.bridge.flatten``:
  ``main/layers/[0]/w``) in a single ``.npz``, plus a JSON sidecar
  ``<file>.meta.json`` holding ``{"meta", "n_leaves", "time"}``;
* bf16 is widened to f32 on save (exactly; npz has no bf16) and narrowed
  back to the ``like`` leaf's dtype on restore, onto its device;
* writes are atomic (a tmp file, then ``os.replace``), so a crash mid-write
  never corrupts the latest checkpoint;
* ``CheckpointManager`` keeps the last *k*, restores the newest valid one
  (skipping torn files), and can write on a worker thread: the tree is
  copied to the host on the caller's thread before it is queued, so the
  writer never sees a later update.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time
import zipfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import flatten
from repro_torch.tree import tree_flatten_with_path, tree_unflatten

PyTree = Any

#: what a torn or corrupt checkpoint file raises on read
_TORN = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def save_pytree(path: str, tree: PyTree, meta: Optional[dict] = None) -> None:
    """Atomic save of a tree of tensors or numpy arrays (+ metadata) to
    ``path`` (.npz)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = flatten(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    meta_path = path + ".meta.json"
    tmp_meta = meta_path + ".tmp"
    with open(tmp_meta, "w") as f:
        json.dump({"meta": meta or {}, "n_leaves": len(flat), "time": time.time()}, f)
    os.replace(tmp_meta, meta_path)


def restore_pytree(path: str, like: PyTree) -> PyTree:
    """Restore into the structure of ``like``: each leaf takes the dtype and
    device of ``like``'s leaf at its path."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    out = []
    for key, leaf in tree_flatten_with_path(like):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        out.append(torch.from_numpy(flat[key]).to(device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(like, out)


def read_meta(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)


class CheckpointManager:
    """keep-last-k checkpoints with resume-latest and async writes."""

    def __init__(self, directory: str, keep: int = 3, async_write: bool = False):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._worker: Optional[threading.Thread] = None
        if async_write:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:010d}.npz")

    def save(self, step: int, tree: PyTree, meta: Optional[dict] = None) -> None:
        meta = dict(meta or {}, step=step)
        if self._worker is not None:
            # snapshot off the device, and a copy: the caller may go on
            # updating the tree while the write is queued
            self._q.put((step, {k: np.array(v) for k, v in flatten(tree).items()}, meta))
        else:
            self._write(step, tree, meta)

    def _write(self, step: int, tree: PyTree, meta: dict) -> None:
        save_pytree(self._path(step), tree, meta)
        self._gc()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except Exception as e:  # kept for wait() to raise on the caller's thread
                self._error = e
            finally:
                self._q.task_done()

    def wait(self) -> None:
        """Block until every queued write is on disk; raise the first error
        a write met."""
        if self._worker is not None:
            self._q.join()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        """Finish the queued writes and stop the writer thread."""
        if self._worker is not None:
            self._q.put(None)
            self._worker.join()
            self._worker = None
        self.wait()

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            for suffix in ("", ".meta.json"):
                try:
                    os.remove(self._path(s) + suffix)
                except FileNotFoundError:
                    pass

    def steps(self):
        return sorted(int(fn[5:-4]) for fn in os.listdir(self.dir)
                      if fn.startswith("ckpt_") and fn.endswith(".npz"))

    def restore_latest(self, like: PyTree) -> Tuple[Optional[int], PyTree]:
        """Newest valid checkpoint (torn files skipped). (None, like) if none."""
        step, tree, _meta = self.restore_latest_with_meta(like)
        return step, tree

    def restore_latest_with_meta(self, like: PyTree) -> Tuple[Optional[int], PyTree, dict]:
        """Like ``restore_latest`` but also returns the saved user metadata
        (the ``meta`` dict passed to ``save``), so callers can resume
        non-parameter state: simulated clock, history, comm counters."""
        for step in reversed(self.steps()):
            path = self._path(step)
            try:
                tree = restore_pytree(path, like)
            except _TORN:
                continue  # torn/corrupt: fall back to an older one
            try:
                meta = read_meta(path).get("meta", {})
            except (OSError, ValueError):
                meta = {}  # params are valid even if the sidecar is torn
            return step, tree, meta
        return None, like, {}
