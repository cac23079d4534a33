"""Fault-tolerant checkpointing: atomic and asynchronous.

* **Atomic**: a checkpoint is written to ``<dir>/tmp.step_N`` and renamed
  to ``<dir>/step_N`` only when complete, so a crash mid-save never
  corrupts the latest checkpoint (a leftover ``tmp.`` directory is not a
  step).
* **Async**: saves run on a writer thread; the train loop blocks only to
  copy the tensors to host memory, never on disk I/O.
* **One format with the reference** (``repro.checkpoint.manager``): a
  ``manifest.json`` (``step``, ``paths``, ``extra``, ``shapes``,
  ``dtypes``) beside an ``arrays.npz`` keyed ``a{i}``.  Leaf paths are the
  sorted-key ``/``-joined paths of :func:`repro_torch.optim.adamw.
  tree_leaves`, which are the names ``jax.tree_util.tree_flatten_with_path``
  gives the same nested dict, so a checkpoint written by either package's
  trainer restores into the other's.

Trees are nested dicts of tensors whose dtypes numpy has (the trainer's
fp32 params and moments).  ``extra`` carries the data-iterator step and
anything JSON-serialisable beside the arrays, so a restart reproduces
the exact token stream.

* **Elastic**: arrays are stored whole, so a checkpoint restores onto
  another layout: ``restore(devices=...)`` puts each leaf on the device
  its tree names (the reference's ``shardings``), and a run saved under
  one shard group resumes under another.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.optim.adamw import tree_leaves, tree_like


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).removeprefix("torch."))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_writes: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = None
        if async_writes:
            self._thread = threading.Thread(target=self._writer,
                                            daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             block: bool = False) -> None:
        """Copy the tree to host memory and enqueue the disk write (or
        write now, with ``block`` or without the writer thread).  The
        copy is taken before this returns, so the caller may update the
        tensors in place right after."""
        if self._err:
            raise RuntimeError("checkpoint writer failed") from self._err
        pairs = tree_leaves(tree)
        host = [leaf.detach().to("cpu", copy=True).numpy()
                for _, leaf in pairs]
        payload = (step, [p for p, _ in pairs], host, extra or {})
        if self._thread is None or block:
            self._write(payload)
        else:
            self._q.put(payload)

    def wait(self) -> None:
        """Block until every queued write is on disk; re-raise a writer
        failure."""
        if self._thread is not None:
            self._q.join()
        if self._err:
            raise RuntimeError("checkpoint writer failed") from self._err

    def _writer(self):
        while True:
            payload = self._q.get()
            try:
                self._write(payload)
            except BaseException as e:  # surfaced on next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, payload):
        step, paths, leaves, extra = payload
        tmp = os.path.join(self.dir, f"tmp.step_{step:08d}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": leaf for i, leaf in enumerate(leaves)})
        manifest = {"step": step, "paths": paths, "extra": extra,
                    "shapes": [list(x.shape) for x in leaves],
                    "dtypes": [str(x.dtype) for x in leaves]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                devices: Any = None) -> Tuple[Any, dict, int]:
        """Restore into the structure of ``template`` (a nested dict of
        tensors): each leaf of the checkpoint at ``step`` (default the
        latest) with the template leaf's shape, cast to its dtype, on the
        device ``devices`` names for it (a tree of the template's
        structure whose leaves are devices, or None for the template
        leaf's own device; ``devices=None`` keeps every leaf's).  A
        ``devices`` tree of another structure raises ValueError.
        Returns (tree, extra, step)."""
        pairs = tree_leaves(template)
        if devices is None:
            placed = [None] * len(pairs)
        else:
            dev_pairs = tree_leaves(devices)
            if [p for p, _ in dev_pairs] != [p for p, _ in pairs]:
                raise ValueError("the devices tree does not have the "
                                 "template's structure")
            placed = [d for _, d in dev_pairs]
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            by_path = {p: data[f"a{i}"]
                       for i, p in enumerate(manifest["paths"])}
        missing = [p for p, _ in pairs if p not in by_path]
        if missing:
            raise KeyError(f"checkpoint missing params: {missing[:5]}...")
        restored = []
        for (p, tmpl), dev in zip(pairs, placed):
            arr = by_path[p]
            if list(arr.shape) != list(tmpl.shape):
                raise ValueError(f"shape mismatch for {p}: "
                                 f"{arr.shape} vs {tuple(tmpl.shape)}")
            arr = arr.astype(_numpy_dtype(tmpl.dtype), copy=False)
            restored.append(torch.from_numpy(arr).to(
                tmpl.device if dev is None else torch.device(dev)))
        return tree_like(template, restored), manifest["extra"], step
