"""Fault-tolerant checkpointing of trees of tensors.

The reference's contract, on torch tensors:
  * a checkpoint stores *logical* (whole) arrays in ``arrays.npz`` beside a
    JSON ``manifest.json``; a restore places them on any device;
  * writes are atomic: a tmp directory, ``os.replace`` onto
    ``step_XXXXXXXX``, the manifest written last, so a failure mid-save
    never corrupts the latest checkpoint;
  * an optional async save copies every tensor to the host *before* its
    writer thread starts, so the training loop may go on updating them;
  * retention keeps the newest ``keep`` checkpoints.

A tree is a tensor (or numpy array or scalar), or a dict, list, tuple or
``NamedTuple`` of trees; a leaf's key is its path joined with ``/``
(dict keys, list indices, tuple field names).  ``bfloat16`` tensors, which
numpy lacks, are stored as their 16-bit patterns and named in the
manifest's ``bfloat16`` list.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` in the tree's order (dict keys sorted, as a JAX
    pytree flattens them)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], join(k)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flatten(v, join(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, join(i)))
        return out
    return {prefix: tree}


def _unflatten(template, leaves: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with each leaf taken from ``leaves``."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, join(k)) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(v, leaves, join(k))
                                for k, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, join(i))
                              for i, v in enumerate(template))
    return leaves[prefix]


def _to_host(leaf) -> np.ndarray:
    """A leaf as numpy on the host (a copy, not a view of a tensor that
    may change); bfloat16 as its int16 bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Write ``tree`` as checkpoint ``step``: at once, or (async) on a
        thread after every leaf has been copied to the host."""
        flat = _flatten(tree)
        bf16 = sorted(k for k, v in flat.items()
                      if isinstance(v, torch.Tensor)
                      and v.dtype == torch.bfloat16)
        host = {k: _to_host(v) for k, v in flat.items()}
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, bf16, extra or {}))
            self._thread.start()
        else:
            self._write(step, host, bf16, extra or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, np.ndarray],
               bf16: List[str], extra: Dict):
        tmp = os.path.join(self.dir, f".tmp-{step}-{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        manifest = {"step": step, "time": time.time(), "extra": extra,
                    "keys": sorted(host), "bfloat16": bf16}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)          # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device: Optional[DeviceLike] = None):
        """``(tree, step)``: checkpoint ``step`` (the latest if None) in
        the structure of ``template``, as tensors of the stored dtypes on
        ``device`` (the CPU if None).  Raises ``FileNotFoundError`` when
        there is no checkpoint and ``KeyError`` for a key of ``template``
        the checkpoint lacks."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        bf16 = set(self.manifest(step).get("bfloat16", ()))
        path = os.path.join(self.dir, f"step_{step:08d}")
        leaves = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key in _flatten(template):
                if key not in data:
                    raise KeyError(f"checkpoint missing {key}")
                t = torch.from_numpy(data[key])
                if key in bf16:
                    t = t.view(torch.bfloat16)
                leaves[key] = t if device is None else t.to(device)
        return _unflatten(template, leaves), step

    def manifest(self, step: int) -> Dict:
        with open(os.path.join(self.dir, f"step_{step:08d}",
                               "manifest.json")) as f:
            return json.load(f)
