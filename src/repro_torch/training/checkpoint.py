"""Checkpointing with async save and restore onto any device.

Counterpart of ``repro/training/checkpoint.py``, with its on-disk layout
letter for letter, so that each package reads what the other wrote:

    step_000000123/
      MANIFEST.json   {"step", "metadata", "leaves": {key: {file, shape,
                      dtype}}}
      <flat-key>.npy  one file per leaf, the key's "/" written "__"
      COMMIT          written last: a step without it is torn and ignored

* atomic: a step is written to ``step_X.tmp/`` and moved to ``step_X/``
  with ``os.replace``; ``COMMIT`` lands after every array.
* async: ``save`` copies the tree to the host at once (a consistent
  snapshot; CUDA tensors never reach the writer), then writes on a thread
  so the train loop keeps stepping. ``wait()`` joins it and raises what
  the write raised.
* placement: leaves are stored whole; ``restore`` puts them on the device
  it is given (the reference's ``shardings=`` placement onto a mesh comes
  with the mesh modules, ROADMAP.md).
* bounded retention: ``keep_last`` prunes old steps.
* accounting: each committed save appends {step, bytes, write_seconds}
  to ``saves``, each restore {step, bytes, seconds} to ``restores``.

A tree is nested dicts (keys sorted), lists, tuples and NamedTuples
(fields in order) of torch tensors or numpy arrays, as the reference
walks its pytrees.
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

from repro_torch.core.device import DeviceLike

_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}{_SEP}"))
    else:
        out[prefix[: -len(_SEP)]] = tree
    return out


def _unflatten_into(proto, flat, prefix=""):
    """Rebuild a tree shaped like ``proto`` from the flat dict."""
    if isinstance(proto, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}{_SEP}")
                for k, v in proto.items()}
    if hasattr(proto, "_fields"):
        return type(proto)(*[
            _unflatten_into(getattr(proto, k), flat, f"{prefix}{k}{_SEP}")
            for k in proto._fields])
    if isinstance(proto, (list, tuple)):
        return type(proto)(
            _unflatten_into(v, flat, f"{prefix}{i}{_SEP}")
            for i, v in enumerate(proto))
    return flat[prefix[: -len(_SEP)]]


def _host(leaf) -> np.ndarray:
    """A host copy of a tensor leaf (a CPU tensor is cloned, so the train
    loop may update it in place while the writer runs); a numpy leaf is
    taken as it is, as the reference takes it."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return (leaf.cpu() if leaf.is_cuda else leaf.clone()).numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves, self.restores = [], []

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False,
             metadata: Optional[dict] = None):
        """Snapshot ``tree`` at ``step``. Non-blocking by default: the copy
        to the host happens now, the disk I/O on a writer thread. A numpy
        leaf is not copied: leave it unchanged until ``wait()``."""
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        self.wait()

        def _write():
            t1 = time.perf_counter()
            final = os.path.join(self.directory, f"step_{step:09d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
            for k, v in host.items():
                fname = k.replace(_SEP, "__") + ".npy"
                np.save(os.path.join(tmp, fname), v)
                manifest["leaves"][k] = {"file": fname, "shape": list(v.shape),
                                         "dtype": str(v.dtype)}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self.saves.append({
                "step": step, "bytes": sum(v.nbytes for v in host.values()),
                "write_seconds": time.perf_counter() - t1})
            self._prune()

        if blocking:
            _write()
            return

        def _run():
            try:
                _write()
            except Exception as e:  # handed to wait(), which raises it
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the writer thread; raise what the write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    def _prune(self):
        steps = self.list_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def list_steps(self):
        out = []
        for name in sorted(os.listdir(self.directory)):
            full = os.path.join(self.directory, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "COMMIT"))):
                out.append(int(name[5:]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, proto: Any, step: Optional[int] = None,
                device: DeviceLike = None):
        """Restore into the structure of ``proto`` (its leaves are not
        read) as torch tensors on ``device`` (default: the CPU), each with
        the dtype and shape the manifest records. Only the leaves that
        ``proto`` holds are read from disk. Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        device = torch.device("cpu" if device is None else device)
        t0 = time.perf_counter()
        flat = {}
        for k in _flatten(proto):
            info = manifest["leaves"][k]
            flat[k] = torch.from_numpy(
                np.load(os.path.join(d, info["file"]))).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.restores.append({
            "step": step, "bytes": sum(t.nbytes for t in flat.values()),
            "seconds": time.perf_counter() - t0})
        return _unflatten_into(proto, flat), step
