"""Fault-tolerant checkpointing of a train state.

Mirrors ``repro.checkpoint.ckpt``:
  * the state is flattened to key paths (a dict's keys, a list's indices,
    an ``nn.Module``'s state-dict names); leaves go into one ``.npz``;
  * atomic commit: write to ``step_XXXX.tmp/``, then rename, so a crash
    mid-save never corrupts the latest checkpoint;
  * async save: the leaves are copied to host numpy first, then a thread
    writes them while training goes on; a failure there is re-raised on
    the next ``save`` or ``wait``;
  * keep policy: retain the newest ``keep`` checkpoints.
Restore writes into the template's tensors, on their device and in their
dtype, and returns the template with its other leaves (ints, numpy
arrays) replaced. bf16 tensors are stored as fp32 (numpy has no bf16),
which is exact. Re-meshing on restore waits for sharding.
"""

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn


def _items(tree, prefix=""):
    """(key path, leaf) pairs of `tree`, depth first, dicts in key order."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _host(leaf) -> np.ndarray:
    """A host copy of `leaf` (always a copy: a CPU tensor's ``numpy()``
    shares its memory, and the train step updates it in place)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> dict:
    """{key path: host numpy copy} of every leaf of `tree`."""
    return {k: _host(v) for k, v in _items(tree)}


def save_pytree(tree, path: str):
    """Atomic save: <path>.tmp -> rename(<path>)."""
    _write(_flatten(tree), path)


def _write(keyed: dict, path: str):
    """Write flattened leaves to <path>.tmp, then rename it to <path>."""
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{str(i): v for i, v in enumerate(keyed.values())})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"keys": list(keyed.keys())}, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _restore_into(template, it):
    """`template` with each leaf taken from `it` in order: tensors written
    in place, other leaves replaced (cast to the template leaf's type)."""
    if isinstance(template, nn.Module):
        _restore_into(template.state_dict(), it)   # its tensors, written in place
        return template
    if isinstance(template, dict):
        return type(template)((k, _restore_into(v, it)) for k, v in template.items())
    if isinstance(template, (list, tuple)):
        return type(template)(_restore_into(v, it) for v in template)
    arr = next(it)
    if isinstance(template, torch.Tensor):
        with torch.no_grad():
            template.copy_(torch.from_numpy(arr).reshape(template.shape))
        return template
    if isinstance(template, np.ndarray):
        return arr.astype(template.dtype)
    if isinstance(template, (bool, int, float)):
        return type(template)(arr)
    return arr


def restore_pytree(template, path: str):
    """Restore the checkpoint at `path` into `template`'s structure."""
    with open(os.path.join(path, "manifest.json")) as f:
        keys = json.load(f)["keys"]
    want = [k for k, _ in _items(template)]
    if keys != want:
        diff = sorted(set(keys) ^ set(want))[:3]
        raise ValueError(f"checkpoint has {len(keys)} leaves, the template {len(want)}; "
                         f"keys in one and not the other: {diff}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = [z[str(i)] for i in range(len(z.files))]
    return _restore_into(template, iter(arrays))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # a failure on the async save thread is stashed here and re-raised
        # on the next save()/wait(): losing checkpoints silently would turn
        # a full disk into data loss found only at restore time
        self._error: Optional[BaseException] = None
        self.saves = 0           # committed checkpoints (post-rename)
        self.restores = 0

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def all_steps(self):
        steps = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                steps.append(int(d.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        s = self.all_steps()
        return s[-1] if s else None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def save(self, state: Any, step: int):
        host_state = _flatten(state)   # snapshot off the device
        if self.async_save:
            self.wait()              # re-raises a prior async failure
            self._thread = threading.Thread(
                target=self._save_async, args=(host_state, step), daemon=True)
            self._thread.start()
        else:
            self._save_sync(host_state, step)

    def _save_async(self, host_state, step):
        try:
            self._save_sync(host_state, step)
        except BaseException as e:     # surfaced at the next save()/wait()
            self._error = e

    def _save_sync(self, host_state, step):
        with self._lock:
            _write(host_state, self._step_dir(step))
            self._gc()
            self.saves += 1

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, template: Any, step: Optional[int] = None):
        """(the template with the checkpoint's leaves, step); the latest
        checkpoint unless `step` is given."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        out = restore_pytree(template, self._step_dir(step)), step
        self.restores += 1
        return out
