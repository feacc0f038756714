"""Checkpointing with async save and restore onto a device.

Counterpart of ``repro/checkpoint/manager.py``, writing the same layout:

  * every leaf of a nested tree (dicts, lists, tuples; dict keys in sorted
    order, as the reference's tree flattening takes them) is saved as
    ``<flat-key>.npy``, the keys of its path joined by ``__``, under
    ``<dir>/step_<N>.tmp/`` beside a ``manifest.json`` (each leaf's dtype
    and shape), then the directory is renamed atomically to ``step_<N>``:
    a crash mid-save never corrupts the latest checkpoint; ``keep_last``
    prunes the oldest;
  * a leaf is a torch tensor (on any device), a numpy array or a Python
    scalar; a None leaf is no leaf, as in the reference's trees;
  * ``restore`` reads into the structure of a target tree and puts each
    leaf on ``device`` (the target leaf's own device when omitted), as
    torch tensors;
  * ``AsyncCheckpointer`` copies every leaf to host memory before ``save``
    returns (a CPU tensor's ``.numpy()`` would share its memory, and the
    in-place optimizer changes it while the thread writes), then writes to
    disk on a background thread.

One deviation: a bfloat16 leaf is written as its uint16 bits with manifest
dtype ``"bfloat16"`` (numpy has no bfloat16, and the reference's writer
takes ``ml_dtypes``'), and read back as bfloat16.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "__"
BF16 = "bfloat16"


def _flatten(tree, prefix: Tuple = ()) -> Dict[str, Any]:
    """{flat key: leaf} in the reference's order (dict keys sorted, depth
    first); None leaves are left out."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        if tree is not None:
            out[_SEP.join(str(k) for k in prefix)] = tree
        return out
    for k, sub in items:
        out.update(_flatten(sub, prefix + (k,)))
    return out


def _unflatten(tree, flat: Dict[str, Any], prefix: Tuple = ()):
    """``tree``'s structure holding the leaves of ``flat``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, flat, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_unflatten(v, flat, prefix + (i,)) for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    if tree is None:
        return None
    return flat[_SEP.join(str(k) for k in prefix)]


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array (a copy for torch tensors) and its
    manifest dtype."""
    if isinstance(leaf, _HostLeaf):
        return leaf.arr, leaf.dtype
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str | Path, step: int, tree, *,
         keep_last: Optional[int] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {}
    for key, leaf in _flatten(tree).items():
        arr, dtype = _host(leaf)
        np.save(tmp / f"{key}.npy", arr)
        manifest[key] = {"dtype": dtype, "shape": list(arr.shape)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    if keep_last:
        steps = sorted(available_steps(ckpt_dir))
        for s in steps[:-keep_last]:
            shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)
    return final


def available_steps(ckpt_dir: str | Path) -> List[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                  if not p.name.endswith(".tmp"))


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, step: int, target_tree, *, device=None):
    """Restore into the structure of ``target_tree``: each leaf a torch
    tensor on ``device``, or, when omitted, on the target leaf's device
    (the CPU for a non-tensor target leaf)."""
    path = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    out = {}
    for key, target in _flatten(target_tree).items():
        arr = np.load(path / f"{key}.npy")
        if (manifest.get(key) or {}).get("dtype") == BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        dev = device if device is not None else (
            target.device if isinstance(target, torch.Tensor) else "cpu")
        out[key] = t.to(dev)
    return _unflatten(target_tree, out)


class _HostLeaf:
    """A leaf already copied to the host: its array and manifest dtype."""

    def __init__(self, leaf):
        self.arr, self.dtype = _host(leaf)


class AsyncCheckpointer:
    """Snapshot to host synchronously, persist on a background thread."""

    def __init__(self, ckpt_dir: str | Path, keep_last: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.saved_steps: List[int] = []

    def save(self, step: int, tree) -> None:
        self.wait()
        host_tree = _unflatten(tree, {k: _HostLeaf(v) for k, v in
                                      _flatten(tree).items()})

        def _write_all():
            save(self.ckpt_dir, step, host_tree, keep_last=self.keep_last)
            self.saved_steps.append(step)

        self._thread = threading.Thread(target=_write_all, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
