"""Checkpointing: atomic, async, restartable. Port of
``repro/ckpt/checkpoint.py``, on the same on-disk layout, so each package
restores the other's checkpoints:

    <dir>/step_<8 digits>/
        manifest.json   — {"step": n, "keys": [{"key", "file", "shape",
                           "dtype"[, "raw"]}, ...]}
        <key>.npy       — one array a leaf, "/" in the key as "__"

Keys are the leaves' paths as JAX's ``tree_flatten_with_path`` names them
("params/layers/attn/wq", "opt/m/...", "opt/count", "step": dict keys in
sorted order). A dtype numpy lacks (bfloat16) is stored as its raw bytes,
``uint8``, with its name in ``dtype`` and ``"raw": true``; torch tensors
reach numpy through an integer view of the same width, so no
``ml_dtypes`` is needed.

* Atomicity: written to ``step_<n>.tmp`` then renamed — a crash mid-save
  never corrupts the latest checkpoint; ``keep`` bounds how many stay.
* Async: ``AsyncCheckpointer`` copies the state to host memory on the
  caller's thread, then writes on a background thread. It must copy: the
  optimizer updates params and moments in place while the writer runs,
  and ``.cpu()`` of a CPU tensor is the tensor itself.
* Restore: into the structure of a target tree, each leaf cast to the
  target leaf's dtype and put on its device; with ``shardings`` (a tree
  of DTensor placements) and ``mesh``, each leaf becomes a DTensor on that
  mesh (elastic rescale: the checkpoint is mesh-agnostic, so any mesh can
  take it). Every rank reads the whole file and keeps its own block: no
  collective runs.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

#: dtypes numpy lacks, stored as raw bytes: name -> (torch dtype, the
#: integer view of the same width)
_RAW = {"bfloat16": (torch.bfloat16, torch.int16)}


def _flatten(tree: Any, prefix: tuple = ()) -> dict[str, Any]:
    """{path: leaf} in the order and with the names of JAX's
    ``tree_flatten_with_path`` (dict keys sorted, sequences by index)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {"/".join(prefix): tree}
    out = {}
    for name, sub in items:
        out.update(_flatten(sub, prefix + (name,)))
    return out


def _host(leaf: Any) -> tuple[np.ndarray, Optional[str]]:
    """(numpy array, the raw dtype's name or None) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        for name, (dt, view) in _RAW.items():
            if t.dtype == dt:
                return t.view(view).numpy(), name
        return t.numpy(), None
    return np.asarray(leaf), None


def save_checkpoint(state: Any, directory: str, step: int,
                    *, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the final path."""
    base = pathlib.Path(directory)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "keys": []}
    for key, leaf in _flatten(state).items():
        arr, raw = _host(leaf)
        fname = key.replace("/", "__") + ".npy"
        entry = {"key": key, "file": fname, "shape": list(arr.shape),
                 "dtype": raw or str(arr.dtype)}
        if raw:
            np.save(tmp / fname,
                    np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
            entry["raw"] = True
        else:
            np.save(tmp / fname, arr)
        manifest["keys"].append(entry)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _cleanup(base, keep)
    return str(final)


def _cleanup(base: pathlib.Path, keep: int) -> None:
    steps = sorted(
        (p for p in base.iterdir() if re.fullmatch(r"step_\d{8}", p.name)),
        key=lambda p: p.name,
    )
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    base = pathlib.Path(directory)
    if not base.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in base.iterdir()
        if re.fullmatch(r"step_\d{8}", p.name)
    ]
    return max(steps) if steps else None


def _load(path: pathlib.Path, entry: dict) -> torch.Tensor:
    arr = np.load(path / entry["file"])
    if entry.get("raw"):
        if entry["dtype"] not in _RAW:
            raise ValueError(f"{entry['key']}: no torch dtype for raw "
                             f"{entry['dtype']}")
        dt, view = _RAW[entry["dtype"]]
        ints = torch.from_numpy(arr).view(view)
        return ints.reshape(entry["shape"]).view(dt)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, step: int, target: Any, *,
                       shardings: Any = None, mesh: Any = None) -> Any:
    """The checkpoint of ``step`` in the structure of ``target`` (a tree of
    tensors, or ``meta`` stand-ins: each leaf restored in its dtype, on its
    device). ``shardings`` (a tree like ``target``; leaves DTensor
    placements, or None for a plain tensor) re-places each leaf on
    ``mesh``, on the mesh's device type."""
    from repro_torch.runtime.sharding import from_full

    if shardings is not None and mesh is None:
        raise ValueError("restoring with shardings needs the mesh they are on")
    path = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    by_key = {e["key"]: e for e in manifest["keys"]}

    def build(tree: Any, sh: Any, prefix: tuple) -> Any:
        if isinstance(tree, dict):
            return {k: build(tree[k], None if sh is None else sh[k],
                             prefix + (str(k),)) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, None if sh is None else sh[i],
                                    prefix + (str(i),))
                              for i, v in enumerate(tree))
        key = "/".join(prefix)
        t = _load(path, by_key[key])
        if tuple(t.shape) != tuple(tree.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(t.shape)} vs "
                             f"{tuple(tree.shape)}")
        if sh is None:
            device = (torch.device(mesh.device_type)
                      if mesh is not None and tree.device.type == "meta"
                      else tree.device)
            return t.to(device=device, dtype=tree.dtype)
        return from_full(t.to(tree.dtype), mesh, sh, device=mesh.device_type)

    return build(target, shardings, ())


class AsyncCheckpointer:
    """Copy to the host on the caller's thread, write on a background
    thread; one save in flight at a time."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        #: (step, seconds of the host copy on the caller's thread, seconds
        #: of the write on the background thread) of each save
        self.times: list[tuple[int, float, float]] = []

    def save(self, state: Any, step: int) -> None:
        self.wait()
        t0 = time.perf_counter()
        host_state = {key: (leaf.detach().to("cpu", copy=True)
                            if isinstance(leaf, torch.Tensor)
                            else np.array(leaf))
                      for key, leaf in _flatten(state).items()}
        copy_s = time.perf_counter() - t0

        def write():
            t1 = time.perf_counter()
            try:
                save_checkpoint(host_state, self.directory, step,
                                keep=self.keep)
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e
            self.times.append((step, copy_s, time.perf_counter() - t1))

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
