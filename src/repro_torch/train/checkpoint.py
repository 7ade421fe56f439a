"""Fault-tolerant checkpointing of tensor trees (the port's copy of the JAX
package's ``train/checkpoint.py``, without JAX).

  * atomic       — write to ``.tmp-<step>-<pid>-<ns>`` then rename; a crash
                   never leaves a half-written checkpoint visible.
  * verified     — the manifest carries each leaf's byte size and a digest;
                   restore validates before trusting a directory.
  * async        — ``save_async`` snapshots to host memory on the caller's
                   thread and writes on a worker; training continues while
                   bytes reach the disk.  Old steps are collected (``keep``).
  * auto-resume  — ``latest_step``/``restore_latest`` pick the newest *valid*
                   checkpoint, skipping corrupt or partial ones.

Each leaf is stored as its raw bytes with its dtype named in the manifest; a
bf16 leaf is stored as its 16-bit patterns (numpy has no bfloat16 here).
Re-laying a checkpoint out onto a mesh waits for the distributed slice
(ROADMAP item 5).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as tree_mod

# manifest dtype name -> (torch dtype, numpy dtype of the stored bytes)
_DTYPES = {"bfloat16": (torch.bfloat16, np.uint16),
           "float16": (torch.float16, np.float16),
           "float32": (torch.float32, np.float32),
           "float64": (torch.float64, np.float64),
           "int32": (torch.int32, np.int32),
           "int64": (torch.int64, np.int64)}
_NAMES = {t: name for name, (t, _n) in _DTYPES.items()}


def _named_leaves(tree) -> list[tuple[str, Any]]:
    return [("/".join(map(str, path)), leaf)
            for path, leaf in tree_mod.flatten_with_paths(tree)]


def _to_host(leaf: torch.Tensor) -> torch.Tensor:
    return leaf.detach().to("cpu", copy=True).contiguous()


def _raw(leaf: torch.Tensor) -> tuple[bytes, str]:
    name = _NAMES.get(leaf.dtype)
    if name is None:
        raise ValueError(f"checkpoint: unsupported dtype {leaf.dtype}")
    t = leaf.view(torch.int16) if leaf.dtype == torch.bfloat16 else leaf
    return t.numpy().tobytes(), name


def save(ckpt_dir: str | Path, step: int, tree: Any,
         extra_metadata: Optional[dict] = None) -> Path:
    """Synchronous atomic save; returns the final directory."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:010d}"
    tmp = ckpt_dir / f".tmp-{step}-{os.getpid()}-{time.time_ns()}"
    tmp.mkdir()
    manifest = {"step": step, "leaves": {}, "metadata": extra_metadata or {}}
    for name, leaf in _named_leaves(tree):
        raw, dtype = _raw(_to_host(leaf))
        fn = name.replace("/", "__") + ".bin"
        (tmp / fn).write_bytes(raw)
        manifest["leaves"][name] = {"file": fn, "shape": list(leaf.shape),
                                    "dtype": dtype, "bytes": len(raw)}
    blob = json.dumps(manifest, sort_keys=True).encode()
    manifest["digest"] = hashlib.sha256(blob).hexdigest()
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Snapshot on the caller's thread (host copy), write on a worker; keep
    the newest ``keep`` valid steps."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any, extra_metadata=None):
        self.wait()                       # one in flight at a time
        snapshot = tree_mod.map_tree(_to_host, tree)

        def work():
            try:
                save(self.ckpt_dir, step, snapshot, extra_metadata)
                self._gc()
            except BaseException as e:    # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        steps = sorted(valid_steps(self.ckpt_dir))
        for s in steps[: -self.keep]:
            shutil.rmtree(self.ckpt_dir / f"step_{s:010d}", ignore_errors=True)


def _valid(d: Path) -> bool:
    mf = d / "manifest.json"
    if not mf.exists():
        return False
    try:
        manifest = json.loads(mf.read_text())
        for info in manifest["leaves"].values():
            f = d / info["file"]
            if not f.exists() or f.stat().st_size < info["bytes"]:
                return False
        digest = manifest.pop("digest", None)
        blob = json.dumps(manifest, sort_keys=True).encode()
        return digest == hashlib.sha256(blob).hexdigest()
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return False


def valid_steps(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and _valid(d):
            out.append(int(d.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str | Path, step: int,
            target_tree: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``target_tree``; each leaf lands on its
    target leaf's device."""
    d = Path(ckpt_dir) / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    out = []
    for name, like in _named_leaves(target_tree):
        info = manifest["leaves"].get(name)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        if tuple(info["shape"]) != tuple(like.shape):
            raise ValueError(f"{name}: shape {tuple(info['shape'])} != "
                             f"{tuple(like.shape)}")
        tdt, ndt = _DTYPES[info["dtype"]]
        arr = np.frombuffer((d / info["file"]).read_bytes(), dtype=ndt)
        t = torch.from_numpy(arr.copy()).view(tdt).reshape(info["shape"])
        out.append(t.to(like.device))
    return tree_mod.unflatten(target_tree, out), manifest["metadata"]


def restore_latest(ckpt_dir, target_tree):
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    tree, meta = restore(ckpt_dir, step, target_tree)
    return step, tree, meta
