"""Checkpointing with async save, atomic publish and auto-resume: the
reference's ``checkpoint/manager.py`` on one device.

The on-disk format is the reference's, so that either package restores the
other's checkpoints: ``step_XXXXXXXX/`` holds ``shard_0.npz`` (``leaf_{i}``,
leaves in the reference's flattening order: dicts by sorted key, tuples in
order) and ``manifest.json`` (``step``, ``num_leaves``, ``paths`` as the
reference's ``keystr``, ``shapes``, ``dtypes``, ``extra``, ``time``).  A save
copies the state to host numpy at once, then writes it from a background
thread into a temporary directory that is renamed into place, so a crash
mid-save leaves the previous checkpoint intact; ``keep`` newest are kept.
There is one shard and no resharding: the port runs on one device.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, tree_map, unflatten


def to_host(tree):
    """``tree`` with every leaf as a numpy array (tensors copied to the host,
    Python numbers through ``np.asarray``, as the reference's ``np.asarray``)."""

    def host(x):
        if torch.is_tensor(x):  # a copy: training goes on updating the tensors in place
            return x.detach().to("cpu", copy=True).numpy()
        return np.asarray(x)

    return tree_map(host, tree)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # ---- save ----
    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None) -> None:
        if self._thread is not None:
            self._thread.join()  # one in-flight save at a time
        host_state = to_host(state)

        def _write():
            tmp = Path(tempfile.mkdtemp(dir=self.dir))
            pairs = list(leaves_with_path(host_state))
            np.savez(tmp / "shard_0.npz", **{f"leaf_{i}": l for i, (_, l) in enumerate(pairs)})
            manifest = {
                "step": step,
                "num_leaves": len(pairs),
                "paths": [p for p, _ in pairs],
                "shapes": [list(np.shape(l)) for _, l in pairs],
                "dtypes": [str(np.asarray(l).dtype) for _, l in pairs],
                "extra": extra or {},
                "time": time.time(),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---- restore ----
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None):
        """``(tree of numpy arrays in the structure of state_like, manifest)``
        of ``step`` (default: the newest).  The manifest's paths must be
        ``state_like``'s, leaf for leaf."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        want = [p for p, _ in leaves_with_path(state_like)]
        if manifest["paths"] != want:
            raise ValueError(
                f"{d}: its leaves {manifest['paths'][:4]}... are not the state's {want[:4]}..."
            )
        with np.load(d / "shard_0.npz") as data:
            values = [data[f"leaf_{i}"] for i in range(manifest["num_leaves"])]
        return unflatten(state_like, values), manifest
