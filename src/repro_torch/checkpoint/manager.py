"""Fault-tolerant checkpointing: atomic, chunked into volumes, async
(counterpart of ``repro/checkpoint/manager.py``, with its on-disk layout).

Layout (one directory per step):

    ckpt_dir/
      step_00000100/
        meta.json            # leaf paths, shapes, dtypes, step, extra state, volume_of
        arrays_00.npz        # flat leaves, chunked into volumes
        COMMITTED            # sentinel written LAST (atomicity marker)
      step_00000200/ ...

The paths and leaf order are the reference's (dict keys sorted), so a
checkpoint written by either package restores in the other.

Crash-safety contract:
* a checkpoint is valid iff COMMITTED exists; restore() scans for the newest
  valid step and ignores torn writes;
* save writes into ``step_XXXXXXXX.tmp`` and renames it with ``os.replace``
  (atomic on POSIX), the sentinel last;
* async mode: the device→host copy happens synchronously (so a later in-place
  update cannot reach the saved values), the serialization and disk IO on a
  background thread; `wait()` joins before the next save or on exit;
* restore(target) refuses a checkpoint whose tree differs from ``target``'s
  and puts each leaf on the device of ``target``'s leaf.  Resharding onto a
  device mesh waits for the mesh slice.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from .._tree import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    dir: str
    keep_last: int = 3
    async_save: bool = True
    volume_mb: int = 256


def _paths_of(tree) -> list[str]:
    return ["/".join(str(k) for k in path) for path, _ in flatten(tree)]


def _to_host(x) -> np.ndarray:
    """A copy on the host: a CPU tensor's numpy view would see later updates."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: Optional[dict] = None):
        self.wait()
        flat = flatten(tree)
        host_leaves = [_to_host(x) for _, x in flat]
        meta = {
            "step": int(step),
            "paths": _paths_of(tree),
            "shapes": [list(x.shape) for x in host_leaves],
            "dtypes": [str(x.dtype) for x in host_leaves],
            "extra": extra or {},
        }
        if self.cfg.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_leaves, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host_leaves, meta)

    def _write(self, step: int, host_leaves, meta):
        try:
            final = os.path.join(self.cfg.dir, f"step_{step:08d}")
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            # chunk leaves into volumes by size
            budget = self.cfg.volume_mb * (1 << 20)
            vol, vol_bytes, vol_id, index = {}, 0, 0, []
            for i, arr in enumerate(host_leaves):
                vol[f"a{i}"] = arr
                index.append(vol_id)
                vol_bytes += arr.nbytes
                if vol_bytes >= budget:
                    np.savez(os.path.join(tmp, f"arrays_{vol_id:02d}.npz"), **vol)
                    vol, vol_bytes, vol_id = {}, 0, vol_id + 1
            if vol:
                np.savez(os.path.join(tmp, f"arrays_{vol_id:02d}.npz"), **vol)
            meta["volume_of"] = index
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            self._gc()
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.cfg.keep_last]:
            shutil.rmtree(os.path.join(self.cfg.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.cfg.dir):
            d = os.path.join(self.cfg.dir, name)
            if name.startswith("step_") and os.path.exists(os.path.join(d, "COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target, step: Optional[int] = None) -> tuple[Any, int, dict]:
        """target: the tree prototype (structure and devices).  -> (tree of
        tensors in the saved dtypes, step, extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.cfg.dir}")
        d = os.path.join(self.cfg.dir, f"step_{step:08d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        proto_paths = _paths_of(target)
        if proto_paths != meta["paths"]:
            raise ValueError("checkpoint tree structure mismatch: "
                             f"{set(meta['paths']) ^ set(proto_paths)}")
        vols: dict[int, Any] = {}
        host = []
        for i, vol_id in enumerate(meta["volume_of"]):
            if vol_id not in vols:
                vols[vol_id] = np.load(os.path.join(d, f"arrays_{vol_id:02d}.npz"))
            host.append(vols[vol_id][f"a{i}"])
        for vol in vols.values():
            vol.close()
        protos = [x for _, x in flatten(target)]
        leaves = [torch.as_tensor(a).to(p.device if isinstance(p, torch.Tensor) else "cpu")
                  for a, p in zip(host, protos)]
        return unflatten(target, leaves), step, meta.get("extra", {})
