"""Fault-tolerant checkpointing (port of ``repro.ckpt.manager``), with the
reference's contract and its on-disk layout, so that a checkpoint either
package writes, the other restores:

* **Atomic commit** — a generation is written to ``step_<n>.tmp/`` and
  renamed to ``step_<n>/``; a ``LATEST`` pointer is then replaced
  atomically.  A crash mid-write never touches the latest generation.
* **Async save** — :meth:`save` copies the state to host memory before
  it returns (every device-to-host copy finished), then writes to disk on
  a thread; the next step may update the tensors in place meanwhile.
  :meth:`wait` joins the writer and re-raises what it raised.
* **Layout** — ``arrays.npz`` holds ``leaf_<i>`` in the order
  ``jax.tree_util`` flattens nested dicts (sorted keys), and
  ``manifest.json`` the leaves' key paths (``jax.tree_util.keystr``) and
  dtypes.  bfloat16 leaves are stored as uint16 views (npz has no
  bfloat16); nothing here needs ``ml_dtypes``.
* **Restore in place** — :meth:`restore` copies each leaf, read from the
  npz in turn, into the tensors of the tree it is given (``copy_``), so
  a restore needs no second copy of the state on the device, and the
  tensors that steps and the optimizer hold stay the ones they hold.
* **Generation GC** — keep the last ``keep`` generations.

A tree is nested dicts whose leaves are torch tensors,
:class:`repro_torch.convert.Stacked` (one tensor per layer, one stacked
``[L, ...]`` leaf on disk) or numpy arrays and scalars (restored as
numpy).  :func:`repro_torch.convert.train_state_layout` gives a train
state in this form, laid out as the reference's.
"""
from __future__ import annotations

import errno
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import Stacked
from repro_torch.layout import flatten


def _unflatten(tree, leaves: Iterator):
    out = dict(tree)
    for k in sorted(tree):
        out[k] = _unflatten(tree[k], leaves) if isinstance(tree[k], dict) else next(leaves)
    return out


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host copy to write, and its dtype's name in the manifest."""
    if isinstance(leaf, (torch.Tensor, Stacked)):
        t = leaf.host() if isinstance(leaf, Stacked) else leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_disk(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # one dict per save and restore: step, bytes and seconds
        self.events: List[Dict[str, Any]] = []

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = False):
        """Snapshot to host memory synchronously, write to disk async.

        Raises ``OSError`` (ENOSPC) before writing when the directory's
        file system has less room than the generation needs: the older
        generations stay until this one is committed."""
        self.wait()
        t0 = time.perf_counter()
        flat = flatten(state)
        host = [_host(leaf) for _, leaf in flat]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        paths = [p for p, _ in flat]
        nbytes = sum(arr.nbytes for arr, _ in host)
        event = {"op": "save", "step": step, "bytes": nbytes,
                 "snapshot_s": time.perf_counter() - t0}
        self.events.append(event)
        free = shutil.disk_usage(self.dir).free
        if nbytes + (16 << 20) > free:
            raise OSError(errno.ENOSPC, f"checkpoint step {step} needs {nbytes} bytes; "
                          f"{free} free in {self.dir}")

        def write():
            t1 = time.perf_counter()
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            arrays = {f"leaf_{i}": arr for i, (arr, _) in enumerate(host)}
            meta = [{"path": path, "dtype": dtype} for path, (_, dtype) in zip(paths, host)]
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "leaves": meta}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(os.path.join(self.dir, "LATEST.tmp"), "w") as f:
                f.write(str(step))
            os.replace(os.path.join(self.dir, "LATEST.tmp"), os.path.join(self.dir, "LATEST"))
            self._gc()
            event["write_s"] = time.perf_counter() - t1

        def guarded():
            try:
                write()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()

    def wait(self):
        """Join the writer of the last save, and re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        # Join any in-flight async save first: a restart decision taken
        # while the writer thread is mid-generation would otherwise miss
        # the newest checkpoint and replay from a stale (or zero) step.
        self.wait()
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip())

    def paths(self, step: Optional[int] = None) -> List[str]:
        """The key paths of a generation's leaves, from its manifest."""
        return [m["path"] for m in self._manifest(step)[1]["leaves"]]

    def _manifest(self, step):
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        final = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(final, "manifest.json")) as f:
            return final, json.load(f)

    @torch.no_grad()
    def restore(self, like: Any, step: Optional[int] = None):
        """Restore into ``like``: its tensor leaves in place, leaf by leaf.
        Returns a tree shaped as ``like``, holding its tensors and, at its
        other leaves, the checkpoint's numpy arrays.  Raises ``ValueError``
        when the generation's key paths, shapes or dtypes are not
        ``like``'s."""
        t0 = time.perf_counter()
        final, manifest = self._manifest(step)
        flat = flatten(like)
        want = [p for p, _ in flat]
        got = [m["path"] for m in manifest["leaves"]]
        if got != want:
            missing = sorted(set(want) - set(got))[:4]
            extra = sorted(set(got) - set(want))[:4]
            raise ValueError(f"checkpoint/tree structure mismatch in {final}: "
                             f"{len(got)} leaves for {len(want)}; missing {missing}, extra {extra}")
        out, nbytes = [], 0
        with np.load(os.path.join(final, "arrays.npz")) as data:
            for i, ((path, leaf), meta) in enumerate(zip(flat, manifest["leaves"])):
                arr = data[f"leaf_{i}"]
                nbytes += arr.nbytes
                if not isinstance(leaf, (torch.Tensor, Stacked)):
                    out.append(arr if meta["dtype"] != "bfloat16"
                               else _from_disk(arr, meta["dtype"]))
                    continue
                t = _from_disk(arr, meta["dtype"])
                if tuple(t.shape) != tuple(leaf.shape) or t.dtype != leaf.dtype:
                    raise ValueError(f"checkpoint leaf {path}: {meta['dtype']}{list(t.shape)} "
                                     f"for {leaf.dtype}{list(leaf.shape)}")
                if isinstance(leaf, Stacked):
                    leaf.load_(t)
                else:
                    leaf.copy_(t)
                out.append(leaf)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.events.append({"op": "restore", "step": manifest["step"], "bytes": nbytes,
                            "s": time.perf_counter() - t0})
        return _unflatten(like, iter(out))

    # ------------------------------------------------------------------
    def _gc(self):
        steps = sorted(
            int(d.split("_", 1)[1])
            for d in os.listdir(self.dir)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
