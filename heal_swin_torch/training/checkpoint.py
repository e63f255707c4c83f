"""Checkpoint management: top-k by monitored metric + last + best (the port's
counterpart of ``heal_swin_tpu/training/checkpoint.py``).

Mirrors the reference's ModelCheckpoint behaviour (reference heal_swin/train.py:83-90,
231-235): save_top_k=3 on ``ckpt_metric``, save_last=True, filenames
``epoch={e}_{metric}={value:.4f}.ckpt``, the best copied to ``best.ckpt`` after fit.
Checkpoints embed run_id + experiment (reference logging_callbacks.py:195-200).

Format: one ``torch.save`` file a checkpoint, a dict of the model's ``state_dict``
(``"state_dict"``), the optimizer's (``"optimizer"``) and ``"meta"`` (epoch,
global_step, scheduler state, run id, metrics) -- tensors, containers and Python
scalars only, so that ``load_checkpoint`` reads it with ``weights_only=True``.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _plain(x):
    """A meta leaf with numpy and 0-d tensor scalars as Python scalars."""
    if isinstance(x, np.generic) or (isinstance(x, torch.Tensor) and x.ndim == 0):
        return x.item()
    return x


def _payload(model_state, optimizer_state, meta: Dict[str, Any]) -> dict:
    return {"state_dict": model_state, "optimizer": optimizer_state,
            "meta": _tree_map(_plain, meta)}


def _write(path, payload: dict):
    tmp = str(path) + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path, model_state, optimizer_state, meta: Dict[str, Any]):
    """Write a checkpoint now (tmp + rename), its tensors moved to the host."""
    host = _tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                     (model_state, optimizer_state))
    _write(path, _payload(*host, meta))


def load_checkpoint(path, map_location="cpu"):
    """Returns (model state_dict, optimizer state_dict, meta), read with
    ``weights_only=True``; the tensors on ``map_location``."""
    state = torch.load(path, map_location=map_location, weights_only=True)
    return state["state_dict"], state["optimizer"], state.get("meta", {})


def _link_or_copy(src: Path, dst: Path):
    """Hardlink dst to src's current inode (instant, no extra I/O); copy as a
    fallback for filesystems without hardlinks.  A later atomic os.replace of
    src swaps its directory entry only, so dst keeps the linked content."""
    dst = Path(dst)
    dst.unlink(missing_ok=True)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy(src, dst)


def _snapshot(tree):
    """A copy of every tensor of ``tree``, on its device and, for CUDA tensors, on the
    current (training) stream, so that the caller may go on updating the originals in
    place.  Returns (the copy, an event recorded after the copies, or None)."""
    tensors = [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]
    copy = _tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, tree)
    cuda = [t for t in tensors if t.is_cuda]
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cuda[0].device))
    return copy, event


def _pinned_copy(t):
    """``t`` copied into a pinned host buffer, ``non_blocking`` from the device (a copy
    to pageable memory blocks the calling thread, and with it the train loop's
    launches, for each tensor's transfer)."""
    if not isinstance(t, torch.Tensor):
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)


class CheckpointManager:
    """Top-k + last checkpointing, with asynchronous saves by default.

    ``save_epoch`` copies the state on the device, on the training stream (the caller
    may go on training immediately), and hands the copy to the host, the
    serialization and the write to a background thread, which copies into pinned host
    buffers on a stream of its own after the snapshot's event.  At most one save is in flight: a new save (or
    ``flush`` / ``finalize_best``) joins the previous one first, so the top-k
    bookkeeping stays ordered, and a failed save's error is raised by the next
    ``flush``.  The thread is non-daemon, so a pending write completes if the process
    ends mid-epoch (writes are tmp + rename either way).  ``flush_seconds`` sums the
    time callers waited on a save in flight, ``save_wait_seconds`` the part of it
    ``save_epoch`` waited (the train loop), ``save_seconds`` the saves' own time."""

    def __init__(self, ckpt_dir, monitor: str, mode: str = "max", save_top_k: int = 3,
                 async_save: bool = True):
        self.dir = Path(ckpt_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.async_save = async_save
        self.saved: List[tuple] = []  # (value, path)
        self.flush_seconds = 0.0  # waited on a save in flight, by any caller
        self.save_wait_seconds = 0.0  # of it, by save_epoch (the train loop)
        self.save_seconds = 0.0  # the saves' own time, host copy and write
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._streams = {}

    def _is_better(self, a, b):
        return a > b if self.mode == "max" else a < b

    def flush(self):
        """Wait for the in-flight save (if any); re-raise its error."""
        if self._pending is not None:
            t0 = time.perf_counter()
            self._pending.join()
            self.flush_seconds += time.perf_counter() - t0
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_epoch(self, epoch: int, metrics: Dict[str, float], model_state,
                   optimizer_state, meta: Dict[str, Any]):
        """Save last.ckpt always; save the epoch's checkpoint if it is in the top k of
        the monitored metric, as a hard link to last.ckpt's bytes."""
        meta = dict(meta, epoch=epoch, metrics=metrics)
        if not self.async_save:
            self._save_job(epoch, (model_state, optimizer_state), None, meta)
            return
        waited = self.flush_seconds
        self.flush()
        self.save_wait_seconds += self.flush_seconds - waited
        state, event = _snapshot((model_state, optimizer_state))
        self._pending = threading.Thread(
            target=self._save_job_guarded, args=(epoch, state, event, meta),
            name=f"ckpt-save-epoch-{epoch}", daemon=False,
        )
        self._pending.start()

    def _save_job_guarded(self, epoch, state, event, meta):
        try:
            self._save_job(epoch, state, event, meta)
        except BaseException as e:  # raised by the next flush()
            self._error = e

    def _to_host(self, state, event):
        if event is None:
            return _tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor)
                             else t, state)
        dev = next(t.device for t in _leaves(state)
                   if isinstance(t, torch.Tensor) and t.is_cuda)
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            host = _tree_map(_pinned_copy, state)
        stream.synchronize()
        return host

    def _save_job(self, epoch, state, event, meta):
        t0 = time.perf_counter()
        last = self.dir / "last.ckpt"
        _write(last, _payload(*self._to_host(state, event), meta))
        self.save_seconds += time.perf_counter() - t0

        value = meta["metrics"].get(self.monitor)
        if value is None:
            return
        fname = f"epoch={epoch}_{self.monitor}={value:.4f}.ckpt"
        if len(self.saved) < self.save_top_k or any(
            self._is_better(value, v) for v, _ in self.saved
        ):
            path = self.dir / fname
            _link_or_copy(last, path)
            self.saved.append((value, path))
            self.saved.sort(key=lambda t: t[0], reverse=(self.mode == "max"))
            while len(self.saved) > self.save_top_k:
                _, worst = self.saved.pop()
                worst.unlink(missing_ok=True)

    def finalize_best(self) -> Optional[Path]:
        """Copy the best checkpoint to best.ckpt (reference train.py:231-235)."""
        self.flush()
        if not self.saved:
            return None
        best = self.saved[0][1]
        if best.exists():
            _link_or_copy(best, self.dir / "best.ckpt")
            return self.dir / "best.ckpt"
        return None


_EPOCH_RE = re.compile(r"epoch=(\d+)_.*\.ckpt$")


def find_checkpoint(artifacts_dir, epoch: Optional[str] = "best",
                    epoch_number: Optional[str] = None) -> Path:
    """Resolve a checkpoint inside an artifacts dir by selector best/last/number
    (reference utils.check_and_get_ckpt_paths, utils.py:141-198)."""
    d = Path(artifacts_dir)
    candidates = list(d.glob("**/*.ckpt"))
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {d}")
    base = candidates[0].parent
    if epoch == "best":
        p = base / "best.ckpt"
        if p.exists():
            return p
        epoch = "last"
    if epoch == "last":
        p = base / "last.ckpt"
        if p.exists():
            return p
        raise FileNotFoundError(f"last.ckpt not found under {base}")
    if epoch == "number":
        for c in candidates:
            m = _EPOCH_RE.match(c.name)
            if m and m.group(1) == str(epoch_number):
                return c
        raise FileNotFoundError(f"epoch={epoch_number} checkpoint not found under {base}")
    raise ValueError(f"unknown epoch selector: {epoch}")
