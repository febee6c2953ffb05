"""Resumable checkpoints of a fine-tuning run (port of
`udifftext_tpu/utils/ckpt_orbax.py`, as torch files).

One file `step_XXXXXXXX.pt` per save holds the whole engine state dict
(frozen parameters too: a resumed run draws a new seed, so what it does not
restore would differ), the AdamW state dict, the optimizer-step count and
the EMA of the trainable parameters (None without EMA). The file is written
under a temporary name, flushed to disk and renamed into place
(`os.replace`), so a crash mid-write leaves no file of the finished name:
`latest_checkpoint` and the keep quota count finished names only, and a
leftover temporary file is never resumed from nor pruned in place of a good
checkpoint.

`AsyncCheckpointWriter.save` copies the state to host memory before it
returns (AdamW then updates the parameters in place without touching the
copy) and writes the copy on a background thread; the next `save`, or
`close`, waits for that write and prunes to the `keep` newest.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch import nn

_STEP_RE = re.compile(r"^step_\d{8}\.pt$")


def checkpoint_name(step: int) -> str:
    return f"step_{int(step):08d}.pt"


def _finished(ckpt_dir: str) -> List[str]:
    return sorted(e for e in os.listdir(ckpt_dir) if _STEP_RE.match(e))


def _to_host(obj: Any) -> Any:
    """A copy of `obj` with every tensor copied to host memory (a GPU
    tensor's copy is complete when this returns)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def snapshot(engine: nn.Module, state) -> Dict[str, Any]:
    """The checkpoint's contents, on the host: {"engine", "optimizer",
    "step", "ema"}."""
    return {"engine": _to_host(engine.state_dict()),
            "optimizer": _to_host(state.optimizer.state_dict()),
            "step": int(state.step),
            "ema": None if state.ema is None else _to_host(state.ema)}


def _write(path: str, payload: Dict[str, Any]) -> None:
    """Write to a temporary name, flush to disk, then rename into place."""
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _prune(ckpt_dir: str, keep: int) -> None:
    for e in _finished(ckpt_dir)[:-keep] if keep > 0 else []:
        os.remove(os.path.join(ckpt_dir, e))


def save_checkpoint(ckpt_dir: str, engine: nn.Module, state, keep: int = 3) -> str:
    """Write a checkpoint of (engine, state) at state.step, durable on
    return, then prune to the `keep` newest."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, checkpoint_name(state.step))
    _write(path, snapshot(engine, state))
    _prune(ckpt_dir, keep)
    return path


class AsyncCheckpointWriter:
    """Checkpoint writes overlapped with training: `save` blocks for the
    host copy only (and for the previous write, if it is still running);
    the write runs on a background thread. A checkpoint is durable once the
    next `save` or `close` returns. `blocked_s` and `write_s` list, per
    save, the seconds `save` held the caller and the seconds its write took."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.keep = int(keep)
        self.blocked_s: List[float] = []
        self.write_s: List[float] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._closed = False

    def _finish(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err
        _prune(self.ckpt_dir, self.keep)

    def _run(self, path: str, payload: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        try:
            _write(path, payload)
        except Exception as e:  # re-raised on the caller's thread by _finish
            self._error = e
        self.write_s.append(time.perf_counter() - t0)

    def save(self, engine: nn.Module, state) -> str:
        if self._closed:
            raise RuntimeError("AsyncCheckpointWriter is closed")
        t0 = time.perf_counter()
        self._finish()  # one write in flight keeps host memory bounded
        path = os.path.join(self.ckpt_dir, checkpoint_name(state.step))
        payload = snapshot(engine, state)
        self._thread = threading.Thread(target=self._run, args=(path, payload),
                                        name="checkpoint-writer", daemon=True)
        self._thread.start()
        self.blocked_s.append(time.perf_counter() - t0)
        return path

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._finish()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest finished checkpoint in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    entries = _finished(ckpt_dir)
    return os.path.join(ckpt_dir, entries[-1]) if entries else None


def restore_checkpoint(path: str, engine: nn.Module, state) -> int:
    """Load a checkpoint into `engine` (strictly) and `state` (optimizer,
    step, EMA) in place, on their devices and dtypes; returns the step."""
    payload = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    engine.load_state_dict(payload["engine"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    if (state.ema is None) != (payload["ema"] is None):
        raise ValueError(f"{path}: EMA {'absent' if payload['ema'] is None else 'present'} in "
                         "the checkpoint, the run's use_ema says otherwise")
    if state.ema is not None:
        with torch.no_grad():
            for name, e in state.ema.items():
                e.copy_(payload["ema"][name])
    return state.step
