"""Serving: request micro-batching around the predictor (port of
`udifftext_tpu/serving.py`).

The model side is injected as a callable, so the scheduling logic runs and
is tested on any host with stub predictors.

- ``MicroBatcher``: a deadline-based request coalescer. A single dispatcher
  thread drains up to ``max_batch`` queued requests (waiting at most
  ``max_delay_ms`` after the first) and hands the group to ``run_batch``.
  With ``finalize`` the call is split into a launch on the dispatcher thread
  and a finalize on a completion thread, up to ``pipeline_depth`` groups in
  flight; results still resolve in dispatch order.
- ``InpaintService``: builds one uint8 batch row per request on the
  caller's thread (so a bad request fails alone), pads each group to the
  smallest ``batch_buckets`` entry that fits it by repeating the last row,
  runs the predictor and slices the real rows back out.

Three faults of the JAX package's batcher are not carried over:
- the in-flight slot is taken before a group closes, so requests that
  arrive while the pipeline is full still join the waiting group (the JAX
  dispatcher closes the group first, then waits for a slot);
- the completion thread's stop marker is queued by the dispatcher itself
  after its last launch, so it cannot overtake a group launched late, and
  a shutdown whose timeout expires fails every request still in flight
  instead of leaving its caller waiting;
- a future is marked running when its request is dispatched and skipped if
  the caller cancelled it, so a cancelled future cannot kill the
  completion thread.

Launch and finalize on CUDA: kernels run asynchronously, but a plain
``.cpu()`` on the completion thread would wait for everything queued on the
stream, the next group's kernels included. So the launch stage ends by
queueing a non-blocking copy of the images into pinned host memory and
recording an event behind it (``HostCopy``); finalize waits on that event
only.

Determinism: every response carries ``batch_key`` (the service's group
counter), ``row`` and ``batch_size`` (the padded bucket). The predictor
draws the whole batch's noise from a generator seeded by
``batch_seed(seed, batch_key)``, so a request's output is a function of
(weights, batch contents, batch_key, row, batch_size), and replaying those
reproduces the image bit for bit.

Data parallelism over cards (``--dp N``, one process per card): the group's
first process runs the service as above with a ``DataParallelPredictor`` as
its predictor; every other process runs ``DataParallelPredictor.serve``. For
each group the first process broadcasts a header (op, batch_key, bucket)
and the group's uint8 rows; then every process runs the same predictor call
(``predict.Predictor`` with the data group: each samples its rows of the
padded bucket with the generator of ``batch_seed(seed, batch_key)``), and
the images come back whole. ``shutdown`` broadcasts a stop header after the
last group, which ends the other processes' loops. While no group comes,
a keep-alive header goes out every ``KEEPALIVE_S``, so that a waiting
process stays within the process group's timeout. Only ``broadcast`` and
``all_reduce`` are used: they run on NCCL across cards, on gloo on the CPU
and on gloo for processes that share a card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

import torch.distributed as dist

from .charset import encode_label
from .parallel.dist import group_src


def batch_seed(seed: int, key: int) -> int:
    """The seed of batch `key`'s generator: the first 8 bytes (little
    endian) of SHA-256 of "<seed>:<key>", below 2^63. Stands in for the JAX
    package's `fold_in(PRNGKey(seed), key)`, which torch has no counterpart
    of; any (seed, key) pair gives its own stream."""
    digest = hashlib.sha256(f"{int(seed)}:{int(key)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _settle(fut: Future, result: Any = None, exc: Optional[BaseException] = None) -> bool:
    """Resolve `fut` unless a shutdown past its timeout already failed it;
    returns whether this call resolved it."""
    try:
        if exc is None:
            fut.set_result(result)
        else:
            fut.set_exception(exc)
        return True
    except InvalidStateError:
        return False


class MicroBatcher:
    """Coalesce concurrent requests into bounded batches for one dispatcher.

    Parameters
    ----------
    run_batch: called from the dispatcher thread with 1..max_batch queued
        items; returns their results in order. An exception fails every
        request of the group and leaves the batcher serving.
    max_batch: the largest group.
    max_delay_ms: how long the dispatcher waits for co-batchable requests
        after it takes a group's first request; 0 dispatches what is queued.
    finalize: optional second stage for pipelined dispatch. ``run_batch``
        is then the launch and returns an in-flight handle quickly;
        ``finalize(handle)`` turns it into the results on a completion
        thread, in dispatch order. An exception in either stage fails only
        its group.
    pipeline_depth: the most groups in flight when ``finalize`` is given.
    """

    def __init__(
        self,
        run_batch: Callable[[List[Any]], Any],
        max_batch: int = 8,
        max_delay_ms: float = 50.0,
        queue_limit: int = 1024,
        finalize: Optional[Callable[[Any], Sequence[Any]]] = None,
        pipeline_depth: int = 2,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if finalize is not None and pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self._run_batch = run_batch
        self._finalize = finalize
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1000.0
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_limit)
        self._closed = False
        self._stats_lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_errors = 0
        self._batch_sizes: List[int] = []
        # rolling windows (seconds): enqueue → dispatch, and one model call
        self._queue_waits: List[float] = []
        self._run_times: List[float] = []
        # futures taken from the queue and not resolved yet
        self._pending: set = set()
        self._completion_q: Optional["queue.Queue"] = None
        self._completion_thread: Optional[threading.Thread] = None
        self._inflight: Optional[threading.Semaphore] = None
        if finalize is not None:
            self._inflight = threading.Semaphore(int(pipeline_depth))
            self._completion_q = queue.Queue()
            self._completion_thread = threading.Thread(
                target=self._completion_loop, name="microbatcher-complete", daemon=True)
            self._completion_thread.start()
        self._thread = threading.Thread(target=self._dispatch_loop, name="microbatcher",
                                        daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------

    def submit(self, item: Any) -> Future:
        """Enqueue one request; its Future resolves with run_batch's result."""
        if self._closed:
            raise RuntimeError("MicroBatcher is shut down")
        fut: Future = Future()
        self._queue.put((item, fut, time.monotonic()))
        if self._closed and not self._thread.is_alive():
            # raced past the closed check after the dispatcher's final drain
            self._drain_queue()
            return fut
        with self._stats_lock:
            self._n_requests += 1
        return fut

    def shutdown(self, timeout: float = 30.0) -> None:
        """Stop accepting requests, serve what is queued, join both threads.
        Requests still in flight when `timeout` expires are failed."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(None)  # the dispatcher finishes its group, then stops
        deadline = time.monotonic() + timeout
        self._thread.join(timeout=timeout)
        threads = [self._thread]
        if self._completion_thread is not None:
            # the dispatcher queues the completion thread's stop marker after
            # its last launch, so every launched group is finalized first
            self._completion_thread.join(timeout=max(0.0, deadline - time.monotonic()))
            threads.append(self._completion_thread)
        if any(t.is_alive() for t in threads):
            with self._stats_lock:
                stuck = [f for f in self._pending if not f.done()]
            self._fail(stuck, RuntimeError(
                f"MicroBatcher shut down with this request still in flight after {timeout} s"))
            self._drain_queue()
            self._queue.put(None)  # the drain took the marker the dispatcher stops on
        else:
            self._drain_queue()  # anything that raced in after the dispatcher's last drain

    @staticmethod
    def _pcts(xs: List[float]) -> Dict[str, float]:
        if not xs:
            return {"p50_s": 0.0, "p95_s": 0.0}
        return {"p50_s": round(float(np.percentile(xs, 50)), 4),
                "p95_s": round(float(np.percentile(xs, 95)), 4)}

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            sizes = list(self._batch_sizes[-100:])
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "errors": self._n_errors,
                "queue_depth": self._queue.qsize(),
                "mean_batch_size": float(np.mean(sizes)) if sizes else 0.0,
                "max_batch": self.max_batch,
                # queue_wait = enqueue → dispatch; run = one model call (the
                # finalize stage alone when pipelined)
                "queue_wait": self._pcts(self._queue_waits),
                "run": self._pcts(self._run_times),
            }

    # -- dispatcher side ----------------------------------------------------

    def _start(self, entry) -> bool:
        """Mark a dequeued request's future running; False if it was cancelled."""
        fut = entry[1]
        if not fut.set_running_or_notify_cancel():
            return False
        with self._stats_lock:
            self._pending.add(fut)
        return True

    def _collect_group(self) -> List:
        """Block for the first live request, take an in-flight slot when
        pipelined, then gather until the group is full or the deadline (from
        the first request) has passed. Empty on the shutdown marker."""
        while True:
            first = self._queue.get()
            if first is None:
                return []
            if self._start(first):
                break
        deadline = time.monotonic() + self.max_delay
        if self._inflight is not None:
            # before the group closes: what arrives while the pipeline is
            # full joins this group instead of waiting for the next one
            self._inflight.acquire()
        group = [first]
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                nxt = (self._queue.get(timeout=remaining) if remaining > 0
                       else self._queue.get_nowait())
            except queue.Empty:
                break
            if nxt is None:  # shutdown marker: finish this group, stop after it
                self._queue.put(None)
                break
            if self._start(nxt):
                group.append(nxt)
        return group

    def _drain_queue(self) -> None:
        """Fail whatever is still queued (after shutdown)."""
        while True:
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                return
            if entry is not None and entry[1].set_running_or_notify_cancel():
                _settle(entry[1], exc=RuntimeError("MicroBatcher is shut down"))

    def _record_group(self, n_items: int, waits: List[float], run_s: float) -> None:
        with self._stats_lock:
            self._n_batches += 1
            self._batch_sizes.append(n_items)
            self._queue_waits.extend(waits)
            self._run_times.append(run_s)
            for buf in (self._batch_sizes, self._queue_waits, self._run_times):
                if len(buf) > 1000:
                    del buf[:-100]

    def _resolve_group(self, futures: List[Future], results: Sequence[Any],
                       waits: List[float], run_s: float) -> None:
        if len(results) != len(futures):
            self._fail(futures, RuntimeError(
                f"run_batch returned {len(results)} results for {len(futures)} items"))
            return
        self._record_group(len(futures), waits, run_s)
        for fut, res in zip(futures, results):
            _settle(fut, res)
        with self._stats_lock:
            self._pending.difference_update(futures)

    def _fail(self, futures: List[Future], e: Exception) -> None:
        failed = sum(_settle(fut, exc=e) for fut in futures)
        with self._stats_lock:
            self._n_errors += failed
            self._pending.difference_update(futures)

    def _completion_loop(self) -> None:
        """Finalize launched groups in dispatch order, releasing each one's
        in-flight slot. The recorded `run` time is the finalize stage alone:
        launch → completion would add the queueing behind up to
        pipeline_depth earlier groups."""
        while True:
            entry = self._completion_q.get()
            if entry is None:
                return
            handle, futures, waits = entry
            t0 = time.monotonic()
            try:
                try:
                    results = self._finalize(handle)
                except Exception as e:  # noqa: BLE001 — fail only this group
                    self._fail(futures, e)
                    continue
                self._resolve_group(futures, results, waits, time.monotonic() - t0)
            finally:
                self._inflight.release()

    def _dispatch_loop(self) -> None:
        try:
            while True:
                group = self._collect_group()
                if not group:
                    return
                # a shutdown past its timeout may have failed these already
                group = [e for e in group if not e[1].done()]
                if not group:
                    if self._inflight is not None:
                        self._inflight.release()
                    continue
                items = [item for item, _, _ in group]
                futures = [fut for _, fut, _ in group]
                t_dispatch = time.monotonic()
                waits = [t_dispatch - t_in for _, _, t_in in group]
                if self._finalize is not None:
                    try:
                        handle = self._run_batch(items)
                    except Exception as e:  # noqa: BLE001
                        self._inflight.release()
                        self._fail(futures, e)
                        continue
                    self._completion_q.put((handle, futures, waits))
                    continue
                try:
                    results = self._run_batch(items)
                except Exception as e:  # noqa: BLE001 — fail the group, keep serving
                    self._fail(futures, e)
                    continue
                self._resolve_group(futures, results, waits, time.monotonic() - t_dispatch)
        finally:
            self._drain_queue()
            if self._completion_q is not None:
                self._completion_q.put(None)  # after every launched group


class HostCopy:
    """The images of one launched group on their way to the host. For a
    CUDA tensor, a non-blocking copy into pinned host memory is queued on
    the current stream with an event recorded behind it, so `numpy()` waits
    for this group's work only; anything else is taken as it is (numpy, or
    an object with __array__)."""

    def __init__(self, images: Any):
        self.event = None
        if isinstance(images, torch.Tensor) and images.is_cuda:
            self.images = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
            self.images.copy_(images, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.images = images

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        if isinstance(self.images, torch.Tensor):
            return self.images.numpy()
        return np.asarray(self.images)


@dataclasses.dataclass
class InpaintRequest:
    """One scene-text inpainting request."""

    image: np.ndarray  # (H, W, 3) uint8
    mask: np.ndarray  # (H, W), truthy where the text goes
    text: str


class InpaintService:
    """Batch assembly and bucket padding around a predictor callable.

    ``predictor(arr_batch, key) -> images (bucket, H, W, 3)`` (uint8, or
    float in [0, 1]; numpy, a CPU or CUDA tensor) is injected;
    scripts/serve.py wraps `predict.Predictor` with the generator of
    `batch_seed(seed, key)`. Every group is padded, by repeating its last
    row, to the smallest ``batch_buckets`` entry that fits it; the default
    buckets are ``(max_batch,)``. ``dp``, the predictor's data-parallel
    degree, must divide every bucket. ``pipeline_depth`` > 1 launches up to
    that many groups before the oldest is finalized.
    """

    def __init__(
        self,
        predictor: Callable[[Dict[str, np.ndarray], int], Any],
        max_batch: int = 8,
        max_delay_ms: float = 50.0,
        size: int = 512,
        seq_len: int = 12,
        batch_buckets: Optional[Sequence[int]] = None,
        dp: int = 1,
        pipeline_depth: int = 1,
    ):
        self.predictor = predictor
        self.size = int(size)
        self.seq_len = int(seq_len)
        self.max_batch = int(max_batch)
        self.dp = int(dp)
        if self.dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        if batch_buckets is None:
            self.batch_buckets = (self.max_batch,)
        else:
            buckets = tuple(sorted({int(b) for b in batch_buckets}))
            if not buckets or buckets[0] < 1:
                raise ValueError(f"batch_buckets must be positive, got {batch_buckets}")
            if buckets[-1] != self.max_batch:
                raise ValueError(
                    f"largest bucket ({buckets[-1]}) must equal max_batch "
                    f"({self.max_batch}) so a full group always fits")
            self.batch_buckets = buckets
        bad = [b for b in self.batch_buckets if b % self.dp != 0]
        if bad:
            raise ValueError(
                f"every batch bucket must be divisible by the data-parallel "
                f"degree dp={self.dp}, got buckets {self.batch_buckets} (offending: {bad})")
        self._key_counter = 0
        self._key_lock = threading.Lock()
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth > 1:
            self.batcher = MicroBatcher(self._launch_group, max_batch=max_batch,
                                        max_delay_ms=max_delay_ms, finalize=self._finalize_group,
                                        pipeline_depth=self.pipeline_depth)
        else:
            self.batcher = MicroBatcher(self._run_group, max_batch=max_batch,
                                        max_delay_ms=max_delay_ms)

    # -- request -> model-batch row ------------------------------------------

    def _resize(self, image: np.ndarray, mask01: np.ndarray):
        """image and 0/255 mask at size × size: as they are when already that
        size (Pillow's resize to the same size is a copy), else Pillow's
        resize (its default filter for the image, nearest for the mask), as
        the JAX package does."""
        s = self.size
        if image.shape == (s, s, 3) and mask01.shape == (s, s):
            return image.copy(), mask01
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                f"resizing a {image.shape[:2]} request to {s}x{s} needs Pillow, which is not "
                f"installed; send image and mask at {s}x{s}") from e
        img = np.asarray(Image.fromarray(image).resize((s, s)), np.uint8)
        mask = np.asarray(Image.fromarray(mask01).resize((s, s), Image.NEAREST), np.uint8)
        return img, mask

    def build_row(self, req: InpaintRequest) -> Dict[str, np.ndarray]:
        """One request's uint8 batch row: image (size, size, 3), mask
        (size, size, 1) in {0, 255}, seg_mask and label_ids (seq_len,)."""
        if not req.text or len(req.text) > self.seq_len:
            raise ValueError(f"text must be 1..{self.seq_len} characters, got {req.text!r}")
        image = np.asarray(req.image, np.uint8)
        mask01 = (np.asarray(req.mask) > 0).astype(np.uint8) * 255
        img, mask = self._resize(image, mask01)
        seg_mask = np.zeros((self.seq_len,), np.float32)
        seg_mask[: len(req.text)] = 1.0
        return {"image": img, "mask": mask[..., None], "seg_mask": seg_mask,
                "label_ids": encode_label(req.text, self.seq_len)}

    def batch_of(self, rows: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        """The rows padded to the smallest bucket that fits them (the last
        row repeated) and stacked: what the predictor is called with."""
        bucket = next(b for b in self.batch_buckets if b >= len(rows))
        rows = list(rows) + [rows[-1]] * (bucket - len(rows))
        return {k: np.stack([row[k] for row in rows]) for k in rows[0]}

    def _launch_group(self, rows: List[Dict[str, np.ndarray]]):
        """Stage 1: pad, stack, call the predictor, queue the copy home."""
        arr_batch = self.batch_of(rows)
        with self._key_lock:
            key = self._key_counter
            self._key_counter += 1
        images = HostCopy(self.predictor(arr_batch, key))
        return images, key, len(arr_batch["image"]), len(rows)

    def _finalize_group(self, handle) -> List[Dict[str, Any]]:
        """Stage 2: wait for this group's images and slice the real rows out."""
        copy, key, bucket, n_real = handle
        images = copy.numpy()
        if images.shape[0] != bucket:
            raise RuntimeError(f"predictor returned batch {images.shape[0]}, expected {bucket}")
        if images.dtype != np.uint8:  # float [0, 1] from a float predictor
            images = (np.clip(images, 0.0, 1.0) * 255).astype(np.uint8)
        # .copy(): a row view would keep the whole batch alive
        return [{"image": images[i].copy(), "batch_key": key, "row": i, "batch_size": bucket}
                for i in range(n_real)]

    def _run_group(self, rows: List[Dict[str, np.ndarray]]) -> List[Dict[str, Any]]:
        return self._finalize_group(self._launch_group(rows))

    def warmup(self) -> None:
        """Run one dummy group per bucket straight through `_run_group`
        (bucket choice independent of timing), before serving traffic."""
        dummy = self.build_row(InpaintRequest(
            image=np.zeros((self.size, self.size, 3), np.uint8),
            mask=np.ones((self.size, self.size), np.uint8), text="w"))
        for b in self.batch_buckets:
            self._run_group([dummy] * b)

    # -- public API -----------------------------------------------------------

    def submit(self, req: InpaintRequest) -> Future:
        # the row is built (and validated) on the caller's thread: an invalid
        # request fails here instead of failing its co-batched group
        return self.batcher.submit(self.build_row(req))

    def inpaint(self, req: InpaintRequest, timeout: Optional[float] = None):
        return self.submit(req).result(timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        return self.batcher.stats()

    def shutdown(self) -> None:
        self.batcher.shutdown()


# -- data parallelism over a process group ------------------------------------

OP_STOP, OP_RUN, OP_KEEPALIVE = 0, 1, 2
# an idle group's first process sends a keep-alive header this often: well
# inside the process group's timeout (`parallel.dist.TIMEOUT_S`)
KEEPALIVE_S = 60.0


def row_layout(size: int, seq_len: int):
    """(key, dtype, shape of one row) of the service's uint8 wire rows, in
    the order they are packed (`InpaintService.build_row`)."""
    return (("image", np.uint8, (size, size, 3)), ("mask", np.uint8, (size, size, 1)),
            ("seg_mask", np.float32, (seq_len,)), ("label_ids", np.int32, (seq_len,)))


class DataParallelPredictor:
    """The service's predictor over a data group: on the group's first
    process it is the `InpaintService`'s predictor, on the others `serve`
    is their loop.

    ``run(arr_batch, key)``, the same callable on every process (e.g.
    `scripts/serve.build_predict_fn` with the data group), samples the
    global batch together with the other processes and returns its images.
    A call broadcasts the header (op, key, bucket) and the rows packed into
    one uint8 buffer, then calls ``run``; calls are serialized by a lock, so
    the broadcasts of two threads (a warmup and the dispatcher) cannot
    interleave.

    A call that raises on one process may leave it midway through ``run``'s
    collectives while the others wait in another: the group is out of step
    and serves nothing more. The first process sets ``broken`` and refuses
    later calls (`scripts/serve.py` then stops its server and exits non-zero);
    another process's `serve` raises. Either way the process ends, a rank
    still waiting in a collective fails when the process group times out or
    its peer's connection closes, and torchrun ends the job."""

    def __init__(self, run: Callable[[Dict[str, Any], int], Any], group: Any,
                 device: torch.device | str, size: int, seq_len: int):
        self.run, self.group = run, group
        self.device = torch.device(device)
        self.layout = row_layout(size, seq_len)
        self.row_bytes = sum(int(np.dtype(dt).itemsize * np.prod(shape))
                             for _, dt, shape in self.layout)
        self.src = group_src(group)
        self.groups = 0  # groups this process has run
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._stopped = threading.Event()
        self.broken = threading.Event()  # a call raised: the group is out of step
        self._keepalive: Optional[threading.Thread] = None

    def _send(self, op: int, key: int = 0, bucket: int = 0) -> None:
        """Broadcast a header; nothing here waits for the device."""
        h = torch.tensor([op, key, bucket], dtype=torch.int64, device=self.device)
        dist.broadcast(h, src=self.src, group=self.group)
        self._last = time.monotonic()

    def _receive(self) -> List[int]:
        h = torch.empty(3, dtype=torch.int64, device=self.device)
        dist.broadcast(h, src=self.src, group=self.group)
        return h.tolist()

    def _pack(self, arr_batch: Dict[str, np.ndarray]) -> torch.Tensor:
        parts = []
        bucket = len(arr_batch["image"])
        for k, dt, shape in self.layout:
            a = np.ascontiguousarray(arr_batch[k], dtype=dt)
            if a.shape != (bucket,) + shape:
                raise ValueError(f"row field {k}: {a.shape}, expected {(bucket,) + shape}")
            parts.append(a.reshape(bucket, -1).view(np.uint8))
        return torch.from_numpy(np.concatenate(parts, axis=1)).to(self.device)

    def _unpack(self, buf: torch.Tensor, bucket: int) -> Dict[str, torch.Tensor]:
        rows, out, off = buf.reshape(bucket, self.row_bytes), {}, 0
        for k, dt, shape in self.layout:
            n = int(np.dtype(dt).itemsize * np.prod(shape))
            t = rows[:, off:off + n].contiguous().view(getattr(torch, np.dtype(dt).name))
            out[k] = t.reshape((bucket,) + shape)
            off += n
        return out

    def __call__(self, arr_batch: Dict[str, np.ndarray], key: int):
        bucket = len(arr_batch["image"])
        with self._lock:
            if self._stopped.is_set():
                raise RuntimeError("the data-parallel group has been "
                                   + ("broken by a failed group" if self.broken.is_set()
                                      else "stopped"))
            if self._keepalive is None:
                self._keepalive = threading.Thread(target=self._keepalive_loop,
                                                   name="dp-keepalive", daemon=True)
                self._keepalive.start()
            buf = self._pack(arr_batch)  # a bad batch fails before any collective
            try:
                self._send(OP_RUN, key, bucket)
                dist.broadcast(buf, src=self.src, group=self.group)
                self.groups += 1
                return self.run(arr_batch, key)
            except BaseException:
                self.broken.set()
                self._stopped.set()  # no stop header: the others may be in a collective
                raise

    def _keepalive_loop(self) -> None:
        while not self._stopped.wait(KEEPALIVE_S / 2):
            with self._lock:
                if not self._stopped.is_set() and time.monotonic() - self._last >= KEEPALIVE_S / 2:
                    self._send(OP_KEEPALIVE)

    def stop(self) -> None:
        """End the other processes' loops (after every group sent)."""
        with self._lock:
            if not self._stopped.is_set():
                self._stopped.set()
                self._send(OP_STOP)

    def serve(self) -> int:
        """The loop of a process other than the group's first: run each
        group the first process broadcasts, until its stop header. Returns
        the groups run; a group whose call raises ends the loop with its
        error, as the group is out of step (see the class)."""
        while True:
            op, key, bucket = self._receive()
            if op == OP_STOP:
                return self.groups
            if op == OP_KEEPALIVE:
                continue
            buf = torch.empty(bucket * self.row_bytes, dtype=torch.uint8, device=self.device)
            dist.broadcast(buf, src=self.src, group=self.group)
            self.groups += 1
            try:
                self.run(self._unpack(buf, bucket), key)
            except BaseException as e:
                print(f"data-parallel worker: group {key} failed, leaving the group: {e!r}",
                      flush=True)
                raise


class DataParallelService(InpaintService):
    """An `InpaintService` over a `DataParallelPredictor` whose shutdown
    also stops the group's other processes."""

    def shutdown(self) -> None:
        super().shutdown()
        self.predictor.stop()
