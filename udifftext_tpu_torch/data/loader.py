"""Batching + prefetching loader (port of `udifftext_tpu/data/loader.py`).

The reference's `get_dataloader` (dataloader.py:925-932, torch DataLoader
with `eval(target)` dispatch) as a plain pipeline: explicit dataset
registry, numpy collation to fixed-shape NHWC batches, `label_ids`
tokenization for the LabelEncoder and `parseq_label_ids` for the OCR loss,
and a background-thread prefetcher that overlaps host augmentation
(cv2/PIL) with device steps. The run configs' `num_workers` is honored with
forked worker processes (ordered output, per-batch deterministic seeding),
not torch's DataLoader: its per-worker seeding makes the epoch depend on the
worker count. Batches are numpy; `train.to_device` moves them.

The process's rank and the world size come from `torch.distributed` when
it is initialized, else 0 and 1.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
import traceback
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..charset import encode_labels
from ..config import load_config
from ..models.parseq import ParseqTokenizer
from ..parallel.dist import rank_and_world as process_rank_and_count
from . import datasets as D

_PARSEQ_TOKENIZER = ParseqTokenizer()

DATASETS = {
    "LAIONOCRDataset": D.LAIONOCRDataset,
    "TextSegDataset": D.TextSegDataset,
    "SynthTextDataset": D.SynthTextDataset,
    "ICDAR13Dataset": D.ICDAR13Dataset,
    "LabelDataset": D.LabelDataset,
}


def collate(samples: List[Dict[str, Any]], max_len: int = 12) -> Dict[str, Any]:
    """Stack numpy fields; keep strings as lists; add label_ids."""
    batch: Dict[str, Any] = {}
    keys = samples[0].keys()
    for k in keys:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[k] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float)):
            batch[k] = np.asarray(vals)
        else:
            batch[k] = vals
    if "label" in batch:
        batch["label_ids"] = encode_labels(batch["label"], max_len)
        batch["parseq_label_ids"] = _PARSEQ_TOKENIZER.encode(batch["label"])
    if "text" in batch:
        batch["label_ids"] = encode_labels(batch["text"], max_len)
    return batch


def _worker_loop(dataset, task_q, result_q, max_label_len: int):
    """Worker process body (num_workers > 0): pull (batch_idx, seed, indices)
    tasks, seed the per-batch augmentation RNGs, emit collated batches.

    Seeding per BATCH (not per worker) makes the produced stream independent
    of how batches land on workers — the same loader seed yields bit-identical
    epochs at any num_workers >= 1, unlike torch's per-worker seeding
    (reference dataloader.py:925-932 wraps torch.utils.data.DataLoader)."""
    import random as _random

    while True:
        task = task_q.get()
        if task is None:
            return
        bidx, seed, idx = task
        try:
            np.random.seed(seed)
            _random.seed(seed)
            samples = [dataset[i] for i in idx]
            result_q.put((bidx, collate(samples, max_label_len), None))
        except Exception:  # noqa: BLE001 — surfaced in the parent as RuntimeError
            result_q.put((bidx, None, traceback.format_exc()))


class DataLoader:
    """Simple shuffling, drop-last, prefetching loader over an indexable
    dataset.

    num_workers=0 (default): samples are loaded on a background thread
    (prefetch>0) or inline. num_workers>0: a pool of forked worker processes
    loads and collates batches in parallel — the host-side augmentation
    (cv2/PIL char-seg extraction, ~10-50 ms/sample) runs outside the GIL so
    it can keep up with the device step. Batches are yielded strictly in
    epoch order regardless of worker completion order."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        max_label_len: int = 12,
        prefetch: int = 2,
        seed: Optional[int] = None,
        process_index: int = 0,
        process_count: int = 1,
        num_workers: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.max_label_len = max_label_len
        self.prefetch = prefetch
        # Multi-host sharding: every process builds the SAME global order
        # (shared seed) and reads its strided shard — so per-process batches
        # are disjoint and jointly cover the epoch. seed must agree across
        # processes when process_count > 1.
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        if process_count > 1 and seed is None:
            seed = 0
        self.num_workers = int(num_workers)
        self.rng = np.random.RandomState(seed)

    def _shard_len(self) -> int:
        # every process gets the SAME shard length (the global order is
        # truncated to a multiple of process_count) — unequal shards would
        # desynchronize the per-process step counts and hang or mix the
        # collectives across epochs
        return len(self.dataset) // self.process_count

    def __len__(self):
        n = self._shard_len() // self.batch_size
        if not self.drop_last and self._shard_len() % self.batch_size:
            n += 1
        return n

    def _index_batches(self) -> Iterator[List[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        usable = len(order) // self.process_count * self.process_count
        order = order[:usable][self.process_index :: self.process_count]
        for i in range(0, len(order), self.batch_size):
            idx = order[i : i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx.tolist()

    def _produce(self, q: "queue.Queue"):
        try:
            for idx in self._index_batches():
                samples = [self.dataset[i] for i in idx]
                q.put(collate(samples, self.max_label_len))
        finally:
            q.put(None)

    def __iter__(self):
        if self.num_workers > 0:
            yield from self._iter_workers()
            return
        if self.prefetch <= 0:
            for idx in self._index_batches():
                yield collate([self.dataset[i] for i in idx], self.max_label_len)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q,), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item

    def _iter_workers(self) -> Iterator[Dict[str, Any]]:
        """Multi-process epoch: forked workers (the dataset object — open
        files, fonts, mmaps — is inherited, never pickled), bounded in-flight
        window, ordered reassembly, fail-fast error propagation."""
        tasks = [
            (bidx, int(self.rng.randint(0, 2**31 - 1)), idx)
            for bidx, idx in enumerate(self._index_batches())
        ]
        if not tasks:
            return
        ctx = mp.get_context("fork")
        task_q = ctx.Queue()
        result_q = ctx.Queue()
        workers = [
            ctx.Process(
                target=_worker_loop,
                args=(self.dataset, task_q, result_q, self.max_label_len),
                daemon=True,
            )
            for _ in range(min(self.num_workers, len(tasks)))
        ]
        for w in workers:
            w.start()
        try:
            limit = len(workers) + max(self.prefetch, 1)
            it = iter(tasks)
            inflight = 0
            buffer: Dict[int, Dict[str, Any]] = {}
            next_out = 0
            while next_out < len(tasks):
                while inflight < limit:
                    task = next(it, None)
                    if task is None:
                        break
                    task_q.put(task)
                    inflight += 1
                if next_out in buffer:
                    yield buffer.pop(next_out)
                    next_out += 1
                    continue
                while True:
                    try:
                        bidx, batch, err = result_q.get(timeout=5.0)
                        break
                    except queue.Empty:
                        # watchdog: a worker killed hard (segfault, OOM kill)
                        # never reports its task — hang here would be silent
                        dead = [w for w in workers
                                if not w.is_alive() and w.exitcode not in (0, None)]
                        if dead:
                            raise RuntimeError(
                                f"data worker died with exit code "
                                f"{dead[0].exitcode} (signal/OOM?) — "
                                f"{inflight} batch(es) were in flight"
                            )
                inflight -= 1
                if err is not None:
                    raise RuntimeError(
                        f"data worker failed on batch {bidx}:\n{err}"
                    )
                buffer[bidx] = batch
        finally:
            for _ in workers:
                task_q.put(None)
            for w in workers:
                w.join(timeout=5)
                if w.is_alive():
                    w.terminate()


def get_dataloader(cfgs, datype: str = "train") -> DataLoader:
    """Reference get_dataloader semantics: run-config points at a dataset
    YAML with {target, params}; explicit registry instead of eval().
    `batch_size` is the global micro-batch: each of the world's processes
    loads its share, which must divide it."""
    dataset_cfgs = load_config(cfgs["dataset_cfg_path"])
    target = dataset_cfgs["target"].split(".")[-1]
    if target not in DATASETS:
        raise KeyError(f"unknown dataset target {target}")
    cls = DATASETS[target]
    params = dict(dataset_cfgs.get("params", {}) or {})
    if target == "LabelDataset":
        dataset = cls(**params)
    else:
        dataset = cls(params, datype=datype)

    pindex, pcount = process_rank_and_count()
    batch_size = int(cfgs.get("batch_size", 1))
    if pcount > 1:
        # batch_size stays the GLOBAL microbatch (the single-host
        # convention); each process loads its slice of it
        if batch_size % pcount != 0:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the process "
                f"count {pcount}"
            )
        batch_size //= pcount
    return DataLoader(
        dataset,
        batch_size=batch_size,
        shuffle=cfgs.get("shuffle", True),
        max_label_len=params.get("seq_len", params.get("max_len", 12)),
        seed=int(cfgs.get("data_seed", 0)) if pcount > 1 else None,
        process_index=pindex,
        process_count=pcount,
        # reference run configs carry torch DataLoader's num_workers; honor it
        # with forked worker processes (0 = background-thread prefetch)
        num_workers=int(cfgs.get("num_workers", 0) or 0),
    )
