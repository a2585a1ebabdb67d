"""Token data pipeline for LM training (``repro.data.pipeline`` in PyTorch).

``SyntheticTokenSource`` is the JAX package's deterministic stand-in for
pretraining data, copied so that ``batch_at(step)`` gives the same tokens
bit for bit: Markov-ish rows with next-token labels, seeded by (seed,
step, host).  ``PrefetchLoader`` draws the next batches on a worker
thread while the current step runs and places each on the device through
``device.upload`` (pinned memory, an asynchronous copy).  On the LM mesh
(``mesh``, ``policy``) each rank places only its rows of every batch:
the rows ``sharding.rules.data_spec`` gives it (JAX's ``device_put`` with
that spec), so a source of the whole batch (``host_count=1``) gives the
mesh the same global batch as one card.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.common.device import resolve_device, upload
from repro_torch.sharding import rules


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    prefetch: int = 2


class SyntheticTokenSource:
    """Deterministic LM-pretraining stand-in: Markov-ish token streams with
    next-token labels.  Sharded: host h of H draws only rows h::H."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 host_count: int = 1):
        if cfg.global_batch % host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {host_count} hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = cfg.global_batch // self.host_count
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + self.host_index)
        base = rng.integers(0, cfg.vocab_size, (rows, cfg.seq_len + 1),
                            dtype=np.int32)
        # inject local structure so loss is learnable (not pure noise)
        rep = rng.integers(2, 6)
        base[:, rep::rep] = base[:, ::rep][:, : base[:, rep::rep].shape[1]]
        return {"tokens": base[:, :-1], "labels": base[:, 1:]}


class PrefetchLoader:
    """Background-thread prefetch of ``source.batch_at(0), (1), ...`` (at
    most ``prefetch`` ahead), each batch placed on ``device`` (the card by
    default) as it is taken: this rank's rows under ``mesh``."""

    def __init__(self, source: SyntheticTokenSource, device=None, mesh=None,
                 policy: str = "2d"):
        self.source = source
        self.device = resolve_device(device)
        self.mesh = mesh
        self.policy = policy
        self._q: "queue.Queue" = queue.Queue(maxsize=source.cfg.prefetch)
        self._stop = threading.Event()
        self._step = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self.mesh is not None:
            batch = {k: v[slice(*rules.rows_of(self.mesh, v.shape[0],
                                               self.policy))]
                     for k, v in batch.items()}
        return {k: upload(v, self.device) for k, v in batch.items()}

    def _worker(self) -> None:
        while not self._stop.is_set():
            host = self.source.batch_at(self._step)
            self._step += 1
            try:
                self._q.put(host, timeout=1.0)
            except queue.Full:
                if self._stop.is_set():
                    return
                self._step -= 1

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        return self._place(self._q.get())

    def close(self) -> None:
        """Stop the worker (freeing a queue slot it may be waiting on)
        and wait for it to end."""
        self._stop.set()
        try:
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join()
