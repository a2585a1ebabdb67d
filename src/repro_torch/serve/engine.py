"""Serving engine: continuous-batched prefill/decode over the LM
(``repro.serve.engine`` in PyTorch).

The analytics tier of the DeepStream deployment: requests are token
prompts; the engine prefills each new request into a slot of the batched
KV cache and steps the live slots together, one decode per group of slots
at the same sequence position.

The JAX engine's masked decode writes every row at ``pos`` into a new
cache and then restores the rows of slots outside the group from the old
one.  Here the cache is written in place, and a grouped decode writes only
its group's rows, of every leaf (recurrent states too): the same cache,
with no copy of it.  ``admit`` splices a request's prefilled cache (one
row) into its slot along each leaf's own batch axis (``model.
splice_rows``, on a mesh ``LM.splice``: the axis on which the two
leaves' shapes differ; JAX diffs against a batch-1 cache too); with one
slot they are the same shape and the row is the leaf.  A vlm request
is prefilled with zero image embeddings, as in JAX.  The audio family is
refused: JAX's engine sizes its cross cache at ``max_seq *
enc_seq_factor`` positions while a prefill fills it at the prompt's
length, and its splice fails with a broadcast error; padding the cross
cache would change what decode attends to.

On the LM mesh (``LM(cfg, mesh)``: one engine per rank, every rank
driving the same requests) the cache is this rank's piece, as JAX's
``cache_shardings`` lays it out: its slots' rows (``LM.batch_rows``, the
batch over the data-parallel axes) and, under tensor parallelism, its
positions (the sequence over "model") and its piece of each recurrent
state; when the data-parallel axes do not divide the slots, every slot
and the positions cut over "data" (JAX's long-context layout).  A
request's prefill writes its cache in that layout (``cache_batch``).  Admission, slots and positions stay host
decisions, and every rank takes the same ones: a request is prefilled on
every rank (a batch of one is not cut), every rank calls the splice and
the rank that holds its slot writes it, every rank runs every grouped decode (with or without rows
of its own in the group), and the next tokens are a vocab-parallel argmax
(``LM.next_tokens``) gathered over the data-parallel ranks, so every rank
reads all slots' tokens.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.model import LM, splice_rows

AUDIO_CAVEAT = (
    "the serving engine does not serve the audio (encoder-decoder) family: "
    "its cross cache holds max_seq * enc_seq_factor positions while a "
    "prefill fills it at the prompt's length, and padding it would change "
    "what decode attends to (the JAX engine fails the same way, at admit); "
    "drive LM.prefill / LM.decode directly")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Single-card engine over ``lm`` with ``params`` on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, lm: LM, params: Any, batch_slots: int, max_seq: int,
                 device=None):
        self.lm = lm
        self.params = params
        self.slots = batch_slots
        self.max_seq = max_seq
        if lm.cfg.family == "audio":
            raise ValueError(AUDIO_CAVEAT)
        self.device = resolve_device(device)
        self.mesh = getattr(lm, "mesh", None)
        self.rows = (lm.batch_rows(batch_slots) if self.mesh is not None
                     else (0, batch_slots))
        self.cache = lm.init_cache(batch_slots, max_seq, self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def admit(self, req: Request) -> bool:
        """Prefill a request into a free slot (one slot at a time: the
        batched cache rows of other slots are untouched)."""
        slot = self._free_slot()
        if slot is None:
            return False
        S = len(req.prompt)
        cfg = self.lm.cfg
        batch = {"tokens": torch.as_tensor(
            np.asarray(req.prompt, np.int64)[None, :], device=self.device)}
        if cfg.family == "vlm":
            batch["img_embeds"] = torch.zeros(
                (1, cfg.vlm.num_image_tokens, cfg.d_model),
                dtype=L.dtype_of(cfg), device=self.device)
        kw = self._batch_kw(1)
        if self.mesh is not None:
            kw["cache_batch"] = self.slots
        logits, cache1 = self.lm.prefill(self.params, batch, self.max_seq,
                                         **kw)
        if self.mesh is None:
            splice_rows(self.cache, cache1, slot)
        else:
            self.lm.splice(self.cache, cache1, slot, self.slots)
        self.slot_req[slot] = req
        self.slot_pos[slot] = S
        req.out_tokens.append(int(self._argmax(logits[:, -1])[0]))
        return True

    def _batch_kw(self, global_batch: int) -> Dict[str, int]:
        return {} if self.mesh is None else {"global_batch": global_batch}

    def _argmax(self, logits: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return torch.argmax(logits, dim=-1)
        return self.lm.next_tokens(logits)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Every slot's next token (host), from this rank's rows of the
        logits."""
        nxt = self._argmax(logits[:, 0])
        if self.mesh is not None:
            nxt = self.lm.gather_rows(nxt, self.slots)
        # audit: allow(host-sync) the sampled tokens: the call's one fetch
        return nxt.cpu().numpy()

    def step(self) -> List[Request]:
        """One decode step for all live slots; returns finished requests."""
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not live:
            return []
        tokens = np.zeros((self.slots, 1), np.int64)
        for i in live:
            tokens[i, 0] = self.slot_req[i].out_tokens[-1]
        lo, hi = self.rows
        tokens = torch.as_tensor(tokens[lo:hi], device=self.device)
        # each slot decodes at ITS OWN position: group live slots by
        # position; one group decodes the full batch and writes every row
        groups: Dict[int, List[int]] = {}
        for i in live:
            # audit: allow(host-sync) slot positions are host numpy
            groups.setdefault(int(self.slot_pos[i]), []).append(i)
        if len(groups) == 1:
            pos = next(iter(groups))
            logits, self.cache = self.lm.decode(self.params, tokens,
                                                self.cache, pos,
                                                **self._batch_kw(self.slots))
            nxt = self._sample(logits)
        else:
            nxt = np.zeros(self.slots, np.int64)
            for pos, idxs in sorted(groups.items()):
                mine = [i - lo for i in idxs if lo <= i < hi]
                logits, self.cache = self.lm.decode(
                    self.params, tokens, self.cache, pos, rows=mine,
                    **self._batch_kw(self.slots))
                nxt[idxs] = self._sample(logits)[idxs]
        finished = []
        for i in live:
            r = self.slot_req[i]
            # audit: allow(host-sync) nxt is the fetched host array
            r.out_tokens.append(int(nxt[i]))
            self.slot_pos[i] += 1
            if (len(r.out_tokens) >= r.max_new_tokens
                    or self.slot_pos[i] >= self.max_seq - 1):
                r.done = True
                finished.append(r)
                self.slot_req[i] = None
                self.slot_pos[i] = 0
        return finished

    def run(self, requests: List[Request],
            max_steps: Optional[int] = None) -> Dict[str, float]:
        """Drain a request list; returns throughput stats.

        ``max_steps`` bounds the decode loop (default: enough for every
        request to emit its full budget serially, plus slack — a loop that
        outlives it is stuck, not slow).  Exhausting it raises with the
        stuck slots named (slot index, request id, sequence position,
        tokens emitted) plus the un-admitted backlog."""
        pending = list(requests)
        done: List[Request] = []
        if max_steps is None:
            max_steps = 64 + 2 * sum(r.max_new_tokens for r in requests)
        t0 = time.perf_counter()
        steps = 0
        while pending or any(r is not None for r in self.slot_req):
            if steps >= max_steps:
                stuck = [f"slot {i}: rid={r.rid} pos={int(self.slot_pos[i])} "
                         f"emitted={len(r.out_tokens)}/{r.max_new_tokens}"
                         for i, r in enumerate(self.slot_req)
                         if r is not None] or ["no live slots"]
                raise RuntimeError(
                    f"serve loop did not drain in {max_steps} steps: "
                    f"{len(pending)} request(s) never admitted "
                    f"({self.slots} slot(s) configured); " + "; ".join(stuck))
            while pending and self._free_slot() is not None:
                self.admit(pending.pop(0))
            done += self.step()
            steps += 1
        dt = time.perf_counter() - t0
        toks = sum(len(r.out_tokens) for r in done)
        return {"requests": len(done), "tokens": toks, "wall_s": dt,
                "tok_per_s": toks / max(dt, 1e-9), "steps": steps}
