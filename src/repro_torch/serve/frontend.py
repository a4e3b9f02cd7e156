"""ServingFrontend: request queueing, per-adapter routing, admission.

A copy of ``repro.serve.frontend`` (host-side numpy only) over the port's
pool and replica.

The tenant-facing edge of the serving tier. ``submit`` enqueues a decode
request routed by adapter id; the frontend then drives the replica in
one of two modes:

**continuous (default).** ``step_continuous`` keeps every lane of the
replica's ``Z x lanes`` grid busy: before each fused decode step it
drains pending batched publishes (``queue_publish`` ->
``AdapterPool.publish_many``), then fills free lanes from the queues —
each join is admission-checked against the §A.3+k2 memory model using
the request's ACTUAL footprint (``prompt_len + max_new`` tokens, times
the adapter's charged rank for rank-tokens) summed over everything in
flight, not the pessimistic ``lanes x max_len`` bound. A request that
doesn't fit right now simply waits; it is re-checked as lanes complete
and release their charge. ``drain`` loops steps until the queues and
lanes are empty and returns per-request results; per-request latency
records accumulate on ``replica.records``.

**round (baseline).** ``step_round``/``drain`` reproduce the epoch
barrier: the heads of every adapter's queue are packed into one cache
epoch and everything joins/leaves together. Publish admission in this
mode keeps the pessimistic resident-set bound (every resident adapter
charged ``lanes x max_len``), since a round has no per-request charge
tracking.
"""
from __future__ import annotations

import collections
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sched.intra_task import MemoryModel
from repro_torch.serve.pool import AdapterPool
from repro_torch.serve.replica import ServeRequest, ServingReplica


class AdmissionError(Exception):
    """Publish or request refused by the frontend's admission checks."""


class ServingFrontend:
    """Queueing + routing + admission over one ``ServingReplica``."""

    def __init__(self, replica: ServingReplica,
                 mem: Optional[MemoryModel] = None,
                 mode: str = "continuous"):
        assert mode in ("continuous", "round"), mode
        self.replica = replica
        self.pool: AdapterPool = replica.pool
        self.mem = mem
        self.mode = mode
        self._queues: Dict[str, Deque[ServeRequest]] = \
            collections.defaultdict(collections.deque)
        self._done: Dict[str, ServeRequest] = {}
        self._inflight: Dict[str, Tuple[int, int]] = {}  # rid -> (tok, rtok)
        self._pending_pubs: List[Tuple] = []
        self._next_id = 0
        self.publishes = 0
        self.hot_publishes = 0      # publishes landing mid-decode (hook)
        self.served_requests = 0
        self.deferred_joins = 0     # joins postponed by the memory model

    # ------------------------------------------------------------ admission
    def _admission_tokens(self, extra_rank: int) -> Tuple[int, int]:
        lanes, seq = self.replica.lanes, self.replica.max_len
        toks = self.pool.occupied_tokens(lanes, seq) + lanes * seq
        rtoks = self.pool.occupied_rank_tokens(lanes, seq) \
            + extra_rank * lanes * seq
        return toks, rtoks

    def _check_publish(self, rank: int, pending: int = 0) -> None:
        if len(self.pool.free_slots()) <= pending:
            raise AdmissionError("no free adapter slot")
        if self.mem is None or self.mode == "continuous":
            # continuous mode charges actual per-request footprints at
            # join time instead of reserving lanes x max_len per adapter
            return
        rank = self.mem.charged_rank(min(rank, self.pool.r_max))
        toks, rtoks = self._admission_tokens(rank)
        if not self.mem.fits_ranked(toks, rtoks):
            raise AdmissionError(
                f"publish would exceed memory budget: "
                f"{self.mem.predict_ranked(toks, rtoks):.3e} B > "
                f"{self.mem.capacity * self.mem.safety_margin:.3e} B")

    def _request_footprint(self, r: ServeRequest) -> Tuple[int, int]:
        """Actual serving footprint: the tokens this request will occupy
        in its lane's cache, and the rank-tokens its adapter's charged
        rank multiplies them into."""
        toks = len(r.prompt) + r.max_new
        slot = self.pool.slot_of(r.adapter_id)
        rank = self.pool.slot_rank[slot]
        if self.mem is not None:
            rank = self.mem.charged_rank(rank)
        return toks, rank * toks

    def _can_join(self, r: ServeRequest) -> bool:
        if self.mem is None:
            return True
        toks, rtoks = self._request_footprint(r)
        toks += sum(t for t, _ in self._inflight.values())
        rtoks += sum(rt for _, rt in self._inflight.values())
        return self.mem.fits_ranked(toks, rtoks)

    # ------------------------------------------------------------ publishing
    def publish(self, adapter_id: str, adapter: Dict, rank: int,
                meta: Optional[Dict] = None) -> int:
        self._check_publish(rank)
        slot = self.pool.publish(adapter_id, adapter, rank, meta=meta)
        self.publishes += 1
        return slot

    def queue_publish(self, adapter_id: str, adapter: Dict, rank: int,
                      meta: Optional[Dict] = None) -> None:
        """Defer the publish to the next drain point between decode steps;
        a burst of queued publishes lands as ONE batched
        ``publish_many`` slot update. Admission (free slots, and in round
        mode the memory bound) is checked now, against earlier queued
        publishes too, so a refused publish fails fast at call time."""
        self._check_publish(rank, pending=len(self._pending_pubs))
        self._pending_pubs.append((adapter_id, adapter, rank, meta))

    def _drain_pending_publishes(self) -> int:
        if not self._pending_pubs:
            return 0
        pending, self._pending_pubs = self._pending_pubs, []
        self.pool.publish_many(pending)
        self.publishes += len(pending)
        return len(pending)

    def publish_checkpoint(self, path: str,
                           adapter_id: Optional[str] = None) -> str:
        """Admit an adapter from a durable checkpoint artifact (the
        tune-to-serve path). Returns the adapter id."""
        import json

        # peek rank for admission without mutating the pool
        data = np.load(path if path.endswith(".npz") else path + ".npz",
                       allow_pickle=False)
        meta = json.loads(str(data["__meta__"]))
        self._check_publish(int(meta["rank"]))
        aid, _ = self.pool.publish_checkpoint(path, adapter_id=adapter_id)
        self.publishes += 1
        return aid

    def retire(self, adapter_id: str) -> int:
        assert not self._queues.get(adapter_id), \
            f"adapter {adapter_id!r} has queued requests"
        self._queues.pop(adapter_id, None)
        return self.pool.retire(adapter_id)

    # ------------------------------------------------------------ requests
    def submit(self, adapter_id: str, prompt, max_new: int, *,
               temperature: float = 0.0, top_k: int = 0,
               seed: int = 0) -> str:
        """Enqueue a decode request; returns its request id. Sampling is
        greedy unless ``temperature > 0`` (then optionally ``top_k``-
        truncated; ``seed`` keys the per-request sample stream)."""
        import time as _time

        if adapter_id not in self.pool.resident():
            raise AdmissionError(f"adapter {adapter_id!r} not resident")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1 or len(prompt) + max_new > self.replica.max_len:
            raise AdmissionError(
                f"prompt({len(prompt)}) + max_new({max_new}) exceeds "
                f"max_len={self.replica.max_len}")
        r = ServeRequest(request_id=f"req-{self._next_id}",
                         adapter_id=adapter_id, prompt=prompt,
                         max_new=max_new, temperature=temperature,
                         top_k=top_k, seed=seed)
        if self.mem is not None and self.mode == "continuous":
            # a request that can never fit even alone is refused up front
            toks, rtoks = self._request_footprint(r)
            if not self.mem.fits_ranked(toks, rtoks):
                raise AdmissionError(
                    f"request footprint {toks} tokens exceeds the memory "
                    f"budget even on an empty replica")
        r.submit_t = _time.perf_counter()
        self._next_id += 1
        self._queues[adapter_id].append(r)
        return r.request_id

    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ------------------------------------------------------------ continuous
    def _fill_lanes(self) -> int:
        """Join queued requests into free lanes, round-robin across
        adapters, re-checking the memory model per join. Returns joins."""
        joined = 0
        progress = True
        while progress:
            progress = False
            for adapter_id in list(self._queues):
                q = self._queues[adapter_id]
                if not q or adapter_id not in self.pool.resident():
                    continue
                r = q[0]
                slot = self.pool.slot_of(adapter_id)
                if self.replica.free_lane(slot) is None:
                    continue
                if not self._can_join(r):
                    self.deferred_joins += 1
                    continue        # re-checked as in-flight work completes
                q.popleft()
                ok = self.replica.try_join(r)
                assert ok
                self._inflight[r.request_id] = self._request_footprint(r)
                joined += 1
                progress = True
        return joined

    def step_continuous(self,
                        on_step: Optional[Callable[[int], None]] = None,
                        record_logits: bool = False) -> int:
        """Drain queued publishes, fill free lanes, run one fused decode
        step. Returns requests completed by the step; their lanes (and
        memory charges) free immediately, so the NEXT step can join new
        work — the zero-barrier property."""
        self._drain_pending_publishes()
        self._fill_lanes()
        hot_before = self.pool.version
        done = self.replica.step_continuous(on_step=on_step,
                                            record_logits=record_logits)
        if on_step is not None and self.pool.version > hot_before:
            self.hot_publishes += self.pool.version - hot_before
        for r in done:
            self._inflight.pop(r.request_id, None)
            self._done[r.request_id] = r
        self.served_requests += len(done)
        return len(done)

    # ------------------------------------------------------------ rounds
    def step_round(self, on_step: Optional[Callable[[int], None]] = None
                   ) -> int:
        """Serve one round over the head of every adapter's queue (up to
        ``lanes`` requests each). Returns requests completed; 0 = idle."""
        batch: List[ServeRequest] = []
        for adapter_id in list(self._queues):
            if adapter_id not in self.pool.resident():
                continue            # retired with queued work: re-check later
            q = self._queues[adapter_id]
            for _ in range(min(len(q), self.replica.lanes)):
                batch.append(q.popleft())
        if not batch:
            return 0
        hot_before = self.pool.version
        self.replica.serve_round(batch, on_step=on_step)
        if on_step is not None and self.pool.version > hot_before:
            self.hot_publishes += self.pool.version - hot_before
        for r in batch:
            self._done[r.request_id] = r
        self.served_requests += len(batch)
        return len(batch)

    def drain(self, on_step: Optional[Callable[[int], None]] = None
              ) -> Dict[str, List[int]]:
        """Serve until every queue and lane is empty; returns
        ``{request_id: generated tokens}`` for everything completed."""
        if self.mode == "round":
            while self.queued():
                served = self.step_round(on_step=on_step)
                on_step = None      # hooks fire on the first round only
                if served == 0:
                    break           # only retired-adapter queues remain
            return {rid: list(r.tokens) for rid, r in self._done.items()}
        while self.queued() or self.replica.busy_lanes():
            before = self.replica.busy_lanes()
            self.step_continuous(on_step=on_step)
            on_step = None
            if not self.replica.busy_lanes() and before == 0:
                break               # only retired/unjoinable queues remain
        return {rid: list(r.tokens) for rid, r in self._done.items()}

    def result(self, request_id: str) -> List[int]:
        assert request_id in self._done, f"request {request_id!r} not done"
        return list(self._done[request_id].tokens)
