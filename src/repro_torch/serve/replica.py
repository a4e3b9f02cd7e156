"""ServingReplica: continuous-batching decode over one adapter pool.

One frozen backbone serves every resident adapter of an ``AdapterPool``
at once: in-flight requests map to ``(slot, lane)`` coordinates of the
slot-stacked forward — slot = the request's adapter, lane = one of the
replica's ``lanes`` decode streams per slot — so each decode step advances
``Z x lanes`` streams in one fused forward. Prefill and decode both run
with the pool's ``ranks`` bound via ``LORA.slot_ranks``, so every LoRA
projection goes through the rank-local grouped-LoRA kernels.

Two batching disciplines share the replica:

**Continuous (default drive mode).** The decode cache carries a per-lane
position vector, so every lane is its own stream: a request joins the
moment a lane in its adapter's slot frees up (block prefill writes its
prompt into its own lane cache; ring caches and the recurrent and hybrid
families stream the prompt through the decode step after a lane reset) and leaves the moment it has ``max_new``
tokens. Idle lanes are frozen bitwise by the ``active`` mask.

**Round-based (baseline).** ``serve_round`` keeps one global cache
position, so requests only join at a fresh cache epoch and finished lanes
idle until the slowest stream drains.

Sampling: requests may carry ``temperature``/``top_k`` (greedy when
``temperature == 0``, the default). A sampled token draws from a
``torch.Generator`` seeded from ``(sample_seed, request.seed,
token_index)`` — deterministic under a fixed seed and independent of when
the request joined; its bits differ from the JAX package's ``fold_in``
keys by design, so only greedy streams are compared across packages.

Every step runs under ``torch.inference_mode()``; the greedy argmax is
taken on the device, so a step moves only ``[Z, lanes]`` int64 tokens to
the host unless logits are recorded or a request samples.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora as LORA
from repro_torch.core.steps import (make_join_decode_step,
                                    make_lane_prefill_step, make_prefill_step,
                                    make_serve_step)
from repro_torch.models import model as M
from repro_torch.models.common import resolve_device
from repro_torch.serve.pool import AdapterPool


@dataclasses.dataclass
class ServeRequest:
    """One decode request routed to a resident adapter."""
    request_id: str
    adapter_id: str
    prompt: np.ndarray            # [P] int32 token ids, P >= 1
    max_new: int
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => full vocab
    seed: int = 0                 # seeds the per-request sample stream
    tokens: List[int] = dataclasses.field(default_factory=list)
    # lane-lifecycle bookkeeping (filled by the replica / frontend)
    fed: int = 0                  # prompt+generated tokens consumed so far
    submit_t: Optional[float] = None
    join_t: Optional[float] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new


@dataclasses.dataclass
class RequestRecord:
    """Per-request completion record (continuous mode)."""
    request_id: str
    adapter_id: str
    prompt_len: int
    new_tokens: int
    queue_s: float                # submit -> lane assignment
    prefill_s: float              # lane assignment -> first token
    decode_s: float               # first token -> completion
    total_s: float                # submit -> completion


@dataclasses.dataclass
class RoundStats:
    """One cache epoch's accounting (round-based mode)."""
    requests: int
    generated: int                # tokens produced this round
    decode_steps: int             # fused step invocations
    wall_s: float
    logits: List[Tuple[int, np.ndarray]]   # (position, [Z,lanes,V]) when
                                           # recording is on


class ServingReplica:
    """Lane scheduler over ``pool.Z`` x ``lanes`` decode streams, on the
    card unless ``device`` says otherwise (it must be the pool's device)."""

    def __init__(self, cfg: ModelConfig, params, pool: AdapterPool, *,
                 lanes: int = 4, max_len: int = 64, ring: bool = False,
                 sample_seed: int = 0, join_batch: int = 2,
                 join_wait_steps: int = 1,
                 device: Optional[str | torch.device] = None):
        assert lanes >= 1 and max_len >= 2
        self.device = resolve_device(device)
        if pool.device != self.device:
            raise ValueError(f"pool is on {pool.device}, replica on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.pool = pool
        self.lanes = lanes
        self.max_len = max_len
        self.ring = ring and cfg.family != "ssm"
        # block prefill writes the whole prompt in one forward; ring caches
        # and the recurrent and hybrid families need per-position writes:
        # their prompts stream through decode_step
        self._block_prefill = (not self.ring
                               and cfg.family not in ("ssm", "hybrid"))
        prefill = make_prefill_step(cfg)
        serve = make_serve_step(cfg)
        lane_prefill = make_lane_prefill_step(cfg)
        join_decode = make_join_decode_step(cfg)

        # every wrapper also returns the greedy argmax, taken on the device
        def ranked_prefill(params, lora, cache, batch, ranks):
            with torch.inference_mode(), LORA.slot_ranks(ranks):
                logits, cache = prefill(params, lora, cache, batch)
                return logits, torch.argmax(logits, dim=-1), cache

        def ranked_decode(params, lora, cache, tokens, ranks):
            with torch.inference_mode(), LORA.slot_ranks(ranks):
                logits, cache = serve(params, lora, cache, tokens)
                return logits, torch.argmax(logits, dim=-1), cache

        def ranked_decode_lanes(params, lora, cache, tokens, active, ranks):
            with torch.inference_mode(), LORA.slot_ranks(ranks):
                logits, cache = serve(params, lora, cache, tokens, active)
                return logits, torch.argmax(logits, dim=-1), cache

        def ranked_lane_prefill(params, lora, cache, tokens, mask, plens,
                                ranks):
            with torch.inference_mode(), LORA.slot_ranks(ranks):
                logits, cache = lane_prefill(params, lora, cache, tokens,
                                             mask, plens)
                return logits, torch.argmax(logits, dim=-1), cache

        def ranked_join_decode(params, lora, cache, tokens, mask, plens,
                               cur, active, ranks):
            with torch.inference_mode(), LORA.slot_ranks(ranks):
                return join_decode(params, lora, cache, tokens, mask,
                                   plens, cur, active)

        def reset(cache, mask):
            with torch.inference_mode():
                return M.reset_lanes(cfg, cache, mask)

        self._prefill = ranked_prefill
        self._decode = ranked_decode
        self._decode_lanes = ranked_decode_lanes
        self._lane_prefill = ranked_lane_prefill
        self._join_decode = ranked_join_decode
        self._reset_lanes = reset
        self.sample_seed = sample_seed
        self.total_generated = 0
        self.total_decode_steps = 0
        self.total_wall_s = 0.0
        self.rounds = 0
        # continuous-mode state: one live per-lane cache, never epoch-reset
        self._cache: Optional[Dict] = None
        self._cur = np.zeros((pool.Z, lanes), np.int32)
        self._active = np.zeros((pool.Z, lanes), bool)
        self._active_dev: Optional[torch.Tensor] = None   # device mirror
        self._lane_req: Dict[Tuple[int, int], ServeRequest] = {}
        self._pending_joins: Dict[Tuple[int, int], ServeRequest] = {}
        self._join_step: Dict[Tuple[int, int], int] = {}
        # joins flush when >= join_batch are pending, the oldest has
        # waited join_wait_steps fused steps, or no lane is decoding
        self.join_batch = max(join_batch, 1)
        self.join_wait_steps = max(join_wait_steps, 0)
        self.joins = 0
        self.block_prefills = 0     # fused ragged prefill launches
        self.records: List[RequestRecord] = []
        self.step_logits: List[Tuple[int, np.ndarray]] = []

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------ lanes
    def busy_lanes(self) -> int:
        return len(self._lane_req) + len(self._pending_joins)

    def free_lane(self, slot: int) -> Optional[int]:
        """First free lane in the slot's row, or None."""
        for lane in range(self.lanes):
            c = (slot, lane)
            if c not in self._lane_req and c not in self._pending_joins:
                return lane
        return None

    def try_join(self, r: ServeRequest) -> bool:
        """Assign the request to a free lane of its adapter's slot; it is
        prefilled right before the next fused decode step. Returns False
        when the row is full."""
        assert len(r.prompt) >= 1
        assert len(r.prompt) + r.max_new <= self.max_len, \
            f"request {r.request_id!r} exceeds max_len={self.max_len}"
        slot = self.pool.slot_of(r.adapter_id)
        lane = self.free_lane(slot)
        if lane is None:
            return False
        r.join_t = time.perf_counter()
        if r.submit_t is None:
            r.submit_t = r.join_t
        self._pending_joins[(slot, lane)] = r
        self._join_step[(slot, lane)] = self.total_decode_steps
        self.joins += 1
        return True

    def _ensure_cache(self) -> None:
        if self._cache is None:
            self._cache = M.init_cache(self.cfg, self.pool.Z, self.lanes,
                                       self.max_len, ring=self.ring,
                                       per_lane=True, device=self.device)

    # ------------------------------------------------------------ sampling
    def _sample(self, r: ServeRequest, greedy_tok: int,
                logits_row: Optional[np.ndarray]) -> int:
        if r.temperature <= 0.0:
            return greedy_tok
        seed = np.random.SeedSequence(
            [self.sample_seed, r.seed, len(r.tokens)]).generate_state(1)[0]
        gen = torch.Generator().manual_seed(int(seed))
        logits = torch.as_tensor(logits_row, dtype=torch.float32) \
            / r.temperature
        if r.top_k and r.top_k < logits.shape[-1]:
            kth = torch.sort(logits).values[-r.top_k]
            logits = torch.where(logits >= kth, logits,
                                 torch.tensor(float("-inf")))
        return int(torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                     generator=gen))

    # ------------------------------------------------------------ joins
    def _join_batch(self, joiners: Dict[Tuple[int, int], ServeRequest]):
        """(tokens [Z,lanes,P], mask, plens) for a ragged block prefill;
        prompts right-padded to the next power of two of the longest
        (bounded by the cache)."""
        Z, lanes = self.pool.Z, self.lanes
        P = max(len(r.prompt) for r in joiners.values())
        P = min(1 << (P - 1).bit_length(), self.max_len)
        toks = np.zeros((Z, lanes, P), np.int32)
        mask = np.zeros((Z, lanes), bool)
        plens = np.ones((Z, lanes), np.int32)      # idle rows: index 0
        for (s, lane), r in joiners.items():
            toks[s, lane, :len(r.prompt)] = r.prompt
            mask[s, lane] = True
            plens[s, lane] = len(r.prompt)
        return self._dev(toks), self._dev(mask), self._dev(plens)

    def _flush_joins(self) -> None:
        """Write pending joiners' prompts into their own lane caches: one
        ragged ``prefill_lanes`` for the block joiners; ring caches and
        one-token prompts reset the lane and stream through decode."""
        pending, self._pending_joins = self._pending_joins, {}
        self._join_step.clear()
        if not pending:
            return
        block: Dict[Tuple[int, int], ServeRequest] = {}
        stream: Dict[Tuple[int, int], ServeRequest] = {}
        for coord, r in pending.items():
            if self._block_prefill and len(r.prompt) > 1:
                block[coord] = r
            else:
                stream[coord] = r
        if block:
            toks, mask, plens = self._join_batch(block)
            logits, greedy, self._cache = self._lane_prefill(
                self.params, self.pool.lora, self._cache, toks, mask, plens,
                self.pool.ranks)
            self.block_prefills += 1
            nxt = greedy.cpu().numpy()
            rows = logits.float().cpu().numpy() if any(
                r.temperature > 0 for r in block.values()) else None
            for (s, lane), r in block.items():
                tok = self._sample(
                    r, int(nxt[s, lane]),
                    None if rows is None else rows[s, lane])
                r.tokens.append(tok)
                self.total_generated += 1
                r.fed = len(r.prompt)
                r.first_token_t = time.perf_counter()
                self._cur[s, lane] = tok
                self._activate(s, lane, r)
        if stream:
            mask = np.zeros((self.pool.Z, self.lanes), bool)
            for (s, lane) in stream:
                mask[s, lane] = True
            self._cache = self._reset_lanes(self._cache, self._dev(mask))
            for (s, lane), r in stream.items():
                r.fed = 0
                self._cur[s, lane] = r.prompt[0]
                self._activate(s, lane, r)

    def _activate(self, slot: int, lane: int, r: ServeRequest) -> None:
        self._lane_req[(slot, lane)] = r
        self._active[slot, lane] = True
        self._active_dev = None

    # ------------------------------------------------------------ decode
    def step_continuous(self, on_step: Optional[Callable[[int], None]] = None,
                        record_logits: bool = False) -> List[ServeRequest]:
        """Flush pending joins, run ONE fused per-lane decode step, and
        return the requests completed by it (their lanes are freed).
        ``on_step(i)`` fires before the fused step (hot publish/retire
        hook). Completion appends a ``RequestRecord`` to ``records``."""
        t0 = time.perf_counter()
        self._ensure_cache()
        flush_due = bool(self._pending_joins) and (
            not self._lane_req
            or len(self._pending_joins) >= self.join_batch
            or self.total_decode_steps - min(self._join_step.values())
            >= self.join_wait_steps)
        # greedy block-prefillable joiners take the fused join+decode step:
        # prefill + first-token argmax + one decode step, no host round-trip
        fuse = (flush_due and self._block_prefill
                and all(len(r.prompt) > 1 and r.temperature <= 0.0
                        for r in self._pending_joins.values()))
        if flush_due and not fuse:
            self._flush_joins()
        done: List[ServeRequest] = []
        for coord, r in list(self._lane_req.items()):
            if r.done:                      # block prefill covered max_new=1
                done.append(self._complete(coord, r))
        if fuse:
            joiners, self._pending_joins = self._pending_joins, {}
            self._join_step.clear()
            toks, mask, plens = self._join_batch(joiners)
            if on_step is not None:
                on_step(self.total_decode_steps)
            if self._active_dev is None:
                self._active_dev = self._dev(self._active)
            p_greedy, logits, greedy, self._cache = self._join_decode(
                self.params, self.pool.lora, self._cache, toks, mask, plens,
                self._dev(self._cur), self._active_dev, self.pool.ranks)
            self.block_prefills += 1
            p_nxt = p_greedy.cpu().numpy()
            now = time.perf_counter()
            for (s, lane), r in joiners.items():
                tok = int(p_nxt[s, lane])
                r.tokens.append(tok)
                self.total_generated += 1
                r.fed = len(r.prompt)
                r.first_token_t = now
                self._cur[s, lane] = tok
                self._activate(s, lane, r)
                if r.done:      # max_new == 1: prefill covered it fully
                    done.append(self._complete((s, lane), r))
        else:
            if not self._lane_req:
                self.total_wall_s += time.perf_counter() - t0
                return done
            if on_step is not None:
                on_step(self.total_decode_steps)
            if self._active_dev is None:  # re-upload only on lane churn
                self._active_dev = self._dev(self._active)
            logits, greedy, self._cache = self._decode_lanes(
                self.params, self.pool.lora, self._cache,
                self._dev(self._cur), self._active_dev, self.pool.ranks)
        nxt = greedy.cpu().numpy()
        rows = None
        if record_logits or any(r.temperature > 0
                                for r in self._lane_req.values()):
            rows = logits.float().cpu().numpy()
        if record_logits:
            self.step_logits.append((self.total_decode_steps, rows))
        generated = 0
        for (s, lane), r in list(self._lane_req.items()):
            P = len(r.prompt)
            r.fed += 1
            if r.fed < P:                   # still consuming its prompt
                self._cur[s, lane] = r.prompt[r.fed]
                continue
            tok = self._sample(r, int(nxt[s, lane]),
                               None if rows is None else rows[s, lane])
            if r.first_token_t is None:
                r.first_token_t = time.perf_counter()
            r.tokens.append(tok)
            generated += 1
            self._cur[s, lane] = tok
            if r.done:
                done.append(self._complete((s, lane), r))
        self.total_decode_steps += 1
        self.total_generated += generated
        self.total_wall_s += time.perf_counter() - t0
        return done

    def _complete(self, coord: Tuple[int, int],
                  r: ServeRequest) -> ServeRequest:
        r.done_t = time.perf_counter()
        del self._lane_req[coord]
        self._active[coord] = False
        self._active_dev = None
        self.records.append(RequestRecord(
            request_id=r.request_id, adapter_id=r.adapter_id,
            prompt_len=len(r.prompt), new_tokens=len(r.tokens),
            queue_s=r.join_t - r.submit_t,
            prefill_s=r.first_token_t - r.join_t,
            decode_s=r.done_t - r.first_token_t,
            total_s=r.done_t - r.submit_t))
        return r

    # ------------------------------------------------------------ rounds
    def pack(self, requests: List[ServeRequest]
             ) -> Dict[Tuple[int, int], ServeRequest]:
        """Assign requests to (slot, lane); every adapter must be resident
        and get at most ``lanes`` requests in one round."""
        lane_req: Dict[Tuple[int, int], ServeRequest] = {}
        used: Dict[int, int] = {}
        for r in requests:
            s = self.pool.slot_of(r.adapter_id)
            lane = used.get(s, 0)
            assert lane < self.lanes, \
                f"adapter {r.adapter_id!r}: > {self.lanes} requests/round"
            assert len(r.prompt) >= 1
            assert len(r.prompt) + r.max_new <= self.max_len, \
                f"request {r.request_id!r} exceeds max_len={self.max_len}"
            used[s] = lane + 1
            lane_req[(s, lane)] = r
        return lane_req

    def serve_round(self, requests: List[ServeRequest],
                    on_step: Optional[Callable[[int], None]] = None,
                    record_logits: bool = False) -> RoundStats:
        """Drive one cache epoch (round-based baseline): streamed prefill
        + greedy decode until every request has ``max_new`` tokens.
        ``on_step(i)`` fires before the i-th fused step."""
        assert requests, "empty round"
        lane_req = self.pack(requests)
        pool = self.pool
        Z, b = pool.Z, self.lanes
        cache = M.init_cache(self.cfg, Z, b, self.max_len, ring=self.ring,
                             device=self.device)
        cur = np.zeros((Z, b), np.int32)
        lens = {len(r.prompt) for r in lane_req.values()}
        logits = None
        logits_log: List[Tuple[int, np.ndarray]] = []
        steps = 0
        t0 = time.perf_counter()
        if self._block_prefill and len(lens) == 1 and min(lens) > 1:
            P0 = lens.pop()
            prompts = np.zeros((Z, b, P0), np.int32)
            for (s, lane), r in lane_req.items():
                prompts[s, lane] = r.prompt
            logits, greedy, cache = self._prefill(
                self.params, pool.lora, cache, {"tokens": self._dev(prompts)},
                pool.ranks)
            t = P0 - 1                 # logits for position P0-1 in hand
        else:
            for (s, lane), r in lane_req.items():
                cur[s, lane] = r.prompt[0]
            t = -1                     # nothing consumed yet
        generated = 0
        while True:
            if logits is not None:
                nxt = greedy.cpu().numpy()
                if record_logits:
                    logits_log.append((t, logits.float().cpu().numpy()))
                for (s, lane), r in lane_req.items():
                    P = len(r.prompt)
                    if t < P - 1:
                        cur[s, lane] = r.prompt[t + 1]
                    else:
                        tok = int(nxt[s, lane])
                        if not r.done:
                            r.tokens.append(tok)
                            generated += 1
                        cur[s, lane] = tok
                if all(r.done for r in lane_req.values()):
                    break
            if on_step is not None:
                on_step(steps)
            logits, greedy, cache = self._decode(self.params, pool.lora,
                                                 cache, self._dev(cur),
                                                 pool.ranks)
            steps += 1
            t += 1
        wall = time.perf_counter() - t0
        self.total_generated += generated
        self.total_decode_steps += steps
        self.total_wall_s += wall
        self.rounds += 1
        return RoundStats(requests=len(requests), generated=generated,
                          decode_steps=steps, wall_s=wall,
                          logits=logits_log)

    @property
    def aggregate_tok_s(self) -> float:
        return self.total_generated / max(self.total_wall_s, 1e-9)
