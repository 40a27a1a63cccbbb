"""``ServeEngine``: multi-tenant composed-model inference with continuous
batching and a device-resident hot loop.

Each request names a tenant; the engine routes it to that tenant's
personalized base block + the shared modular block (from the
``CompositionStore``) and batches it into the lane of its
(base_arch, modular_arch) pair. One engine *step* advances every lane
``horizon`` ticks (``lanes.py``), fetches every lane's emitted-token
window plus the previous boundary's admission outputs in ONE
device-to-host transfer, evicts finished requests, and admits waiting
arrivals into freed slots with bucketed batch prefill. The host
therefore syncs once per ``horizon`` ticks, not once per token.

Admissions land only at horizon boundaries (the last tick of a step),
so ``horizon=1`` is the tick-exact engine: decode one tick, evict, admit
at that same tick. A request whose prefill token already completes it
(EOS on first token, or ``max_new_tokens == 1``) is detected on the
device at admission but reported at the next step's fetch, holding its
slot for one step. Token streams are unaffected.

The step-count clock is the engine's time base: request arrivals,
admissions and per-token stamps are all measured in ticks.

Correctness contract: ``oracle(request)`` replays the request alone in
an otherwise-empty lane of the SAME width and horizon; by the lane's row
independence a continuously-batched served output is bitwise equal to
its oracle, on the CPU and on the card.

``autotune`` times the horizon and bucket edges of batch admission on a
workload and persists the winner (``repro_torch.kernels.ops``'s
serve-plan autotuner); ``horizon="auto"`` reads it back.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.serve.lanes import Lane, default_bucket_edges
from repro_torch.serve.store import CompositionStore
from repro_torch.serve.types import Completion, Request

__all__ = ["ServeEngine", "fetch"]


def fetch(payload: Dict[Any, Dict[str, Any]]) -> Dict[Any, Dict[str, Any]]:
    """Bring every pending device tensor of ``payload`` (lane key ->
    ``Lane.pending_transfer()``) to the host in ONE transfer: the
    tensors are flattened into one int64 tensor, copied with a single
    ``.cpu()``, and split back into numpy arrays of the same layout."""
    tensors = []
    for d in payload.values():
        if "window" in d:
            tensors.append(d["window"])
        for first, done in d.get("admit", []):
            tensors += [first, done]
    if not tensors:
        return {k: {} for k in payload}
    flat = torch.cat([t.reshape(-1).long() for t in tensors]).cpu().numpy()
    offset = 0

    def take(t):
        nonlocal offset
        a = flat[offset: offset + t.numel()].reshape(tuple(t.shape))
        offset += t.numel()
        return a

    host: Dict[Any, Dict[str, Any]] = {}
    for k, d in payload.items():
        h: Dict[str, Any] = {}
        if "window" in d:
            h["window"] = take(d["window"])
        if "admit" in d:
            h["admit"] = [(take(f), take(dn)) for f, dn in d["admit"]]
        host[k] = h
    return host


class ServeEngine:
    """Continuous-batching server over a ``CompositionStore``.

    ``horizon`` is the fused-decode span S (ticks per engine step);
    ``"auto"`` reads the serve-plan autotuner's file
    (``repro_torch.kernels.ops.serve_plan``) for this (device, arch
    pairs, width, cache_len) and falls back to 8. ``bucket_edges``
    overrides the padded prompt-length buckets of batch admission
    (default: the plan's under "auto", else powers of two up to
    ``cache_len``). ``device`` defaults to the card; pass ``"cpu"`` to
    serve on the CPU.
    """

    def __init__(self, store: CompositionStore, *, width: int = 8,
                 cache_len: int = 128, horizon: Any = 1,
                 bucket_edges: Optional[Sequence[int]] = None,
                 device: DeviceLike = None):
        if width < 1:
            raise ValueError(f"lane width must be >= 1, got {width}")
        self.device = resolve_device(device)
        self.store = store
        self.width = int(width)
        self.cache_len = int(cache_len)
        self.bucket_edges = list(bucket_edges) if bucket_edges else None
        if horizon == "auto":
            plan = ops.serve_plan(self.plan_key(), self.device)
            horizon = plan.get("horizon", 8)
            if self.bucket_edges is None and plan.get("bucket_edges"):
                self.bucket_edges = [int(e) for e in plan["bucket_edges"]]
        self.horizon = int(horizon)
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        self._lanes: Dict[Tuple[str, str], Lane] = {}
        # Pending queues carry (request, base params) so admission does
        # not repeat the store.entry() lookup submit already paid.
        self._pending: Dict[Tuple[str, str], Deque[Tuple[Request, Any]]] \
            = {}
        self._tick = 0
        self._inflight = 0

    # ---------------------------------------------------------- lanes

    def plan_key(self) -> str:
        """The autotuner's key: every (base_arch, modular_arch) pair the
        store can serve, and the lane geometry."""
        pairs = sorted({(e.arch, e.modular_arch)
                        for e in (self.store.entry(t)
                                  for t in self.store.tenants())})
        tag = ",".join(f"{a}+{m}" for a, m in pairs)
        return f"{tag}|W{self.width}|L{self.cache_len}"

    def _lane_key(self, request: Request) -> Tuple[str, str]:
        e = self.store.entry(request.tenant)
        return (e.arch, e.modular_arch)

    def _lane(self, key: Tuple[str, str]) -> Lane:
        if key not in self._lanes:
            arch, mod_arch = key
            some_tenant = next(
                e for e in (self.store.entry(t) for t in
                            self.store.tenants())
                if e.arch == arch and e.modular_arch == mod_arch
            )
            self._lanes[key] = Lane(
                self.store.cfg(arch), self.store.cfg(mod_arch),
                self.store.modular(mod_arch), some_tenant.base,
                width=self.width, cache_len=self.cache_len,
                device=self.device, bucket_edges=self.bucket_edges,
            )
        return self._lanes[key]

    def lanes(self) -> List[Lane]:
        return list(self._lanes.values())

    # --------------------------------------------------------- submit

    def submit(self, request: Request) -> None:
        e = self.store.entry(request.tenant)  # the ONE tenant lookup
        bc = self.store.cfg(e.arch)
        if len(request.prompt) + request.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request {request.rid}: prompt({len(request.prompt)}) "
                f"+ max_new({request.max_new_tokens}) exceeds cache_len "
                f"{self.cache_len}"
            )
        if max(request.prompt) >= bc.vocab_size or min(request.prompt) < 0:
            raise ValueError(
                f"request {request.rid}: prompt token out of vocab "
                f"range [0, {bc.vocab_size})"
            )
        key = (e.arch, e.modular_arch)
        q = self._pending.setdefault(key, deque())
        q.append((request, e.base))
        # FIFO by (arrival, submission order): keep the deque sorted, so
        # a late-arriving request cannot jump the queue.
        if len(q) > 1 and request.arrival < q[-2][0].arrival:
            self._pending[key] = deque(
                sorted(q, key=lambda rb: rb[0].arrival))
        self._inflight += 1

    # ----------------------------------------------------------- step

    @property
    def tick(self) -> int:
        return self._tick

    @property
    def inflight(self) -> int:
        return self._inflight

    def queue_depth(self) -> int:
        """Requests submitted but not yet admitted to a slot."""
        return sum(len(q) for q in self._pending.values())

    def step(self) -> List[Completion]:
        """One engine step == ``horizon`` ticks: run the horizon on every
        occupied lane, fetch all lanes' windows + pending admission
        outputs in ONE transfer, evict finished requests, then admit
        waiting arrivals at the boundary tick. Returns the completions
        finished this step."""
        now, S = self._tick, self.horizon
        for lane in self._lanes.values():
            if lane.n_active > 0:
                lane.launch_horizon(S, now)
        # The single host sync of the step.
        host = fetch({k: lane.pending_transfer()
                      for k, lane in self._lanes.items()})
        done: List[Completion] = []
        for k, lane in self._lanes.items():
            done.extend(lane.absorb(host[k]))
        # Boundary admission: bucketed batch prefill of everything
        # admissible into the slots now free, one prefill per bucket.
        boundary = now + S - 1
        for key, q in self._pending.items():
            lane = self._lane(key)
            free = len(lane.free_slots())
            admits: List[Tuple[Request, Any]] = []
            while q and q[0][0].arrival <= boundary and len(admits) < free:
                admits.append(q.popleft())
            lane.admit_batch(admits, boundary)
        self._inflight -= len(done)
        self._tick += S
        return done

    # ------------------------------------------------------------ run

    def step_budget(self) -> int:
        """An exact upper bound on the engine steps needed to drain the
        current queues + in-flight slots (no further submissions).

        Worst case every request of a lane serializes through one slot:
        admission at one boundary, first token landing the next step,
        ``ceil((m-1)/S)`` windows for the remaining tokens, and the freed
        slot re-admitting at that same step's boundary:
        ``ceil((m-1)/S) + 2`` steps per request. Arrivals gate admission
        for at most ``ceil(max_arrival/S) + 1`` leading steps. Lanes
        drain in the same global steps, so the busiest lane dominates.
        """
        S = self.horizon
        per_lane: Dict[Tuple[str, str], int] = {}
        max_arr = 0
        for key, q in self._pending.items():
            for req, _ in q:
                per_lane[key] = per_lane.get(key, 0) + \
                    (max(req.max_new_tokens - 1, 0) + S - 1) // S + 2
                max_arr = max(max_arr, req.arrival)
        for key, lane in self._lanes.items():
            for s in lane.slots:
                if s is None:
                    continue
                owed = (s.request.max_new_tokens if s.awaiting_first
                        else max(s.remaining, 0))
                per_lane[key] = per_lane.get(key, 0) + \
                    (max(owed - 1, 0) + S - 1) // S + 2
        busiest = max(per_lane.values()) if per_lane else 0
        return (max_arr + S - 1) // S + 1 + busiest

    def run(self, requests: List[Request],
            max_ticks: Optional[int] = None) -> List[Completion]:
        """Drive submitted + given requests to completion; returns all
        completions sorted by rid. The default budget is the exact
        :meth:`step_budget` bound: exceeding it is a scheduler bug."""
        for r in requests:
            self.submit(r)
        budget = (max_ticks + self.horizon - 1) // self.horizon \
            if max_ticks is not None else self.step_budget()
        out: List[Completion] = []
        while self._inflight > 0:
            if budget <= 0:
                raise RuntimeError("engine did not drain within the "
                                   "step budget (scheduler stall?)")
            out.extend(self.step())
            budget -= 1
        return sorted(out, key=lambda c: c.rid)

    def fresh_clone(self) -> "ServeEngine":
        """An empty engine over the same store whose lanes share this
        engine's cast modular blocks: the warm twin a second run times."""
        clone = ServeEngine(self.store, width=self.width,
                            cache_len=self.cache_len, horizon=self.horizon,
                            bucket_edges=self.bucket_edges,
                            device=self.device)
        clone._lanes = {k: lane.fresh_clone()
                        for k, lane in self._lanes.items()}
        return clone

    # --------------------------------------------------------- oracle

    def oracle(self, request: Request) -> Completion:
        """The fixed-batch correctness twin: serve ``request`` ALONE in
        an empty lane of the same width and horizon. The engine's
        continuously-batched output must be bitwise equal."""
        key = self._lane_key(request)
        lane = self._lane(key).fresh_clone()
        base = self.store.entry(request.tenant).base
        req0 = dataclasses.replace(request, arrival=0)
        S = self.horizon
        lane.admit_batch([(req0, base)], S - 1)
        t0 = S
        budget = (max(request.max_new_tokens - 1, 0) + S - 1) // S + 3
        for _ in range(budget):
            if lane.n_active > 0:
                lane.launch_horizon(S, t0)
            finished = lane.absorb(
                fetch({key: lane.pending_transfer()})[key])
            if finished:
                return finished[0]
            t0 += S
        raise RuntimeError("oracle did not finish")

    # ------------------------------------------------------- autotune

    def autotune(self, requests: List[Request], *,
                 horizons: Sequence[int] = (1, 2, 4, 8, 16),
                 edge_sets: Optional[Sequence[Sequence[int]]] = None,
                 force: bool = False) -> Dict[str, Any]:
        """Wall-clock autotune of (horizon, bucket edges) for this
        store, width and cache_len on this device, persisted to the
        serve-plan file (``repro_torch.kernels.ops``). Each candidate
        serves ``requests`` once, then times a warm ``fresh_clone`` run
        of them, the card synchronized before each clock read."""
        if edge_sets is None:
            edge_sets = (default_bucket_edges(self.cache_len),
                         [self.cache_len])

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def timer(h: int, edges: Sequence[int]) -> float:
            eng = ServeEngine(self.store, width=self.width,
                              cache_len=self.cache_len, horizon=h,
                              bucket_edges=list(edges), device=self.device)
            eng.run(list(requests))      # the first run
            warm = eng.fresh_clone()
            sync()
            t0 = time.perf_counter()
            warm.run(list(requests))
            sync()
            return time.perf_counter() - t0

        return ops.autotune_serve_plan(
            self.plan_key(), timer, self.device, horizons=horizons,
            edge_sets=edge_sets, force=force)
