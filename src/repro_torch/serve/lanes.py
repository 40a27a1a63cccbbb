"""Per-architecture batch lanes, the device-resident continuous-batching
substrate.

A lane is a fixed-width W vector of independent decode slots for ONE
(base_arch, modular_arch) pair: per-slot base params (each slot a
different tenant) held as one stack with a slot dim, ONE shared modular
block, per-slot decode caches and positions, all batched along a
leading W dim where the JAX package ``vmap``s a B=1 step:

* the shared modular block's linears are one matmul over the W rows;
* the per-slot base linears are ``torch.bmm`` over the slot dim (plain
  products, as XLA did them);
* every slot carries its own position, and the decode kernel reads each
  slot's cache rows in place.

The weights are cast to the compute dtype once, when the lane is built
and when a tenant is admitted, instead of at every call (see
``modules.linear``).

The hot loop: one *horizon* advances every slot S ticks, a Python loop
of the same W-row step with per-slot stop state (remaining-length
counters and EOS ids) kept in device tensors. Post-stop slots keep being
decoded, but their tokens are dead: the host walks each slot's emitted
window only up to its own stop point. The lane never blocks on the
device; the engine fetches every lane's window (and the previous
boundary's admission outputs) in ONE transfer per engine step.

Admission is bucketed batch prefill: at a horizon boundary the engine
hands the lane a list of requests; the lane groups them by padded
prompt-length bucket and, per bucket, copies each admitted tenant's base
into its slot row in place, resets the slot's cache rows, and runs ONE
W-row ragged prefill (``composed_prefill_ragged``) on the lane's own
cache, in which every row that is not being admitted has length 0 and
is left untouched. EOS/length-1 completion of the prefill token is
decided on the device; the host reads the first token at the next
boundary's transfer.

Bitwise contract (the oracle leans on it): at fixed width W, a slot's
tokens depend only on that slot's params, cache, token and position.
Every row goes through the same per-row arithmetic (a batched product
treats its batch entries alike, a shared product its rows alike, the
kernel one block per row and KV head), so other slots' contents,
admissions and evictions cannot perturb it. An engine-served request is
therefore bitwise equal to the same request served alone in an
otherwise-empty width-W lane (``ServeEngine.oracle``). Empty slots carry
zero params and a fresh cache and decode finite garbage that nobody
reads.

Greedy only in this slice: a request with ``temperature > 0`` raises
NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models import modules as nn
from repro_torch.models.transformer import (
    check_supported,
    composed_decode_step,
    composed_prefill_ragged,
    init_composed_cache,
)
from repro_torch.serve.types import Completion, Request

__all__ = ["Lane", "SlotState", "default_bucket_edges", "require_greedy"]


def default_bucket_edges(cache_len: int) -> List[int]:
    """Power-of-two prompt-length buckets from 8 up to ``cache_len``."""
    edges, e = [], 8
    while e < cache_len:
        edges.append(e)
        e *= 2
    edges.append(int(cache_len))
    return edges


def require_greedy(request: Request) -> None:
    if request.temperature > 0:
        raise NotImplementedError(
            f"request {request.rid}: temperature > 0; the port serves greedy "
            "requests only, per-slot sampling is ROADMAP.md queue 1, item 5a")


def _zero_stack(template, width: int, dtype: torch.dtype, device,
                grouped: bool = False):
    """Zeros shaped like ``template`` with a slot dim of ``width``: after
    the group dim for leaves under 'groups' ((G, W, ...), so one group's
    slice is a contiguous (W, ...) stack), first otherwise. Leaves that
    ``linear``/``embedding`` cast at use are held in ``dtype``."""
    out = {}
    for k, v in template.items():
        if isinstance(v, dict):
            out[k] = _zero_stack(v, width, dtype, device,
                                 grouped or k == "groups")
            continue
        shape = ((v.shape[0], width, *v.shape[1:]) if grouped
                 else (width, *v.shape))
        dt = dtype if k in ("w", "b", "table") else v.dtype
        out[k] = torch.zeros(shape, dtype=dt, device=device)
    return out


def _copy_into_slot(stack, base, slot: int, grouped: bool = False) -> None:
    """Write one tenant's base params into slot row ``slot`` of the stack,
    in place (``copy_`` casts to the stack's compute dtype). The JAX lane
    stacks W whole base trees per admission instead: at qwen1.5-0.5b's
    full width that is about 5 GB of copies, here one tenant's base."""
    for k, v in base.items():
        if isinstance(v, dict):
            _copy_into_slot(stack[k], v, slot, grouped or k == "groups")
        else:
            (stack[k][:, slot] if grouped else stack[k][slot]).copy_(v)


def _reset_cache_rows(cache, rows: torch.Tensor) -> None:
    """Give slot rows ``rows`` a fresh cache: zero K/V, slot_pos -1.
    Prefix caches lead with the slot dim, group caches with the group
    dim."""
    for part, sub in cache.items():
        for layer in sub.values():
            for name, t in layer["mix"].items():
                fill = -1 if name == "slot_pos" else 0
                if part == "prefix":
                    t[rows] = fill
                else:
                    t[:, rows] = fill


class SlotState:
    """Host bookkeeping for one occupied slot."""

    def __init__(self, request: Request, completion: Completion):
        self.request = request
        self.completion = completion
        # Decode tokens still owed AFTER the prefill token; mirrors the
        # device-side ``rem`` counter. Set when the first token lands.
        self.remaining = request.max_new_tokens - 1
        self.awaiting_first = True


class _AdmitGroup:
    """One bucketed admission launch awaiting its boundary transfer."""

    def __init__(self, rows: List[Tuple[int, int]], first: Any, done: Any,
                 tick: int):
        self.rows = rows          # [(row index in batch, slot index)]
        self.first = first        # (W,) device tensor
        self.done = done          # (W,) bool device tensor
        self.tick = tick          # boundary tick the admission happened


class Lane:
    """Width-W continuous batch of one (base_cfg, mod_cfg) pair."""

    def __init__(self, base_cfg: ModelConfig, mod_cfg: ModelConfig,
                 modular_params: Any, base_template: Any, *,
                 width: int, cache_len: int, device,
                 bucket_edges: Optional[Sequence[int]] = None):
        if base_cfg.d_fusion != mod_cfg.d_fusion:
            raise ValueError("lane arch pair disagrees on d_fusion")
        check_supported(base_cfg)
        check_supported(mod_cfg)
        self.base_cfg = base_cfg
        self.mod_cfg = mod_cfg
        self.width = int(width)
        self.cache_len = int(cache_len)
        self.device = torch.device(device)
        self.bucket_edges = sorted(
            int(e) for e in (bucket_edges or
                             default_bucket_edges(self.cache_len)))
        if self.bucket_edges[-1] < self.cache_len:
            self.bucket_edges.append(self.cache_len)
        # The shared modular block, cast to the compute dtype once.
        self.modular = nn.cast_for_compute(
            nn.tree_map(lambda a: a.to(self.device), modular_params),
            nn.dtype_of(mod_cfg.compute_dtype))
        self._base_template = base_template
        # Decode steps (ticks and prefill positions) this lane has run:
        # each is one composed step over all W rows.
        self.composed_steps = 0
        self._reset_state()

    def _reset_state(self) -> None:
        """Empty slots: zero base params, fresh caches, stop state off."""
        W, dev = self.width, self.device
        self.base_stack = _zero_stack(
            self._base_template, W, nn.dtype_of(self.base_cfg.compute_dtype),
            dev)
        self.cache = init_composed_cache(self.base_cfg, self.mod_cfg, W,
                                         self.cache_len, device=dev)
        self.tok = torch.zeros((W,), dtype=torch.long, device=dev)
        self.pos = torch.zeros((W,), dtype=torch.long, device=dev)
        # On-device stop state: rem = decode tokens still owed (0 =
        # stopped or empty), eos = per-slot eos id (-1 disables).
        self.rem = torch.zeros((W,), dtype=torch.long, device=dev)
        self.eos = torch.full((W,), -1, dtype=torch.long, device=dev)
        self.slots: List[Optional[SlotState]] = [None] * W
        self._admits: List[_AdmitGroup] = []
        self._window: Optional[torch.Tensor] = None  # (S, W) device tokens
        self._window_span: Tuple[int, int] = (0, 0)  # (tick0, S)

    def fresh_clone(self) -> "Lane":
        """An empty lane of the same pair and width sharing this lane's
        cast modular block: the oracle's fixed-batch twin."""
        clone = object.__new__(Lane)
        for name in ("base_cfg", "mod_cfg", "width", "cache_len", "device",
                     "modular", "_base_template"):
            setattr(clone, name, getattr(self, name))
        clone.bucket_edges = list(self.bucket_edges)
        clone.composed_steps = 0
        clone._reset_state()
        return clone

    # ------------------------------------------------------- occupancy

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def bucket(self, prompt_len: int) -> int:
        for e in self.bucket_edges:
            if prompt_len <= e:
                return e
        return self.cache_len

    # -------------------------------------------------------- admit

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def admit_batch(self, admits: List[Tuple[Request, Any]],
                    tick: int) -> None:
        """Admit up to ``len(free_slots())`` requests at a horizon
        boundary: group by prompt-length bucket and run ONE W-row
        prefill per bucket, each request in the row of its slot. No
        device-to-host transfer: the first tokens (and device-side
        EOS/length-1 completion flags) come with the engine's next
        fetch."""
        if not admits:
            return
        for req, _ in admits:
            require_greedy(req)
        free = self.free_slots()
        if len(admits) > len(free):
            raise RuntimeError("admit_batch() with too few free slots")
        W = self.width
        by_bucket: Dict[int, List[Tuple[Request, Any, int]]] = {}
        for (req, base), slot in zip(admits, free):
            by_bucket.setdefault(self.bucket(len(req.prompt)), []).append(
                (req, base, slot))
        for P, group in by_bucket.items():
            prompts = np.zeros((W, P), np.int64)
            lens = np.zeros((W,), np.int64)  # 0 = row not admitted
            max_new = np.ones((W,), np.int64)
            eos_rows = np.full((W,), -1, np.int64)
            slots = []
            for req, base, slot in group:
                prompts[slot, : len(req.prompt)] = req.prompt
                lens[slot] = len(req.prompt)
                max_new[slot] = req.max_new_tokens
                eos_rows[slot] = req.eos_id
                slots.append(slot)
                _copy_into_slot(self.base_stack, base, slot)
                comp = Completion(
                    rid=req.rid, tenant=req.tenant,
                    prompt_len=len(req.prompt), arrival=req.arrival,
                    admitted_tick=tick,
                )
                self.slots[slot] = SlotState(req, comp)
            _reset_cache_rows(self.cache, self._tensor(np.array(slots)))
            lens_t = self._tensor(lens)
            last, self.cache = composed_prefill_ragged(
                self.base_stack, self.base_cfg, self.modular, self.mod_cfg,
                self.cache, self._tensor(prompts), lens_t)
            self.composed_steps += P
            first = last.argmax(dim=-1)
            max_new_t, eos_t = self._tensor(max_new), self._tensor(eos_rows)
            done = (first == eos_t) | (max_new_t <= 1)
            admitted = lens_t > 0
            self.tok = torch.where(admitted, first, self.tok)
            self.pos = torch.where(admitted, lens_t, self.pos)
            self.rem = torch.where(admitted,
                                   torch.where(done, 0, max_new_t - 1),
                                   self.rem)
            self.eos = torch.where(admitted, eos_t, self.eos)
            self._admits.append(
                _AdmitGroup([(s, s) for s in slots], first, done, tick))

    # -------------------------------------------------------- decode

    def launch_horizon(self, S: int, tick0: int) -> None:
        """Run S decode ticks of every slot (no host sync): the same
        W-row step S times, the stop state updated on the device. The
        emitted (S, W) token window goes to the engine's fetch via
        :meth:`pending_transfer`."""
        tok, pos, rem = self.tok, self.pos, self.rem
        toks = []
        for _ in range(S):
            logits, self.cache = composed_decode_step(
                self.base_stack, self.base_cfg, self.modular, self.mod_cfg,
                self.cache, tok[:, None], pos)
            nxt = logits[:, -1].argmax(dim=-1)
            live = rem > 0
            stop = (nxt == self.eos) | (rem == 1)
            rem = torch.where(live & ~stop, rem - 1, 0)
            tok, pos = nxt, pos + 1
            toks.append(nxt)
        self.tok, self.pos, self.rem = tok, pos, rem
        self.composed_steps += S
        self._window = torch.stack(toks)
        self._window_span = (tick0, S)

    def pending_transfer(self) -> Dict[str, Any]:
        """Device tensors the engine must fetch this step: the horizon
        window just launched plus any admission outputs (first tokens +
        device-side done flags) from the previous boundary."""
        out: Dict[str, Any] = {}
        if self._window is not None:
            out["window"] = self._window
        if self._admits:
            out["admit"] = [(g.first, g.done) for g in self._admits]
        return out

    def absorb(self, host: Dict[str, Any]) -> List[Completion]:
        """Host bookkeeping for one fetched step: land the previous
        boundary's first tokens (evicting prefill-completed slots), then
        walk each occupied slot's emitted window up to its stop point.
        Pure numpy: the one device sync already happened in the
        engine's fetch."""
        done: List[Completion] = []
        for group, (first, done_flags) in zip(self._admits,
                                              host.get("admit", [])):
            for row, slot in group.rows:
                s = self.slots[slot]
                t = int(first[row])
                s.completion.tokens.append(t)
                s.completion.token_ticks.append(group.tick)
                s.awaiting_first = False
                if bool(done_flags[row]):
                    s.completion.finish_reason = (
                        "eos" if t == s.request.eos_id else "length")
                    s.completion.finished_tick = group.tick
                    done.append(s.completion)
                    self.slots[slot] = None
        self._admits = []
        window = host.get("window")
        if window is not None:
            tick0, S = self._window_span
            for i, s in enumerate(self.slots):
                if s is None or s.awaiting_first:
                    continue
                for step in range(S):
                    t = int(window[step][i])
                    s.completion.tokens.append(t)
                    s.completion.token_ticks.append(tick0 + step)
                    s.remaining -= 1
                    if t == s.request.eos_id:
                        s.completion.finish_reason = "eos"
                    elif s.remaining > 0:
                        continue
                    s.completion.finished_tick = tick0 + step
                    done.append(s.completion)
                    self.slots[i] = None
                    break
            self._window = None
        return done
