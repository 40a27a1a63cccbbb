"""The exchange plane — the eager IFL uplink/downlink wire pipeline.

The port's copy of the eager half of ``repro.core.exchange``:

  ``ExchangePlane``   the base plane: the :class:`CommLedger` every
                      boundary byte routes through.
  ``FusionCache``     the server's staleness-bounded cache of decoded
                      fusion payloads, one entry per client slot.
  ``FusionExchange``  codec + per-client EF21 residuals + the cache +
                      the broadcast policy.

``FusionExchange.upload`` encodes with the EF residual threaded through,
ledgers exactly the encoded payload and the labels, and decodes once into
the cache. The encode is the kernel dispatch point: a codec with a wire
scheme (int8_row, int4, topk, sketch and their ``ef(...)``) goes through
``repro_torch.kernels.ops.wire_encode`` / ``wire_encode_ef`` — on the
card, the hand-written kernels; every other codec encodes with its plain
ops on every device, the reference's rule.

Broadcast policy (the downlink): ``broadcast_round`` serves the valid
cache, in slot order. Under ``"full"`` every participant receives the
whole M-entry cache (K * M entries down). Under ``"delta"`` every client
keeps a *mirror* of the server cache (``_DeltaMirrors``, versioned by
upload round): the server ships each (slot, payload, y) entry at most
once a round, the union of what the participants' mirrors lack, plus a
``DELTA_SIDECAR_BYTES`` sidecar per entry, and every participant's
mirror becomes the server's valid cache. The decoded pairs the modular
updates train on are the same under both policies by construction; only
the downlink bytes differ (``comm.ifl_round_bytes(..., broadcast=,
delta_entries=)``, in exact per-round parity with the ledger).

``cache_tree`` / ``restore_cache`` and ``aux_state`` / ``restore_aux``
snapshot the cache (stacked over all N slots, so the tree's shape does
not depend on the round) and the mirrors, so a resumed run replays its
mid-staleness broadcasts bit for bit.

Population regime (``population=True``, a C-of-N cohort a round): the
broadcast serves the round's fresh cohort uploads only, so the downlink
and the modular updates scale in C, never in N; EF residuals are built
on a slot's first upload (``_LazySlotState``: zeros, so lazy == eager
bitwise); and ``prune``, which the round engine calls every round, ages
the EF residuals and delta mirrors of clients that have not uploaded
within ``max_staleness`` rounds out of memory. A client that comes back
restarts from a zero residual and an empty mirror (the normal delta
catch-up), exactly the state of a client never seen. A population
trainer snapshots the cache sparsely, slot by slot, never through
``cache_tree``, which stacks all N slots.

``SPMDFusionExchange`` is the one-card counterpart of the reference's
SPMD backend: the wire block of the LM round step
(``repro_torch.core.ifl_spmd``) over a stacked client dim, at full
participation. On one card the 'client'-axis all-gather is the stacking
of the N payloads, and the receivers decode them.

Not ported yet (ROADMAP.md queue 1, item 4b): the SPMD backend's
partial participation (payload cache, ``max_staleness``), delta
broadcast and host-side ``account_round``, with ``expected_delta_entries``
that replays through it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.codec import Codec, get_codec
from repro_torch.core.comm import DELTA_SIDECAR_BYTES, CommLedger

__all__ = [
    "BROADCAST_POLICIES",
    "parse_broadcast",
    "ExchangePlane",
    "CacheEntry",
    "FusionCache",
    "FusionExchange",
    "SPMDFusionExchange",
    "init_ef_state",
]


BROADCAST_POLICIES = ("full", "delta")


def parse_broadcast(spec: Optional[str]) -> str:
    """Validate a broadcast-policy spec: ``full`` | ``delta``."""
    if spec is None:
        return "full"
    if spec not in BROADCAST_POLICIES:
        raise ValueError(f"unknown broadcast policy {spec!r}; expected one "
                         f"of {BROADCAST_POLICIES}")
    return spec


class ExchangePlane:
    """Base plane: the one ledger every boundary byte routes through."""

    def __init__(self):
        self.ledger = CommLedger()

    def up(self, tree) -> None:
        """Client -> server: ledger the measured bytes of ``tree``."""
        self.ledger.send_up(tree)

    def down(self, tree) -> None:
        """Server -> client: ledger the measured bytes of ``tree``."""
        self.ledger.send_down(tree)

    def down_bytes(self, b: int) -> None:
        self.ledger.send_down_bytes(b)

    def aux_state(self) -> Dict[str, Any]:
        """JSON-able plane state beyond the ledger (which the engine's aux
        carries). Empty for the base plane."""
        return {}

    def restore_aux(self, aux: Dict[str, Any]) -> None:
        pass

    def prune(self, round_idx: int) -> None:
        """Age per-client carried state out of memory; the round engine
        calls it every ``end_round``. A no-op but on a population-regime
        fusion plane."""
        return None


@dataclass
class CacheEntry:
    """Last upload of one client slot, as the server decoded it."""

    payload: Any  # the encoded wire payload (what a broadcast re-ships)
    z_hat: Any  # decoded fusion output — what modular updates train on
    y: Any  # labels (ride uncompressed)
    round_idx: int  # round the payload was uploaded (staleness anchor)


class FusionCache:
    """Server-side staleness-bounded cache of decoded fusion payloads:
    one entry per client slot; ``valid_entries`` returns the slots at most
    ``max_staleness`` rounds old, slot-ordered, and evicts the rest."""

    def __init__(self, max_staleness: Optional[int] = None):
        if max_staleness is not None and max_staleness < 0:
            raise ValueError("max_staleness must be >= 0 or None")
        self.max_staleness = max_staleness
        self._entries: Dict[int, CacheEntry] = {}

    def put(self, slot: int, *, payload, z_hat, y, round_idx: int) -> None:
        self._entries[slot] = CacheEntry(payload, z_hat, y, round_idx)

    def prune(self, round_idx: int) -> List[int]:
        """Evict entries older than ``max_staleness``; return their slots."""
        if self.max_staleness is None:
            return []
        expired = [s for s, e in self._entries.items()
                   if round_idx - e.round_idx > self.max_staleness]
        for s in expired:
            del self._entries[s]
        return expired

    def valid_entries(self, round_idx: int) -> List[Tuple[int, CacheEntry]]:
        """(slot, entry) pairs within the staleness bound, slot-ordered."""
        self.prune(round_idx)
        return sorted(self._entries.items())

    def staleness(self, round_idx: int) -> Dict[int, int]:
        """Per-slot age (rounds since upload) of the current entries."""
        return {s: round_idx - e.round_idx
                for s, e in sorted(self._entries.items())}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, slot: int) -> bool:
        return slot in self._entries


class _DeltaMirrors:
    """Per-client mirrors of the server fusion cache, versions only: a
    mirror maps slot -> upload round of the entry the client holds (one
    upload per slot per round makes the round a monotone version).
    ``sync`` ships the union of the valid entries the participants'
    mirrors lack and sets each participant's mirror to the server's
    valid cache; absent clients' mirrors are untouched and catch up the
    round they rejoin."""

    def __init__(self, n_clients: int):
        self.versions: List[Dict[int, int]] = [{} for _ in range(n_clients)]

    def note_upload(self, slot: int, round_idx: int) -> None:
        """The uploader made this payload itself: its own mirror entry is
        current with no downlink."""
        self.versions[slot][slot] = int(round_idx)

    def sync(self, participants: Sequence[int],
             valid: Sequence[Tuple[int, int]]) -> List[int]:
        """-> the sorted slots shipped; every participant's mirror becomes
        the server's valid cache (``valid``: (slot, version) pairs)."""
        valid_d = {int(s): int(v) for s, v in valid}
        shipped: set = set()
        for p in participants:
            mine = self.versions[int(p)]
            shipped.update(s for s, v in valid_d.items() if mine.get(s) != v)
            self.versions[int(p)] = dict(valid_d)
        return sorted(shipped)

    # JSON-able state (a manifest's ``extra`` turns int keys into strings).

    def aux_state(self) -> List[Dict[str, int]]:
        return [{str(s): int(v) for s, v in m.items()}
                for m in self.versions]

    def restore_aux(self, aux: List[Dict[str, int]]) -> None:
        self.versions = [{int(s): int(v) for s, v in m.items()}
                         for m in aux]


class _LazySlotState(dict):
    """slot -> state dict that builds an entry on first access.
    ``init_fn`` must be deterministic in the slot (the EF init is zeros),
    so lazy and eager are bitwise the same."""

    def __init__(self, init_fn):
        super().__init__()
        self._init = init_fn

    def __missing__(self, slot):
        state = self._init(slot)
        self[slot] = state
        return state


class FusionExchange(ExchangePlane):
    """Eager IFL wire pipeline: codec + EF residuals + cache + policy.

    ``z_shape`` is one client's fusion-output shape ``(batch_size,
    d_fusion)``; ``device`` is where the EF residuals and the snapshot's
    empty cache slots live (the fusion outputs' device);
    ``population`` switches on the cohort regime (module docstring)."""

    def __init__(self, codec: Union[str, Codec, None], n_clients: int,
                 z_shape: Tuple[int, ...], *,
                 max_staleness: Optional[int] = None,
                 broadcast: str = "full",
                 population: bool = False,
                 device=None):
        super().__init__()
        self.codec = get_codec(codec)
        self.n_clients = n_clients
        self.z_shape = tuple(z_shape)
        self.broadcast = parse_broadcast(broadcast)
        self.population = bool(population)
        self.device = device
        self.cache = FusionCache(max_staleness)
        self.mirrors = _DeltaMirrors(n_clients)
        self._last_upload: Dict[int, int] = {}
        # Per-client EF residual (an empty tuple for stateless codecs),
        # keyed by client slot, built on first use; client-private, never
        # ledgered.
        self.ef_state: Dict[int, Any] = _LazySlotState(
            lambda slot: self.codec.init_state(self.z_shape, device=device))

    def encode_with_state(self, z: torch.Tensor, state):
        """EF-threaded encode: the wire kernel for a codec with a wire
        scheme, the codec's plain ops for one without (see module
        docstring)."""
        out = self.codec.fused_encode_with_state(z, state)
        return self.codec.encode_with_state(z, state) if out is None else out

    def decode(self, payload) -> torch.Tensor:
        return self.codec.decode(payload, shape=self.z_shape,
                                 dtype=torch.float32)

    def upload(self, slot: int, z, y, round_idx: int) -> None:
        """One client's fresh fusion upload: EF-threaded encode, ledger
        the encoded payload (+ labels), decode once into the cache."""
        slot = int(slot)
        payload, self.ef_state[slot] = self.encode_with_state(
            z, self.ef_state[slot])
        self.up((payload, y))  # the ONLY uplink bytes in IFL
        self.cache.put(slot, payload=payload, z_hat=self.decode(payload),
                       y=y, round_idx=round_idx)
        self.mirrors.note_upload(slot, round_idx)
        self._last_upload[slot] = int(round_idx)

    def broadcast_round(self, participants: Sequence[int], round_idx: int):
        """Serve the valid cache to the participants under the policy ->
        (Z, Y, entries, shipped): the decoded pairs the modular updates
        consume, in slot order (the same under both policies), the (slot,
        entry) list behind them, and the slots the delta policy shipped
        (empty under ``full``). In the population regime the entries are
        the round's fresh cohort uploads only."""
        entries = self.cache.valid_entries(round_idx)
        if self.population:
            entries = [(s, e) for s, e in entries
                       if e.round_idx == round_idx]
        Z = [e.z_hat for _, e in entries]
        Y = [e.y for _, e in entries]
        shipped: List[int] = []
        if self.broadcast == "full":
            payloads = [e.payload for _, e in entries]
            for _ in participants:
                self.down((payloads, Y))
        else:
            shipped = self.mirrors.sync(
                participants, [(s, e.round_idx) for s, e in entries])
            if shipped:
                by_slot = dict(entries)
                self.down(([by_slot[s].payload for s in shipped],
                           [by_slot[s].y for s in shipped]))
                self.down_bytes(len(shipped) * DELTA_SIDECAR_BYTES)
        return Z, Y, entries, shipped

    def prune(self, round_idx: int) -> None:
        """Population regime only: drop the EF residuals and delta mirrors
        of clients whose last upload is more than ``max_staleness``
        rounds old. Outside it every residual stays frozen across
        absences, as the reference keeps it."""
        if not self.population or self.cache.max_staleness is None:
            return
        bound = self.cache.max_staleness
        stale = [s for s, r in self._last_upload.items()
                 if round_idx - r > bound]
        for s in stale:
            del self._last_upload[s]
            self.ef_state.pop(s, None)
            self.mirrors.versions[s].clear()

    # ------------------------------------------------- snapshot / restore

    def cache_tree(self) -> Dict[str, Any]:
        """The cache as a fixed-shape tree: every one of the N slots
        stacked (an empty slot carries ``encode(zeros)``, zero z_hat and
        labels), so a checkpoint template holds it whatever the round;
        ``aux_state()['cache_rounds']`` marks the real slots."""
        z0 = torch.zeros(self.z_shape, dtype=torch.float32,
                         device=self.device)
        empty = self.codec.encode(z0)
        y0 = torch.zeros((self.z_shape[0],), dtype=torch.int32,
                         device=self.device)
        pays, zhs, ys = [], [], []
        for s in range(self.n_clients):
            e = self.cache._entries.get(s)
            pays.append(e.payload if e is not None else empty)
            zhs.append(e.z_hat if e is not None else z0)
            ys.append(e.y if e is not None else y0)
        return {"payload": {k: torch.stack([p[k] for p in pays])
                            for k in empty},
                "z_hat": torch.stack(zhs),
                "y": torch.stack(ys)}

    def restore_cache(self, tree: Dict[str, Any],
                      cache_rounds: Sequence[Optional[int]]) -> None:
        """Inverse of ``cache_tree``: rebuild the entries in place (the
        engine and the trainer hold this cache object)."""
        self.cache._entries = {
            s: CacheEntry(payload={k: v[s] for k, v in tree["payload"].items()},
                          z_hat=tree["z_hat"][s], y=tree["y"][s],
                          round_idx=int(r))
            for s, r in enumerate(cache_rounds) if r is not None
        }

    def aux_state(self) -> Dict[str, Any]:
        entries = self.cache._entries
        return {
            "cache_rounds": [int(entries[s].round_idx) if s in entries
                             else None for s in range(self.n_clients)],
            "mirrors": self.mirrors.aux_state(),
        }

    def restore_aux(self, aux: Dict[str, Any]) -> None:
        # The entries are arrays: the trainer hands its snapshot tree to
        # ``restore_cache`` (with aux['cache_rounds']) after this.
        self.mirrors.restore_aux(aux["mirrors"])


_SPMD_TODO = ("ROADMAP.md queue 1, item 4b: the SPMD trainer, with its "
              "partial participation and staleness")


class SPMDFusionExchange(ExchangePlane):
    """The fusion wire block of the LM round step over a stacked client
    dim, on one card, at full participation.

    ``wire(z, tokens, mask, cache, ef_state)`` takes the N clients'
    fusion outputs stacked as z (N, Bc, S, d_fusion) and their tokens
    (N, Bc, S). A codec with a wire scheme encodes all N clients' rows
    in one ``wire_encode`` / ``wire_encode_ef`` call (the rows of a
    row-wise scheme are independent, so this is the per-client encode;
    the reference's fused path flattens the same axes), with z in fp32,
    the kernel's input type (every scheme's plain encode upcasts to fp32
    first). Every other codec encodes each client's z as it is. The
    payloads, "gathered" (stacked), are decoded to z's dtype.
    """

    def __init__(self, codec: Union[str, Codec, None], *, n_clients: int,
                 max_staleness: Optional[int] = None,
                 broadcast: str = "full"):
        if max_staleness is not None or broadcast != "full":
            raise NotImplementedError(
                f"max_staleness={max_staleness!r}, broadcast={broadcast!r}: "
                f"only full participation with a full broadcast is ported "
                f"({_SPMD_TODO})")
        super().__init__()
        self.codec = get_codec(codec)
        self.n_clients = n_clients

    def _encode_rows(self, z, ef_state):
        """The fused encode of all rows -> (payload, ef') or None."""
        zf = z.float()
        if self.codec.has_state:
            return self.codec.fused_encode_with_state(zf, ef_state)
        payload = self.codec.fused_encode(zf)
        return None if payload is None else (payload, ef_state)

    def wire(self, z, tokens, mask, cache, ef_state):
        """-> (zg, yg, valid, new_cache, ef_state'): the gathered decoded
        fusion outputs (N, Bc, S, d_fusion) in z's dtype and their tokens,
        ``valid`` and ``new_cache`` None (full participation), and the
        EF residual (N, Bc, S, d_fusion) threaded through (``()`` for a
        stateless codec)."""
        if mask is not None or cache is not None:
            raise NotImplementedError(
                f"partial participation on the SPMD path ({_SPMD_TODO})")
        shape = tuple(z.shape[1:])
        out = self._encode_rows(z, ef_state)
        if out is not None:
            payload, ef_state = out
            zg = self.codec.decode(payload, shape=tuple(z.shape),
                                   dtype=z.dtype)
            return zg, tokens, None, None, ef_state
        payloads, efs = [], []
        for k in range(z.shape[0]):
            if self.codec.has_state:
                p, e = self.codec.encode_with_state(z[k], ef_state[k])
                efs.append(e)
            else:
                p = self.codec.encode(z[k])
            payloads.append(p)
        if self.codec.has_state:
            ef_state = torch.stack(efs)
        zg = torch.stack([self.codec.decode(p, shape=shape, dtype=z.dtype)
                          for p in payloads])
        return zg, tokens, None, None, ef_state


def init_ef_state(codec, z_shape: Tuple[int, ...], *, device=None):
    """Initial carried EF residual for ``make_ifl_round_step``: zeros of
    the stacked fusion-output shape (N, Bc, S, d_fusion) for an
    ``ef(...)`` codec, ``()`` for a stateless one."""
    return get_codec(codec).init_state(tuple(z_shape), device=device)
