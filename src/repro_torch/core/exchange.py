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

``SPMDFusionExchange`` is the counterpart of the reference's SPMD
backend: the wire block of the LM round step
(``repro_torch.core.ifl_spmd``) over a stacked client dim, with partial
participation (the carried payload cache, ``max_staleness``), the full
or delta broadcast, the population regime and the host-side
``account_round``; ``expected_delta_entries`` replays a schedule
through it, and ``init_ef_state`` / ``init_payload_cache`` build its
carried state. Without a mesh the 'client'-axis all-gather is the
stacking of the N payloads in one process; on a ('client', 'data',
'model') mesh it is a real all-gather of the encoded payload over the
client group.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
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
    "expected_delta_entries",
    "init_ef_state",
    "init_payload_cache",
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

    def up_bytes(self, b: int) -> None:
        self.ledger.send_up_bytes(b)

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




# ------------------------------------------------------------ SPMD backend


_NEVER = 2 ** 30  # age of a never-filled cache slot (always invalid)


def _tree_where(mask: torch.Tensor, new, old):
    """Per-client select over trees whose leaves lead with (N,): client k
    takes ``new`` where ``mask[k]``, else ``old`` (the reference's
    ``_tree_where``)."""
    if isinstance(new, dict):
        return {k: _tree_where(mask, new[k], old[k]) for k in new}
    m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


class SPMDFusionExchange(ExchangePlane):
    """The fusion wire block of the LM round step over a stacked client
    dim: the port of the reference's SPMD backend.

    ``wire(z, tokens, mask, cache, ef_state)`` is the in-step half. It
    takes the clients' fusion outputs stacked as z (n, Bc, S, d_fusion)
    and their tokens (n, Bc, S). A codec with a wire scheme encodes all n
    clients' rows in one ``wire_encode`` / ``wire_encode_ef`` call (the
    rows of a row-wise scheme are independent, so this is the
    per-client encode; the reference's fused path flattens the same
    axes), with z in fp32, the kernel's input type (every scheme's plain
    encode upcasts to fp32 first). Every other codec encodes each
    client's z as it is.

    Without a mesh, n is N and the reference's 'client'-axis all-gather
    is the stacked payload itself. With ``mesh`` (a ('client', 'data',
    'model') ``DeviceMesh``, ``launch.mesh.ClientLayout``) each rank
    holds its block of n = N / C clients and its rows of their
    minibatches; ``wire`` encodes only those rows, then gathers every
    payload leaf and the labels over the client group, in client order,
    each leaf in its own dtype (a bool leaf as uint8): the paper's
    upload + concat + broadcast as one collective of the compressed
    bytes. The rows stay this rank's after the gather (the reference's
    ``_gather_payload`` keeps 'data' on the per-client batch axis), so a
    codec that encodes a client's whole tensor at once (``int8``,
    ``int8_channel``) needs a data axis of 1. The EF residual and the
    payload cache never cross: they stay this rank's block, as the
    reference's ``_ef_constrain`` / ``_cache_constrain`` keep them
    (``carried_pspecs``). ``gathered`` records what each wire call hands
    to the collective, in bytes per part (payload, labels, and the cache
    ages under a mask); with ``time_gather`` set it also records the
    gathers' wall seconds, from a barrier of the client group (the
    device synchronized) to the device synchronized after.

    Under partial participation (``mask``, the (N,) bool vector, not
    None) the carried payload cache (``init_payload_cache``) is refreshed
    for the participants only: the one encode is selected by the mask
    (``_tree_where``), so absent clients keep their EF residual and
    their cache slot bitwise, ``age`` is 0 for a participant and
    ``min(age, _NEVER - 1) + 1`` for everyone else, and ``valid = age <=
    age_bound`` weights the cached chunks of the modular update (the
    eager cache's eviction, at fixed shapes). A rank none of whose
    clients takes part encodes nothing, but still joins the gather.

    The host half: ``account_round`` replays the mask stream against a
    host replica of the cache ages (``_last_upload``, equal to the
    in-step ``age`` vector: both are functions of the mask history) and
    ledgers the codec's analytic ``encoded_nbytes`` per boundary
    crossing under the full or delta policy, with the eager plane's
    ``_DeltaMirrors``; on a mesh every rank keeps the same replica and
    the same ledger. ``population=True`` (the cohort regime) accounts
    the round's fresh cohort only and lets ``prune`` age mirrors out.
    ``expected_delta_entries`` replays a schedule through it.
    """

    def __init__(self, codec: Union[str, Codec, None], *, n_clients: int,
                 max_staleness: Optional[int] = None,
                 broadcast: str = "full", population: bool = False,
                 mesh=None):
        super().__init__()
        self.codec = get_codec(codec)
        self.n_clients = n_clients
        self.max_staleness = max_staleness
        self.broadcast = parse_broadcast(broadcast)
        self.population = bool(population)
        self.age_bound = (_NEVER - 1 if max_staleness is None
                          else int(max_staleness))
        self.mirrors = _DeltaMirrors(n_clients)
        # Host replica of each slot's last upload round (None = never).
        self._last_upload: List[Optional[int]] = [None] * n_clients
        self.mesh = mesh
        self.layout = None
        if mesh is not None:
            from repro_torch.launch.mesh import ClientLayout

            self.layout = ClientLayout.of(mesh, n_clients)
        self.gathered: List[Dict[str, float]] = []
        self.time_gather = False

    # ------------------------------------------------ in-step wire

    def _encode(self, z, ef_state):
        """All n clients' payloads, stacked leaf by leaf, and the EF
        residual threaded through -> (payload, ef')."""
        zf = z.float()
        if self.codec.has_state:
            out = self.codec.fused_encode_with_state(zf, ef_state)
        else:
            payload = self.codec.fused_encode(zf)
            out = None if payload is None else (payload, ef_state)
        if out is not None:
            return out
        pays, efs = [], []
        for k in range(z.shape[0]):
            if self.codec.has_state:
                p, e = self.codec.encode_with_state(z[k], ef_state[k])
                efs.append(e)
            else:
                p = self.codec.encode(z[k])
            pays.append(p)
        payload = {name: torch.stack([p[name] for p in pays])
                   for name in pays[0]}
        return payload, (torch.stack(efs) if efs else ef_state)

    def _decode(self, payload, shape, dtype, keep=None) -> torch.Tensor:
        """The stacked payload decoded -> (n, *shape) in ``dtype``. A
        row-wise wire scheme's payload decodes in one call over all n
        clients' rows; any other codec decodes client by client, and
        only the clients in ``keep`` (None: all), zeros elsewhere."""
        lead = next(iter(payload.values()))
        n = lead.shape[0]
        if self._rowwise(shape[-1]):
            return self.codec.decode(payload, shape=(n,) + tuple(shape),
                                     dtype=dtype)
        zero = torch.zeros(tuple(shape), dtype=dtype, device=lead.device)
        return torch.stack([
            self.codec.decode({name: v[k] for name, v in payload.items()},
                              shape=tuple(shape), dtype=dtype)
            if keep is None or k in keep else zero for k in range(n)])

    def _rowwise(self, d: int) -> bool:
        """True when the codec (or the one ``ef(...)`` wraps) has a wire
        scheme at fusion dim ``d``: its payload leaves keep z's leading
        dims, so the stacked payload is one payload of (N, *shape)."""
        from repro_torch.kernels import ops

        return ops.scheme_for(getattr(self.codec, "inner", self.codec),
                              d) is not None

    def _row_local(self, d: int) -> bool:
        """True when a row's payload depends on that row alone (a wire
        scheme, the identity, a cast), so a data rank can encode its
        rows by itself."""
        from repro_torch.core.codec import CastCodec, IdentityCodec

        inner = getattr(self.codec, "inner", self.codec)
        return self._rowwise(d) or isinstance(inner,
                                              (IdentityCodec, CastCodec))

    def _gather(self, parts: Dict[str, Any]) -> Dict[str, Any]:
        """Each part's tensors (payload leaves, labels, ages) gathered
        over the client group in client order; records the bytes handed
        to the collective (and the wall, under ``time_gather``)."""
        from repro_torch.sharding.rules import all_gather_cat

        import torch.distributed as dist

        group = self.layout.client_group
        rec: Dict[str, float] = {}
        if self.time_gather:
            # The gathers alone: every rank of the group has arrived.
            if self.layout.mesh.device_type == "cuda":
                torch.cuda.synchronize()
            dist.barrier(group=group)
        t0 = time.perf_counter()
        out = {}
        for key, tree in parts.items():
            leaves = tree if isinstance(tree, dict) else {"": tree}
            rec[key] = float(sum(v.numel() * v.element_size()
                                 for v in leaves.values()))
            got = {name: all_gather_cat(v, group, 0)
                   for name, v in leaves.items()}
            out[key] = got if isinstance(tree, dict) else got[""]
        if self.time_gather:
            if self.layout.mesh.device_type == "cuda":
                torch.cuda.synchronize()
            rec["seconds"] = time.perf_counter() - t0
        self.gathered.append(rec)
        return out

    def wire(self, z, tokens, mask, cache, ef_state):
        """-> (zg, yg, valid, new_cache, ef_state'): the decoded fusion
        outputs (N, Bc, S, d_fusion) in z's dtype and their tokens,
        ``valid`` the (N,) 0/1 fp32 staleness weights and ``new_cache``
        the refreshed cache (both None at full participation), and the
        EF residual (``()`` for a stateless codec). ``mask`` is an (N,)
        bool tensor; absent clients' rows of z are never read. On a mesh
        z, tokens, the cache and the EF residual are this rank's block
        (its clients, its rows), and so are the rows of zg and yg: all N
        clients, this rank's rows. The staleness arithmetic runs where
        the cache's ``age`` lives: on the host in a dry-run on the meta
        device (``init_payload_cache``'s ``age_device``), whose tensors
        have no values to read."""
        shape = tuple(z.shape[1:])
        lay = self.layout
        if lay is not None and lay.n_data > 1 and not self._row_local(
                shape[-1]):
            raise ValueError(
                f"codec {self.codec.name!r} encodes a client's whole "
                "tensor at once; on a data axis above 1 use a row-wise "
                "codec (a wire scheme, fp32 or a cast)")
        if mask is None:
            payload, ef_state = self._encode(z, ef_state)
            if lay is None:
                return (self._decode(payload, shape, z.dtype), tokens, None,
                        None, ef_state)
            got = self._gather({"payload": payload,
                                "labels": tokens.to(torch.int32)})
            return (self._decode(got["payload"], shape, z.dtype),
                    got["labels"], None, None, ef_state)
        own = mask if lay is None else mask[lay.clients]
        any_upload = bool(own.any())
        age_mask = own.to(device=cache["age"].device, dtype=torch.bool)
        own = own.to(device=z.device, dtype=torch.bool)
        payload, toks = cache["payload"], cache["tokens"]
        if any_upload:
            enc, ef_new = self._encode(z, ef_state)
            if self.codec.has_state:
                ef_state = _tree_where(own, ef_new, ef_state)
            payload = _tree_where(own, enc, payload)
            toks = _tree_where(own, tokens.to(toks.dtype), toks)
        age = torch.where(age_mask, torch.zeros_like(cache["age"]),
                          torch.clamp_max(cache["age"], _NEVER - 1) + 1)
        new_cache = {"payload": payload, "tokens": toks, "age": age}
        if lay is not None:
            got = self._gather({"payload": payload, "labels": toks,
                                "age": age})
            payload, toks, age = got["payload"], got["labels"], got["age"]
        valid = (age <= self.age_bound).float()
        keep = set(torch.nonzero(valid.cpu()).flatten().tolist())
        return (self._decode(payload, shape, z.dtype, keep), toks, valid,
                new_cache, ef_state)

    def carried_pspecs(self, tree):
        """The mesh layout of the carried state a round step threads
        (the EF residual, the payload cache): every leaf leads with its
        clients on 'client' and, where it has rows, their rows on 'data'
        (sidecars of a row-wise scheme too: a scale per row stays with
        its row); the cache ages on 'client' alone."""
        def spec(a):
            return (("client", "data") + (None,) * (a.dim() - 2)
                    if a.dim() >= 2 else ("client",))

        if isinstance(tree, dict):
            return {k: self.carried_pspecs(v) for k, v in tree.items()}
        return spec(tree)

    # ------------------------------------------------ host accounting

    def account_round(self, participants: Sequence[int], round_idx: int,
                      entry_bytes: int) -> Tuple[int, int]:
        """Ledger one round's boundary bytes analytically.

        ``entry_bytes`` is one client's (encoded payload + labels) size.
        Uplink: K fresh entries. Downlink under ``full``: the M valid
        cache entries to each of the K participants; under ``delta``: the
        mirror-sync union once, each entry plus the slot-index sidecar.
        -> ``(valid_entries, shipped_entries)``; ``valid_entries`` equals
        the in-step ``cache_valid`` metric (both replay the mask
        stream)."""
        parts = [int(k) for k in participants]
        for k in parts:
            self._last_upload[k] = int(round_idx)
            # The uploader made this payload: its own mirror entry is
            # current without any downlink (K = 1 rounds ship nothing
            # back to the sole producer).
            self.mirrors.note_upload(k, round_idx)
        bound = 0 if self.population else self.age_bound
        valid = [(s, r) for s, r in enumerate(self._last_upload)
                 if r is not None and round_idx - r <= bound]
        self.up_bytes(len(parts) * entry_bytes)
        shipped: List[int] = []
        if self.broadcast == "full":
            self.down_bytes(len(parts) * len(valid) * entry_bytes)
        else:
            shipped = self.mirrors.sync(parts, valid)
            self.down_bytes(len(shipped) * (entry_bytes + DELTA_SIDECAR_BYTES))
        return len(valid), len(shipped)

    def prune(self, round_idx: int) -> None:
        """Population regime only: forget the mirrors (and upload stamps)
        of clients whose last upload is more than ``max_staleness``
        rounds old; a client that rejoins catches up as a new one."""
        if not self.population or self.max_staleness is None:
            return
        for s, r in enumerate(self._last_upload):
            if r is not None and round_idx - r > self.max_staleness:
                self._last_upload[s] = None
                self.mirrors.versions[s].clear()

    # ------------------------------------------------- snapshot / restore

    def cache_tree(self, cache: Dict[str, Any],
                   z_shape: Tuple[int, ...]) -> Dict[str, Any]:
        """The carried payload cache as the serving plane's fusion state:
        ``{payload, z_hat, y, age}``, every slot's payload decoded to fp32
        z_hat (``z_shape`` is one client's fusion-output shape); the
        ``age`` vector marks the real slots (age <= ``age_bound``)."""
        return {"payload": cache["payload"],
                "z_hat": self._decode(cache["payload"], z_shape,
                                      torch.float32),
                "y": cache["tokens"],
                "age": cache["age"]}

    def aux_state(self) -> Dict[str, Any]:
        return {"last_upload": list(self._last_upload),
                "mirrors": self.mirrors.aux_state()}

    def restore_aux(self, aux: Dict[str, Any]) -> None:
        self._last_upload = [None if r is None else int(r)
                             for r in aux["last_upload"]]
        self.mirrors.restore_aux(aux["mirrors"])


# ------------------------------------------------------ analytic helpers


def expected_delta_entries(schedule, n_clients: int, *,
                           max_staleness: Optional[int] = None,
                           cohort: Optional[int] = None,
                           rounds: int = 256, seed: int = 0) -> float:
    """Mean entries shipped a delta-broadcast round under ``schedule``:
    the schedule's mask stream (and, with ``cohort=C``, the engine's
    uniform C-of-available draw) replayed through a real
    ``SPMDFusionExchange.account_round`` (population regime under a
    cohort), so the price cannot drift from the trainers' ledger."""
    rng = np.random.default_rng(seed)
    plane = SPMDFusionExchange(None, n_clients=n_clients,
                               max_staleness=max_staleness,
                               broadcast="delta",
                               population=cohort is not None)
    total = 0
    for t in range(rounds):
        parts = np.flatnonzero(schedule.mask(t, n_clients, rng))
        if cohort is not None and len(parts) > cohort:
            parts = np.sort(rng.choice(parts, size=cohort, replace=False))
        total += plane.account_round(parts, t, entry_bytes=0)[1]
        plane.prune(t)
    return total / max(rounds, 1)


# ------------------------------------------------------ carried-state init


def init_ef_state(codec, z_shape: Tuple[int, ...], *, device=None):
    """Initial carried EF residual for ``make_ifl_round_step``: zeros of
    the stacked fusion-output shape (N, Bc, S, d_fusion) for an
    ``ef(...)`` codec, ``()`` for a stateless one."""
    return get_codec(codec).init_state(tuple(z_shape), device=device)


def init_payload_cache(codec, z_shape: Tuple[int, ...],
                       token_shape: Tuple[int, ...], *,
                       dtype=torch.float32, device=None,
                       age_device=None) -> Dict[str, Any]:
    """Initial carried payload cache of a partial-participation step:
    ``z_shape`` (N, Bc, S, d_fusion), ``token_shape`` (N, Bc, S). The
    payload is the codec's encode of a zero z, stacked N times (the
    reference's leaf names, dtypes and shapes); tokens are int32 zeros
    and every age is ``_NEVER``: a slot is invalid until its client
    first uploads, whatever the staleness bound. The ages live on
    ``age_device`` (default ``device``): a dry-run on the meta device
    keeps them on the host, with the mask."""
    n = z_shape[0]
    one = get_codec(codec).encode(
        torch.zeros(tuple(z_shape[1:]), dtype=dtype, device=device))
    return {"payload": {k: v.unsqueeze(0).repeat((n,) + (1,) * v.dim())
                        for k, v in one.items()},
            "tokens": torch.zeros(tuple(token_shape), dtype=torch.int32,
                                  device=device),
            "age": torch.full((n,), _NEVER, dtype=torch.int32,
                              device=device if age_device is None
                              else age_device)}
