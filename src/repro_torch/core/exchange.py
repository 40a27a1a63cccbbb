"""The exchange plane — the eager IFL uplink/downlink wire pipeline.

The port's copy of the eager half of ``repro.core.exchange``:

  ``ExchangePlane``   the base plane: the :class:`CommLedger` every
                      boundary byte routes through.
  ``FusionCache``     the server's staleness-bounded cache of decoded
                      fusion payloads, one entry per client slot.
  ``FusionExchange``  codec + per-client EF21 residuals + the cache +
                      the full-broadcast policy.

``FusionExchange.upload`` encodes with the EF residual threaded through,
ledgers exactly the encoded payload and the labels, and decodes once into
the cache; ``broadcast_round`` serves the valid cache, in slot order, to
every participant (``broadcast='full'``: K * M entries down). The encode
is the kernel dispatch point: a codec with a wire scheme (int8_row, int4,
topk, sketch and their ``ef(...)``) goes through
``repro_torch.kernels.ops.wire_encode`` / ``wire_encode_ef`` — on the
card, the hand-written kernels; every other codec encodes with its plain
ops on every device, the reference's rule.

``SPMDFusionExchange`` is the one-card counterpart of the reference's
SPMD backend: the wire block of the LM round step
(``repro_torch.core.ifl_spmd``) over a stacked client dim, at full
participation. On one card the 'client'-axis all-gather is the stacking
of the N payloads, and the receivers decode them.

Not ported yet (ROADMAP.md queue 1): the delta broadcast and its client
mirrors, the population regime, snapshot/restore of the cache, and the
SPMD backend's partial participation (payload cache, ``max_staleness``)
and host-side ``account_round``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.codec import Codec, get_codec
from repro_torch.core.comm import CommLedger

__all__ = [
    "ExchangePlane",
    "CacheEntry",
    "FusionCache",
    "FusionExchange",
    "SPMDFusionExchange",
    "init_ef_state",
]


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


class FusionExchange(ExchangePlane):
    """Eager IFL wire pipeline: codec + EF residuals + cache + broadcast.

    ``z_shape`` is one client's fusion-output shape ``(batch_size,
    d_fusion)``; ``device`` is where the EF residuals live (the fusion
    outputs' device)."""

    def __init__(self, codec: Union[str, Codec, None], n_clients: int,
                 z_shape: Tuple[int, ...], *,
                 max_staleness: Optional[int] = None,
                 broadcast: str = "full",
                 device=None):
        if broadcast != "full":
            raise NotImplementedError(
                f"broadcast={broadcast!r}: only 'full' is ported; delta "
                "broadcast is ROADMAP.md queue 1, item 2f")
        super().__init__()
        self.codec = get_codec(codec)
        self.n_clients = n_clients
        self.z_shape = tuple(z_shape)
        self.broadcast = broadcast
        self.cache = FusionCache(max_staleness)
        # Per-client EF residual (an empty tuple for stateless codecs),
        # keyed by client slot; client-private, never ledgered.
        self.ef_state: Dict[int, Any] = {
            k: self.codec.init_state(self.z_shape, device=device)
            for k in range(n_clients)
        }

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

    def broadcast_round(self, participants: Sequence[int], round_idx: int):
        """Serve the valid cache to the participants -> (Z, Y, entries):
        the decoded pairs the modular updates consume, in slot order, and
        the (slot, entry) list behind them."""
        entries = self.cache.valid_entries(round_idx)
        Z = [e.z_hat for _, e in entries]
        Y = [e.y for _, e in entries]
        payloads = [e.payload for _, e in entries]
        for _ in participants:
            self.down((payloads, Y))
        return Z, Y, entries


_SPMD_TODO = ("ROADMAP.md queue 1, items 3b (partial participation, "
              "staleness) and 4b (the SPMD trainer)")


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
