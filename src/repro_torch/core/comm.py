"""Communication accounting for IFL (and the FL/FSL formulas).

Analytic per-round byte formulas (paper §IV measures cumulative MB on
the x-axis of Fig. 2) plus a ledger that the trainer feeds with the
*actual* tensor sizes it transmits. Only bytes that cross the client
boundary count. The port's copy of ``repro.core.comm``: the same
formulas and the same ledger, over trees of tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts, lists and tuples, in key / item order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def nbytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


@dataclass
class CommLedger:
    """Cumulative uplink/downlink bytes, total and per round."""

    uplink: int = 0
    downlink: int = 0
    per_round: List[Dict[str, int]] = field(default_factory=list)
    _round_up: int = 0
    _round_down: int = 0

    def send_up(self, tree):
        self.send_up_bytes(nbytes(tree))

    def send_down(self, tree):
        self.send_down_bytes(nbytes(tree))

    def send_up_bytes(self, b: int):
        self.uplink += b
        self._round_up += b

    def send_down_bytes(self, b: int):
        self.downlink += b
        self._round_down += b

    def end_round(self):
        self.per_round.append({"up": self._round_up,
                               "down": self._round_down})
        self._round_up = 0
        self._round_down = 0

    @property
    def total(self) -> int:
        return self.uplink + self.downlink

    @property
    def uplink_mb(self) -> float:
        return self.uplink / 1e6

    @property
    def downlink_mb(self) -> float:
        return self.downlink / 1e6

    @property
    def total_mb(self) -> float:
        return self.total / 1e6

    def round_mb(self, i: int) -> float:
        """Total (up + down) MB of closed round ``i``."""
        r = self.per_round[i]
        return (r["up"] + r["down"]) / 1e6


# ------------------------------------------------------------ analytic


# Per shipped delta-broadcast entry: one int32 slot index plus one int32
# upload round (the staleness anchor a client mirror needs to apply the
# server's eviction rule locally). See repro_torch.core.exchange.
DELTA_SIDECAR_BYTES = 8


def ifl_round_bytes(n_clients: int, batch: int, d_fusion: int,
                    label_bytes: int = 4, act_bytes: int = 4,
                    codec=None, participating: Optional[int] = None,
                    broadcast_entries: Optional[int] = None,
                    broadcast: str = "full",
                    delta_entries: Optional[int] = None) -> Dict[str, int]:
    """One IFL round: each of the K participants uploads (z_k, y_k); the
    server serves the M valid fusion-cache entries to the participants
    (Algorithm 1 lines 13-21 at full participation: K = M = N).

    ``codec`` switches z to its wire format through the codec's own
    analytic ``encoded_nbytes``, so ledger parity holds per codec; labels
    ride uncompressed (int32). ``broadcast`` is the downlink policy
    (``repro_torch.core.exchange``):

      ``"full"``   the M-entry cache to each of the K participants:
                   ``down = K * M * (z + y)``.
      ``"delta"``  clients mirror the server cache, so each entry ships
                   at most once a round, with a ``DELTA_SIDECAR_BYTES``
                   sidecar: ``down = E * (z + y + sidecar)``. E is
                   ``delta_entries`` (a round's ``shipped_entries``
                   metric); it defaults to K, exact only at full
                   participation."""
    if codec is not None:
        from repro_torch.core.codec import get_codec

        z = get_codec(codec).encoded_nbytes((batch, d_fusion))
    else:
        z = batch * d_fusion * act_bytes
    y = batch * label_bytes
    k = n_clients if participating is None else participating
    m = n_clients if broadcast_entries is None else broadcast_entries
    if broadcast == "full":
        down = k * m * (z + y)
    elif broadcast == "delta":
        e = k if delta_entries is None else delta_entries
        down = e * (z + y + DELTA_SIDECAR_BYTES)
    else:
        raise ValueError(f"unknown broadcast policy {broadcast!r}; expected "
                         "'full' or 'delta'")
    return {"up": k * (z + y), "down": down}


def fl_round_bytes(n_clients: int, model_bytes: int,
                   participating: Optional[int] = None) -> Dict[str, int]:
    """FedAvg: full model up and global model down per participant."""
    k = n_clients if participating is None else participating
    return {"up": k * model_bytes, "down": k * model_bytes}


def fsl_round_bytes(n_clients: int, batch: int, cut_dim: int,
                    label_bytes: int = 4, act_bytes: int = 4,
                    participating: Optional[int] = None) -> Dict[str, int]:
    """FSL: cut activations + labels up; activation gradients down."""
    k = n_clients if participating is None else participating
    h = batch * cut_dim * act_bytes
    y = batch * label_bytes
    return {"up": k * (h + y), "down": k * h}
