"""The composition store, the serving plane's deployable artifact.

Maps tenant -> (base arch, personalized base-block params [, fusion
cache state]) plus ONE shared modular block per arch. On disk it is the
JAX package's artifact format: a ``.npz`` + JSON manifest whose
``extra`` carries the tenant -> arch routing table and per-arch config
provenance, so ``load`` rebuilds the tree from the '/'-joined keys
alone. An artifact saved by the JAX package's ``CompositionStore``
loads here, and one saved here loads there.

``from_spmd_trainer`` (export of a trained SPMD run) waits for the SPMD
slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.checkpoint import (
    load_extra,
    load_flat,
    params_from_numpy,
    save_checkpoint,
    unflatten,
)
from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["TenantEntry", "CompositionStore"]

_ARTIFACT_VERSION = 1


def _resolve_cfg(arch: str, *, reduced: bool,
                 d_fusion: Optional[int]) -> ModelConfig:
    """Arch name -> ModelConfig, by the rules the JAX package uses."""
    if arch == "spmd-smoke":
        raise NotImplementedError(
            "the 'spmd-smoke' arch belongs to the SPMD trainer, not ported "
            "to repro_torch yet (ROADMAP.md queue 1, item 4b)")
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if d_fusion is not None and cfg.d_fusion != int(d_fusion):
        cfg = cfg.replace(d_fusion=int(d_fusion)).validate()
    return cfg


@dataclass
class TenantEntry:
    """One tenant's routing row: which arch pair, and its base block."""

    tenant: str
    arch: str          # base-block architecture (lane routing key, 1/2)
    modular_arch: str  # shared modular block's arch (routing key, 2/2)
    base: Any          # personalized base-half params
    fusion: Optional[Any] = None  # last fusion-cache state {z_hat, y[, payload]}


class CompositionStore:
    """Tenant -> composed-model registry behind the serving engine.

    Archs are registered once (name + config); tenants attach a
    personalized base block under a registered arch; each arch carries
    ONE shared modular block reused by every tenant routed to it.
    Cross-arch composition is ``modular_arch != arch``, validated to
    agree on d_fusion. Params are dicts of tensors; keep them on the
    device the engine serves from, since a lane copies a tenant's base
    into its slot at every admission.
    """

    def __init__(self):
        self._cfgs: Dict[str, ModelConfig] = {}
        self._meta: Dict[str, Dict[str, Any]] = {}  # arch -> provenance
        self._modular: Dict[str, Any] = {}
        self._tenants: Dict[str, TenantEntry] = {}

    # ----------------------------------------------------------- archs

    def add_arch(self, arch, *, reduced: bool,
                 d_fusion: Optional[int] = None) -> str:
        """Register an architecture by name (resolvable on load) or by
        explicit ``ModelConfig`` (in-memory only: ``save`` refuses)."""
        if isinstance(arch, ModelConfig):
            cfg, name, custom = arch, arch.name, True
        else:
            name, custom = str(arch), False
            cfg = _resolve_cfg(name, reduced=reduced, d_fusion=d_fusion)
        if name in self._cfgs and self._cfgs[name] != cfg:
            raise ValueError(f"arch {name!r} already registered with a "
                             "different config")
        self._cfgs[name] = cfg
        self._meta[name] = {"reduced": bool(reduced),
                            "d_fusion": cfg.d_fusion, "custom": custom}
        return name

    def set_modular(self, arch: str, params: Any) -> None:
        """Attach the shared modular block for ``arch``."""
        if arch not in self._cfgs:
            raise KeyError(f"unregistered arch {arch!r}")
        self._modular[arch] = params

    def cfg(self, arch: str) -> ModelConfig:
        return self._cfgs[arch]

    def modular(self, arch: str) -> Any:
        return self._modular[arch]

    # --------------------------------------------------------- tenants

    def add_tenant(self, tenant: str, arch: str, base: Any, *,
                   modular_arch: Optional[str] = None,
                   fusion: Optional[Any] = None) -> TenantEntry:
        if "/" in tenant:
            raise ValueError(
                f"tenant id {tenant!r} must not contain '/' (it is a "
                "checkpoint key path segment)")
        mod_arch = modular_arch or arch
        for a in (arch, mod_arch):
            if a not in self._cfgs:
                raise KeyError(f"unregistered arch {a!r}")
        if mod_arch not in self._modular:
            raise KeyError(f"arch {mod_arch!r} has no shared modular block")
        bc, mc = self._cfgs[arch], self._cfgs[mod_arch]
        if bc.d_fusion != mc.d_fusion:
            raise ValueError(
                f"tenant {tenant!r}: base {arch!r} d_fusion "
                f"{bc.d_fusion} != modular {mod_arch!r} d_fusion "
                f"{mc.d_fusion}")
        entry = TenantEntry(tenant=tenant, arch=arch, modular_arch=mod_arch,
                            base=base, fusion=fusion)
        self._tenants[tenant] = entry
        return entry

    def tenants(self) -> List[str]:
        return sorted(self._tenants)

    def entry(self, tenant: str) -> TenantEntry:
        if tenant not in self._tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        return self._tenants[tenant]

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    # --------------------------------------------------- save / load

    def save(self, path: str) -> None:
        """Write the artifact (.npz + manifest). Every registered arch
        must be name-resolvable on a fresh box."""
        for name, meta in self._meta.items():
            if meta["custom"]:
                raise ValueError(
                    f"arch {name!r} was registered from an explicit "
                    "ModelConfig and cannot be serialized; register a "
                    "named arch for saveable artifacts")
        tree: Dict[str, Any] = {
            "tenants": {
                t: ({"base": e.base, "fusion": e.fusion}
                    if e.fusion is not None else {"base": e.base})
                for t, e in self._tenants.items()
            },
            "modular": dict(self._modular),
        }
        extra = {
            "serve_artifact": _ARTIFACT_VERSION,
            "archs": {n: {"reduced": m["reduced"], "d_fusion": m["d_fusion"]}
                      for n, m in self._meta.items()},
            "tenants": {t: {"arch": e.arch, "modular_arch": e.modular_arch}
                        for t, e in self._tenants.items()},
        }
        save_checkpoint(path, tree, extra=extra)

    @classmethod
    def load(cls, path: str, *, device: DeviceLike = None
             ) -> "CompositionStore":
        """Read an artifact (written by either package) onto ``device``
        (default: the card)."""
        dev = resolve_device(device)
        extra = load_extra(path)
        if "serve_artifact" not in extra:
            raise ValueError(f"{path} is not a serving artifact (no "
                             "'serve_artifact' manifest key)")
        tree = params_from_numpy(unflatten(load_flat(path)), device=dev)
        store = cls()
        for name, m in extra["archs"].items():
            store.add_arch(name, reduced=bool(m["reduced"]),
                           d_fusion=m["d_fusion"])
        for arch, params in tree.get("modular", {}).items():
            store.set_modular(arch, params)
        for tenant, m in extra["tenants"].items():
            sub = tree["tenants"][tenant]
            store.add_tenant(tenant, m["arch"], sub["base"],
                             modular_arch=m["modular_arch"],
                             fusion=sub.get("fusion"))
        return store
