"""The composition store, the serving plane's deployable artifact.

Maps tenant -> (base arch, personalized base-block params [, fusion
cache state]) plus ONE shared modular block per arch. On disk it is the
JAX package's artifact format: a ``.npz`` + JSON manifest whose
``extra`` carries the tenant -> arch routing table and per-arch config
provenance, so ``load`` rebuilds the tree from the '/'-joined keys
alone. An artifact saved by the JAX package's ``CompositionStore``
loads here, and one saved here loads there.

``from_spmd_trainer`` exports a trained ``SPMDIFLTrainer`` run (of
either regime) as such an artifact; the ``spmd-smoke`` arch resolves to
``repro_torch.api.spmd.smoke_model_config``.
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
from repro_torch.models import modules as nn

__all__ = ["TenantEntry", "CompositionStore"]

_ARTIFACT_VERSION = 1


def _resolve_cfg(arch: str, *, reduced: bool,
                 d_fusion: Optional[int]) -> ModelConfig:
    """Arch name -> ModelConfig, by the rules the JAX package uses."""
    if arch == "spmd-smoke":
        from repro_torch.api.spmd import smoke_model_config

        cfg = smoke_model_config()
    else:
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
        explicit ``ModelConfig`` (in-memory only: ``save`` refuses, but
        for the ``spmd-smoke`` config, which resolves by name)."""
        if isinstance(arch, ModelConfig):
            cfg, name = arch, arch.name
            custom = name != "spmd-smoke"
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

    # -------------------------------------------------- trainer export

    @classmethod
    def from_spmd_trainer(cls, trainer, *, tenants=None,
                          modular_slot: int = 0) -> "CompositionStore":
        """Export a trained ``SPMDIFLTrainer`` run as a serving artifact,
        on the trainer's device (copies: the trainer trains on).

        One tenant per client slot (ids ``client<k>`` by default); the
        shared modular block is ``modular_slot``'s trained modular half.
        In the legacy regime each slot whose carried cache entry is
        valid rides along as decoded ``{z_hat, y}`` fusion state; a
        population run exports its materialized working set (the slots
        the cohorts trained, paged through its ``PopulationStore``),
        whose cache is rebuilt every round and so is not exported.

        A legacy trainer on a mesh gathers its blocks (every rank calls
        this, a collective); rank 0 builds the store from the gathered
        trees and returns it, every other rank returns None."""
        cfg = trainer.model_cfg
        params, cache = trainer.params, trainer.cache
        if getattr(trainer, "mesh", None) is not None and \
                not trainer._population:
            import torch.distributed as dist

            from repro_torch.api.spmd import _unstack

            tree, _ = trainer.snapshot()
            if dist.get_rank() != 0:
                return None
            params = _unstack(tree["params"], trainer.n_clients)
            cache = tree.get("cache")
        # The spec's resolvable arch id ('' is the smoke config): the
        # trainer's cfg.name carries reduced()'s suffix.
        arch_name = trainer.spec.model or cfg.name
        store = cls()
        store.add_arch(arch_name, reduced=bool(trainer.spec.model),
                       d_fusion=cfg.d_fusion)
        dev = trainer.device
        if trainer._population:
            slots = trainer.store.slots()
            if not slots:
                raise ValueError("population run has no materialized slots "
                                 "to export; train a round first")

            def get_params(k):
                return trainer.store.get(k)["params"]
        else:
            slots = list(range(trainer.n_clients))

            def get_params(k):
                return params[k]
        if tenants is None:
            tenants = [f"client{k}" for k in slots]
        if len(tenants) != len(slots):
            raise ValueError(f"{len(tenants)} tenant ids for {len(slots)} "
                             "exported slots")

        def copy(tree):
            return nn.tree_map(lambda a: a.to(dev, copy=True), tree)

        mslot = modular_slot if modular_slot in slots else slots[0]
        store.set_modular(arch_name, copy(get_params(mslot)["modular"]))
        fusion = {}
        if not trainer._population and cache is not None:
            z_shape = (trainer.spec.batch_size, trainer.seq, cfg.d_fusion)
            ctree = trainer.exchange.cache_tree(cache, z_shape)
            ages = ctree["age"].tolist()
            fusion = {k: {"z_hat": ctree["z_hat"][k].clone(),
                          "y": ctree["y"][k].clone()}
                      for k in slots if ages[k] <= trainer.exchange.age_bound}
        for tid, k in zip(tenants, slots):
            store.add_tenant(tid, arch_name, copy(get_params(k)["base"]),
                             fusion=fusion.get(k))
        return store
