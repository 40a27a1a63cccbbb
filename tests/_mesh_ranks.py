"""The rank side of tests/test_torch_mesh_round.py: what each of the 4
gloo ranks (CPU tensors, one torch thread) runs, and how the ranks are
spawned. Every rank writes what it saw to ``<out>/rank<r>.pt``; the test
process compares that with its own one-process runs.

Scenarios (smoke LM, N 4, tau 2, S 32; the same token draws everywhere):
  a      (4, 1, 1), int8_row, full participation, 2 rounds, from the
         reference's init carried in ``<out>/jax_init.npz``;
  b      (2, 2, 1), ef(int4), k2 masks, max_staleness 1, 3 rounds, from
         ``init_ifl_state(..., mesh=)``;
  c      SPMDIFLTrainer on (4, 1, 1) (ef(int4), k2, delta): 2 rounds,
         ``save_trainer``, a third round, ``from_spmd_trainer``; and a
         trainer resumed from the one-process checkpoint
         ``<out>/one_process`` for its third round;
  d      SPMDIFLTrainer on (2, 2, 1), int8_row, full participation, 1
         round, and ``train_ifl_lm`` on the same mesh, 1 round;
  pop    SPMDIFLTrainer, a cohort of 2 from 8, ef(int4), on (1, 4, 1)
         (B 4), 2 rounds.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

N, TAU, B, S, LR = 4, 2, 2, 32, 1e-2
MASKS = [[True, False, True, False], [False, True, True, False],
         [False, False, True, True]]
IFL_AXES = ("client", "data", "model")


def smoke_batches(vocab: int, rounds: int, b: int = B) -> List[np.ndarray]:
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=(N, TAU + 1, b, S)).astype(np.int32)
            for _ in range(rounds)]


def trainer_spec(**kw):
    from repro_torch import api

    fleet = kw.pop("fleet", {})
    base = dict(scheme="ifl_spmd", model="", rounds=3, tau=TAU, lr=LR,
                batch_size=B, d_fusion=32, codec="ef(int4)",
                participation="k2", max_staleness=1, broadcast="delta",
                eval_every=0, seed=0)
    base.update(kw)
    return api.ExperimentSpec(**base, fleet=api.FleetSpec(**fleet),
                              data=api.DataSpec(dataset="synth_tokens",
                                                n_test=8))


def run_step(cfg, params, opt_state, codec, batches, masks, *, mesh=None,
             max_staleness=None, track=False):
    """Rounds of ``make_ifl_round_step`` (debug z_hat on) -> per-round
    records; params and opt_state updated in place. With ``track`` each
    record says whether the absent clients this process holds kept their
    params, EF rows and cache slots bitwise."""
    from repro_torch.core import ifl_spmd as spmd
    from repro_torch.core.comm import tree_leaves
    from repro_torch.core.exchange import SPMDFusionExchange

    plane = SPMDFusionExchange(codec, n_clients=N,
                               max_staleness=max_staleness, mesh=mesh)
    lay = plane.layout
    mine = list(range(N)) if lay is None else lay.clients
    rows = B if lay is None else B // lay.n_data
    partial = masks is not None
    step = spmd.make_ifl_round_step(
        cfg, mesh=mesh, n_clients=N, tau=TAU, lr_base=LR, lr_modular=LR,
        partial_participation=partial, debug_return_zhat=True,
        exchange=plane)
    z_shape = (len(mine), rows, S, cfg.d_fusion)
    ef = spmd.init_ef_state(codec, z_shape)
    cache = (spmd.init_payload_cache(codec, z_shape, z_shape[:3])
             if partial else None)
    out = []
    for r, toks in enumerate(batches):
        args = [params, opt_state, {"tokens": torch.from_numpy(toks)}]
        absent = ([i for i, k in enumerate(mine) if not masks[r][k]]
                  if partial else [])
        kept = {i: ([a.clone() for a in tree_leaves(params[i])],
                    ef[i].clone() if plane.codec.has_state else None,
                    {k: v[i].clone() for k, v in cache["payload"].items()})
                for i in absent} if track else {}
        if partial:
            args += [torch.tensor(masks[r]), cache]
        if plane.codec.has_state:
            args.append(ef)
        res = step(*args)
        m = res[2]
        if partial:
            cache = res[3]
        if plane.codec.has_state:
            ef = res[-1]
        frozen = all(
            all(torch.equal(a, c) for a, c in zip(ps, tree_leaves(params[i])))
            and (e is None or torch.equal(e, ef[i]))
            and all(torch.equal(v, cache["payload"][k][i])
                    for k, v in slot.items())
            for i, (ps, e, slot) in kept.items())
        out.append({
            "base_loss": float(m["base_loss"]), "mod_loss": float(m["mod_loss"]),
            "z_hat": m["z_hat"].clone(), "frozen": frozen, "absent": absent,
            "ef": None if not plane.codec.has_state else ef.clone(),
            "cache": None if cache is None else {
                "payload": {k: v.clone() for k, v in cache["payload"].items()},
                "tokens": cache["tokens"].clone(),
                "age": cache["age"].clone()},
            "params": [[a.clone() for a in tree_leaves(p)] for p in params],
        })
    return out, plane


def _mesh(shape):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, IFL_AXES, device_type="cpu")


def _scenario_a(out_dir, cfg):
    from repro_torch.checkpoint import unstack_clients

    init = dict(np.load(os.path.join(out_dir, "jax_init.npz")))
    tree = {"base": {}, "modular": {}}
    for key, v in init.items():
        d = tree
        parts = key.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    mesh = _mesh((4, 1, 1))
    from repro_torch.launch.mesh import ClientLayout

    mine = ClientLayout.of(mesh, N).clients
    params = [p for k, p in enumerate(unstack_clients(tree, device="cpu"))
              if k in mine]
    opt = [{"base": {}, "modular": {}} for _ in mine]
    recs, plane = run_step(cfg, params, opt, "int8_row",
                           smoke_batches(cfg.vocab_size, 2), None, mesh=mesh)
    return {"records": recs, "gathered": plane.gathered, "clients": mine,
            "ledger": plane.ledger.per_round}


def _scenario_b(cfg):
    from repro_torch.core import ifl_spmd as spmd
    from repro_torch.core.comm import tree_leaves
    from repro_torch.launch.mesh import ClientLayout

    mesh = _mesh((2, 2, 1))
    lay = ClientLayout.of(mesh, N)
    params, opt = spmd.init_ifl_state(
        cfg, n_clients=N, generator=torch.Generator().manual_seed(3),
        device="cpu", mesh=mesh)
    whole, _ = spmd.init_ifl_state(
        cfg, n_clients=N, generator=torch.Generator().manual_seed(3),
        device="cpu")
    init_same = all(torch.equal(a, c) for i, k in enumerate(lay.clients)
                    for a, c in zip(tree_leaves(params[i]),
                                    tree_leaves(whole[k])))
    recs, plane = run_step(cfg, params, opt, "ef(int4)",
                           smoke_batches(cfg.vocab_size, 3), MASKS,
                           mesh=mesh, max_staleness=1, track=True)
    return {"records": recs, "gathered": plane.gathered,
            "clients": lay.clients, "rows": lay.rows(B),
            "init_same": init_same}


def _scenario_c(out_dir, rank):
    from repro_torch.api.spmd import SPMDIFLTrainer
    from repro_torch.api.trainer import load_trainer, save_trainer
    from repro_torch.serve.store import CompositionStore

    mesh = _mesh((4, 1, 1))
    spec = trainer_spec()
    t = SPMDIFLTrainer(spec, mesh=mesh)
    reports = [t.run_round().to_dict() for _ in range(2)]
    save_trainer(os.path.join(out_dir, "mesh_ckpt"), t)
    reports.append(t.run_round().to_dict())
    accs = t.evaluate()
    store = CompositionStore.from_spmd_trainer(t)
    if rank == 0:
        store.save(os.path.join(out_dir, "mesh_store.npz"))
    resumed = load_trainer(os.path.join(out_dir, "one_process"),
                           SPMDIFLTrainer(spec, mesh=mesh))
    tail = resumed.run_round().to_dict()
    save_trainer(os.path.join(out_dir, "mesh_resumed"), resumed)
    return {"reports": reports, "accs": accs, "tail": tail,
            "store_is_none": store is None}


def _scenario_d(cfg):
    from repro_torch.api.spmd import SPMDIFLTrainer
    from repro_torch.train.loop import train_ifl_lm

    mesh = _mesh((2, 2, 1))
    t = SPMDIFLTrainer(trainer_spec(codec="int8_row", participation="full",
                                    broadcast="full"), mesh=mesh)
    report = t.run_round().to_dict()
    hist = train_ifl_lm(cfg, rounds=1, n_clients=N, tau=TAU, batch=B,
                        seq=S, log_every=99, mesh=mesh)["history"]
    return {"report": report, "gathered": t._wire.gathered,
            "ledger": t.ledger.per_round, "history": hist}


def _scenario_pop():
    from repro_torch.api.spmd import SPMDIFLTrainer

    mesh = _mesh((1, 4, 1))
    t = SPMDIFLTrainer(trainer_spec(
        batch_size=4, participation="full",
        fleet=dict(n_population=8, cohort=2)), mesh=mesh)
    return {"reports": [t.run_round().to_dict() for _ in range(2)]}


def rank_main(rank: int, world: int, store_path: str, out_dir: str,
              scenarios: List[str]) -> None:
    import torch.distributed as dist

    from repro_torch.api.spmd import smoke_model_config

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        cfg = smoke_model_config()
        res: Dict[str, object] = {}
        for name in scenarios:
            t0 = time.perf_counter()
            if name == "a":
                res[name] = _scenario_a(out_dir, cfg)
            elif name == "b":
                res[name] = _scenario_b(cfg)
            elif name == "c":
                res[name] = _scenario_c(out_dir, rank)
            elif name == "d":
                res[name] = _scenario_d(cfg)
            elif name == "pop":
                res[name] = _scenario_pop()
            res[name + "_seconds"] = time.perf_counter() - t0
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(out_dir: str, scenarios: List[str], *, world: int = 4,
          timeout: float = 300.0) -> List[dict]:
    """Run ``rank_main`` on ``world`` spawned gloo ranks (rendezvous
    through a FileStore under ``out_dir``) -> each rank's results. Kills
    the ranks and raises past ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        rank_main, args=(world, os.path.join(out_dir, "rendezvous"), out_dir,
                         scenarios),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh ranks still running after "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]
