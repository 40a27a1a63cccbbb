"""The port's dry-run against the JAX package's on the CPU: the shape trees
of every config of the registry at full width, the analytic numbers
(block and active params, model FLOPs, the client-boundary section)
number for number, and ``run_one`` end to end on the meta device."""

import json
import os

import jax
import numpy as np
import pytest

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.config import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jshapes
from repro.core.rounds import parse_participation as j_parse_participation
from repro.roofline.analysis import model_flops as j_model_flops
from repro_torch.config import INPUT_SHAPES
from repro_torch.configs import (
    ARCH_IDS,
    LONG_CONTEXT_OK,
    get_config,
    supports_shape,
)
from repro_torch.configs import shapes
from repro_torch.core.rounds import parse_participation
from repro_torch.launch import dryrun
from repro_torch.roofline.analysis import model_flops


def _jax_dryrun():
    """The reference's dry-run module. It sets a 512-device XLA flag at
    import for its own process; this process keeps the real single CPU
    device: the backend starts first, and the flag is put back."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return mod


def _jax_leaves(tree, drop_lead=False):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        shape = tuple(leaf.shape[1:] if drop_lead else leaf.shape)
        out[key] = (shape, np.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_port_leaves(v, key))
        else:
            assert v.device.type == "meta", key
            out[key] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


def _per_row_slot_pos(leaves, batch):
    """The reference's cache leaves in the port's one documented layout
    difference (``models/attention.py``, ``checkpoint.cache_from_numpy``):
    a GQA cache's ``slot_pos`` is (..., L) int32 there, shared by the
    batch, and (..., B, L) int64 in the port, one position a row."""
    out = dict(leaves)
    for key, (shape, _) in leaves.items():
        if key.endswith("/slot_pos"):
            out[key] = ((*shape[:-1], batch, shape[-1]), "int64")
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_decode_specs_are_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert _port_leaves(shapes.param_specs(cfg)) == _jax_leaves(
        jshapes.param_specs(jcfg))
    for name in ("decode_32k", "long_500k"):
        if name == "long_500k" and arch not in LONG_CONTEXT_OK:
            assert not supports_shape(arch, name)
            continue
        got = shapes.decode_specs(cfg, INPUT_SHAPES[name])
        want = jshapes.decode_specs(jcfg, J_SHAPES[name])
        assert _port_leaves(got["cache"]) == _per_row_slot_pos(
            _jax_leaves(want["cache"]), INPUT_SHAPES[name].global_batch)
        assert (tuple(got["token"].shape), tuple(got["pos"].shape)) == (
            want["token"].shape, want["pos"].shape)
        assert (got["cross_kvs"] is None) == (want["cross_kvs"] is None)
        if got["cross_kvs"] is not None:
            assert _port_leaves(got["cross_kvs"]) == _jax_leaves(
                want["cross_kvs"])
    for name in ("train_4k", "prefill_32k"):
        sh, jsh = INPUT_SHAPES[name], J_SHAPES[name]
        fn, jfn = ((shapes.train_batch_specs, jshapes.train_batch_specs)
                   if sh.kind == "train" else
                   (shapes.prefill_batch_specs, jshapes.prefill_batch_specs))
        assert _port_leaves(fn(cfg, sh)) == _jax_leaves(jfn(jcfg, jsh))
    assert _port_leaves(shapes.train_batch_specs(
        cfg, INPUT_SHAPES["train_4k"], n_clients=4, tau=2)) == _jax_leaves(
        jshapes.train_batch_specs(jcfg, J_SHAPES["train_4k"], n_clients=4,
                                  tau=2))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v3-671b"])
def test_stacked_param_specs_are_the_references_per_client(arch):
    got = shapes.param_specs(get_config(arch), n_clients=4)
    want = _jax_leaves(jshapes.param_specs(jax_get_config(arch),
                                           n_clients=4), drop_lead=True)
    assert isinstance(got, list) and len(got) == 4
    assert all(_port_leaves(p) == want for p in got)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_and_model_flops_are_the_references(arch):
    jd = _jax_dryrun()
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    pb, pm = dryrun._block_params(cfg)
    assert (pb, pm) == jd._block_params(jcfg)
    active = dryrun._active_params(cfg, pb, pm)
    assert active == jd._active_params(jcfg, pb, pm)
    for kind in ("dp_train", "ifl_round", "prefill", "decode"):
        kw = dict(params_base=active[0], params_mod=active[1],
                  tokens=256 * 4096, tau=2, n_clients=4)
        assert model_flops(kind, **kw) == j_model_flops(kind, **kw)


BOUNDARY = ([(c, p, b, "sync", "", 0, 0)
             for c in ("fp32", "int8_row", "ef(int4)", "topk")
             for p in ("full", "k2") for b in ("full", "delta")]
            + [("ef(int4)", "full", "delta", "async", "pareto(1.2,0.5)", 0,
                0),
               ("ef(int4)", "zipf(1.1)", "delta", "sync", "", 10000, 256)])


@pytest.mark.parametrize("case", BOUNDARY, ids=lambda c: "-".join(
    str(x) for x in c if x not in ("", 0)))
def test_client_boundary_section_is_the_references(case):
    codec, part, bcast, mode, trace, n_pop, cohort = case
    jd = _jax_dryrun()
    kw = dict(n_clients=4, codec=codec, broadcast=bcast, mode=mode,
              trace=trace, tick=1.0, n_population=n_pop, cohort=cohort)
    got = dryrun.client_boundary_section(
        get_config("qwen1.5-0.5b"), INPUT_SHAPES["train_4k"],
        schedule=parse_participation(part), **kw)
    want = jd.client_boundary_section(
        jax_get_config("qwen1.5-0.5b"), J_SHAPES["train_4k"],
        schedule=j_parse_participation(part), fused=True, **kw)
    gw, ww = got.pop("wire_path"), want.pop("wire_path")
    assert got == want
    # The wire path names each package's own kernel: compare whether the
    # codec has one, and the bytes the encode moves.
    assert gw["fused"] == ww["fused"]
    if gw["fused"]:
        assert sorted(gw["payload_leaves"]) == sorted(ww["payload_leaves"])
        assert gw["hbm_bytes_fused"] == ww["hbm_bytes_fused"]


def test_accounting_only_prices_a_fleet_of_10000_as_the_reference(tmp_path):
    jd = _jax_dryrun()
    kw = dict(n_clients=4, tau=2, variant="", force=True, codec="ef(int4)",
              participation="zipf(1.1)", broadcast="delta",
              n_population=10000, cohort=256, accounting_only=True)
    got = dryrun.run_one("qwen1.5-0.5b", "train_4k", step_kind="ifl",
                         out_dir=str(tmp_path / "port"), **kw)
    want = jd.run_one("qwen1.5-0.5b", "train_4k", multi_pod=False,
                      step_kind="ifl", out_dir=str(tmp_path / "jax"), **kw)
    assert (got["client_boundary"]["per_round_bytes"]
            == want["client_boundary"]["per_round_bytes"])
    assert got["client_boundary"]["cohort"] == 256


def test_run_one_writes_each_step_kind_on_meta(tmp_path):
    """Each step kind of a reduced config through the dry-run: one JSON
    with the reference's keys, one card, the roofline against h100-sxm,
    and the kernels the step reaches on the card."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    out = str(tmp_path)
    rows = {
        "ifl": dryrun.run_one("qwen1.5-0.5b", "train_4k", step_kind="ifl",
                              n_clients=4, tau=1, variant="r", out_dir=out,
                              cfg_override=cfg, codec="ef(int4)",
                              participation="k2"),
        "dp": dryrun.run_one("qwen1.5-0.5b", "train_4k", step_kind="dp",
                             n_clients=4, tau=1, variant="r", out_dir=out,
                             cfg_override=cfg),
        "prefill": dryrun.run_one("qwen1.5-0.5b", "prefill_32k",
                                  step_kind="ifl", n_clients=4, tau=1,
                                  variant="r", out_dir=out,
                                  cfg_override=cfg),
        "decode": dryrun.run_one("qwen1.5-0.5b", "decode_32k",
                                 step_kind="ifl", n_clients=4, tau=1,
                                 variant="r", out_dir=out, cfg_override=cfg),
    }
    assert len(os.listdir(out)) == 4
    for name, r in rows.items():
        with open(os.path.join(out, f"{r['arch']}__{r['shape']}__h100__"
                               f"{'dp' if name == 'dp' else 'ifl'}"
                               + ("__cef-int4-__pk2" if name == "ifl"
                                  else "") + "__r.json")) as f:
            assert json.load(f) == json.loads(json.dumps(r))
        assert r["n_chips"] == 1 and r["roofline"]["hardware"] == "h100-sxm"
        assert r["roofline"]["collective_s"] == 0.0
        assert r["memory"]["peak_bytes"] > r["memory"]["argument_bytes"] > 0
        assert r["cost"]["flops"] > 0 and r["cost"]["bytes accessed"] > 0
    layers = cfg.num_layers
    ifl = rows["ifl"]
    assert ifl["mask"] == [True, True, False, False]
    assert ifl["kernels"]["wire_encode_ef"]["launches"] == 1
    assert ifl["client_boundary"]["participation"] == "k2"
    assert rows["dp"]["kernels"]["flash_attention_bwd"]["launches"] == layers
    assert rows["prefill"]["kernels"] == {
        "flash_attention": rows["prefill"]["kernels"]["flash_attention"]}
    assert rows["prefill"]["kernels"]["flash_attention"]["launches"] == layers
    assert rows["decode"]["kernels"]["flash_decode"]["launches"] == layers
