"""The port's roofline accounting against the JAX package on the CPU:
``kernels/cost.py`` reproduces PERF.md's table of kernels, a meta tensor
never builds or launches a kernel but counts its cost, and the
accounting of an eager step counts the FLOPs XLA counts in the
reference's compiled step (``repro.roofline.hlo_accounting``)."""

import jax
import jax.numpy as jnp
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_config as jax_get_config
from repro.core import ifl_spmd as jspmd
from repro.models import transformer as jtf
from repro.roofline.hlo_accounting import analyze_hlo
from repro_torch.configs import get_config
from repro_torch.core.codec import get_codec
from repro_torch.core.ifl_spmd import make_dp_train_step, make_prefill_step
from repro_torch.kernels import build, cost, ops, ref
from repro_torch.models import transformer as tf
from repro_torch.optim import make_optimizer
from repro_torch.roofline.accounting import Accounting
from repro_torch.roofline.analysis import HW, model_flops, roofline_terms

F32, BF16 = torch.float32, torch.bfloat16
META = torch.device("meta")


def _scheme(name, d=432):
    codec = get_codec(name)
    return ops.scheme_for(codec.inner if codec.has_state else codec, d)


# PERF.md's table of kernels: each row's bound_ms (and its extra entries)
# at the row's stated shape, as the table gives it.
PERF_BOUNDS = {
    "1 wire_encode int8_row (32, 432)": (
        lambda: cost.wire_encode(_scheme("int8_row"), 32), 0.0000207),
    "2 wire_encode_ef ef(int4) (32, 432)": (
        lambda: cost.wire_encode(_scheme("int4"), 32, ef=True), 0.0000516),
    "2 wire_encode_ef ef(int4) (4096, 1024)": (
        lambda: cost.wire_encode(_scheme("int4", 1024), 4096, ef=True),
        0.01566),
    "3 decode_proj int8_row (32, 432) -> 256": (
        lambda: cost.decode_proj(32, 256, _scheme("int8_row"), F32),
        0.000146),
    "4 fusion_proj (32, 784, 1024) fp32": (
        lambda: cost.fusion_proj(32, 784, 1024, F32), 0.00103),
    "5 fusion_proj_quant (32, 1568, 432) int8_row": (
        lambda: cost.fusion_proj_encode(32, 1568, _scheme("int8_row"),
                                        False, F32), 0.000873),
    "6 fusion_proj_encode (32, 1568, 432) int8_row": (
        lambda: cost.fusion_proj_encode(32, 1568, _scheme("int8_row"),
                                        False, F32), 0.000873),
    "7 rmsnorm (8192, 4096) fp32": (
        lambda: cost.rmsnorm(8192, 4096, F32, F32), 0.0801),
    "8 flash_attention B 2 S 512 H 16 hd 64": (
        lambda: cost.flash_attention(2, 512, 16, 16, 64, 64, -1, True, BF16),
        0.00252),
    "8 hd 24": (lambda: cost.flash_attention(2, 512, 16, 16, 24, 24, -1,
                                             True, BF16), 0.000959),
    "8 hd 48": (lambda: cost.flash_attention(2, 512, 16, 16, 48, 48, -1,
                                             True, BF16), 0.00190),
    "8 MLA": (lambda: cost.flash_attention(1, 512, 128, 128, 192, 128, -1,
                                           True, BF16), 0.02512),
    "8 causal=False": (lambda: cost.flash_attention(
        2, 1024, 16, 16, 64, 64, -1, False, BF16), 0.00869),
    "8b flash_attention_bwd B 2 S 512 H 16 hd 64": (
        lambda: cost.flash_attention_bwd(2, 512, 16, 16, 64, 64, -1, True,
                                         BF16), 0.00503),
    "8b hd 24": (lambda: cost.flash_attention_bwd(2, 512, 16, 16, 24, 24, -1,
                                                  True, BF16), 0.00190),
    "8b hd 48": (lambda: cost.flash_attention_bwd(2, 512, 16, 16, 48, 48, -1,
                                                  True, BF16), 0.00378),
    "8b MLA": (lambda: cost.flash_attention_bwd(1, 512, 128, 128, 192, 128,
                                                -1, True, BF16), 0.05016),
    "8b causal=False": (lambda: cost.flash_attention_bwd(
        2, 1024, 16, 16, 64, 64, -1, False, BF16), 0.02171),
    "9 flash_decode (4, 64, 16, 1, 64), 154 rows live": (
        lambda: cost.flash_decode(4, 64, 16, 1, 64, BF16, live=154),
        0.000193),
    "9 hd 128": (lambda: cost.flash_decode(4, 64, 16, 1, 128, BF16,
                                           live=154), 0.000386),
    "9 hd 24": (lambda: cost.flash_decode(4, 64, 16, 1, 24, BF16, live=154),
                0.0000725),
    "9 hd 48": (lambda: cost.flash_decode(4, 64, 16, 1, 48, BF16, live=154),
                0.000145),
}
BY_OPERATIONS = {"8 causal=False", "8b causal=False"}


@pytest.mark.parametrize("row", sorted(PERF_BOUNDS))
def test_cost_reproduces_the_perf_table_bounds(row):
    fn, want = PERF_BOUNDS[row]
    c = fn()
    assert f"{c['bound_ms']:.3g}" == f"{want:.3g}", (row, c)
    assert c["bound_by"] == ("operations" if row in BY_OPERATIONS
                             else "bytes"), (row, c)


@pytest.mark.parametrize("S,window,causal", [
    (1, -1, True), (513, -1, True), (512, 48, True), (100, 1, True),
    (1000, 65, False), (64, -1, False)])
def test_attn_pairs_counts_the_kept_pairs(S, window, causal):
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    keep = (j <= i) if causal else torch.ones(S, S, dtype=torch.bool)
    if window > 0:
        keep &= j > i - window
    assert cost.attn_pairs(S, window, causal) == int(keep.sum())


# ------------------------------------------------------- the meta branch


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device=META)


def _like(tree, device):
    """Empty tensors of ``tree``'s shapes and dtypes on ``device``."""
    if isinstance(tree, dict):
        return {k: _like(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_like(v, device) for v in tree)
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def _sig(tree):
    if isinstance(tree, dict):
        return {k: _sig(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_sig(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def _meta_calls():
    """(kernel, call on meta inputs, the same call on CPU inputs, the
    cost.py count the meta call must record)."""
    i8, ef4 = get_codec("int8_row"), get_codec("ef(int4)")
    pay = {"q": _meta(32, 432, dtype=torch.int8), "scale": _meta(32, 1)}
    dec = (_meta(4, 1, 16, 2, 64, dtype=BF16), _meta(4, 64, 16, 64,
                                                      dtype=BF16),
           _meta(4, 64, 16, 64, dtype=BF16), _meta(4, 64, dtype=torch.bool))
    proj = (_meta(32, 784), _meta(784, 1024), _meta(1024))
    enc = (_meta(32, 1568), _meta(1568, 432), _meta(432))
    e = _meta(32, 432)
    return [
        ("flash_decode", lambda d: ops.cached_attn_decode(*d), dec,
         cost.flash_decode(4, 64, 16, 2, 64, BF16)),
        ("wire_encode", lambda z: ops.wire_encode(z, i8), e,
         cost.wire_encode(_scheme("int8_row"), 32)),
        ("wire_encode_ef", lambda a: ops.wire_encode_ef(*a, ef4), (e, e),
         cost.wire_encode(_scheme("int4"), 32, ef=True)),
        ("fusion_proj", lambda a: ops.fusion_proj(*a, "relu"), proj,
         cost.fusion_proj(32, 784, 1024, F32)),
        ("fusion_proj_quant", lambda a: ops.fusion_proj_quant(*a, "relu"),
         enc, cost.fusion_proj_encode(32, 1568, _scheme("int8_row"), False,
                                      F32)),
        ("fusion_proj_encode", lambda a: ops.fusion_proj_encode(
            *a[:3], "relu", codec=ef4, ef_state=a[3]), (*enc, e),
         cost.fusion_proj_encode(32, 1568, _scheme("int4"), True, F32)),
        ("decode_proj", lambda a: ops.decode_proj(
            a[0], a[1], a[2], "relu", codec=i8, shape=(32, 432)),
         (pay, _meta(432, 256), _meta(256)),
         cost.decode_proj(32, 256, _scheme("int8_row"), F32)),
        ("rmsnorm", lambda a: ops.rmsnorm(*a), (_meta(64, 4096, dtype=BF16),
                                                _meta(4096)),
         cost.rmsnorm(64, 4096, BF16, F32)),
    ]


@pytest.fixture
def no_build(monkeypatch):
    """A build or a launch raises."""
    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached a kernel build")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "build_all", refuse)


@pytest.mark.parametrize("case", range(8))
def test_meta_call_never_builds_and_records_its_cost(no_build, case):
    name, call, args, want = _meta_calls()[case]
    fn = getattr(ops, name)
    launches, meta = fn.launches, fn.meta_launches
    with Accounting() as acc:
        out = call(args)
    assert fn.launches == launches and fn.meta_launches == meta + 1
    k = acc.result()["kernels"]
    assert list(k) == [name]
    assert (k[name]["launches"], k[name]["flops"], k[name]["bytes"]) == (
        1, want["flops"], want["bytes"])
    assert k[name]["bound_ms"] == pytest.approx(want["bound_ms"])
    # The kernel's shapes and dtypes: those of the plain version on the
    # CPU, with no bytes counted for the wrapper's own allocations.
    assert _sig(out) == _sig(call(_like(args, "cpu")))
    assert acc.result()["bytes"] == want["bytes"]


def test_meta_attention_forward_and_backward_count_8_and_8b(no_build):
    q = _meta(2, 128, 8, 64, dtype=BF16).requires_grad_()
    k = _meta(2, 128, 4, 64, dtype=BF16).requires_grad_()
    v = _meta(2, 128, 4, 32, dtype=BF16).requires_grad_()
    fwd, bwd = ops.flash_attention, ops.flash_attention_bwd
    before = (fwd.launches, bwd.launches, fwd.meta_launches,
              bwd.meta_launches)
    with Accounting() as acc:
        o = ops.flash_attention(q, k, v, window=48)
        grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    assert o.shape == (2, 128, 8, 32) and o.dtype == BF16
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    ks = acc.result()["kernels"]
    args = (2, 128, 8, 4, 64, 32, 48, True, BF16)
    for name, want in (("flash_attention", cost.flash_attention(*args)),
                       ("flash_attention_bwd",
                        cost.flash_attention_bwd(*args))):
        assert (ks[name]["launches"], ks[name]["flops"],
                ks[name]["bytes"]) == (1, want["flops"], want["bytes"])
    assert (fwd.launches, bwd.launches, fwd.meta_launches,
            bwd.meta_launches) == (*before[:2], before[2] + 1, before[3] + 1)


def test_meta_call_checks_what_the_kernel_takes(no_build):
    with pytest.raises(ValueError):
        ops.fusion_proj(_meta(32, 784), _meta(783, 1024))
    with pytest.raises(ValueError):
        ops.flash_attention_fwd(_meta(2, 64, 8, 200, dtype=BF16),
                                _meta(2, 64, 8, 200, dtype=BF16),
                                _meta(2, 64, 8, 200, dtype=BF16))


def test_cpu_call_runs_the_plain_version_and_records_no_kernel():
    x, w, b = torch.randn(8, 16), torch.randn(16, 12), torch.randn(12)
    with Accounting() as acc:
        y = ops.fusion_proj(x, w, b, "relu")
        p = ops.wire_encode(torch.randn(8, 432), get_codec("int8_row"))
    assert torch.equal(y, ref.fusion_proj_ref(x, w, b, "relu"))
    assert p is not None
    r = acc.result()
    assert r["kernels"] == {} and r["by_family"]["matmul"]["flops"] == (
        2 * 8 * 16 * 12)


# ------------------------------------------------------- the accounting


def test_accounting_counts_products_bytes_and_the_peak():
    a = torch.empty(64, 32, device=META)
    b = torch.empty(32, 16, device=META)
    with Accounting() as acc:
        acc.hold(a, b)
        held = acc.live
        c = a @ b              # mm: 2 M N K, a and b in, c out
        d = torch.relu(c)      # elementwise: c in, d out
        del c
        e = d.t()              # a view: no bytes
        del d, e
    r = acc.result()
    assert held == (64 * 32 + 32 * 16) * 4
    assert r["by_family"]["matmul"] == {
        "flops": 2 * 64 * 16 * 32, "bytes": (64 * 32 + 32 * 16 + 64 * 16) * 4,
        "ops": 1}
    assert r["by_family"]["elementwise"]["bytes"] == 2 * 64 * 16 * 4
    assert r["peak_bytes"] == held + 2 * 64 * 16 * 4
    assert acc.live == held


def test_roofline_terms_on_one_card():
    t = roofline_terms({"flops": 989e12, "bytes accessed": 3.35e12 / 2},
                       "bfloat16", HW, model_flops_total=494.5e12)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == (
        1.0, 0.5, 0.0)
    assert t["dominant"] == "compute" and t["bound_step_s"] == 1.0
    assert t["mfu_bound"] == pytest.approx(0.5) and t["n_chips"] == 1
    assert HW.peak_flops("float32") == 67e12 and HW.link_bw is None
    assert model_flops("dp_train", params_base=1, params_mod=2,
                       tokens=10) == 180


# --------------------------------------------- FLOPs against XLA's count


def _xla_flops(arch, kind, B, S):
    """analyze_hlo's FLOPs of the reference's step, jit-compiled on the
    CPU's one device (shapes only: FLOPs do not depend on values)."""
    jcfg = jax_get_config(arch).reduced()
    params = jax.eval_shape(lambda k: jtf.init_lm(k, jcfg),
                            jax.random.PRNGKey(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if kind == "dp":
        low = jax.jit(jspmd.make_dp_train_step(jcfg)).lower(params, {}, batch)
    else:
        low = jax.jit(jspmd.make_prefill_step(jcfg)).lower(params, batch)
    compiled = low.compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})
    return analyze_hlo(compiled.as_text())["flops"]


FLOP_TOL = 0.01


@pytest.mark.parametrize("arch,kind", [
    ("qwen1.5-0.5b", "dp"), ("qwen1.5-0.5b", "prefill"),
    ("deepseek-v3-671b", "dp"), ("deepseek-v3-671b", "prefill")])
def test_step_flops_agree_with_xla(arch, kind):
    """The port's step on the CPU (the plain versions run: attention as
    the reference's blocked path) against the reference's HLO: within
    FLOP_TOL, and with the family that differs named if not."""
    B, S = 2, 64
    cfg = get_config(arch).reduced()
    p = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     dtype=torch.int32)}
    with Accounting() as acc:
        if kind == "dp":
            make_dp_train_step(cfg)(p, make_optimizer("sgd").init(p), batch)
        else:
            with torch.no_grad():
                make_prefill_step(cfg)(p, batch)
    r = acc.result()
    want = _xla_flops(arch, kind, B, S)
    fams = {f: v["flops"] for f, v in r["by_family"].items() if v["flops"]}
    assert abs(r["flops"] / want - 1) <= FLOP_TOL, (
        f"{arch} {kind}: the port counts {r['flops']:.4e} FLOPs, XLA "
        f"{want:.4e}; by family {fams} (XLA counts dots and "
        "convolutions only)")
