"""The port's CUDA kernels (flash decode, wire encode with and without
EF, flash attention forward and backward, the fused wire path's
projection, projection-encode and decode-projection) against their plain
PyTorch versions, on the card. Marked ``cuda``:
each test skips where no card is available. This file imports no JAX,
so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import _wire_budget as budget
from repro_torch.core.codec import get_codec
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, L, KVH, G, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, KVH, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KVH, hd)).astype(np.float32)
    valid = np.zeros((B, L), bool)
    valid[0, :5] = True                      # a prefix, as decode has it
    valid[1] = True                          # the whole cache
    valid[2] = rng.random(L) < 0.5           # a scattered ring buffer
    valid[2, L - 1] = True
    # valid[3] stays all False: the fully masked row.
    return q, k, v, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd,L", [(1, 64, 64), (2, 128, 40), (4, 64, 300),
                                    (16, 128, 33), (3, 128, 70),
                                    (1, 128, 200)])
def test_flash_decode_kernel_matches_plain_on_card(dtype, G, hd, L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v, valid = (torch.from_numpy(a).cuda() for a in
                      _inputs(11, B=4, L=L, KVH=2, G=G, hd=hd))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = ops.flash_decode.launches
    got = ops.cached_attn_decode(q, k, v, valid)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    want = ref.cached_attn_decode_ref(q, k, v, valid)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        torch.testing.assert_close(got, want)
    assert torch.all(got[3] == 0)


# ------------------------------------------------------------ wire encode

WIRE = ["int8_row", "int4", "topk", "topk0.1", "sketch", "sketch0.5"]


def _wire_z(rows, d, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((rows, d)) * scale).astype(np.float32)
    z[min(3, rows - 1)] = 0.0                 # an all-zero row
    z[0, : d // 3] = 0.0                      # dead-ReLU zeros
    z[1 % rows, [5, 40, 77]] = [3.5, -3.5, 3.5]   # ties in |z|
    return torch.from_numpy(z).cuda()


def _assert_payload(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = got[name], want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(a, b), name      # codes and indices: bitwise


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIRE)
@pytest.mark.parametrize("rows,d", [(32, 432), (32, 433), (4096, 432),
                                    (5, 8192)])
def test_wire_encode_kernel_matches_plain_on_card(name, rows, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec = get_codec(name)
    z = _wire_z(rows, d, seed=rows + d)
    before = ops.wire_encode.launches
    got = ops.wire_encode(z, codec)
    torch.cuda.synchronize()
    assert ops.wire_encode.launches == before + 1
    _assert_payload(got, ref.wire_encode_ref(z, codec))


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIRE)
@pytest.mark.parametrize("rows,d", [(32, 432), (32, 433), (4096, 432)])
def test_wire_encode_ef_kernel_matches_plain_on_card(name, rows, d):
    """Four chained EF steps, each fed the plain version's residual."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec = get_codec(f"ef({name})")
    e = torch.zeros((rows, d), device="cuda")
    for t in range(4):
        z = _wire_z(rows, d, seed=10 * t + d, scale=1.0 + t)
        before = ops.wire_encode_ef.launches
        got, e_got = ops.wire_encode_ef(z, e, codec)
        torch.cuda.synchronize()
        assert ops.wire_encode_ef.launches == before + 1
        want, e_want = ref.wire_encode_ef_ref(z, e, codec)
        _assert_payload(got, want)
        torch.testing.assert_close(e_got, e_want, rtol=1e-6, atol=1e-6)
        e = e_want


@pytest.mark.cuda
def test_exchange_on_card_launches_the_kernels():
    """A CUDA tensor never takes the plain path for a codec with a wire
    scheme: the exchange's encode goes through the kernel (counted)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.exchange import FusionExchange

    for name, counter in [("int8_row", ops.wire_encode),
                          ("ef(int4)", ops.wire_encode_ef),
                          ("topk0.1", ops.wire_encode),
                          ("ef(sketch)", ops.wire_encode_ef)]:
        ex = FusionExchange(name, 2, (32, 432), device="cuda")
        before = counter.launches
        z = _wire_z(32, 432, seed=1)
        y = torch.zeros(32, dtype=torch.int32, device="cuda")
        ex.upload(0, z, y, 0)
        ex.upload(1, z, y, 0)
        assert counter.launches == before + 2, name
    before = (ops.wire_encode.launches, ops.wire_encode_ef.launches)
    ex = FusionExchange("bf16", 1, (32, 432), device="cuda")  # no scheme
    ex.upload(0, _wire_z(32, 432, seed=2), y, 0)
    assert (ops.wire_encode.launches, ops.wire_encode_ef.launches) == before


@pytest.mark.cuda
def test_wire_encode_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec, ef = get_codec("int8_row"), get_codec("ef(int8_row)")
    z = _wire_z(8, 432, seed=0)
    with pytest.raises(ValueError):
        ops.wire_encode(z.half(), codec)                  # dtype
    with pytest.raises(ValueError):
        ops.wire_encode(z.t().contiguous().t(), codec)    # not contiguous
    with pytest.raises(ValueError):
        ops.wire_encode_ef(z, torch.zeros(4, 432, device="cuda"), ef)
    with pytest.raises(ValueError):
        ops.wire_encode_ef(z, torch.zeros(8, 432), ef)    # e on the CPU


# ------------------------------------------------------- flash attention

# (B, S, H, KVH, hd, window): the LM path's shape, GQA at hd 128, partial
# last tiles (S 200, 77, 1), sliding windows.
ATTN = [(2, 512, 16, 16, 64, -1), (2, 256, 8, 4, 128, -1),
        (2, 200, 4, 4, 64, -1), (1, 130, 4, 2, 64, 48),
        (3, 77, 6, 3, 128, 16), (1, 1, 2, 1, 64, -1)]
# Relative to max(1, max |plain|): fp32 sums in another order; in bf16 the
# kernel rounds the online softmax's unnormalized p, the plain version
# the normalized p, and outputs are rounded to bf16.
ATTN_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 3e-2)}


def _rel(got, want):
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,hd,window", ATTN)
def test_flash_attention_kernels_match_plain_on_card(B, S, H, KVH, hd,
                                                     window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(S + hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(dtype) for shape in (
        (B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd), (B, S, H, hd)))
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qa, ka, va, window=window)
    grads = torch.autograd.grad(out, (qa, ka, va), do)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == (before[0] + 1,
                                                  before[1] + 1)
    fwd_tol, bwd_tol = ATTN_TOL[dtype]
    assert _rel(out, ref.flash_attention_ref(q, k, v, window=window)) \
        <= fwd_tol
    want = ref.flash_attention_bwd_ref(q, k, v, do, window=window)
    for g, w, name in zip(grads, want, "qkv"):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g, w) <= bwd_tol, f"d{name}"
    # Deterministic: no atomics, the same bits on a second run.
    again = ops.flash_attention_bwd(q, k, v, *ops.flash_attention_fwd(
        q, k, v, window=window), do, window=window)
    for a, b in zip(again, grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_lm_loss_on_card_launches_attention_kernels_per_layer():
    """Every layer's attention is a kernel launch on the card: under
    remat 'group' the forward kernel runs twice per layer (the backward
    recomputes the checkpointed group), the backward kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.core.ifl_spmd import value_and_grad
    from repro_torch.models.transformer import init_lm, lm_loss

    cfg = get_config("qwen1.5-0.5b").reduced().replace(
        compute_dtype="bfloat16", remat="group")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_lm(cfg, generator=gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), device="cuda")
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    loss, grads = value_and_grad(lm_loss, params, cfg, {"tokens": tokens})
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    L = cfg.num_layers
    assert (ops.flash_attention.launches - before[0],
            ops.flash_attention_bwd.launches - before[1]) == (2 * L, L)


@pytest.mark.cuda
def test_flash_attention_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q = torch.zeros((1, 8, 4, 64), device="cuda")
    k = torch.zeros((1, 8, 2, 64), device="cuda")
    with pytest.raises(ValueError):
        ops.flash_attention(q.half(), k.half(), k.half())          # dtype
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :32].contiguous(),
                            k[..., :32].contiguous(),
                            k[..., :32].contiguous())              # hd 32
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.transpose(1, 2), k.transpose(1, 2))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 8, 3, 64), device="cuda"),
                            torch.zeros((1, 8, 3, 64), device="cuda"))


# ------------------------------------------------- the fused wire path

# (M, K, N): the IFL path's fusion FCs, a ragged shape and degenerate ones.
PROJ = [(32, 1568, 432), (32, 784, 432), (33, 433, 433), (1, 1, 1),
        (5, 20, 300), (70, 17, 10)]
# fp32 against cuBLAS: sums in another order, relative to max |plain|;
# bf16 outputs: one bf16 rounding of a value that may differ in its
# last fp32 bits (2^-7 relative).
PROJ_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _proj_inputs(M, K, N, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[min(2, M - 1)] = 0.0                    # a zero row
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(N)).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda().to(dtype) for a in (x, w, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "relu", "silu"])
@pytest.mark.parametrize("M,K,N", PROJ)
def test_fusion_proj_kernel_matches_plain_on_card(M, K, N, act, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w, b = _proj_inputs(M, K, N, seed=M + K + N, dtype=dtype)
    for bias in (b, None):
        before = ops.fusion_proj.launches
        got = ops.fusion_proj(x, w, bias, act)
        torch.cuda.synchronize()
        assert ops.fusion_proj.launches == before + 1
        want = ref.fusion_proj_ref(x, w, bias, act)
        assert got.dtype == dtype and got.shape == (M, N)
        budget.floats_close(got.float(), want.float(), PROJ_TOL[dtype])
    # Leading dims are flattened.
    got = ops.fusion_proj(x.reshape(1, M, K), w, b, act)
    assert torch.equal(got, ops.fusion_proj(x, w, b, act).reshape(1, M, N))


SCHEMES = ["int8_row", "int4", "topk", "sketch"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCHEMES + ["topk0.1", "sketch0.5"])
@pytest.mark.parametrize("M,K,N", [(32, 1568, 432), (33, 433, 433),
                                   (1024, 432, 432), (3, 40, 8192)])
def test_fusion_proj_encode_is_the_wire_encode_of_fusion_proj(M, K, N, name):
    """Bitwise: the fused payload is wire_encode of the kernel's own
    projection, e' of 3 chained EF steps included; against the plain
    version (cuBLAS) codes within the flip budget."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec, ef = get_codec(name), get_codec(f"ef({name})")
    kind = ops.scheme_for(codec, N).kind
    x, w, b = _proj_inputs(M, K, N, seed=K + N)
    before = ops.fusion_proj_encode.launches
    got = ops.fusion_proj_encode(x, w, b, "relu", codec=codec)
    torch.cuda.synchronize()
    assert ops.fusion_proj_encode.launches == before + 1
    y = ops.fusion_proj(x, w, b, "relu")
    want = ops.wire_encode(y, codec)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    budget.payload_close(kind, got, ref.fusion_proj_encode_ref(
        x, w, b, "relu", codec=codec), N, 1e-5)
    e = torch.zeros((M, N), device="cuda")
    for t in range(3):
        x, _, _ = _proj_inputs(M, K, N, seed=t)
        got, e_got = ops.fusion_proj_encode(x, w, b, "relu", codec=ef,
                                            ef_state=e)
        want, e_want = ops.wire_encode_ef(ops.fusion_proj(x, w, b, "relu"),
                                          e, ef)
        for k in want:
            assert torch.equal(got[k], want[k]), (t, k)
        assert torch.equal(e_got, e_want), t
        plain, e_plain = ref.fusion_proj_encode_ref(x, w, b, "relu",
                                                    codec=ef, e=e)
        flips = budget.payload_close(kind, got, plain, N, 1e-5)
        budget.residual_close(e_got, e_plain, flips, 1e-5)
        e = e_got


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "relu", "silu"])
@pytest.mark.parametrize("M,K,N", [(32, 1568, 432), (33, 433, 433),
                                   (4096, 96, 432)])
def test_fusion_proj_quant_is_the_int8_row_payload(M, K, N, act):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w, b = _proj_inputs(M, K, N, seed=7)
    codec = get_codec("int8_row")
    before = ops.fusion_proj_quant.launches
    q, scale = ops.fusion_proj_quant(x, w, b, act)
    torch.cuda.synchronize()
    assert ops.fusion_proj_quant.launches == before + 1
    assert q.dtype == torch.int8 and q.shape == (M, N)
    assert scale.dtype == torch.float32 and scale.shape == (M, 1)
    p = ops.fusion_proj_encode(x, w, b, act, codec=codec)
    assert torch.equal(q, p["q"]) and torch.equal(scale, p["scale"])
    qr, sr = ref.fusion_proj_quant_ref(x, w, b, act)
    budget.payload_close("int8_row", {"q": q, "scale": scale},
                         {"q": qr, "scale": sr}, N, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCHEMES + ["topk0.1"])
@pytest.mark.parametrize("M,d,N", [(32, 432, 256), (32, 432, 10),
                                   (33, 433, 433), (1024, 432, 432),
                                   (2, 8192, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_proj_is_fusion_proj_of_the_decode(M, d, N, name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec = get_codec(name)
    z = _wire_z(M, d, seed=d + N)
    payload = codec.encode(z)
    _, w, b = _proj_inputs(1, d, N, seed=N, dtype=dtype)
    before = ops.decode_proj.launches
    got = ops.decode_proj(payload, w, b, "relu", codec=codec, shape=(M, d))
    torch.cuda.synchronize()
    assert ops.decode_proj.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    if dtype == torch.float32:
        z_hat = codec.decode(payload, shape=(M, d))
        assert torch.equal(got, ops.fusion_proj(z_hat, w, b, "relu"))
    want = ref.decode_proj_ref(payload, w, b, "relu", codec=codec,
                               shape=(M, d))
    budget.floats_close(got, want, 1e-5)
    # An ef(...) codec decodes with its inner scheme: the same launch.
    again = ops.decode_proj(payload, w, b, "relu", codec=get_codec(
        f"ef({name})"), shape=(M, d))
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_fused_wire_path_without_a_scheme_runs_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w, b = _proj_inputs(8, 40, 432, seed=1)
    counters = (ops.fusion_proj_encode, ops.decode_proj, ops.fusion_proj,
                ops.fusion_proj_quant)
    before = [c.launches for c in counters]
    for name in ("fp32", "bf16", "int8"):
        codec = get_codec(name)
        p = ops.fusion_proj_encode(x, w, b, "relu", codec=codec)
        y = ops.decode_proj(p, w.t().contiguous(), None, "none",
                            codec=codec, shape=(8, 432))
        assert y.shape == (8, 40) and y.device.type == "cuda"
    _, wide, _ = _proj_inputs(1, 40, ops.MAX_FUSED_D + 1, seed=2)
    q, _ = ops.fusion_proj_quant(x, wide)
    assert q.shape == (8, ops.MAX_FUSED_D + 1)
    assert [c.launches for c in counters] == before


@pytest.mark.cuda
def test_fused_wire_path_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w, b = _proj_inputs(8, 40, 432, seed=3)
    codec, ef = get_codec("int8_row"), get_codec("ef(int8_row)")
    with pytest.raises(ValueError):
        ops.fusion_proj(x.half(), w.half())                     # dtype
    with pytest.raises(ValueError):
        ops.fusion_proj(x, w.to(torch.bfloat16))                # mixed
    with pytest.raises(ValueError):
        ops.fusion_proj(x, w.t().contiguous().t())              # layout
    with pytest.raises(ValueError):
        ops.fusion_proj(x, w, b, "gelu")                        # act
    with pytest.raises(ValueError):
        ops.fusion_proj_encode(x, w, b.cpu(), codec=codec)      # device
    with pytest.raises(ValueError):
        ops.fusion_proj_encode(x, w, codec=codec,
                               ef_state=torch.zeros(8, 432, device="cuda"))
    with pytest.raises(ValueError):
        ops.fusion_proj_encode(x, w, codec=ef,
                               ef_state=torch.zeros(4, 432, device="cuda"))
    p = codec.encode(_wire_z(8, 432, seed=0))
    with pytest.raises(ValueError):
        ops.decode_proj({"q": p["q"]}, w.t().contiguous(), codec=codec,
                        shape=(8, 432))                         # leaves
    with pytest.raises(ValueError):
        ops.decode_proj(p, w, codec=codec, shape=(8, 432))      # w rows
