"""The port's CUDA kernels (flash decode, wire encode with and without
EF, flash attention forward and backward, the fused wire path's
projection, projection-encode and decode-projection, RMSNorm) against
their plain PyTorch versions, on the card, and the front door
(``run_experiment`` under the delta broadcast) there. Marked ``cuda``:
each test skips where no card is available. This file imports no JAX,
so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import json

import numpy as np
import pytest
import torch

import _launch_rules as rules
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
                                    (1, 128, 200), (1, 64, 1), (1, 64, 65),
                                    (1, 64, 4097), (16, 128, 4097),
                                    (16, 64, 1000), (4, 128, 31),
                                    # head dims run zero-padded to the
                                    # instance's 32, 64 or 128
                                    (1, 24, 64), (4, 24, 300), (2, 48, 64),
                                    (16, 48, 1000), (1, 8, 65), (8, 32, 129),
                                    (4, 96, 200), (16, 96, 33)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("G,hd,L", [(1, 64, 65), (1, 64, 4097),
                                    (16, 128, 4097), (4, 64, 1000),
                                    (1, 24, 4097), (4, 48, 1000),
                                    (16, 96, 4097), (8, 32, 1000)])
def test_flash_decode_splits_and_merges_on_card(G, hd, L):
    """S > 1 splits of the cache, one launch: row 0 lives only in the
    first split (the others wholly masked), row 3 is fully masked and
    exactly zero; fp32 within 1e-5 of the plain version and of the
    plain mirror of the kernel's split-and-merge order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    splits = ops.decode_splits(4, 2, G, L, hd, ops.sm_count("cuda"))
    assert splits[0] > 1
    q, k, v, valid = (torch.from_numpy(a).cuda() for a in
                      _inputs(L + G, B=4, L=L, KVH=2, G=G, hd=hd))
    before = ops.flash_decode.launches
    got = ops.cached_attn_decode(q, k, v, valid)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    torch.testing.assert_close(got, ref.cached_attn_decode_ref(q, k, v, valid),
                               **TOL)
    torch.testing.assert_close(got, ref.flash_decode_split_ref(
        q, k, v, valid, splits=splits, tile=ops.decode_tile_rows(hd)), **TOL)
    assert torch.all(got[3] == 0)
    # The counters of this stream are back to zero for the next call.
    assert all(int(c.abs().sum()) == 0 for c in ops._COUNTERS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,hd,L", [(1, 64, 4097), (16, 128, 300)])
def test_flash_decode_twice_in_one_cuda_graph(dtype, G, hd, L):
    """The same split call captured twice in one graph and the graph
    replayed: each replay gives the plain version's output, so the
    arrival counters were zero at every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert ops.decode_splits(4, 2, G, L, hd, ops.sm_count("cuda"))[0] > 1
    q, k, v, valid = (torch.from_numpy(a).cuda() for a in
                      _inputs(3 * L + G, B=4, L=L, KVH=2, G=G, hd=hd))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    q2 = torch.from_numpy(_inputs(7, B=4, L=L, KVH=2, G=G, hd=hd)[0]).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.cached_attn_decode(q, k, v, valid)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a = ops.cached_attn_decode(q, k, v, valid)
        b = ops.cached_attn_decode(q, k, v, valid)
    tol = TOL if dtype == torch.float32 else {}
    for step in range(3):
        if step == 2:
            q.copy_(q2.to(dtype))         # a replay reads its inputs anew
        graph.replay()
        torch.cuda.synchronize()
        want = ref.cached_attn_decode_ref(q, k, v, valid)
        torch.testing.assert_close(a, want, **tol)
        assert torch.equal(a, b)
        assert torch.all(a[3] == 0)


# ------------------------------------------------------------ wire encode

WIRE = ["int8_row", "int4", "topk", "topk0.1", "sketch", "sketch0.5"]


def _wire_z(rows, d, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((rows, d)) * scale).astype(np.float32)
    z[min(3, rows - 1)] = 0.0                 # an all-zero row
    z[0, : d // 3] = 0.0                      # dead-ReLU zeros
    ties = [i for i in (5, 40, 77) if i < d]
    z[1 % rows, ties] = [3.5, -3.5, 3.5][:len(ties)]   # ties in |z|
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
# last tiles (S 200, 77, 1), sliding windows; then the edges of the bf16
# kernels' 64-row tiles (S 63, 64, 65, 129), windows of 1 and 65 keys,
# G 8 at hd 128 (H 16, KVH 2) and hd 128 at S 512.
ATTN = [(2, 512, 16, 16, 64, -1), (2, 256, 8, 4, 128, -1),
        (2, 200, 4, 4, 64, -1), (1, 130, 4, 2, 64, 48),
        (3, 77, 6, 3, 128, 16), (1, 1, 2, 1, 64, -1),
        (2, 63, 4, 2, 64, -1), (1, 64, 4, 4, 64, -1),
        (2, 65, 4, 1, 128, -1), (1, 129, 4, 4, 64, -1),
        (1, 200, 4, 2, 64, 1), (1, 200, 4, 2, 64, 65),
        (1, 129, 16, 2, 128, -1), (1, 512, 4, 4, 128, -1),
        # Head dims run zero-padded to the instance's 32, 64 or 128: 8,
        # the smoke LM's 24, 32, the composition twin's 48, 96; GQA,
        # windows, partial tiles.
        (2, 77, 4, 2, 8, -1), (2, 200, 4, 2, 24, -1), (1, 129, 4, 4, 24, 48),
        (2, 65, 8, 2, 32, 16), (2, 512, 4, 4, 48, -1), (1, 130, 8, 2, 48, 65),
        (2, 200, 8, 4, 96, 1), (1, 64, 6, 3, 96, -1)]
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


# MLA's head dims: (B, S, H, KVH, hd, hdv, window), v's head dim apart
# from q's and k's. deepseek-v3's (192, 128) on the HD 192 instance (its
# path shape at S 512 with 128 heads, tile edges, a window, GQA), the
# reduced config's (48, 32) on HD 64, and hd 192 with v at 192.
MLA_ATTN = [(1, 512, 128, 128, 192, 128, -1), (2, 65, 8, 8, 192, 128, 48),
            (1, 200, 8, 2, 192, 128, -1), (2, 64, 4, 4, 48, 32, -1),
            (2, 129, 4, 4, 48, 32, 65), (1, 63, 4, 4, 192, 192, -1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,hd,hdv,window", MLA_ATTN)
def test_flash_attention_mla_head_dims_match_plain_on_card(
        B, S, H, KVH, hd, hdv, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(S + hd + hdv)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(dtype) for shape in (
        (B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hdv), (B, S, H, hdv)))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    scale = 1.0 / np.sqrt(hd)
    out = ops.flash_attention(qa, ka, va, window=window, scale=scale)
    assert out.shape == (B, S, H, hdv)
    grads = torch.autograd.grad(out, (qa, ka, va), do)
    fwd_tol, bwd_tol = ATTN_TOL[dtype]
    assert _rel(out, ref.flash_attention_ref(q, k, v, window=window,
                                             scale=scale)) <= fwd_tol
    want = ref.flash_attention_bwd_ref(q, k, v, do, window=window,
                                       scale=scale)
    for g, w, name in zip(grads, want, "qkv"):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g, w) <= bwd_tol, f"d{name}"


# The TPU kernel's causal=False (every row sees every key; a window still
# bounds keys from below): (B, S, H, KVH, hd, window). The seamless
# encoder's self-attention (B 2, S 1024, 16 heads of 64) first; S 100 and
# 1000 off the tile multiples, H = KVH and G > 1, hd 64 and 128, windows,
# a padded head dim and the tile edges.
ATTN_BIDIR = [(2, 1024, 16, 16, 64, -1), (2, 100, 4, 4, 64, -1),
              (1, 1000, 8, 2, 128, -1), (2, 100, 8, 2, 128, 48),
              (1, 1000, 4, 4, 64, 65), (2, 65, 4, 4, 24, -1),
              (1, 129, 4, 1, 64, 1), (2, 64, 6, 3, 64, -1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KVH,hd,window", ATTN_BIDIR)
def test_flash_attention_bidirectional_matches_plain_on_card(
        B, S, H, KVH, hd, window, dtype):
    """``causal=False`` forward and backward, one launch each (counted
    as non-causal too), against the plain version's bidirectional
    attention; deterministic."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(S + hd + 7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(dtype) for shape in (
        (B, S, H, hd), (B, S, KVH, hd), (B, S, KVH, hd), (B, S, H, hd)))
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches,
              ops.flash_attention.bidir_launches,
              ops.flash_attention_bwd.bidir_launches)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qa, ka, va, causal=False, window=window)
    grads = torch.autograd.grad(out, (qa, ka, va), do)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches,
            ops.flash_attention.bidir_launches,
            ops.flash_attention_bwd.bidir_launches) == tuple(
                c + 1 for c in before)
    fwd_tol, bwd_tol = ATTN_TOL[dtype]
    want_o = ref.flash_attention_ref(q, k, v, causal=False, window=window)
    assert _rel(out, want_o) <= fwd_tol
    # The last query row sees the same keys either way; the first does not.
    causal_o = ref.flash_attention_ref(q, k, v, window=window)
    assert _rel(out[:, 0], causal_o[:, 0]) > 10 * fwd_tol or S == 1
    want = ref.flash_attention_bwd_ref(q, k, v, do, causal=False,
                                       window=window)
    for g, w, name in zip(grads, want, "qkv"):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel(g, w) <= bwd_tol, f"d{name}"
    again = ops.flash_attention_bwd(q, k, v, *ops.flash_attention_fwd(
        q, k, v, causal=False, window=window), do, causal=False,
        window=window)
    for a, b in zip(again, grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_hd64_128_outputs_bitwise_the_parents_on_card():
    """At hd 64 and 128 every output of the attention kernels (o, lse,
    dq, dk, dv, decode) is bitwise what the kernels gave before the
    padded head dims: sha256 digests on fixed inputs, against the ones
    those kernels wrote (``_attn_fingerprints.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    import _attn_fingerprints as fp

    want = json.loads(fp.FINGERPRINTS.read_text())
    got = fp.attn_fingerprints(ops)
    assert set(got) == set(want)
    assert [k for k in sorted(got) if got[k] != want[k]] == []


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
    for hd in (20, 200):  # not a multiple of 8, or above 192
        qh, kh = (torch.zeros((*t.shape[:3], hd), device="cuda")
                  for t in (q, k))
        with pytest.raises(ValueError):
            ops.flash_attention(qh, kh, kh)
    for hdv in (20, 72):  # v's head dim not a multiple of 8, or above q's
        with pytest.raises(ValueError):
            ops.flash_attention(q, k, torch.zeros((1, 8, 2, hdv),
                                                  device="cuda"))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.transpose(1, 2), k.transpose(1, 2))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 8, 3, 64), device="cuda"),
                            torch.zeros((1, 8, 3, 64), device="cuda"))
    # Contiguous, but 2 bytes off the 16 the bf16 kernels' copies need.
    flat = torch.zeros(8 * 4 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    kb = k.bfloat16()
    with pytest.raises(ValueError):
        ops.flash_attention(flat[1:].view(1, 8, 4, 64), kb, kb)


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
                                   (1024, 432, 432), (3, 40, 8192),
                                   (32, 40, 8192), (1000, 432, 432)])
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
                                   (2, 8192, 5), (4096, 256, 1024)])
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


# The edges of fusion_proj's tiles: rows around its 4-, 8-, 16-, 64- and
# 128-row tiles, k around its 16- and 32-deep stages, N off the 16-byte
# rows (10, 433) and on them (300 fp32).
EDGE_M = [1, 7, 8, 9, 31, 33, 127, 129]
EDGE_K = [17, 31, 33, 433]
EDGE_N = [10, 300, 433]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", EDGE_M)
def test_fusion_proj_tile_edges_match_plain_on_card(M, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for K in EDGE_K:
        for N in EDGE_N:
            x, w, b = _proj_inputs(M, K, N, seed=M * K + N, dtype=dtype)
            got = ops.fusion_proj(x, w, b, "silu")
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (M, N)
            budget.floats_close(got.float(), ref.fusion_proj_ref(
                x, w, b, "silu").float(), PROJ_TOL[dtype], f"({M},{K},{N})")


@pytest.mark.cuda
@pytest.mark.parametrize("M", EDGE_M)
def test_fusion_proj_tile_edges_keep_the_fused_chain_bitwise(M):
    """fp32: the projection's own main loop sums each output in the same
    fmaf chain as the fused encode's, so its int8_row payload is the
    fused kernel's, bitwise, at every edge shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec = get_codec("int8_row")
    for K in EDGE_K:
        for N in EDGE_N:
            x, w, b = _proj_inputs(M, K, N, seed=M + K * N)
            fused = ops.fusion_proj_encode(x, w, b, "relu", codec=codec)
            unfused = ops.wire_encode(ops.fusion_proj(x, w, b, "relu"), codec)
            for k in unfused:
                assert torch.equal(fused[k], unfused[k]), (K, N, k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ef(int4)", "ef(topk)", "ef(sketch0.5)"])
@pytest.mark.parametrize("M", [7, 8, 9, 17, 40])
def test_fused_encode_row_groups_keep_ef_bitwise(M, name):
    """The fused encode's 8-row groups and 16-column tiles at their
    edges, N from one tile to more rows than one staging of shared memory
    holds: payload and e' of 2 chained EF steps == wire_encode_ef of the
    projection, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ef = get_codec(name)
    for K, N in ((33, 10), (40, 433), (17, 2000), (8, 8192)):
        _, w, b = _proj_inputs(M, K, N, seed=M * N)
        e = torch.zeros((M, N), device="cuda")
        for t in range(2):
            x, _, _ = _proj_inputs(M, K, N, seed=t + N)
            got, e_got = ops.fusion_proj_encode(x, w, b, "relu", codec=ef,
                                                ef_state=e)
            want, e_want = ops.wire_encode_ef(
                ops.fusion_proj(x, w, b, "relu"), e, ef)
            for k in want:
                assert torch.equal(got[k], want[k]), (K, N, t, k)
            assert torch.equal(e_got, e_want), (K, N, t)
            e = e_got


@pytest.mark.cuda
@pytest.mark.parametrize("name", SCHEMES)
@pytest.mark.parametrize("M,K,N", [(32, 1568, 432), (33, 433, 433),
                                   (1000, 432, 432)])
def test_fusion_proj_encode_bf16_matches_plain_on_card(M, K, N, name):
    """bf16 x and w on the tensor cores (#4's mma.sync tiles): the fp32
    projection is encoded, not its bf16 rounding, so the plain version
    is the one of the fp32-widened inputs; codes within its flip budget,
    floats within 1e-5, e' of 2 EF steps too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec, ef = get_codec(name), get_codec(f"ef({name})")
    kind = ops.scheme_for(codec, N).kind
    x, w, b = _proj_inputs(M, K, N, seed=M + N, dtype=torch.bfloat16)
    b = b.float()
    before = ops.fusion_proj_encode.launches
    got = ops.fusion_proj_encode(x, w, b, "relu", codec=codec)
    torch.cuda.synchronize()
    assert ops.fusion_proj_encode.launches == before + 1
    budget.payload_close(kind, got, ref.fusion_proj_encode_ref(
        x.float(), w.float(), b, "relu", codec=codec), N, 1e-5)
    e = torch.zeros((M, N), device="cuda")
    for t in range(2):
        xt = _proj_inputs(M, K, N, seed=t, dtype=torch.bfloat16)[0]
        got, e_got = ops.fusion_proj_encode(xt, w, b, "relu", codec=ef,
                                            ef_state=e)
        plain, e_plain = ref.fusion_proj_encode_ref(
            xt.float(), w.float(), b, "relu", codec=ef, e=e)
        flips = budget.payload_close(kind, got, plain, N, 1e-5)
        budget.residual_close(e_got, e_plain, flips, 1e-5)
        e = e_got


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1024, 432, 432), (1536, 40, 1536),
                                   (1408, 33, 1410)])
def test_fusion_proj_large_tiles_keep_the_fused_chain_bitwise(M, K, N):
    """fp32 on the 64 x 64 and 128 x 128 tiles (the last with 4-byte
    copies, N off 16 bytes): the fused encode's chain, bitwise, and the
    plain version within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec = get_codec("int8_row")
    x, w, b = _proj_inputs(M, K, N, seed=M + N)
    y = ops.fusion_proj(x, w, b, "relu")
    budget.floats_close(y, ref.fusion_proj_ref(x, w, b, "relu"), 1e-5)
    fused = ops.fusion_proj_encode(x, w, b, "relu", codec=codec)
    unfused = ops.wire_encode(y, codec)
    for k in unfused:
        assert torch.equal(fused[k], unfused[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fusion_proj_unaligned_starts_match_plain_on_card(dtype):
    """x and w starting one element off 16 bytes (slices of longer
    buffers) take the narrow copies and give the aligned result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    M, K, N = 32, 784, 1024
    x, w, b = _proj_inputs(M, K, N, seed=9, dtype=dtype)
    xs = torch.empty(M * K + 1, dtype=dtype, device="cuda")
    xs[1:] = x.reshape(-1)
    ws = torch.empty(K * N + 1, dtype=dtype, device="cuda")
    ws[1:] = w.reshape(-1)
    got = ops.fusion_proj(xs[1:].view(M, K), ws[1:].view(K, N), b, "relu")
    want = ops.fusion_proj(x, w, b, "relu")
    if dtype == torch.float32:
        assert torch.equal(got, want)     # the same chain, other copies
    budget.floats_close(got.float(), ref.fusion_proj_ref(
        x, w, b, "relu").float(), PROJ_TOL[dtype])


@pytest.mark.cuda
def test_fusion_proj_bf16_at_large_m_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, w, b = _proj_inputs(512, 1024, 768, seed=5, dtype=torch.bfloat16)
    got = ops.fusion_proj(x, w, b, "relu")
    budget.floats_close(got.float(), ref.fusion_proj_ref(
        x, w, b, "relu").float(), PROJ_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(16, 16, 16), (33, 40, 24), (300, 48, 520),
                                   (1536, 64, 1536), (70, 17, 10)])
def test_fusion_proj_bf16_fragments_are_exact_on_structured_inputs(M, K, N):
    """x's rows are rows of the identity and w[k, n] = (k N + n) % 256, so
    y[m] = w[m % K] exactly in bf16: a wrong fragment or lane map moves
    whole entries, not last bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.zeros((M, K), device="cuda")
    x[torch.arange(M), torch.arange(M) % K] = 1.0
    w = (torch.arange(K * N, device="cuda") % 256).float().reshape(K, N)
    got = ops.fusion_proj(x.bfloat16(), w.bfloat16())
    assert torch.equal(got.float(), w[torch.arange(M) % K])


# decode_proj on fusion_proj's main loop: rows around its 8-, 16- and
# 64-row tiles, N around its 16-column tiles (under 16 the 16 x 8 tile),
# d off 16 bytes (433), past the last d whose rows the 16 x 8 tile keeps
# resident (3421), the last the 8 x 16 tile keeps beside its fp32 ring
# (6588) and past it (6589, 8192: decoded a stage at a time).
DEC_EDGE_M = [1, 7, 8, 9, 33, 65]
DEC_EDGE_N = [1, 15, 16, 17]
DEC_EDGE_D = [433, 3421, 6588, 6589, 8192]


def _graph_replay(fn):
    """fn() captured in a CUDA graph and replayed once -> its output."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("N", DEC_EDGE_N)
@pytest.mark.parametrize("M", DEC_EDGE_M)
def test_decode_proj_tile_edges_keep_the_identity_in_a_graph(M, N):
    """Every scheme, fp32 and bf16 w: one launch a call; replayed from a
    CUDA graph it gives the eager call's bits; with fp32 w it is
    fusion_proj of the codec's decode, bitwise; both within 1e-5 of the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for d in DEC_EDGE_D:
        for name in SCHEMES:
            codec = get_codec(name)
            payload = codec.encode(_wire_z(M, d, seed=M * d + N))
            for dtype in (torch.float32, torch.bfloat16):
                label = (M, N, d, name, dtype)
                _, w, b = _proj_inputs(1, d, N, seed=d + N, dtype=dtype)

                def call():
                    return ops.decode_proj(payload, w, b, "relu", codec=codec,
                                           shape=(M, d))
                before = ops.decode_proj.launches
                got = call()
                torch.cuda.synchronize()
                assert ops.decode_proj.launches == before + 1, label
                assert torch.equal(_graph_replay(call), got), label
                if dtype == torch.float32:
                    z_hat = codec.decode(payload, shape=(M, d))
                    assert torch.equal(got, ops.fusion_proj(z_hat, w, b,
                                                            "relu")), label
                budget.floats_close(got, ref.decode_proj_ref(
                    payload, w, b, "relu", codec=codec, shape=(M, d)), 1e-5,
                    str(label))


def _team_takeover_d(kind):
    """The largest d at which wire_encode runs a warp a row for ``kind``
    at 4096 rows; d + 1 takes the block team."""
    return max(d for d in range(1, 4097) if ops.encode_warps(4096, d, kind))


def _check_wire(rows, d, name):
    """wire_encode and 2 chained wire_encode_ef steps of ``name`` at (rows,
    d) against the plain version: codes bitwise, floats within 1e-6."""
    codec, ef = get_codec(name), get_codec(f"ef({name})")
    z = _wire_z(rows, d, seed=rows + d)
    _assert_payload(ops.wire_encode(z, codec), ref.wire_encode_ref(z, codec))
    e = torch.zeros((rows, d), device="cuda")
    for t in range(2):
        z = _wire_z(rows, d, seed=10 * t + d, scale=1.0 + t)
        got, e_got = ops.wire_encode_ef(z, e, ef)
        want, e_want = ref.wire_encode_ef_ref(z, e, ef)
        _assert_payload(got, want)
        torch.testing.assert_close(e_got, e_want, rtol=1e-6, atol=1e-6)
        e = e_want


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 31, 32, 33, 432, 8192])
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 4096])
def test_wire_encode_team_edges_match_plain_on_card(rows, d):
    """Rows around a block's warps and d around a warp's 32 lanes, a
    path-width row and the widest; every scheme, with and without EF."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in SCHEMES:
        _check_wire(rows, d, name)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SCHEMES)
@pytest.mark.parametrize("rows", [9, 4096])
def test_wire_encode_where_the_block_team_takes_over(rows, kind):
    """The last d of a warp a row and the first of the block team."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = _team_takeover_d(kind)
    assert ops.encode_warps(4096, d + 1, kind) == 0
    for dd in (d, d + 1):
        _check_wire(rows, dd, kind)


def _tie_z(case, rows, d, seed):
    """Rows full of top-k ties: every |z| equal ("equal"), zeros of both
    signs among a few equal magnitudes ("signed_zeros"), or values from a
    small set with each repeated sign-flipped ("flipped")."""
    rng = np.random.default_rng(seed)
    sign = np.where(rng.random((rows, d)) < 0.5, -1.0, 1.0)
    if case == "equal":
        z = 0.75 * sign
    elif case == "signed_zeros":
        z = 0.0 * sign                            # -0.0 and +0.0
        hot = rng.random((rows, d)) < 0.1
        z[hot] = 1.5 * sign[hot]
    else:
        half = rng.choice([0.5, 1.0, 2.0], size=(rows, (d + 1) // 2))
        z = np.concatenate([half, -half], axis=1)[:, :d]
    return torch.from_numpy(z.astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", ["0.0001", "", "1.0"])   # k = 1, d / 4, d
@pytest.mark.parametrize("case", ["equal", "signed_zeros", "flipped"])
@pytest.mark.parametrize("rows,d", [(9, 433), (32, 432), (4096, 432),
                                    (5, 8192)])
def test_wire_encode_topk_ties_are_exact(rows, d, case, ratio):
    """The sort's order is lax.top_k's on ties, +-0 and sign flips, at k =
    1, d / 4 and d: values and indices bitwise equal to the plain
    version's, with and without EF (e' within 1e-6, its clip norms summed
    as a tree); at up to 32 rows the fused encode of the same rows gives
    the same payload and e', bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec, ef = get_codec(f"topk{ratio}"), get_codec(f"ef(topk{ratio})")
    z = _tie_z(case, rows, d, seed=rows * d)
    got = ops.wire_encode(z, codec)
    want = ref.wire_encode_ref(z, codec)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    e = torch.zeros((rows, d), device="cuda")
    for t in range(2):
        got, e_got = ops.wire_encode_ef(z, e, ef)
        want, e_want = ref.wire_encode_ef_ref(z, e, ef)
        for k in want:
            assert torch.equal(got[k], want[k]), (t, k)
        torch.testing.assert_close(e_got, e_want, rtol=1e-6, atol=1e-6)
        if rows <= 32:
            # The identity rows times z: y is z (a -0 becomes +0).
            x = torch.eye(rows, device="cuda")
            fused, e_fused = ops.fusion_proj_encode(x, z, None, "none",
                                                    codec=ef, ef_state=e)
            unfused, e_unfused = ops.wire_encode_ef(
                ops.fusion_proj(x, z, None, "none"), e, ef)
            for k in unfused:
                assert torch.equal(fused[k], unfused[k]), (t, k)
            assert torch.equal(e_fused, e_unfused), t
        e = e_got


# ---------------------------------------------------------------- rmsnorm

# (M, D): kernel_bench's shape, the LM clients' B*S rows at qwen1.5-0.5b's
# d_model, the Table-II fusion width, M off a multiple of 256, an odd D
# with unaligned rows, a long row.
RMS_SHAPES = [(8192, 4096), (4096, 1024), (1, 432), (1000, 432), (37, 1023),
              (3, 8192)]
RMS_TYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)]


def _rms_inputs(M, D, xd, sd, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, D)) * 2.0).astype(np.float32)
    s = rng.standard_normal((D,)).astype(np.float32)
    return torch.from_numpy(x).cuda().to(xd), torch.from_numpy(s).cuda().to(sd)


@pytest.mark.cuda
@pytest.mark.parametrize("xd,sd", RMS_TYPES)
@pytest.mark.parametrize("M,D", RMS_SHAPES)
def test_rmsnorm_kernel_matches_plain_on_card(M, D, xd, sd):
    """fp32 within 2e-5 of max(1, |plain|) (the reference's fp32
    tolerance); bf16 within one bf16 rounding of the plain value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, s = _rms_inputs(M, D, xd, sd, seed=M + D)
    before = ops.rmsnorm.launches
    got = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.rmsnorm.launches == before + 1
    assert got.dtype == xd and got.shape == (M, D)
    want = ref.rmsnorm_ref(x, s).float()
    err = (got.float() - want).abs()
    if xd == torch.float32:
        assert float(err.max()) <= 2e-5 * max(1.0, float(want.abs().max()))
    else:
        assert bool((err <= 2.0 ** -7 * want.abs()).all())


@pytest.mark.cuda
def test_rmsnorm_on_card_is_scale_invariant_and_keeps_leading_dims():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, s = _rms_inputs(16, 64, torch.float32, torch.float32, seed=0)
    s = torch.ones_like(s)
    torch.testing.assert_close(ops.rmsnorm(3.7 * x, s), ops.rmsnorm(x, s),
                               atol=1e-5, rtol=0)
    x3 = x.reshape(2, 8, 64)
    assert torch.equal(ops.rmsnorm(x3, s).reshape(16, 64), ops.rmsnorm(x, s))


@pytest.mark.cuda
def test_rmsnorm_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, s = _rms_inputs(8, 64, torch.float32, torch.float32, seed=1)
    before = ops.rmsnorm.launches
    for bad in ((x.half(), s), (x, s.cpu()), (x, s[:32]),
                (x.t().contiguous().t(), s), (x[:0], s), (x[0, 0], s)):
        with pytest.raises(ValueError):
            ops.rmsnorm(*bad)
    assert ops.rmsnorm.launches == before


# Around the kernel's register limits (a warp a row up to D 1024, a block a
# row up to 8192, then two passes), with row counts off a block's 8 rows.
RMS_EDGES = [(13, 1023), (13, 1024), (13, 1025), (5, 8191), (5, 8192),
             (5, 8193), (2113, 64), (531, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("xd,sd", RMS_TYPES)
@pytest.mark.parametrize("M,D", RMS_EDGES)
def test_rmsnorm_register_limits_and_unaligned_starts_on_card(M, D, xd, sd):
    """The RMS_SHAPES limits; then x and scale starting one element off
    16 bytes (slices of a longer buffer), which take the element-wise
    loads, against the same plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, s = _rms_inputs(M, D, xd, sd, seed=M * D)
    xs = torch.empty(M * D + 1, dtype=xd, device="cuda")
    xs[1:] = x.reshape(-1)
    ss = torch.empty(D + 1, dtype=sd, device="cuda")
    ss[1:] = s
    for xi, si in ((x, s), (xs[1:].view(M, D), ss[1:])):
        got = ops.rmsnorm(xi, si)
        torch.cuda.synchronize()
        assert got.dtype == xd and got.shape == (M, D)
        want = ref.rmsnorm_ref(x, s).float()
        err = (got.float() - want).abs()
        if xd == torch.float32:
            assert float(err.max()) <= 2e-5 * max(1.0, float(want.abs().max()))
        else:
            assert bool((err <= 2.0 ** -7 * want.abs()).all())


# ----------------------------------------------------------- front door


@pytest.mark.cuda
def test_run_experiment_under_delta_on_card_matches_cpu():
    """A short ``run_experiment`` under delta on the card: one
    ``wire_encode_ef`` launch per participant, ledger == the delta
    formula every round, and the same run on the CPU gives the same
    participants and bytes, losses within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.api import DataSpec, ExperimentSpec, run_experiment
    from repro_torch.launch.quickstart import round_bytes_match

    spec = ExperimentSpec(scheme="ifl", rounds=2, tau=2, lr=0.01,
                          codec="ef(int4)", participation="k2",
                          max_staleness=2, broadcast="delta", eval_every=1,
                          data=DataSpec(n_train=800, n_test=200))
    before = ops.wire_encode_ef.launches
    card = run_experiment(spec, keep_trainer=True, device="cuda")
    torch.cuda.synchronize()
    n_part = sum(len(r["participants"]) for r in card.reports)
    assert ops.wire_encode_ef.launches == before + n_part
    assert round_bytes_match(card.trainer, spec)
    cpu = run_experiment(spec, keep_trainer=True, device="cpu")
    assert card.trainer.ledger.per_round == cpu.trainer.ledger.per_round
    for a, b in zip(card.reports, cpu.reports):
        assert a["participants"] == b["participants"]
        assert a["shipped_entries"] == b["shipped_entries"]
        for key in ("base_loss", "mod_loss"):
            assert abs(a[key] - b[key]) <= 1e-4, (key, a[key], b[key])


@pytest.mark.cuda
def test_batched_sampler_bits_on_card_equal_the_cpus():
    """The serving lanes' sampler at full width: a (4, 2) batch of keys
    over (4, 151936) counters (qwen1.5-0.5b's vocab), its bits, its key
    split and its sampled tokens on the card, bitwise the CPU's (integer
    ops, then the same fp32 steps; the logits here are far from ties)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.serve import lanes, prng

    V = 151936
    keys = prng.split(prng.prng_key(17), 4)
    bits = {dev: prng.random_bits(keys.to(dev), (V,)).cpu()
            for dev in ("cpu", "cuda")}
    assert bits["cpu"].shape == (4, V)
    assert torch.equal(bits["cuda"], bits["cpu"])
    assert int(bits["cpu"].min()) >= 0 and int(bits["cpu"].max()) < 2**32
    assert torch.equal(prng.split(keys.cuda()).cpu(), prng.split(keys))
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, V)).astype(np.float32)) * 4
    temp = torch.tensor([0.8, 0.0, 1.3, 0.5])
    top_k = torch.tensor([20, 0, 0, 1])
    toks = {dev: lanes.sample_token(logits.to(dev), keys.to(dev),
                                    temp.to(dev), top_k.to(dev)).cpu()
            for dev in ("cpu", "cuda")}
    assert torch.equal(toks["cuda"], toks["cpu"])


# ------------------------------------------------------- launch plans


@pytest.fixture
def wire_plan_file(tmp_path, monkeypatch):
    """A plan file of the test's own, read afresh."""
    path = tmp_path / "wire_plan.json"
    monkeypatch.setenv("REPRO_TORCH_WIRE_PLAN_CACHE", str(path))
    monkeypatch.setattr(ops, "_wire_cache_mem", None)
    yield path
    ops._wire_cache_mem = None


def _launches():
    return [f.launches for f in (ops.wire_encode, ops.wire_encode_ef,
                                 ops.fusion_proj_encode, ops.fusion_proj_quant,
                                 ops.decode_proj)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,codec,rows,d", [
    ("encode", "int8_row", 32, 432), ("encode", "ef(int4)", 32, 432),
    ("encode", "topk", 1024, 432), ("encode", "int4", 4096, 1024),
    ("proj_encode", "int8_row", 32, 432), ("proj_encode", "ef(int4)", 512, 432),
    ("proj_encode", "sketch", 32, 433), ("decode_proj", "int8_row", 32, 432),
    ("decode_proj", "ef(int4)", 512, 1024), ("decode_proj", "topk", 33, 433)])
def test_autotune_wire_plan_writes_an_admissible_entry_on_card(
        wire_plan_file, kind, codec, rows, d):
    """Every candidate's outputs bitwise the kernel rule's, the winner
    among them, persisted under this card's key and read back by
    wire_plan; the launch counters as they were; a second call is a
    cache hit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    knob = "warps" if kind == "encode" else "tile"
    before = _launches()
    entry = ops.autotune_wire_plan(codec, d, kind=kind, rows=rows, reps=1)
    assert _launches() == before
    cands = entry["candidates"]
    assert len(cands) > 1 and all(c["admissible"] for c in cands), cands
    assert entry[knob] in [c[knob] for c in cands]
    assert entry["us"] == min(c["us"] for c in cands)
    name = get_codec(codec).name
    key = f"{ops.card_name('cuda')}|{kind}|{name}|d{d}"
    assert json.loads(wire_plan_file.read_text())[key] == entry
    ops._wire_cache_mem = None
    assert ops.wire_plan(name, d, kind, "cuda") == {knob: entry[knob]}
    assert ops.autotune_wire_plan(codec, d, kind=kind, rows=rows) == entry


def _spied(entry, call):
    with rules.KnobSpy(ops) as spy:
        out = call()
    torch.cuda.synchronize()
    assert spy.count(entry) == 1
    return out, spy.knob(entry)


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_a_tuned_encode_team_is_the_team_launched_on_card(wire_plan_file,
                                                          warps):
    """A plan entry's team, other than encode_warps' block team at
    (32, 432), is the one the wrapper passes; the payload and e' are
    bitwise the rule's, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec = get_codec("ef(int4)")
    assert ops.encode_warps(32, 432, "int4") == 0
    z, e = _wire_z(32, 432, seed=1), _wire_z(32, 432, seed=2, scale=0.1)
    want, e_want = ops.wire_encode_ef(z, e, codec, warps=-1)
    wire_plan_file.write_text(json.dumps(
        {f"{ops.card_name('cuda')}|encode|ef(int4)|d432": {"warps": warps}}))
    before = ops.wire_encode_ef.launches
    (got, e_got), (passed, _) = _spied(
        "wire_encode", lambda: ops.wire_encode_ef(z, e, codec))
    assert passed == warps
    assert ops.wire_encode_ef.launches == before + 1
    assert ops._first_differing({**want, "e": e_want}, {**got, "e": e_got}) \
        is None


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tile", [("proj_encode", 0),
                                       ("decode_proj", 1),
                                       ("decode_proj", 3)])
def test_a_tuned_tile_is_the_tile_launched_on_card(wire_plan_file, kind,
                                                   tile):
    """A plan entry's tile, other than the rule's at the boundary's M
    32, is the one the wrapper passes (with the card's SM count); the
    outputs are bitwise the rule's; bf16 launches keep the rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    codec = get_codec("int8_row")
    sms = ops.sm_count("cuda")
    x, w, b = (torch.randn(s, device="cuda") for s in ((32, 1568),
                                                       (1568, 432), (432,)))
    payload = ref.wire_encode_ref(_wire_z(32, 432, seed=3), codec)
    wd = torch.randn((432, 256), device="cuda") * 0.05

    if kind == "proj_encode":
        def call(t, dtype=torch.float32):
            return ops.fusion_proj_encode(x.to(dtype), w.to(dtype), b,
                                          "relu", codec=codec, tile=t)
        entry_name = "fusion_proj_encode"
        assert ops.fused_tile(kind, 32, 1568, 432) != tile
    else:
        def call(t, dtype=torch.float32):
            return {"y": ops.decode_proj(payload, wd.to(dtype), b[:256],
                                         "relu", codec=codec,
                                         shape=(32, 432), tile=t)}
        entry_name = "decode_proj"
        assert ops.fused_tile(kind, 32, 432, 256) != tile
        assert ops.fused_tile(kind, 32, 432, 256, tile=tile) == tile
    want = call(-1)
    wire_plan_file.write_text(json.dumps(
        {f"{ops.card_name('cuda')}|{kind}|int8_row|d432": {"tile": tile}}))
    got, passed = _spied(entry_name, lambda: call(None))
    assert passed == (tile, sms)
    assert ops._first_differing(want, got) is None
    _, passed = _spied(entry_name, lambda: call(None, torch.bfloat16))
    assert passed == (-1, sms)


@pytest.mark.cuda
def test_tile_and_grid_choices_at_the_cards_count_are_the_rule_at_132():
    """#4's tile, the fused encode's tile and #7's grid as the kernels
    choose them at the card's SM count: the rule at that count, and at
    132 SMs the rule the H100 SXM was tuned with."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sms = ops.sm_count("cuda")
    assert sms == torch.cuda.get_device_properties(0).multi_processor_count
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        for M in (1, 32, 33, 256, 1000, 1024, 4096, 8192):
            for K, N in ((784, 1024), (1568, 432), (64, 10), (4096, 2048),
                         (432, 432), (96, 432), (40, 8192)):
                for n_sm in (sms, 132):
                    assert ops.fused_tile("fusion_proj", M, K, N, dt,
                                          sms=n_sm) == rules.proj_tile(
                        M, N, name, n_sm), (M, K, N, name, n_sm)
                    assert ops.fused_tile("proj_encode", M, K, N, dt,
                                          sms=n_sm) == rules.encode_tile(
                        M, N, name, n_sm), (M, K, N, name, n_sm)
                assert ops.fused_tile("fusion_proj", M, K, N, dt) == \
                    ops.fused_tile("fusion_proj", M, K, N, dt, sms=sms)
        for rows in (1, 3, 37, 1000, 4096, 8192, 100000):
            for d in (432, 1023, 1024, 4096, 8192, 8193):
                aligned = d % (4 if dt == torch.float32 else 8) == 0
                for n_sm in (sms, 132):
                    assert ops.rmsnorm_grid(rows, d, dt, sms=n_sm) == \
                        rules.rmsnorm_grid(rows, d, aligned, n_sm)
                assert ops.rmsnorm_grid(rows, d, dt, aligned=False) == \
                    rules.rmsnorm_grid(rows, d, False, sms)

