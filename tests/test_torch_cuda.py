"""The port's CUDA kernels (flash decode, wire encode with and without
EF) against their plain PyTorch versions, on the card. Marked ``cuda``:
each test skips where no card is available. This file imports no JAX,
so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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
