"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: each test skips where no card is available. This
file imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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
