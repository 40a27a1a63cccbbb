"""The port's full-sequence attention against the JAX package on the CPU.

* ``kernels.ref.flash_attention_ref`` (the plain version of the port's
  flash-attention kernel, in the model's (B, S, H, hd) layout with GQA
  K/V) against the TPU kernel itself, ``repro.kernels.ops.flash_attention
  (..., interpret=True)``: the Pallas kernel in interpret mode. fp32
  within 2e-5 (both sum in fp32, in other orders); bf16 within 4e-2 (the
  reference rounds q.k to bf16 before its fp32 softmax, and both round p
  to bf16 at other points: the unnormalized p of the online softmax in
  the Pallas kernel, the normalized p here).
* ``models.attention.blocked_attention`` against the reference's, forward
  and gradients (``jax.grad`` vs ``torch.autograd``), fp32 within 1e-5.
* ``ops.flash_attention`` on CPU tensors is the plain version, and its
  plain backward is autograd of it.

Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn

HD = 64
# Every S and window; GQA (4 query heads on 2 KV heads) at S 64 and 192,
# MHA at S 128. Then the edges of the card's bf16 kernel tiles (64 rows):
# S 63, 65 and 129, and windows of 1 and 65 keys, which the card tests
# hold the kernels to this plain version at.
CASES = [(S, w, 2 if S != 128 else 4) for S in (64, 128, 192)
         for w in (-1, 16, 48)] + [
    (63, -1, 2), (65, -1, 2), (129, -1, 4), (129, 1, 2), (129, 65, 2)]
TOLS = {"float32": 2e-5, "bfloat16": 4e-2}


def _qkv(S, kvh, seed, B=2, H=4):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, HD)).astype(np.float32)
    k = rng.standard_normal((B, S, kvh, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, kvh, HD)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,window,kvh", CASES)
def test_plain_version_matches_pallas_kernel_in_interpret_mode(
        S, window, kvh, dtype):
    q, k, v = _qkv(S, kvh, seed=S + window)
    jdt = jnp.dtype(dtype)
    # The reference's layout is (B, H, S, hd).
    want = jops.flash_attention(
        *(jnp.asarray(a.transpose(0, 2, 1, 3)).astype(jdt) for a in (q, k, v)),
        causal=True, window=window, interpret=True)
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3)
    tdt = getattr(torch, dtype)
    got = ref.flash_attention_ref(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        causal=True, window=window)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOLS[dtype],
                               atol=TOLS[dtype])


@pytest.mark.parametrize("S,q_block,window,kvh", [
    (64, 16, -1, 2), (64, 16, 24, 2), (48, 16, 8, 4), (32, 64, -1, 1),
])
def test_blocked_attention_forward_and_grads_match_jax(S, q_block, window,
                                                       kvh):
    q, k, v = _qkv(S, kvh, seed=7 + S)
    rng = np.random.default_rng(S)
    w = rng.standard_normal(q.shape).astype(np.float32)  # loss weights

    def jloss(q_, k_, v_):
        o = jattn.blocked_attention(q_, k_, v_, window=window,
                                    q_block=q_block)
        return jnp.sum(o * w), o

    (lj, oj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(*map(jnp.asarray,
                                                         (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ot = tattn.blocked_attention(qt, kt, vt, window=window, q_block=q_block)
    lt = (ot * torch.from_numpy(w)).sum()
    gt = torch.autograd.grad(lt, (qt, kt, vt))
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(oj),
                               rtol=1e-5, atol=1e-5)
    for a, b, name in zip(gt, gj, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("window", [-1, 16])
def test_ops_on_cpu_is_the_plain_version_and_bwd_is_its_autograd(window):
    q, k, v = (torch.from_numpy(a) for a in _qkv(96, 2, seed=3))
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qa, ka, va, window=window)
    torch.testing.assert_close(
        out, ref.flash_attention_ref(q, k, v, window=window), rtol=0, atol=0)
    do = torch.cos(torch.arange(out.numel(), dtype=torch.float32)
                   ).reshape(out.shape)
    got = torch.autograd.grad(out, (qa, ka, va), do)
    want = ref.flash_attention_bwd_ref(q, k, v, do, window=window)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # The blocked path and the plain version agree (the same function).
    torch.testing.assert_close(
        tattn.blocked_attention(q, k, v, window=window, q_block=32),
        out.detach(), rtol=1e-5, atol=1e-5)
    # CPU tensors never count a kernel launch.
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == before
