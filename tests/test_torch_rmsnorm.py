"""The port's RMSNorm op (``repro_torch.kernels.ops.rmsnorm``) on the CPU,
where it runs its plain version, against the JAX package's TPU kernel
``rmsnorm_pallas`` in interpret mode (through ``repro.kernels.ops.rmsnorm
(..., interpret=True)``) and its jnp oracle ``repro.kernels.ref
.rmsnorm_ref``, on the same numpy inputs.

Tolerances are the reference's own (tests/test_kernels.py:188): fp32
2e-5, bf16 3e-2, absolute and relative. The CUDA kernel
(``csrc/rmsnorm.cu``) runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _port_parity import one_torch_thread  # noqa: F401 (autouse)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# (x dtype, scale dtype): the reference's two cases and the LM path's
# mixed one (bf16 activations, fp32 params).
DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
          ("bfloat16", "float32")]


def _inputs(m, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, d)) * 2.0).astype(np.float32)
    s = rng.standard_normal((d,)).astype(np.float32)
    return x, s


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


@pytest.mark.parametrize("xd,sd", DTYPES)
@pytest.mark.parametrize("d", [32, 256, 432, 1023])
@pytest.mark.parametrize("m", [1, 37, 64, 300])
def test_rmsnorm_matches_pallas_interpret_and_oracle(m, d, xd, sd):
    x, s = _inputs(m, d, seed=m * 7 + d)
    got = ops.rmsnorm(_torch(x, xd), _torch(s, sd))
    assert got.dtype == getattr(torch, xd) and got.shape == (m, d)
    got = got.float().numpy()
    jx, js = _jax(x, xd), _jax(s, sd)
    pallas = np.asarray(jops.rmsnorm(jx, js, interpret=True), np.float32)
    oracle = np.asarray(jref.rmsnorm_ref(jx, js), np.float32)
    tol = TOL[xd]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=tol)


def test_rmsnorm_scale_invariance():
    """RMSNorm(a * x) == RMSNorm(x) for a > 0 (tests/test_kernels.py:195)."""
    x, _ = _inputs(16, 64, seed=0)
    s = torch.ones(64)
    y1 = ops.rmsnorm(torch.from_numpy(x), s)
    y2 = ops.rmsnorm(torch.from_numpy(3.7 * x), s)
    torch.testing.assert_close(y1, y2, atol=1e-5, rtol=0)


def test_rmsnorm_flattens_and_restores_leading_dims():
    x, s = _inputs(2 * 3 * 5, 48, seed=1)
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    got = ops.rmsnorm(xt.reshape(2, 3, 5, 48), st)
    assert got.shape == (2, 3, 5, 48)
    assert torch.equal(got.reshape(30, 48), ref.rmsnorm_ref(xt, st))
    jgot = jops.rmsnorm(jnp.asarray(x).reshape(2, 3, 5, 48), jnp.asarray(s),
                        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=2e-5,
                               rtol=2e-5)


def test_cpu_dispatch_is_the_plain_version_and_launches_nothing():
    x, s = _inputs(9, 432, seed=2)
    xt, st = _torch(x, "bfloat16"), _torch(s, "float32")
    before = ops.rmsnorm.launches
    assert torch.equal(ops.rmsnorm(xt, st), ref.rmsnorm_ref(xt, st))
    assert ops.rmsnorm.launches == before


def test_rmsnorm_off_the_cpu_raises_without_falling_back(monkeypatch):
    """A tensor that is not on the CPU never takes the plain version: it
    goes to the kernel's path, or raises. A meta tensor (a dry-run) goes
    through the kernel's checks, which raise on what the kernel does not
    take, and counts a meta launch of it; the plain version is never
    called and nothing launches."""
    def plain(*a, **k):
        raise AssertionError("a meta tensor reached the plain version")

    monkeypatch.setattr(ref, "rmsnorm_ref", plain)
    x = torch.empty((4, 32), device="meta")
    before = (ops.rmsnorm.launches, ops.rmsnorm.meta_launches)
    with pytest.raises(ValueError, match="shapes"):
        ops.rmsnorm(x, torch.empty((31,), device="meta"))
    with pytest.raises(ValueError, match="dtypes"):
        ops.rmsnorm(x.double(), torch.empty((32,), device="meta"))
    y = ops.rmsnorm(x, torch.empty((32,), device="meta"))
    assert y.device.type == "meta" and y.shape == x.shape
    assert (ops.rmsnorm.launches, ops.rmsnorm.meta_launches) == (
        before[0], before[1] + 1)


def test_rmsnorm_rejects_a_0d_tensor_on_every_device():
    """A 0-d x has no last dim to normalize over: ValueError, on the CPU
    as on any other device, before anything reads its shape."""
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="0-d"):
            ops.rmsnorm(torch.ones((), device=dev),
                        torch.ones((1,), device=dev))
