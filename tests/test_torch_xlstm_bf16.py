"""The open question of xlstm-350m's bf16 gradient, settled on the CPU:
at full width on the card it lies at cos 0.155 to the fp32 one. Eager
PyTorch rounds after every bf16 op, where the reference's XLA fusions
may keep intermediates in fp32; if the port's bf16 gradient lay much
further from the fp32 one than the reference's, that would be a fault
of the port."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _port_parity import flat, numpy_tree, one_torch_thread  # noqa: F401
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.core.ifl_spmd import value_and_grad
from repro_torch.models import transformer as tf

ARCH = "xlstm-350m"
B, S = 2, 32
# How much further from the fp32 gradient the port's bf16 gradient may lie
# than the reference's, in cosine, before it is a fault of the port.
BF16_COS_GAP = 0.05


def _cos(a, b):
    """Cosine of two gradients given as {name: array}, in fp64."""
    dot = sum(float(np.sum(np.asarray(a[k], np.float64)
                           * np.asarray(b[k], np.float64))) for k in a)
    na = sum(float(np.sum(np.asarray(a[k], np.float64) ** 2)) for k in a)
    nb = sum(float(np.sum(np.asarray(b[k], np.float64) ** 2)) for k in b)
    return dot / math.sqrt(na * nb)


def test_bf16_gradient_lies_as_close_to_fp32_as_the_references():
    """The reduced config in both packages, the same params (the port's
    init, carried to JAX as numpy) and batch: each package's bf16
    gradient against the same fp32 gradient (the port's, which agrees
    with the reference's within 3e-4 of a leaf's largest value,
    ``test_torch_xlstm.py``). The port's cosine must lie within
    BF16_COS_GAP of the reference's. Readings (the builder's CPU): port
    0.9549, reference 0.9295."""
    cfg = get_config(ARCH).reduced()
    jcfg = jax_get_config(ARCH).reduced().replace(compute_dtype="bfloat16")
    params = tf.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    jp = numpy_tree(params)
    toks = np.random.default_rng(5).integers(0, 512, (B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks)}
    _, g32 = value_and_grad(tf.lm_loss, params, cfg, batch)
    _, g16 = value_and_grad(tf.lm_loss, params,
                            cfg.replace(compute_dtype="bfloat16"), batch)
    args = (jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(toks)})
    low = jax.jit(jax.grad(jtf.lm_loss), static_argnums=1).lower(
        args[0], jcfg, args[1])
    jg16 = low.compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)
    ref32 = {k: v.numpy() for k, v in flat(g32).items()}
    port = _cos({k: v.float().numpy() for k, v in flat(g16).items()}, ref32)
    ref = _cos(flat(jax.tree.map(lambda a: np.asarray(a, np.float32), jg16)),
               ref32)
    print(f"cos(g16, g32): port {port:.4f}, reference {ref:.4f}")
    assert math.isfinite(port) and math.isfinite(ref)
    assert port >= ref - BF16_COS_GAP, (port, ref)
