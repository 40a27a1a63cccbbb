"""Helpers shared by the tests that hold the port's models against the JAX
package on the same numpy inputs (``test_torch_mla_mtp.py``,
``test_torch_attn_variants.py``, ``test_torch_encdec.py``): the port on
one thread, trees as numpy, flat leaf paths, the relative closeness
check and the reference compiled cheaply.
"""

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one intra-op thread: its steps are many small
    ops, and test workers each spinning a thread a core over them run
    many times slower than alone (a lane step or a training round here
    took 100x its time alone in a full parallel run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_tree(tree):
    """A copy as numpy (JAX may alias a numpy buffer, and the port
    updates its params in place)."""
    return {k: numpy_tree(v) if isinstance(v, dict)
            else v.detach().numpy().copy() for k, v in tree.items()}


def flat(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = v
    return out


def shapes(tree):
    return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def close(got, want, *, rel, what=""):
    """got (a tensor) finite, of want's shape, and within rel of the
    largest |want| (at least 1) everywhere."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.all(np.isfinite(got)), what
    err = np.max(np.abs(got - want))
    assert err <= rel * max(1.0, np.max(np.abs(want))), (what, err)


def fast_jit(fn, cfg, *args):
    """fn(args[0], cfg, *args[1:]) jitted with XLA's LLVM backend at
    optimization level 0 (the same operations, compiled in about half
    the time)."""
    low = jax.jit(fn, static_argnums=1).lower(args[0], cfg, *args[1:])
    return low.compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(args[0], *args[1:])
