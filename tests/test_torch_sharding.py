"""The port's sharding rules and meshes against the JAX package's, exactly.

``repro_torch.sharding.rules`` against ``repro.sharding.rules``: every
config of the registry at its published widths, params from
``jax.eval_shape`` of the reference's ``init_lm`` and the port's meta
init (``configs/shapes.py``), under fsdp False/True x client_axis
False/True and ``REPRO_EMBED_SHARD=dmodel``; ``batch_pspec``,
``cache_pspecs`` on a decode cache and ``sanitize_pspec`` on the
reference tests' device-duplicating mesh. A port spec is the reference
``PartitionSpec``'s entry tuple.

``repro_torch.launch.mesh`` against ``repro.launch.mesh``: the rank grid
of ``derive_ifl_mesh`` is the reference's reshape of the same grid, and
the production meshes get the reference's shapes and names on worlds of
256 and 512 ranks of torch's fake process group (no rank is spawned).
Nothing here compiles.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jmesh
from repro.models.transformer import init_decode_cache as jax_init_cache
from repro.models.transformer import init_lm as jax_init_lm
from repro.sharding import rules as jrules
from repro_torch.configs import get_config
from repro_torch.configs.shapes import param_specs
from repro_torch.launch import mesh as tmesh
from repro_torch.models.transformer import init_decode_cache
from repro_torch.sharding import rules as trules

N_STACK = 4


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        key = f"{pre}/{k}" if pre else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _jax_flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jrules._path_str(p): v for p, v in leaves}


def _meta(shape):
    return torch.empty(tuple(shape), device="meta")


def _stacked(tree):
    """Every leaf with a leading client dim of N_STACK."""
    return {k: (_stacked(v) if isinstance(v, dict)
                else _meta((N_STACK, *v.shape))) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_params():
    """arch -> the reference's init_lm shapes (eval_shape: nothing runs)."""
    out = {}
    for arch in ARCH_IDS:
        cfg = jax_get_config(arch)
        out[arch] = jax.eval_shape(lambda k, c=cfg: jax_init_lm(k, c),
                                   jax.random.PRNGKey(0))
    return out


@pytest.mark.parametrize("embed", ["vocab", "dmodel"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(jax_params, arch, embed, monkeypatch):
    """Leaf by leaf, every flag combination: fsdp x client_axis (the
    client axis over a stacked leading dim), under both embedding
    levers."""
    if embed == "dmodel":
        monkeypatch.setenv("REPRO_EMBED_SHARD", "dmodel")
    else:
        monkeypatch.delenv("REPRO_EMBED_SHARD", raising=False)
    jp = jax_params[arch]
    tp = param_specs(get_config(arch))
    jstack = jax.tree.map(
        lambda l: jax.ShapeDtypeStruct((N_STACK, *l.shape), l.dtype), jp)
    tstack = _stacked(tp)
    for fsdp, client in itertools.product([False, True], repeat=2):
        want = _jax_flat(jrules.param_pspecs(jstack if client else jp,
                                             fsdp=fsdp, client_axis=client))
        got = _flat(trules.param_pspecs(tstack if client else tp,
                                        fsdp=fsdp, client_axis=client))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == tuple(want[k]), (arch, fsdp, client, k)
    if embed == "dmodel":
        spec = _flat(trules.param_pspecs(tp))
        assert spec[next(k for k in spec if k.endswith("embed/table"))] \
            == (None, "model")


_BATCH_SHAPES = [(8, 64), (8, 64, 16), (4, 3, 2, 64), (4, 3, 2, 7, 16),
                 (4,), ()]


@pytest.mark.parametrize("data_axes", [("data",), ("pod", "data")])
@pytest.mark.parametrize("client", [False, True])
def test_batch_pspec_matches_reference(client, data_axes):
    shapes = {f"x{i}": s for i, s in enumerate(_BATCH_SHAPES)
              if not (client and len(s) == 0)}
    want = jrules.batch_pspec(
        {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()},
        client_axis=client, data_axes=data_axes)
    got = trules.batch_pspec({k: _meta(s) for k, s in shapes.items()},
                             client_axis=client, data_axes=data_axes)
    assert {k: tuple(v) for k, v in want.items()} == got


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_reference(arch, seq_shard):
    """On the reference's decode cache shapes, exactly; on the port's own
    cache, the same spec for every leaf of the same shape (the port keeps
    a per-row ``slot_pos``, replicated under both packages' rules)."""
    jcache = jax.eval_shape(lambda: jax_init_cache(jax_get_config(arch), 2,
                                                   64))
    want = _jax_flat(jrules.cache_pspecs(jcache, seq_shard=seq_shard))
    shapes = {k: l.shape for k, l in _jax_flat(jcache).items()}
    same = _flat(trules.cache_pspecs(
        {k: _meta(s) for k, s in shapes.items()}, seq_shard=seq_shard))
    assert same == {k: tuple(v) for k, v in want.items()}
    own_cache = _flat(init_decode_cache(get_config(arch), 2, 64,
                                        device="meta"))
    own = _flat(trules.cache_pspecs(init_decode_cache(
        get_config(arch), 2, 64, device="meta"), seq_shard=seq_shard))
    assert own.keys() == want.keys()
    for k, spec in own.items():
        if tuple(own_cache[k].shape) == shapes[k]:
            assert spec == tuple(want[k]), k
        else:
            assert k.endswith("slot_pos") and set(spec) == {None} \
                and set(want[k]) == {None}, k


def _jax_fake_mesh(shape, axes):
    """The reference tests' mesh of one CPU device repeated
    (tests/test_substrate.py:128)."""
    devs = np.array(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


_SANITIZE = [
    (("data", "model"), (6, 8)),
    ((("data", "model"), None), (8, 3)),
    ((("data", "model"), None), (6, 3)),
    (("data", None, "model"), (4, 5, 2)),
    ((None, "model"), (3,)),
    (("model",), (4, 6, 8)),
    ((), (2, 2)),
    (("data", "model", None, None), (12, 10)),
]


@pytest.mark.parametrize("spec,shape", _SANITIZE)
def test_sanitize_pspec_matches_reference(spec, shape):
    jm = _jax_fake_mesh((4, 2), ("data", "model"))
    want = jrules.sanitize_pspec(P(*spec), shape, jm)
    assert trules.sanitize_pspec(spec, shape, {"data": 4, "model": 2}) \
        == tuple(want)


@pytest.fixture
def fake_world():
    """A fake process group of a given world size (rank 0): meshes of 256
    or 512 ranks without spawning any."""
    started = []

    def start(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        started.append(world)

    yield start
    if started:
        dist.destroy_process_group()


class _Captured:
    def __init__(self, devices, axes):
        self.devices, self.axis_names = np.asarray(devices), tuple(axes)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_match_reference(fake_world, monkeypatch,
                                           multi_pod):
    """The reference's make_production_mesh (jax.make_mesh captured: this
    box has one device) and the port's on a fake world of that size:
    shapes and names equal; the port's grid is the world's ranks in
    order; derive_ifl_mesh's grid is the reference's reshape of the same
    rank grid for every client count that tiles it."""
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes: _Captured(
                            np.arange(int(np.prod(shape))).reshape(shape),
                            axes))
    monkeypatch.setattr(jmesh, "Mesh", _Captured)
    ref = jmesh.make_production_mesh(multi_pod=multi_pod)
    world = ref.devices.size
    fake_world(world)
    m = tmesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert tuple(m.mesh.shape) == ref.devices.shape
    assert m.mesh_dim_names == ref.axis_names
    assert np.array_equal(m.mesh.numpy(), ref.devices)
    assert tmesh.data_axes_of(m) == jmesh.data_axes_of(ref)
    for n in (1, 2, 4, 8, 16) + ((32,) if multi_pod else ()):
        derived = jmesh.derive_ifl_mesh(ref, n)
        assert np.array_equal(tmesh.derived_ifl_grid(m.mesh, n).numpy(),
                              derived.devices)
    dm = tmesh.derive_ifl_mesh(m, 4)
    assert dm.mesh_dim_names == ("client", "data", "model")
    assert np.array_equal(dm.mesh.numpy(),
                          jmesh.derive_ifl_mesh(ref, 4).devices)
    assert tmesh.data_axes_of(dm) == ("data",)
    for n in (3, 5):   # clients that do not tile the data rows
        with pytest.raises(AssertionError):
            jmesh.derive_ifl_mesh(ref, n)
        with pytest.raises(ValueError):
            tmesh.derived_ifl_grid(m.mesh, n)


def test_mesh_world_and_device_refusals(fake_world):
    """No process group, a world of the wrong size, a CUDA mesh without a
    card: each raises."""
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    fake_world(4)
    with pytest.raises(ValueError, match="world of 8"):
        tmesh.make_mesh((2, 4), ("data", "model"), device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh((2, 2), ("data", "model"))


def test_placements_and_blocks(fake_world):
    """tree_shardings gives one placement a mesh dim; local_block cuts the
    blocks that tile the leaf, major axis first, and raises where an axis
    does not divide its dim."""
    fake_world(8)
    m = tmesh.make_mesh((2, 2, 2), ("client", "data", "model"),
                        device_type="cpu")
    specs = {"a": ("client", "data", None), "b": (("client", "data"),),
             "c": (None, "model")}
    shapes = {"a": _meta((4, 6, 3)), "b": _meta((8,)), "c": _meta((2, 3))}
    pl = trules.tree_shardings(m, specs, shapes)
    assert pl["a"] == (Shard(0), Shard(1), Replicate())
    assert pl["b"] == (Shard(0), Shard(0), Replicate())
    # 3 does not split over 'model' (2): the sanitizer drops it.
    assert pl["c"] == (Replicate(), Replicate(), Replicate())
    a = torch.arange(72).reshape(4, 6, 3)
    b = torch.arange(8)
    seen_a, seen_b = torch.zeros_like(a), []
    for c, d in itertools.product(range(2), range(2)):
        blk = trules.local_block(a, m, pl["a"], coordinate=(c, d, 0))
        assert blk.shape == (2, 3, 3)
        seen_a[2 * c:2 * c + 2, 3 * d:3 * d + 3] += blk
        seen_b += trules.local_block(b, m, pl["b"],
                                     coordinate=(c, d, 0)).tolist()
    assert torch.equal(seen_a, a) and seen_b == list(range(8))
    with pytest.raises(ValueError, match="does not split"):
        trules.local_block(torch.zeros(3, 2), m,
                           trules.placements_of(m, ("client", None)),
                           coordinate=(0, 0, 0))
