"""Device meshes over ``torch.distributed`` ranks: the port of
``repro.launch.mesh``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group: a grid of global ranks with named axes, and a
process group along each axis. Building one is a collective (every rank
of the world builds the same mesh, in the same order), needs an
initialised process group whose world holds exactly the grid's ranks,
and makes no device or group of its own: the caller starts the world
(``torch.distributed.init_process_group`` with an address, a world size
and a rank) and ends it.

``ClientLayout`` is what the IFL round reads off a ('client', 'data',
'model') mesh: which block of the N clients this rank holds, which rows
of their minibatches, and the two process groups the round talks over.
The 'model' axis (tensor and expert parallelism) stays at size 1 here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

IFL_AXES = ("client", "data", "model")


def _require_world(n: int) -> None:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialised torch.distributed process group "
            "(init_process_group with its address, world size and rank)")
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {n} ranks needs a world of {n}; this "
                         f"one has {dist.get_world_size()}")


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: Optional[str] = None):
    """The counterpart of ``jax.make_mesh``: the world's ranks, in order,
    as a grid of ``shape`` with axis names ``axes``. ``device_type``
    'cuda' unless the caller asks for 'cpu'; 'cuda' raises without a
    card."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.device import resolve_device

    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {tuple(axes)} differ "
                         "in length")
    dev = resolve_device(device_type)
    _require_world(int(np.prod(shape)))
    return DeviceMesh(dev.type, torch.arange(int(np.prod(shape))).reshape(
        shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks (the reference's TPU pod slices).
    Raises unless the world has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def derive_ifl_mesh(mesh, n_clients: int):
    """Reshape a production mesh into ('client', 'data', 'model').

    Clients tile the (pod ×) data axes contiguously, pod-major, so in the
    multi-pod mesh a client never straddles a pod unless n_clients <
    n_pods; with n_clients a multiple of n_pods, the only inter-pod
    collective left in an IFL round is the fusion all-gather. A
    collective (the new mesh's groups)."""
    from torch.distributed.device_mesh import DeviceMesh

    grid = derived_ifl_grid(mesh.mesh, n_clients)
    return DeviceMesh(mesh.device_type, grid, mesh_dim_names=IFL_AXES)


def derived_ifl_grid(ranks, n_clients: int):
    """The rank grid of ``derive_ifl_mesh``: ``ranks`` (the production
    mesh's grid, model last) as (n_clients, pod*data // n_clients,
    model)."""
    model = ranks.shape[-1]
    flat = ranks.reshape(-1, model)  # (pod*data, model), pod-major
    total_dp = flat.shape[0]
    if total_dp % n_clients:
        raise ValueError(f"{n_clients} clients do not tile the mesh's "
                         f"{total_dp} data-parallel rows "
                         f"{(total_dp, n_clients)}")
    return flat.reshape(n_clients, total_dp // n_clients, model)


def data_axes_of(mesh) -> Tuple[str, ...]:
    """The axes a plain (non-IFL) step shards its batch over."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


@dataclass(frozen=True)
class ClientLayout:
    """This rank's share of an IFL round on a ('client', 'data', 'model')
    mesh: the contiguous block of ``per = N / C`` clients that
    P('client', ...) gives it (C the client axis's size) and rows
    ``[d * b / D, (d + 1) * b / D)`` of each of their minibatches (D the
    data axis's size). The client group holds one rank per client block
    (same data index): the fusion all-gather runs over it. The data
    group holds the D ranks of this rank's client block: gradients are
    all-reduced over it."""

    mesh: object
    n_clients: int
    n_client_blocks: int
    n_data: int
    client_coord: int
    data_coord: int

    @classmethod
    def of(cls, mesh, n_clients: int) -> "ClientLayout":
        """Check ``mesh`` for the IFL round and read this rank's share.
        Raises where the mesh is not ('client', 'data', 'model'), its
        'model' axis is above 1, its client axis does not divide N, its
        process group is gone, or it is a CUDA mesh without a card."""
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError(
                "the mesh's process group is not initialised (or was "
                "destroyed): init_process_group before building the mesh "
                "and the round")
        names = tuple(mesh.mesh_dim_names or ())
        if names != IFL_AXES:
            raise ValueError(f"the IFL round runs on a {IFL_AXES} mesh "
                             f"(derive_ifl_mesh), not {names}")
        c, d, m = (int(s) for s in mesh.mesh.shape)
        if m != 1:
            raise NotImplementedError(
                f"'model' axis of size {m}: tensor and expert parallelism "
                "are not in the port yet (ROADMAP item 1 (i)); use a "
                "'model' axis of 1")
        if n_clients % c:
            raise ValueError(f"the client axis ({c}) does not divide the "
                             f"{n_clients} clients")
        if mesh.device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh without a card")
        coord = mesh.get_coordinate()
        return cls(mesh, int(n_clients), c, d, int(coord[0]), int(coord[1]))

    @property
    def per(self) -> int:
        return self.n_clients // self.n_client_blocks

    @property
    def clients(self) -> List[int]:
        """The global ids of this rank's clients, in order."""
        return list(range(self.client_coord * self.per,
                          (self.client_coord + 1) * self.per))

    @property
    def client_group(self):
        return self.mesh.get_group("client")

    @property
    def data_group(self):
        return self.mesh.get_group("data")

    def device(self) -> torch.device:
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def rows(self, b: int) -> slice:
        """This rank's rows of a minibatch of ``b`` (the data split)."""
        if b % self.n_data:
            raise ValueError(f"a minibatch of {b} rows does not split over "
                             f"the data axis ({self.n_data})")
        step = b // self.n_data
        return slice(self.data_coord * step, (self.data_coord + 1) * step)

    def mean_over_data(self, tensors: List[torch.Tensor]) -> None:
        """In place: each tensor the mean of its copies over the data
        group (the rows' mean gradients -> the full minibatch's mean), in
        one all-reduce a dtype. Nothing to do at D = 1."""
        import torch.distributed as dist

        if self.n_data == 1 or not tensors:
            return
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, group=self.data_group)
            flat /= self.n_data
            off = 0
            for t in group:
                n = t.numel()
                t.copy_(flat[off:off + n].view_as(t))
                off += n
