"""Logical-axis sharding rules: param-tree path -> partition spec, the
port of ``repro.sharding.rules``.

Conventions (mesh axes: optional 'client', optional 'pod', 'data', 'model'):
  - Column-parallel weights (d_model -> parallel): last dim on 'model'.
  - Row-parallel weights (parallel -> d_model): first matmul dim on 'model'.
  - MoE expert stacks: expert dim on 'model' (expert parallelism).
  - Embedding/vocab: vocab dim on 'model'.
  - FSDP (ZeRO-3-style, per arch when params/chip would not fit): the
    *other* matmul dim additionally on 'data'.
  - Stacked leading dims (layer groups, IFL client stacking) are prepended:
    groups -> None, clients -> 'client'.
  - 1-D leaves (norm scales, biases) are replicated.

A spec is a plain tuple with one entry per dim: None (not sharded), a
mesh-axis name, or a tuple of names (the dim split over several axes,
the first the major one); it is the entry tuple of the reference's
``PartitionSpec``, which writes a one-name tuple as the name. The rules
match on leaf *path names* ('/'-joined dict keys, the reference's own
names: ``groups/l0/attn/wq/w``), not positions.

``tree_shardings`` turns a spec into ``torch.distributed.tensor``
placements, one per mesh dim (``Shard(d)`` / ``Replicate()``), and
``local_block`` / ``gather_block`` cut a leaf to a rank's block and put
the blocks back together over the mesh's process groups. No DTensor runs
through the model: the round step cuts its inputs with these and its
kernels take local tensors.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]

# name-pattern -> spec template over the trailing (matmul) dims.
# 'M' = model axis, 'F' = fsdp axis (data, only when fsdp enabled), '-' = None.
_RULES = [
    # embeddings / heads
    (r"embed/table$", ("M", "F")),
    (r"lm_head/w$", ("F", "M")),
    # attention (GQA + cross + qwen bias)
    (r"(attn|cross)/w[qkv]/w$", ("F", "M")),
    (r"(attn|cross)/w[qkv]/b$", ("M",)),
    (r"(attn|cross)/wo/w$", ("M", "F")),
    # MLA
    (r"wq_a/w$", ("F", "-")),
    (r"wq_b/w$", ("-", "M")),
    (r"wkv_a/w$", ("F", "-")),
    (r"wkv_b/w$", ("-", "M")),
    # dense MLP
    (r"ffn/w_(gate|up)/w$", ("F", "M")),
    (r"ffn/w_down/w$", ("M", "F")),
    # MoE: expert-parallel stacks + router
    (r"moe/experts/w_(gate|up)/w$", ("M", "F", "-")),
    (r"moe/experts/w_down/w$", ("M", "-", "F")),
    (r"moe/router/w$", ("F", "-")),
    (r"moe/shared/w_(gate|up)/w$", ("F", "M")),
    (r"moe/shared/w_down/w$", ("M", "F")),
    # mamba
    (r"mamba/in_proj/w$", ("F", "M")),
    (r"mamba/conv_[wb]$", ("-", "M")),
    (r"mamba/x_proj/w$", ("M", "-")),
    (r"mamba/dt_proj/w$", ("-", "M")),
    (r"mamba/dt_proj/b$", ("M",)),
    (r"mamba/a_log$", ("M", "-")),
    (r"mamba/d_skip$", ("M",)),
    (r"mamba/out_proj/w$", ("M", "F")),
    # mlstm
    (r"mlstm/up/w$", ("F", "M")),
    (r"mlstm/conv_[wb]$", ("-", "M")),
    (r"mlstm/w[qkv]/w$", ("M", "-")),
    (r"mlstm/w_if/w$", ("M", "-")),
    (r"mlstm/skip$", ("M",)),
    (r"mlstm/down/w$", ("M", "F")),
    # slstm: small scalar-memory block, replicate
    (r"slstm/", ()),
    # fusion interface: keep z model-sharded on d_fusion
    (r"fusion_in/w$", ("F", "M")),
    (r"fusion_out/w$", ("M", "F")),
    (r"img_proj/w$", ("F", "M")),
]


def _entry(axes):
    """A spec entry as the reference's ``PartitionSpec`` keeps it: a
    one-name tuple is the name."""
    if isinstance(axes, (tuple, list)):
        axes = tuple(axes)
        return axes[0] if len(axes) == 1 else axes
    return axes


def _leaf_spec(path: str, ndim: int, fsdp: bool):
    # §Perf probe lever: vocab-sharded embedding tables force a gather
    # that replicates (B, S, d) per device; REPRO_EMBED_SHARD=dmodel
    # shards the table on d_model instead so the lookup stays local.
    if re.search(r"embed/table$", path) and \
            os.environ.get("REPRO_EMBED_SHARD") == "dmodel":
        return [None] * (ndim - 2) + [None, "model"]
    for pat, tmpl in _RULES:
        if re.search(pat, path):
            axes = []
            for t in tmpl:
                if t == "M":
                    axes.append("model")
                elif t == "F":
                    axes.append("data" if fsdp else None)
                else:
                    axes.append(None)
            # left-pad with Nones for stacked leading dims (layer groups).
            pad = ndim - len(axes)
            if pad < 0:  # conv_b matched a 2-dim template with 1-dim leaf
                axes = axes[-ndim:] if ndim else []
                pad = ndim - len(axes)
            return [None] * pad + axes
    return [None] * ndim  # default: replicate (norms, small misc)


def _path_str(path: Sequence[Any]) -> str:
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _ndim(leaf) -> int:
    return leaf.dim() if hasattr(leaf, "dim") else len(leaf.shape)


def param_pspecs(params, *, fsdp: bool = False, client_axis: bool = False):
    """Spec tree matching ``params`` (one tree; leaves need only
    ``shape``). client_axis: every leaf carries a leading stacked client
    dim that goes on the 'client' mesh axis (the reference's stacked-client
    layout; the port's round keeps a list of per-client trees and cuts
    that list by the same rule)."""

    def spec_for(path, leaf):
        p = _path_str(path)
        ndim = _ndim(leaf)
        if client_axis:
            return ("client", *_leaf_spec(p, ndim - 1, fsdp))
        return tuple(_leaf_spec(p, ndim, fsdp))

    return _map_with_path(spec_for, params)


def batch_pspec(batch, *, client_axis: bool = False, data_axes=("data",)):
    """Shard every batch leaf's batch dim. With client_axis the leading
    dim is the clients' -> 'client', the per-client batch dim -> the data
    axes; (N, tau, B, ...) leaves keep tau and trailing dims unsharded."""
    data = _entry(data_axes)

    def spec_for(path, leaf):
        ndim = _ndim(leaf)
        if client_axis:
            if ndim == 2:
                return ("client", data)
            if ndim == 3:
                return ("client", data, None)
            if ndim >= 4:  # (N, tau, B, ...trailing feature dims)
                return ("client", None, data, *([None] * (ndim - 3)))
            return ("client", *([None] * (ndim - 1)))
        if ndim == 0:
            return ()
        return (data, *([None] * (ndim - 1)))

    return _map_with_path(spec_for, batch)


# Decode-cache rules: (regex, semantic_rank, tail spec). Leading dims
# beyond the semantic rank are layer-group stacks -> None. Cache key names
# are mixer-prefixed (ssm_/mlstm_/slstm_) so rules are unambiguous.
def _cache_rules(seq_shard: bool):
    b_ax = "data"
    s_ax = "data" if seq_shard else None
    if seq_shard:
        b_ax = None  # batch ~1: context-parallel over the cache seq dim
    return [
        (r"/slot_pos$", 1, (None,)),
        (r"/(k|v)$", 4, (b_ax, s_ax, "model", None)),  # (B, S, KVH, hd)
        (r"/(ckv|krope)$", 3, (b_ax, s_ax, None)),  # MLA latent stream
        (r"/ssm_h$", 3, (b_ax, "model", None)),  # (B, d_inner, d_state)
        (r"/ssm_conv$", 3, (b_ax, None, "model")),  # (B, K-1, d_inner)
        (r"/mlstm_C$", 4, (b_ax, None, None, "model")),  # (B, nh, dk, dv)
        (r"/mlstm_n$", 3, (b_ax, None, "model")),
        (r"/mlstm_m$", 2, (b_ax, None)),
        (r"/mlstm_conv$", 3, (b_ax, None, "model")),
        (r"/slstm_[cnmh]$", 2, (b_ax, "model")),  # (B, d)
    ]


def cache_pspecs(cache, *, seq_shard: bool = False):
    """Decode-cache specs: batch on 'data'; KV heads / state channels on
    'model'; optionally the cache sequence dim on 'data' (context-parallel
    decode for batch ~1 long contexts). Axes that do not divide a dim are
    dropped by ``sanitize_pspec``."""
    rules = _cache_rules(seq_shard)

    def spec_for(path, leaf):
        name = _path_str(path)
        ndim = _ndim(leaf)
        for pat, rank, tail in rules:
            if re.search(pat, name):
                return (*([None] * (ndim - rank)), *tail)
        return (None,) * ndim

    return _map_with_path(spec_for, cache)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of such a dict)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def sanitize_pspec(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes that do not divide the corresponding dim (e.g.
    batch 1 long-context decode, 4-head smoke models on a 16-way axis).
    ``mesh``: a ``DeviceMesh`` or an {axis: size} dict."""
    sizes = axis_sizes(mesh)
    out = []
    for i, ax in enumerate(spec):
        if ax is None or i >= len(shape):
            out.append(None if i >= len(shape) else ax)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n = 1
        for a in axes:
            n *= sizes[a]
        out.append(ax if shape[i] % n == 0 else None)
    return (*out[: len(shape)], *([None] * max(0, len(shape) - len(out))))


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def placements_of(mesh, spec: Spec) -> Tuple[Any, ...]:
    """One placement per mesh dim: ``Shard(d)`` where tensor dim d names
    that axis, else ``Replicate()``. A dim split over several axes is
    sharded on each, the first-named the major one."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in mesh.mesh_dim_names)


def tree_shardings(mesh, specs, shapes=None):
    """Placements for a spec tree; with ``shapes`` (a matching tree of
    tensors, or anything with ``shape``) every spec is sanitized first."""
    if shapes is None:
        return _map_spec(lambda s: placements_of(mesh, s), specs)
    return _map_spec(
        lambda s, leaf: placements_of(mesh, sanitize_pspec(s, leaf.shape,
                                                           mesh)),
        specs, shapes)


def _map_spec(fn, specs, *rest):
    if _is_spec(specs):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: _map_spec(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    return type(specs)(_map_spec(fn, v, *(r[i] for r in rest))
                       for i, v in enumerate(specs))


def _shard_order(mesh, placements):
    """(mesh dim, tensor dim) of every ``Shard``, the major axis first
    along each tensor dim (mesh-dim order, as DTensor splits)."""
    from torch.distributed.tensor import Shard

    return [(i, p.dim) for i, p in enumerate(placements)
            if isinstance(p, Shard)]


def local_block(t: torch.Tensor, mesh, placements,
                coordinate: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The block of ``t`` (the whole leaf) that the rank at
    ``coordinate`` (default: this rank's) holds: contiguous, equal
    blocks along each sharded dim. A view; raises where a mesh axis does
    not divide its dim."""
    coord = (mesh.get_coordinate() if coordinate is None
             else list(coordinate))
    shape = mesh.mesh.shape
    for i, d in _shard_order(mesh, placements):
        n = int(shape[i])
        if t.shape[d] % n:
            raise ValueError(
                f"dim {d} of size {t.shape[d]} does not split over mesh "
                f"axis {mesh.mesh_dim_names[i]!r} of size {n}")
        step = t.shape[d] // n
        t = t.narrow(d, coord[i] * step, step)
    return t


def gather_block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """Inverse of ``local_block`` on every rank at once: the whole leaf
    from each rank's block, gathered over each sharded mesh axis's
    process group (minor axis first) and joined in coordinate order.
    A collective: every rank of the mesh calls it."""
    for i, d in reversed(_shard_order(mesh, placements)):
        t = all_gather_cat(t, mesh.get_group(mesh.mesh_dim_names[i]), d)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``t`` of every rank of ``group`` joined along ``dim`` in group-rank
    order: the list form of ``all_gather``, which NCCL and gloo both take
    for CUDA tensors. NCCL has no bool: a bool leaf crosses as uint8."""
    import torch.distributed as dist

    src = t.contiguous()
    if src.dtype == torch.bool:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.view(torch.bool) if t.dtype == torch.bool else out
