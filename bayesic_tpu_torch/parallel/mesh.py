"""Device meshes and the collectives over their axes: the only layer that
names mesh axes.

Counterpart of ``bayesic_tpu/parallel/mesh.py``.  JAX expresses a sharded
run as ``NamedSharding`` annotations on one controller and XLA places the
collectives.  Here a run is SPMD: one process a rank (``launcher``), each
holding its share of the sharded arrays, and the modules above place each
collective by hand through the helpers below.  A ``Sharding`` is a mesh
and the axis that splits an array's leading dimension (None: replicated);
JAX's ``PartitionSpec`` has no counterpart.  Axis names follow the JAX
package:

  data      mini-batch shards for DP-SVI
  chain     MCMC chains
  particle  SMC particles
  model     sharded latent blocks / obs dimension

The collectives below are forward-only, but for three that autograd can
differentiate, which a ``"model"``-axis split (``tp``) places around its
sharded work.  On every rank the loss is the same replicated value, and
its gradient must count that loss once:

  enter     identity forward; the gradient all-reduced (summed) backward.
            A replicated tensor that feeds sharded work gets, on each rank,
            the gradient of only that rank's share of the work.
  gather    the ranks' tensors concatenated along a dimension forward;
            backward, this rank's slice of the (replicated) gradient.
  reduce    the sum over the ranks forward; the gradient unchanged
            backward (each rank's share of a replicated sum).

``torch.distributed.nn``'s all_gather reduce-scatters its gradient and its
all_reduce all-reduces it: under a replicated loss both give gradients P
times too large, so these three are written here.

Under NCCL every collective runs on the card.  Under gloo (the CPU tests,
and two ranks that share one card) the tensors stay where they are too:
gloo takes all_reduce, broadcast and all_gather on CUDA tensors (it
stages them through the host itself; read on torch 2.11 by
``chip_smoke.py`` phase 27).  Point-to-point sends are another matter:
gloo's send and receive of a CUDA tensor fail on torch 2.11 ("writev ...
Bad address"), so ``ppermute`` copies a CUDA tensor to the host and back
itself under gloo; under NCCL it stays on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..infer.svi.svi import _tree_unflatten, tree_leaves, tree_map

__all__ = ["AXES", "Sharding", "make_mesh", "shard_leading", "replicate",
           "put_sharded", "put_replicated", "local_slice", "local_chains",
           "axis_size",
           "axis_index", "psum", "pmean", "pmax", "all_gather",
           "ppermute", "group_device", "enter", "gather", "reduce"]

AXES = ("data", "chain", "particle", "model")

class Sharding(NamedTuple):
    """``mesh``'s ``axis`` splits the leading dimension (None: every rank
    holds the whole array)."""

    mesh: object
    axis: Optional[str]


def make_mesh(axis_sizes: Optional[dict] = None):
    """A ``torch.distributed`` ``DeviceMesh`` over the process group's ranks
    with named dimensions.  ``axis_sizes`` maps axis name -> size; one axis
    may be -1 (it takes the remaining ranks).  Default: every rank on
    ``"data"``.  Every rank calls it (it makes the axes' groups).  Its
    device type is the backend's: cuda for NCCL, else cpu."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.launcher.initialize() first")
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if not axis_sizes:
        axis_sizes = {"data": n}
    names = tuple(axis_sizes)
    sizes = [int(axis_sizes[a]) for a in names]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=names)


def shard_leading(mesh, axis: str) -> Sharding:
    """The sharding that splits the leading dimension over ``axis``."""
    return Sharding(mesh, axis)


def replicate(mesh) -> Sharding:
    return Sharding(mesh, None)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def local_slice(global_size: int, axis_size: int, axis_index: int):
    """(start, size) of this shard's slice of a dimension."""
    if global_size % axis_size:
        raise ValueError(f"size {global_size} not divisible by mesh axis "
                         f"{axis_size}")
    per = global_size // axis_size
    return axis_index * per, per


def local_chains(num_chains: int, sharding, device):
    """The global indices of the chains this rank runs, on ``device``:
    all ``num_chains`` without ``sharding``, else this rank's contiguous
    share along the axis of ``sharding`` (a ``Sharding`` or ``(mesh,
    axis)``).  Every chain-sharded sampler keys its draws by these
    indices, so a chain's draws do not depend on the rank that runs it."""
    start, n = 0, int(num_chains)
    if sharding is not None:
        mesh, axis = sharding
        start, n = local_slice(n, axis_size(mesh, axis),
                               axis_index(mesh, axis))
    return torch.arange(start, start + n, device=device)


def put_sharded(tree, mesh, axis: str):
    """This rank's slice of every leaf's leading dimension (each leaf a
    global array that every rank holds)."""
    size, index = axis_size(mesh, axis), axis_index(mesh, axis)

    def one(x):
        start, per = local_slice(x.shape[0], size, index)
        return x[start:start + per]

    return tree_map(one, tree)


def put_replicated(tree, mesh):
    """Every rank's tensors set to those of rank 0 (one broadcast a leaf),
    so that every rank of ``mesh`` starts from the same replicated
    values."""
    def one(x):
        out = x.clone()
        dist.broadcast(out, 0)
        return out

    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# collectives over one axis
# ---------------------------------------------------------------------------

def group_device(group=None):
    """Where a tensor for ``group``'s collectives lives: this rank's card
    under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_reduce(t, group, op):
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(t, group):
    """The ranks' ``t`` in group rank order, as a list."""
    t = t.contiguous()
    got = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(got, t, group=group)
    return got


def _reduce_tree(tree, mesh, axis, op):
    """All-reduce every tensor leaf of ``tree`` over ``axis``: the leaves of
    one dtype and device go flat into one buffer and one collective."""
    group = mesh.get_group(axis)
    leaves = tree_leaves(tree)
    out = {}
    buckets = {}
    for i, x in enumerate(leaves):
        buckets.setdefault((x.dtype, x.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        flat = _all_reduce(flat, group, op)
        for i, part in zip(idx, torch.split(
                flat, [leaves[i].numel() for i in idx])):
            out[i] = part.reshape(leaves[i].shape)
    return _tree_unflatten(tree, [out[i] for i in range(len(leaves))])


def psum(tree, mesh, axis: str):
    """The sum over ``axis`` of every tensor leaf (a tensor, or nested dicts
    and tuples of tensors)."""
    return _reduce_tree(tree, mesh, axis, dist.ReduceOp.SUM)


def pmean(tree, mesh, axis: str):
    """The mean over ``axis``: the sum, divided by the axis size."""
    n = axis_size(mesh, axis)
    return tree_map(lambda x: x / n, psum(tree, mesh, axis))


def pmax(tree, mesh, axis: str):
    return _reduce_tree(tree, mesh, axis, dist.ReduceOp.MAX)


def all_gather(t, mesh, axis: str, dim=0):
    """The ranks' tensors ``t`` concatenated along ``dim`` in the order of
    their coordinates on ``axis``."""
    return torch.cat(_all_gather(t, mesh.get_group(axis)), dim)


def ppermute(tree, mesh, axis: str, shift: int = -1):
    """Every tensor leaf of ``tree`` moved ``shift`` places around the ring
    of ``axis``: the rank at coordinate i sends to (i + shift) mod P and
    receives from (i - shift) mod P.  The default, -1, is JAX's ring
    ``perm=[(i, (i - 1) % p)]``.  Every rank's sends and receives of every
    leaf are posted together (``batch_isend_irecv``), so no order of the
    ranks can deadlock.  Under gloo a CUDA leaf goes through the host (gloo
    sends host tensors only); under NCCL it stays on the card.  With one
    rank on the axis it returns copies."""
    group = mesh.get_group(axis)
    p, me = axis_size(mesh, axis), axis_index(mesh, axis)
    leaves = tree_leaves(tree)
    if p == 1:
        return _tree_unflatten(tree, [x.clone() for x in leaves])
    host = dist.get_backend(group) != "nccl"
    send = [(x.cpu() if host else x).contiguous() for x in leaves]
    recv = [torch.empty_like(x) for x in send]
    to = dist.get_global_rank(group, (me + shift) % p)
    frm = dist.get_global_rank(group, (me - shift) % p)
    ops = [dist.P2POp(dist.isend, x, to, group) for x in send] \
        + [dist.P2POp(dist.irecv, x, frm, group) for x in recv]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _tree_unflatten(tree, [r.to(x.device) for r, x in zip(recv,
                                                                 leaves)])


# ---------------------------------------------------------------------------
# differentiable collectives over one axis (the "model" axis's three)
# ---------------------------------------------------------------------------

class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group, dist.ReduceOp.SUM), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        ctx.start = dist.get_rank(group) * ctx.size
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.size), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def enter(x, mesh, axis: str):
    """``x`` unchanged; backward, its gradient summed over ``axis``.  Put it
    where a replicated tensor enters work that ``axis`` shards."""
    return _Enter.apply(x, mesh.get_group(axis))


def gather(x, mesh, axis: str, dim=0):
    """The ranks' ``x`` concatenated along ``dim`` in the order of their
    coordinates on ``axis`` (the shards of a replicated result); backward,
    this rank's slice of the gradient.  Every rank's ``x`` has one shape."""
    dim = dim % x.dim()
    return _Gather.apply(x, mesh.get_group(axis), dim)


def reduce(x, mesh, axis: str):
    """The sum of the ranks' ``x`` over ``axis`` (a replicated total of
    sharded parts); backward, the gradient unchanged."""
    return _Reduce.apply(x, mesh.get_group(axis))
