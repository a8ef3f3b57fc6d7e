"""Process bring-up and cross-rank consistency guards.

Counterpart of ``bayesic_tpu/parallel/launcher.py``.  A sharded run is one
SPMD program in several processes, one rank per card: ``torchrun
--nproc-per-node N script.py`` starts them, and the script calls
``initialize()``, which joins the ranks into one ``torch.distributed``
process group.  Each rank's tensors then live on ``cuda:{local_rank}``
and NCCL carries the collectives; on the CPU (the tests) the backend is
gloo.  Only rank 0 writes logs and checkpoints (``is_primary``), each rank
loads its own shard of the rows (``host_shard``), and a hash of the
replicated state compared across ranks (``check_replicated_sync``) catches
a rank whose copy drifted.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import _all_gather, group_device

__all__ = ["initialize", "is_primary", "host_shard", "replicated_fingerprint",
           "check_replicated_sync", "DesyncError"]

_MASK32 = 0xFFFFFFFF
_GOLDEN = 2654435761      # the fingerprint's position multiplier


def initialize(init_method=None, world_size=None, rank=None, local_rank=None,
               device="cuda", backend=None, timeout=None):
    """Join this process to the run's process group.

    The arguments default from the variables ``torchrun`` sets (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR`` and ``MASTER_PORT``
    through the ``env://`` init method).  With one process it does nothing
    and returns False.  On ``device="cuda"`` it selects ``cuda:{local_rank}``
    and uses NCCL; on ``device="cpu"`` gloo.  ``backend`` overrides that
    choice (gloo lets two ranks share one card, which NCCL refuses).
    ``timeout`` (seconds) bounds every collective, so a rank that fails
    while the others wait ends the run instead of hanging it.  Returns
    True once the group is up."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
    elif device.type != "cpu":
        raise ValueError(f"initialize: unsupported device {device}")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    return True


def _world():
    """(size, rank) of the process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def is_primary():
    """True on rank 0 (and in a run of one process)."""
    return _world()[1] == 0


def host_shard(array, axis_size=None, axis_index=None):
    """This rank's contiguous slice of a global array's leading axis (each
    process loads only its shard of the rows); the sizes default to the
    process group's."""
    size, index = _world()
    axis_size = size if axis_size is None else int(axis_size)
    axis_index = index if axis_index is None else int(axis_index)
    n = array.shape[0]
    if n % axis_size:
        raise ValueError(f"{n} rows not divisible by {axis_size} processes")
    per = n // axis_size
    return array[axis_index * per:(axis_index + 1) * per]


class DesyncError(RuntimeError):
    pass


def _leaves(tree):
    """Tensor leaves in the JAX package's tree order: dict keys sorted,
    sequences (tuples, lists, NamedTuples) in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _mul32(a, b):
    """(a * b) mod 2^32 of int64 tensors holding values below 2^32, without
    overflowing int64: a's high and low 16-bit halves apart."""
    hi = ((a >> 16) * b) & 0xFFFF
    return ((a & 0xFFFF) * b + (hi << 16)) & _MASK32


def _term(leaf):
    """One leaf's share of the fingerprint, on the leaf's device (a
    generator counts as its state's bytes)."""
    if isinstance(leaf, torch.Generator):
        leaf = leaf.get_state()
    leaf = torch.as_tensor(leaf)
    if leaf.dtype.is_floating_point or leaf.dtype == torch.bool:
        bits = leaf.to(torch.float32).reshape(-1).view(torch.int32)
    else:
        # integers (seeds, counters) keep all their bits: through float32
        # nearby values would collapse and hide a desync
        bits = leaf.reshape(-1)
    bits = bits.to(torch.int64) & _MASK32
    idx = torch.arange(bits.numel(), dtype=torch.int64, device=bits.device)
    mix = (_mul32(idx, torch.tensor(_GOLDEN, device=bits.device)) + 1) \
        & _MASK32
    return int(torch.sum(_mul32(bits, mix)) & _MASK32)


def replicated_fingerprint(tree):
    """A uint32 hash of a tree's bits, as a Python int: the JAX package's
    ``replicated_fingerprint`` bit for bit (floats as their float32 bits,
    integers modulo 2^32, each leaf's words weighted by their position,
    all summed modulo 2^32).  Equal on two ranks iff (up to collisions)
    their copies of the tree are."""
    return sum(_term(leaf) for leaf in _leaves(tree)) & _MASK32


def check_replicated_sync(tree, group=None):
    """Raise ``DesyncError`` unless every rank of ``group`` (the world by
    default) holds the same bits of ``tree``: one all_gather of the
    fingerprints.  Returns True; a run of one process passes at once."""
    if _world()[0] == 1:
        return True
    fp = torch.tensor([replicated_fingerprint(tree)], dtype=torch.int64,
                      device=group_device(group))
    fps = [int(v) for v in _all_gather(fp, group)]
    if len(set(fps)) != 1:
        raise DesyncError(f"replicated state fingerprints diverged across "
                          f"ranks: {fps}")
    return True
