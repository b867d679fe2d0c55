"""Data-parallel training (counterpart of ``torchmdnet_tpu/parallel/dp.py``;
the reference's DDP over NCCL, ``scripts/train.py:252-258``).

One process a card, each with a whole replica of the weights and its own
padded batch: :func:`launch` starts them with
``torch.multiprocessing.spawn`` and joins them in a process group (NCCL on
the cards, gloo on the CPU), rank ``r`` on card ``r``.  Each step is the
single-device step (``train/step.py::make_train_step``) with the
gradients and the step's scalars (the y and neg_dy losses, the total and
both new loss EMAs) averaged over the group where JAX ``pmean``s them
(``train/step.py:152-154``): after the gradients and before the clipping
and the update, so every replica applies the same update.
``DistributedDataParallel`` would average nothing here: the step takes
its gradients with ``torch.autograd.grad``, which never runs the
gradient-accumulation hooks DDP's reducer listens to.

:func:`shard_batch` gives rank ``r`` the ``r``-th batch of each group of
``world_size`` consecutive loader batches (the JAX trainer stacks such a
group along its device axis); a last group of fewer batches is dropped,
as in JAX, so that the replicas stay in step.  Several hosts
(``num_nodes > 1``) join one group through :func:`env_init_method`
(``MASTER_ADDR``, ``MASTER_PORT``, ``NODE_RANK``), where JAX calls
``jax.distributed.initialize()``.
"""

import functools
import os
import socket

import torch
import torch.distributed as dist

from torchmdnet_tpu_torch.train.step import make_train_step


def world():
    """``(rank, world size)`` of the default process group, ``(0, 1)``
    outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def average_(tensors, group=None) -> None:
    """Replace each tensor by its mean over the group: one all-reduce of
    the tensors packed into a flat buffer."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    start = 0
    for t in tensors:
        t.copy_(flat[start:start + t.numel()].view_as(t))
        start += t.numel()


def make_data_parallel_train_step(potential, *, num_mols, group=None,
                                  **step_kwargs):
    """The train step of ``train/step.py::make_train_step`` with its
    gradients and scalars averaged over ``group`` (the default process
    group when None); each rank calls it on its own batch."""
    return make_train_step(potential, num_mols=num_mols,
                           average=functools.partial(average_, group=group),
                           **step_kwargs)


def shard_batch(batches, rank: int, world_size: int, on_remainder=None):
    """Rank ``rank``'s batches of ``batches``: the ``rank``-th of each
    group of ``world_size`` consecutive ones.  A last group of fewer
    batches is dropped, and ``on_remainder(count)`` called with its size."""
    group = []
    for batch in batches:
        group.append(batch)
        if len(group) == world_size:
            yield group[rank]
            group = []
    if group and on_remainder is not None:
        on_remainder(len(group))


def free_port() -> int:
    """A free TCP port of this host for a local process group."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def env_init_method() -> str:
    """The rendezvous of a several-host group: ``tcp://MASTER_ADDR:
    MASTER_PORT`` from the environment."""
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"num_nodes > 1 needs {', '.join(missing)} in "
                           "the environment (with NODE_RANK)")
    return f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"


def _worker(local_rank, fn, backend, init_method, rank0, world_size, args):
    rank = rank0 + local_rank
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, nprocs: int, *args, device_type: str = "cuda",
           num_nodes: int = 1):
    """Run ``fn(rank, world_size, *args)`` in ``nprocs`` new processes of
    this host, joined in one process group (NCCL for ``device_type``
    "cuda", each process on its card ``rank mod nprocs``; gloo on the CPU),
    and wait for them.  ``num_nodes > 1``: this host is node
    ``NODE_RANK`` of that many, each with ``nprocs`` processes, meeting at
    :func:`env_init_method`, in a group of ``WORLD_SIZE`` (default: all
    the hosts' processes); else at a free local port.  ``fn`` and
    ``args`` are pickled into the new processes."""
    backend = "nccl" if device_type == "cuda" else "gloo"
    world_size = nprocs * num_nodes
    if num_nodes > 1:
        init_method = env_init_method()
        rank0 = int(os.environ.get("NODE_RANK", 0)) * nprocs
        world_size = int(os.environ.get("WORLD_SIZE", world_size))
    else:
        init_method, rank0 = f"tcp://localhost:{free_port()}", 0
    torch.multiprocessing.spawn(
        _worker, args=(fn, backend, init_method, rank0, world_size, args),
        nprocs=nprocs, join=True)
