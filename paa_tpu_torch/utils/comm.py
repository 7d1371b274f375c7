"""Processes and collectives over ``torch.distributed`` (the port's
counterpart of paa_tpu/utils/comm.py; reference paa_core/utils/comm.py
and tools/train_net.py:150-155).

One process per GPU, launched by ``torchrun`` (or anything that sets its
``env://`` variables: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK). ``init_distributed`` joins the process group when
WORLD_SIZE > 1 and gives the rank's device; everything else reads the
group and is a no-op without one. NCCL serves ranks on the card, one
card each; gloo serves ranks on the CPU, and any rank that asks for it
(chip_smoke.py runs two gloo ranks on one card, where NCCL refuses two
ranks on one device).
"""

from __future__ import annotations

import os
import pickle

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def get_world_size():
    return dist.get_world_size() if is_initialized() else 1


def get_rank():
    return dist.get_rank() if is_initialized() else 0


def is_main_process():
    return get_rank() == 0


def unwrap(module):
    """The model's module inside a ``DistributedDataParallel``."""
    if isinstance(module, DistributedDataParallel):
        return module.module
    return module


def synchronize():
    """A barrier across the ranks; a no-op in one process."""
    if get_world_size() > 1:
        dist.barrier()


def _collective_device():
    """Where a collective's tensors live: the rank's card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_pickled(obj):
    """Every rank's picklable ``obj``, a list in rank order (the
    reference's padded byte all_gather, paa_core/utils/comm.py:48-88):
    the byte counts are gathered first, then the pickles padded to the
    longest. One process returns [obj] and touches no device."""
    world = get_world_size()
    if world == 1:
        return [obj]
    device = _collective_device()
    data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                            dtype=torch.uint8).to(device)
    size = torch.tensor([data.numel()], dtype=torch.int64, device=device)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size)
    sizes = [int(s) for s in sizes]
    padded = torch.zeros(max(sizes), dtype=torch.uint8, device=device)
    padded[:data.numel()] = data
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded)
    return [pickle.loads(t[:n].cpu().numpy().tobytes())
            for t, n in zip(gathered, sizes)]


def all_reduce_sum(tensor):
    """The sum of ``tensor`` over the ranks (a new tensor, detached); the
    tensor itself in one process. gloo reduces CUDA tensors too."""
    if get_world_size() == 1:
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out)
    return out


def init_distributed(device=None, logger=None, backend=None):
    """Join the process group of a ``torchrun`` launch and return this
    rank's device.

    With WORLD_SIZE > 1 in the environment: ``device`` "cpu" runs the
    rank on the CPU with gloo; otherwise the rank runs on
    cuda:LOCAL_RANK (made the current device) with NCCL. ``backend``
    overrides the choice. The group is joined through ``env://``; a
    failed join raises. With no WORLD_SIZE, or 1, nothing is joined and
    the device is ``device`` (None: the card, as every entry point of
    the port)."""
    from ..modeling.detector import resolve_device

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return resolve_device(device)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu:
        rank_device = torch.device("cpu")
    else:
        rank_device = resolve_device(
            torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))))
        torch.cuda.set_device(rank_device)
    if not is_initialized():
        dist.init_process_group(backend or ("gloo" if on_cpu else "nccl"),
                                init_method="env://")
    if logger:
        logger.info(f"torch.distributed: rank {get_rank()} of "
                    f"{get_world_size()} ({dist.get_backend()}) on "
                    f"{rank_device}")
    return rank_device
