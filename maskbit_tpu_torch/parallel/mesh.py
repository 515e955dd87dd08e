"""Data-parallel multi-process runtime over `torch.distributed`.

Counterpart of `maskbit_tpu/parallel/mesh.py`, for its `data` axis only.
The JAX package leaves the gradient and metric reductions to GSPMD; here
every reduction is an explicit collective (the trainers take their
gradients with `torch.autograd.grad`, which DDP's reducer does not hook):

  * `MeshConfig.from_config`: the `parallel` node; `fsdp` or `tensor` above 1
    raises (they wait for the FSDP PR, ROADMAP.md Queue 1);
  * `maybe_init_distributed`: joins the process group that `torchrun`
    describes (`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`,
    `MASTER_ADDR`, `MASTER_PORT`) when `WORLD_SIZE` > 1, or at any size with
    `MASKBIT_DISTRIBUTED=1`; each rank takes `cuda:{LOCAL_RANK %
    device_count}`; NCCL when every local rank has a card of its own, gloo
    when ranks share a card and on the CPU;
  * `process_index`, `process_count`, `is_main_process`, `barrier`;
  * `process_allgather_f64` (bit-exact: the float64 bits travel as int64)
    and `assert_host_agreement` for the facts that gate a collective;
  * `all_reduce_mean_`: a list of tensors (the gradients) averaged in place,
    in flat buckets of one dtype;
  * `global_mean`: the mean over ranks of a per-rank mean, differentiable,
    for the loss terms that JAX computes over the global batch (the LFQ and
    VQ codebook distributions, the LeCam means). Its backward passes the
    cotangent through unchanged: each rank's gradient is then its share of
    the global one, and the `all_reduce_mean_` of the gradients completes it;
  * `local_rows`: this rank's rows of an array given for the global batch.

Under gloo, tensors on a card are staged through host memory for each
collective. Everything is a no-op (or the identity) in one process.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

# gradients are averaged in flat buffers of at most this many bytes
BUCKET_BYTES = 256 << 20


class MeshConfig(NamedTuple):
    data: int = -1  # -1: every process
    fsdp: int = 1
    tensor: int = 1

    @classmethod
    def from_config(cls, cfg) -> "MeshConfig":
        """The `parallel` node of a config (absent: pure data parallelism).
        The fsdp and tensor axes are not ported: above 1 they raise."""
        node = cfg.get("parallel", None)
        mesh = cls() if node is None else cls(data=node.get("data", -1),
                                              fsdp=node.get("fsdp", 1),
                                              tensor=node.get("tensor", 1))
        if mesh.fsdp > 1 or mesh.tensor > 1:
            raise NotImplementedError(
                f"parallel.fsdp={mesh.fsdp}, parallel.tensor={mesh.tensor}: maskbit_tpu_torch "
                "ports the data axis only; FSDP and the tensor axis wait for a later PR "
                "(ROADMAP.md, Queue 1)")
        if mesh.data not in (-1, process_count()):
            raise ValueError(f"parallel.data={mesh.data} but {process_count()} processes run; "
                             "one process per device")
        return mesh


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if _distributed() else 1


def is_main_process() -> bool:
    return process_index() == 0


def _comm_device() -> torch.device:
    """Where collective buffers live: the rank's card under NCCL, else the
    host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def maybe_init_distributed(device: torch.device,
                           logger: Optional[logging.Logger] = None) -> torch.device:
    """Join the process group described by torchrun's environment when
    `WORLD_SIZE` > 1 (or `MASKBIT_DISTRIBUTED=1`); returns the device this
    rank computes on (`device` itself in one process, or `cuda:{LOCAL_RANK
    % device_count}`). Joining twice is a no-op."""
    device = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    wanted = world > 1 or os.environ.get("MASKBIT_DISTRIBUTED", "0") == "1"
    if not (wanted or _distributed()):
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for but none is available")
        n_cards = torch.cuda.device_count()
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
    if _distributed():
        return device
    rank = int(os.environ.get("RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        backend = "nccl"
    else:
        backend = "gloo"
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            **kwargs)
    why = ("one card per local rank" if backend == "nccl" else
           f"{local_world} local ranks share {torch.cuda.device_count()} card(s)"
           if device.type == "cuda" else "CPU")
    (logger or logging.getLogger("maskbit_tpu_torch")).info(
        f"torch.distributed: rank {rank} of {world} (local {local_rank} of {local_world}) on "
        f"{device}, backend {backend} ({why})")
    return device


def barrier() -> None:
    """Every process waits here for the others (no-op in one process)."""
    if not _distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _all_reduce_sum_(flat: torch.Tensor) -> torch.Tensor:
    """Sum `flat` over the processes in place, staged through the
    collective's device."""
    comm = _comm_device()
    if flat.device == comm:
        dist.all_reduce(flat)
        return flat
    staged = flat.to(comm)
    dist.all_reduce(staged)
    flat.copy_(staged)
    return flat


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    """Average each tensor over the processes, in place, through flat
    buckets of one dtype and device of at most `BUCKET_BYTES`; returns the
    tensors (unchanged in one process)."""
    tensors = list(tensors)
    if process_count() == 1 or not tensors:
        return tensors
    world = process_count()
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        bucket: List[torch.Tensor] = []
        size = 0
        for t in group + [None]:
            if t is not None and (not bucket or size + t.numel() * t.element_size()
                                  <= BUCKET_BYTES):
                bucket.append(t)
                size += t.numel() * t.element_size()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            _all_reduce_sum_(flat).div_(world)
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            bucket, size = ([t], t.numel() * t.element_size()) if t is not None else ([], 0)
    return tensors


class _GlobalMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_mean_([x.detach().clone()])[0]

    @staticmethod
    def backward(ctx, grad):
        return grad


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the processes of `x` (each rank's mean over its equal
    share of the global batch), so the global batch's mean; differentiable,
    the cotangent passed through (see the module docstring). `x` itself in
    one process."""
    if process_count() == 1:
        return x
    return _GlobalMean.apply(x)


@torch.no_grad()
def mean_across_processes(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The scalar tensors of `metrics` averaged over the processes in one
    collective (others passed as they are): a per-rank batch mean becomes
    the global batch's, and a value equal on every rank stays as it is."""
    if process_count() == 1:
        return metrics
    keys = [k for k, v in metrics.items() if torch.is_tensor(v) and v.dim() == 0]
    if not keys:
        return metrics
    flat = all_reduce_mean_([torch.stack([metrics[k].float() for k in keys])])[0]
    return {**metrics, **dict(zip(keys, flat.unbind()))}


def local_rows(x, b_local: int):
    """This rank's rows of `x`, given for the global batch (leading dim
    `b_local * process_count()`): rows `[rank * b_local, (rank + 1) *
    b_local)`. `x` itself in one process."""
    n = process_count()
    if n == 1:
        return x
    if x.shape[0] != b_local * n:
        raise ValueError(f"an array given for the global batch has {x.shape[0]} rows, not "
                         f"{b_local} x {n} processes")
    r = process_index()
    return x[r * b_local:(r + 1) * b_local]


def rank_seed(seed: int) -> int:
    """`seed` with this rank folded in: seed + rank * 0x9E3779B1, an odd
    multiplier, so the low 32 bits (all that the CPU generator keeps) of
    two ranks' seeds differ too and their step streams never coincide;
    `seed` itself on rank 0."""
    return int(seed) + process_index() * 0x9E3779B1


def process_allgather_f64(x) -> np.ndarray:
    """Bit-exact float64 allgather -> (nproc, *shape): the float64 bits
    travel as int64, so the result does not depend on the backend's
    floating-point support. (1, *shape) in one process."""
    x = np.ascontiguousarray(np.atleast_1d(np.asarray(x, np.float64)))
    if process_count() == 1:
        return x[None].copy()
    bits = torch.from_numpy(x.view(np.int64).copy()).to(_comm_device())
    out = [torch.empty_like(bits) for _ in range(process_count())]
    dist.all_gather(out, bits)
    gathered = torch.stack(out).cpu().numpy()
    return gathered.view(np.float64).reshape((len(out),) + x.shape)


def assert_host_agreement(facts: Dict[str, float], context: str = "") -> None:
    """Raise, naming the fact and each process's value, when per-process
    facts disagree (no-op in one process). A collective gated on a fact
    one process sees differently (a weights file found through an
    environment variable, a stats file, a checkpoint on a local disk)
    would otherwise hang every process; callers agree on the facts here
    first, in one small collective every process runs."""
    if process_count() == 1:
        return
    names = sorted(facts)
    vec = np.asarray([float(facts[k]) for k in names], np.float64)
    gathered = process_allgather_f64(vec)
    if (gathered == vec[None]).all():
        return
    lines = [f"  {name}: " + " ".join(f"process{p}={gathered[p, i]:g}"
                                      for p in range(gathered.shape[0]))
             for i, name in enumerate(names) if not (gathered[:, i] == gathered[0, i]).all()]
    raise RuntimeError(f"per-process facts disagree{' in ' + context if context else ''} "
                       "(a collective gated on them would hang every process):\n"
                       + "\n".join(lines))
