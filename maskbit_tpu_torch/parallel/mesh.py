"""The multi-process runtime over `torch.distributed`: the (data, fsdp,
tensor) mesh, its process groups, the parameter partitioning rules and the
collectives.

Counterpart of `maskbit_tpu/parallel/mesh.py`. The JAX package leaves the
gradient and metric reductions to GSPMD; here every reduction is an
explicit collective (the trainers take their gradients with
`torch.autograd.grad`, which DDP's and FSDP's hooks do not see):

  * `MeshConfig.from_config`: the `parallel` node. `data x fsdp x tensor`
    must equal the process count (`data = -1` takes the rest); any other
    product raises, naming the numbers;
  * `init_mesh`: lays the ranks out in JAX's `AXES` order, `data` outermost
    and `tensor` innermost (rank = (d * fsdp + f) * tensor + t), and makes
    the process groups: the batch group (`data x fsdp`: the ranks that hold
    different rows of the global batch, as JAX's `batch_sharding` splits
    it; the ranks of one tensor group hold the same rows), the `fsdp`,
    `tensor` and `data` groups and the model group (`fsdp x tensor`).
    `batch_shard_index` and `batch_shard_count` give this rank's rows.
    Without `init_mesh` the mesh is pure data parallelism over every
    process;
  * `maybe_init_distributed`: joins the process group that `torchrun`
    describes (`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`,
    `MASTER_ADDR`, `MASTER_PORT`) when `WORLD_SIZE` > 1, or at any size with
    `MASKBIT_DISTRIBUTED=1`; each rank takes `cuda:{LOCAL_RANK %
    device_count}`; NCCL when every local rank has a card of its own, gloo
    when ranks share a card and on the CPU;
  * `_PARAM_RULES` and `param_shardings`: JAX's partitioning rules written
    on the port's state-dict keys, each key's split as one tuple of mesh
    axes per dimension (`ParamSplit`); `shard_params`, `shard_train_state`
    and `shard_of` keep this rank's slice; `sharded_byte_fraction`;
  * collectives, each over a `Group` (None: every process): `all_reduce_mean_`
    (the gradients, in flat buckets of one dtype), `global_mean` (the mean
    over the group of a per-rank mean, differentiable: the cotangent passes
    through unchanged, so each rank's gradient is its share of the global
    one and the gradient reduction completes it), `mean_across_processes`,
    `local_rows`, `rank_seed`, `all_gather_flat`, `reduce_scatter_flat`,
    and Megatron's pair `copy_to_group` (identity forward, all-reduce
    backward) and `reduce_from_group` (all-reduce forward, identity
    backward);
  * `process_index`, `process_count`, `is_main_process`, `barrier`,
    `process_allgather_f64` (bit-exact: the float64 bits travel as int64)
    and `assert_host_agreement` for the facts that gate a collective.

Under gloo, tensors on a card are staged through host memory for each
collective (gloo's `reduce_scatter` is there on the CPU's torch 2.13 and
the card's 2.11). Under every backend a bf16 or fp16 tensor travels and is
reduced in float32 and comes back in its own dtype, so NCCL's sums equal
gloo's, which the CPU tests hold against JAX.
Everything is a no-op (or the identity) in one process.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, Iterable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# gradients are averaged in flat buffers of at most this many bytes
BUCKET_BYTES = 256 << 20
AXES = ("data", "fsdp", "tensor")


class MeshConfig(NamedTuple):
    data: int = -1  # -1: every process that fsdp x tensor leaves
    fsdp: int = 1
    tensor: int = 1

    @classmethod
    def from_config(cls, cfg, world: Optional[int] = None) -> "MeshConfig":
        """The `parallel` node of a config (absent: pure data parallelism),
        checked against `world` processes (default: the running count)."""
        node = cfg.get("parallel", None)
        mesh = cls() if node is None else cls(data=int(node.get("data", -1)),
                                              fsdp=int(node.get("fsdp", 1)),
                                              tensor=int(node.get("tensor", 1)))
        mesh.resolve(process_count() if world is None else world)
        return mesh

    def resolve(self, world: int) -> "MeshConfig":
        """This mesh with `data` filled in for `world` processes; raises,
        naming the numbers, when data x fsdp x tensor cannot equal it."""
        if self.fsdp < 1 or self.tensor < 1 or self.data == 0 or self.data < -1:
            raise ValueError(f"parallel.data={self.data}, parallel.fsdp={self.fsdp}, "
                             f"parallel.tensor={self.tensor}: each axis needs a size >= 1")
        model = self.fsdp * self.tensor
        if self.data == -1:
            if world % model:
                raise ValueError(f"{world} processes do not divide into parallel.fsdp={self.fsdp}"
                                 f" x parallel.tensor={self.tensor}; one process per device")
            return self._replace(data=world // model)
        if self.data * model != world:
            raise ValueError(f"parallel.data={self.data} x parallel.fsdp={self.fsdp} x "
                             f"parallel.tensor={self.tensor} = {self.data * model}, but {world} "
                             "processes run; one process per device")
        return self


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


# ------------------------------------------------------------------ the mesh

class Group(NamedTuple):
    """A set of ranks that take part in one collective: the torch process
    group (None: the default group of every process), its members' global
    ranks in ascending order, and this process's place among them."""

    pg: Optional[object]
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


class Mesh:
    """The resolved (data, fsdp, tensor) mesh of this run, this rank's
    coordinates in it and its groups (see the module docstring)."""

    def __init__(self, shape: MeshConfig, groups: Dict[str, Group]):
        self.shape = shape
        self.world = shape.data * shape.fsdp * shape.tensor
        self.groups = groups
        self.coords = coords_of(process_index(), shape)

    def coord(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]


def coords_of(rank: int, shape: MeshConfig) -> Tuple[int, int, int]:
    """(d, f, t) of a global rank: rank = (d * fsdp + f) * tensor + t."""
    t = rank % shape.tensor
    f = (rank // shape.tensor) % shape.fsdp
    return rank // (shape.tensor * shape.fsdp), f, t


# the groups and the axes they span
GROUP_AXES = {"batch": ("data", "fsdp"), "fsdp": ("fsdp",), "tensor": ("tensor",),
              "data": ("data",), "model": ("fsdp", "tensor")}
_MESH: Optional[Mesh] = None


def _world_group() -> Group:
    return Group(None, tuple(range(process_count())), process_index())


def _make_groups(shape: MeshConfig) -> Dict[str, Group]:
    """Every group of every kind, made in the same order on every process
    (torch's `new_group` is collective); each process keeps its own."""
    world, me = process_count(), process_index()
    mine = coords_of(me, shape)
    groups = {}
    for kind, axes in GROUP_AXES.items():
        span = [AXES.index(a) for a in axes]
        members: Dict[tuple, List[int]] = {}
        for r in range(world):
            c = coords_of(r, shape)
            members.setdefault(tuple(v for i, v in enumerate(c) if i not in span), []).append(r)
        key = tuple(v for i, v in enumerate(mine) if i not in span)
        for k, ranks in members.items():
            if len(ranks) == 1:
                pg = None
            elif len(ranks) == world:
                pg = None  # the default group
            else:
                pg = dist.new_group(ranks)
            if k == key:
                groups[kind] = Group(pg, tuple(ranks), ranks.index(me))
    return groups


def init_mesh(config: MeshConfig = MeshConfig()) -> Mesh:
    """Resolve `config` against the running processes and make its groups
    (collective: every process calls it with the same config)."""
    global _MESH
    shape = config.resolve(process_count())
    if _MESH is not None and _MESH.shape == shape and _MESH.world == process_count():
        return _MESH
    _MESH = Mesh(shape, _make_groups(shape) if process_count() > 1 else {})
    return _MESH


def current_mesh() -> Mesh:
    """The mesh `init_mesh` made, or pure data parallelism over every
    process."""
    if _MESH is not None and _MESH.world == process_count():
        return _MESH
    shape = MeshConfig(data=process_count())
    groups = {}
    if process_count() > 1:
        one = lambda: Group(None, (process_index(),), 0)  # noqa: E731
        groups = {"batch": _world_group(), "data": _world_group(), "fsdp": one(),
                  "tensor": one(), "model": one()}
    return Mesh(shape, groups)


def group(kind: str) -> Group:
    """This process's group of `kind` ("batch", "fsdp", "tensor", "data" or
    "model") in the current mesh."""
    mesh = current_mesh()
    if kind not in mesh.groups:
        return Group(None, (process_index(),), 0)
    return mesh.groups[kind]


def batch_group() -> Group:
    return group("batch")


def batch_shard_index() -> int:
    """Which rows of the global batch this rank holds: d * fsdp + f."""
    return batch_group().index


def batch_shard_count() -> int:
    return batch_group().size


def _size(g: Optional[Group]) -> int:
    return process_count() if g is None else g.size


def _index(g: Optional[Group]) -> int:
    return process_index() if g is None else g.index


def _pg(g: Optional[Group]):
    return None if g is None else g.pg


# ------------------------------------------------------------- collectives

def _staged(t: torch.Tensor) -> torch.Tensor:
    """`t` as the collective takes it: on the collective's device, and a
    half type in float32 (under every backend, so that the sums do not
    depend on it)."""
    dtype = torch.float32 if t.dtype in (torch.bfloat16, torch.float16) else t.dtype
    return t.to(_comm_device(), dtype)


def _all_reduce_sum_(flat: torch.Tensor, g: Optional[Group] = None) -> torch.Tensor:
    """Sum `flat` over the group in place, staged through the collective's
    device."""
    if _size(g) == 1:
        return flat
    staged = _staged(flat)
    dist.all_reduce(staged, group=_pg(g))
    if staged is not flat:
        flat.copy_(staged)
    return flat


def all_reduce_mean_(tensors: Iterable[torch.Tensor], group: Optional[Group] = None
                     ) -> List[torch.Tensor]:
    """Average each tensor over the group (None: every process), in place,
    through flat buckets of one dtype and device of at most `BUCKET_BYTES`;
    returns the tensors (unchanged in a group of one)."""
    tensors = list(tensors)
    n = _size(group)
    if n == 1 or not tensors:
        return tensors
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for same in groups.values():
        bucket: List[torch.Tensor] = []
        size = 0
        for t in same + [None]:
            if t is not None and (not bucket or size + t.numel() * t.element_size()
                                  <= BUCKET_BYTES):
                bucket.append(t)
                size += t.numel() * t.element_size()
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket])
            _all_reduce_sum_(flat, group).div_(n)
            for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                b.copy_(part.view_as(b))
            bucket, size = ([t], t.numel() * t.element_size()) if t is not None else ([], 0)
    return tensors


def all_gather_flat(flat: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every member's `flat` (equal sizes), in the group's order, on
    `flat`'s device."""
    if group.size == 1:
        return [flat]
    staged = _staged(flat)
    out = [torch.empty_like(staged) for _ in range(group.size)]
    dist.all_gather(out, staged, group=group.pg)
    return [o.to(flat.device, flat.dtype) for o in out]


def reduce_scatter_flat(pieces: Sequence[torch.Tensor], group: Group) -> torch.Tensor:
    """The sum over the group's members of their `pieces[self]`: each member
    gives one piece per member (equal sizes) and keeps the sum of the
    pieces meant for it."""
    if group.size == 1:
        return pieces[0].clone()
    staged = [_staged(p) for p in pieces]
    out = torch.empty_like(staged[0])
    dist.reduce_scatter(out, staged, group=group.pg)
    return out.to(pieces[0].device, pieces[0].dtype)


class _GlobalMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_mean_([x.detach().clone()], group)[0]

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_mean(x: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """The mean over the group (None: every process) of `x` (each rank's
    mean over its equal share of the global batch), so the global batch's
    mean; differentiable, the cotangent passed through (see the module
    docstring). `x` itself in a group of one."""
    if _size(group) == 1:
        return x
    return _GlobalMean.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_sum_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's `f`: the identity forward; backward, the sum of the
    members' cotangents (the input of a column-parallel layer)."""
    return x if group.size == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's `g`: forward, the sum of the members' partial outputs (a
    row-parallel layer's, before its bias); the cotangent passes through."""
    return x if group.size == 1 else _ReduceFromGroup.apply(x, group)


@torch.no_grad()
def mean_across_processes(metrics: Dict[str, torch.Tensor], group: Optional[Group] = None
                          ) -> Dict[str, torch.Tensor]:
    """The scalar tensors of `metrics` averaged over the group (None: every
    process) in one collective (others passed as they are): a per-rank
    batch mean becomes the global batch's, and a value equal on every rank
    stays as it is."""
    if _size(group) == 1:
        return metrics
    keys = [k for k, v in metrics.items() if torch.is_tensor(v) and v.dim() == 0]
    if not keys:
        return metrics
    flat = all_reduce_mean_([torch.stack([metrics[k].float() for k in keys])], group)[0]
    return {**metrics, **dict(zip(keys, flat.unbind()))}


def local_rows(x, b_local: int, group: Optional[Group] = None):
    """This rank's rows of `x`, given for the global batch (leading dim
    `b_local` x the group's size; None: every process): rows `[i * b_local,
    (i + 1) * b_local)` for the rank's place i in the group. `x` itself in
    a group of one."""
    n = _size(group)
    if n == 1:
        return x
    if x.shape[0] != b_local * n:
        raise ValueError(f"an array given for the global batch has {x.shape[0]} rows, not "
                         f"{b_local} x {n} shards")
    r = _index(group)
    return x[r * b_local:(r + 1) * b_local]


def rank_seed(seed: int, group: Optional[Group] = None) -> int:
    """`seed` with this rank's place in the group (None: every process)
    folded in: seed + index * 0x9E3779B1, an odd multiplier, so the low 32
    bits (all that the CPU generator keeps) of two places' seeds differ too
    and their step streams never coincide; `seed` itself at place 0. Ranks
    of one tensor group share their place in the batch group, and so their
    stream."""
    return int(seed) + _index(group) * 0x9E3779B1


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


# --------------------------------------------------- parameter partitioning
# JAX's _PARAM_RULES (maskbit_tpu/parallel/mesh.py) on the port's state-dict
# keys: (key regex, one tuple of mesh axes per torch dimension, outer axis
# first). The first rule whose rank equals the parameter's and whose axis
# sizes divide its dims wins; none: replicated. Torch stores a linear
# weight as (out, in) and a conv kernel as OIHW where JAX has (in, out) and
# HWIO, so the specs are JAX's transposed.
#   * tensor: Megatron's split of heads and the MLP hidden dim (qkv and fc1
#     by columns, out_proj and fc2 by rows, one all-reduce each pair);
#   * fsdp: ZeRO-style storage of every remaining dim: gathered before the
#     forward, the gradients reduce-scattered.
# JAX's rules for `input_proj`, `last_dense` and `prediction_layer` kernels
# (`.*/name/kernel$`) and Bert's `bias_{i}` (`.*/bias_\d+$`) want a parent
# module, which those top-level leaves lack: JAX replicates them, and so
# does the port (the head is replicated, computed whole on every rank).
_T, _F, _TF = ("tensor",), ("fsdp",), ("tensor", "fsdp")
_LAYER = r"transformer\.layers\.\d+\."
_QKV_FC1_W = re.compile(_LAYER + r"(0\.mha\.in_proj_weight|1\.net\.0\.weight)$")
_OUT_FC2_W = re.compile(_LAYER + r"(0\.mha\.out_proj\.weight|1\.net\.2\.weight)$")
_QKV_FC1_B = re.compile(_LAYER + r"(0\.mha\.in_proj_bias|1\.net\.0\.bias)$")
_EMBEDDING = re.compile(r".*(class_emb|tok_emb_list\.\d+|quantize\.embedding)\.weight$")
_PARAM_RULES = [
    (_QKV_FC1_W, (_T, _F)),
    (_QKV_FC1_W, (_T, ())),
    (_OUT_FC2_W, (_F, _T)),
    (_OUT_FC2_W, ((), _T)),
    (_QKV_FC1_B, (_TF,)),
    (_QKV_FC1_B, (_T,)),
    # embeddings: vocab over fsdp when divisible, else the feature dim
    (_EMBEDDING, (_F, ())),
    (_EMBEDDING, ((), _TF)),
    # learned positional embedding (1, seq+1, hidden): feature dim
    (re.compile(r"(.*\.)?pos_emb$"), ((), (), _TF)),
    # conv kernels (OIHW): output channels over fsdp
    (re.compile(r".*\.weight$"), (_F, (), (), ())),
    # every remaining vector (biases, norm scales)
    (re.compile(r".*\.(bias|weight)$"), (_TF,)),
]
# the parameters whose tensor axis splits the computation, not only the
# storage: the packed q|k|v rows split head-wise, the others in plain chunks
_HEADS = re.compile(_LAYER + r"0\.mha\.in_proj_(weight|bias)$")
_MEGATRON = re.compile(_LAYER + r"(0\.mha\.out_proj\.weight|1\.net\.(0\.weight|0\.bias|2\.weight))$")


class ParamSplit(NamedTuple):
    """How one parameter is split: per torch dimension the mesh axes over
    it, outer first (axes of size 1 left out); `megatron` "heads" or
    "plain" when the tensor axis splits the computation (the layer runs on
    its share: the packed q|k|v rows head-wise, or a plain chunk), None
    when every split is storage only."""

    spec: Tuple[Tuple[str, ...], ...]
    megatron: Optional[str] = None

    def storage(self, dim: int) -> Tuple[str, ...]:
        """The axes that split the stored slice of dim `dim`."""
        return tuple(a for a in self.spec[dim] if not (self.megatron and a == "tensor"))

    def axes(self) -> set:
        return {a for dim in self.spec for a in dim}


def _spec_for(key: str, shape, mesh: MeshConfig) -> Optional[ParamSplit]:
    """The first rule that fits `key` and `shape` on `mesh`; None when the
    parameter is replicated."""
    for pattern, spec in _PARAM_RULES:
        if not pattern.match(key) or len(spec) != len(shape):
            continue
        sizes = [int(np.prod([getattr(mesh, a) for a in axes])) for axes in spec]
        if any(dim % size for dim, size in zip(shape, sizes)):
            continue
        spec = tuple(tuple(a for a in axes if getattr(mesh, a) > 1) for axes in spec)
        if not any(spec):
            return None
        megatron = None
        if any("tensor" in axes for axes in spec):
            megatron = "heads" if _HEADS.match(key) else "plain" if _MEGATRON.match(key) else None
        return ParamSplit(spec, megatron)
    return None


def param_shardings(module_or_shapes, mesh: Optional[MeshConfig] = None
                    ) -> Dict[str, ParamSplit]:
    """{key: ParamSplit} of every split parameter of a module (or of a
    {key: shape} mapping), following `_PARAM_RULES` on `mesh` (default: the
    current mesh's shape); replicated keys are left out."""
    mesh = current_mesh().shape if mesh is None else mesh
    if hasattr(module_or_shapes, "named_parameters"):
        shapes = {k: tuple(p.shape) for k, p in module_or_shapes.named_parameters()}
    else:
        shapes = {k: tuple(s) for k, s in module_or_shapes.items()}
    out = {}
    for key, shape in shapes.items():
        split = _spec_for(key, shape, mesh)
        if split is not None:
            out[key] = split
    return out


def _axes_index(axes: Sequence[str], mesh: MeshConfig, coords) -> Tuple[int, int]:
    """(chunk index, chunk count) of the joint axes `axes` (outer first)."""
    idx, n = 0, 1
    for a in axes:
        size = getattr(mesh, a)
        idx, n = idx * size + coords[AXES.index(a)], n * size
    return idx, n


def _megatron_dim(split: ParamSplit) -> Optional[int]:
    if split.megatron is None:
        return None
    return next(i for i, axes in enumerate(split.spec) if "tensor" in axes)


def tensor_local(x: torch.Tensor, split: ParamSplit, t: int, tensor: int) -> torch.Tensor:
    """Tensor rank `t`'s part of a whole parameter for the computation: the
    heads [t h/T, (t+1) h/T) of each of q, k and v, or the t-th plain chunk
    of the Megatron dim; `x` itself when the split is storage only."""
    dim = _megatron_dim(split)
    if dim is None or tensor == 1:
        return x
    if split.megatron == "heads":
        parts = x.unflatten(dim, (3, tensor, x.shape[dim] // (3 * tensor)))
        return parts.select(dim + 1, t).flatten(dim, dim + 1)
    return x.chunk(tensor, dim)[t]


def tensor_whole(parts: Sequence[torch.Tensor], split: ParamSplit) -> torch.Tensor:
    """The inverse of `tensor_local`: the whole from every tensor rank's
    part, in rank order."""
    dim = _megatron_dim(split)
    if dim is None or len(parts) == 1:
        return parts[0]
    if split.megatron == "heads":
        per = [p.unflatten(dim, (3, p.shape[dim] // 3)) for p in parts]
        return torch.stack(per, dim + 1).flatten(dim, dim + 2)
    return torch.cat(list(parts), dim)


def storage_slices(split: ParamSplit, local_shape, mesh: MeshConfig, coords) -> tuple:
    """The index of the stored slice of a rank at `coords` in its
    tensor-local parameter."""
    out = []
    for dim, size in enumerate(local_shape):
        idx, n = _axes_index(split.storage(dim), mesh, coords)
        chunk = size // n
        out.append(slice(idx * chunk, (idx + 1) * chunk))
    return tuple(out)


def shard_of(x: torch.Tensor, split: Optional[ParamSplit], mesh: Optional[MeshConfig] = None,
             coords=None) -> torch.Tensor:
    """The slice of the whole parameter `x` that the rank at `coords`
    (default: this rank) stores, as a new tensor; `x` itself when it is
    replicated."""
    if split is None:
        return x
    cur = current_mesh()
    mesh = cur.shape if mesh is None else mesh
    coords = cur.coords if coords is None else coords
    local = tensor_local(x, split, coords[2], mesh.tensor)
    return local[storage_slices(split, local.shape, mesh, coords)].clone()


def shard_params(params: Mapping[str, torch.Tensor],
                 splits: Optional[Mapping[str, ParamSplit]] = None) -> Dict[str, torch.Tensor]:
    """This rank's slices of whole parameters {key: tensor}, following
    `param_shardings` (default: of these shapes on the current mesh)."""
    splits = param_shardings({k: v.shape for k, v in params.items()}) if splits is None else splits
    return {k: shard_of(v, splits.get(k)) for k, v in params.items()}


def shard_train_state(tree, splits: Mapping[str, ParamSplit],
                      names: Optional[Sequence[str]] = None):
    """A whole train state's tree (a checkpoint's) with this rank's slices
    only: every tensor kept under a parameter's key, and the i-th tensor
    of an optimizer's `mu`, `nu` and `acc` lists (the parameters `names`,
    in order), become slices; other leaves stay as they are."""
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            if torch.is_tensor(v) and k in splits:
                out[k] = shard_of(v, splits[k])
            elif k in ("mu", "nu", "acc") and isinstance(v, (list, tuple)) and names is not None:
                out[k] = [shard_of(t, splits.get(n)) for n, t in zip(names, v)]
            else:
                out[k] = shard_train_state(v, splits, names)
        return out
    return tree


def sharded_byte_fraction(module_or_shapes, mesh: Optional[MeshConfig] = None) -> float:
    """The share of parameter bytes whose placement splits the parameter
    across ranks on `mesh` (default: the current mesh's shape). The AdamW
    moments and the EMA shadows mirror the parameters, so this is also the
    share of the train state's bytes."""
    mesh = current_mesh().shape if mesh is None else mesh
    if hasattr(module_or_shapes, "named_parameters"):
        sizes = {k: p.numel() * p.element_size() for k, p in module_or_shapes.named_parameters()}
        shapes = {k: tuple(p.shape) for k, p in module_or_shapes.named_parameters()}
    else:
        shapes = {k: tuple(s) for k, s in module_or_shapes.items()}
        sizes = {k: int(np.prod(s)) * 4 for k, s in shapes.items()}
    splits = param_shardings(shapes, mesh)
    total = sum(sizes.values())
    return sum(sizes[k] for k in splits) / max(total, 1)
