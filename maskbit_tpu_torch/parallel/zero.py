"""The sharded parameter store: explicit ZeRO-3 over `fsdp` plus Megatron
over `tensor`, on `torch.distributed`.

`ShardedParams(module)` holds this rank's slices of a module's parameters,
following `parallel.mesh.param_shardings` on the current mesh:
  * under `tensor`, the Megatron layers (`nn/transformer.py`) are cut to
    this rank's share first: `in_proj_weight` / `in_proj_bias` keep the
    rows of heads [t h/T, (t+1) h/T) of each of q, k and v (JAX's
    `P(None, "tensor")` splits the packed columns plainly and lets GSPMD
    reshard; here the split is head-wise so that each rank's attention
    runs on whole heads), `fc1` keeps its t-th chunk of rows, `out_proj`
    and `fc2` their t-th chunk of columns; the layers then sum their
    partial outputs over the tensor group before the bias; an attention
    layer whose heads do not divide `tensor` is not cut (JAX runs such a
    layer's kernel unpartitioned): it computes whole on every tensor rank,
    its q|k|v and out-projection split over fsdp only, with a warning;
  * every other split (fsdp, and the tensor axis of a storage-only rule) is
    storage: `shards[name]` is this rank's slice, a float32 `nn.Parameter`
    of its own; a replicated parameter's "shard" is the module's parameter
    itself, so with nothing split the store changes nothing (data
    parallelism: the trainers' updates reach the module in place).

Between steps the module holds no copy of a split parameter (an empty
tensor of its dtype): `gather()` writes the whole (tensor-local)
parameters into the module before the forward, one all-gather per bucket
over the fsdp group (or the model group for a storage split over
`tensor`), every rank's whole parameters at once, and `release()` frees
them once the gradients are taken (peak: one whole copy of the model's
float32 parameters and one of its gradients beside the slices, for the
forward and backward only).
`reduce_scatter_grads(names, grads)` turns the module's gradients (of this rank's
rows) into the slices' gradients of the global batch's mean: a
reduce-scatter over fsdp, then an all-reduce over data, divided by the
batch group's size (a replicated parameter: one all-reduce over the batch
group). The ranks of a tensor group hold the same rows, so their
gradients of a storage-only split are equal and each keeps its own slice.
`global_norm` sums the slices' squares over every rank, each distinct
slice counted once. `whole(names, tensors)` gathers slices (parameters,
AdamW moments, EMA shadows) back into whole parameters, across the tensor
group too; `whole_weights(source)` lends the module whole weights (the
EMA's, for generation) with the Megatron layers computing whole. Every
method that gathers or reduces is collective.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, Iterator, List, Mapping, Optional, Sequence

import torch
from torch import nn

from maskbit_tpu_torch.parallel.mesh import (
    BUCKET_BYTES,
    ParamSplit,
    _all_reduce_sum_,
    all_gather_flat,
    all_reduce_mean_,
    coords_of,
    current_mesh,
    group,
    param_shardings,
    process_count,
    reduce_scatter_flat,
    shard_params,
    storage_slices,
    tensor_local,
    tensor_whole,
)


_logger = logging.getLogger("maskbit_tpu_torch")


def _join(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _without_tensor(split: ParamSplit) -> Optional[ParamSplit]:
    """`split` with its tensor axis dropped (None when nothing is left)."""
    spec = tuple(tuple(a for a in axes if a != "tensor") for axes in split.spec)
    return ParamSplit(spec) if any(spec) else None


def _buckets(names: Sequence[str], sizes: Mapping[str, int]) -> List[List[str]]:
    """`names` in runs of at most `BUCKET_BYTES` (float32)."""
    out, run, size = [], [], 0
    for n in names:
        if run and size + 4 * sizes[n] > BUCKET_BYTES:
            out.append(run)
            run, size = [], 0
        run.append(n)
        size += 4 * sizes[n]
    return out + ([run] if run else [])


class ShardedParams:
    """This rank's slices of `module`'s parameters on the current mesh
    (see the module docstring); with `replicate`, none is split."""

    def __init__(self, module: nn.Module, replicate: bool = False):
        self.module = module
        self.mesh = current_mesh()
        shape = self.mesh.shape
        self.splits: Dict[str, ParamSplit] = {} if replicate else param_shardings(module, shape)
        params = dict(module.named_parameters())
        self.names = list(params)
        self.global_shapes = {n: tuple(p.shape) for n, p in params.items()}
        self.tensor_group = group("tensor")
        if not replicate and shape.tensor > 1:
            self._replicate_undivided_heads(module, shape.tensor)
        # the layers that compute on this rank's share under tensor: those
        # with a `tensor_group` whose parameters hold a Megatron split
        self._megatron_modules = [
            m for prefix, m in module.named_modules() if hasattr(m, "tensor_group") and any(
                getattr(self.splits.get(_join(prefix, n)), "megatron", False)
                for n, _ in m.named_parameters())]
        megatron = [n for n, s in self.splits.items() if s.megatron]
        if megatron:
            t = self.mesh.coord("tensor")
            with torch.no_grad():
                for n in megatron:
                    params[n].data = tensor_local(params[n].data, self.splits[n], t,
                                                  shape.tensor).contiguous().clone()
            self._set_tensor_group(self.tensor_group)
        self.params = params  # the module's parameters (tensor-local)
        self.local_shapes = {n: tuple(p.shape) for n, p in params.items()}
        self.shards: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for n, p in params.items():
                split = self.splits.get(n)
                if split is None:
                    self.shards[n] = p
                else:
                    local = p.data[storage_slices(split, p.shape, shape, self.mesh.coords)]
                    self.shards[n] = nn.Parameter(local.float().clone(),
                                                  requires_grad=p.requires_grad)
        self._name_of = {id(s): n for n, s in self.shards.items()}
        self.release()

    def _replicate_undivided_heads(self, module: nn.Module, tensor: int) -> None:
        """An attention layer whose heads do not divide `tensor` computes
        whole on every tensor rank, as JAX's unpartitioned kernel does: its
        q|k|v and out-projection leave the Megatron splits and keep their
        fsdp slices (the head, `input_proj` and `last_dense` are routed so).
        Both tensor ranks hold the same rows, so its gradients are equal
        there and take no tensor all-reduce."""
        for prefix, m in module.named_modules():
            if getattr(m, "num_heads", tensor) % tensor == 0:
                continue
            _logger.warning(
                "%s: heads=%d do not divide parallel.tensor=%d — falling back to the "
                "unpartitioned kernel (the layer is replicated over the tensor axis)",
                prefix, m.num_heads, tensor)
            for n, _ in m.named_parameters():
                name = _join(prefix, n)
                if name in self.splits and self.splits[name].megatron:
                    split = _without_tensor(self.splits[name])
                    if split is None:
                        del self.splits[name]
                    else:
                        self.splits[name] = split

    def _set_tensor_group(self, tensor_group) -> None:
        for m in self._megatron_modules:
            m.tensor_group = tensor_group

    @property
    def sharded(self) -> bool:
        """Whether any parameter is split on this mesh."""
        return bool(self.splits)

    def names_of(self, tensors: Sequence[torch.Tensor]) -> List[str]:
        """The parameter names of slices held by this store."""
        return [self._name_of[id(t)] for t in tensors]

    def parameters(self, names: Optional[Sequence[str]] = None) -> List[torch.Tensor]:
        """The slices of `names` (default: every parameter that takes a
        gradient), in order: what an optimizer updates."""
        if names is None:
            names = [n for n in self.names if self.params[n].requires_grad]
        return [self.shards[n] for n in names]

    # ------------------------------------------------------------- gather
    def _gather_group(self, split: ParamSplit):
        return group("model") if "tensor" in {a for d in range(len(split.spec))
                                              for a in split.storage(d)} else group("fsdp")

    def _local_wholes(self, names: Sequence[str], tensors: Sequence[torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Whole tensor-local parameters from slices (a collective)."""
        out: Dict[str, torch.Tensor] = {}
        shape = self.mesh.shape
        by_group: Dict[tuple, List[int]] = {}
        for i, n in enumerate(names):
            if n not in self.splits:
                out[n] = tensors[i]
                continue
            g = self._gather_group(self.splits[n])
            by_group.setdefault((g.ranks, tensors[i].dtype, tensors[i].device), []).append(i)
        for (ranks, _, _), idx in by_group.items():
            g = self._gather_group(self.splits[names[idx[0]]])
            sizes = {names[i]: tensors[i].numel() for i in idx}
            pos = {names[i]: i for i in idx}
            for run in _buckets([names[i] for i in idx], sizes):
                flat = torch.cat([tensors[pos[n]].reshape(-1) for n in run])
                pieces = all_gather_flat(flat, g)
                for n in run:
                    out[n] = torch.empty(self.local_shapes[n], dtype=flat.dtype,
                                         device=flat.device)
                offsets = [0] * len(pieces)
                for m, piece in enumerate(pieces):
                    coords = coords_of(g.ranks[m], shape)
                    for n in run:
                        split, whole = self.splits[n], out[n]
                        index = storage_slices(split, whole.shape, shape, coords)
                        k = sizes[n]
                        whole[index] = piece[offsets[m]:offsets[m] + k].view(whole[index].shape)
                        offsets[m] += k
        return out

    @torch.no_grad()
    def gather(self) -> None:
        """Write the whole tensor-local parameters into the module (a
        collective; nothing moves when nothing is split)."""
        split = [n for n in self.names if n in self.splits]
        if not split:
            return
        wholes = self._local_wholes(split, [self.shards[n] for n in split])
        for n, w in wholes.items():
            self.params[n].data = w

    def release(self) -> None:
        """Free the module's whole copies of the split parameters (each
        becomes an empty tensor of its dtype until the next `gather`)."""
        for n in self.splits:
            p = self.params[n]
            p.data = p.data.new_empty(0)

    @torch.no_grad()
    def whole(self, names: Sequence[str], tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Whole parameters (as a one-process run holds them) from slices
        of `names` (a collective; the tensors themselves when nothing is
        split)."""
        names = list(names)
        if not self.sharded:
            return list(tensors)
        local = self._local_wholes(names, list(tensors))
        out = []
        tg = self.tensor_group
        mega = [n for n in names if n in self.splits and self.splits[n].megatron]
        gathered: Dict[str, torch.Tensor] = {}
        if mega and tg.size > 1:
            sizes = {n: local[n].numel() for n in mega}
            for run in _buckets(mega, sizes):
                flat = torch.cat([local[n].reshape(-1) for n in run])
                pieces = all_gather_flat(flat, tg)
                offset = 0
                for n in run:
                    k = sizes[n]
                    parts = [p[offset:offset + k].view(local[n].shape) for p in pieces]
                    gathered[n] = tensor_whole(parts, self.splits[n])
                    offset += k
        for n in names:
            out.append(gathered.get(n, local[n]))
        return out

    def whole_dict(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        names = list(tensors)
        return dict(zip(names, self.whole(names, [tensors[n] for n in names])))

    def whole_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter whole (a collective)."""
        return self.whole_dict(self.shards)

    @torch.no_grad()
    def load_whole_(self, whole: Mapping[str, torch.Tensor]) -> None:
        """Copy whole parameters {name: tensor} into the slices (every
        name of the module); the module's copies of split parameters are
        released."""
        missing = set(self.names) ^ set(whole)
        if missing:
            raise KeyError(f"saved parameters differ: {sorted(missing)[:5]}")
        for n, shard in shard_params(whole, self.splits).items():
            self.shards[n].copy_(shard)
        self.release()

    @contextlib.contextmanager
    def whole_weights(self, source: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> Iterator[nn.Module]:
        """Inside the block the module holds whole weights (of `source`,
        slices by name such as the EMA shadows; default: the parameters)
        and its Megatron layers compute whole, as one process does; on exit
        the module is given back its own tensors. A collective."""
        source = self.shards if source is None else source
        wholes = self.whole_dict(source)
        kept = {n: p.data for n, p in self.params.items()}
        with torch.no_grad():
            for n, p in self.params.items():
                p.data = wholes[n].detach()
        self._set_tensor_group(None)
        try:
            yield self.module
        finally:
            for n, p in self.params.items():
                p.data = kept[n]
            self._set_tensor_group(self.tensor_group)

    # ----------------------------------------------------------- reduce
    @torch.no_grad()
    def reduce_scatter_grads(self, names: Sequence[str], grads: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """The slices' gradients of the global batch's mean, from the
        module's gradients of this rank's rows (a collective). Without a
        split this is `all_reduce_mean_` over the batch group, in place."""
        names, grads = list(names), list(grads)
        out: List[Optional[torch.Tensor]] = [None] * len(names)
        batch, fsdp, data = group("batch"), group("fsdp"), group("data")
        shape, coords = self.mesh.shape, self.mesh.coords
        replicated = [i for i, n in enumerate(names) if n not in self.splits]
        for i, g in zip(replicated, all_reduce_mean_([grads[i] for i in replicated], batch)):
            out[i] = g
        scattered, kept = [], []
        for i, n in enumerate(names):
            if n in self.splits:
                split = self.splits[n]
                has_fsdp = any("fsdp" in split.storage(d) for d in range(len(split.spec)))
                (scattered if has_fsdp else kept).append(i)
        # a storage split over tensor only: this rank's slice, averaged over the batch group
        mine = [grads[i][storage_slices(self.splits[names[i]], grads[i].shape, shape, coords)]
                .contiguous() for i in kept]
        for i, g in zip(kept, all_reduce_mean_(mine, batch)):
            out[i] = g
        if scattered:
            sizes = {names[i]: grads[i].numel() // fsdp.size for i in scattered}
            pos = {names[i]: i for i in scattered}
            for run in _buckets([names[i] for i in scattered], sizes):
                pieces = []
                for m in range(fsdp.size):
                    member = coords_of(fsdp.ranks[m], shape)
                    pieces.append(torch.cat([
                        grads[pos[n]][storage_slices(self.splits[n], grads[pos[n]].shape, shape,
                                                     member)].reshape(-1) for n in run]))
                flat = reduce_scatter_flat(pieces, fsdp)
                _all_reduce_sum_(flat, data)
                flat.div_(batch.size)
                offset = 0
                for n in run:
                    k = self.shards[n].numel()
                    out[pos[n]] = flat[offset:offset + k].view(self.shards[n].shape)
                    offset += k
        return out

    def _owns(self, name: str) -> bool:
        """Whether this rank counts `name`'s slice in a sum over every rank:
        one rank of each set that holds equal slices."""
        d, f, t = self.mesh.coords
        split = self.splits.get(name)
        axes = set() if split is None else split.axes()
        return d == 0 and (f == 0 or "fsdp" in axes) and (t == 0 or "tensor" in axes)

    @torch.no_grad()
    def squared_norms(self, names: Sequence[str], tensors: Sequence[torch.Tensor]
                      ) -> torch.Tensor:
        """Each parameter's sum of squares over every rank's slice (a
        collective), float32."""
        owned = [t.float() if self._owns(n) else torch.zeros_like(t, dtype=torch.float32)
                 for n, t in zip(names, tensors)]
        squares = torch.stack(torch._foreach_norm(owned)).pow(2)
        if process_count() > 1:
            _all_reduce_sum_(squares, None)
        return squares

    def global_norm(self, names: Sequence[str], tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares over every rank's slices, each
        distinct slice counted once (a collective); optax's global norm of
        the whole tensors when nothing is split."""
        from maskbit_tpu_torch.train.optim import global_norm

        if not self.sharded:
            return global_norm(list(tensors))
        return self.squared_norms(names, tensors).sum().sqrt()

    def norm_fn(self, params: Sequence[torch.Tensor]):
        """The global norm of tensors laid out as `params` (an optimizer's
        slices), for the optimizer's clip."""
        names = self.names_of(params)
        return lambda tensors: self.global_norm(names, tensors)
