"""The port's parameter partitioning (`maskbit_tpu_torch/parallel/mesh.py`)
against the JAX package's, in one process.

* Every parameter's split equals JAX's `param_shardings` element for
  element: each element is labelled with the fsdp and tensor coordinates of
  the ranks that store it, on JAX's tree (from its PartitionSpecs), which
  `compat/torch_export` then lays out as state-dict keys (transposes
  included), and on the port's (from `shard_of` at every coordinate); the
  labels must be equal. Tiny LFQBert, Bert and tokenizer, at fsdp=2, and at
  fsdp=2 x tensor=2, where the packed q|k|v weight and bias differ by
  design (the port splits them head-wise): there each rank's share holds
  as many elements, split over the same axes, as JAX's.
* `sharded_byte_fraction` at fsdp=2 is at least JAX's for the same models,
  and at least 0.9 for `tests/test_parallel.py`'s flagship-proportioned
  LFQBert.
* The head-wise slices reassemble the whole weights, and the rank shares of
  an attention layer and of a feed-forward layer, their partial outputs
  summed before the bias, give the whole layer's output (float32; atol
  1e-5, a few ulps of outputs up to about 4: the partial sums reassociate
  the output projection's sum).
* The collectives take a bf16 or fp16 tensor in float32 under gloo and
  under NCCL alike (`dist.get_backend` and the collective's device patched,
  the collectives themselves replaced by spies over two emulated members),
  and give it back in its own dtype: the backend does not change the sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maskbit_tpu.models.generator import Bert as JaxBert, LFQBert as JaxLFQBert
from maskbit_tpu.models.tokenizer import ConvVQModel as JaxConvVQModel
from maskbit_tpu.parallel.mesh import (
    MeshConfig as JaxMeshConfig,
    create_mesh,
    param_shardings as jax_param_shardings,
    shard_params as jax_shard_params,
    sharded_byte_fraction as jax_sharded_byte_fraction,
)
from maskbit_tpu_torch.compat.torch_export import export_generator_state, export_tokenizer_state
from maskbit_tpu_torch.models.generator import Bert, LFQBert
from maskbit_tpu_torch.models.tokenizer import ConvVQModel
from maskbit_tpu_torch.nn.transformer import BertFeedForward, MultiHeadSelfAttention
from maskbit_tpu_torch.parallel.mesh import (
    MeshConfig,
    param_shardings,
    shard_of,
    sharded_byte_fraction,
    tensor_local,
    tensor_whole,
)
from tests.test_cli_eval_demo import TINY_VQ

MLM = {"hidden_dim": 64, "depth": 1, "heads": 4, "mlp_dim": 128, "codebook_splits": 2,
       "img_size": 32, "input_stride": 4, "nclass": 10}
VQ256 = {"codebook_size": 256, "token_size": 8}
# tests/test_parallel.py's flagship-proportioned LFQBert (the 14-bit config's ratios)
FLAGSHIP = {"img_size": 64, "hidden_dim": 256, "codebook_splits": 2, "depth": 2, "heads": 8,
            "mlp_dim": 1024, "nclass": 1000, "input_stride": 16}
MESHES = {"fsdp2": (4, 2, 1), "fsdp2-tensor2": (2, 2, 2)}


def _jax_tree(kind):
    key = jax.random.key(0)
    if kind == "tokenizer":
        model = JaxConvVQModel.from_config(TINY_VQ)
        return jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 16, 16, 3)))["params"], key)
    model = (JaxLFQBert if kind == "lfq_bert" else JaxBert).from_config(MLM, VQ256)
    return jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, 64, 2), jnp.int32),
                                               jnp.zeros((1,), jnp.int32))["params"], key)


def _port_model(kind):
    with torch.device("meta"):
        if kind == "tokenizer":
            return ConvVQModel.from_config(TINY_VQ)
        return (LFQBert if kind == "lfq_bert" else Bert).from_config(MLM, VQ256)


def _export(kind, tree):
    if kind == "tokenizer":
        return export_tokenizer_state(tree, TINY_VQ["codebook_size"])
    return export_generator_state(tree, MLM["codebook_splits"])


def _jax_labels(spec, shape, sizes):
    """16 x (fsdp coordinate + 1) + (tensor coordinate + 1) of the ranks that
    store each element (0 for an axis the leaf is not split over)."""
    labels = np.zeros(shape, np.int64)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = [a for a in (axes if isinstance(axes, tuple) else (axes,)) if sizes[a] > 1]
        if not axes:
            continue
        n = int(np.prod([sizes[a] for a in axes]))
        rest = np.arange(shape[dim]) // (shape[dim] // n)
        for a in reversed(axes):
            coord, rest = rest % sizes[a], rest // sizes[a]
            view = [1] * len(shape)
            view[dim] = shape[dim]
            labels = labels + (coord + 1).reshape(view) * (16 if a == "fsdp" else 1)
    return labels


def _port_labels(split, shape, mesh):
    labels = torch.zeros(int(np.prod(shape)), dtype=torch.int64)
    if split is None:
        return labels.reshape(shape).numpy()
    ids = torch.arange(labels.numel()).reshape(shape)
    axes = split.axes()
    for f in range(mesh.fsdp):
        for t in range(mesh.tensor):
            piece = shard_of(ids, split, mesh, coords=(0, f, t))
            labels[piece.reshape(-1)] = (16 * (f + 1) if "fsdp" in axes else 0) + (
                t + 1 if "tensor" in axes else 0)
    return labels.reshape(shape).numpy()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kind", ["lfq_bert", "bert", "tokenizer"])
def test_param_splits_match_jax(kind, mesh_name):
    shape = MESHES[mesh_name]
    jmesh = create_mesh(JaxMeshConfig(*shape))
    sizes = dict(jmesh.shape)
    tree = _jax_tree(kind)
    specs = jax_param_shardings(tree, jmesh)
    labelled = jax.tree.map(lambda leaf, s: _jax_labels(s.spec, leaf.shape, sizes), tree, specs)
    want = _export(kind, labelled)
    model = _port_model(kind)
    mesh = MeshConfig(*shape)
    splits = param_shardings(model, mesh)
    params = dict(model.named_parameters())
    assert set(splits) <= set(params)
    for key, p in params.items():
        got = _port_labels(splits.get(key), tuple(p.shape), mesh)
        if splits.get(key) is not None and splits[key].megatron == "heads":
            # head-wise q|k|v rows: the same axes and equal shares as JAX's,
            # other elements (each rank's heads of q, k and v)
            shares = [np.unique(x, return_counts=True) for x in (got, want[key])]
            for a, b in zip(*shares):
                np.testing.assert_array_equal(a, b, err_msg=key)
            continue
        np.testing.assert_array_equal(got, want[key], err_msg=key)
    if mesh_name == "fsdp2" and kind != "tokenizer":
        assert splits["transformer.layers.0.0.mha.in_proj_weight"].spec == ((), ("fsdp",))
        # JAX leaves the top-level kernels whole (its rules want a parent module)
        assert "last_layer.0.weight" not in splits


@pytest.mark.parametrize("kind", ["lfq_bert", "bert", "tokenizer"])
def test_sharded_byte_fraction_at_least_jax(kind):
    jmesh = create_mesh(JaxMeshConfig(4, 2, 1))
    key = jax.random.key(0)
    if kind == "tokenizer":
        jmodel = JaxConvVQModel.from_config(TINY_VQ)
        params = jmodel.init(key, jnp.zeros((1, 16, 16, 3)))["params"]
    else:
        jmodel = (JaxLFQBert if kind == "lfq_bert" else JaxBert).from_config(MLM, VQ256)
        params = jmodel.init(key, jnp.zeros((1, 64, 2), jnp.int32),
                             jnp.zeros((1,), jnp.int32))["params"]
    theirs = jax_sharded_byte_fraction(jax_shard_params(params, jmesh))
    ours = sharded_byte_fraction(_port_model(kind), MeshConfig(4, 2, 1))
    assert ours >= theirs - 1e-12, (ours, theirs)
    assert ours > 0.5


@pytest.mark.parametrize("fsdp", [2, 8])
def test_flagship_proportioned_lfqbert_splits_90_percent(fsdp):
    with torch.device("meta"):
        model = LFQBert.from_config(FLAGSHIP, {"codebook_size": 16384})
    frac = sharded_byte_fraction(model, MeshConfig(1, fsdp, 1))
    assert frac >= 0.9, f"only {frac:.1%} of the parameter bytes split at fsdp={fsdp}"


def _filled(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    return module.eval()


@pytest.mark.parametrize("tensor", [2, 4])
def test_head_wise_slices_reassemble_the_attention_layer(tensor):
    e, heads, b, n = 64, 4, 2, 9
    mha = _filled(MultiHeadSelfAttention(e, heads), 0)
    # the keys of a transformer layer, for the rules
    keys = {f"transformer.layers.0.0.mha.{k}": p for k, p in mha.named_parameters()}
    splits = param_shardings({k: p.shape for k, p in keys.items()}, MeshConfig(1, 1, tensor))
    w_qkv, b_qkv = mha.in_proj_weight.detach(), mha.in_proj_bias.detach()
    w_o = mha.out_proj.weight.detach()
    s_qkv = splits["transformer.layers.0.0.mha.in_proj_weight"]
    s_b = splits["transformer.layers.0.0.mha.in_proj_bias"]
    s_o = splits["transformer.layers.0.0.mha.out_proj.weight"]
    assert (s_qkv.megatron, s_b.megatron, s_o.megatron) == ("heads", "heads", "plain")
    parts = [tensor_local(w_qkv, s_qkv, t, tensor) for t in range(tensor)]
    assert torch.equal(tensor_whole(parts, s_qkv), w_qkv)
    x = torch.randn(b, n, e, generator=torch.Generator().manual_seed(1))
    d, h = e // heads, heads // tensor
    total = torch.zeros(b, n, e)
    for t in range(tensor):
        qkv = F.linear(x, tensor_local(w_qkv, s_qkv, t, tensor), tensor_local(b_qkv, s_b, t, tensor))
        q, k, v = qkv.view(b, n, 3, h, d).unbind(2)
        # rank t's heads are heads [t h, (t + 1) h) of the whole layer
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * d**-0.5, -1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, n, h * d)
        total += F.linear(out, tensor_local(w_o, s_o, t, tensor))
    with torch.no_grad():
        want = mha(x)
    torch.testing.assert_close(total + mha.out_proj.bias.detach(), want, atol=1e-5, rtol=0)


def test_row_and_column_slices_reassemble_the_feed_forward_layer():
    tensor, e, hidden = 2, 32, 64
    ffn = _filled(BertFeedForward(e, hidden), 2)
    keys = {f"transformer.layers.0.1.{k}": p for k, p in ffn.named_parameters()}
    splits = param_shardings({k: p.shape for k, p in keys.items()}, MeshConfig(1, 1, tensor))
    fc1, _, fc2, _ = ffn.net
    s1w, s1b = splits["transformer.layers.0.1.net.0.weight"], splits["transformer.layers.0.1.net.0.bias"]
    s2w = splits["transformer.layers.0.1.net.2.weight"]
    assert "transformer.layers.0.1.net.2.bias" in splits and splits[
        "transformer.layers.0.1.net.2.bias"].megatron is None  # stored split, added whole
    x = torch.randn(3, 5, e, generator=torch.Generator().manual_seed(3))
    partial = sum(F.linear(F.gelu(F.linear(x, tensor_local(fc1.weight.detach(), s1w, t, tensor),
                                           tensor_local(fc1.bias.detach(), s1b, t, tensor))),
                           tensor_local(fc2.weight.detach(), s2w, t, tensor))
                  for t in range(tensor))
    with torch.no_grad():
        want = ffn._net(x, None)
    torch.testing.assert_close(partial + fc2.bias.detach(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_collectives_reduce_half_types_in_float32(monkeypatch, backend, dtype):
    from maskbit_tpu_torch.parallel import mesh as pm

    monkeypatch.setattr(pm.dist, "get_backend", lambda *args, **kwargs: backend)
    monkeypatch.setattr(pm, "_comm_device", lambda: torch.device("cpu"))
    seen = []

    def all_reduce(t, group=None):  # two members that hold the same tensor
        seen.append(t.dtype)
        t.add_(t.clone())

    def all_gather(out, t, group=None):
        seen.append(t.dtype)
        for o in out:
            o.copy_(t)

    def reduce_scatter(out, pieces, group=None):
        seen.append(pieces[0].dtype)
        out.copy_(pieces[0] + pieces[1])

    monkeypatch.setattr(pm.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(pm.dist, "all_gather", all_gather)
    monkeypatch.setattr(pm.dist, "reduce_scatter", reduce_scatter)
    wide = torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype
    x = torch.tensor([1.0, 3.0, -0.5, 2.0**-6], dtype=dtype)
    assert pm._staged(x).dtype == wide
    g = pm.Group("pg", (0, 1), 0)
    mean = pm.all_reduce_mean_([x.clone()], g)[0]
    summed = pm.reduce_from_group(x.clone(), g)
    gathered = pm.all_gather_flat(x, g)
    scattered = pm.reduce_scatter_flat([x, x], g)
    y = x.clone().requires_grad_()
    pm.copy_to_group(y, g).sum().backward()  # Megatron's f: the cotangents summed
    assert y.grad.dtype == dtype and torch.equal(y.grad, torch.full_like(x, 2.0))
    assert seen and all(d == wide for d in seen), seen
    for out, want in ((mean, x), (summed, 2 * x), (gathered[1], x), (scattered, 2 * x)):
        assert out.dtype == dtype and torch.equal(out, want)
