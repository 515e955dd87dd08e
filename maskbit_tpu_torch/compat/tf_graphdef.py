"""TF1 frozen graph (GraphDef .pb) -> the port's InceptionV3 state dict.

Counterpart of `maskbit_tpu/compat/tf_graphdef.py`, as the port's own copy:
the network of the ADM suite's headline gFID is the OpenAI
`classify_image_graph_def.pb` InceptionV3 frozen graph; the pt-fid weights
were converted from it but are not byte-identical. This module reads the
graph's weights with no TensorFlow:
  * a minimal protobuf wire-format decoder for the GraphDef, NodeDef,
    AttrValue and TensorProto subset the graph uses, and
  * a structural walker over the dataflow graph that does not rely on node
    names: conv units (Conv2D -> batch norm -> Relu) are found by topology,
    blocks by their concat nodes, branches by the concat's input order (which
    fixes the order of the output channels). Every tensor is checked
    against the shape `eval/inception.InceptionV3` expects, so a mis-ordered
    mapping fails instead of giving wrong features.
`extract_inception_state` yields the state dict of `InceptionV3` (pt-fid /
torchvision layout) directly. The graph's batch-norm epsilon is folded into
`running_var` so the module's fixed 1e-3 stays exact; the softmax head's
MatMul weight becomes `fc.weight` (the ADM head uses no bias: `fc.bias` is
zero). `MASKBIT_ADM_PB` (`cli.eval_tokenizer.make_inception_fn`) takes
precedence over `MASKBIT_INCEPTION_WEIGHTS`.

    python -m maskbit_tpu_torch.compat.tf_graphdef graph.pb inception_adm.pth

writes the state dict as a torch `.pth` that `MASKBIT_INCEPTION_WEIGHTS`
loads (the JAX package's `main` writes a `.msgpack`).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from maskbit_tpu_torch.eval.inception import InceptionV3

# ---------------------------------------------------------------------------
# protobuf wire format
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_FIXED64 = 1
_WIRE_BYTES = 2
_WIRE_FIXED32 = 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) — value is int for varint/
    fixed and bytes for length-delimited."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _WIRE_VARINT:
            value, pos = _read_varint(buf, pos)
        elif wire == _WIRE_FIXED64:
            value = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == _WIRE_BYTES:
            size, pos = _read_varint(buf, pos)
            value = buf[pos:pos + size]
            pos += size
        elif wire == _WIRE_FIXED32:
            value = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, value


# tensorflow DataType enum -> numpy (the subset frozen inference graphs use)
_DTYPES = {
    1: np.dtype(np.float32),   # DT_FLOAT
    2: np.dtype(np.float64),   # DT_DOUBLE
    3: np.dtype(np.int32),     # DT_INT32
    4: np.dtype(np.uint8),     # DT_UINT8
    6: np.dtype(np.int8),      # DT_INT8
    9: np.dtype(np.int64),     # DT_INT64
    10: np.dtype(np.bool_),    # DT_BOOL
}


def _parse_shape(buf: bytes) -> List[int]:
    """TensorShapeProto: repeated Dim dim = 2 {int64 size = 1}."""
    dims = []
    for field, _, value in _iter_fields(buf):
        if field == 2:  # dim
            size = 0
            for f2, _, v2 in _iter_fields(value):
                if f2 == 1:
                    # zigzag NOT used: size is a plain int64 varint
                    size = v2 if v2 < (1 << 63) else v2 - (1 << 64)
            dims.append(size)
    return dims


def _unpack_scalars(value, wire: int, fmt: str, out: list) -> None:
    """Repeated scalar field: packed (length-delimited) or one-at-a-time."""
    if wire == _WIRE_BYTES:
        size = struct.calcsize(fmt)
        out.extend(struct.unpack(f"<{len(value) // size}{fmt}", value))
    else:
        out.append(struct.unpack("<f" if fmt == "f" else "<d",
                                 struct.pack("<I" if fmt == "f" else "<Q", value))[0])


def _parse_tensor(buf: bytes) -> np.ndarray:
    """TensorProto -> numpy array (tensor_content or typed *_val fields)."""
    dtype_enum = 1
    shape: List[int] = []
    content: Optional[bytes] = None
    float_vals: List[float] = []
    double_vals: List[float] = []
    int_vals: List[int] = []
    int64_vals: List[int] = []
    bool_vals: List[int] = []
    for field, wire, value in _iter_fields(buf):
        if field == 1:
            dtype_enum = value
        elif field == 2:
            shape = _parse_shape(value)
        elif field == 4:
            content = value
        elif field == 5:  # float_val
            _unpack_scalars(value, wire, "f", float_vals)
        elif field == 6:  # double_val
            _unpack_scalars(value, wire, "d", double_vals)
        elif field in (7, 10, 11):  # int_val / int64_val / bool_val (varints)
            target = {7: int_vals, 10: int64_vals, 11: bool_vals}[field]
            if wire == _WIRE_BYTES:  # packed
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    target.append(v)
            else:
                target.append(value)
    if dtype_enum not in _DTYPES:
        raise ValueError(f"unsupported TensorProto dtype enum {dtype_enum}")
    dtype = _DTYPES[dtype_enum]
    count = int(np.prod(shape)) if shape else 1
    if content is not None:
        arr = np.frombuffer(content, dtype=dtype)
    else:
        vals = {np.dtype(np.float32): float_vals, np.dtype(np.float64): double_vals,
                np.dtype(np.int32): int_vals, np.dtype(np.int64): int64_vals,
                np.dtype(np.bool_): bool_vals}.get(dtype, int_vals)
        arr = np.asarray(vals, dtype=dtype)
        if arr.size < count:
            # TF semantics: remaining elements repeat the LAST value
            fill = arr[-1] if arr.size else np.zeros((), dtype)
            arr = np.concatenate([arr, np.full(count - arr.size, fill, dtype)])
    return arr.reshape(shape)


def _parse_attr_value(buf: bytes) -> Dict[str, object]:
    """AttrValue: the oneof subset we need (s=2, i=3, f=4, b=5, tensor=8)."""
    out: Dict[str, object] = {}
    for field, wire, value in _iter_fields(buf):
        if field == 2:
            out["s"] = value
        elif field == 3:
            out["i"] = value if value < (1 << 63) else value - (1 << 64)
        elif field == 4:
            out["f"] = struct.unpack("<f", struct.pack("<I", value))[0]
        elif field == 5:
            out["b"] = bool(value)
        elif field == 6:
            out["type"] = value
        elif field == 8:
            out["tensor"] = _parse_tensor(value)
    return out


class NodeDef:
    __slots__ = ("name", "op", "inputs", "attrs")

    def __init__(self, name: str, op: str, inputs: List[str],
                 attrs: Dict[str, Dict[str, object]]):
        self.name = name
        self.op = op
        self.inputs = inputs
        self.attrs = attrs

    def __repr__(self):
        return f"NodeDef({self.name!r}, op={self.op!r})"


def _parse_node(buf: bytes) -> NodeDef:
    name = op = ""
    inputs: List[str] = []
    attrs: Dict[str, Dict[str, object]] = {}
    for field, _, value in _iter_fields(buf):
        if field == 1:
            name = value.decode("utf-8")
        elif field == 2:
            op = value.decode("utf-8")
        elif field == 3:
            inputs.append(value.decode("utf-8"))
        elif field == 5:  # attr map entry {1: key, 2: AttrValue}
            key, attr = "", {}
            for f2, _, v2 in _iter_fields(value):
                if f2 == 1:
                    key = v2.decode("utf-8")
                elif f2 == 2:
                    attr = _parse_attr_value(v2)
            attrs[key] = attr
    return NodeDef(name, op, inputs, attrs)


def parse_graphdef(data: bytes) -> List[NodeDef]:
    """GraphDef bytes -> list of NodeDef (field 1, repeated)."""
    return [_parse_node(value) for field, _, value in _iter_fields(data)
            if field == 1]


# ---------------------------------------------------------------------------
# structural InceptionV3 extraction
# ---------------------------------------------------------------------------

_TRANSPARENT = {"Identity", "CheckNumerics", "StopGradient", "Relu"}
_POOL_OPS = {"MaxPool", "AvgPool"}
_CONCAT_OPS = {"Concat", "ConcatV2"}
_BN_OPS = {"BatchNormWithGlobalNormalization", "FusedBatchNorm", "FusedBatchNormV3"}

_BN_EPS = 1e-3  # eval/inception.BasicConv2d's fixed epsilon


def _base_name(ref: str) -> str:
    """'name:0' -> 'name'; control deps ('^name') have no data edge."""
    return ref.split(":")[0]


class _Graph:
    def __init__(self, nodes: List[NodeDef]):
        self.nodes = nodes
        self.by_name = {n.name: n for n in nodes}
        self.consumers: Dict[str, List[NodeDef]] = {}
        for n in nodes:
            for ref in n.inputs:
                if ref.startswith("^"):
                    continue
                self.consumers.setdefault(_base_name(ref), []).append(n)

    def producer(self, ref: str) -> NodeDef:
        return self.by_name[_base_name(ref)]

    def const_value(self, ref: str) -> np.ndarray:
        """Resolve a tensor reference to its Const value (through Identity)."""
        node = self.producer(ref)
        while node.op == "Identity":
            node = self.producer(node.inputs[0])
        if node.op != "Const" or "tensor" not in node.attrs.get("value", {}):
            raise ValueError(f"expected a Const at {ref!r}, got {node}")
        return np.asarray(node.attrs["value"]["tensor"])

    def data_consumers(self, node: NodeDef) -> List[NodeDef]:
        """Consumers of the node's output, skipping THROUGH transparent ops
        other than Relu (Relu terminates a conv unit; callers pass the Relu
        node itself)."""
        out = []
        for c in self.consumers.get(node.name, []):
            if c.op in ("Identity", "CheckNumerics", "StopGradient"):
                out.extend(self.data_consumers(c))
            else:
                out.append(c)
        return out

    def concat_value_inputs(self, node: NodeDef) -> List[str]:
        if node.op == "Concat":     # inputs: [dim, values...]
            return node.inputs[1:]
        return node.inputs[:-1]     # ConcatV2: [values..., axis]


def _conv_unit(g: _Graph, conv: NodeDef) -> Tuple[Dict[str, np.ndarray], NodeDef]:
    """Conv2D node -> (BasicConv2d state-dict leaves, unit-output node).

    The unit is conv -> batchnorm -> relu; the BN's variance_epsilon is
    folded into running_var so the module's fixed 1e-3 stays exact."""
    if conv.op != "Conv2D":
        raise ValueError(f"expected Conv2D, got {conv}")
    kernel = g.const_value(conv.inputs[1])  # TF filters are HWIO
    if kernel.ndim != 4:
        raise ValueError(f"conv kernel at {conv.name} has shape {kernel.shape}")
    out_ch = kernel.shape[3]

    node = conv
    consumers = g.data_consumers(node)
    if len(consumers) != 1 or consumers[0].op not in _BN_OPS:
        raise ValueError(
            f"conv {conv.name}: expected a single batchnorm consumer, got "
            f"{[c.op for c in consumers]}")
    bn = consumers[0]
    if bn.op == "BatchNormWithGlobalNormalization":
        # inputs: t, mean, variance, beta, gamma
        mean = g.const_value(bn.inputs[1])
        var = g.const_value(bn.inputs[2])
        beta = g.const_value(bn.inputs[3])
        if bn.attrs.get("scale_after_normalization", {}).get("b", False):
            gamma = g.const_value(bn.inputs[4])
        else:
            gamma = np.ones(out_ch, np.float32)
        eps = float(bn.attrs.get("variance_epsilon", {}).get("f", _BN_EPS))
    else:  # FusedBatchNorm(V3): x, scale, offset, mean, variance
        gamma = g.const_value(bn.inputs[1])
        beta = g.const_value(bn.inputs[2])
        mean = g.const_value(bn.inputs[3])
        var = g.const_value(bn.inputs[4])
        eps = float(bn.attrs.get("epsilon", {}).get("f", _BN_EPS))

    relu_consumers = g.data_consumers(bn)
    if len(relu_consumers) != 1 or relu_consumers[0].op != "Relu":
        raise ValueError(f"batchnorm {bn.name}: expected a single Relu consumer")
    relu = relu_consumers[0]

    leaves = {
        "conv.weight": np.asarray(kernel, np.float32).transpose(3, 2, 0, 1),  # OIHW
        "bn.weight": np.asarray(gamma, np.float32).reshape(out_ch),
        "bn.bias": np.asarray(beta, np.float32).reshape(out_ch),
        "bn.running_mean": np.asarray(mean, np.float32).reshape(out_ch),
        # fold the graph's epsilon so 1 / sqrt(var' + 1e-3) == 1 / sqrt(var + eps)
        "bn.running_var": np.asarray(var, np.float64).reshape(out_ch).astype(np.float32)
        + np.float32(eps - _BN_EPS),
        "bn.num_batches_tracked": np.zeros((), np.int64),
    }
    return leaves, relu


# Expected branch structure per block type, in CONCAT INPUT ORDER (matches
# torchvision/pt-fid because the TF graph fixes output-channel order through
# its concats; eval/inception.py InceptionA..E concatenate identically).
# A nested list marks an inner concat (the E blocks' 2a/2b splits); () is
# the conv-free pool branch of the reduction blocks.
_BLOCK_SPECS: Dict[str, List] = {
    "A": [("branch1x1",), ("branch5x5_1", "branch5x5_2"),
          ("branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
          ("branch_pool",)],
    "B": [("branch3x3",),
          ("branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"), ()],
    "C": [("branch1x1",), ("branch7x7_1", "branch7x7_2", "branch7x7_3"),
          ("branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
           "branch7x7dbl_4", "branch7x7dbl_5"), ("branch_pool",)],
    "D": [("branch3x3_1", "branch3x3_2"),
          ("branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"),
          ()],
    "E": [("branch1x1",),
          ("branch3x3_1", [("branch3x3_2a",), ("branch3x3_2b",)]),
          ("branch3x3dbl_1", "branch3x3dbl_2",
           [("branch3x3dbl_3a",), ("branch3x3dbl_3b",)]),
          ("branch_pool",)],
}

_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
         "Conv2d_3b_1x1", "Conv2d_4a_3x3")
_BLOCKS = (("Mixed_5b", "A"), ("Mixed_5c", "A"), ("Mixed_5d", "A"),
           ("Mixed_6a", "B"),
           ("Mixed_6b", "C"), ("Mixed_6c", "C"), ("Mixed_6d", "C"),
           ("Mixed_6e", "C"),
           ("Mixed_7a", "D"), ("Mixed_7b", "E"), ("Mixed_7c", "E"))


def _has_conv_ancestor(g: _Graph, node: NodeDef, memo: Dict[str, bool]) -> bool:
    if node.name in memo:
        return memo[node.name]
    memo[node.name] = False  # cycle guard (graphs are acyclic anyway)
    found = False
    for ref in node.inputs:
        if ref.startswith("^"):
            continue
        parent = g.producer(ref)
        if parent.op == "Conv2D" or _has_conv_ancestor(g, parent, memo):
            found = True
            break
    memo[node.name] = found
    return found


def _walk_branch_back(g: _Graph, ref: str, stop: str) -> List:
    """Walk a concat input backwards to the block input `stop`, collecting
    items in FORWARD order: ('unit', conv_name, leaves) for a conv unit, or
    ('concat', [sub_chains...]) for a nested concat (E blocks).

    Nested-concat sub-branches share their prefix convs (both 2a and 2b sit
    on branch3x3_1's output); the shared prefix is factored OUT of the
    nested item so each conv unit appears exactly once."""
    items: List = []
    node = g.producer(ref)
    while True:
        if node.name == stop:
            return items
        if node.op in ("Identity", "CheckNumerics", "StopGradient"):
            node = g.producer(node.inputs[0])
        elif node.op == "Relu":
            bn = g.producer(node.inputs[0])
            if bn.op not in _BN_OPS:
                raise ValueError(f"Relu {node.name}: expected batchnorm input")
            conv = g.producer(bn.inputs[0])
            leaves, _ = _conv_unit(g, conv)
            items.insert(0, ("unit", conv.name, leaves))
            node = g.producer(conv.inputs[0])
        elif node.op in _POOL_OPS:
            node = g.producer(node.inputs[0])
        elif node.op in _CONCAT_OPS:
            subs = [_walk_branch_back(g, r, stop)
                    for r in g.concat_value_inputs(node)]
            k = 0  # factor the common prefix (shared upstream convs)
            while (all(len(s) > k for s in subs)
                   and all(s[k][0] == "unit" for s in subs)
                   and len({s[k][1] for s in subs}) == 1):
                k += 1
            return subs[0][:k] + [("concat", [s[k:] for s in subs])] + items
        else:
            raise ValueError(
                f"unexpected op {node.op!r} ({node.name}) walking a branch")


def _match_branch(branch_items: List, spec, out: Dict[str, dict],
                  block_name: str) -> None:
    """Assign a walked branch's items to the spec's module names."""
    flat_spec = list(spec)
    if len(branch_items) != len(flat_spec):
        raise ValueError(
            f"{block_name}: branch has {len(branch_items)} units, "
            f"expected {len(flat_spec)} ({flat_spec})")
    for item, name in zip(branch_items, flat_spec):
        if isinstance(name, list):  # nested concat (E blocks)
            if item[0] != "concat" or len(item[1]) != len(name):
                raise ValueError(f"{block_name}: nested concat mismatch")
            for sub_items, sub_spec in zip(item[1], name):
                _match_branch(sub_items, sub_spec, out, block_name)
        else:
            if item[0] != "unit":
                raise ValueError(f"{block_name}: unexpected nested concat")
            out[name] = item[2]


def extract_inception_state(pb: "bytes | str",
                            num_classes: int = 1008) -> Dict[str, torch.Tensor]:
    """classify_image_graph_def.pb (path or bytes) -> the state dict of
    eval/inception.InceptionV3. Raises with the offending node on any
    structural or shape mismatch."""
    if isinstance(pb, str):
        with open(pb, "rb") as f:
            pb = f.read()
    g = _Graph(parse_graphdef(pb))

    params: Dict[str, dict] = {}  # module name -> its leaves

    # --- stem: the conv with no conv ancestor starts the linear chain
    memo: Dict[str, bool] = {}
    starts = [n for n in g.nodes
              if n.op == "Conv2D" and not _has_conv_ancestor(g, n, memo)]
    if len(starts) != 1:
        raise ValueError(f"expected one stem conv, found {[n.name for n in starts]}")
    node = starts[0]
    for i, name in enumerate(_STEM):
        unit, out_node = _conv_unit(g, node)
        params[name] = unit
        consumers = g.data_consumers(out_node)
        while len(consumers) == 1 and consumers[0].op in _POOL_OPS:
            consumers = g.data_consumers(consumers[0])
        if i + 1 < len(_STEM):
            if len(consumers) != 1 or consumers[0].op != "Conv2D":
                raise ValueError(f"stem after {name}: expected one Conv2D, got "
                                 f"{[c.op for c in consumers]}")
            node = consumers[0]
        else:
            block_input = out_node  # pools are transparent in branch walks

    # --- blocks: concat-terminated branch bundles
    for block_name, block_type in _BLOCKS:
        # any forward path from the block input reaches the block's concat;
        # a nested (E-block) concat feeds the block concat directly
        probe = g.data_consumers(block_input)
        while len(probe) == 1 and probe[0].op in _POOL_OPS:
            block_input = probe[0]  # inter-block pool (the stem's pool_1)
            probe = g.data_consumers(block_input)
        if len(probe) < 2:
            raise ValueError(f"{block_name}: block input fans out to "
                             f"{[c.op for c in probe]}")
        seen = set()
        cursor = probe[0]
        while cursor.op not in _CONCAT_OPS:
            if cursor.name in seen:
                raise ValueError(f"{block_name}: loop hunting for concat")
            seen.add(cursor.name)
            nxt = g.data_consumers(cursor)
            if not nxt:
                raise ValueError(f"{block_name}: dead end at {cursor.name}")
            cursor = nxt[0]
        while True:
            outer = [c for c in g.data_consumers(cursor) if c.op in _CONCAT_OPS]
            if not outer:
                break
            cursor = outer[0]
        concat = cursor

        spec = _BLOCK_SPECS[block_type]
        values = g.concat_value_inputs(concat)
        if len(values) != len(spec):
            raise ValueError(f"{block_name}: concat has {len(values)} inputs, "
                             f"expected {len(spec)}")
        block_params: Dict[str, dict] = {}
        for ref, branch_spec in zip(values, spec):
            units = _walk_branch_back(g, ref, block_input.name)
            _match_branch(units, branch_spec, block_params, block_name)
        for name, leaves in block_params.items():
            params[f"{block_name}.{name}"] = leaves
        block_input = concat

    # --- softmax head: the MatMul whose weight is a (2048, num_classes) Const
    fc = None
    for n in g.nodes:
        if n.op != "MatMul" or len(n.inputs) < 2:
            continue
        try:
            w = g.const_value(n.inputs[1])
        except (ValueError, KeyError):
            continue
        if w.ndim == 2 and w.shape[0] == 2048:
            fc = w
            break
    if fc is None:
        raise ValueError("no (2048, num_classes) MatMul weight found")
    if fc.shape[1] != num_classes:
        raise ValueError(f"softmax weight has shape {fc.shape}, expected "
                         f"(2048, {num_classes})")
    state = {f"{module}.{leaf}": value for module, leaves in params.items()
             for leaf, value in leaves.items()}
    state["fc.weight"] = np.asarray(fc, np.float32).T
    state["fc.bias"] = np.zeros(num_classes, np.float32)  # the ADM head uses no bias
    _validate_shapes(state, num_classes)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in state.items()}


def _validate_shapes(state: Dict[str, np.ndarray], num_classes: int) -> None:
    """Every entry must match the module's state dict exactly."""
    with torch.device("meta"):
        expected = {k: tuple(v.shape) for k, v in
                    InceptionV3(num_classes=num_classes).state_dict().items()}
    got = {k: tuple(np.shape(v)) for k, v in state.items()}
    missing, extra = sorted(set(expected) - set(got)), sorted(set(got) - set(expected))
    if missing or extra:
        raise ValueError(f"state dict mismatch: missing={missing[:8]} extra={extra[:8]}")
    for key, shape in expected.items():
        if got[key] != shape:
            raise ValueError(f"{key}: extracted shape {got[key]}, model expects {shape}")


def main(argv=None) -> None:
    """Convert a frozen-graph pb to a torch `.pth` in the pt-fid layout:
    python -m maskbit_tpu_torch.compat.tf_graphdef graph.pb inception_adm.pth
    """
    import os
    import sys

    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 2:
        raise SystemExit(main.__doc__)
    state = extract_inception_state(args[0])
    os.makedirs(os.path.dirname(os.path.abspath(args[1])), exist_ok=True)
    torch.save(state, args[1])
    print(f"wrote {args[1]}")


if __name__ == "__main__":
    main()
