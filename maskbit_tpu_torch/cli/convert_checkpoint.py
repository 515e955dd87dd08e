"""Convert checkpoints between the original repo's `.bin` and the JAX
package's `.msgpack` zoo format.

Forward (original repo -> zoo):
    python -m maskbit_tpu_torch.cli.convert_checkpoint \
        --input /ckpts/maskbit_tokenizer_12bit.bin --output tokenizer_12bit.msgpack

Reverse (zoo -> `pytorch_model.bin`, which the original repo and the port
load strictly):
    python -m maskbit_tpu_torch.cli.convert_checkpoint \
        --input tokenizer_12bit.msgpack --output pytorch_model.bin \
        --codebook-size 4096

Counterpart of `maskbit_tpu/cli/convert_checkpoint.py`, with its flags and
its direction rule: a `.msgpack` input is exported to a `.bin`
(`compat/torch_export`); any other input is converted to a `.msgpack`
(`compat/torch_convert`, written by `compat/msgpack` byte for byte as the
JAX CLI writes it). Tokenizer versus generator is detected from the keys
in both directions. An LFQ tokenizer's export needs `--codebook-size` to
rebuild the quantizer's buffers (nothing in its parameters encodes it);
`--codebook-splits` overrides LFQBert's shape-derived split count. A
`.bin` is read by `core.checkpoint.load_pretrained`. Two differences from
the JAX CLI: a taming tokenizer's mid block exports as CompVis names it
(`mid.block_1`, `mid.attn_1`, `mid.block_2`), which the JAX exporter
writes as `mid.block.1` and so on; and the torch input must end in `.bin`,
`.pth` or `.pt`, as `load_pretrained` asks.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _n_params(tree) -> float:
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return int(np.prod(np.shape(node)))

    return count(tree) / 1e6


def _export_torch(args) -> None:
    from maskbit_tpu_torch.compat.msgpack import read_msgpack
    from maskbit_tpu_torch.compat.torch_export import (
        export_generator_state,
        export_tokenizer_state,
    )

    variables = read_msgpack(args.input)
    params = variables.get("params", variables)
    if "transformer" in params or "pos_emb" in params:
        state = export_generator_state(variables, codebook_splits=args.codebook_splits)
        kind = "generator"
    else:
        state = export_tokenizer_state(variables, codebook_size=args.codebook_size)
        kind = "tokenizer"
    torch.save({k: torch.from_numpy(np.array(v, copy=True)) for k, v in state.items()},
               args.output)
    print(f"exported {kind} {args.input} -> {args.output} "
          f"({_n_params(variables):.1f}M params, {len(state)} torch keys)")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input", required=True,
                        help=".bin/.pth torch checkpoint or .msgpack zoo file")
    parser.add_argument("--output", required=True,
                        help=".msgpack output (import) or .bin output (export)")
    parser.add_argument("--codebook-size", type=int, default=None,
                        help="export only: LFQ tokenizer codebook size "
                             "(model.vq_model.codebook_size)")
    parser.add_argument("--codebook-splits", type=int, default=None,
                        help="export only: override the shape-derived "
                             "LFQBert codebook_splits")
    args = parser.parse_args(argv)

    if args.input.endswith(".msgpack"):
        _export_torch(args)
        return

    from maskbit_tpu_torch.compat.msgpack import sorted_tree, write_msgpack
    from maskbit_tpu_torch.compat.torch_convert import convert_state
    from maskbit_tpu_torch.core.checkpoint import load_pretrained

    variables = convert_state(load_pretrained(args.input))
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    # the JAX package's save_pretrained serializes jax.device_get's copy of
    # the tree, whose dicts are rebuilt in sorted key order
    write_msgpack(args.output, sorted_tree(variables))
    print(f"converted {args.input} -> {args.output} ({_n_params(variables):.1f}M params)")


if __name__ == "__main__":
    main()
