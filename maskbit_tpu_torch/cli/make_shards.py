"""Create webdataset-format tar shards from an ImageNet directory.

    python -m maskbit_tpu_torch.cli.make_shards --data_root /data/imagenet/train \\
        --output /shards/imagenet-train-%04d.tar --maxcount 5079

Counterpart of `maskbit_tpu/cli/make_shards.py`; the shards are the same.
"""

from __future__ import annotations

import argparse

from maskbit_tpu_torch.data.shard_writer import create_sharded_dataset


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data_root", required=True, help="ImageNet split dir (synset subdirs)")
    parser.add_argument("--output", required=True, help="output pattern, e.g. out-%%04d.tar")
    parser.add_argument("--maxcount", type=int, default=5079)
    parser.add_argument("--no-shuffle", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    total = create_sharded_dataset(args.data_root, args.output, maxcount=args.maxcount,
                                   shuffle=not args.no_shuffle, seed=args.seed)
    print(f"wrote {total} samples")
    return total


if __name__ == "__main__":
    main()
