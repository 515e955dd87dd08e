"""Parameter counts for the train CLIs' logs (counterpart of
`maskbit_tpu/utils/params.py`, over `named_parameters`)."""

from __future__ import annotations

from torch import nn


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def summarize_params(module: nn.Module, name: str = "model") -> str:
    """The total and the count of each top-level submodule, in millions."""
    totals = {}
    for path, p in module.named_parameters():
        top = path.split(".", 1)[0]
        totals[top] = totals.get(top, 0) + p.numel()
    lines = [f"{name}: {count_params(module) / 1e6:.2f}M params"]
    lines += [f"  {key}: {totals[key] / 1e6:.3f}M" for key in sorted(totals)]
    return "\n".join(lines)
