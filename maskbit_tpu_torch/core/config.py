"""Hierarchical YAML config with dotted CLI overrides and interpolation.

The port's own copy of `maskbit_tpu/core/config.py` (yaml only): YAML file
+ dotted ``key.path=value`` CLI overrides merged on top, ``${a.b.c}``
interpolation, the legacy key aliases, scientific-notation float coercion,
attribute access and ``.get(key, default)`` at every level. The two loaders
give equal trees for every shipped config (`tests/test_torch_common.py`).
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any, Iterable, Mapping, Optional

import yaml

_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
# Reference config keys that were renamed ("gpu" -> "device"). Normalized
# in load_config so the reference repo's YAML files (and dotted CLI
# overrides written against them) work verbatim.
_LEGACY_KEY_ALIASES = {
    "training.per_gpu_batch_size": "training.per_device_batch_size",
    "dataset.params.num_workers_per_gpu": "dataset.params.num_workers_per_device",
}
# YAML 1.1 fails to parse "1e-4" as a float (requires "1.0e-4"); coerce such
# scientific-notation strings the way OmegaConf does.
_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce_tree(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _coerce_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_tree(v) for v in node]
    if isinstance(node, str) and _FLOAT_RE.match(node):
        return float(node)
    return node


class Config:
    """A nested attribute-access view over a plain dict tree.

    Leaves are plain Python values; nested mappings are wrapped lazily in
    `Config` on access.  Mutation via attribute or item assignment is
    supported so trainers can fill in derived fields.
    """

    __slots__ = ("_data",)

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_data", dict(data) if data else {})

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return _wrap(self._data[key])

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def values(self):
        return (_wrap(v) for v in self._data.values())

    def items(self):
        return ((k, _wrap(v)) for k, v in self._data.items())

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return _wrap(self._data[key])
        return default

    # -- attribute protocol -----------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return _wrap(self._data[key])
        except KeyError as e:
            raise AttributeError(f"Config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    # -- utilities ----------------------------------------------------------
    def to_dict(self) -> dict:
        return copy.deepcopy(self._data)

    def select(self, dotted: str, default: Any = None) -> Any:
        """Look up a dotted path like ``model.vq_model.token_size``."""
        node: Any = self._data
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return _wrap(node)

    def update_dotted(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self._data
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise TypeError(f"Cannot set {dotted}: {part} is a leaf")
        node[parts[-1]] = _unwrap(value)

    def merge(self, other: "Config | Mapping[str, Any]") -> "Config":
        """Deep-merge `other` on top of self, returning a new Config."""
        merged = _deep_merge(self.to_dict(), _unwrap(other))
        return Config(merged)

    def __repr__(self) -> str:
        return f"Config({json.dumps(self._data, default=str, indent=2)})"

    def save_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _wrap(value: Any) -> Any:
    if isinstance(value, dict):
        return Config(value)
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value.to_dict()
    if isinstance(value, dict):
        return {k: _unwrap(v) for k, v in value.items()}
    return value


def _deep_merge(base: dict, override: Mapping[str, Any]) -> dict:
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, Mapping):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _parse_cli_value(raw: str) -> Any:
    """Parse a CLI override value using YAML scalar rules."""
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def _resolve_interpolations(tree: dict) -> dict:
    """Resolve ``${a.b.c}`` references against the root of the tree."""

    def lookup(path: str) -> Any:
        node: Any = tree
        for part in path.split("."):
            node = node[part]
        return node

    def resolve(node: Any, seen: frozenset) -> Any:
        if isinstance(node, dict):
            return {k: resolve(v, seen) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v, seen) for v in node]
        if isinstance(node, str):
            m = _INTERP_RE.match(node.strip())
            if m:
                path = m.group(1)
                if path in seen:
                    raise ValueError(f"Circular interpolation at ${{{path}}}")
                return resolve(lookup(path), seen | {path})
        return node

    return resolve(tree, frozenset())


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Iterable[str]] = None,
    base: Optional[Mapping[str, Any]] = None,
) -> Config:
    """Load a YAML config and merge dotted CLI overrides.

    Args:
        path: YAML file path. Optional if `base` is given.
        overrides: iterable of ``a.b.c=value`` strings (also accepts a single
            leading ``config=<path>`` which is ignored, matching the
            reference CLI convention).
        base: base mapping merged underneath the file contents.
    """
    tree: dict = dict(base) if base else {}
    if path is not None:
        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        tree = _deep_merge(tree, loaded)

    # Normalize file keys before overrides so a CLI override always wins
    # (OmegaConf last-wins semantics), whichever spelling either side uses.
    tree = _apply_legacy_aliases(tree)
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"Override {item!r} must look like key.path=value")
        key, _, raw = item.partition("=")
        key = key.strip()
        if key == "config":
            continue
        key = _LEGACY_KEY_ALIASES.get(key, key)
        cfg = Config(tree)
        cfg.update_dotted(key, _parse_cli_value(raw.strip()))
        tree = cfg.to_dict()

    tree = _resolve_interpolations(_coerce_tree(tree))
    return Config(tree)


def _apply_legacy_aliases(tree: dict) -> dict:
    """Move renamed reference keys onto their new names (new name wins)."""

    def node_at(path: list) -> Any:
        node: Any = tree
        for part in path:
            if not isinstance(node, dict) or part not in node:
                return None
            node = node[part]
        return node

    for old, new in _LEGACY_KEY_ALIASES.items():
        *old_parents, old_leaf = old.split(".")
        parent = node_at(old_parents)
        if not isinstance(parent, dict) or old_leaf not in parent:
            continue
        value = parent.pop(old_leaf)
        *new_parents, new_leaf = new.split(".")
        new_parent: Any = tree
        for part in new_parents:
            new_parent = new_parent.setdefault(part, {})
        new_parent.setdefault(new_leaf, value)
    return tree


def config_from_cli(argv: Iterable[str]) -> Config:
    """Reference-style CLI: ``script config=path/to.yaml a.b=1 c.d=2``."""
    argv = list(argv)
    path = None
    for item in argv:
        if item.startswith("config="):
            path = item.split("=", 1)[1]
            break
    if path is None:
        raise ValueError("Expected a config=<path.yaml> argument")
    return load_config(path, overrides=[a for a in argv if not a.startswith("config=")])
