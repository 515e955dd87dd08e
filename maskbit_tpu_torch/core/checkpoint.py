"""Train-state checkpoints for resume, and bare-model weights to and from disk.

`CheckpointManager` is the counterpart of `maskbit_tpu/core/checkpoint.py`'s
(there an Orbax manager; here a torch format of the port's own, since Orbax
is not on the card's machine). Under its directory each committed step is
`{step}/state.pt`, a `torch.save` of the train state's `state_dict()` with
every tensor on the host; `metadata-{step}.json` holds `{"global_step": step}`.
A save copies the state to the host (one host copy; nothing more on the
card), then writes it on a background thread under `.tmp-{step}` and renames
that into place, so a step either is there whole or is not there. The
metadata of a step is written only after its step has committed (at the
next save, wait, restore or close), and the steps beyond `max_to_keep`,
oldest first, and their metadata are deleted.

`load_pretrained` is the counterpart of `maskbit_tpu/core/checkpoint.load_pretrained`:
a PyTorch state dict in the original repo's layout, with its legacy
`token_emb.` -> `input_proj.` rename for LFQBert, or a flax `.msgpack` of the
JAX package's (its `save_pretrained`, the zoo format), read by
`compat/msgpack` and mapped to that layout by `compat/torch_export` (a
tokenizer when it has an encoder or decoder, else a generator).
`save_pretrained` writes a `.bin` (float32 tensors on the CPU), which this
loader and the JAX package's `load_pretrained` both read; the port writes
no `.msgpack`.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

STATE_FILE = "state.pt"


def host_copy(tree: Any) -> Any:
    """`tree` with every tensor copied to the host (dicts, lists, tuples and
    scalars kept as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


class CheckpointManager:
    """Save and restore an object with `state_dict()` / `load_state_dict()`
    (a `GeneratorTrainState`), keeping the newest `max_to_keep` steps.
    `timings` records each save's host copy and write and each restore, in
    seconds."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):  # a write cut short never committed
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        self.max_to_keep = max_to_keep
        self.timings: List[dict] = []
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending_meta: Optional[Tuple[int, dict]] = None

    def all_steps(self) -> List[int]:
        """The committed steps, in ascending order."""
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit()
                      and os.path.exists(os.path.join(self.directory, n, STATE_FILE)))

    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Copy `state.state_dict()` to the host now and write it in the
        background (the next save, wait, restore or close waits for it);
        blocking=True waits here."""
        self.wait()
        t0 = time.perf_counter()
        tree = host_copy(state.state_dict())
        record = {"step": int(step), "host_copy_s": time.perf_counter() - t0}
        self.timings.append(record)
        meta = {"global_step": int(step)}
        self._writer = threading.Thread(target=self._write, args=(int(step), tree, meta, record),
                                        name=f"checkpoint-{step}")
        self._writer.start()
        if blocking:
            self.wait()

    def _write(self, step: int, tree: dict, meta: dict, record: dict) -> None:
        try:
            t0 = time.perf_counter()
            tmp = os.path.join(self.directory, f".tmp-{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(tree, f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.directory, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
            record["write_s"] = time.perf_counter() - t0
            self._pending_meta = (step, meta)
        except BaseException as e:  # raised by wait() on the caller's thread
            self._error = e

    def wait(self) -> None:
        """Block until the save in flight has committed, then write its
        metadata; raise what the write raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from error
        self._flush_metadata()

    def _flush_metadata(self) -> None:
        if self._pending_meta is None:
            return
        step, meta = self._pending_meta
        self._pending_meta = None
        with open(os.path.join(self.directory, f"metadata-{step}.json"), "w") as f:
            json.dump(meta, f)
        live = set(self.all_steps())
        for name in os.listdir(self.directory):
            if not (name.startswith("metadata-") and name.endswith(".json")):
                continue
            try:
                s = int(name[len("metadata-"):-len(".json")])
            except ValueError:
                continue
            if s not in live:
                os.remove(os.path.join(self.directory, name))

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, state: Any) -> Optional[Tuple[Any, int]]:
        """Load the newest step into `state` in place; (state, step), or
        None when no step has committed."""
        step = self.latest_step()
        if step is None:
            return None
        t0 = time.perf_counter()
        tree = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                          map_location="cpu", mmap=True, weights_only=True)
        state.load_state_dict(tree)
        self.timings.append({"restored_step": step, "restore_s": time.perf_counter() - t0})
        return state, step

    def close(self) -> None:
        self.wait()


def _state_from_msgpack(path: str) -> Dict[str, torch.Tensor]:
    """A JAX package `.msgpack` tokenizer or generator as a state dict in the
    original repo's layout; an LFQ tokenizer's buffers are rebuilt for the
    codebook of its latent width (2 ** token_size)."""
    import numpy as np

    from maskbit_tpu_torch.compat.msgpack import read_msgpack
    from maskbit_tpu_torch.compat.torch_export import (
        export_generator_state,
        export_tokenizer_state,
    )

    tree = read_msgpack(path)
    params = tree.get("params", tree)
    if "encoder" in params or "decoder" in params:
        codebook_size = None
        if "embedding" not in params.get("quantize", {}):
            codebook_size = 2 ** int(np.asarray(params["encoder"]["conv_out"]["kernel"]).shape[-1])
        state = export_tokenizer_state(params, codebook_size)
    else:
        state = export_generator_state(params)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in state.items()}


def load_pretrained(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Load a `.bin` / `.pth` / `.pt` state dict, or a JAX package
    `.msgpack`, onto `device`."""
    if path.endswith(".msgpack"):
        return {k: v.to(device) for k, v in _state_from_msgpack(path).items()}
    if not path.endswith((".bin", ".pth", ".pt")):
        raise NotImplementedError(f"{path}: neither a PyTorch state dict nor a flax .msgpack")
    state = torch.load(path, map_location=device, weights_only=True)
    if "state_dict" in state and isinstance(state["state_dict"], dict):
        state = state["state_dict"]
    return {("input_proj." + k[len("token_emb."):] if k.startswith("token_emb.") else k): v
            for k, v in state.items()}


def save_pretrained(model: nn.Module, path: str,
                    params: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    """Write `model`'s state dict as a `.bin`; `params` (name -> tensor, e.g.
    the EMA shadows) replace the model's parameters of the same names."""
    if not path.endswith(".bin"):
        raise NotImplementedError(f"{path}: the port writes `.bin` state dicts only")
    state = model.state_dict()
    if params is not None:
        missing = set(dict(model.named_parameters())) - set(params)
        if missing:
            raise KeyError(f"params lack {sorted(missing)[:5]}")
        state.update(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: (v.float() if v.is_floating_point() else v).detach().cpu()
                for k, v in state.items()}, path)
