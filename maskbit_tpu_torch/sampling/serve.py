"""One sampler batch split over the devices of one host, one worker process
per device.

Counterpart of `maskbit_tpu/sampling/serve.py` (`make_sharded_sampler`),
where one jit generates on every local chip with the weights replicated and
the batch on the data axis. Here:
  * one worker process per entry of `devices` (a list that names a device
    twice gets two), started with the `spawn` context (the caller may hold
    CUDA state). Each holds its own replica of both models and its own CUDA
    context, so no kernel launch waits on another replica's interpreter;
  * the replicas hold the caller's weights: one CPU copy of each model,
    its tensors in shared memory (one flat buffer a dtype), goes to every
    worker, which copies it to its device; nothing is initialised again;
  * the CUDA kernels are built in the caller before the workers start
    (`nn/cuda_build.build_all`); each worker loads them at start-up, so a
    build that fails raises in the caller;
  * the batch in contiguous blocks of `b / len(devices)` rows, the layout of
    JAX's `batch_sharding`; the batch must divide;
  * injected draws split by the same rows; otherwise shard i draws from a
    `torch.Generator` on its device seeded with `derive_seed(base, i)`,
    `base` one draw of the caller's generator, so a run over N devices
    draws other values than one device does, and the same for the same
    seed and N;
  * labels and draws go out once a call; images and tokens come back and
    are concatenated in row order on `devices[0]`;
  * a worker that dies, or does not answer within `timeout` seconds, makes
    the call raise and closes the sampler (every worker is stopped; later
    calls raise). An error raised inside the workers is raised in the
    caller, and the workers stay up;
  * `close()` stops the workers; so do the sampler's garbage collection and
    the caller's exit, and a worker whose caller is gone stops by itself;
  * `launch_counts()`: each worker's kernel launches (`attention_block` and
    `dropout_attention`'s counters, which count in the process that
    launches), read in the worker; after `close()`, as they stood then.
`local_devices(device)` lists the devices a host splits over, as
`jax.local_devices()` does for the JAX server.
"""

from __future__ import annotations

import copy
import itertools
import multiprocessing as mp
import os
import time
import traceback
import weakref
from multiprocessing.connection import wait
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.multiprocessing  # noqa: F401 — tensors cross pipes through shared memory

from maskbit_tpu_torch.nn import attention_block
from maskbit_tpu_torch.sampling.sample import SamplingConfig, make_sampler

# how long a worker may take to start, or to answer a call (s)
DEFAULT_TIMEOUT = 600.0
_CLOSE_TIMEOUT = 30.0


def local_devices(device) -> List[torch.device]:
    """Every visible CUDA card for an unindexed "cuda", else `[device]`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def _canonical(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def derive_seed(base: int, index: int) -> int:
    """A 63-bit generator seed from (base, index): a shard's from the
    caller's draw, or a serving chunk's from its request's seed."""
    words = np.random.SeedSequence([int(base) & (2**64 - 1), int(index)]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])


def _shared_cpu_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A CPU copy of `module` whose parameters and buffers are views of one
    flat shared-memory tensor a dtype (tied tensors stay tied), so a worker
    maps the weights instead of receiving them through a pipe."""
    tensors = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        tensors.setdefault(id(t), t)
    by_dtype: dict = {}
    for t in tensors.values():
        by_dtype.setdefault(t.dtype, []).append(t)
    memo = {}
    with torch.no_grad():
        for dtype, group in by_dtype.items():
            flat = torch.empty(sum(t.numel() for t in group), dtype=dtype).share_memory_()
            offset = 0
            for t in group:
                view = flat[offset:offset + t.numel()].view(t.shape)
                view.copy_(t)
                offset += t.numel()
                memo[id(t)] = (torch.nn.Parameter(view, t.requires_grad)
                               if isinstance(t, torch.nn.Parameter) else view)
    return copy.deepcopy(module, memo)


def _worker(device: str, conn, threads: int) -> None:
    """A worker's life: take the models, move them to `device`, load the
    kernels, say "ready", then answer ("sample", labels, seed, injected),
    ("launches", reset), ("state",) and ("close",) until closed or until the
    caller's end of the pipe goes away."""
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            from maskbit_tpu_torch.nn import cuda_build

            torch.cuda.set_device(dev)
            for name in cuda_build.sources():
                cuda_build.load_library(name)
        generator, tokenizer, cfg = conn.recv()
        generator, tokenizer = generator.to(dev), tokenizer.to(dev)
        sampler = make_sampler(generator, tokenizer, cfg)
        conn.send(("ok", os.getpid()))
    except Exception:  # noqa: BLE001 — raised in the caller
        conn.send(("error", traceback.format_exc()))
        return
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):  # the caller is gone
            return
        try:
            if msg[0] == "sample":
                _, labels, seed, injected = msg
                gen = None if seed is None else torch.Generator(device=dev).manual_seed(seed)
                if injected is not None:
                    injected = tuple(x.to(dev) for x in injected)
                images, tokens = sampler(labels.to(dev), gen, injected)
                reply = ("ok", (images.cpu(), tokens.cpu()))
            elif msg[0] == "launches":
                reply = ("ok", attention_block.launch_counts())
                if msg[1]:
                    attention_block.reset_launch_counts()
            elif msg[0] == "state":
                reply = ("ok", tuple({k: v.cpu() for k, v in m.state_dict().items()}
                                     for m in (generator, tokenizer)))
            elif msg[0] == "close":
                conn.send(("ok", attention_block.launch_counts()))
                return
            else:
                reply = ("error", f"unknown request {msg[0]!r}")
        except Exception:  # noqa: BLE001 — raised in the caller; the worker stays up
            reply = ("error", traceback.format_exc())
        conn.send(reply)


def _stop(procs, conns) -> None:
    """Kill what is still running and close the pipes (also the finaliser)."""
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=_CLOSE_TIMEOUT)
    for c in conns:
        c.close()


class ShardedSampler:
    """(images, tokens) = sampler(labels, generator=None, injected=None)
    over worker processes; see the module docstring."""

    def __init__(self, generator_model, tokenizer, cfg: SamplingConfig, devices: Sequence,
                 timeout: float = DEFAULT_TIMEOUT):
        self.devices = [_canonical(d) for d in devices]
        if not self.devices:
            raise ValueError("make_sharded_sampler needs at least one device")
        self.timeout = float(timeout)
        self._closed_counts: Optional[list] = None
        if any(d.type == "cuda" for d in self.devices):
            from maskbit_tpu_torch.nn import cuda_build

            cuda_build.build_all()  # once here, not once a worker
        ctx = mp.get_context("spawn")
        threads = max(1, torch.get_num_threads() // len(self.devices))
        self._procs, self._conns = [], []
        self._finalizer = weakref.finalize(self, _stop, self._procs, self._conns)
        for d in self.devices:
            ours, theirs = ctx.Pipe()
            proc = ctx.Process(target=_worker, args=(str(d), theirs, threads), daemon=True,
                               name=f"sampler-{d}")
            proc.start()
            theirs.close()
            self._procs.append(proc)
            self._conns.append(ours)
        try:
            payload = (_shared_cpu_copy(generator_model), _shared_cpu_copy(tokenizer), cfg)
            self.pids = self._ask_all(None, payload=payload)
        except BaseException:  # a worker that failed to start: stop them all
            self._finalizer()
            raise

    # ------------------------------------------------------------ plumbing
    def _fail(self, why: str):
        self._closed_counts = self._closed_counts or []
        self._finalizer()
        raise RuntimeError(f"split sampler: {why}; its workers are stopped")

    def _ask_all(self, requests, payload=None) -> list:
        """Send each worker its request (or `payload`, at start-up) and
        return the answers in worker order; raises as the module docstring
        says."""
        if not self._finalizer.alive:
            raise RuntimeError("split sampler is closed")
        n = len(self._procs)
        for i, conn in enumerate(self._conns):
            try:
                conn.send(payload if requests is None else requests[i])
            except (BrokenPipeError, OSError):
                self._fail(f"worker {i} on {self.devices[i]} is gone "
                           f"(exit code {self._procs[i].exitcode})")
        deadline = time.monotonic() + self.timeout
        replies: dict = {}
        while len(replies) < n:
            rest = deadline - time.monotonic()
            waiting = [i for i in range(n) if i not in replies]
            if rest <= 0:
                self._fail(f"workers {waiting} gave no answer within {self.timeout:g} s")
            ready = wait([self._conns[i] for i in waiting]
                         + [self._procs[i].sentinel for i in waiting], rest)
            for i in waiting:
                conn = self._conns[i]
                if conn in ready or conn.poll():
                    try:
                        replies[i] = conn.recv()
                    except (EOFError, OSError):
                        pass
                    else:
                        continue
                if not self._procs[i].is_alive() or conn in ready:
                    self._fail(f"worker {i} on {self.devices[i]} died (exit code "
                               f"{self._procs[i].exitcode})")
        errors = [(i, r[1]) for i, r in sorted(replies.items()) if r[0] != "ok"]
        if errors:
            i, tb = errors[0]
            raise RuntimeError(f"split sampler: worker {i} on {self.devices[i]} raised:\n{tb}")
        return [replies[i][1] for i in range(n)]

    # ------------------------------------------------------------ the API
    def __call__(self, labels: torch.Tensor, generator: Optional[torch.Generator] = None,
                 injected: Optional[Tuple] = None):
        if generator is None and injected is None:
            raise ValueError("the sampler needs a torch.Generator or injected draws")
        n = len(self.devices)
        b = labels.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not divide over {n} devices")
        per = b // n
        rows = [slice(i * per, (i + 1) * per) for i in range(n)]
        host = labels.cpu()
        if injected is None:
            base = int(torch.randint(0, 2**62, (1,), generator=generator,
                                     device=generator.device).item())
            requests = [("sample", host[r].clone(), derive_seed(base, i), None)
                        for i, r in enumerate(rows)]
        else:
            requests = [("sample", host[r].clone(), None,
                         tuple(x[:, r].to("cpu").clone(memory_format=torch.contiguous_format)
                               for x in injected))
                        for r in rows]
        out = self._ask_all(requests)
        images = torch.cat([o[0] for o in out]).to(self.devices[0])
        tokens = torch.cat([o[1] for o in out]).to(self.devices[0])
        return images, tokens

    def launch_counts(self, reset: bool = False) -> list:
        """Each worker's kernel launches {kernel: count}, in worker order;
        `reset` sets them to 0 after reading. After `close()`, the counts
        read as it closed."""
        if self._closed_counts is not None:
            return self._closed_counts
        return self._ask_all([("launches", reset)] * len(self._procs))

    def replica_states(self) -> list:
        """Each worker's (generator, tokenizer) state dicts, on the host."""
        return self._ask_all([("state",)] * len(self._procs))

    def close(self) -> None:
        """Stop the workers (their launch counts kept); a no-op when closed."""
        if not self._finalizer.alive:
            return
        timeout, self.timeout = self.timeout, _CLOSE_TIMEOUT
        try:
            self._closed_counts = self._ask_all([("close",)] * len(self._procs))
        except RuntimeError:
            self._closed_counts = self._closed_counts or []
        finally:
            self.timeout = timeout
            self._finalizer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_sharded_sampler(generator_model, tokenizer, cfg: SamplingConfig,
                         devices: Sequence, timeout: float = DEFAULT_TIMEOUT) -> ShardedSampler:
    """(images, tokens) = f(labels, generator=None, injected=None), with the
    contract of `sampling.sample.make_sampler`, the batch split over one
    worker process per entry of `devices` (see the module docstring);
    `labels` must divide over them. Close it (`f.close()`, or `with`) to
    stop the workers."""
    return ShardedSampler(generator_model, tokenizer, cfg, devices, timeout)
