"""One sampler batch split over the devices of one process.

Counterpart of `maskbit_tpu/sampling/serve.py` (`make_sharded_sampler`),
where one jit generates on every local chip with the weights replicated and
the batch on the data axis. Here:
  * one replica of each model per distinct device (a list that names a
    device twice shares its replica);
  * the batch in contiguous blocks of `b / len(devices)` rows, the layout of
    JAX's `batch_sharding`; the batch must divide;
  * one thread per entry, each under its own CUDA stream on its device
    (PyTorch's current stream is thread-local, and the kernel wrappers
    launch on `torch.cuda.current_stream(device)`);
  * injected draws split by the same rows; otherwise shard i draws from a
    `torch.Generator` on its device seeded from one draw of the caller's
    generator and i, so a run over N devices draws other values than one
    device does, and the same for the same seed and N;
  * the images and tokens concatenated in row order on `devices[0]`.
`local_devices(device)` lists the devices a process splits over, as
`jax.local_devices()` does for the JAX server.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from maskbit_tpu_torch.sampling.sample import SamplingConfig, make_sampler


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


def _module_device(module: torch.nn.Module) -> torch.device:
    return _canonical(next(module.parameters()).device)


def derive_seed(base: int, index: int) -> int:
    """A 63-bit generator seed from (base, index): a shard's from the
    caller's draw, or a serving chunk's from its request's seed."""
    words = np.random.SeedSequence([int(base) & (2**64 - 1), int(index)]).generate_state(2)
    return (int(words[0]) << 31) ^ int(words[1])


def _replica(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    return module if _module_device(module) == device else copy.deepcopy(module).to(device)


def make_sharded_sampler(generator_model, tokenizer, cfg: SamplingConfig,
                         devices: Sequence) -> Callable:
    """(images, tokens) = f(labels, generator=None, injected=None), with the
    contract of `sampling.sample.make_sampler`, the batch split over
    `devices` (see the module docstring); `labels` must divide over them."""
    devices = [_canonical(d) for d in devices]
    if not devices:
        raise ValueError("make_sharded_sampler needs at least one device")
    samplers, streams = {}, {}
    for d in devices:
        if d not in samplers:
            samplers[d] = make_sampler(_replica(generator_model, d), _replica(tokenizer, d), cfg)
    for i, d in enumerate(devices):
        if d.type == "cuda":
            streams[i] = torch.cuda.Stream(device=d)
    n = len(devices)

    def run_shard(i: int, labels: torch.Tensor, generator, injected, waits, out: list) -> None:
        dev = devices[i]
        if dev.type != "cuda":
            out[i] = samplers[dev](labels.to(dev), generator, injected)
        else:
            stream = streams[i]
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                for w in waits:  # the caller's work on the labels, weights and draws
                    stream.wait_stream(w)
                if injected is not None:  # one copy to the shard's card, not one per step
                    injected = tuple(x.to(dev) for x in injected)
                out[i] = samplers[dev](labels.to(dev), generator, injected)
            stream.synchronize()

    def sample(labels: torch.Tensor, generator: Optional[torch.Generator] = None,
               injected: Optional[Tuple] = None):
        if generator is None and injected is None:
            raise ValueError("the sampler needs a torch.Generator or injected draws")
        b = labels.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not divide over {n} devices")
        per = b // n
        rows = [slice(i * per, (i + 1) * per) for i in range(n)]
        if injected is None:
            base = int(torch.randint(0, 2**62, (1,), generator=generator,
                                     device=generator.device).item())
            gens = [torch.Generator(device=d).manual_seed(derive_seed(base, i))
                    for i, d in enumerate(devices)]
            shard_draws = [None] * n
        else:
            gens = [None] * n
            shard_draws = [tuple(x[:, r] for x in injected) for r in rows]
        waits = [torch.cuda.current_stream(d) for d in dict.fromkeys(
            devices + ([labels.device] if labels.is_cuda else [])) if d.type == "cuda"]
        out: list = [None] * n
        errors: list = []

        def target(i):
            try:
                run_shard(i, labels[rows[i]], gens[i], shard_draws[i], waits, out)
            except BaseException as e:  # raised below, on the caller's thread
                errors.append(e)

        if n == 1:
            target(0)
        else:
            threads = [threading.Thread(target=target, args=(i,), daemon=True)
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        for images, tokens in out:  # the shards' memory is read on the caller's streams now
            for t in (images, tokens):
                if t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))
        images = torch.cat([o[0].to(devices[0]) for o in out])
        tokens = torch.cat([o[1].to(devices[0]) for o in out])
        return images, tokens

    sample.devices = devices
    return sample
