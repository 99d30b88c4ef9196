"""Weights and inputs made from ``--seed`` on the device.

The benchmark makes them, and hands the same numbers to the program and to
the reference.  Every random leaf of one dtype is drawn from one
``torch.Generator`` on the device into one flat buffer, in a few large
calls, then scaled leaf by leaf; constants are filled.  The same seed
gives the same numbers on the same kind of device.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

CHUNK = 1 << 28         # elements a draw


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator for ``seed`` (any whole number) and a named ``stream``
    of draws, on ``device``."""
    mixed = np.random.SeedSequence([int(seed), stream]).generate_state(
        2, np.uint32)
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(mixed[0]) << 31 | int(mixed[1] >> 1))
    return g


def draw(specs: Iterable[Tuple[str, Tuple[int, ...], str, Tuple]],
         seed: int, device, matrix_dtype: torch.dtype
         ) -> Dict[str, torch.Tensor]:
    """Each leaf of ``specs`` (``reference.*.param_specs``) as a tensor on
    ``device``: normal leaves N(0, std²) in their dtype (``"matrix"`` is
    ``matrix_dtype``), constants filled.  The normal leaves of one dtype
    are views of one buffer."""
    specs = list(specs)
    dtypes = {"matrix": matrix_dtype, "float32": torch.float32}
    out: Dict[str, torch.Tensor] = {}
    groups: Dict[torch.dtype, List] = {}
    for name, shape, dt, init in specs:
        dtype = dtypes[dt]
        if init[0] == "const":
            out[name] = torch.full(shape, float(init[1]), dtype=dtype,
                                   device=device)
        else:
            groups.setdefault(dtype, []).append((name, shape, init[1]))
    for i, (dtype, leaves) in enumerate(sorted(groups.items(),
                                               key=lambda kv: str(kv[0]))):
        total = sum(int(np.prod(s)) for _, s, _ in leaves)
        flat = torch.empty(total, dtype=dtype, device=device)
        gen = generator(seed, device, 1 + i)
        for lo in range(0, total, CHUNK):
            flat[lo:lo + CHUNK].normal_(generator=gen)
        off = 0
        for name, shape, std in leaves:
            n = int(np.prod(shape))
            out[name] = flat[off:off + n].view(shape).mul_(std)
            off += n
    return {name: out[name] for name, _, _, _ in specs}


def load_into(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``tensors`` into the module's parameters, after checking that
    the module has exactly these names, shapes and dtypes."""
    params = dict(module.named_parameters())
    if set(params) != set(tensors):
        missing = sorted(set(tensors) - set(params))[:5]
        extra = sorted(set(params) - set(tensors))[:5]
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: missing {missing}, extra {extra}")
    with torch.no_grad():
        for name, p in params.items():
            t = tensors[name]
            if tuple(p.shape) != tuple(t.shape) or p.dtype != t.dtype:
                raise ValueError(f"{name}: the program has {tuple(p.shape)} "
                                 f"{p.dtype}, the reference "
                                 f"{tuple(t.shape)} {t.dtype}")
            p.copy_(t)


def tokens(seed: int, stream: int, shape: Tuple[int, ...], vocab: int,
           device) -> torch.Tensor:
    """Token ids uniform over the vocabulary, int64, on ``device``."""
    return torch.randint(0, vocab, shape, generator=generator(
        seed, device, 1000 + stream), device=device)
