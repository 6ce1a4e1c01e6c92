"""The weights of a run, drawn by the benchmark from the seed on the
device: one uniform draw of every leaf's numbers at once, from a
``torch.Generator`` on that device, each leaf then scaled to its
published initialisation range (the reference's ``specs``). Constant
leaves (biases, LayerNorm) take their constant. The same dict is loaded
into the program's model by name and handed to the reference."""

from __future__ import annotations

from typing import Dict

import torch


def draw(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    device = torch.device(device)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
    out, off = {}, 0
    for (name, shape, init, scale), n in zip(specs, sizes):
        if init == "uniform":
            out[name] = (flat[off:off + n] * scale).reshape(shape)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
        off += n
    return out
