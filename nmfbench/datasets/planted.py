"""Planted rank-r Poisson counts, drawn on the device from the seed.

A frozen PyTorch copy of the JAX package's benchmark problem (planted
gamma(0.5) factors, Poisson counts scaled to a mean of ``mean``, capped
at ``cap`` so that int8 holds them, thinned to ``density``), drawn in
2,048-gene blocks with one ``torch.Generator`` on the device.
"""

from __future__ import annotations

import torch

BLOCK = 2048


def generate(data, seed, device):
    """The (n, m) counts as an int8 tensor on ``device`` for the
    configuration's ``data`` block and the run's seed."""
    n, m, r = int(data["n_genes"]), int(data["n_cells"]), int(data["rank"])
    cap = int(data["cap"])
    if cap > 127:
        raise ValueError("planted counts are held as int8: cap <= 127")
    g = torch.Generator(device=device).manual_seed(seed)
    half = torch.tensor(0.5, dtype=torch.float32, device=device)
    wf = torch._standard_gamma(half.expand(n, r).contiguous(), generator=g)
    hf = torch._standard_gamma(half.expand(r, m).contiguous(), generator=g)
    scale = float(data["mean"]) * n * m / float(wf.sum(0) @ hf.sum(1))
    x = torch.empty((n, m), dtype=torch.int8, device=device)
    for i0 in range(0, n, BLOCK):
        mu = (wf[i0:i0 + BLOCK] @ hf).mul_(scale)
        blk = torch.poisson(mu, generator=g).clamp_max_(cap)
        keep = torch.rand(mu.shape, generator=g, device=device) < float(
            data["density"])
        x[i0:i0 + BLOCK] = (blk * keep).to(torch.int8)
    return x
