"""Bundled example data (synthetic PBMC-like 10x trio).

The reference bundles a real 10x PBMC subsample as its fixture; this
package bundles a deterministic synthetic analog with five planted
immune cell types (see :mod:`ccfindr_tpu_torch.data.generate`), so
tests and examples run without any external data mount.
"""

from __future__ import annotations

import os


def pbmc_sim_dir() -> str:
    """Directory of the bundled synthetic PBMC-like 10x trio (written
    by :func:`~ccfindr_tpu_torch.data.generate.write` if missing)."""
    d = os.path.join(os.path.dirname(__file__), "pbmc_sim")
    if not os.path.isdir(d):
        from .generate import write

        d = write()
    return d
