"""Bundled example data: the synthetic PBMC-like 10x trio shipped with
the reference package ``ccfindr_tpu`` (five planted immune cell types).

The files are not copied: they are located through the import
machinery's package spec, which finds ``ccfindr_tpu`` without
executing its ``__init__`` (that would import JAX).
"""

from __future__ import annotations

import importlib.util
import os


def pbmc_sim_dir() -> str:
    """Directory of the bundled synthetic PBMC-like 10x trio."""
    spec = importlib.util.find_spec("ccfindr_tpu")
    if spec is None or not spec.submodule_search_locations:
        raise FileNotFoundError(
            "the bundled pbmc_sim data ships with the ccfindr_tpu "
            "package, which is not installed")
    for loc in spec.submodule_search_locations:
        d = os.path.join(loc, "data", "pbmc_sim")
        if os.path.isfile(os.path.join(d, "matrix.mtx")):
            return d
    raise FileNotFoundError("ccfindr_tpu/data/pbmc_sim is missing")
