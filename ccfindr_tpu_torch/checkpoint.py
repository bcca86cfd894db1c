"""Checkpoint / resume for factorization state.

A copy of ``ccfindr_tpu.checkpoint`` (numpy and this package's
container only), so that the files of either package load in the other.
The reference has no checkpoint mechanism (persistence = R object
serialization; SURVEY.md §5).  Here factorization state is tiny — just
the factor matrices, hyperparameters and measure table — so
checkpoints are plain ``.npz`` archives with a JSON sidecar for the
measure table; cheap enough to write per rank during long sweeps.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np

from .container import SCSet


def _jsonable(v):
    """Best-effort lossless JSON conversion: numpy scalars/arrays become
    Python scalars/nested lists; anything json can't represent returns
    the sentinel ``_DROP`` (caller warns instead of silently losing it)."""
    if isinstance(v, np.generic):
        v = v.item()
    elif isinstance(v, np.ndarray):
        v = v.tolist()
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return _DROP


_DROP = object()


def save_checkpoint(obj: SCSet, path: str) -> str:
    """Persist factorization results (not the count matrix) to
    ``path`` (.npz + .json).  All JSON-representable metadata (incl.
    nested lists/dicts, e.g. the profiling timings) round-trips;
    anything else triggers a warning rather than silent loss."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for k, rank in enumerate(obj.ranks):
        arrays[f"basis_{rank}"] = np.asarray(obj.basis[k])
        arrays[f"dbasis_{rank}"] = np.asarray(obj.dbasis[k])
        arrays[f"coeff_{rank}"] = np.asarray(obj.coeff[k])
        arrays[f"dcoeff_{rank}"] = np.asarray(obj.dcoeff[k])
    np.savez_compressed(path + ".npz", ranks=np.asarray(obj.ranks),
                        **arrays)
    meta = {}
    for k, v in obj.metadata.items():
        jv = _jsonable(v)
        if jv is _DROP:
            warnings.warn(
                f"checkpoint: metadata[{k!r}] ({type(v).__name__}) is "
                "not JSON-serializable and was not saved", stacklevel=2)
        else:
            meta[k] = jv
    with open(path + ".json", "w") as f:
        json.dump({"measure": obj.measure.to_dict(orient="list"),
                   "metadata": meta}, f)
    return path


def load_checkpoint(obj: SCSet, path: str) -> SCSet:
    """Restore factorization results into a copy of ``obj`` (which
    supplies the count matrix and annotations)."""
    import pandas as pd

    data = np.load(path + ".npz")
    with open(path + ".json") as f:
        meta = json.load(f)
    out = obj[np.arange(obj.n_genes), np.arange(obj.n_cells)]
    out.ranks = [int(r) for r in data["ranks"]]
    out.basis = [data[f"basis_{r}"] for r in out.ranks]
    out.dbasis = [data[f"dbasis_{r}"] for r in out.ranks]
    out.coeff = [data[f"coeff_{r}"] for r in out.ranks]
    out.dcoeff = [data[f"dcoeff_{r}"] for r in out.ranks]
    out.measure = pd.DataFrame(meta["measure"])
    out.metadata.update(meta.get("metadata", {}))
    out.validate()
    return out
