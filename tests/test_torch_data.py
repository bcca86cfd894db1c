"""The port's bundled data: ``ccfindr_tpu_torch.data.generate`` against
the JAX package's generator (the same draws, so the same arrays and
files, byte for byte), the committed ``ccfindr_tpu_torch/data/pbmc_sim``
against the JAX package's, and ``pbmc_sim_dir`` finding (or writing)
the port's own files with ``ccfindr_tpu`` out of reach."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ccfindr_tpu.data import generate as jgen
from ccfindr_tpu_torch import data as tdata
from ccfindr_tpu_torch.data import generate as tgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("matrix.mtx", "genes.tsv", "barcodes.tsv", "labels.tsv")
JAX_DIR = os.path.join(REPO, "ccfindr_tpu", "data", "pbmc_sim")
PORT_DIR = os.path.join(REPO, "ccfindr_tpu_torch", "data", "pbmc_sim")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_constants_are_jax_s():
    assert tgen.MARKERS == jgen.MARKERS
    assert list(tgen.MARKERS) == list(jgen.MARKERS)
    assert (tgen.N_BACKGROUND, tgen.CELLS_PER_TYPE, tgen.SEED) == (
        jgen.N_BACKGROUND, jgen.CELLS_PER_TYPE, jgen.SEED)


@pytest.mark.parametrize("seed", [jgen.SEED, 7])
def test_build_equals_jax_build(seed):
    got, want = tgen.build(seed), jgen.build(seed)
    x, gene_ids, symbols, barcodes, labels = got
    assert x.dtype == want[0].dtype and x.shape == want[0].shape
    assert np.array_equal(x, want[0])
    assert gene_ids == want[1]
    assert symbols == want[2]
    assert barcodes == want[3]
    assert labels.dtype == want[4].dtype
    assert np.array_equal(labels, want[4])


def test_write_gives_the_jax_files(tmp_path):
    out = tgen.write(str(tmp_path / "sim"))
    assert out == str(tmp_path / "sim")
    for f in FILES:
        assert _read(os.path.join(out, f)) == _read(os.path.join(JAX_DIR, f)), f


def test_committed_files_are_the_jax_files():
    assert sorted(os.listdir(PORT_DIR)) == sorted(FILES)
    for f in FILES:
        assert _read(os.path.join(PORT_DIR, f)) == _read(
            os.path.join(JAX_DIR, f)), f


def test_pbmc_sim_dir_is_the_port_s_own():
    d = tdata.pbmc_sim_dir()
    pkg = os.path.dirname(os.path.abspath(tdata.__file__))
    assert os.path.abspath(d) == os.path.join(pkg, "pbmc_sim")
    assert os.path.commonpath([os.path.abspath(d), pkg]) == pkg


def test_pbmc_sim_dir_writes_a_missing_directory(tmp_path, monkeypatch):
    # both modules' files moved to an empty directory: the data there is
    # missing, and pbmc_sim_dir must write it with the default write()
    monkeypatch.setattr(tdata, "__file__", str(tmp_path / "__init__.py"))
    monkeypatch.setattr(tgen, "__file__", str(tmp_path / "generate.py"))
    d = tdata.pbmc_sim_dir()
    assert d == str(tmp_path / "pbmc_sim")
    for f in FILES:
        assert _read(os.path.join(d, f)) == _read(os.path.join(JAX_DIR, f)), f


def test_read_10x_with_ccfindr_tpu_unfindable():
    code = (
        "import importlib.abc, sys\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'ccfindr_tpu' or name.startswith('ccfindr_tpu.'):\n"
        "            raise ModuleNotFoundError(name)\n"
        "        return None\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import importlib.util\n"
        "try:\n"
        "    importlib.util.find_spec('ccfindr_tpu')\n"
        "    raise SystemExit('ccfindr_tpu was found')\n"
        "except ModuleNotFoundError:\n"
        "    pass\n"
        "import ccfindr_tpu_torch as ct\n"
        "from ccfindr_tpu_torch.data import pbmc_sim_dir\n"
        "s = ct.read_10x(pbmc_sim_dir())\n"
        "assert (s.n_genes, s.n_cells) == (737, 450), (s.n_genes, s.n_cells)\n"
        "assert 'ccfindr_tpu' not in sys.modules\n"
        "assert 'jax' not in sys.modules\n"
        "print('read', s.n_genes, s.n_cells)\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("read 737 450")
