"""examples/pbmc_workflow_torch.py, the vignette on the port, run as a
user runs it on the CPU (``--device cpu``; float32 and three restarts,
as tests/test_torch_driver.py's bundled scan, to keep it short): it
must reach the optimal rank 5, as tests/test_integration_pbmc.py::
test_pbmc_optimal_rank_is_5 does on the JAX package, assign each of the
five marker sets to a cluster of its own, and import no JAX."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "pbmc_workflow_torch.py")


def test_pbmc_workflow_torch_on_the_cpu():
    code = ("import runpy, sys\n"
            f"sys.argv = [{SCRIPT!r}, '--device', 'cpu', '--nrun', '3',\n"
            "            '--dtype', 'float32']\n"
            f"runpy.run_path({SCRIPT!r}, run_name='__main__')\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert "optimal rank: 5 " in out, out
    assigned = [line.split(": ", 1)[1] for line in out.splitlines()
                if line.startswith("  cluster ")]
    assert sorted(assigned) == ["B cell", "CD4+ T cell", "CD8+ T cell",
                                "Monocyte", "NK cell"], out
