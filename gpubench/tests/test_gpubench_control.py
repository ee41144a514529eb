"""The comparison that decides ``correct`` has to fail when the timed path
is broken underneath.  Each cell runs at a tiny size on the CPU with each
planted fault of ``gpubench/faults.py``: the control (the reference in the
program's place, with parity from the Vandermonde rows instead of the
configuration's Reed-Solomon matrix), half of each dispatch's batch left
out, and one byte of every answer altered where it is produced.  On the
card, the control runs at the cell's own size on three seeds."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpubench import faults, manifest, rehearsal  # noqa: E402

BENCH = manifest.load(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**32 + 77


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_planted_fault_comes_out_not_correct(workload, fault):
    result, lines = rehearsal.run_tiny(workload, SEED, fault=fault)
    assert result["correct"] is False
    failing = [k for k, v in result["checked"].items()
               if v["limit"] is not None and v["value"] > v["limit"]]
    assert failing, result["checked"]
    # the program's own path is whole again once the run is over
    clean, _ = rehearsal.run_tiny(workload, SEED + 1)
    assert clean["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_the_card(workload):
    """The control at the cell's own size, three seeds (run on the H100:
    ``python3 -m pytest -m cuda gpubench/tests``)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        proc = subprocess.run(
            [sys.executable, "-m", "gpubench.run", "--workload", workload,
             "--seed", str(seed), "--seconds", "10", "--trace", "0",
             "--fault", "control"],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        assert result["correct"] is False, result["checked"]
