"""Multi-host (>= 2 process) distributed BA: the multi-host scaling point.

SURVEY.md section 5 distributed plan / BASELINE.md scaling report: the same
shard_map BA program must run across PROCESS boundaries, not just local
devices.  Here two subprocesses (2 CPU devices each) form a 4-device global
mesh via jax.distributed + gloo and must agree with the single-process
solve on the identical problem.
"""

import json
import socket
import subprocess
import sys
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_ba_matches_single():
    port = _free_port()
    worker = REPO / "tests" / "multihost_worker.py"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(REPO),
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            pytest.fail(f"multihost worker timed out:\n{err[-2000:]}")
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    assert {o["proc"] for o in outs} == {0, 1}
    assert all(o["num_devices"] == 4 for o in outs)
    # Both processes see identical replicated outputs.
    assert outs[0]["rmse_final"] == pytest.approx(outs[1]["rmse_final"], abs=1e-6)

    # Single-process reference on the same problem.
    from monocularsfm_tpu.optim import bundle_adjust
    from tests.multihost_worker import _build_problem

    single = bundle_adjust(_build_problem(), max_iterations=25)
    assert outs[0]["rmse_final"] == pytest.approx(
        float(single["rmse_final"]), abs=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(outs[0]["R0"]), np.asarray(single["R"])[1], atol=5e-3
    )
