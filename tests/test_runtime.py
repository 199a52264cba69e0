"""Process-level behaviour: compile-cache placement and chip_smoke.py's
refusal to run without a GPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(args, env_update, cwd=REPO, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_update)
    for k in drop:
        env.pop(k, None)
    return subprocess.run([sys.executable, *args], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, the package sets no other
    directory; unset, the cache is <checkout>/.jax_cache."""
    code = ("import monocularsfm_tpu, jax; print(json.dumps(["
            "jax.config.jax_compilation_cache_dir, "
            "monocularsfm_tpu.compile_cache_dir()]))")
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else {}
    res = _run(["-c", "import json; " + code], env,
               drop=() if env_set else ("JAX_COMPILATION_CACHE_DIR",))
    assert res.returncode == 0, res.stderr[-2000:]
    want = str(tmp_path) if env_set else str(REPO / ".jax_cache")
    assert json.loads(res.stdout.strip().splitlines()[-1]) == [want, want]


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """On a CPU-only JAX, in the checkout or copied alone into an empty
    directory, chip_smoke.py exits non-zero and prints no verdict."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        cwd = tmp_path
        script = pathlib.Path(shutil.copy(script, tmp_path / script.name))
    res = _run([str(script)], {}, cwd=cwd)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "needs a GPU" in res.stderr
