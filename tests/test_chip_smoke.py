"""chip_smoke.py on the CPU: the --rehearse run of every single-card
phase, and the refusals that keep a CPU result from passing as a GPU
one."""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")

import pytest  # noqa: E402


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(REPO, "tests", ".jax_cache"))
    return env


def test_chip_smoke_rehearse_single_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--rehearse", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=REPO,
    )
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}
    }
    out = proc.stdout
    for mode in ("exact", "k2", "paired", "tiered"):
        assert f"main path {mode}:" in out
        assert f"trace {mode}:" in out
        assert (tmp_path / f"trace_{mode}" / "events_sample.json").exists()
    assert "4-shard == 1-shard" in out
    assert out.count("memory_analysis") == 2
    # a CPU trace is never reported as device time
    assert "device op ms" not in out


@pytest.mark.parametrize("where", ["cpu_host", "script_alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    script = SCRIPT
    cwd = REPO
    if where == "script_alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
        cwd = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, script, "--out", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=cwd,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    if where == "cpu_host":
        assert "device check" in proc.stdout
