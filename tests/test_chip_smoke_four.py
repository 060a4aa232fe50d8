"""chip_smoke.py --four-cards --rehearse: DistEngine over four virtual
CPU devices reports exactly the single-device Engine's hits, with each
device holding its own index shard (kept in its own file so the test
workers run it beside the single-card rehearsal)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_rehearse_four_cards(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # the script asks for 4 devices itself
    env.setdefault("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(REPO, "tests", ".jax_cache"))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--four-cards",
         "--rehearse", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    out = proc.stdout
    assert json.loads(out.strip().splitlines()[-1]) == {
        "ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 4}
    }
    for mesh in ("(shard=4, data=1)", "(shard=2, data=2)"):
        for k in (0, 2):
            assert f"mesh {mesh} k={k}:" in out
            assert "DistEngine == Engine" in out
    assert "mesh_checks OK" in out
    # the four-card run is that phase alone
    assert "main path" not in out and "trace " not in out
