"""Process set-up shared by the entry points: the compile-cache
directory, the device peak table and the native library's first-use
build."""

import hashlib
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [True, False], ids=["env_set", "env_unset"])
def test_setup_compile_cache(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is set;
    without it the cache is <repo>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    code = (
        "import jax\n"
        "from bwtpu.hosttune import setup_compile_cache\n"
        "d = setup_compile_cache()\n"
        "print(d)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ret, cfg = proc.stdout.strip().splitlines()[-2:]
    want = str(tmp_path / "cc") if env_dir else os.path.join(REPO, ".jax_cache")
    assert ret == cfg == want


@pytest.mark.parametrize("platform,kind,want", [
    ("gpu", "NVIDIA H100 80GB HBM3", 3.35e12),
    ("gpu", "NVIDIA Unknown GPU", ValueError),
    ("cpu", "cpu", None),
], ids=["h100", "unknown_gpu", "cpu"])
def test_peak_bandwidth_lookup(platform, kind, want):
    import bench

    dev = SimpleNamespace(platform=platform, device_kind=kind)
    if want is ValueError:
        with pytest.raises(ValueError, match="no peak bandwidth"):
            bench.hbm_bandwidth(dev)
    else:
        assert bench.hbm_bandwidth(dev) == want


def test_native_library_concurrent_first_use(tmp_path):
    """Two processes that load the native library at the same first use
    (no csrc/build yet) both end up with one complete, working .so."""
    shutil.copytree(os.path.join(REPO, "bwtpu"), tmp_path / "bwtpu",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(REPO, "csrc"), tmp_path / "csrc",
                    ignore=shutil.ignore_patterns("build"))
    code = (
        "import hashlib, numpy as np\n"
        "from bwtpu import sais\n"
        "assert sais.native_available()\n"
        "s = np.array([2, 1, 3, 1, 3, 1, 0], np.uint8)\n"
        "sa = sais.suffix_array(s)\n"
        "ref = sais.suffix_array(s, force_fallback=True)\n"
        "assert (sa == ref).all(), (sa, ref)\n"
        "print(hashlib.sha256(open(sais._SO, 'rb').read()).hexdigest())\n"
    )
    env = dict(os.environ, PYTHONPATH=str(tmp_path), JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    digests = {out.strip().splitlines()[-1] for out, _ in outs}
    so = tmp_path / "csrc" / "build" / "libbwtpu.so"
    assert digests == {hashlib.sha256(so.read_bytes()).hexdigest()}
    # no partial temporaries left beside the library
    assert sorted(p.name for p in so.parent.iterdir()) == [
        "libbwtpu.so", "libbwtpu.so.lock"]
