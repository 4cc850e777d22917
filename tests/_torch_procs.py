"""Multi-process helpers for the port's distributed tests: ranks of a real
``gloo`` group as subprocesses over a ``file://`` store, and the reference
on forced host devices in a subprocess of its own (the device count must
be set before jax starts).  Every call has a time limit."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 240


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def run_ranks(script: str, n: int, workdir: Path, timeout: int = TIMEOUT):
    """``script`` as ``n`` processes, each given ``rank n init_file
    workdir`` in ``sys.argv[1:]``; every one must exit 0."""
    init = workdir / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(n), str(init),
         str(workdir)], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]


def run_reference(script: str, devices: int, workdir: Path,
                  timeout: int = TIMEOUT):
    """``script`` with ``devices`` forced host devices, given ``workdir``
    in ``sys.argv[1]``."""
    env = dict(_env(), XLA_FLAGS=f"--xla_force_host_platform_device_count="
                                 f"{devices}")
    out = subprocess.run([sys.executable, "-c", script, str(workdir)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
