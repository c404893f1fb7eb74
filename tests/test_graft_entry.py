"""The multi-device dry run: __graft_entry__.dryrun_multichip(8) must pass
in a fresh process started with neither JAX_PLATFORMS nor XLA_FLAGS set
(a direct import and a direct call), and in-process after jax is imported.
The function forces the virtual CPU devices itself.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_dryrun_multichip_as_the_driver_calls_it():
    # the process environment minus the CPU overrides the test conftest
    # adds: dryrun_multichip must force the CPU devices on its own
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [
            sys.executable,
            "-c",
            "import __graft_entry__ as g; g.dryrun_multichip(8)",
        ],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "dryrun_multichip OK" in proc.stdout


def test_dryrun_multichip_inprocess_after_jax_import():
    # Robust to jax being already imported (the conftest imported it) — the
    # function must still find >=8 CPU devices via config update/clear.
    sys.path.insert(0, str(REPO))
    try:
        import __graft_entry__ as g

        g.dryrun_multichip(8)
    finally:
        sys.path.remove(str(REPO))
