"""Subprocess runners for the dry-run tests: the port's dry run (its
``fake`` process group is global, so it stays out of the test workers)
and the JAX package's shard shapes (importing ``repro.launch.dryrun``
forces 512 host devices, which must happen before JAX starts)."""
import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_script(code: str, timeout: int = 300):
    """The JSON object ``code`` prints on its last line of stdout, run in
    a fresh interpreter with ``src`` on the path (JAX on the CPU)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])
