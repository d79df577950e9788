"""Smoke tests: every example in examples/ runs end-to-end on CPU.

The examples are the end-to-end protocol demos (Ajtai commitment,
folding step, sumcheck, big-ring fold, multi-chip prover) — the shapes
a user of the reference (NethermindEth/stark-rings) drives the algebra
through.  Each runs as a subprocess with SRT_PLATFORM=cpu (the examples
set the platform in-process; distributed_prover.py also gets a virtual
8-device CPU mesh from it) and must exit 0; each example carries
its own internal exactness asserts (oracle cross-checks, verifier
replay), so exit 0 is a real correctness statement, not just "no crash".
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = sorted(p.name for p in (REPO / "examples").glob("*.py"))


def test_every_example_is_covered():
    # a new example must be added to the smoke matrix below
    assert EXAMPLES == sorted(EXPECT), EXAMPLES


# example -> substring its stdout must contain (ties the smoke test to
# the example's own verification print, not just the exit code)
EXPECT = {
    "ajtai_commitment.py": "demo ok",
    "folding_step.py": "verifier transcript replay matches",
    "sumcheck.py": "verified = True, tamper rejected",
    "bigring_fold.py": "square exact vs the radix oracle",
    "distributed_prover.py": "sharded sumcheck verified",
    "folding_tree.py": "REJECT on a tampered digit commitment",
}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_example_runs(name):
    env = dict(os.environ)
    env["SRT_PLATFORM"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / name)],
        env=env, cwd=str(REPO), capture_output=True, text=True,
        timeout=600,
    )
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert EXPECT[name] in proc.stdout, proc.stdout
