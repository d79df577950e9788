"""chip_smoke.py --four phases on four virtual CPU devices at small
sizes: the sharded multiply, the witness-sharded folding tree and the
sharded sumcheck, each against its one-device reference."""

import pathlib
import sys

import pytest

import jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SMALL = {
    "four_ntt": dict(P=4, logN=8, B=2),
    "four_tree": dict(P=4, leaves=8, n=2, L=3),
    "four_sumcheck": dict(P=4, nv=8),
}


@pytest.mark.parametrize("phase", list(SMALL))
def test_four_phase_small(phase, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices (tests/conftest.py makes 8 on CPU)")
    assert set(SMALL) == set(chip_smoke.FOUR_PHASES)
    chip_smoke.FOUR_PHASES[phase](card="test-card", **SMALL[phase])
    out = capsys.readouterr().out
    assert "[four] " in out and "| test-card" in out
