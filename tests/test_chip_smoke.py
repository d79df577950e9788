"""chip_smoke.py on the CPU: every phase function at small sizes (the
same exactness checks the GPU run makes at full size), the HLO dot
report, and the refusal to run without a GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

SMALL = {
    "ring16": dict(B=3, logN=10),
    "pow2": dict(B_bb=3, B_stark=2, logN=6),
    "models": dict(n=8, n_check=4, n_spec=2),
    "mle": dict(nv=8, W=3),
    "sumcheck": dict(nv=8),
    "protocol": dict(step_W=2, step_n=2, step_L=3, tree_leaves=4,
                     tree_n=2, tree_L=3),
}


def test_every_phase_has_a_small_case():
    assert set(SMALL) == set(chip_smoke.PHASES)


@pytest.mark.parametrize("phase", list(SMALL))
def test_phase_small(phase, capsys):
    """Each phase runs its exactness checks at a small size and prints
    its timing lines with the card label."""
    chip_smoke.PHASES[phase](card="test-card", **SMALL[phase])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(f"[{phase}]") and " ms median of " in ln]
    assert lines and all(ln.endswith("| test-card") for ln in lines)


GPU_HLO = """\
HloModule jit_mul

%gemm_fusion_dot.1_computation (parameter_0: s8[320,320], parameter_1: s8[320,64]) -> s32[320,64] {
  %parameter_0 = s8[320,320]{1,0} parameter(0)
  %parameter_1 = s8[320,64]{1,0} parameter(1)
  ROOT %dot.0 = s32[320,64]{1,0} dot(%parameter_0, %parameter_1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%fused_computation (param_0: u8[8,8], param_1: u8[8,4]) -> s32[8,4] {
  %param_0 = u8[8,8]{1,0} parameter(0)
  %param_1 = u8[8,4]{1,0} parameter(1)
  ROOT %dot_general.8.1 = s32[8,4]{1,0} dot(%param_0, %param_1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

ENTRY %main.9 (a.1: s8[2048,2048], b.1: s8[2048,64], w: s8[320,320], x: s8[320,64], u: u8[8,8], v: u8[8,4]) -> s32[8,4] {
  %a.1 = s8[2048,2048]{1,0} parameter(0)
  %b.1 = s8[2048,64]{1,0} parameter(1)
  %w = s8[320,320]{1,0} parameter(2)
  %x = s8[320,64]{1,0} parameter(3)
  %u = u8[8,8]{1,0} parameter(4)
  %v = u8[8,4]{1,0} parameter(5)
  %custom-call.1 = (s32[2048,64]{1,0}, s8[33554432]{0}) custom-call(%a.1, %b.1), custom_call_target="__cublas$gemm", backend_config={"operation_queue_id":"0"}
  %gemm_fusion_dot.1 = s32[320,64]{1,0} fusion(%w, %x), kind=kCustom, calls=%gemm_fusion_dot.1_computation, backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}
  ROOT %fusion.2 = s32[8,4]{1,0} fusion(%u, %v), kind=kLoop, calls=%fused_computation
}
"""


def test_gemm_report_classifies_dots():
    """cuBLAS custom calls, Triton GEMM fusions and plain dot emitters
    are told apart, with operand types (GPU HLO as XLA prints it)."""
    assert chip_smoke.gemm_report(GPU_HLO) == [
        "Triton GEMM fusion (__triton_gemm): "
        "s8[320,320] x s8[320,64] -> s32[320,64]",
        "XLA dot emitter (not a tensor-core GEMM): "
        "u8[8,8] x u8[8,4] -> s32[8,4]",
        "__cublas$gemm: s8[2048,2048] x s8[2048,64] -> s32[2048,64]",
    ]


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_to_run_without_a_gpu(where, tmp_path):
    """On a machine where JAX finds no GPU (and with the script alone in
    a directory) it exits non-zero and prints no result line."""
    if where == "checkout":
        script, cwd = ROOT / "chip_smoke.py", ROOT
    else:
        script = tmp_path / "chip_smoke.py"
        shutil.copy(ROOT / "chip_smoke.py", script)
        cwd = tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
