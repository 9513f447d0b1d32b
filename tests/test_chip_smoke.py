"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to
report a result from anything but the GPU backend."""
import pytest


def test_main_refuses_cpu_backend(smoke, capsys):
    assert smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""            # no result line, nothing on stdout
    assert "not 'gpu'" in out.err


def test_check_raises(smoke):
    with pytest.raises(smoke.SmokeFailure):
        smoke.check(False, "must fail")


def test_box_operator_phase(smoke, capsys):
    smoke.phase_box_operator(bound=23)
    out = capsys.readouterr().out
    assert "box (24, 24, 24) float64" in out and "float32" in out


def test_main_solve_and_ell_operator_phases(smoke, capsys):
    solver, d, walls = smoke.phase_main_solve(t_final=0.2, runs=1)
    assert len(walls) == 1 and solver._backend_used == "ell"
    smoke.phase_ell_operator(solver)
    out = capsys.readouterr().out
    assert "backend=ell" in out and "ell float32" in out
