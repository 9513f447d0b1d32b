"""chip_smoke.py's oracle and solve phases at tiny sizes on the CPU."""


def test_oracle_phase(smoke):
    smoke.phase_oracles(t_final=1.0)


def test_box_and_hog1p_phases(smoke, capsys):
    smoke.phase_box_solve(t_final=0.3)
    smoke.phase_hog1p(t_final=0.5)
    out = capsys.readouterr().out
    assert "backend=box" in out and "hog1p_5d BDF" in out
