"""chip_smoke.py's --multi phase on four virtual CPU devices."""


def test_multi_phase_on_virtual_devices(smoke, capsys):
    smoke.phase_multi(n_devices=4, bound=23, t_final=0.2)
    out = capsys.readouterr().out
    assert "on 4 devices" in out and "ShardedEllOperator" in out
