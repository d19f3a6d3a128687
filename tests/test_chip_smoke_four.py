"""chip_smoke.py's four-card phase on four of the virtual CPU devices
(icosahedral subdiv 2): sharded against one device, shards committed to
distinct devices."""

import chip_smoke


def test_four_card_phase(capsys):
    rep = chip_smoke.Report("cpu")
    compiles = chip_smoke.Compiles(rep, workers=3)
    try:
        chip_smoke.phase_four_cards(rep, subdiv=2, n_subcycles=4,
                                    compiles=compiles)
    finally:
        compiles.shutdown()
    assert rep.failures == []
    assert "distinct devices" in capsys.readouterr().out
