"""chip_smoke.py's full-physics phase on the CPU at a small size
(icosahedral subdiv 2, 4 subcycles): f32 steps, the f64 reference, the
f32-vs-f64 bound and the determinism probe, on both mesh families."""

import pytest

import chip_smoke


@pytest.mark.parametrize("mesh_kind", ["panel", "voronoi"])
def test_full_phase(mesh_kind, capsys):
    rep = chip_smoke.Report("cpu")
    compiles = chip_smoke.Compiles(rep, workers=2)
    try:
        work = chip_smoke.prepare_full(rep, mesh_kind, subdiv=2,
                                       n_subcycles=4, compiles=compiles)
        model, state, _ = chip_smoke.phase_full(
            rep, work, n_steps=2, trace=mesh_kind == "panel")
    finally:
        compiles.shutdown()
    assert rep.failures == []
    out = capsys.readouterr().out
    assert "f32 vs f64" in out and "[determinism]" in out
    assert model.velocity_path() == (
        "panel" if mesh_kind == "panel" else "gather")
    if mesh_kind == "panel":
        # no GPU plane in a CPU trace: the number is not invented
        assert "integrate_fluxes device time: not measured" in out
