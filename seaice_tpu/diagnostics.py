"""Diagnostics: state sanity checks, conservation budgets, regional
statistics, and phase timers.

JAX re-design of `mpas_seaice_diagnostics.F` (seaice_check_state
:170, load-balance timers :504) and the conservation_check / regional
statistics analysis members
(`src/analysis_members/mpas_seaice_conservation_check.F:1915+`,
`mpas_seaice_regional_statistics.F`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from . import constants as c
from .model import State


# -- state sanity check (reference seaice_check_state) ------------------------

def check_state(state: State, max_velocity: float = 5.0,
                max_thickness: float = 50.0) -> Dict[str, Any]:
    """Scan prognostic fields for NaN/Inf and physically absurd values.
    Returns a dict with 'ok' plus per-check flags; pure jnp so it can run
    inside jit (the abort decision happens on the host)."""
    a = state.tracers["iceAreaCategory"]
    v = state.tracers["iceVolumeCategory"]
    u = state.velocity.u_velocity
    w = state.velocity.v_velocity
    speed = jnp.sqrt(u ** 2 + w ** 2)
    aice = a.sum(-1)
    has = a > c.PUNY
    thickness = jnp.where(has, v / jnp.where(has, a, 1.0), 0.0)
    checks = {
        "finite_area": jnp.isfinite(a).all(),
        "finite_volume": jnp.isfinite(v).all(),
        "finite_velocity": jnp.isfinite(u).all() &
        jnp.isfinite(w).all(),
        "area_bounds": (a >= -c.PUNY).all() & (aice <= 1.0 + 1e-6).all(),
        "volume_nonneg": (v >= -c.PUNY).all(),
        "velocity_bound": (speed <= max_velocity).all(),
        "thickness_bound": (thickness <= max_thickness).all(),
    }
    ok = jnp.array(True)
    for val in checks.values():
        ok = ok & val
    checks["ok"] = ok
    return checks


# -- conservation budgets (conservation_check analysis member) ----------------

def total_budgets(state: State, area_cell) -> Dict[str, Any]:
    """Global extensive totals: ice area (m^2), ice/snow mass (kg),
    internal energy (J), salt (kg) — the quantities the reference's
    conservation_check closes against coupler fluxes
    (compute_total_* at :1915+)."""
    tr = state.tracers
    a = tr["iceAreaCategory"]
    v = tr["iceVolumeCategory"]
    vs = tr["snowVolumeCategory"]
    ac = area_cell[:, None]
    out = {
        "ice_area": (a * ac).sum(),
        "ice_mass": c.DENSITY_ICE * (v * ac).sum(),
        "snow_mass": c.DENSITY_SNOW * (vs * ac).sum(),
    }
    if "iceEnthalpy" in tr:
        ni = tr["iceEnthalpy"].shape[-1]
        out["ice_energy"] = ((v / ni)[..., None] * tr["iceEnthalpy"] *
                             ac[..., None]).sum()
    if "snowEnthalpy" in tr:
        ns = tr["snowEnthalpy"].shape[-1]
        out["snow_energy"] = ((vs / ns)[..., None] * tr["snowEnthalpy"] *
                              ac[..., None]).sum()
    if "iceSalinity" in tr:
        ni = tr["iceSalinity"].shape[-1]
        out["salt_mass"] = c.DENSITY_ICE * 1e-3 * (
            (v / ni)[..., None] * tr["iceSalinity"] *
            ac[..., None]).sum()
    return out


class ConservationMonitor:
    """Closes budget changes against accumulated boundary fluxes over a
    window (the conservation_check analysis member pattern)."""

    def __init__(self, area_cell):
        self.area_cell = area_cell
        self.reference: Optional[Dict[str, float]] = None
        self.accumulated: Dict[str, float] = {}

    def reset(self, state: State):
        self.reference = {k: float(v) for k, v in
                          total_budgets(state, self.area_cell).items()}
        self.accumulated = {"fresh": 0.0, "fhocn": 0.0, "fsalt": 0.0}

    def accumulate_fluxes(self, fluxes, dt: float):
        """fluxes: ColumnFluxes (per-cell); integrates area-weighted."""
        ac = self.area_cell
        self.accumulated["fresh"] += float(
            (fluxes.fresh * ac).sum()) * dt
        self.accumulated["fsalt"] += float(
            (fluxes.fsalt * ac).sum()) * dt
        self.accumulated["fhocn"] += float(
            (fluxes.fhocn * ac).sum()) * dt

    def errors(self, state: State) -> Dict[str, float]:
        """Relative budget-closure errors since reset."""
        now = {k: float(v) for k, v in
               total_budgets(state, self.area_cell).items()}
        d_mass = (now["ice_mass"] + now["snow_mass"] -
                  self.reference["ice_mass"] -
                  self.reference["snow_mass"])
        # fresh flux is water ADDED to the ocean = mass REMOVED from ice
        expected = -self.accumulated["fresh"]
        scale = max(abs(now["ice_mass"]), abs(expected), 1.0)
        out = {"mass_closure": abs(d_mass - expected) / scale}
        if "salt_mass" in now:
            d_salt = now["salt_mass"] - self.reference["salt_mass"]
            exp_salt = -self.accumulated["fsalt"]
            scale = max(abs(now["salt_mass"]), abs(exp_salt), 1.0)
            out["salt_closure"] = abs(d_salt - exp_salt) / scale
        return out


# -- regional statistics (regional_statistics member) -------------------------

def regional_statistics(state: State, area_cell, region_mask,
                        n_regions: int, mesh_t=None) -> Dict[str, Any]:
    """Per-region statistics via segment reductions (reference
    mpas_seaice_regional_statistics.F, 2,917 LoC of region-masked MPI
    sums over ~30 quantities): area/extent/volume totals, kinetic
    energy and RMS speed (needs mesh_t for the vertex->cell velocity
    interpolation), internal energy, salt, ponds, level/ridged
    partition, age/FY areas, and thickness mean/max."""
    tr = state.tracers
    aicen = tr["iceAreaCategory"]
    vicen = tr["iceVolumeCategory"]
    vsnon = tr["snowVolumeCategory"]
    aice = aicen.sum(-1)
    vice = vicen.sum(-1)
    vsno = vsnon.sum(-1)

    def seg(x):
        return jax.ops.segment_sum(x, region_mask,
                                   num_segments=n_regions)

    def segmax(x):
        return jax.ops.segment_max(x, region_mask,
                                   num_segments=n_regions)

    a_tot = seg(aice * area_cell)
    v_tot = seg(vice * area_cell)
    out = {
        "total_ice_area": a_tot,
        "total_ice_extent": seg(
            jnp.where(aice > 0.15, area_cell, 0.0)),
        "total_ice_volume": v_tot,
        "total_snow_volume": seg(vsno * area_cell),
        "total_open_water_area": seg(
            jnp.maximum(1.0 - aice, 0.0) * area_cell),
        "average_ice_thickness": v_tot / jnp.maximum(a_tot, 1.0),
        "max_ice_thickness": segmax(jnp.where(
            aice > c.PUNY, vice / jnp.maximum(aice, c.PUNY), 0.0)),
    }
    # kinetic energy / RMS ice speed (reference computes KE from the
    # cell-interpolated velocity and the ice+snow mass)
    if mesh_t is not None:
        from .mesh.core import vertex_to_cell
        uc = vertex_to_cell(mesh_t, state.velocity.u_velocity)
        vc = vertex_to_cell(mesh_t, state.velocity.v_velocity)
        sp2 = uc * uc + vc * vc
        mass = c.DENSITY_ICE * vice + c.DENSITY_SNOW * vsno
        out["total_kinetic_energy"] = seg(0.5 * mass * sp2 * area_cell)
        spd_w = seg(jnp.sqrt(sp2) * aice * area_cell)
        out["rms_ice_speed"] = jnp.sqrt(
            seg(sp2 * aice * area_cell) / jnp.maximum(a_tot, 1.0))
        out["average_ice_speed"] = spd_w / jnp.maximum(a_tot, 1.0)
    # internal energy / salt (energy and salt sums of the reference)
    if "iceEnthalpy" in tr:
        ni = tr["iceEnthalpy"].shape[-1]
        e = ((vicen / ni)[..., None] * tr["iceEnthalpy"]).sum((-2, -1))
        out["total_ice_energy"] = seg(e * area_cell)
    if "snowEnthalpy" in tr:
        ns = tr["snowEnthalpy"].shape[-1]
        e = ((vsnon / ns)[..., None] * tr["snowEnthalpy"]).sum((-2, -1))
        out["total_snow_energy"] = seg(e * area_cell)
    if "iceSalinity" in tr:
        ni = tr["iceSalinity"].shape[-1]
        s = ((vicen / ni)[..., None] * tr["iceSalinity"]).sum((-2, -1))
        out["total_salt_mass"] = seg(
            c.DENSITY_ICE * 1e-3 * s * area_cell)
    # ponds
    if "pondArea" in tr:
        apnd = tr["pondArea"]
        if "levelIceArea" in tr:
            apnd = apnd * tr["levelIceArea"]
        pa = (apnd * aicen).sum(-1)
        out["total_pond_area"] = seg(pa * area_cell)
        if "pondDepth" in tr:
            out["total_pond_volume"] = seg(
                (apnd * tr["pondDepth"] * aicen).sum(-1) * area_cell)
    # level / ridged partition
    if "levelIceArea" in tr:
        alvl = (tr["levelIceArea"] * aicen).sum(-1)
        out["total_level_ice_area"] = seg(alvl * area_cell)
        out["total_ridged_ice_area"] = seg((aice - alvl) * area_cell)
    if "levelIceVolume" in tr:
        vlvl = (tr["levelIceVolume"] * vicen).sum(-1)
        out["total_level_ice_volume"] = seg(vlvl * area_cell)
        out["total_ridged_ice_volume"] = seg((vice - vlvl) * area_cell)
    # age / first-year
    if "iceAge" in tr:
        aw = (tr["iceAge"] * aicen).sum(-1)
        out["average_ice_age"] = seg(aw * area_cell) / \
            jnp.maximum(a_tot, 1.0)
    if "firstYearIceArea" in tr:
        out["total_first_year_ice_area"] = seg(
            (tr["firstYearIceArea"] * aicen).sum(-1) * area_cell)
    if "brineHeight" in tr:
        out["average_brine_height"] = seg(
            (tr["brineHeight"] * aicen).sum(-1) * area_cell) / \
            jnp.maximum(a_tot, 1.0)
    return out


def hemisphere_region_mask(mesh) -> "np.ndarray":
    """Two-region mask: 0 = northern hemisphere, 1 = southern (the
    reference's standard region file splits hemispheres)."""
    lat = getattr(mesh, "lat_cell", None)
    if lat is None:
        return np.zeros(mesh.n_cells, np.int32)
    return (np.asarray(lat) < 0.0).astype(np.int32)


# -- phase timers -------------------------------------------------------------

class PhaseTimers:
    """Named wall-clock timers with block_until_ready fencing — the
    JAX analog of the reference's hierarchical mpas_timer
    instrumentation (velocity_solver.F:579-669)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    def time(self, name: str):
        timers = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                timers.totals[name] = timers.totals.get(name, 0.0) + dt
                timers.counts[name] = timers.counts.get(name, 0) + 1
                return False

        return _Ctx()

    def timed(self, name: str, fn, *args, **kwargs):
        with self.time(name):
            out = fn(*args, **kwargs)
            jax.block_until_ready(out)
        return out

    def report(self) -> str:
        lines = ["timer                          total(s)   calls  mean(ms)"]
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            n = self.counts[k]
            lines.append(f"{k:<30} {self.totals[k]:>8.3f} {n:>7d} "
                         f"{1000.0 * self.totals[k] / n:>9.2f}")
        return "\n".join(lines)
