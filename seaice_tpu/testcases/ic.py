"""Idealized initial-condition generators.

JAX re-design of the reference's `init_ice_state` modes
(`/root/reference/src/shared/mpas_seaice_initialize.F:253-360`:
uniform :462, uniform_interior :1095, circle :1188, special :1321,
random_coverage :1441, cice_default :573 with the parabolic category
profile :758-884, ridging :894, no_ice).  All generators are
vectorized over cells and return (ice_area_cat, ice_volume_cat,
snow_volume_cat, extra_tracers) with [nCells, nCat] arrays, ready for
`SeaIceModel.init_state` + a tracer update.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

DEG2RAD = np.pi / 180.0


def category_initial_profile(ncat: int, kcatbound: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """The CICE parabolic initial area profile per category
    (initial_category_areas_and_volumes :758-884): mid-category
    thickness, area ~ max(0, 2*3m*h - h^2), normalized."""
    from ..column.itd import category_boundaries
    hin_max = np.asarray(category_boundaries(ncat, kcatbound))
    h = np.empty(ncat)
    h[:-1] = 0.5 * (hin_max[:-2] + hin_max[1:-1])
    h[-1] = hin_max[-2] + 1.0
    hbar = 3.0                       # thicknessWithLargestArea
    a = np.maximum(0.0, 2.0 * hbar * h - h ** 2)
    a = a / (a.sum() + 1e-11 / ncat)
    return a, h


def _fill(mesh, mask, ncat, area, volume, snow, tsfc_ice=1.0):
    nc = mesh.n_cells
    m = mask.astype(float)[:, None]
    a = np.full((nc, ncat), area) * m
    v = np.full((nc, ncat), volume) * m
    s = np.full((nc, ncat), snow) * m
    extra = {"surfaceTemperature":
             np.full((nc, ncat), tsfc_ice) * m}
    return a, v, s, extra


def _lat_mask(mesh, lat_north, lat_south):
    if getattr(mesh, "lat_cell", None) is None:
        return np.ones(mesh.n_cells, bool)
    lat = np.asarray(mesh.lat_cell)
    return (lat > lat_north * DEG2RAD) | (lat < lat_south * DEG2RAD)


def uniform_ice(mesh, n_categories: int = 1, area: float = 1.0,
                volume: float = 1.0, snow: float = 0.0,
                lat_north: float = 70.0, lat_south: float = -60.0):
    """Uniform ice polewards of the latitude gates
    (init_ice_state_uniform_ice :462-559; planar meshes have
    lat_cell=0 so the gates select everything when set <= 0)."""
    mask = _lat_mask(mesh, lat_north, lat_south)
    if not mask.any():
        mask = np.ones(mesh.n_cells, bool)
    return _fill(mesh, mask, n_categories, area, volume, snow,
                 tsfc_ice=-1.0)


def uniform_interior(mesh, n_categories: int = 1, area: float = 1.0,
                     volume: float = 1.0, snow: float = 0.0):
    """Ice on interior cells only (init_ice_state_uniform_interior
    :1095): cells whose neighbor stencil is complete."""
    coc = np.asarray(mesh.cells_on_cell)
    interior = (coc >= 0).all(axis=-1)
    return _fill(mesh, interior, n_categories, area, volume, snow)


def circle_ice(mesh, n_categories: int = 1, area: float = 1.0,
               volume: float = 1.0, snow: float = 0.0,
               radius_fraction: float = 0.1):
    """A circle of ice (init_ice_state_circle_of_ice :1188): on a
    sphere, a disc on the equator at the Greenwich meridian of radius
    0.1*R; on a planar mesh, a disc around the domain center of the
    same fraction of the domain size."""
    if getattr(mesh, "on_sphere", False) and \
            getattr(mesh, "lat_cell", None) is not None:
        lat = np.asarray(mesh.lat_cell)
        lon = np.asarray(mesh.lon_cell)
        x = np.cos(lat) * np.cos(lon)
        y = np.cos(lat) * np.sin(lon)
        z = np.sin(lat)
        mask = (x > 0.0) & (np.sqrt(y ** 2 + z ** 2) < radius_fraction)
    else:
        xc = np.asarray(mesh.x_cell)
        yc = np.asarray(mesh.y_cell)
        cx, cy = xc.mean(), yc.mean()
        size = max(xc.max() - xc.min(), yc.max() - yc.min())
        mask = np.hypot(xc - cx, yc - cy) < radius_fraction * size
    return _fill(mesh, mask, n_categories, area, volume, snow)


def random_coverage(mesh, n_categories: int = 1, seed: int = 0):
    """Random half-coverage with log-uniform tiny states down to the
    puny limit (init_ice_state_random_coverage :1441) — the stress
    test for the model's small-value handling."""
    rng = np.random.default_rng(seed)
    nc = mesh.n_cells
    has = rng.random(nc) > 0.5
    mag = 10.0 ** (-11.0 * rng.random(nc))
    val = np.where(has, mag, 0.0)[:, None]
    a = np.repeat(val, n_categories, axis=1)
    extra = {"surfaceTemperature":
             np.where(has, 1.0, 0.0)[:, None] *
             np.ones((1, n_categories))}
    return a, a.copy(), a.copy(), extra


def special_cells(mesh, cells=(2051, 2052), n_categories: int = 1,
                  area: float = 1.0, volume: float = 1.0):
    """Ice on a handful of named cells (init_ice_state_special :1321 —
    the reference hardwires cells 2051/2052 next to 2050)."""
    mask = np.zeros(mesh.n_cells, bool)
    mask[[c for c in cells if c < mesh.n_cells]] = True
    return _fill(mesh, mask, n_categories, area, volume, 0.0)


def cice_default(mesh, n_categories: int, n_ice_layers: int,
                 n_snow_layers: int = 1,
                 sst: Optional[np.ndarray] = None,
                 freezing_temperature: Optional[np.ndarray] = None,
                 air_temperature: Optional[np.ndarray] = None,
                 land_mask: Optional[np.ndarray] = None,
                 lat_north: float = 70.0, lat_south: float = -60.0,
                 snow_thickness: float = 0.2):
    """The CICE standard initial state (init_ice_cice_default :573):
    the parabolic category area/thickness profile where the ocean is
    near freezing polewards of the gates, snow capped at 20% of ice
    volume, and enthalpy/salinity profiles from a linear temperature
    ramp between the (air-limited) surface and the freezing bottom
    (colpkg_init_trcr)."""
    from ..column.thermo_shared import (
        ice_enthalpy_from_temperature, melting_temperature,
        salinity_profile, snow_enthalpy_from_temperature)
    import jax.numpy as jnp

    nc = mesh.n_cells
    ncat = n_categories
    Tf = (np.full(nc, -1.8) if freezing_temperature is None
          else np.asarray(freezing_temperature))
    sstv = Tf if sst is None else np.asarray(sst)
    Tair = (np.full(nc, -20.0) if air_temperature is None
            else np.asarray(air_temperature))
    land = (np.zeros(nc) if land_mask is None
            else np.asarray(land_mask))
    mask = (sstv <= Tf + 0.2) & _lat_mask(mesh, lat_north, lat_south) \
        & (land == 0)
    if not mask.any():
        mask = (sstv <= Tf + 0.2) & (land == 0)

    a_cat, h_cat = category_initial_profile(ncat)
    m = mask.astype(float)[:, None]
    area = m * a_cat[None, :]
    vol = area * h_cat[None, :]
    snow = np.minimum(area * snow_thickness, 0.2 * vol)

    # tracer profiles (colpkg_init_trcr): Tsfc = min(Tair, -puny),
    # linear T(z) from Tsfc to Tf
    tsfc = np.broadcast_to(
        np.minimum(Tair, -0.1)[:, None] * m +
        (1.0 - m) * Tf[:, None], (nc, ncat)).copy()
    sal = np.asarray(salinity_profile(n_ice_layers))
    frac = (np.arange(n_ice_layers) + 0.5) / n_ice_layers
    Tprof = tsfc[:, :, None] * (1.0 - frac) + \
        Tf[:, None, None] * frac                   # [nc, ncat, ni]
    Tmelt = np.asarray(melting_temperature(jnp.asarray(sal)))
    Tprof = np.minimum(Tprof, Tmelt[None, None, :])
    qin = np.asarray(ice_enthalpy_from_temperature(
        jnp.asarray(Tprof), jnp.asarray(sal)[None, None, :]))
    qsn = np.asarray(snow_enthalpy_from_temperature(
        jnp.asarray(np.minimum(tsfc, 0.0))))[..., None] * \
        np.ones((1, 1, n_snow_layers))
    extra = {
        "surfaceTemperature": tsfc,
        "iceEnthalpy": qin * m[:, :, None],
        "iceSalinity": np.broadcast_to(
            sal[None, None, :], qin.shape).copy() * m[:, :, None],
        "snowEnthalpy": qsn * m[:, :, None],
    }
    return area, vol, snow, extra


def ridging_band(mesh, n_categories: int = 1, volume: float = 1.0):
    """A converging band for ridging tests (init_ice_ridging :894):
    full cover, thickness ramping across the domain x-extent."""
    xc = np.asarray(mesh.x_cell)
    t = (xc - xc.min()) / max(xc.max() - xc.min(), 1e-300)
    nc = mesh.n_cells
    a = np.ones((nc, n_categories)) / n_categories
    v = (volume * (0.5 + t))[:, None] * a
    return a, v, np.zeros_like(a), {
        "surfaceTemperature": -1.0 * np.ones((nc, n_categories))}
