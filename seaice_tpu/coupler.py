"""Coupled-driver surface: import/export field dictionaries.

JAX re-design of the reference coupler caps (`driver_nuopc/
ice_import_export.F90`: advertise :126-290, `ice_import` :487,
`ice_export` :975; MCT analog `driver/ice_comp_mct.F`): a host-side
field-dict API with the NUOPC standard names, so an external coupler
(or a Python E3SM/CESM harness) can drive the model with
`import_state -> step -> export_state`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import jax.numpy as jnp

from . import constants as c
from .column.driver import (AtmosForcing, ColumnFluxes, OceanForcing,
                            slab_ocean_frzmlt)
from .dynamics.evp import DynamicsForcing
from .model import State

# NUOPC standard names advertised by the reference cap
IMPORT_FIELDS = (
    "So_t", "So_s", "So_u", "So_v", "So_dhdx", "So_dhdy", "Fioo_q",
    "Sa_z", "Sa_ptem", "Sa_tbot", "Sa_shum", "Sa_dens",
    "Faxa_swvdr", "Faxa_swvdf", "Faxa_swndr", "Faxa_swndf",
    "Faxa_lwdn", "Faxa_rain", "Faxa_snow", "Sa_u", "Sa_v")
EXPORT_FIELDS = (
    "Si_imask", "Si_ifrac", "Si_t", "Si_vice", "Si_vsno",
    "Si_avsdr", "Si_avsdf", "Si_anidr", "Si_anidf",
    "Faii_taux", "Faii_tauy", "Faii_lat", "Faii_sen", "Faii_lwup",
    "Faii_evap", "Fioi_melth", "Fioi_swpen", "Fioi_meltw",
    "Fioi_salt", "Fioi_taux", "Fioi_tauy")

# per-category atmosphere-computed surface fluxes, imported only in
# calc_Tsfc=False coupling (Registry.xml:3657-3660 atmos_coupling pool)
SFC_FLUX_IMPORT_FIELDS = (
    "surfaceHeatFluxCouple", "surfaceConductiveFluxCouple",
    "latentHeatFluxCouple", "sensibleHeatFluxCouple")


def import_sfc_fluxes(fields: Dict[str, Any], dtype=jnp.float64):
    """calc_Tsfc=False imports: the atmosphere model's per-category
    surface fluxes ([nCells, nCategories] arrays, Registry
    surfaceHeatFluxCouple / surfaceConductiveFluxCouple /
    latentHeatFluxCouple / sensibleHeatFluxCouple) -> the column
    driver's sfc_fluxes dict (set_sfcflux analog,
    ice_flux_colpkg.F90:174-288)."""
    missing = [k for k in SFC_FLUX_IMPORT_FIELDS if k not in fields]
    if missing:
        raise KeyError(
            f"calc_Tsfc=False coupling requires import fields "
            f"{missing} (per-category surface fluxes from the "
            f"atmosphere model)")
    return {
        "fsurf": jnp.asarray(fields["surfaceHeatFluxCouple"], dtype),
        "fcondtop": jnp.asarray(
            fields["surfaceConductiveFluxCouple"], dtype),
        "flat": jnp.asarray(fields["latentHeatFluxCouple"], dtype),
        "fsens": jnp.asarray(fields["sensibleHeatFluxCouple"], dtype),
    }


def import_state(fields: Dict[str, Any], dt: float, dtype=jnp.float64,
                 tfrz_option: str = "minus1p8",
                 sst_in_kelvin: bool = False
                 ) -> Tuple[DynamicsForcing, AtmosForcing, OceanForcing]:
    """Translate coupler import fields (NUOPC names, [nCells] arrays)
    into the model forcing containers (reference ice_import :487).

    tfrz_option selects the sea freezing-temperature formula
    (colpkg_sea_freezing_temperature, ice_colpkg.F90:1664-1686).
    sst_in_kelvin: set when the driving coupler sends So_t in K (the
    NUOPC cap converts; declare the convention, don't guess)."""
    def g(name, default=0.0):
        if name in fields:
            return jnp.asarray(fields[name], dtype)
        return jnp.full_like(jnp.asarray(fields["So_t"], dtype), default)

    sst = g("So_t")
    if sst_in_kelvin:
        sst = sst - c.FRESH_FREEZING_POINT
    sss = g("So_s", 34.0)
    from .column.thermo_shared import sea_freezing_temperature
    tf = sea_freezing_temperature(sss, tfrz_option)
    frzmlt = g("Fioo_q")
    if "Fioo_q" not in fields:
        frzmlt = slab_ocean_frzmlt(sst, tf, 20.0 * jnp.ones_like(sst),
                                   dt)

    dyn = DynamicsForcing(
        u_air_velocity=g("Sa_u"), v_air_velocity=g("Sa_v"),
        air_density=g("Sa_dens", 1.3),
        u_ocean_velocity=g("So_u"), v_ocean_velocity=g("So_v"),
        sea_surface_tilt_u=g("So_dhdx"),
        sea_surface_tilt_v=g("So_dhdy"),
        land_ice_mask=jnp.zeros_like(sst))
    atm = AtmosForcing(
        air_temperature=g("Sa_ptem", 273.0),
        specific_humidity=g("Sa_shum", 1e-3),
        u_air=g("Sa_u"), v_air=g("Sa_v"),
        longwave_down=g("Faxa_lwdn", 250.0),
        sw_vis_dir=g("Faxa_swvdr"), sw_vis_dif=g("Faxa_swvdf"),
        sw_ir_dir=g("Faxa_swndr"), sw_ir_dif=g("Faxa_swndf"),
        rain_rate=g("Faxa_rain"), snow_rate=g("Faxa_snow"),
        air_density=g("Sa_dens", 1.3),
        air_level_height=g("Sa_z", 10.0))
    ocn = OceanForcing(
        sst=sst, sss=sss, freezing_temperature=tf, frzmlt=frzmlt,
        mixed_layer_depth=20.0 * jnp.ones_like(sst))
    return dyn, atm, ocn


def export_state(state: State, fluxes: ColumnFluxes = None,
                 diags: Dict[str, Any] = None,
                 mesh_tensors=None) -> Dict[str, np.ndarray]:
    """Build the coupler export dict (reference ice_export :975):
    fractions/states plus atmosphere- and ocean-side fluxes.

    mesh_tensors: when given, vertex stresses are interpolated to cell
    centers for the Fioi_tau* exports (reference
    seaice_interpolate_vertex_to_cell before export)."""
    tr = state.tracers
    aice = np.asarray(tr["iceAreaCategory"].sum(-1))
    out: Dict[str, np.ndarray] = {
        "Si_imask": (aice > 0).astype(float),
        "Si_ifrac": aice,
        "Si_vice": np.asarray(tr["iceVolumeCategory"].sum(-1)),
        "Si_vsno": np.asarray(tr["snowVolumeCategory"].sum(-1)),
    }
    if "surfaceTemperature" in tr:
        a_cat = np.asarray(tr["iceAreaCategory"])
        t_cat = np.asarray(tr["surfaceTemperature"])
        w = np.maximum(aice, 1e-11)
        out["Si_t"] = (a_cat * t_cat).sum(-1) / w + \
            c.FRESH_FREEZING_POINT
    if fluxes is not None:
        f = fluxes
        out.update({
            "Faii_lat": np.asarray(f.flat),
            "Faii_sen": np.asarray(f.fsens),
            "Faii_lwup": np.asarray(f.flwout),
            "Faii_evap": np.asarray(f.evap),
            "Fioi_melth": np.asarray(f.fhocn),
            "Fioi_swpen": np.asarray(f.fswthru),
            "Fioi_meltw": np.asarray(f.fresh),
            "Fioi_salt": np.asarray(f.fsalt),
            "Si_avsdr": np.asarray(f.albedo_vis_dir),
            "Si_avsdf": np.asarray(f.albedo_vis_dif),
            "Si_anidr": np.asarray(f.albedo_ir_dir),
            "Si_anidf": np.asarray(f.albedo_ir_dif),
        })
    if diags is not None and "ocean_stress_u" in diags:
        su = diags["ocean_stress_u"]
        sv = diags["ocean_stress_v"]
        if mesh_tensors is not None:
            from .mesh.core import vertex_to_cell
            su = vertex_to_cell(mesh_tensors, jnp.asarray(su))
            sv = vertex_to_cell(mesh_tensors, jnp.asarray(sv))
            out["Fioi_taux"] = np.asarray(su)
            out["Fioi_tauy"] = np.asarray(sv)
        else:
            # no mesh available: export the raw vertex fields under
            # explicitly vertex-named keys so the caller cannot confuse
            # them with cell fields
            out["Fioi_taux_vertex"] = np.asarray(su)
            out["Fioi_tauy_vertex"] = np.asarray(sv)
    return out
