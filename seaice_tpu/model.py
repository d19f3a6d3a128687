"""Model driver: state container + the single jitted timestep.

JAX equivalent of the reference's core run loop and time
integration (`/root/reference/src/model_forward/mpas_seaice_core.F:257-371`
and `/root/reference/src/shared/mpas_seaice_time_integration.F:42-175`):
one `seaice_timestep` = column pre-dynamics -> (dynamics subcycle:
velocity solve -> transport -> ridging) -> column post-dynamics, compiled
as one XLA program over the whole step so the working set stays resident
on device (the reference needs OpenACC data regions for this;
mesh_pool.F:145-172).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as c
from .config import AdvectionType, Config
from .mesh.core import Mesh, MeshTensors
from .dynamics import evp
from .column.tuning import Tunables as _Tunables
from .dynamics.evp import (DynamicsForcing, DynamicsTensors,
                           VelocitySolverState, build_dynamics_tensors,
                           init_velocity_state, zero_forcing)
from .transport import (RemapTensors, TracerTree, build_remap_geometry,
                        make_remap_step, standard_tracer_tree,
                        mass_only_tree)
from .column.driver import (AtmosForcing, ColumnPhysics, OceanForcing)
from .utils.pytree import pytree_dataclass, replace


@pytree_dataclass
class State:
    """Full prognostic model state (one pytree; the JAX Registry
    'restart' field set, reference Registry.xml:1910-2014)."""
    velocity: VelocitySolverState
    tracers: Dict[str, Any]         # tracer arrays keyed by name
    time: Any                       # model time, seconds since start


@pytree_dataclass
class ModelTensors:
    """All static per-mesh device tensors used by the step."""
    mesh: MeshTensors
    dynamics: DynamicsTensors
    remap: Optional[RemapTensors]
    upwind: Optional[Any]
    area_cell: Any




def _col_tunables(col) -> "_Tunables":
    """Build the column physics Tunables from the flat ColumnConfig
    fields (the namelist maps Registry options onto these)."""
    import dataclasses as _dc
    return _Tunables(**{f.name: getattr(col, f.name)
                        for f in _dc.fields(_Tunables)})


class SeaIceModel:
    """Owns the static mesh/basis/geometry tensors and builds the jitted
    step for a Config (scheme selection at trace time, like the
    reference's init-time scheme selection)."""

    def __init__(self, mesh: Mesh, cfg: Config, dtype=jnp.float64,
                 tracer_tree: Optional[TracerTree] = None):
        self.mesh = mesh
        self.cfg = cfg
        self.dtype = dtype
        if tracer_tree is None:
            if cfg.column.use_column_package:
                col = cfg.column
                n_bio = col.n_bio_tracers
                if col.use_biogeochemistry and not n_bio:
                    if col.zbgc_params is not None:
                        # size from the actual roster (use_C/DON/Fe/
                        # DMS/PON/hum/zaero extend it)
                        n_bio = col.zbgc_params.n_bio * \
                            (col.n_bio_layers + 1)
                    else:
                        n_bio = (col.n_algae + 3) * \
                            (col.n_bio_layers + 1)
                tracer_tree = standard_tracer_tree(
                    n_ice_layers=cfg.run.n_ice_layers,
                    n_snow_layers=cfg.run.n_snow_layers,
                    use_ice_age=col.use_ice_age,
                    use_first_year_ice=col.use_first_year_ice,
                    use_level_ice=col.use_level_ice,
                    pond_scheme=col.pond_scheme,
                    use_snow_tracers=col.use_snow_tracers,
                    n_aerosols=col.n_aerosols,
                    use_brine_height=(col.use_brine_height or
                                      col.use_biogeochemistry or
                                      col.solve_zsalinity),
                    n_bio_tracers=n_bio,
                    n_bio_grid_points=(col.n_bio_layers + 1
                                       if col.use_biogeochemistry
                                       else 0),
                    use_skeletal_bgc=col.use_skeletal_biochemistry,
                    n_vertical_salinity=(col.n_bio_layers if
                                         col.solve_zsalinity else 0))
            else:
                tracer_tree = TracerTree((
                    mass_only_tree().specs[0],
                    standard_tracer_tree().specs[1],
                    standard_tracer_tree().specs[2],
                ))
        self.tree = tracer_tree

        mesh_t = mesh.tensors(dtype)
        dyn_t = build_dynamics_tensors(mesh, cfg, dtype)
        remap_t = None
        upwind_t = None
        if cfg.advection.advection_type == AdvectionType.INCREMENTAL_REMAP:
            remap_t = build_remap_geometry(
                mesh,
                rotate_cartesian_grid=cfg.velocity.rotate_cartesian_grid
            ).tensors(dtype)
        elif cfg.advection.advection_type == AdvectionType.UPWIND:
            from .transport.upwind import build_upwind_tensors
            upwind_t = build_upwind_tensors(mesh, dtype)
        self.tensors = ModelTensors(
            mesh=mesh_t, dynamics=dyn_t, remap=remap_t, upwind=upwind_t,
            area_cell=jnp.asarray(mesh.area_cell, dtype))
        self.column = None
        if cfg.column.use_column_package:
            col = cfg.column
            self.column = ColumnPhysics(
                cfg.run.n_categories, cfg.run.n_ice_layers,
                cfg.run.n_snow_layers, kcatbound=col.kcatbound,
                kitd=col.kitd,
                krdg_partic=col.krdg_partic,
                krdg_redist=col.krdg_redist,
                natmiter=col.natmiter,
                shortwave=col.shortwave,
                ktherm=col.ktherm, kstrength=col.kstrength,
                atmbndy=col.atmbndy,
                use_shortwave=col.use_shortwave,
                use_vertical_thermodynamics=
                col.use_vertical_thermodynamics,
                use_itd_thermodynamics=col.use_itd_thermodynamics,
                pond_scheme=col.pond_scheme,
                use_level_ice=col.use_level_ice or
                col.pond_scheme == "lvl",
                use_ice_age=col.use_ice_age,
                use_first_year_ice=col.use_first_year_ice,
                use_snow_tracers=col.use_snow_tracers,
                snwredist=col.snwredist,
                n_aerosols=col.n_aerosols,
                use_form_drag=col.use_form_drag,
                highfreq=col.highfreq,
                tfrz_option=col.tfrz_option,
                rfracmin=col.rfracmin, rfracmax=col.rfracmax,
                pndaspect=col.pndaspect, frzpnd=col.frzpnd,
                dpscale=col.dpscale, hi_min_pond=col.hi_min_pond,
                mu_rdg=col.mu_rdg,
                shortwave_tuning=dict(
                    albicev=col.albicev, albicei=col.albicei,
                    albsnowv=col.albsnowv, albsnowi=col.albsnowi,
                    ahmax=col.ahmax, R_ice=col.r_ice, R_pnd=col.r_pnd,
                    R_snw=col.r_snw, dT_mlt=col.dt_mlt,
                    rsnw_mlt=col.rsnw_mlt),
                zbgc_params=col.zbgc_params,
                tunables=_col_tunables(col),
                use_snicar=col.use_snicar,
                use_brine_height=col.use_brine_height,
                use_biogeochemistry=col.use_biogeochemistry,
                use_skeletal_bgc=col.use_skeletal_biochemistry,
                n_algae=col.n_algae,
                n_bio_layers=col.n_bio_layers,
                solve_zsalinity=col.solve_zsalinity,
                calc_tsfc=col.calc_surface_temperature,
                use_snow_liquid_ponds=col.use_snow_liquid_ponds,
                include_pond_freshwater_feedback=
                col.include_pond_freshwater_feedback,
                use_modal_aerosols=col.use_modal_aerosols)

    # -- state ---------------------------------------------------------------

    def init_state(self, ice_area_cat=None, ice_volume_cat=None,
                   snow_volume_cat=None) -> State:
        nc = self.mesh.n_cells
        ncat = self.cfg.run.n_categories
        dt = self.dtype
        z2 = jnp.zeros((nc, ncat), dt)
        tr = {}
        for spec in self.tree.specs:
            shape = (nc, ncat) + ((spec.n_layers,) if spec.n_layers else ())
            tr[spec.name] = jnp.zeros(shape, dt)
        # non-zero tracer defaults: undeformed initial ice is all level;
        # fresh snow grain radius (reference init_column_tracers)
        if "levelIceArea" in tr:
            tr["levelIceArea"] = jnp.ones((nc, ncat), dt)
            tr["levelIceVolume"] = jnp.ones((nc, ncat), dt)
        if "snowGrainRadius" in tr:
            from .column.snow import RSNW_FALL
            tr["snowGrainRadius"] = jnp.full(
                tr["snowGrainRadius"].shape, RSNW_FALL, dt)
        if "brineHeight" in tr:
            tr["brineHeight"] = jnp.ones((nc, ncat), dt)
        if "bioMobileFraction" in tr:
            # zbgc_frac_init = 1: all-mobile initial phase partition
            # (reference ice_colpkg.F90:1510-1522)
            tr["bioMobileFraction"] = jnp.ones(
                tr["bioMobileFraction"].shape, dt)
        if "verticalSalinity" in tr:
            from .column.thermo_shared import salinity_profile
            prof = salinity_profile(tr["verticalSalinity"].shape[-1])
            tr["verticalSalinity"] = jnp.broadcast_to(
                jnp.asarray(prof, dt), tr["verticalSalinity"].shape)
        if ice_area_cat is not None:
            tr["iceAreaCategory"] = jnp.asarray(ice_area_cat, dt)
        if ice_volume_cat is not None:
            tr["iceVolumeCategory"] = jnp.asarray(ice_volume_cat, dt)
        if snow_volume_cat is not None:
            tr["snowVolumeCategory"] = jnp.asarray(snow_volume_cat, dt)
        # physical enthalpy/salinity/Tsfc profiles wherever there is
        # ice: zero-enthalpy "ice" sits exactly at the melting point
        # and the thermo solvers cannot close its energy budget (the
        # reference always initializes via colpkg_init_trcr)
        if ice_area_cat is not None and "iceEnthalpy" in tr:
            from .column.thermo_shared import init_thermo_tracers
            tr = init_thermo_tracers(tr, self.cfg.run.n_ice_layers,
                                     self.cfg.run.n_snow_layers, dt)
        return State(
            velocity=init_velocity_state(self.mesh, dt),
            tracers=tr,
            time=jnp.zeros((), dt),
        )

    # -- step ----------------------------------------------------------------

    def _mesh_structure(self, halo_exchange_vertex=None):
        """(raster layout or None, panel size N or None) of the mesh."""
        from .mesh.structured import detect_raster_quad
        raster = detect_raster_quad(self.mesh)
        lay = getattr(self.mesh, "panel_layout", None)
        panel_n = (lay.N if lay is not None
                   and self.tensors.dynamics.panel is not None
                   and halo_exchange_vertex is None else None)
        return raster, panel_n

    def velocity_path(self) -> str:
        """The subcycle formulation make_step runs (evp.velocity_path)."""
        raster, panel_n = self._mesh_structure()
        return evp.velocity_path(self.cfg, self.tensors.dynamics, raster,
                                 panel_n)

    def make_step(self, halo_exchange_vertex=None, jit: bool = True):
        """Build step(tensors, state, forcing) -> (state, diags).

        The ModelTensors are a traced argument (compile-time constants blow
        up compile time and kill the persistent cache)."""
        cfg = self.cfg
        tree = self.tree
        raster, panel_n = self._mesh_structure(halo_exchange_vertex)
        vel_step = evp.make_velocity_solver(
            cfg, halo_exchange_vertex=halo_exchange_vertex,
            min_dv_edge=float(np.min(self.mesh.dv_edge[
                self.mesh.dv_edge > 0])),
            raster=raster,
            panel_n=panel_n)
        use_remap = (cfg.advection.advection_type ==
                     AdvectionType.INCREMENTAL_REMAP)
        use_upwind = (cfg.advection.advection_type ==
                      AdvectionType.UPWIND)
        if use_remap:
            remap_step = make_remap_step(
                tree, self.mesh.vertex_degree,
                monotonic=cfg.advection.monotonic)
        adv_checks = (cfg.advection.conservation_check or
                      cfg.advection.monotonicity_check)
        if use_upwind:
            from .transport.upwind import make_upwind_step
            upwind_step = make_upwind_step(tree)
        dt_dyn = cfg.dynamics_timestep
        n_sub = cfg.velocity.dynamics_subcycle_number

        column = self.column
        use_column = cfg.column.use_column_package
        use_ridging = use_column and cfg.column.use_ridging

        use_kstrength = (use_column and
                         cfg.column.kstrength == 1)
        highfreq = use_column and cfg.column.highfreq

        def step(tensors: ModelTensors, state: State,
                 forcing: DynamicsForcing,
                 atmos: Optional[AtmosForcing] = None,
                 ocean: Optional[OceanForcing] = None,
                 coszen=None, day_of_year=None, lat=None,
                 faero_atm=None, sfc_fluxes=None):
            """One coupling timestep (reference seaice_timestep,
            mpas_seaice_time_integration.F:42-175): column pre-dynamics
            -> (velocity solve -> transport -> ridging) x n_sub ->
            column post-dynamics.

            coszen: cell cosine solar zenith (dEdd shortwave).
            day_of_year/lat: first-year-ice tracer reset inputs.
            faero_atm [nCells, nAero]: aerosol deposition rate.
            sfc_fluxes: calc_Tsfc=False prescribed per-category surface
            fluxes (dict: fsurf/fcondtop/flat/fsens [nCells, nCat])."""
            tr = dict(state.tracers)
            vel = state.velocity
            diags = {}
            fluxes = None
            if use_column and atmos is not None:
                uvel_c = vvel_c = None
                if highfreq:
                    from .mesh.core import vertex_to_cell
                    uvel_c = vertex_to_cell(tensors.mesh, vel.u_velocity)
                    vvel_c = vertex_to_cell(tensors.mesh, vel.v_velocity)
                tr, fluxes = column.step_thermodynamics(
                    cfg.run.dt, tr, atmos, ocean, coszen=coszen,
                    uvel=uvel_c, vvel=vvel_c,
                    day_of_year=day_of_year, lat=lat,
                    faero_atm=faero_atm, sfc_fluxes=sfc_fluxes)
            for _ in range(n_sub):
                if cfg.velocity.use_velocity_solver:
                    pressure_in = None
                    if use_kstrength:
                        # Rothrock strength from the column package
                        # (reference kstrength dispatch,
                        # ice_mechred.F90 ice_strength)
                        pressure_in = column.ice_strength(tr)
                    vel, diags = vel_step(
                        tensors.dynamics, vel, forcing,
                        tr["iceAreaCategory"], tr["iceVolumeCategory"],
                        tr["snowVolumeCategory"],
                        pressure_in=pressure_in)
                if use_remap:
                    if adv_checks:
                        from .transport.remap import (
                            global_conserved_sums, local_extrema)
                        pre_sums = (global_conserved_sums(
                            tree, tr, tensors.area_cell)
                            if cfg.advection.conservation_check
                            else None)
                        pre_ext = (local_extrema(
                            tree, tr, tensors.mesh.cells_on_cell,
                            tensors.mesh.cells_on_cell_mask)
                            if cfg.advection.monotonicity_check
                            else None)
                    tr = remap_step(
                        tensors.remap, tensors.mesh.cells_on_cell,
                        tensors.mesh.cells_on_cell_mask, tensors.area_cell,
                        tr, vel.u_velocity, vel.v_velocity, dt_dyn)
                    if adv_checks:
                        # runtime self-checks (reference optional IR
                        # checks, ..._incremental_remap.F:8126,8416)
                        if pre_sums is not None:
                            post = global_conserved_sums(
                                tree, tr, tensors.area_cell)
                            err = jnp.stack([
                                jnp.abs(post[k] - pre_sums[k]) /
                                jnp.maximum(jnp.abs(pre_sums[k]),
                                            1e-30)
                                for k in pre_sums]).max()
                            diags["ir_conservation_error"] = jnp.maximum(
                                diags.get("ir_conservation_error", 0.0),
                                err)
                        if pre_ext is not None:
                            from .transport.remap import (
                                monotonicity_violation)
                            viol = monotonicity_violation(
                                tree, tr, *pre_ext)
                            diags["ir_monotonicity_violation"] = \
                                jnp.maximum(diags.get(
                                    "ir_monotonicity_violation", 0.0),
                                    viol)
                elif use_upwind:
                    tr = upwind_step(
                        tensors.upwind, tensors.area_cell, tr,
                        vel.u_velocity, vel.v_velocity, dt_dyn)
                if use_ridging and diags:
                    tr, rdg = column.step_ridging(
                        dt_dyn, tr, diags["ridge_convergence"],
                        diags["ridge_shear"])
                    diags.update(rdg)
            if use_column and atmos is not None:
                # post-dynamics: snow physics + coupling prep
                # (reference column.F:1208)
                wind = jnp.sqrt(atmos.u_air ** 2 + atmos.v_air ** 2)
                tr, post = column.step_post_dynamics(
                    cfg.run.dt, tr, wind=wind,
                    snow_rate=atmos.snow_rate)
                diags["coupling_prep"] = post
            if fluxes is not None:
                diags["column_fluxes"] = fluxes
            new_state = State(velocity=vel, tracers=tr,
                              time=state.time + cfg.run.dt)
            return new_state, diags

        if jit:
            step = jax.jit(step)
        return step
