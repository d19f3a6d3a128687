"""EVP velocity solver driver.

The performance core: one jitted program per dynamics step covering the
reference's pre-subcycle prep kernels, the ~120-iteration elastic subcycle
loop (strain -> EVP stress -> stress divergence -> ocean-stress coefficient
-> 2x2 implicit momentum solve), and the post-subcycle diagnostics
(reference `mpas_seaice_velocity_solver.F:562-3700`). The subcycle loop is
a `lax.fori_loop` so the whole solver compiles to a single XLA program with
the working set resident on device — the JAX equivalent of the
reference's OpenACC persistent data region (mesh_pool.F:145-172).
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as c
from ..config import (Config, ConstitutiveRelation, OceanStressType,
                      StrainScheme, StressDivergenceScheme)
from ..mesh.core import Mesh, MeshTensors, cell_to_vertex
from ..utils.pytree import pytree_dataclass, replace
from . import constitutive, variational
from .weak import WeakTensors, build_weak_tensors, strain_tensor_weak, \
    stress_divergence_weak


@pytree_dataclass
class DynamicsTensors:
    """Static per-mesh tensors for the velocity solver (device arrays)."""
    mesh: MeshTensors
    basis_gradient_u: Any        # [nCells, maxEdges, maxEdges]
    basis_gradient_v: Any
    basis_integrals_u: Any       # [nCells, maxEdges, maxEdges]
    basis_integrals_v: Any
    basis_integrals_metric: Any
    variational_denominator: Any  # [nVertices]
    tan_lat_vertex: Any          # [nVertices] tan(lat)/r metric factor
    weak: Optional[WeakTensors]  # line-integral scheme tensors
    fast: Optional[Any]          # transposed-layout subcycle tensors
    area_cell: Any               # [nCells]
    area_triangle: Any           # [nVertices]
    panel: Optional[Any] = None  # panel-shift tensors (icosahedral)


def build_dynamics_tensors(mesh: Mesh, cfg: Config,
                           dtype=jnp.float32) -> DynamicsTensors:
    """Init-time basis precompute + device upload
    (reference seaice_init_velocity_solver, velocity_solver.F:85-386)."""
    from ..ops.basis import compute_variational_basis

    vb = compute_variational_basis(
        mesh,
        basis_type=cfg.velocity.variational_basis.value,
        integration_type=cfg.velocity.integration_type,
        integration_order=cfg.velocity.integration_order,
        denominator_type=cfg.velocity.variational_denominator.value,
        include_metric_terms=cfg.velocity.include_metric_terms,
        rotate_cartesian_grid=cfg.velocity.rotate_cartesian_grid,
    )
    use_weak = (cfg.velocity.strain_scheme == StrainScheme.WEAK or
                cfg.velocity.stress_divergence_scheme ==
                StressDivergenceScheme.WEAK)
    from .variational_fast import build_fast_tensors
    fast = None
    if not use_weak:
        fast = build_fast_tensors(mesh, vb, dtype)
    # panel-shift tensors when the mesh carries a rhombic-panel layout
    # (mesh/panels.panel_reorder attaches it)
    panel = None
    lay = getattr(mesh, "panel_layout", None)
    if lay is not None and not use_weak and mesh.max_edges == 6:
        from .variational_panel import build_panel_tensors
        panel = build_panel_tensors(mesh, lay, vb, dtype)
    return DynamicsTensors(
        panel=panel,
        mesh=mesh.tensors(dtype),
        basis_gradient_u=jnp.asarray(vb.basis_gradient_u, dtype),
        basis_gradient_v=jnp.asarray(vb.basis_gradient_v, dtype),
        basis_integrals_u=jnp.asarray(vb.basis_integrals_u, dtype),
        basis_integrals_v=jnp.asarray(vb.basis_integrals_v, dtype),
        basis_integrals_metric=jnp.asarray(vb.basis_integrals_metric, dtype),
        variational_denominator=jnp.asarray(vb.variational_denominator,
                                            dtype),
        tan_lat_vertex=jnp.asarray(vb.tan_lat_vertex_over_radius, dtype),
        weak=build_weak_tensors(
            mesh, dtype,
            rotate_cartesian_grid=cfg.velocity.rotate_cartesian_grid)
        if use_weak else None,
        fast=fast,
        area_cell=jnp.asarray(mesh.area_cell, dtype),
        area_triangle=jnp.asarray(mesh.area_triangle, dtype),
    )


@pytree_dataclass
class SubcycleOverlap:
    """Subset tensors for the interior/boundary comm-compute overlap.

    Under sharding, the per-subcycle halo exchange is on the critical
    path: every vertex of the next iteration waits on the ppermute
    (reference: the MPI exchange per elastic subcycle,
    velocity_solver.F:2546-2584; SURVEY section 5 calls for the
    interior/boundary split).  These tensors let the subcycle body
    compute next-iteration velocities at the EXPORT vertices first —
    through a small redundant strain->stress->divergence->momentum
    pipeline over only the cells adjacent to them — so the ppermute of
    the export buffer is issued before, and is data-independent of, the
    full-grid pipeline; XLA's latency-hiding scheduler can then overlap
    the collective with the interior compute."""
    export_idx: Any        # [nE] local owned vertex ids (0-padded)
    ec_idx: Any            # [nEc] local cell ids adjacent to exports
    voc_T_E: Any           # [me, nEc] corner vertex ids
    voc_mask_T_E: Any      # [me, nEc]
    basis_grad_T_E: Any    # [me(b), 2, me(g), nEc]
    basis_int_T_E: Any     # [me(s), 2, me(j), nEc]
    flat_corner_idx_E: Any  # [vd, nE] = pos_in_ec*me + cva
    cov_mask_E: Any        # [vd, nE]


def build_subcycle_overlap(mesh: Mesh, fast,
                           vertex_export_idx: np.ndarray,
                           dtype=jnp.float32) -> SubcycleOverlap:
    """Host-side subset extraction from a block's FastTensors."""
    me = mesh.max_edges
    E = np.asarray(vertex_export_idx, np.int64)
    cov = np.asarray(mesh.cells_on_vertex)[E]          # [nE, vd]
    ec = np.unique(cov[cov >= 0])
    if len(ec) == 0:
        ec = np.zeros(1, np.int64)
    pos = np.full(mesh.n_cells, 0, np.int64)
    pos[ec] = np.arange(len(ec))

    voc_T = np.asarray(fast.voc_T)
    voc_mask_T = np.asarray(fast.voc_mask_T)
    bg = np.asarray(fast.basis_grad_T)
    bi = np.asarray(fast.basis_int_T)
    cva = np.asarray(mesh.cell_vertices_at_vertex)[E]  # [nE, vd]
    ok = (cov >= 0) & (cva >= 0)
    flat = pos[np.where(ok, cov, 0)] * me + np.where(ok, cva, 0)

    return SubcycleOverlap(
        export_idx=jnp.asarray(E, jnp.int32),
        ec_idx=jnp.asarray(ec, jnp.int32),
        voc_T_E=jnp.asarray(voc_T[:, ec], jnp.int32),
        voc_mask_T_E=jnp.asarray(voc_mask_T[:, ec], dtype),
        basis_grad_T_E=jnp.asarray(bg[..., ec], dtype),
        basis_int_T_E=jnp.asarray(bi[..., ec], dtype),
        flat_corner_idx_E=jnp.asarray(flat.T, jnp.int32),
        cov_mask_E=jnp.asarray(ok.T, dtype),
    )


@pytree_dataclass
class VelocitySolverState:
    """Prognostic state of the velocity solver."""
    u_velocity: Any              # [nVertices]
    v_velocity: Any              # [nVertices]
    stress11: Any                # [nCells, maxEdges] corner stresses
    stress22: Any
    stress12: Any
    solve_velocity_prev: Any     # [nVertices] mask from previous step


def init_velocity_state(mesh: Mesh, dtype=jnp.float32) -> VelocitySolverState:
    nv, nc, me = mesh.n_vertices, mesh.n_cells, mesh.max_edges
    z = functools.partial(jnp.zeros, dtype=dtype)
    return VelocitySolverState(
        u_velocity=z((nv,)), v_velocity=z((nv,)),
        stress11=z((nc, me)), stress22=z((nc, me)), stress12=z((nc, me)),
        solve_velocity_prev=z((nv,)),
    )


@pytree_dataclass
class DynamicsForcing:
    """External forcing fields for one dynamics step (cell-centered unless
    noted)."""
    u_air_velocity: Any          # [nCells]
    v_air_velocity: Any
    air_density: Any             # [nCells]
    u_ocean_velocity: Any        # [nCells]
    v_ocean_velocity: Any
    sea_surface_tilt_u: Any      # [nCells]
    sea_surface_tilt_v: Any
    land_ice_mask: Any           # [nCells] float {0,1}


def zero_forcing(mesh: Mesh, dtype=jnp.float32) -> DynamicsForcing:
    z = functools.partial(jnp.zeros, dtype=dtype)
    nc = mesh.n_cells
    return DynamicsForcing(
        u_air_velocity=z((nc,)), v_air_velocity=z((nc,)),
        air_density=jnp.full((nc,), c.DENSITY_AIR, dtype),
        u_ocean_velocity=z((nc,)), v_ocean_velocity=z((nc,)),
        sea_surface_tilt_u=z((nc,)), sea_surface_tilt_v=z((nc,)),
        land_ice_mask=z((nc,)),
    )


@pytree_dataclass
class IceMassState:
    """Aggregate mass/area fields entering the momentum solve."""
    ice_area_cell: Any           # [nCells] fractional area
    ice_volume_cell: Any         # [nCells] m
    snow_volume_cell: Any        # [nCells] m
    open_water_area: Any         # [nCells]


def aggregate_mass(ice_area_cat, ice_volume_cat, snow_volume_cat):
    """Category aggregation (reference velocity_solver.F:685-752).
    Inputs [nCells, nCategories]."""
    area = ice_area_cat.sum(axis=1)
    vol = ice_volume_cat.sum(axis=1)
    snow = snow_volume_cat.sum(axis=1)
    return IceMassState(
        ice_area_cell=area, ice_volume_cell=vol, snow_volume_cell=snow,
        open_water_area=jnp.maximum(1.0 - area, 0.0))


# -- pre-subcycle prep kernels ------------------------------------------------

def _computation_masks(mass: IceMassState, forcing: DynamicsForcing,
                       dyn: DynamicsTensors):
    """solveStress (cells) and solveVelocity (vertices) masks
    (reference velocity_solver.F:961-1150)."""
    mesh = dyn.mesh
    total_mass = (mass.ice_volume_cell * c.DENSITY_ICE +
                  mass.snow_volume_cell * c.DENSITY_SNOW)
    has_ice = ((mass.ice_area_cell > c.ICE_AREA_MINIMUM) &
               (total_mass > c.ICE_MASS_MINIMUM) &
               (forcing.land_ice_mask == 0)).astype(total_mass.dtype)

    # a cell solves stress if it or any neighbor has ice
    neigh = has_ice[mesh.cells_on_cell] * mesh.cells_on_cell_mask
    solve_stress = jnp.maximum(has_ice, neigh.max(axis=1))

    area_vertex = cell_to_vertex(mesh, mass.ice_area_cell)
    mass_vertex = cell_to_vertex(mesh, total_mass)
    land_vertex = cell_to_vertex(mesh, forcing.land_ice_mask)
    solve_velocity = (
        (mesh.interior_vertex > 0) &
        (land_vertex == 0) &
        (area_vertex > c.ICE_AREA_MINIMUM) &
        (mass_vertex > c.ICE_MASS_MINIMUM)).astype(total_mass.dtype)
    return solve_stress, solve_velocity, total_mass, mass_vertex, area_vertex


def _ice_strength_hibler(mass: IceMassState, solve_stress):
    """Hibler (1979) P = P* h exp(-C (1-a))
    (reference velocity_solver.F:1422-1435)."""
    p = (c.ICE_STRENGTH_HIBLER_P * mass.ice_volume_cell *
         jnp.exp(-c.ICE_STRENGTH_HIBLER_C * (1.0 - mass.ice_area_cell)))
    return jnp.where(solve_stress > 0, p, 0.0)


def _air_stress(forcing: DynamicsForcing, mass: IceMassState,
                dyn: DynamicsTensors, use_air_stress: bool):
    """Constant-coefficient quadratic air drag, interpolated to vertices
    (reference velocity_solver.F:1665-1728)."""
    if not use_air_stress:
        nv = dyn.mesh.n_vertices
        z = jnp.zeros((nv,), forcing.u_air_velocity.dtype)
        return z, z
    wind = jnp.sqrt(forcing.u_air_velocity ** 2 +
                    forcing.v_air_velocity ** 2)
    coeff = forcing.air_density * wind * c.AIR_STRESS_COEFF * \
        mass.ice_area_cell
    tau_u = coeff * forcing.u_air_velocity
    tau_v = coeff * forcing.v_air_velocity
    return (cell_to_vertex(dyn.mesh, tau_u),
            cell_to_vertex(dyn.mesh, tau_v))


# -- solver -------------------------------------------------------------------

def velocity_path(cfg: Config, dyn: DynamicsTensors, raster=None,
                  panel_n: Optional[int] = None) -> str:
    """The elastic-subcycle formulation make_velocity_solver runs, chosen
    from the scheme and from the structure the mesh carries:

    'weak'      line-integral scheme (dynamics/weak.py);
    'reference' variational.py on the [nCells, maxEdges] layout (averaged
                strains need it);
    'panel'     rhombic-panel shifts on a panel-ordered icosahedral mesh
                (mesh/panels.py + dynamics/variational_panel.py);
    'raster'    structured shifts on a planar regular quad grid without
                metric terms (mesh/structured.py);
    'gather'    cell-minor gathers for any other connectivity
                (dynamics/variational_fast.py)."""
    v = cfg.velocity
    if v.strain_scheme == StrainScheme.WEAK:
        return "weak"
    if dyn.fast is None or v.average_variational_strains:
        return "reference"
    if panel_n is not None and dyn.panel is not None:
        return "panel"
    if raster is not None and not v.include_metric_terms:
        return "raster"
    return "gather"


def make_velocity_solver(cfg: Config, dyn: DynamicsTensors = None,
                         halo_exchange_vertex=None,
                         halo_exchange_cell_field=None,
                         halo_exchange_vertex_field=None,
                         min_dv_edge: float = None,
                         raster=None,
                         halo_overlap=None,
                         panel_n: Optional[int] = None):
    """Build the dynamics-step function.

    The returned step takes the DynamicsTensors as its first ARGUMENT (not
    a closure) so jit traces the mesh/basis tensors as inputs rather than
    folding them into the program as constants — constant-embedding blows
    compile time up by two orders of magnitude and breaks the persistent
    compilation cache.

    halo_exchange_vertex: optional callable (u, v) -> (u, v) run after each
    velocity update — identity on a single device, a collective under
    shard_map.
    halo_exchange_cell_field / halo_exchange_vertex_field: optional
    single-array halo refreshers applied to the pre-subcycle fields whose
    local stencils extend beyond the halo (solveStress mask; the
    solveVelocity/velocity group) — mirrors the reference's
    solveVelocity/icePressure exchange groups (velocity_solver.F:257-345).
    min_dv_edge: global minimum edge length (needed for revised EVP; the
    reference computes it with an MPI min-reduction at init,
    constitutive_relation.F:133-162).
    halo_overlap: (SubcycleOverlap, exchange_from_buf, n_owned) for the
    sharded interior/boundary comm-compute overlap: next-iteration
    velocities at the export vertices are computed first through a small
    subset pipeline, the halo collective is issued on that buffer, and
    the full-grid pipeline runs concurrently (the collective is
    data-independent of it).  Requires standard EVP on the fast path
    without metric terms; mutually exclusive with halo_exchange_vertex
    being the subcycle exchange (pass the identity there).
    dyn: optional; if given, returns a convenience wrapper with dyn bound
    via partial application of the first argument (still traced).

    Returns step(dyn, state, forcing, ice_area_cat, ice_volume_cat,
                 snow_volume_cat) -> (state, diagnostics dict).
    """
    v_cfg = cfg.velocity
    dt_e = cfg.elastic_timestep
    dt_dyn = cfg.dynamics_timestep
    damping_t = cfg.evp_damping_timescale
    relation = v_cfg.constitutive_relation

    use_weak = v_cfg.strain_scheme == StrainScheme.WEAK
    if (v_cfg.stress_divergence_scheme == StressDivergenceScheme.WEAK) \
            != use_weak:
        raise NotImplementedError(
            "mixed weak/variational strain and stress-divergence schemes "
            "are not supported; choose one scheme for both")

    if halo_exchange_vertex is None:
        def halo_exchange_vertex(u, v):
            return u, v
    if halo_exchange_cell_field is None:
        def halo_exchange_cell_field(f):
            return f
    if halo_exchange_vertex_field is None:
        def halo_exchange_vertex_field(f):
            return f

    def internal_stress(dyn, u, v, s11, s22, s12, pressure, solve_stress_c):
        mesh = dyn.mesh
        """One stress evaluation: strain -> constitutive -> divergence
        (reference seaice_internal_stress, velocity_solver.F:2606-2863)."""
        if use_weak:
            # weak scheme: cell-centered strains/stresses carried in
            # corner slot 0 of the stress state arrays
            e11c, e22c, e12c = strain_tensor_weak(
                dyn.weak, mesh, u, v, dyn.area_cell, solve_stress_c)
            e11 = e11c[:, None]
            e22 = e22c[:, None]
            e12 = e12c[:, None]
        else:
            e11, e22, e12 = variational.strain_tensor(
                u, v, dyn.tan_lat_vertex, mesh,
                dyn.basis_gradient_u, dyn.basis_gradient_v)
            if v_cfg.average_variational_strains:
                e11, e22, e12 = variational.average_strains(e11, e22, e12,
                                                            mesh)

        ss = solve_stress_c[:, None]
        if relation == ConstitutiveRelation.EVP:
            s11n, s22n, s12n, rp = constitutive.evp_stress_update(
                s11, s22, s12, e11, e22, e12, pressure[:, None],
                dt_e, damping_t)
        elif relation == ConstitutiveRelation.EVP_REVISED:
            s11n, s22n, s12n, rp = constitutive.evp_stress_update_revised(
                s11, s22, s12, e11, e22, e12, pressure[:, None])
        elif relation == ConstitutiveRelation.LINEAR:
            s11n, s22n, s12n = constitutive.linear_stress(e11, e22, e12)
            rp = jnp.zeros_like(s11n)
        else:  # NONE
            s11n, s22n, s12n, rp = s11, s22, s12, jnp.zeros_like(s11)
        s11 = jnp.where(ss > 0, s11n, s11)
        s22 = jnp.where(ss > 0, s22n, s22)
        s12 = jnp.where(ss > 0, s12n, s12)
        return (s11, s22, s12, e11, e22, e12, rp)

    def ocean_stress_coefficient(u, v, uo_v, vo_v, area_vertex,
                                 solve_velocity):
        """(reference velocity_solver.F:2986-3082)"""
        if not v_cfg.use_ocean_stress:
            return jnp.zeros_like(u)
        if v_cfg.ocean_stress_type == OceanStressType.QUADRATIC:
            coeff = (c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER * area_vertex *
                     jnp.sqrt((uo_v - u) ** 2 + (vo_v - v) ** 2))
        else:
            coeff = c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER * area_vertex
        return jnp.where(solve_velocity > 0, coeff, 0.0)

    def solve_velocity_evp(u, v, mass_vertex, mass_f, div_u, div_v,
                           air_u, air_v, tilt_u, tilt_v,
                           ocean_u, ocean_v, ocean_coeff, solve_velocity):
        """2x2 implicit point solve (reference velocity_solver.F:3096-3208)."""
        sgn = jnp.sign(mass_f)
        sgn = jnp.where(sgn == 0, 1.0, sgn)
        a11 = mass_vertex / dt_e + \
            ocean_coeff * c.COS_OCEAN_TURNING_ANGLE
        a12 = -mass_f - ocean_coeff * c.SIN_OCEAN_TURNING_ANGLE * sgn
        a21 = mass_f + ocean_coeff * c.SIN_OCEAN_TURNING_ANGLE * sgn
        a22 = a11
        rhs1 = div_u + air_u + tilt_u + ocean_coeff * ocean_u + \
            mass_vertex * u / dt_e
        rhs2 = div_v + air_v + tilt_v + ocean_coeff * ocean_v + \
            mass_vertex * v / dt_e
        det = a11 * a22 - a12 * a21
        det = jnp.where(det == 0, 1.0, det)
        u_new = (a22 * rhs1 - a12 * rhs2) / det
        v_new = (a11 * rhs2 - a21 * rhs1) / det
        u = jnp.where(solve_velocity > 0, u_new, u)
        v = jnp.where(solve_velocity > 0, v_new, v)
        return u, v

    def solve_velocity_revised_evp(u, v, u_init, v_init, mass_vertex, mass_f,
                                   div_u, div_v, air_u, air_v, tilt_u, tilt_v,
                                   ocean_u, ocean_v, ocean_coeff,
                                   solve_velocity, brlx):
        """Revised-EVP point solve (reference velocity_solver.F:3222-3358)."""
        sgn = jnp.sign(mass_f)
        sgn = jnp.where(sgn == 0, 1.0, sgn)
        a11 = (brlx + 1.0) * mass_vertex / dt_dyn + \
            ocean_coeff * c.COS_OCEAN_TURNING_ANGLE
        a12 = -mass_f - ocean_coeff * c.SIN_OCEAN_TURNING_ANGLE * sgn
        a21 = -a12
        a22 = a11
        rhs1 = div_u + air_u + tilt_u + ocean_coeff * ocean_u + \
            mass_vertex * (brlx * u + u_init) / dt_dyn
        rhs2 = div_v + air_v + tilt_v + ocean_coeff * ocean_v + \
            mass_vertex * (brlx * v + v_init) / dt_dyn
        det = a11 * a22 - a12 * a21
        det = jnp.where(det == 0, 1.0, det)
        u_new = (a22 * rhs1 - a12 * rhs2) / det
        v_new = (a11 * rhs2 - a21 * rhs1) / det
        u = jnp.where(solve_velocity > 0, u_new, u)
        v = jnp.where(solve_velocity > 0, v_new, v)
        return u, v

    def step(dyn: DynamicsTensors, state: VelocitySolverState,
             forcing: DynamicsForcing,
             ice_area_cat, ice_volume_cat, snow_volume_cat,
             pressure_in: Optional[Any] = None):
        """One dynamics step of the velocity solver.

        pressure_in: optional externally computed ice strength [nCells]
        (from the column package); default Hibler.
        """
        mesh = dyn.mesh
        dtype = state.u_velocity.dtype

        # --- pre-subcycle (reference velocity_solver.F:613-671) ---
        mass = aggregate_mass(ice_area_cat, ice_volume_cat, snow_volume_cat)
        (solve_stress, solve_velocity, total_mass, mass_vertex,
         area_vertex) = _computation_masks(mass, forcing, dyn)
        if not v_cfg.calc_velocity_masks:
            # config_calc_velocity_masks=false: the dynamic ice-presence
            # masks are NOT recomputed (velocity_solver.F:897-900) —
            # solve everywhere the geometry allows
            solve_stress = jnp.ones_like(solve_stress)
            solve_velocity = jnp.where(
                dyn.mesh.interior_vertex > 0, 1.0, 0.0).astype(
                solve_velocity.dtype)
        # the solveStress neighbor-max and the vertex masks reach one ring
        # beyond the halo: refresh from their owners
        solve_stress = halo_exchange_cell_field(solve_stress)
        solve_velocity = halo_exchange_vertex_field(solve_velocity)

        # new-ice velocities (reference :1164-1327)
        uo_v = cell_to_vertex(mesh, forcing.u_ocean_velocity)
        vo_v = cell_to_vertex(mesh, forcing.v_ocean_velocity)
        is_new = (solve_velocity > 0) & (state.solve_velocity_prev == 0)
        u = jnp.where(is_new, uo_v, state.u_velocity)
        v = jnp.where(is_new, vo_v, state.v_velocity)
        u = jnp.where(solve_velocity > 0, u, 0.0)
        v = jnp.where(solve_velocity > 0, v, 0.0)
        u, v = halo_exchange_vertex(u, v)
        u_init, v_init = u, v

        # ice strength (reference :1341-1508)
        if pressure_in is None:
            pressure = _ice_strength_hibler(mass, solve_stress)
        else:
            pressure = jnp.where(solve_stress > 0, pressure_in, 0.0)

        # air stress (reference :1522-1651)
        air_u, air_v = _air_stress(forcing, mass, dyn, v_cfg.use_air_stress)

        # coriolis coefficient (reference :1742-1788)
        mass_f = mass_vertex * mesh.f_vertex

        # ocean stress rotation (reference :1802-1883)
        if v_cfg.use_ocean_stress:
            sgn_f = jnp.sign(mesh.f_vertex)
            sgn_f = jnp.where(sgn_f == 0, 1.0, sgn_f)
            ocean_u = jnp.where(
                solve_velocity > 0,
                uo_v * c.COS_OCEAN_TURNING_ANGLE -
                vo_v * c.SIN_OCEAN_TURNING_ANGLE * sgn_f, 0.0)
            ocean_v = jnp.where(
                solve_velocity > 0,
                uo_v * c.SIN_OCEAN_TURNING_ANGLE * sgn_f +
                vo_v * c.COS_OCEAN_TURNING_ANGLE, 0.0)
        else:
            ocean_u = jnp.zeros_like(u)
            ocean_v = jnp.zeros_like(v)

        # surface tilt (reference :1897-2213)
        if not v_cfg.use_surface_tilt:
            tilt_u = jnp.zeros_like(u)
            tilt_v = jnp.zeros_like(v)
        elif v_cfg.geostrophic_surface_tilt:
            tilt_u = jnp.where(solve_velocity > 0,
                               -mesh.f_vertex * mass_vertex * vo_v, 0.0)
            tilt_v = jnp.where(solve_velocity > 0,
                               mesh.f_vertex * mass_vertex * uo_v, 0.0)
        else:
            tilt_uv = cell_to_vertex(mesh, forcing.sea_surface_tilt_u)
            tilt_vv = cell_to_vertex(mesh, forcing.sea_surface_tilt_v)
            tilt_u = jnp.where(solve_velocity > 0,
                               -c.GRAVITY * mass_vertex * tilt_uv, 0.0)
            tilt_v = jnp.where(solve_velocity > 0,
                               -c.GRAVITY * mass_vertex * tilt_vv, 0.0)

        # init subcycle variables (reference :2227-2386): zero stress
        # where not solving
        ss = solve_stress[:, None]
        s11 = jnp.where(ss > 0, state.stress11, 0.0)
        s22 = jnp.where(ss > 0, state.stress22, 0.0)
        s12 = jnp.where(ss > 0, state.stress12, 0.0)

        # --- elastic subcycle loop (reference :2447-2592) ---

        path = velocity_path(cfg, dyn, raster, panel_n)
        use_fast = path in ("panel", "raster", "gather")
        metric = v_cfg.include_metric_terms

        def momentum_update(u, v, div_u, div_v):
            ocean_coeff = ocean_stress_coefficient(
                u, v, uo_v, vo_v, area_vertex, solve_velocity)
            if relation == ConstitutiveRelation.EVP_REVISED:
                return solve_velocity_revised_evp(
                    u, v, u_init, v_init, mass_vertex, mass_f, div_u,
                    div_v, air_u, air_v, tilt_u, tilt_v, ocean_u,
                    ocean_v, ocean_coeff, solve_velocity, brlx)
            return solve_velocity_evp(
                u, v, mass_vertex, mass_f, div_u, div_v,
                air_u, air_v, tilt_u, tilt_v, ocean_u, ocean_v,
                ocean_coeff, solve_velocity)

        use_raster = path == "raster"
        use_panel = path == "panel"

        if halo_overlap is not None:
            # --- interior/boundary split: overlap the per-subcycle halo
            # collective with the full-grid compute (SURVEY section 5) ---
            if (use_weak or metric or not use_fast or
                    relation != ConstitutiveRelation.EVP or
                    v_cfg.average_variational_strains):
                raise ValueError(
                    "halo_overlap requires the fast variational path "
                    "with standard EVP and no metric terms")
            ov, exchange_from_buf, n_owned = halo_overlap
            from . import variational_fast as vf
            ft = dyn.fast
            E = ov.export_idx
            # loop-invariant subset fields
            pE = pressure[ov.ec_idx][None, :]
            ssE = solve_stress[ov.ec_idx][None, :]
            mvE, mfE = mass_vertex[E], mass_f[E]
            uoE, voE = uo_v[E], vo_v[E]
            auE, avE = air_u[E], air_v[E]
            tuE, tvE = tilt_u[E], tilt_v[E]
            ouE, ovE = ocean_u[E], ocean_v[E]
            svE = solve_velocity[E]
            avertE = area_vertex[E]
            denE = ft.denominator[E]
            ss_T = solve_stress[None, :]
            p_T = pressure[None, :]
            nEc = ov.ec_idx.shape[0]
            me_ = ov.voc_T_E.shape[0]

            def export_pipeline(u, v, t11, t22, t12):
                """strain -> stress -> divergence -> momentum on the
                export-adjacent subset only (same arithmetic as the full
                kernels, restricted to ec_idx / export_idx)."""
                uv = jnp.stack([u, v], axis=-1)
                g = uv[ov.voc_T_E] * ov.voc_mask_T_E[..., None]
                u_c, v_c = g[..., 0], g[..., 1]
                gx = ov.basis_grad_T_E[:, 0]
                gy = ov.basis_grad_T_E[:, 1]
                e11 = (u_c[:, None, :] * gx).sum(0)
                e22 = (v_c[:, None, :] * gy).sum(0)
                e12 = 0.5 * ((u_c[:, None, :] * gy).sum(0) +
                             (v_c[:, None, :] * gx).sum(0))
                n11, n22, n12, _ = constitutive.evp_stress_update(
                    t11[:, ov.ec_idx], t22[:, ov.ec_idx],
                    t12[:, ov.ec_idx], e11, e22, e12, pE, dt_e,
                    damping_t)
                n11 = jnp.where(ssE > 0, n11, t11[:, ov.ec_idx])
                n22 = jnp.where(ssE > 0, n22, t22[:, ov.ec_idx])
                n12 = jnp.where(ssE > 0, n12, t12[:, ov.ec_idx])
                bu = ov.basis_int_T_E[:, 0]
                bv = ov.basis_int_T_E[:, 1]
                pu = (n11[:, None, :] * bu).sum(0) + \
                    (n12[:, None, :] * bv).sum(0)
                pv = (n22[:, None, :] * bv).sum(0) + \
                    (n12[:, None, :] * bu).sum(0)
                stacked = jnp.stack([pu, pv], axis=-1)   # [me, nEc, 2]
                flat = jnp.moveaxis(stacked, 0, 1).reshape(nEc * me_, 2)
                gg = flat[ov.flat_corner_idx_E] * ov.cov_mask_E[..., None]
                du = -gg[..., 0].sum(0)
                dv = -gg[..., 1].sum(0)
                du = jnp.where(svE > 0, du / denE, 0.0)
                dv = jnp.where(svE > 0, dv / denE, 0.0)
                uE, vE = u[E], v[E]
                oc = c.ICE_OCEAN_DRAG * c.DENSITY_SEAWATER * avertE * \
                    jnp.sqrt((uoE - uE) ** 2 + (voE - vE) ** 2)
                oc = jnp.where(svE > 0, oc, 0.0)
                return solve_velocity_evp(
                    uE, vE, mvE, mfE, du, dv, auE, avE, tuE, tvE,
                    ouE, ovE, oc, svE)

            def body(_, carry):
                u, v, t11, t22, t12 = carry
                # phase 1: export vertices first -> issue the collective
                uEn, vEn = export_pipeline(u, v, t11, t22, t12)
                halo_uv = exchange_from_buf(
                    jnp.stack([uEn, vEn], axis=-1))
                # phase 2: full-grid pipeline (independent of the
                # collective -> XLA overlaps them)
                e11, e22, e12 = vf.strain_tensor_T(ft, u, v, False)
                n11, n22, n12, _ = constitutive.evp_stress_update(
                    t11, t22, t12, e11, e22, e12, p_T, dt_e, damping_t)
                t11 = jnp.where(ss_T > 0, n11, t11)
                t22 = jnp.where(ss_T > 0, n22, t22)
                t12 = jnp.where(ss_T > 0, n12, t12)
                div_u, div_v = vf.stress_divergence_T(
                    ft, t11, t22, t12, solve_velocity, False)
                u, v = momentum_update(u, v, div_u, div_v)
                # phase 3: assemble — owner values at export vertices
                # take the phase-1 results (bitwise-consistent with what
                # the neighbours received), halo takes the collective
                u = jnp.concatenate(
                    [u[:n_owned].at[E].set(uEn), halo_uv[..., 0]])
                v = jnp.concatenate(
                    [v[:n_owned].at[E].set(vEn), halo_uv[..., 1]])
                return (u, v, t11, t22, t12)

            u, v, t11, t22, t12 = jax.lax.fori_loop(
                0, v_cfg.elastic_subcycle_number, body,
                (u, v, s11.T, s22.T, s12.T))
            s11, s22, s12 = t11.T, t22.T, t12.T
        elif use_fast:
            # transposed (cell-minor) layout; see variational_fast.py
            from . import variational_fast as vf
            ss_T = solve_stress[None, :]
            p_T = pressure[None, :]

            if use_panel:
                from . import variational_panel as vpn
                # cell fields live in the padded layout on this path
                zc = jnp.zeros(
                    (dyn.panel.basis_grad_S.shape[-1],), dtype)
                ss_T = zc.at[dyn.panel.cell_pad_idx].set(
                    solve_stress)[None, :]
                p_T = zc.at[dyn.panel.cell_pad_idx].set(
                    pressure)[None, :]

            def body(_, carry):
                u, v, t11, t22, t12 = carry
                if use_panel:
                    e11, e22, e12 = vpn.strain_tensor_P(
                        dyn.panel, panel_n, u, v, metric)
                elif use_raster:
                    e11, e22, e12 = vf.strain_tensor_S(
                        dyn.fast, raster, u, v)
                else:
                    e11, e22, e12 = vf.strain_tensor_T(dyn.fast, u, v,
                                                       metric)
                if relation == ConstitutiveRelation.EVP:
                    n11, n22, n12, _ = constitutive.evp_stress_update(
                        t11, t22, t12, e11, e22, e12, p_T, dt_e,
                        damping_t)
                elif relation == ConstitutiveRelation.EVP_REVISED:
                    n11, n22, n12, _ = \
                        constitutive.evp_stress_update_revised(
                            t11, t22, t12, e11, e22, e12, p_T)
                elif relation == ConstitutiveRelation.LINEAR:
                    n11, n22, n12 = constitutive.linear_stress(
                        e11, e22, e12)
                else:
                    n11, n22, n12 = t11, t22, t12
                t11 = jnp.where(ss_T > 0, n11, t11)
                t22 = jnp.where(ss_T > 0, n22, t22)
                t12 = jnp.where(ss_T > 0, n12, t12)
                if use_panel:
                    div_u, div_v = vpn.stress_divergence_P(
                        dyn.panel, panel_n, t11, t22, t12,
                        solve_velocity, metric)
                elif use_raster:
                    div_u, div_v = vf.stress_divergence_S(
                        dyn.fast, raster, t11, t22, t12,
                        solve_velocity)
                else:
                    div_u, div_v = vf.stress_divergence_T(
                        dyn.fast, t11, t22, t12, solve_velocity, metric)
                u, v = momentum_update(u, v, div_u, div_v)
                u, v = halo_exchange_vertex(u, v)
                return (u, v, t11, t22, t12)

            t11_0, t22_0, t12_0 = s11.T, s22.T, s12.T
            if use_panel:
                # loop state is slot-indexed on the panel path
                t11_0 = vpn.stress_ring_to_slot(dyn.panel, t11_0)
                t22_0 = vpn.stress_ring_to_slot(dyn.panel, t22_0)
                t12_0 = vpn.stress_ring_to_slot(dyn.panel, t12_0)
            u, v, t11, t22, t12 = jax.lax.fori_loop(
                0, v_cfg.elastic_subcycle_number, body,
                (u, v, t11_0, t22_0, t12_0))
            if use_panel:
                t11 = vpn.stress_slot_to_ring(dyn.panel, t11)
                t22 = vpn.stress_slot_to_ring(dyn.panel, t22)
                t12 = vpn.stress_slot_to_ring(dyn.panel, t12)
            s11, s22, s12 = t11.T, t22.T, t12.T
        else:
            def body(_, carry):
                u, v, s11, s22, s12 = carry
                s11, s22, s12, e11, e22, e12, _rp = internal_stress(
                    dyn, u, v, s11, s22, s12, pressure, solve_stress)
                if use_weak:
                    div_u, div_v = stress_divergence_weak(
                        dyn.weak, mesh, s11[:, 0], s22[:, 0], s12[:, 0],
                        dyn.area_triangle, solve_velocity)
                else:
                    div_u, div_v = variational.stress_divergence(
                        s11, s22, s12, dyn.tan_lat_vertex, mesh,
                        dyn.basis_integrals_u, dyn.basis_integrals_v,
                        dyn.basis_integrals_metric,
                        dyn.variational_denominator, solve_velocity)
                u, v = momentum_update(u, v, div_u, div_v)
                u, v = halo_exchange_vertex(u, v)
                return (u, v, s11, s22, s12)

            u, v, s11, s22, s12 = jax.lax.fori_loop(
                0, v_cfg.elastic_subcycle_number, body,
                (u, v, s11, s22, s12))

        # --- post-subcycle (reference :3360-3700) ---
        if use_weak:
            e11c, e22c, e12c = strain_tensor_weak(
                dyn.weak, mesh, u, v, dyn.area_cell, solve_stress)
            e11, e22, e12 = e11c[:, None], e22c[:, None], e12c[:, None]
        elif use_panel:
            # final diagnostic strain via the panel-shift formulation
            # (the naive gather layout costs several ms/step at 40k
            # cells; the shifts are ~free)
            from . import variational_panel as vpn
            eS = vpn.strain_tensor_P(dyn.panel, panel_n, u, v, metric)
            e11, e22, e12 = (
                vpn.stress_slot_to_ring(dyn.panel, e).T for e in eS)
        elif use_fast:
            # cell-minor fast layout (variational_fast)
            from . import variational_fast as vf
            eT = vf.strain_tensor_T(dyn.fast, u, v, metric)
            e11, e22, e12 = (e.T for e in eT)
        else:
            e11, e22, e12 = variational.strain_tensor(
                u, v, dyn.tan_lat_vertex, mesh,
                dyn.basis_gradient_u, dyn.basis_gradient_v)
        div, shear, ridge_conv, ridge_shear = \
            variational.final_divergence_shear(
                e11, e22, e12, mesh, solve_stress, c.EVP_ECCENTRICITY_SQ)

        # principal stresses (reference :3443-3555)
        s11m = (s11 * mesh.vertices_on_cell_mask).sum(axis=1) / \
            jnp.maximum(mesh.vertices_on_cell_mask.sum(axis=1), 1.0)
        s22m = (s22 * mesh.vertices_on_cell_mask).sum(axis=1) / \
            jnp.maximum(mesh.vertices_on_cell_mask.sum(axis=1), 1.0)
        s12m = (s12 * mesh.vertices_on_cell_mask).sum(axis=1) / \
            jnp.maximum(mesh.vertices_on_cell_mask.sum(axis=1), 1.0)
        mean = 0.5 * (s11m + s22m)
        rad = jnp.sqrt((0.5 * (s11m - s22m)) ** 2 + s12m ** 2)
        sig1 = mean + rad
        sig2 = mean - rad

        # final ocean stress for the coupler (reference :3624-3700)
        ocean_coeff = ocean_stress_coefficient(
            u, v, uo_v, vo_v, area_vertex, solve_velocity)
        sgn_f = jnp.sign(mesh.f_vertex)
        sgn_f = jnp.where(sgn_f == 0, 1.0, sgn_f)
        tau_ou = ocean_coeff * (
            (uo_v - u) * c.COS_OCEAN_TURNING_ANGLE -
            (vo_v - v) * c.SIN_OCEAN_TURNING_ANGLE * sgn_f)
        tau_ov = ocean_coeff * (
            (vo_v - v) * c.COS_OCEAN_TURNING_ANGLE +
            (uo_v - u) * c.SIN_OCEAN_TURNING_ANGLE * sgn_f)

        new_state = VelocitySolverState(
            u_velocity=u, v_velocity=v,
            stress11=s11, stress22=s22, stress12=s12,
            solve_velocity_prev=solve_velocity.astype(dtype),
        )
        diags = {
            "divergence": div, "shear": shear,
            "ridge_convergence": ridge_conv, "ridge_shear": ridge_shear,
            "principal_stress1": sig1, "principal_stress2": sig2,
            "ice_pressure": pressure,
            "ocean_stress_u": tau_ou, "ocean_stress_v": tau_ov,
            "solve_stress": solve_stress, "solve_velocity": solve_velocity,
            "stress_divergence_u": jnp.zeros_like(u),
            "stress_divergence_v": jnp.zeros_like(v),
        }
        return new_state, diags

    # revised-EVP numerical inertia coefficient brlx (Bouillon et al. 2013;
    # reference constitutive_relation.F:154-162)
    if relation == ConstitutiveRelation.EVP_REVISED:
        if min_dv_edge is None:
            raise ValueError("revised EVP requires min_dv_edge")
        gamma = 0.25 * 1.0e11 * dt_dyn
        brlx = (2.0 * c.REVISED_EVP_DAMPING_RATIO_DENOM *
                c.REVISED_EVP_DAMPING_RATIO * gamma) / min_dv_edge ** 2
    else:
        brlx = 0.0

    if dyn is not None:
        return functools.partial(step, dyn)
    return step  # call as step(dyn, state, forcing, area, vol, snow)
