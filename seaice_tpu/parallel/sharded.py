"""Multi-device sea-ice model: shard_map over a 1-D device mesh.

JAX replacement for the reference's MPI block loop + dmpar halo
exchange (SURVEY.md section 2h). Each device runs the identical
single-device kernels on its local block (owned + 2-deep halo — the MPAS
block structure), and halo refresh happens *inside* the one jitted step:

  per elastic subcycle: vertex-velocity halo refresh (the reference
    exchanges uVelocity/vVelocity by MPI once per subcycle,
    mpas_seaice_velocity_solver.F:2546-2584) -> here an all_gather of
    per-shard export buffers (NCCL between GPUs) + a gather;
  per dynamics step: 2-deep cell halo refresh of all tracers after
    transport (reference ...incremental_remap.F:2429-2487).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from .. import constants as c
from ..config import AdvectionType, Config
from ..dynamics import evp
from ..mesh.core import Mesh
from ..model import ModelTensors, SeaIceModel, State
from ..transport import make_remap_step
from ..utils.pytree import pytree_dataclass
from .partition import Partition, partition_mesh

AXIS = "shard"


@pytree_dataclass
class HaloMaps:
    """Per-shard halo bookkeeping (stacked on the shard axis)."""
    vertex_export_idx: Any        # [nVertexExport] local owned indices
    vertex_halo_src_shard: Any    # [nVertexHalo]
    vertex_halo_src_idx: Any
    cell_export_idx: Any          # [nCellExport]
    cell_halo_src_shard: Any      # [nCellHalo]
    cell_halo_src_idx: Any
    vertex_owned_mask: Any        # [nVerticesOwned]
    cell_owned_mask: Any          # [nCellsOwned]
    vertex_halo_color: Any        # [nVertexHalo] ppermute round index
    cell_halo_color: Any          # [nCellHalo]
    overlap: Optional[Any] = None  # evp.SubcycleOverlap (stacked) or None


def _gather_halo(buf, src_shard, src_idx):
    """Halo values from an export buffer via all_gather: every shard
    ships its exports everywhere, receivers address (shard, slot)."""
    allbuf = jax.lax.all_gather(buf, AXIS)        # [S, nExport, ...]
    return allbuf[src_shard, src_idx]             # [nHalo, ...]


def _exchange(field, export_idx, src_shard, src_idx, n_owned):
    """Refresh a field's halo entries: all_gather each shard's export
    buffer, then place the addressed entries into the halo slots.
    field: [nLocal, ...]; returns same shape."""
    halo = _gather_halo(field[export_idx], src_shard, src_idx)
    return jnp.concatenate([field[:n_owned], halo], axis=0)


def color_halo_graph(edges, n_shards):
    """Decompose the shard-neighbor digraph into partial permutations.

    edges: set of (src_shard, dst_shard) pairs meaning 'dst needs halo
    data owned by src'. Greedy bipartite edge coloring: each color
    class uses every shard at most once as a source and once as a
    target, so it is a valid lax.ppermute schedule. The number of
    colors is bounded by ~2x the max shard neighbor degree — a
    topology constant, independent of the shard count (a 2-D Morton
    block touches O(1) neighbor blocks however many shards there are).

    Returns (perms, color_of): perms[c] = [(src, dst), ...];
    color_of[(src, dst)] = c."""
    perms = []
    src_used = []    # per color: sets of used sources / targets
    dst_used = []
    color_of = {}
    # deterministic order; long edges first makes greedy tighter
    for (r, s) in sorted(edges):
        for ci in range(len(perms) + 1):
            if ci == len(perms):
                perms.append([])
                src_used.append(set())
                dst_used.append(set())
            if r not in src_used[ci] and s not in dst_used[ci]:
                perms[ci].append((r, s))
                src_used[ci].add(r)
                dst_used[ci].add(s)
                color_of[(r, s)] = ci
                break
    return [tuple(p) for p in perms], color_of


def _exchange_perm(field, export_idx, src_idx, halo_color, n_owned,
                   perms):
    """Halo refresh by point-to-point ppermute rounds.

    The reference's dmpar halo exchange is point-to-point MPI to the
    handful of blocks owning each halo layer
    (mpas_seaice_velocity_solver.F:2546-2584 via mpas_dmpar); the
    all_gather path instead ships every shard's exports everywhere
    (S x nExport traffic). Here the shard-neighbor graph is
    edge-colored at partition time (color_halo_graph) into K partial
    permutations with K ~ the neighbor degree, so traffic is
    K x nExport and each round is one point-to-point ppermute. Values
    delivered are bitwise identical to the all_gather path."""
    halo = _perm_halo(field[export_idx], src_idx, halo_color, perms)
    return jnp.concatenate([field[:n_owned], halo], axis=0)


def _perm_halo(buf, src_idx, halo_color, perms):
    """Halo values from an export buffer via edge-colored ppermute
    rounds (see _exchange_perm). buf: [nExport, ...]."""
    halo_shape = (halo_color.shape[0],) + buf.shape[1:]
    halo = jnp.zeros(halo_shape, buf.dtype)
    mshape = (-1,) + (1,) * (buf.ndim - 1)
    for ci, perm in enumerate(perms):
        recv = jax.lax.ppermute(buf, AXIS, perm)
        mask = (halo_color == ci).reshape(mshape)
        halo = jnp.where(mask, recv[src_idx], halo)
    return halo


class ShardedSeaIceModel:
    """Drop-in multi-device wrapper: same Config/semantics as
    SeaIceModel, state and tensors stacked on a leading shard axis."""

    def __init__(self, mesh: Mesh, cfg: Config, n_shards: int,
                 dtype=jnp.float64, devices=None,
                 halo_mode: str = "ring", overlap: bool = False):
        """halo_mode: 'ring' (neighbor ppermutes, default) or
        'allgather' (every shard ships its exports everywhere).
        overlap: interior/boundary split so the per-subcycle halo
        collective is data-independent of the full-grid compute and an
        async-collective backend can overlap the two (auto-disabled for
        configs the split does not support: weak scheme, metric terms,
        revised EVP).  Off by default: on the CPU backend collectives
        are synchronous thread rendezvous, so the reordering cannot help
        there (measured on the CPU: allgather +28% from the redundant
        boundary recompute; ring pathological); on NCCL it is not
        measured yet."""
        self.global_mesh = mesh
        self.cfg = cfg
        self.dtype = dtype
        self.halo_mode = halo_mode
        from ..config import (ConstitutiveRelation, StrainScheme,
                              StressDivergenceScheme)
        v = cfg.velocity
        self.overlap_enabled = (
            overlap and v.use_velocity_solver
            and v.strain_scheme == StrainScheme.VARIATIONAL
            and v.stress_divergence_scheme ==
            StressDivergenceScheme.VARIATIONAL
            and v.constitutive_relation == ConstitutiveRelation.EVP
            and not v.include_metric_terms
            and not v.average_variational_strains)
        self.part = partition_mesh(mesh, n_shards)
        self.n_shards = n_shards
        if devices is None:
            devices = np.array(jax.devices()[:n_shards])
        self.jax_mesh = JaxMesh(devices, (AXIS,))
        self.sharding = NamedSharding(self.jax_mesh, P(AXIS))

        # per-block single-device models (share config/tracer tree)
        self.models = [SeaIceModel(b.mesh, cfg, dtype)
                       for b in self.part.blocks]
        self.tree = self.models[0].tree
        self.column = self.models[0].column
        self.tensors = self.place(jax.tree.map(
            lambda *xs: np.stack(xs), *[m.tensors for m in self.models]))

        def stack(field):
            return np.stack(field)

        # edge-color the shard-neighbor graph into ppermute rounds;
        # padded halo slots (global id -1) are not real edges — they
        # get color -1 and never match a round
        def halo_valid(b):
            return (b.cell_global[b.n_cells_owned:] >= 0,
                    b.vertex_global[b.n_vertices_owned:] >= 0)

        edges = set()
        for s, b in enumerate(self.part.blocks):
            cv, vv = halo_valid(b)
            for r in np.unique(b.cell_halo_src_shard[cv]):
                edges.add((int(r), s))
            for r in np.unique(b.vertex_halo_src_shard[vv]):
                edges.add((int(r), s))
        self.halo_perms, color_of = color_halo_graph(edges, n_shards)

        def colors(src_shards, valid, s):
            return np.array(
                [color_of[(int(r), s)] if ok else -1
                 for r, ok in zip(src_shards, valid)], np.int32)

        v_col = [colors(b.vertex_halo_src_shard, halo_valid(b)[1], s)
                 for s, b in enumerate(self.part.blocks)]
        c_col = [colors(b.cell_halo_src_shard, halo_valid(b)[0], s)
                 for s, b in enumerate(self.part.blocks)]

        overlap_stacked = None
        if self.overlap_enabled:
            ovs = [evp.build_subcycle_overlap(
                       b.mesh, self.models[s].tensors.dynamics.fast,
                       b.vertex_export_idx, dtype)
                   for s, b in enumerate(self.part.blocks)]
            # pad the per-block export-adjacent cell sets to a common
            # size so the pytrees stack on the shard axis
            nec_max = max(o.ec_idx.shape[0] for o in ovs)

            def padc(a, axis):
                if a.shape[axis] == nec_max:
                    return a
                w = [(0, 0)] * a.ndim
                w[axis] = (0, nec_max - a.shape[axis])
                return jnp.pad(a, w)

            from ..utils.pytree import replace as pt_replace
            ovs = [pt_replace(o,
                              ec_idx=padc(o.ec_idx, 0),
                              voc_T_E=padc(o.voc_T_E, 1),
                              voc_mask_T_E=padc(o.voc_mask_T_E, 1),
                              basis_grad_T_E=padc(o.basis_grad_T_E, 3),
                              basis_int_T_E=padc(o.basis_int_T_E, 3))
                   for o in ovs]
            overlap_stacked = jax.tree.map(
                lambda *xs: np.stack(xs), *ovs)

        self.halo = self.place(HaloMaps(
            overlap=overlap_stacked,
            vertex_halo_color=stack(v_col),
            cell_halo_color=stack(c_col),
            vertex_export_idx=stack(
                [b.vertex_export_idx for b in self.part.blocks]),
            vertex_halo_src_shard=stack(
                [b.vertex_halo_src_shard for b in self.part.blocks]),
            vertex_halo_src_idx=stack(
                [b.vertex_halo_src_idx for b in self.part.blocks]),
            cell_export_idx=stack(
                [b.cell_export_idx for b in self.part.blocks]),
            cell_halo_src_shard=stack(
                [b.cell_halo_src_shard for b in self.part.blocks]),
            cell_halo_src_idx=stack(
                [b.cell_halo_src_idx for b in self.part.blocks]),
            vertex_owned_mask=stack(
                [b.vertex_owned_mask for b in self.part.blocks]),
            cell_owned_mask=stack(
                [b.cell_owned_mask for b in self.part.blocks]),
        ))
        self.n_vertices_owned = self.part.blocks[0].n_vertices_owned
        self.n_cells_owned = self.part.blocks[0].n_cells_owned

    # -- state scatter/gather ------------------------------------------------

    def place(self, tree):
        """Commit a pytree of stacked per-shard arrays to the device
        mesh: block s of every leaf lives on device s (the shard_map
        step then moves no block between devices)."""
        return jax.device_put(tree, self.sharding)

    def init_state(self, ice_area_cat=None, ice_volume_cat=None,
                   snow_volume_cat=None) -> State:
        def sc(f):
            if f is None:
                return None
            return self.part.scatter_cell_field(np.asarray(f))

        states = []
        area_l = sc(ice_area_cat)
        vol_l = sc(ice_volume_cat)
        snow_l = sc(snow_volume_cat)
        for s, m in enumerate(self.models):
            states.append(m.init_state(
                None if area_l is None else area_l[s],
                None if vol_l is None else vol_l[s],
                None if snow_l is None else snow_l[s]))
        return self.place(jax.tree.map(lambda *xs: np.stack(xs), *states))

    def scatter_forcing(self, forcing_fn):
        """forcing_fn(local_mesh) -> DynamicsForcing; stacked result."""
        return self.place(jax.tree.map(
            lambda *xs: np.stack(xs),
            *[forcing_fn(b.mesh) for b in self.part.blocks]))

    def scatter_cell_tree(self, tree):
        """Scatter a pytree of global [nCells, ...] fields (e.g.
        AtmosForcing / OceanForcing / coszen) to stacked local blocks."""
        return self.place(jax.tree.map(
            lambda f: self.part.scatter_cell_field(np.asarray(f)), tree))

    def gather_tracers(self, state: State) -> Dict[str, np.ndarray]:
        out = {}
        for name, arr in state.tracers.items():
            out[name] = self.part.gather_cell_field(
                np.asarray(arr), self.global_mesh.n_cells)
        return out

    def gather_velocity(self, state: State):
        u = self.part.gather_vertex_field(
            np.asarray(state.velocity.u_velocity),
            self.global_mesh.n_vertices)
        v = self.part.gather_vertex_field(
            np.asarray(state.velocity.v_velocity),
            self.global_mesh.n_vertices)
        return u, v

    # -- step ----------------------------------------------------------------

    def make_step(self, jit: bool = True):
        cfg = self.cfg
        tree = self.tree
        n_v_own = self.n_vertices_owned
        n_c_own = self.n_cells_owned
        dt_dyn = cfg.dynamics_timestep

        use_remap = (cfg.advection.advection_type ==
                     AdvectionType.INCREMENTAL_REMAP)
        if use_remap:
            remap_step = make_remap_step(
                tree, self.global_mesh.vertex_degree,
                monotonic=cfg.advection.monotonic)
        column = self.column
        use_column = cfg.column.use_column_package
        use_ridging = use_column and cfg.column.use_ridging
        use_kstrength = use_column and cfg.column.kstrength == 1
        highfreq = use_column and cfg.column.highfreq

        def shard_body(tensors: ModelTensors, halo: HaloMaps,
                       state: State, forcing, atmos, ocean, coszen,
                       day_of_year, lat, faero_atm, sfc_fluxes):
            # inside shard_map: strip the leading (length-1) block axis
            # (day_of_year is replicated — no block axis to strip)
            (tensors, halo, state, forcing, atmos, ocean,
             coszen, lat, faero_atm, sfc_fluxes) = jax.tree.map(
                lambda x: x[0],
                (tensors, halo, state, forcing, atmos, ocean, coszen,
                 lat, faero_atm, sfc_fluxes))

            if self.halo_mode == "ring":
                def ex_vertex(f):
                    return _exchange_perm(
                        f, halo.vertex_export_idx,
                        halo.vertex_halo_src_idx,
                        halo.vertex_halo_color, n_v_own,
                        self.halo_perms)

                def exchange_cell(f):
                    return _exchange_perm(
                        f, halo.cell_export_idx,
                        halo.cell_halo_src_idx,
                        halo.cell_halo_color, n_c_own,
                        self.halo_perms)
            else:
                def ex_vertex(f):
                    return _exchange(f, halo.vertex_export_idx,
                                     halo.vertex_halo_src_shard,
                                     halo.vertex_halo_src_idx, n_v_own)

                def exchange_cell(f):
                    return _exchange(f, halo.cell_export_idx,
                                     halo.cell_halo_src_shard,
                                     halo.cell_halo_src_idx, n_c_own)

            def exchange_vertex_uv(u, v):
                uv = ex_vertex(jnp.stack([u, v], axis=-1))
                return uv[..., 0], uv[..., 1]

            exchange_vertex_field = ex_vertex

            halo_overlap = None
            if self.overlap_enabled and halo.overlap is not None:
                if self.halo_mode == "ring":
                    def exchange_from_buf(buf):
                        return _perm_halo(
                            buf, halo.vertex_halo_src_idx,
                            halo.vertex_halo_color, self.halo_perms)
                else:
                    def exchange_from_buf(buf):
                        return _gather_halo(
                            buf, halo.vertex_halo_src_shard,
                            halo.vertex_halo_src_idx)
                halo_overlap = (halo.overlap, exchange_from_buf, n_v_own)

            vel_step = evp.make_velocity_solver(
                cfg, halo_exchange_vertex=exchange_vertex_uv,
                halo_exchange_cell_field=exchange_cell,
                halo_exchange_vertex_field=exchange_vertex_field,
                min_dv_edge=self.part.min_dv_edge,
                halo_overlap=halo_overlap)

            tr = dict(state.tracers)
            vel = state.velocity
            diags = {}
            fluxes = None
            if use_column and atmos is not None:
                # column physics is per-cell: each shard runs it on its
                # owned + halo cells; halo results are bitwise identical
                # to the owner's (same tracers + same scattered forcing,
                # and — for highfreq — the same halo-refreshed vertex
                # velocities, since every local cell carries all of its
                # vertices: partition.py builds vertex sets from ALL
                # local cells), so no exchange is needed (reference runs
                # the per-cell loop on nCellsSolve then does a tracer
                # halo, mpas_seaice_column.F:4279)
                uvel_c = vvel_c = None
                if highfreq:
                    from ..mesh.core import vertex_to_cell
                    uvel_c = vertex_to_cell(tensors.mesh,
                                            vel.u_velocity)
                    vvel_c = vertex_to_cell(tensors.mesh,
                                            vel.v_velocity)
                tr, fluxes = column.step_thermodynamics(
                    cfg.run.dt, tr, atmos, ocean, coszen=coszen,
                    uvel=uvel_c, vvel=vvel_c,
                    day_of_year=day_of_year, lat=lat,
                    faero_atm=faero_atm, sfc_fluxes=sfc_fluxes)
            for _ in range(cfg.velocity.dynamics_subcycle_number):
                if cfg.velocity.use_velocity_solver:
                    pressure_in = None
                    if use_kstrength:
                        pressure_in = column.ice_strength(tr)
                    vel, diags = vel_step(
                        tensors.dynamics, vel, forcing,
                        tr["iceAreaCategory"], tr["iceVolumeCategory"],
                        tr["snowVolumeCategory"],
                        pressure_in=pressure_in)
                if use_remap:
                    tr = remap_step(
                        tensors.remap, tensors.mesh.cells_on_cell,
                        tensors.mesh.cells_on_cell_mask,
                        tensors.area_cell, tr,
                        vel.u_velocity, vel.v_velocity, dt_dyn)
                    # 2-deep tracer halo refresh (owned values are
                    # authoritative; halo updates computed locally are
                    # discarded)
                    tr = {k: exchange_cell(v) for k, v in tr.items()}
                if use_ridging and diags:
                    tr, rdg = column.step_ridging(
                        dt_dyn, tr, diags["ridge_convergence"],
                        diags["ridge_shear"])
                    diags.update(rdg)
            if use_column and atmos is not None:
                wind = jnp.sqrt(atmos.u_air ** 2 + atmos.v_air ** 2)
                tr, post = column.step_post_dynamics(
                    cfg.run.dt, tr, wind=wind,
                    snow_rate=atmos.snow_rate)
                diags["coupling_prep"] = post
            if fluxes is not None:
                diags["column_fluxes"] = fluxes

            new_state = State(velocity=vel, tracers=tr,
                              time=state.time + cfg.run.dt)
            # restore the leading block axis
            return jax.tree.map(lambda x: x[None], (new_state, diags))

        smapped = jax.shard_map(
            shard_body, mesh=self.jax_mesh,
            in_specs=(P(AXIS),) * 7 + (P(), P(AXIS), P(AXIS), P(AXIS)),
            out_specs=P(AXIS),
            check_vma=False)

        def step(tensors, halo, state, forcing, atmos=None, ocean=None,
                 coszen=None, day_of_year=None, lat=None,
                 faero_atm=None, sfc_fluxes=None):
            return smapped(tensors, halo, state, forcing, atmos, ocean,
                           coszen, day_of_year, lat, faero_atm,
                           sfc_fluxes)

        if jit:
            step = jax.jit(step)
        return step


def full_physics_inputs(mesh, cfg, dtype=jnp.float64):
    """Global initial state + forcing for a full-physics run (shared by
    the dryrun and the sharding-invariance tests)."""
    from ..column.driver import AtmosForcing, OceanForcing
    from ..column.driver import slab_ocean_frzmlt
    from ..column.itd import category_boundaries
    from ..column.thermo_shared import (
        salinity_profile, melting_temperature,
        ice_enthalpy_from_temperature, snow_enthalpy_from_temperature)
    from ..testcases import box

    ncat = cfg.run.n_categories
    ni = cfg.run.n_ice_layers
    ns = cfg.run.n_snow_layers
    nc = mesh.n_cells
    conc = np.clip(mesh.x_cell / box.BOX_LX, 0.05, 1.0)
    area = np.tile((conc / ncat)[:, None], (1, ncat)) * 0.9
    hmax = category_boundaries(ncat, cfg.column.kcatbound,
                               cfg.column.kitd)
    mids = 0.5 * (hmax[:-1] + np.minimum(hmax[1:], 10.0))
    vol = area * mids
    snow = area * 0.05
    S = salinity_profile(ni)
    has = area[..., None] > 0
    extra = {
        "surfaceTemperature": jnp.asarray(
            np.where(area > 0, -12.0, 0.0), dtype),
        "iceEnthalpy": ice_enthalpy_from_temperature(
            jnp.asarray(np.where(has, -8.0, 0.0) *
                        np.ones((nc, ncat, ni)), dtype),
            melting_temperature(
                jnp.asarray(np.tile(S, (nc, ncat, 1)), dtype))) *
        has,
        "iceSalinity": jnp.asarray(np.tile(S, (nc, ncat, 1)),
                                   dtype) * has,
        "snowEnthalpy": snow_enthalpy_from_temperature(
            jnp.asarray(-10.0 * np.ones((nc, ncat, ns)), dtype)) * has,
    }
    one = np.ones((nc,))
    dynf = box.box_forcing(mesh, t=0.0, dtype=dtype)
    atm = AtmosForcing(
        air_temperature=252.0 * one, specific_humidity=0.0004 * one,
        u_air=np.asarray(dynf.u_air_velocity),
        v_air=np.asarray(dynf.v_air_velocity),
        longwave_down=170.0 * one,
        sw_vis_dir=5.0 * one, sw_vis_dif=5.0 * one,
        sw_ir_dir=4.0 * one, sw_ir_dif=4.0 * one,
        rain_rate=0.0 * one, snow_rate=1e-5 * one,
        air_density=1.3 * one, air_level_height=10.0 * one)
    sst, Tf = -1.7 * one, -1.8 * one
    ocn = OceanForcing(
        sst=sst, sss=34.0 * one, freezing_temperature=Tf,
        frzmlt=np.asarray(slab_ocean_frzmlt(
            jnp.asarray(sst), jnp.asarray(Tf), 20.0 * one,
            cfg.run.dt)),
        mixed_layer_depth=20.0 * one)
    coszen = 0.5 * one
    return area, vol, snow, extra, atm, ocn, coszen


def dryrun(n_devices: int) -> None:
    """Driver hook: compile + run ONE sharded FULL-PHYSICS step
    (mushy thermo, dEdd shortwave, level-ice ponds, Rothrock strength,
    5 categories, remap + ridging, age/FY tracers, aerosol deposition,
    highfreq coupling, ITDrdg snow redistribution) at a scale where
    every shard has a genuine interior beyond the 2-deep halos:
    32x32 cells over the device mesh at 10 elastic subcycles
    (VERDICT round-2 item 9)."""
    import jax.numpy as jnp
    from ..config import (AdvectionConfig, ColumnConfig, Config,
                          RunConfig, VelocitySolverConfig)
    from ..testcases import box
    from ..utils.pytree import replace as pt_replace

    devices = jax.devices()
    if len(devices) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, found {len(devices)}")
    cfg = Config(
        run=RunConfig(dt=1800.0, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=10, rotate_cartesian_grid=False,
            include_metric_terms=False, geostrophic_surface_tilt=False),
        advection=AdvectionConfig(),
        column=ColumnConfig(ktherm=2, shortwave="dEdd",
                            pond_scheme="lvl", kstrength=1,
                            use_ice_age=True, use_first_year_ice=True,
                            n_aerosols=2, highfreq=True,
                            use_snow_tracers=True, snwredist="ITDrdg"))
    mesh = box.box_test_mesh(32, 32)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    # overlap=True: the dryrun also validates the interior/boundary
    # comm-compute split compiles and runs under shard_map
    model = ShardedSeaIceModel(mesh, cfg, n_devices, dtype=jnp.float32,
                               overlap=True)
    (area, vol, snow, extra, atm, ocn,
     coszen) = full_physics_inputs(mesh, cfg, jnp.float32)
    state = model.init_state(area, vol, snow)
    tr = dict(state.tracers)
    for k, v in extra.items():
        tr[k] = jnp.asarray(model.part.scatter_cell_field(
            np.asarray(v, np.float32)))
    state = pt_replace(state, tracers=tr)
    forcing = model.scatter_forcing(
        lambda m: box.box_forcing(m, t=0.0, dtype=jnp.float32))
    atm_l = model.scatter_cell_tree(
        jax.tree.map(lambda x: np.asarray(x, np.float32), atm))
    ocn_l = model.scatter_cell_tree(
        jax.tree.map(lambda x: np.asarray(x, np.float32), ocn))
    cz_l = model.scatter_cell_tree(jnp.asarray(coszen, jnp.float32))
    lat_l = jnp.asarray(model.part.scatter_cell_field(
        np.full(mesh.n_cells, np.deg2rad(75.0), np.float32)))
    faero_l = jnp.asarray(model.part.scatter_cell_field(
        np.tile(np.array([1e-12, 5e-13], np.float32),
                (mesh.n_cells, 1))))
    step = model.make_step()
    out, _ = step(model.tensors, model.halo, state, forcing,
                  atm_l, ocn_l, cz_l,
                  day_of_year=jnp.asarray(265.0, jnp.float32),
                  lat=lat_l, faero_atm=faero_l)
    jax.block_until_ready(out.velocity.u_velocity)
