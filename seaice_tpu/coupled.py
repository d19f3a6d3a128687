"""Coupled driver: the MCT/NUOPC ModelAdvance loop.

JAX re-design of the reference coupler drivers
(`driver/ice_comp_mct.F`: ice_init_mct :118, ice_run_mct :1004;
`driver_nuopc/ice_comp_nuopc.F90` ModelAdvance): the external coupler
calls `advance(import_fields)` once per coupling interval; internally
the ice model sub-cycles its own (shorter) timestep to the next couple
alarm, accumulates the ocean/atmosphere fluxes over the interval, and
returns their time means in the export dict — the reference's
flux-averaging semantics (`seaice_column_aggregate_fluxes` feeding the
averaged `*_av` coupler fields).

Shape: the whole sub-loop is ONE jitted `lax.scan` — one device
dispatch per coupling interval, with per-substep solar zenith angles
computed on device from the traced clock scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .column.driver import ColumnFluxes
from .coupler import EXPORT_FIELDS, IMPORT_FIELDS, export_state, import_state
from .forcing.clock import Alarm, ModelClock
from .model import SeaIceModel, State


def _zero_fluxes_like(fl: ColumnFluxes) -> ColumnFluxes:
    return jax.tree.map(jnp.zeros_like, fl)


class CoupledDriver:
    """Owns the clock + couple alarm; the coupler owns the forcing.

    Usage (a NUOPC cap or a Python E3SM harness):

        drv = CoupledDriver(model, state, coupling_interval=3600.0)
        imports, exports = drv.advertise()        # field rosters
        for _ in range(n_couple_steps):
            export = drv.advance(import_fields)   # one couple interval

    `coupling_interval` must be an integer multiple of the model
    timestep (the reference requires the same of its couple alarm).
    Output/restart alarms are serviced at couple boundaries (couple
    interval divides the stream intervals in practice)."""

    def __init__(self, model: SeaIceModel, state: State,
                 coupling_interval: float,
                 clock: Optional[ModelClock] = None,
                 tfrz_option: str = "minus1p8",
                 sst_in_kelvin: bool = False,
                 streams=None,
                 prescribed_coverage=None):
        """prescribed_coverage: optional ForcingSeries with an
        'iceCoverage' field — prescribed (data) ice mode inside the
        coupled loop, the CIME _MPASSI%PRES compset behavior: the
        coverage stream is interpolated at each couple boundary and
        imposed on the category state at the start of every model
        substep, with velocities zeroed (reference
        `driver/ice_comp_mct.F`: ice_prescribed_init :812,
        ice_prescribed_run in the run loop :1125, applied via
        seaice_run_prescribed_ice at the head of each timestep,
        `src/shared/mpas_seaice_time_integration.F:125`)."""
        self.model = model
        self.state = state
        self.clock = clock or ModelClock(
            calendar=model.cfg.run.calendar)
        self.tfrz_option = tfrz_option
        self.sst_in_kelvin = sst_in_kelvin
        self.streams = streams
        self.prescribed_coverage = prescribed_coverage
        if prescribed_coverage is not None and \
                "iceEnthalpy" not in state.tracers:
            raise ValueError(
                "prescribed ice mode needs the column package "
                "(enthalpy/salinity tracers) enabled")
        dt = model.cfg.run.dt
        n_sub = coupling_interval / dt
        if abs(n_sub - round(n_sub)) > 1e-9 or n_sub < 1:
            raise ValueError(
                f"coupling_interval {coupling_interval} is not an "
                f"integer multiple of the model dt {dt}")
        self.n_substeps = int(round(n_sub))
        self.coupling_interval = float(coupling_interval)
        if streams is not None:
            self._out_alarm = Alarm(streams.output_interval)
            self._restart_alarm = Alarm(streams.restart_interval)
        self._advance_fn = self._build_advance()
        self.last_fluxes: Optional[ColumnFluxes] = None
        self.last_diags: Dict[str, Any] = {}

    # -- NUOPC advertise/realize analog --------------------------------------

    def advertise(self) -> Tuple[tuple, tuple]:
        """Field rosters the cap advertises (reference
        ice_import_export.F90:126-290)."""
        return IMPORT_FIELDS, EXPORT_FIELDS

    # -- the fused sub-loop ---------------------------------------------------

    def _build_advance(self):
        model = self.model
        cfg = model.cfg
        dt = cfg.run.dt
        use_col = cfg.column.use_column_package
        d = model.dtype
        step_fn = model.make_step(jit=False)
        mesh = model.mesh
        has_latlon = getattr(mesh, "lat_cell", None) is not None
        if has_latlon:
            lat = jnp.asarray(mesh.lat_cell, d)
            lon = jnp.asarray(mesh.lon_cell, d)
        else:
            lat = lon = None
        from .column.orbital import compute_coszen
        from .diagnostics import check_state

        prescribed = self.prescribed_coverage is not None
        if prescribed:
            from .prescribed import prescribe_ice_state
            from .utils.pytree import replace as pt_replace
            hin_max = model.column.hin_max

        calc_tsfc = cfg.column.calc_surface_temperature \
            if use_col else True

        def fn(tensors, state, dyn, atmf, ocnf, sec0, doy0,
               coverage=None, sfcf=None):
            def body(carry, i):
                state, acc, stress_acc = carry
                if prescribed:
                    # impose the data-ice coverage at the head of every
                    # substep and zero the dynamics state (reference
                    # seaice_run_prescribed_ice,
                    # mpas_seaice_time_integration.F:125; PRES compsets
                    # run with dynamics off)
                    tr_p = prescribe_ice_state(
                        state.tracers, coverage,
                        lat if lat is not None
                        else jnp.zeros_like(coverage),
                        ocnf.freezing_temperature, hin_max)
                    state = pt_replace(
                        state, tracers=tr_p,
                        velocity=jax.tree.map(jnp.zeros_like,
                                              state.velocity))
                secs = sec0 + (i + 0.5) * dt
                doy = doy0 + jnp.floor(secs / 86400.0)
                if has_latlon:
                    coszen, _ = compute_coszen(lat, lon, doy,
                                               jnp.mod(secs, 86400.0))
                else:
                    coszen = None
                state, diags = step_fn(
                    tensors, state, dyn, atmf, ocnf, coszen=coszen,
                    day_of_year=doy, lat=lat, sfc_fluxes=sfcf)
                fl = diags.get("column_fluxes")
                if fl is not None:
                    warn = getattr(fl, "warnings", None)
                    fl_num = dataclasses.replace(fl, warnings=None)
                    acc_fl, acc_warn = acc
                    acc_fl = jax.tree.map(jnp.add, acc_fl, fl_num)
                    if warn:
                        acc_warn = {k: acc_warn[k] | warn[k]
                                    for k in warn}
                    acc = (acc_fl, acc_warn)
                su = diags.get("ocean_stress_u")
                sv = diags.get("ocean_stress_v")
                if su is not None:
                    stress_acc = (stress_acc[0] + su, stress_acc[1] + sv)
                return (state, acc, stress_acc), 0.0

            # flux accumulator template from one probe step structure
            if use_col and atmf is not None:
                # zero-init by running the tree structure of the first
                # step lazily: accumulate from a zeros template built
                # at trace time via a throwaway evaluation
                probe_state, probe_diags = step_fn(
                    tensors, state, dyn, atmf, ocnf,
                    coszen=(compute_coszen(
                        lat, lon, doy0, jnp.mod(sec0, 86400.0))[0]
                        if has_latlon else None),
                    day_of_year=doy0, lat=lat, sfc_fluxes=sfcf)
                fl0 = probe_diags["column_fluxes"]
                warn0 = getattr(fl0, "warnings", None)
                acc0 = (_zero_fluxes_like(
                    dataclasses.replace(fl0, warnings=None)),
                    {k: jnp.zeros_like(v, bool)
                     for k, v in (warn0 or {}).items()})
            else:
                acc0 = (None, {})
            nv = state.velocity.u_velocity.shape[-1]
            stress0 = (jnp.zeros((nv,), d), jnp.zeros((nv,), d))
            (state, acc, stress_acc), _ = jax.lax.scan(
                body, (state, acc0, stress0), jnp.arange(
                    self.n_substeps, dtype=d))
            n = float(self.n_substeps)
            acc_fl, acc_warn = acc
            mean_fl = (jax.tree.map(lambda x: x / n, acc_fl)
                       if acc_fl is not None else None)
            if mean_fl is not None:
                mean_fl = dataclasses.replace(mean_fl, warnings=acc_warn)
            mean_stress = (stress_acc[0] / n, stress_acc[1] / n)
            checks = check_state(state)
            return state, mean_fl, mean_stress, checks

        return jax.jit(fn)

    # -- ModelAdvance ---------------------------------------------------------

    def advance(self, import_fields: Dict[str, Any]
                ) -> Dict[str, np.ndarray]:
        """One coupling interval: import -> sub-loop -> averaged export
        (reference ice_run_mct :1004 / NUOPC ModelAdvance)."""
        model = self.model
        d = model.dtype
        dyn, atmf, ocnf = import_state(
            import_fields, model.cfg.run.dt, dtype=d,
            tfrz_option=self.tfrz_option,
            sst_in_kelvin=self.sst_in_kelvin)
        if not model.cfg.column.use_column_package:
            atmf = ocnf = None
        kw = {}
        if self.prescribed_coverage is not None:
            cov = self.prescribed_coverage.interpolate(
                self.clock.seconds)["iceCoverage"]
            kw["coverage"] = jnp.asarray(cov, d)
        if model.cfg.column.use_column_package and \
                not model.cfg.column.calc_surface_temperature:
            from .coupler import import_sfc_fluxes
            kw["sfcf"] = import_sfc_fluxes(import_fields, d)
        state, mean_fl, mean_stress, checks = self._advance_fn(
            model.tensors, self.state, dyn, atmf, ocnf,
            jnp.asarray(self.clock.seconds_today, d),
            jnp.asarray(float(self.clock.day_of_year), d), **kw)
        self.state = state
        self.clock.advance(self.coupling_interval)
        from .error import raise_on_failed_checks
        raise_on_failed_checks(
            checks, self.state, self.clock.timestamp(),
            run_dir=getattr(self.streams, "restart_dir", None))
        self.last_fluxes = mean_fl
        self.last_diags = {"ocean_stress_u": mean_stress[0],
                           "ocean_stress_v": mean_stress[1]}
        self._service_alarms()
        return export_state(self.state, mean_fl, self.last_diags,
                            mesh_tensors=model.tensors.mesh)

    def _service_alarms(self):
        if self.streams is None:
            return
        if self.streams.output is not None and \
                self._out_alarm.is_ringing(self.clock):
            tr = self.state.tracers
            self.streams.output.write({
                "iceAreaCell": np.asarray(
                    tr["iceAreaCategory"].sum(-1)),
                "iceVolumeCell": np.asarray(
                    tr["iceVolumeCategory"].sum(-1)),
                "uVelocity": np.asarray(self.state.velocity.u_velocity),
                "vVelocity": np.asarray(self.state.velocity.v_velocity),
            }, self.clock.timestamp())
        if getattr(self.streams, "restart_dir", None) is not None and \
                self._restart_alarm.is_ringing(self.clock):
            import os

            from .io.checkpoint import (save_checkpoint,
                                        write_restart_timestamp)
            ts = self.clock.timestamp()
            save_checkpoint(
                os.path.join(self.streams.restart_dir,
                             f"restart.{ts}.npz"),
                self.state, {"year": self.clock.year,
                             "seconds": self.clock.seconds})
            write_restart_timestamp(self.streams.restart_dir, ts)


class ShardedCoupledDriver:
    """CoupledDriver over a multi-device ShardedSeaIceModel: import
    fields are scattered to shards, the sub-loop runs the sharded step
    (per-subcycle ppermute halos inside the jit) as one lax.scan per
    couple interval, and the interval-mean fluxes are gathered from
    the shard owners for export (the reference's decomposed
    ice_run_mct loop; gathers happen only at the coupler boundary,
    exactly where the MCT rearranger sits).

    Simplification vs the single-device driver: the solar zenith is
    evaluated once per couple interval (at its midpoint semantics it
    is the interval-start value), not per substep."""

    def __init__(self, model, state, coupling_interval: float,
                 clock: Optional[ModelClock] = None,
                 tfrz_option: str = "minus1p8",
                 sst_in_kelvin: bool = False):
        self.model = model
        self.state = state
        self.clock = clock or ModelClock(
            calendar=model.cfg.run.calendar)
        self.tfrz_option = tfrz_option
        self.sst_in_kelvin = sst_in_kelvin
        dt = model.cfg.run.dt
        n_sub = coupling_interval / dt
        if abs(n_sub - round(n_sub)) > 1e-9 or n_sub < 1:
            raise ValueError(
                f"coupling_interval {coupling_interval} is not an "
                f"integer multiple of the model dt {dt}")
        self.n_substeps = int(round(n_sub))
        self.coupling_interval = float(coupling_interval)
        self._advance_fn = self._build_advance()

    def _build_advance(self):
        model = self.model
        step_fn = model.make_step(jit=False)
        use_col = model.cfg.column.use_column_package

        def fn(tensors, halo, state, dyn, atmf, ocnf, coszen):
            def body(carry, _):
                state, acc = carry
                state, diags = step_fn(tensors, halo, state, dyn,
                                       atmf, ocnf, coszen)
                fl = diags.get("column_fluxes")
                if fl is not None:
                    fl_num = dataclasses.replace(fl, warnings=None)
                    if acc is None:
                        acc = fl_num
                    else:
                        acc = jax.tree.map(jnp.add, acc, fl_num)
                return (state, acc), 0.0

            # one probe step builds the accumulator structure; XLA
            # dead-code-eliminates its values (only shapes feed zeros)
            if use_col and atmf is not None:
                _, probe = step_fn(tensors, halo, state, dyn, atmf,
                                   ocnf, coszen)
                fl0 = probe.get("column_fluxes")
                acc0 = (_zero_fluxes_like(dataclasses.replace(
                    fl0, warnings=None)) if fl0 is not None else None)
            else:
                acc0 = None
            (state, acc), _ = jax.lax.scan(
                body, (state, acc0), None, length=self.n_substeps)
            mean_fl = (jax.tree.map(
                lambda x: x / float(self.n_substeps), acc)
                if acc is not None else None)
            return state, mean_fl

        return jax.jit(fn)

    def advance(self, import_fields: Dict[str, Any]
                ) -> Dict[str, np.ndarray]:
        model = self.model
        d = model.dtype
        dyn_g, atm_g, ocn_g = import_state(
            import_fields, model.cfg.run.dt, dtype=d,
            tfrz_option=self.tfrz_option,
            sst_in_kelvin=self.sst_in_kelvin)
        dyn = jax.tree.map(
            lambda f: jnp.asarray(model.part.scatter_cell_field(
                np.asarray(f))), dyn_g)
        if model.cfg.column.use_column_package:
            atmf = model.scatter_cell_tree(atm_g)
            ocnf = model.scatter_cell_tree(ocn_g)
            from .column.orbital import compute_coszen
            lat_g = getattr(model.global_mesh, "lat_cell", None)
            if lat_g is None:
                lat_g = np.zeros(model.global_mesh.n_cells)
            cz_g, _ = compute_coszen(
                jnp.asarray(lat_g, d),
                jnp.asarray(getattr(model.global_mesh, "lon_cell",
                                    np.zeros_like(lat_g)), d),
                float(self.clock.day_of_year),
                self.clock.seconds_today)
            coszen = jnp.asarray(model.part.scatter_cell_field(
                np.asarray(cz_g)), d)
        else:
            atmf = ocnf = coszen = None
        state, mean_fl = self._advance_fn(
            model.tensors, model.halo, self.state, dyn, atmf, ocnf,
            coszen)
        self.state = state
        self.clock.advance(self.coupling_interval)
        # gather owned rows for the export dict
        fl_host = None
        if mean_fl is not None:
            def g(x):
                if x is None:
                    return None
                return model.part.gather_cell_field(
                    np.asarray(x), model.global_mesh.n_cells)
            fl_host = jax.tree.map(g, mean_fl)
        tr_g = model.gather_tracers(state)
        from .model import State as _State
        from .dynamics.evp import VelocitySolverState as _V
        u_g, v_g = model.gather_velocity(state)
        gstate = _State(
            velocity=_V(u_velocity=jnp.asarray(u_g),
                        v_velocity=jnp.asarray(v_g),
                        stress11=None, stress22=None, stress12=None,
                        solve_velocity_prev=None),
            tracers={k: jnp.asarray(v) for k, v in tr_g.items()},
            time=state.time)
        return export_state(gstate, fl_host)
