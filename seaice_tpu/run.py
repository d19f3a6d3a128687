"""Standalone run loop.

JAX re-design of the reference core lifecycle
(`mpas_seaice_core.F`: seaice_core_init :34, seaice_core_run :257 with
its timeLoop :314-371, seaice_core_finalize :414): a host loop that
advances the clock, pulls interpolated forcing, calls the single jitted
timestep, services output/restart alarms, and runs the state sanity
check.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp

from .column.driver import AtmosForcing, OceanForcing, slab_ocean_frzmlt
from .diagnostics import PhaseTimers, check_state
from .dynamics.evp import DynamicsForcing
from .forcing.clock import Alarm, ModelClock
from .forcing.core import CoreAtmosForcing, NcarOceanForcing
from .io.checkpoint import save_checkpoint, write_restart_timestamp
from .io.output import OutputStream
from .model import SeaIceModel, State


@dataclasses.dataclass
class RunStreams:
    output: Optional[OutputStream] = None
    output_interval: float = 86400.0
    restart_dir: Optional[str] = None
    restart_interval: float = 5 * 86400.0


class StandaloneRunner:
    """Owns the clock + forcing + model; `run(n_steps)` is the time loop."""

    def __init__(self, model: SeaIceModel, state: State,
                 atmos_forcing: Optional[CoreAtmosForcing] = None,
                 ocean_forcing: Optional[NcarOceanForcing] = None,
                 clock: Optional[ModelClock] = None,
                 streams: Optional[RunStreams] = None,
                 analysis=None):
        """analysis: optional AnalysisDriver whose members run on their
        own alarms inside the time loop (reference analysis-driver
        integration, mpas_seaice_core.F timeLoop :321-331)."""
        self.model = model
        self.state = state
        self.atmos = atmos_forcing
        self.ocean = ocean_forcing
        self.clock = clock or ModelClock(
            calendar=model.cfg.run.calendar)
        self.streams = streams or RunStreams()
        self.analysis = analysis
        if analysis is not None:
            analysis.bootstrap(model, state)
            analysis.init(model, state)
        self.step_fn = model.make_step(jit=False)
        self.timers = PhaseTimers()
        self._out_alarm = Alarm(self.streams.output_interval)
        self._restart_alarm = Alarm(self.streams.restart_interval)
        self.dtype = model.dtype
        self._device_step = self._build_device_step()

    # -- forcing assembly ----------------------------------------------------

    def _dynamics_forcing(self, atm: Dict[str, Any],
                          ocn: Dict[str, Any]) -> DynamicsForcing:
        nc = self.model.mesh.n_cells
        dt = self.dtype
        z = jnp.zeros((nc,), dt)

        def g(d, k, default=None):
            if d is None or k not in d:
                return z if default is None else jnp.asarray(default, dt)
            return jnp.asarray(d[k], dt)

        return DynamicsForcing(
            u_air_velocity=g(atm, "u_air"),
            v_air_velocity=g(atm, "v_air"),
            air_density=jnp.full((nc,), 1.3, dt),
            u_ocean_velocity=g(ocn, "uOceanVelocity"),
            v_ocean_velocity=g(ocn, "vOceanVelocity"),
            sea_surface_tilt_u=g(ocn, "seaSurfaceTiltU"),
            sea_surface_tilt_v=g(ocn, "seaSurfaceTiltV"),
            land_ice_mask=z)

    def _column_forcing(self, atm, ocn, dt_step):
        nc = self.model.mesh.n_cells
        d = self.dtype
        one = jnp.ones((nc,), d)

        def g(src, k, default=0.0):
            if src is None or k not in src:
                return default * one
            return jnp.asarray(src[k], d)

        atmf = AtmosForcing(
            air_temperature=g(atm, "air_temperature", 253.0),
            specific_humidity=g(atm, "specific_humidity", 0.0005),
            u_air=g(atm, "u_air"), v_air=g(atm, "v_air"),
            longwave_down=g(atm, "longwave_down", 180.0),
            sw_vis_dir=g(atm, "sw_vis_dir"),
            sw_vis_dif=g(atm, "sw_vis_dif"),
            sw_ir_dir=g(atm, "sw_ir_dir"),
            sw_ir_dif=g(atm, "sw_ir_dif"),
            rain_rate=g(atm, "rain_rate"),
            snow_rate=g(atm, "snow_rate"),
            air_density=1.3 * one,
            air_level_height=10.0 * one)
        sst = g(ocn, "seaSurfaceTemperature", -1.8)
        Tf = g(ocn, "seaFreezingTemperature", -1.8)
        hmix = g(ocn, "oceanMixedLayerDepth", 20.0)
        ocnf = OceanForcing(
            sst=sst, sss=g(ocn, "seaSurfaceSalinity", 34.0),
            freezing_temperature=Tf,
            frzmlt=slab_ocean_frzmlt(sst, Tf, hmix, dt_step),
            mixed_layer_depth=hmix)
        return atmf, ocnf

    # -- the fused device step ----------------------------------------------

    def _build_device_step(self):
        """One jitted program per coupling step: derived forcing (from
        the CURRENT ice state — reference derived-forcing semantics,
        mpas_seaice_forcing.F:842-1190), real solar zenith angles from
        the clock (compute_coszen), then the model step.  Clock scalars
        are traced arguments, so the program compiles once."""
        model = self.model
        dt_step = model.cfg.run.dt
        use_col = model.cfg.column.use_column_package
        d = self.dtype
        step_fn = self.step_fn
        has_atmos = self.atmos is not None
        if has_atmos:
            lon = jnp.asarray(self.atmos.lon, d)
            lat = jnp.asarray(self.atmos.lat, d)
        else:
            lon = lat = None
        from .column.orbital import compute_coszen
        from .diagnostics import check_state
        from .forcing.core import derive_atmos_fields

        def fn(tensors, state, sixh, monthly, ocn_raw,
               seconds_today, day_of_year):
            if has_atmos:
                aicen = state.tracers["iceAreaCategory"]
                aice = aicen.sum(-1)
                tsfc_tr = state.tracers.get("surfaceTemperature")
                if tsfc_tr is not None:
                    tsfc = jnp.where(
                        aice > 1e-11,
                        (tsfc_tr * aicen).sum(-1) /
                        jnp.maximum(aice, 1e-11), 0.0)
                else:
                    tsfc = jnp.zeros_like(aice)
                sst0 = ocn_raw.get("seaSurfaceTemperature",
                                   -1.8 * jnp.ones_like(aice)) \
                    if ocn_raw else -1.8 * jnp.ones_like(aice)
                atm_raw = derive_atmos_fields(
                    sixh, monthly, lon, lat, aice, tsfc, sst0,
                    seconds_today, day_of_year)
                coszen, _ = compute_coszen(lat, lon, day_of_year,
                                           seconds_today)
            else:
                atm_raw = None
                coszen = None
            dyn_forcing = self._dynamics_forcing(atm_raw, ocn_raw)
            if use_col and atm_raw is not None:
                atmf, ocnf = self._column_forcing(atm_raw, ocn_raw,
                                                  dt_step)
            else:
                atmf = ocnf = None
            state, diags = step_fn(tensors, state, dyn_forcing,
                                   atmf, ocnf, coszen=coszen,
                                   day_of_year=day_of_year,
                                   lat=lat)
            checks = check_state(state)
            # column warning buffer -> abort gate with per-cell
            # attribution (reference ice_warnings.F90 + the cell dump
            # at mpas_seaice_column.F:1872-1939)
            cell_masks = {}
            fl = diags.get("column_fluxes")
            if fl is not None and getattr(fl, "warnings", None):
                for name, mask in fl.warnings.items():
                    key = "column_" + name
                    ok = ~mask.any()
                    checks[key] = ok
                    checks["ok"] = checks["ok"] & ok
                    cell_masks[key] = mask
            return state, diags, checks, cell_masks

        return jax.jit(fn)

    def step_inputs(self):
        """The device step's arguments after (tensors, state): raw forcing
        records at the current clock (reference seaice_forcing_get
        :306; interpolation is host-side and cheap, derived fields
        happen on device) and the clock scalars."""
        d = self.dtype
        sixh = monthly = ocn_raw = None
        if self.atmos is not None:
            sixh, monthly = self.atmos.raw_snapshot(self.clock)
            sixh = {k: jnp.asarray(v, d) for k, v in sixh.items()}
            monthly = {k: jnp.asarray(v, d) for k, v in monthly.items()}
        if self.ocean is not None:
            ocn_raw = {k: jnp.asarray(v, d) for k, v in
                       self.ocean.snapshot(self.clock).items()}
        return (sixh, monthly, ocn_raw,
                jnp.asarray(self.clock.seconds_today, d),
                jnp.asarray(float(self.clock.day_of_year), d))

    # -- time loop (reference timeLoop :314-371) -----------------------------

    def run(self, n_steps: int, check_interval: int = 1):
        """check_interval: steps between host-side abort-gate fetches
        (the state check itself runs on-device every step, like the
        reference's per-step seaice_check_state)."""
        model = self.model
        dt = model.cfg.run.dt
        for istep in range(n_steps):
            with self.timers.time("forcing"):
                inputs = self.step_inputs()

            with self.timers.time("timestep"):
                self.state, diags, checks, cell_masks = \
                    self._device_step(model.tensors, self.state, *inputs)
                jax.block_until_ready(self.state.velocity.u_velocity)

            self.clock.advance(dt)

            if (istep + 1) % check_interval == 0:
                with self.timers.time("state_check"):
                    from .error import raise_on_failed_checks
                    raise_on_failed_checks(
                        checks, self.state, self.clock.timestamp(),
                        run_dir=self.streams.restart_dir,
                        cell_masks=cell_masks)

            if self.analysis is not None:
                with self.timers.time("analysis"):
                    self.analysis.on_timestep(self.model, self.state,
                                              self.clock, diags)

            if self.streams.output is not None and \
                    self._out_alarm.is_ringing(self.clock):
                with self.timers.time("output"):
                    self._write_output()
            if self.streams.restart_dir is not None and \
                    self._restart_alarm.is_ringing(self.clock):
                with self.timers.time("restart_write"):
                    self._write_restart()
        return self.state

    def _write_output(self):
        tr = self.state.tracers
        fields = {
            "iceAreaCell": np.asarray(tr["iceAreaCategory"].sum(-1)),
            "iceVolumeCell": np.asarray(tr["iceVolumeCategory"].sum(-1)),
            "snowVolumeCell": np.asarray(
                tr["snowVolumeCategory"].sum(-1)),
            "uVelocity": np.asarray(self.state.velocity.u_velocity),
            "vVelocity": np.asarray(self.state.velocity.v_velocity),
        }
        self.streams.output.write(fields, self.clock.timestamp())

    def _write_restart(self):
        ts = self.clock.timestamp()
        path = os.path.join(self.streams.restart_dir,
                            f"restart.{ts}.npz")
        save_checkpoint(path, self.state, {
            "year": self.clock.year, "seconds": self.clock.seconds})
        write_restart_timestamp(self.streams.restart_dir, ts)


class ShardedStandaloneRunner:
    """Standalone time loop over a ShardedSeaIceModel: global forcing
    series are interpolated on the host, the RAW records are scattered
    to the shard blocks, and everything derived (longwave/shortwave
    from cloud + current ice state, zenith angles, column/dynamics
    forcing containers) is computed on-device per shard inside ONE
    jitted program with the shard_map step — per-cell math only, so the
    per-shard results are bitwise identical to the single-device path
    and the step never gathers the state (output/restart use the
    parallel per-shard I/O, io/parallel.py).

    The multi-device analog of StandaloneRunner (reference: the same
    timeLoop, run under the block decomposition)."""

    def __init__(self, model, state,
                 atmos_forcing: Optional[CoreAtmosForcing] = None,
                 ocean_forcing: Optional[NcarOceanForcing] = None,
                 clock: Optional[ModelClock] = None,
                 streams: Optional[RunStreams] = None):
        self.model = model
        self.state = state
        self.atmos = atmos_forcing
        self.ocean = ocean_forcing
        self.clock = clock or ModelClock(
            calendar=model.cfg.run.calendar)
        self.streams = streams or RunStreams()
        self.timers = PhaseTimers()
        self._out_alarm = Alarm(self.streams.output_interval)
        self._restart_alarm = Alarm(self.streams.restart_interval)
        self.dtype = model.dtype
        self.step_fn = model.make_step(jit=False)
        self._restart_seq = 0
        nc = model.global_mesh.n_cells
        lat_g = np.asarray(getattr(model.global_mesh, "lat_cell",
                                   np.zeros(nc)))
        lon_g = np.asarray(getattr(model.global_mesh, "lon_cell",
                                   np.zeros(nc)))
        npdt = np.dtype(jnp.dtype(self.dtype).name)
        self._lat = jnp.asarray(
            model.part.scatter_cell_field(lat_g.astype(npdt)))
        self._lon = jnp.asarray(
            model.part.scatter_cell_field(lon_g.astype(npdt)))
        self._device_step = self._build_device_step()

    def _scatter_raw(self, d):
        """Scatter a dict of global raw forcing records to stacked
        per-shard blocks."""
        if d is None:
            return None
        npdt = np.dtype(jnp.dtype(self.dtype).name)
        return {k: jnp.asarray(self.model.part.scatter_cell_field(
                    np.asarray(v, npdt))) for k, v in d.items()}

    def _build_device_step(self):
        """One jitted program per coupling step, mirroring
        StandaloneRunner._build_device_step: derived forcing from the
        CURRENT (sharded) ice state, zenith angles, then the shard_map
        step.  All pre-step math is per-cell on the stacked
        [S, nLocal] arrays, so XLA keeps it sharded — no collective,
        no gather."""
        model = self.model
        dt_step = model.cfg.run.dt
        use_col = model.cfg.column.use_column_package
        d = self.dtype
        step_fn = self.step_fn
        has_atmos = self.atmos is not None
        lat, lon = self._lat, self._lon
        from .column.orbital import compute_coszen
        from .forcing.core import derive_atmos_fields

        def nlike(x, v):
            return jnp.full_like(x, v)

        def fn(tensors, halo, state, sixh, monthly, ocn_raw,
               seconds_today, day_of_year):
            aicen = state.tracers["iceAreaCategory"]
            aice = aicen.sum(-1)
            if has_atmos:
                tsfc_tr = state.tracers.get("surfaceTemperature")
                if tsfc_tr is not None:
                    tsfc = jnp.where(
                        aice > 1e-11,
                        (tsfc_tr * aicen).sum(-1) /
                        jnp.maximum(aice, 1e-11), 0.0)
                else:
                    tsfc = jnp.zeros_like(aice)
                sst0 = (ocn_raw.get("seaSurfaceTemperature",
                                    nlike(aice, -1.8))
                        if ocn_raw else nlike(aice, -1.8))
                atm_raw = derive_atmos_fields(
                    sixh, monthly, lon, lat, aice, tsfc, sst0,
                    seconds_today, day_of_year)
                coszen, _ = compute_coszen(lat, lon, day_of_year,
                                           seconds_today)
            else:
                atm_raw = None
                coszen = None

            def g(src, k, default=0.0):
                if src is None or k not in src:
                    return nlike(aice, default)
                return src[k]

            dyn = DynamicsForcing(
                u_air_velocity=g(atm_raw, "u_air"),
                v_air_velocity=g(atm_raw, "v_air"),
                air_density=nlike(aice, 1.3),
                u_ocean_velocity=g(ocn_raw, "uOceanVelocity"),
                v_ocean_velocity=g(ocn_raw, "vOceanVelocity"),
                sea_surface_tilt_u=g(ocn_raw, "seaSurfaceTiltU"),
                sea_surface_tilt_v=g(ocn_raw, "seaSurfaceTiltV"),
                land_ice_mask=nlike(aice, 0.0))
            atmf = ocnf = None
            if use_col and atm_raw is not None:
                atmf = AtmosForcing(
                    air_temperature=g(atm_raw, "air_temperature",
                                      253.0),
                    specific_humidity=g(atm_raw, "specific_humidity",
                                        5e-4),
                    u_air=g(atm_raw, "u_air"),
                    v_air=g(atm_raw, "v_air"),
                    longwave_down=g(atm_raw, "longwave_down", 180.0),
                    sw_vis_dir=g(atm_raw, "sw_vis_dir"),
                    sw_vis_dif=g(atm_raw, "sw_vis_dif"),
                    sw_ir_dir=g(atm_raw, "sw_ir_dir"),
                    sw_ir_dif=g(atm_raw, "sw_ir_dif"),
                    rain_rate=g(atm_raw, "rain_rate"),
                    snow_rate=g(atm_raw, "snow_rate"),
                    air_density=nlike(aice, 1.3),
                    air_level_height=nlike(aice, 10.0))
                sst = g(ocn_raw, "seaSurfaceTemperature", -1.8)
                Tf = g(ocn_raw, "seaFreezingTemperature", -1.8)
                hmix = g(ocn_raw, "oceanMixedLayerDepth", 20.0)
                ocnf = OceanForcing(
                    sst=sst, sss=g(ocn_raw, "seaSurfaceSalinity",
                                   34.0),
                    freezing_temperature=Tf,
                    frzmlt=slab_ocean_frzmlt(sst, Tf, hmix, dt_step),
                    mixed_layer_depth=hmix)
            return step_fn(tensors, halo, state, dyn, atmf, ocnf,
                           coszen, day_of_year, lat)

        return jax.jit(fn)

    def run(self, n_steps: int):
        model = self.model
        dt = model.cfg.run.dt
        d = self.dtype
        for istep in range(n_steps):
            with self.timers.time("forcing"):
                sixh = monthly = ocn_raw = None
                if self.atmos is not None:
                    sixh_g, monthly_g = self.atmos.raw_snapshot(
                        self.clock)
                    sixh = self._scatter_raw(sixh_g)
                    monthly = self._scatter_raw(monthly_g)
                if self.ocean is not None:
                    ocn_raw = self._scatter_raw(
                        self.ocean.snapshot(self.clock))
            with self.timers.time("timestep"):
                self.state, diags = self._device_step(
                    model.tensors, model.halo, self.state, sixh,
                    monthly, ocn_raw,
                    jnp.asarray(self.clock.seconds_today, d),
                    jnp.asarray(float(self.clock.day_of_year), d))
                jax.block_until_ready(self.state.velocity.u_velocity)
            self.clock.advance(dt)
            if self.streams.restart_dir is not None and \
                    self._restart_alarm.is_ringing(self.clock):
                with self.timers.time("restart_write"):
                    from .io.parallel import save_sharded_checkpoint
                    save_sharded_checkpoint(
                        self.streams.restart_dir,
                        f"restart.{self.clock.timestamp()}",
                        self.state, model.part,
                        model.global_mesh.n_cells,
                        model.global_mesh.n_vertices,
                        clock_metadata={"year": self.clock.year,
                                        "seconds": self.clock.seconds})
                    write_restart_timestamp(self.streams.restart_dir,
                                            self.clock.timestamp())
        return self.state
