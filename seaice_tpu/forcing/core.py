"""CORE atmospheric + NCAR oceanic forcing with time interpolation.

JAX replacement for `seaice_forcing_init/get`
(`/root/reference/src/shared/mpas_seaice_forcing.F:68-830`) and the
framework MPAS_forcing group machinery it drives: a ForcingSeries holds
a cyclic time axis of per-cell fields; the host run loop asks for the
linearly interpolated snapshot each coupling step, and the derived
fields (longwave, shortwave, precip split, humidity limit) are computed
by the formulas at :842-1190.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import jax.numpy as jnp

from .. import constants as c
from .clock import DAYS_PER_YEAR, SECONDS_PER_DAY, ModelClock

# shortwave band split (reference forcing.F:41-44)
FRAC_SW_VIS_DIR = 0.28
FRAC_SW_VIS_DIF = 0.24
FRAC_SW_IR_DIR = 0.31
FRAC_SW_IR_DIF = 0.17


@dataclasses.dataclass
class ForcingSeries:
    """A cyclic annual time series of per-cell fields.

    times: [nTimes] seconds-of-year of each record (e.g. 6-hourly:
    0, 21600, ...; monthly: mid-month seconds). fields: name ->
    [nTimes, nCells]. Interpolation is linear with periodic wrap
    (the reference's 'linear' interpolation with annual cycling)."""
    times: np.ndarray
    fields: Dict[str, np.ndarray]

    def interpolate(self, seconds_of_year: float) -> Dict[str, np.ndarray]:
        t = self.times
        n = len(t)
        year_len = DAYS_PER_YEAR * SECONDS_PER_DAY
        s = seconds_of_year % year_len
        i1 = int(np.searchsorted(t, s, side="right")) - 1
        if i1 < 0:
            # before first record: wrap to last
            i0, i1b = n - 1, 0
            t0 = t[-1] - year_len
            t1 = t[0]
        elif i1 >= n - 1:
            i0, i1b = n - 1, 0
            t0 = t[-1]
            t1 = t[0] + year_len
        else:
            i0, i1b = i1, i1 + 1
            t0, t1 = t[i0], t[i1b]
        w = 0.0 if t1 == t0 else (s - t0) / (t1 - t0)
        return {k: (1.0 - w) * v[i0] + w * v[i1b]
                for k, v in self.fields.items()}


def constant_series(n_cells: int, **values) -> ForcingSeries:
    """Single-record (time-constant) series."""
    return ForcingSeries(
        times=np.array([0.0]),
        fields={k: np.full((1, n_cells), v) for k, v in values.items()})


def monthly_times() -> np.ndarray:
    """Mid-month seconds-of-year (noleap), the NCAR monthly convention."""
    from .clock import DAYS_PER_MONTH_NOLEAP
    edges = np.concatenate([[0], np.cumsum(DAYS_PER_MONTH_NOLEAP)])
    mid = 0.5 * (edges[:-1] + edges[1:])
    return mid * SECONDS_PER_DAY


# -- derived atmospheric fields (reference :787-1190) -------------------------

def limit_specific_humidity(air_temperature, q):
    """Cap humidity at saturation (reference limit_specific_humidity).
    jnp formulas: runs inside the jitted step (on-device derived
    forcing, so the ice-state feedback is never stale)."""
    x = air_temperature - c.FRESH_FREEZING_POINT
    qmax = 2.0 + (0.7859 + 0.03477 * x) / (1.0 + 0.00412 * x) + \
        0.00422 * x
    qmax = jnp.power(10.0, qmax)
    qmax = jnp.maximum(qmax, c.PUNY)
    qmax = (0.622 * qmax) / (1.0e5 - 0.378 * qmax)
    return jnp.minimum(q, qmax)


def longwave_rosati_miyakoda(cloud, ice_area, tsfc_c, sst_c, q, t_air):
    """Downward longwave (Rosati & Miyakoda 1988; reference :842-906).
    tsfc_c, sst_c in deg C; t_air in K."""
    clear = 1.0 - 0.8 * cloud
    tsfc_comb = tsfc_c * ice_area + sst_c * (1.0 - ice_area) + \
        c.FRESH_FREEZING_POINT
    vp_sqrt = jnp.sqrt((1000.0 * q) / (0.622 + 0.378 * q))
    term = t_air ** 3 * (t_air * (0.39 - 0.05 * vp_sqrt) * clear +
                         4.0 * (tsfc_comb - t_air))
    return c.ICE_SNOW_EMISSIVITY * c.STEFAN_BOLTZMANN * \
        (tsfc_comb ** 4 - term)


def longwave_parkinson_washington(t_air, cloud):
    """(reference :918-955)"""
    return c.STEFAN_BOLTZMANN * t_air ** 4 * \
        (1.0 - 0.261 * jnp.exp(
            -7.77e-4 * (c.FRESH_FREEZING_POINT - t_air) ** 2)) * \
        (1.0 + 0.275 * cloud)


def shortwave_down(lon, lat, cloud, q, seconds_today, day_of_year):
    """Zenith-angle shortwave from cloud fraction (reference :1077-1160)."""
    lon = jnp.where(lon > np.pi, lon - 2.0 * np.pi, lon)
    solar_time = (seconds_today % SECONDS_PER_DAY) / 3600.0 + \
        12.0 * jnp.sin(0.5 * lon)
    hour_angle = (12.0 - solar_time) * np.pi / 12.0
    decl = 23.44 * jnp.cos((172.0 - day_of_year) * 2.0 * np.pi / 365.0) * \
        c.DEGREES_TO_RADIANS
    cosz = jnp.sin(lat) * jnp.sin(decl) + \
        jnp.cos(lat) * jnp.cos(decl) * jnp.cos(hour_angle)
    cosz = jnp.maximum(cosz, 0.0)
    e = 1.0e5 * q / (0.622 + 0.378 * q)
    d = (cosz + 2.7) * e * 1.0e-5 + 1.085 * cosz + 0.1
    sw0 = jnp.maximum(1353.0 * cosz ** 2 / d, 0.0)
    return sw0 * (1.0 - 0.6 * cloud ** 3)


def split_precipitation(precip_rate, air_temperature):
    """Rain below freezing becomes snow (reference precipitation
    :958-1000; rates already in kg/m^2/s)."""
    is_snow = air_temperature < c.FRESH_FREEZING_POINT
    snow = jnp.where(is_snow, precip_rate, 0.0)
    rain = jnp.where(is_snow, 0.0, precip_rate)
    return rain, snow


def shortwave_split(sw_down):
    return (sw_down * FRAC_SW_VIS_DIR, sw_down * FRAC_SW_VIS_DIF,
            sw_down * FRAC_SW_IR_DIR, sw_down * FRAC_SW_IR_DIF)


def derive_atmos_fields(six_hourly: Dict[str, np.ndarray],
                        monthly: Dict[str, np.ndarray],
                        lon, lat, ice_area, tsfc_c, sst_c,
                        seconds_today, day_of_year,
                        longwave_type: str = "rosati_miyakoda"):
    """Assemble the full atmospheric forcing snapshot from interpolated
    raw records (reference atmospheric_forcing :605-830).  Pure jnp —
    traced inside the jitted step so the derived longwave sees the
    CURRENT ice state, not a cached one.

    six_hourly: airTemperature [K], airSpecificHumidity, uAirVelocity,
    vAirVelocity. monthly: cloudFraction, precipitationRate [kg/m^2/s].
    Returns dict of derived cell fields."""
    t_air = six_hourly["airTemperature"]
    q = limit_specific_humidity(t_air, six_hourly["airSpecificHumidity"])
    cloud = monthly["cloudFraction"]
    if longwave_type == "rosati_miyakoda":
        lw = longwave_rosati_miyakoda(cloud, ice_area, tsfc_c, sst_c, q,
                                      t_air)
    else:
        lw = longwave_parkinson_washington(t_air, cloud)
    sw = shortwave_down(lon, lat, cloud, q, seconds_today, day_of_year)
    rain, snow = split_precipitation(monthly["precipitationRate"], t_air)
    swvdr, swvdf, swidr, swidf = shortwave_split(sw)
    return {
        "air_temperature": t_air,
        "specific_humidity": q,
        "u_air": six_hourly["uAirVelocity"],
        "v_air": six_hourly["vAirVelocity"],
        "longwave_down": lw,
        "shortwave_down": sw,
        "sw_vis_dir": swvdr, "sw_vis_dif": swvdf,
        "sw_ir_dir": swidr, "sw_ir_dif": swidf,
        "rain_rate": rain, "snow_rate": snow,
    }


@dataclasses.dataclass
class CoreAtmosForcing:
    """CORE-style atmospheric forcing: 6-hourly + monthly series
    (reference init_atmospheric_forcing_CORE :142-306)."""
    six_hourly: ForcingSeries
    monthly: ForcingSeries
    lon: np.ndarray
    lat: np.ndarray

    def snapshot(self, clock: ModelClock, ice_area, tsfc_c, sst_c,
                 longwave_type: str = "rosati_miyakoda"):
        sh = self.six_hourly.interpolate(clock.seconds)
        mo = self.monthly.interpolate(clock.seconds)
        return derive_atmos_fields(sh, mo, self.lon, self.lat, ice_area,
                                   tsfc_c, sst_c, clock.seconds_today,
                                   clock.day_of_year, longwave_type)

    def raw_snapshot(self, clock: ModelClock):
        """Interpolated raw records only — the derived fields are
        computed on-device inside the jitted step."""
        return (self.six_hourly.interpolate(clock.seconds),
                self.monthly.interpolate(clock.seconds))


@dataclasses.dataclass
class NcarOceanForcing:
    """NCAR monthly ocean climatology (reference
    init_oceanic_forcing_ncar :1188-1500): SST, SSS, currents, deep heat
    flux, mixed-layer depth, surface tilt."""
    monthly: ForcingSeries

    def snapshot(self, clock: ModelClock) -> Dict[str, np.ndarray]:
        return self.monthly.interpolate(clock.seconds)


@dataclasses.dataclass
class DataIcebergForcing:
    """Data-iceberg mode (reference init_data_iceberg_forcing :1628 +
    get_data_iceberg_fluxes :1752): a monthly climatology of iceberg
    freshwater flux, linearly interpolated; the latent-heat flux to
    the ocean is derived assuming constant berg temperature -4 C."""
    monthly: ForcingSeries
    SPECIFIC_HEAT_FRESH_ICE = 2106.0   # J/kg/K
    BERG_TEMPERATURE = -4.0            # C (assumed constant)

    def snapshot(self, clock: ModelClock) -> Dict[str, np.ndarray]:
        from .. import constants as c
        rec = self.monthly.interpolate(clock.seconds)
        fw = rec["bergFreshwaterFluxData"]
        latent = -fw * (c.LATENT_HEAT_MELTING -
                        self.SPECIFIC_HEAT_FRESH_ICE *
                        self.BERG_TEMPERATURE)
        return {"bergFreshwaterFlux": fw,
                "bergLatentHeatFlux": latent}
