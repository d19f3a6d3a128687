"""NetCDF forcing-file readers (CORE atmosphere / NCAR ocean).

JAX replacement for the reference's forcing streams
(`/root/reference/src/shared/mpas_seaice_forcing.F:68-306` CORE
six-hourly + monthly atmosphere, :1188 NCAR monthly ocean; stream
definitions Registry.xml:1851-2248): forcing files hold [nTimes,
nCells] records with a time coordinate in seconds-of-year; readers
build the in-memory `ForcingSeries` that the runner interpolates each
coupling step with annual cycling, exactly the framework
MPAS_forcing 'linear' interpolation semantics.

The forcing clock needs no separate restart state: interpolation is a
pure function of the model clock, which the checkpoint already
persists (reference seaice_forcing_write_restart_times,
forcing.F:2095, exists because its interpolation state is stateful;
ours is not — restartability is bitwise by construction and covered by
the restart test).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..forcing.core import (CoreAtmosForcing, ForcingSeries,
                            NcarOceanForcing, monthly_times)

# reference CORE field names -> our series keys
CORE_SIXHOURLY_FIELDS = {
    "airTemperature": "airTemperature",
    "airSpecificHumidity": "airSpecificHumidity",
    "uAirVelocity": "uAirVelocity",
    "vAirVelocity": "vAirVelocity",
}
CORE_MONTHLY_FIELDS = {
    "cloudFraction": "cloudFraction",
    "rainfallRate": "precipitationRate",
    "precipitationRate": "precipitationRate",
}
NCAR_MONTHLY_FIELDS = {
    "seaSurfaceTemperature": "seaSurfaceTemperature",
    "seaSurfaceSalinity": "seaSurfaceSalinity",
    "uOceanVelocity": "uOceanVelocity",
    "vOceanVelocity": "vOceanVelocity",
    "seaSurfaceTiltU": "seaSurfaceTiltU",
    "seaSurfaceTiltV": "seaSurfaceTiltV",
    "oceanMixedLayerDepth": "oceanMixedLayerDepth",
    "oceanHeatFluxConvergence": "oceanHeatFluxConvergence",
}


def _open(path: str):
    from scipy.io import netcdf_file
    return netcdf_file(path, "r", mmap=False)


def read_forcing_series(path: str, field_map: Dict[str, str],
                        time_var: str = "xtime_seconds",
                        times: Optional[np.ndarray] = None
                        ) -> ForcingSeries:
    """Read [nTimes, nCells] variables into a ForcingSeries.

    field_map: file variable name -> series key.  The time axis comes
    from `time_var` (seconds-of-year) or, if absent, from `times`
    (e.g. monthly_times() for climatology files)."""
    nc = _open(path)
    fields = {}
    for var, key in field_map.items():
        if var in nc.variables:
            fields[key] = np.array(nc.variables[var][:], np.float64)
    if not fields:
        raise ValueError(f"no known forcing fields in {path!r}")
    if time_var in nc.variables:
        t = np.array(nc.variables[time_var][:], np.float64)
    elif times is not None:
        t = np.asarray(times, np.float64)
    else:
        n = next(iter(fields.values())).shape[0]
        if n == 12:
            t = monthly_times()
        else:
            raise ValueError(
                f"{path!r} has no {time_var!r} and {n} records; pass "
                "explicit times")
    nc.close()
    return ForcingSeries(times=t, fields=fields)


def write_forcing_series(path: str, series: ForcingSeries,
                         time_var: str = "xtime_seconds") -> None:
    """Write a ForcingSeries as a classic NetCDF forcing file (the
    synthesized-to-spec counterpart of read_forcing_series)."""
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "w")
    n_times = len(series.times)
    n_cells = next(iter(series.fields.values())).shape[1]
    nc.createDimension("Time", n_times)
    nc.createDimension("nCells", n_cells)
    v = nc.createVariable(time_var, "d", ("Time",))
    v[:] = series.times
    for k, arr in series.fields.items():
        v = nc.createVariable(k, "d", ("Time", "nCells"))
        v[:] = arr
    nc.close()


def core_atmos_from_files(six_hourly_path: str, monthly_path: str,
                          lon, lat) -> CoreAtmosForcing:
    """CORE atmospheric forcing from file pair (reference
    init_atmospheric_forcing_CORE :142-306)."""
    sixh = read_forcing_series(six_hourly_path, CORE_SIXHOURLY_FIELDS)
    monthly = read_forcing_series(monthly_path, CORE_MONTHLY_FIELDS,
                                  times=monthly_times())
    return CoreAtmosForcing(six_hourly=sixh, monthly=monthly,
                            lon=np.asarray(lon), lat=np.asarray(lat))


def ncar_ocean_from_file(path: str) -> NcarOceanForcing:
    """NCAR monthly ocean climatology (reference
    init_oceanic_forcing_ncar :1188)."""
    monthly = read_forcing_series(path, NCAR_MONTHLY_FIELDS,
                                  times=monthly_times())
    return NcarOceanForcing(monthly=monthly)
