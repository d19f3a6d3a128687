"""Output streams: append-mode history files.

JAX replacement for the Registry `output` stream
(Registry.xml:2088-2161): cell/vertex fields appended per output alarm
to a classic-netCDF file (scipy backend; one time-record per write).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


class OutputStream:
    """Accumulate per-time records in memory; write on flush (classic
    netCDF via scipy, or npz fallback)."""

    def __init__(self, path: str, dims: Dict[str, int]):
        self.path = path
        self.dims = dict(dims)
        self.records: List[Dict[str, np.ndarray]] = []
        self.timestamps: List[str] = []

    def write(self, fields: Dict[str, np.ndarray], timestamp: str):
        self.records.append({k: np.asarray(v) for k, v in fields.items()})
        self.timestamps.append(timestamp)

    def flush(self):
        if not self.records:
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        if self.path.endswith(".npz"):
            payload = {}
            for k in self.records[0]:
                payload[k] = np.stack([r[k] for r in self.records])
            payload["xtime"] = np.array(self.timestamps)
            np.savez(self.path, **payload)
            return
        from scipy.io import netcdf_file
        nc = netcdf_file(self.path, "w")
        nc.createDimension("Time", None)
        for name, n in self.dims.items():
            nc.createDimension(name, n)
        nc.createDimension("StrLen", 64)
        first = self.records[0]
        var_dims = {}
        for k, v in first.items():
            dnames = ["Time"]
            for ax in v.shape:
                match = [d for d, n in self.dims.items() if n == ax]
                if not match:
                    dname = f"dim{ax}"
                    if dname not in nc.dimensions:
                        nc.createDimension(dname, ax)
                    match = [dname]
                dnames.append(match[0])
            var_dims[k] = tuple(dnames)
        for k, v in first.items():
            var = nc.createVariable(k, "d", var_dims[k])
            var[:] = np.stack([r[k] for r in self.records])
        tvar = nc.createVariable("xtime", "c", ("Time", "StrLen"))
        for i, ts in enumerate(self.timestamps):
            padded = ts.ljust(64)[:64]
            tvar[i] = np.frombuffer(padded.encode(), dtype="S1")
        nc.close()
