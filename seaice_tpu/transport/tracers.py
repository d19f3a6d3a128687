"""Static tracer hierarchy for incremental remapping.

JAX replacement for the reference's linked list of tracer objects
(`/root/reference/src/shared/mpas_seaice_advection_incremental_remap_tracers.F:30-137`,
`seaice_add_tracers_to_linked_list` :158): a *static* table of TracerSpec
rows in topological order (parents before children) driving generic
vectorized remap kernels, plus a dict-of-arrays state.

Array convention: every tracer field is stored [nCells, nCategories] or
[nCells, nCategories, nLayers].  The mass-like root (iceAreaCategory) has
parent None; children reference parents by name.  Monotone remapping of a
child tracer uses the parent chain exactly as the reference does
(conservation equations (0)-(3), incremental_remap.F:2710-2721).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class TracerSpec:
    name: str
    parent: Optional[str]        # None for the mass-like root
    n_layers: int = 0            # 0 -> [nCells, nCat]; >0 -> [..., nLayers]
    # If True the framework state stores area*tracer (a volume); the remap
    # driver divides by the parent mass before transport and multiplies
    # back after, mirroring volume_to_thickness / thickness_to_volume
    # (incremental_remap.F:2500-2544, 2602-2650).
    stored_as_product: bool = False


@dataclasses.dataclass(frozen=True)
class TracerTree:
    """Validated, topologically ordered tracer table."""
    specs: Tuple[TracerSpec, ...]

    def __post_init__(self):
        seen = set()
        for s in self.specs:
            if s.parent is not None and s.parent not in seen:
                raise ValueError(
                    f"tracer {s.name}: parent {s.parent} must precede it")
            seen.add(s.name)
        if self.specs and self.specs[0].parent is not None:
            raise ValueError("first tracer must be the mass-like root")

    @property
    def names(self) -> List[str]:
        return [s.name for s in self.specs]

    @property
    def root(self) -> TracerSpec:
        return self.specs[0]

    def spec(self, name: str) -> TracerSpec:
        for s in self.specs:
            if s.name == name:
                return s
        raise KeyError(name)

    def depth(self, name: str) -> int:
        """Number of ancestors (nParents in the reference)."""
        d = 0
        s = self.spec(name)
        while s.parent is not None:
            d += 1
            s = self.spec(s.parent)
        return d

    def has_child(self, name: str) -> bool:
        return any(s.parent == name for s in self.specs)

    def ancestors(self, name: str) -> List[str]:
        """Ancestor names ordered root-first."""
        chain = []
        s = self.spec(name)
        while s.parent is not None:
            chain.append(s.parent)
            s = self.spec(s.parent)
        return chain[::-1]


def standard_tracer_tree(n_ice_layers: int = 7, n_snow_layers: int = 1,
                         use_ice_age: bool = False,
                         use_first_year_ice: bool = False,
                         use_level_ice: bool = False,
                         pond_scheme: str = "none",
                         use_snow_tracers: bool = False,
                         n_aerosols: int = 0,
                         use_brine_height: bool = False,
                         n_bio_tracers: int = 0,
                         n_bio_grid_points: int = 0,
                         use_skeletal_bgc: bool = False,
                         n_vertical_salinity: int = 0,
                         enthalpy: bool = True,
                         use_ponds: bool = False,
                         use_lid_thickness: bool = True) -> TracerTree:
    """The default hierarchy (reference ..._tracers.F:218-330):

    iceAreaCategory (mass)
      +- iceVolumeCategory     -> children iceEnthalpy, iceSalinity,
      |                           levelIceVolume, ice aerosols, zBGC
      +- snowVolumeCategory    -> children snowEnthalpy, snow mass /
      |                           grain-radius tracers, snow aerosols
      +- surfaceTemperature
      +- (optional) iceAge, firstYearIceArea, levelIceArea
      +- ponds: pondArea under levelIceArea (lvl scheme) or directly
         under iceAreaCategory (cesm/topo), with pondDepth and
         pondLidThickness children (reference :252-306)
    """
    if use_ponds and pond_scheme == "none":
        pond_scheme = "lvl"          # legacy kwarg
    if pond_scheme == "lvl":
        use_level_ice = True
    specs = [
        TracerSpec("iceAreaCategory", None),
        TracerSpec("iceVolumeCategory", "iceAreaCategory",
                   stored_as_product=True),
        TracerSpec("snowVolumeCategory", "iceAreaCategory",
                   stored_as_product=True),
        TracerSpec("surfaceTemperature", "iceAreaCategory"),
    ]
    if enthalpy:
        specs += [
            TracerSpec("iceEnthalpy", "iceVolumeCategory",
                       n_layers=n_ice_layers),
            TracerSpec("iceSalinity", "iceVolumeCategory",
                       n_layers=n_ice_layers),
            TracerSpec("snowEnthalpy", "snowVolumeCategory",
                       n_layers=n_snow_layers),
        ]
    if use_ice_age:
        specs.append(TracerSpec("iceAge", "iceAreaCategory"))
    if use_first_year_ice:
        specs.append(TracerSpec("firstYearIceArea", "iceAreaCategory"))
    if use_level_ice:
        specs.append(TracerSpec("levelIceArea", "iceAreaCategory"))
        specs.append(TracerSpec("levelIceVolume", "iceVolumeCategory"))
    if pond_scheme != "none":
        pond_parent = ("levelIceArea" if pond_scheme == "lvl"
                       else "iceAreaCategory")
        specs.append(TracerSpec("pondArea", pond_parent))
        specs.append(TracerSpec("pondDepth", "pondArea"))
        if use_lid_thickness and pond_scheme in ("lvl", "topo"):
            specs.append(TracerSpec("pondLidThickness", "pondArea"))
    if use_snow_tracers:
        specs += [
            TracerSpec("snowIceMass", "snowVolumeCategory",
                       n_layers=n_snow_layers),
            TracerSpec("snowLiquidMass", "snowVolumeCategory",
                       n_layers=n_snow_layers),
            TracerSpec("snowGrainRadius", "snowVolumeCategory",
                       n_layers=n_snow_layers),
        ]
    if n_aerosols:
        specs += [
            TracerSpec("snowScatteringAerosol", "snowVolumeCategory",
                       n_layers=n_aerosols),
            TracerSpec("snowBodyAerosol", "snowVolumeCategory",
                       n_layers=n_aerosols),
            TracerSpec("iceScatteringAerosol", "iceVolumeCategory",
                       n_layers=n_aerosols),
            TracerSpec("iceBodyAerosol", "iceVolumeCategory",
                       n_layers=n_aerosols),
        ]
    if use_brine_height:
        specs.append(TracerSpec("brineHeight", "iceAreaCategory"))
    if n_bio_tracers:
        # vertical zBGC tracers ride on the brine fraction
        # (reference ..._tracers.F bio tracer block)
        specs.append(TracerSpec("bioTracers", "iceVolumeCategory",
                                n_layers=n_bio_tracers))
        if n_bio_grid_points:
            # per-tracer mobile fraction (reference zbgc_frac tracer,
            # ice_zbgc_shared.F90:69)
            specs.append(TracerSpec(
                "bioMobileFraction", "iceVolumeCategory",
                n_layers=n_bio_tracers // n_bio_grid_points))
    if use_skeletal_bgc:
        # skeletal-layer BGC pools: algal N, NO3, SiO3 (reference
        # ice_algae.F90 skl mode)
        specs.append(TracerSpec("sklBgc", "iceAreaCategory",
                                n_layers=3))
    if n_vertical_salinity:
        specs.append(TracerSpec("verticalSalinity",
                                "iceVolumeCategory",
                                n_layers=n_vertical_salinity))
    return TracerTree(tuple(specs))


def mass_only_tree() -> TracerTree:
    return TracerTree((TracerSpec("iceAreaCategory", None),))


def init_tracer_state(tree: TracerTree, n_cells: int, n_categories: int,
                      dtype=jnp.float64) -> Dict[str, jnp.ndarray]:
    out = {}
    for s in tree.specs:
        shape = (n_cells, n_categories)
        if s.n_layers:
            shape = shape + (s.n_layers,)
        out[s.name] = jnp.zeros(shape, dtype)
    return out
