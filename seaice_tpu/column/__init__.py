"""Column physics: the grid-independent per-cell physics package.

JAX re-design of the CICE column package
(`/root/reference/src/column/`, API facade `ice_colpkg.F90:19-68`):
every routine is written as a dense, vectorized kernel over leading
batch dims [nCells, nCategories] with the vertical layer axis last —
the per-cell Fortran loops (reference `mpas_seaice_column.F:1694-1697`)
become one fused XLA program.
"""

from . import constants
from .thermo_shared import (salinity_profile, melting_temperature,
                            ice_enthalpy_from_temperature,
                            ice_temperature_from_enthalpy,
                            snow_enthalpy_from_temperature,
                            snow_temperature_from_enthalpy,
                            sea_freezing_temperature)
from .bl99 import temperature_changes
from .vertical import thermo_vertical, frzmlt_bottom_lateral
from .itd import (category_boundaries, aggregate_area, aggregate_state,
                  linear_itd_remap, ice_strength_hibler,
                  ice_strength_rothrock)
from .ridging import ridge_ice
from .atmo import (atmo_boundary_layer, atmo_constant_coefficients,
                   neutral_drag_coeffs, FormDragResult)
from .shortwave import shortwave_ccsm3
from .dedd import shortwave_dedd, solve_dedd_column
from .itd_thermo import add_new_ice, lateral_melt
from .driver import (AtmosForcing, OceanForcing, ColumnFluxes,
                     ColumnPhysics, slab_ocean_frzmlt)
from . import mushy
from .mushy_solver import (temperature_changes_mushy,
                           explicit_flow_velocities, flushing_velocity,
                           solve_salinity, permeability_mush,
                           flood_ice, FloodResult)
from .zerolayer import zerolayer_temperature
from .orbital import compute_coszen, solar_declination
from . import snow
from .aerosol import update_aerosol
from .bgc import init_skl_bgc, step_skl_bgc, SklBgcState
from .ponds import (compute_ponds_cesm, compute_ponds_lvl,
                    compute_ponds_topo, brine_permeability,
                    permeability_phi_topo, increment_age,
                    update_first_year_area)
