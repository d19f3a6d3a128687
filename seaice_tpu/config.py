"""Typed configuration tree.

The JAX replacement for the reference's Registry.xml namelist records
(`/root/reference/src/Registry.xml`): one frozen dataclass per namelist
record, resolved at trace time (scheme selection happens in Python before
jit, exactly as the reference selects schemes at init).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class ConstitutiveRelation(enum.Enum):
    EVP = "evp"
    EVP_REVISED = "evp_revised"
    LINEAR = "linear"
    NONE = "none"


class StrainScheme(enum.Enum):
    VARIATIONAL = "variational"
    WEAK = "weak"


class StressDivergenceScheme(enum.Enum):
    VARIATIONAL = "variational"
    WEAK = "weak"


class VariationalBasis(enum.Enum):
    WACHSPRESS = "wachspress"
    PWL = "pwl"


class VariationalDenominator(enum.Enum):
    ORIGINAL = "original"      # areaTriangle
    ALTERNATE = "alternate"    # sum of basisIntegralsMetric


class OceanStressType(enum.Enum):
    QUADRATIC = "quadratic"
    LINEAR = "linear"


class AdvectionType(enum.Enum):
    INCREMENTAL_REMAP = "incremental_remap"
    UPWIND = "upwind"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class VelocitySolverConfig:
    """Reference nml_record 'velocity_solver' (Registry.xml:566-651)."""
    use_velocity_solver: bool = True
    dynamics_subcycle_number: int = 1
    elastic_subcycle_number: int = 120
    rotate_cartesian_grid: bool = True
    include_metric_terms: bool = True
    constitutive_relation: ConstitutiveRelation = ConstitutiveRelation.EVP
    strain_scheme: StrainScheme = StrainScheme.VARIATIONAL
    stress_divergence_scheme: StressDivergenceScheme = (
        StressDivergenceScheme.VARIATIONAL)
    variational_basis: VariationalBasis = VariationalBasis.WACHSPRESS
    variational_denominator: VariationalDenominator = (
        VariationalDenominator.ORIGINAL)
    integration_type: str = "dunavant"   # 'trapezoidal' | 'dunavant' | 'fekete'
    integration_order: int = 8
    average_variational_strains: bool = False
    calc_velocity_masks: bool = True
    use_air_stress: bool = True
    use_ocean_stress: bool = True
    use_surface_tilt: bool = True
    geostrophic_surface_tilt: bool = True
    ocean_stress_type: OceanStressType = OceanStressType.QUADRATIC


@dataclasses.dataclass(frozen=True)
class AdvectionConfig:
    """Reference nml_record 'advection' (Registry.xml:650-676)."""
    advection_type: AdvectionType = AdvectionType.INCREMENTAL_REMAP
    monotonic: bool = True
    conservation_check: bool = False
    monotonicity_check: bool = False


@dataclasses.dataclass(frozen=True)
class ColumnConfig:
    """Reference nml_records 'column_package' etc."""
    use_column_package: bool = True
    use_shortwave: bool = True
    use_vertical_thermodynamics: bool = True
    use_itd_thermodynamics: bool = True
    use_ridging: bool = True
    use_snow_tracers: bool = False
    use_biogeochemistry: bool = False
    # skeletal (bottom-layer) biogeochemistry
    # (config_use_skeletal_biochemistry; ice_algae.F90 skl mode)
    use_skeletal_biochemistry: bool = False
    # scheme selectors (reference ice_colpkg_shared.F90:20-150)
    ktherm: int = 1                 # 0: zero-layer, 1: BL99, 2: mushy
    # config_calc_surface_temperature (Registry.xml:1723-1727,
    # icepack_name calc_Tsfc): False = coupled mode where the
    # atmosphere model prescribes the per-category surface fluxes
    # (fsurf/fcondtop/flat/fsens) and Tsfc is not re-solved
    calc_surface_temperature: bool = True
    shortwave: str = "ccsm3"        # 'ccsm3' | 'dEdd'
    use_snicar: bool = False        # 5-band SNICAR snow IOPs (with dEdd)
    kstrength: int = 1              # 0: Hibler79, 1: Rothrock75
    kitd: int = 1                   # 0: delta, 1: linear remap
    kcatbound: int = 0
    krdg_partic: int = 1
    krdg_redist: int = 1
    atmbndy: str = "default"
    natmiter: int = 5
    # optional tracer packages (reference Registry packages :2372-2404)
    pond_scheme: str = "none"       # 'none' | 'cesm' | 'lvl' | 'topo'
    use_level_ice: bool = False     # forced on by pond_scheme='lvl'
    use_ice_age: bool = False
    use_first_year_ice: bool = False
    n_aerosols: int = 0
    # modal (SNICAR internal-mixing) BC optics in the dEdd shortwave
    # (config_use_modal_aerosols, Registry.xml:833-837)
    use_modal_aerosols: bool = False
    use_form_drag: bool = False     # Tsamados 2014 neutral drag
    highfreq: bool = False          # Roberts 2014 ice-relative winds
    tfrz_option: str = "minus1p8"   # ocean freezing temperature formula
    use_brine_height: bool = False  # tr_brine (hbrine dynamics)
    snwredist: str = "none"         # wind redistribution of snow:
                                    # 'none' | 'ITDsd' | 'ITDrdg'
                                    # (reference snow_redist,
                                    # ice_snow.F90:119)
    n_bio_tracers: int = 0          # derived: (n_algae+3)*(nblyr+1)
    n_algae: int = 1
    n_bio_layers: int = 7           # nblyr (bio grid layers)
    solve_zsalinity: bool = False   # prognostic salinity (ktherm=1)
    # snow liquid -> pond routing (config_use_snow_liquid_ponds,
    # Registry.xml:1553; needs the snow mass/liquid tracers)
    use_snow_liquid_ponds: bool = False
    # withhold pond-retained water from the ocean freshwater flux
    # (config_include_pond_freshwater_feedback, Registry.xml:551)
    include_pond_freshwater_feedback: bool = False
    # pond parameters
    rfracmin: float = 0.15
    rfracmax: float = 0.85
    pndaspect: float = 0.8
    frzpnd: str = "hlid"
    dpscale: float = 1.0e-3        # config_pond_flushing_timescale
    hi_min_pond: float = 0.01      # config_critical_pond_ice_thickness
    # ridging (config_ridiging_efolding_scale)
    mu_rdg: float = 4.0
    # shortwave tuning (reference shortwave nml_record)
    albicev: float = 0.78          # config_visible_ice_albedo
    albicei: float = 0.36          # config_infrared_ice_albedo
    albsnowv: float = 0.98         # config_visible_snow_albedo
    albsnowi: float = 0.70         # config_infrared_snow_albedo
    ahmax: float = 0.3             # config_variable_albedo_thickness_limit
    r_ice: float = 0.0             # config_ice_shortwave_tuning_parameter
    r_pnd: float = 0.0             # config_pond_shortwave_tuning_parameter
    r_snw: float = 1.5             # config_snow_shortwave_tuning_parameter
    dt_mlt: float = 1.5            # config_temp_change_snow_grain_radius_…
    rsnw_mlt: float = 1500.0       # config_max_melting_snow_grain_radius
    # -- physics tunables (column/tuning.py Tunables; Registry
    #    thermodynamics / snow / ridging / shortwave / meltponds /
    #    ocean records) --
    rapid_mode_channel_radius: float = 0.5e-3
    rapid_mode_critical_ra: float = 10.0   # config_rapid_model_critical_Ra
    rapid_mode_aspect_ratio: float = 1.0
    slow_mode_drainage_strength: float = -5.0e-8
    slow_mode_critical_porosity: float = 0.05
    congelation_ice_porosity: float = 0.85
    fallen_snow_radius: float = 54.4
    new_snow_density: float = 100.0
    max_snow_density: float = 450.0
    minimum_wind_compaction: float = 10.0
    wind_compaction_factor: float = 27.3
    max_dry_snow_radius: float = 2800.0
    ratio_ridging_work_to_pe: float = 17.0  # config_ratio_ridging_work_to_PE
    algae_absorption_coefficient: float = 0.6
    snow_to_ice_transition_depth: float = 0.0   # dEdd hs0
    snow_on_pond_ice_tapering_parameter: float = 0.03  # dEdd hs1
    min_friction_velocity: float = 0.0005
    # zBGC reaction parameters (None = defaults for n_algae)
    zbgc_params: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Core time/run settings (Registry.xml:317+)."""
    dt: float = 3600.0              # coupling/thermodynamic timestep (s)
    n_categories: int = 5
    n_ice_layers: int = 7
    n_snow_layers: int = 1
    calendar: str = "noleap"


@dataclasses.dataclass(frozen=True)
class Config:
    run: RunConfig = dataclasses.field(default_factory=RunConfig)
    velocity: VelocitySolverConfig = dataclasses.field(
        default_factory=VelocitySolverConfig)
    advection: AdvectionConfig = dataclasses.field(
        default_factory=AdvectionConfig)
    column: ColumnConfig = dataclasses.field(default_factory=ColumnConfig)

    @property
    def dynamics_timestep(self) -> float:
        # reference: mpas_seaice_velocity_solver.F:155
        return self.run.dt / self.velocity.dynamics_subcycle_number

    @property
    def elastic_timestep(self) -> float:
        # reference: mpas_seaice_velocity_solver.F:157
        return self.dynamics_timestep / self.velocity.elastic_subcycle_number

    @property
    def evp_damping_timescale(self) -> float:
        # reference: mpas_seaice_velocity_solver_constitutive_relation.F:125
        from . import constants
        return constants.EVP_DAMPING_TIMESCALE_PARAMETER * self.dynamics_timestep

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)


def box_test_config(elastic_subcycles: int = 120) -> Config:
    """Config for the planar EVP box test (no column physics, no transport)."""
    return Config(
        run=RunConfig(dt=600.0, n_categories=1),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=elastic_subcycles,
            rotate_cartesian_grid=False,
            include_metric_terms=False,
            geostrophic_surface_tilt=False,
        ),
        advection=AdvectionConfig(advection_type=AdvectionType.NONE),
        column=ColumnConfig(use_column_package=False),
    )
