"""Which EVP subcycle formulation the model runs, chosen from the scheme
and from the structure the mesh carries (dynamics/evp.velocity_path).
No option selects a path, and the removed kernel options are rejected.
"""

import dataclasses

import jax.numpy as jnp
import pytest

from seaice_tpu.config import (AdvectionConfig, StrainScheme,
                               StressDivergenceScheme, VelocitySolverConfig,
                               box_test_config)
from seaice_tpu.model import SeaIceModel


def _box(reorder):
    from seaice_tpu.mesh.structured import raster_reorder
    from seaice_tpu.testcases import box
    mesh = box.box_test_mesh(6, 6)
    return raster_reorder(mesh) if reorder else mesh


def _hex():
    from seaice_tpu.mesh import planar_hex_mesh
    return planar_hex_mesh(6, 6, 16000.0, periodic=True)


def _sphere(kind):
    import bench_full
    return bench_full.build_mesh(2, kind)


def _velocity(cfg, **kw):
    return cfg.replace(velocity=dataclasses.replace(cfg.velocity, **kw))


PLANAR = box_test_config(elastic_subcycles=2)
SPHERE = _velocity(PLANAR, rotate_cartesian_grid=True,
                   include_metric_terms=True)


@pytest.mark.parametrize("mesh_fn, cfg, expected", [
    (lambda: _box(True), PLANAR, "raster"),
    (lambda: _box(True), _velocity(PLANAR, include_metric_terms=True),
     "gather"),
    (_hex, PLANAR, "gather"),
    (lambda: _sphere("panel"), SPHERE, "panel"),
    (lambda: _sphere("icos"), SPHERE, "gather"),
    (lambda: _sphere("voronoi"), SPHERE, "gather"),
    (lambda: _box(True), _velocity(
        PLANAR, strain_scheme=StrainScheme.WEAK,
        stress_divergence_scheme=StressDivergenceScheme.WEAK), "weak"),
    (lambda: _sphere("panel"), _velocity(
        SPHERE, average_variational_strains=True), "reference"),
], ids=["raster-box", "box-metric", "planar-hex", "panel", "icos",
        "voronoi", "weak", "averaged-strains"])
def test_velocity_path_follows_mesh_structure(mesh_fn, cfg, expected):
    model = SeaIceModel(mesh_fn(), cfg, dtype=jnp.float64)
    assert model.velocity_path() == expected


@pytest.mark.parametrize("record, option", [
    (VelocitySolverConfig, "use_pallas_subcycle"),
    (VelocitySolverConfig, "use_fused_panel_loop"),
    (VelocitySolverConfig, "use_fused_unstructured"),
    (AdvectionConfig, "use_pallas_flux"),
])
def test_removed_kernel_options_rejected(record, option):
    with pytest.raises(TypeError):
        record(**{option: True})
