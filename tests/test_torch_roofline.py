"""The port's analytic roofline (``repro_torch.roofline``) and its shape
and hardware constants against the JAX package's: ``analytic_terms``
equals JAX's exactly (pure arithmetic on equal configs) for every config,
shape cell and mesh, ``model_flops`` likewise, and ``H100_SXM`` holds the
card's data-sheet numbers."""
import dataclasses

import pytest

from repro.common import config as j_config
from repro.configs import get_config as j_get_config
from repro.launch.specs import arch_run_config as j_run_config
from repro.roofline import analysis as j_analysis
from repro.roofline import analytic as j_analytic
from repro_torch.common import config as t_config
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.specs import arch_run_config
from repro_torch.roofline import analysis as t_analysis
from repro_torch.roofline import analytic as t_analytic

CELLS = [c.name for c in j_config.SHAPE_CELLS]
MESHES = {"default": ((), {}), "one card": ((1, 1, 1), {})}


def test_shape_cells_and_hw_defaults_as_jax():
    assert [dataclasses.astuple(c) for c in t_config.SHAPE_CELLS] == \
        [dataclasses.astuple(c) for c in j_config.SHAPE_CELLS]
    assert list(t_config.SHAPES_BY_NAME) == list(j_config.SHAPES_BY_NAME)
    assert t_config.SHAPES_BY_NAME["train_4k"].is_train
    assert dataclasses.asdict(t_config.TPU_V5E) == \
        dataclasses.asdict(j_config.TPU_V5E)
    assert [f.name for f in dataclasses.fields(t_config.HWConfig)] == \
        [f.name for f in dataclasses.fields(j_config.HWConfig)]


def test_h100_constants():
    hw = t_config.H100_SXM
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes, hw.ici_bw) == \
        (989e12, 3.35e12, 80e9, 450e9)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_terms_equal_jax(arch, cell, mesh):
    """Every term equal (==) for a config, a cell and a mesh (JAX's
    default 256-chip mesh, or one card), on TPU v5e's constants and on the
    H100's."""
    mb = arch_run_config(arch, cell).microbatches
    assert mb == j_run_config(arch, cell).microbatches
    dims = MESHES[mesh][0]
    t_mesh = t_analytic.MeshDims(*dims)
    j_mesh = j_analytic.MeshDims(*dims)
    t_cell, j_cell = t_config.SHAPES_BY_NAME[cell], \
        j_config.SHAPES_BY_NAME[cell]
    for t_hw, j_hw in ((t_config.TPU_V5E, j_config.TPU_V5E),
                       (t_config.H100_SXM, j_config.HWConfig(
                           **dataclasses.asdict(t_config.H100_SXM)))):
        got = t_analytic.analytic_terms(get_config(arch), t_cell, mb,
                                        t_mesh, t_hw)
        want = j_analytic.analytic_terms(j_get_config(arch), j_cell, mb,
                                         j_mesh, j_hw)
        assert got == want
    if dims == (1, 1, 1):
        assert got["a_collective_s"] == 0.0


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_equal_jax(kind):
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        args = (cfg.param_count(), cfg.active_param_count(), 4096, kind)
        assert t_analysis.model_flops(*args) == \
            j_analysis.model_flops(*args)
