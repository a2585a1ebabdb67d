"""The port's one-card dry run (``repro_torch.launch.dryrun``) and its
specs (``repro_torch.launch.specs``) against the JAX package's:
``cell_supported`` and ``arch_run_config`` equal JAX's for every config and
shape cell; the bytes of the weights, the AdamW state and the cache equal
the sums over JAX's ``abstract_params`` / ``abstract_opt_state`` /
``LM.cache_defs`` shapes, at the published depth and at a cut one; and
nothing is allocated (every tensor lies on the meta device)."""
import json

import jax
import numpy as np
import pytest

from repro.common.config import OptimizerConfig
from repro.common.config import SHAPES_BY_NAME as J_SHAPES
from repro.common.params import abstract_params as j_abstract_params
from repro.configs import get_config as j_get_config
from repro.launch import specs as j_specs
from repro.models.model import LM as JLM
from repro.train.optimizer import abstract_opt_state as j_abstract_opt
from repro_torch.common.config import SHAPES_BY_NAME
from repro_torch.common.params import abstract_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun, specs
from repro_torch.models.model import LM
from repro_torch.train.optimizer import abstract_opt_state, tree_leaves


def jax_bytes(tree) -> int:
    return int(sum(np.prod(x.shape) * np.dtype(x.dtype).itemsize
                   for x in jax.tree.leaves(tree)))


def jax_memory(cfg, shape: str, moment_dtype: str) -> dict:
    """The dry run's byte counts from JAX's abstract trees."""
    cell = J_SHAPES[shape]
    lm = JLM(cfg)
    params = j_abstract_params(lm.param_defs())
    out = {"weights_bytes": jax_bytes(params), "adamw_bytes": 0,
           "cache_bytes": 0}
    if cell.kind == "train":
        out["adamw_bytes"] = jax_bytes(j_abstract_opt(
            OptimizerConfig(moment_dtype=moment_dtype), params))
    else:
        out["cache_bytes"] = jax_bytes(jax.eval_shape(
            lambda: lm.cache_defs(cell.global_batch, cell.seq_len)))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_jax(arch):
    for shape in SHAPES_BY_NAME:
        assert specs.cell_supported(arch, shape) == \
            j_specs.cell_supported(arch, shape)
        for mesh in ("single", "multi"):
            t, j = (specs.arch_run_config(arch, shape, mesh),
                    j_specs.arch_run_config(arch, shape, mesh))
            assert t.microbatches == j.microbatches
            assert t.opt.moment_dtype == j.opt.moment_dtype
            assert t.model.arch_id == j.model.arch_id
    assert specs.FULL_ATTENTION_ARCHS == j_specs.FULL_ATTENTION_ARCHS
    assert specs.SUBQUADRATIC_ARCHS == j_specs.SUBQUADRATIC_ARCHS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_bytes_equal_jax(arch):
    """Every supported cell at the published depth, and at 2 layers'
    worth of the family's unit."""
    cut = {"ssm": 4, "hybrid": 6, "vlm": 10}.get(get_config(arch).family, 2)
    for shape in SHAPES_BY_NAME:
        res = dryrun.run_cell(arch, shape, layers=cut)
        if not specs.cell_supported(arch, shape)[0]:
            assert res["status"] == "skip"
            continue
        run = j_specs.arch_run_config(arch, shape)
        for key, cfg in (("published", j_get_config(arch)),
                         ("cut", j_get_config(arch).replace(num_layers=cut))):
            want = jax_memory(cfg, shape, run.opt.moment_dtype)
            got = res[key]
            assert {k: got[k] for k in want} == want, (shape, key)
            assert got["total_bytes"] == sum(want.values())
            assert got["fits"] == (got["total_bytes"] <= 80e9)
        assert res["cut"]["layers"] == cut


def test_nothing_is_allocated():
    cfg = get_config("llama3-405b")
    params = abstract_params(LM(cfg).param_defs())
    opt = abstract_opt_state(specs.arch_run_config(
        "llama3-405b", "train_4k").opt, params)
    cache = dryrun.abstract_cache(LM(cfg), 128, 32768)
    batch = specs.batch_abstract(get_config("llama-3.2-vision-90b"),
                                 SHAPES_BY_NAME["train_4k"])
    leaves = (tree_leaves(params) + tree_leaves(opt.m) + [opt.step]
              + tree_leaves(cache) + list(batch.values()))
    assert leaves and all(t.is_meta for t in leaves)
    assert dryrun.tree_bytes(params) > 800e9     # 405 B bf16 parameters


@pytest.mark.parametrize("arch", ["granite-8b", "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_batch_abstract_equal_jax(arch):
    for shape in SHAPES_BY_NAME:
        t = specs.batch_abstract(get_config(arch), SHAPES_BY_NAME[shape])
        j = j_specs.batch_abstract(j_get_config(arch), J_SHAPES[shape])
        assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in t.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in j.items()}


def test_cli(capsys):
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(ARCH_IDS) * len(SHAPES_BY_NAME)
    assert dryrun.main(["--arch", "granite-8b", "--shape", "train_4k",
                        "--layers", "8"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["published"]["fits"] is False and res["cut"]["fits"] is True
    assert res["activations"] == "not modelled"
