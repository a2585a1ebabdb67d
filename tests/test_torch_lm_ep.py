"""The MoE's expert parallelism on the port's (data, model) mesh against
JAX's ``ep_psum`` branch on 4 host devices.

JAX takes its expert-parallel branch whenever the mesh's "model" axis
has more than one rank, whatever ``cfg.parallelism`` is, with a capacity
per rank and per data block, and returns the aux loss and the drops of
the first data block (``out_specs`` ``P()``).  The port does the same
(``models.moe.apply_moe_ep``).  JAX's reference runs once for this file,
in one subprocess under ``--xla_force_host_platform_device_count=4`` (as
``tests/test_sharded.py`` runs its own), and writes an npz: olmoe-1b-7b's
smoke config in float32 with a capacity factor of 0.5 (pairs dropped) on
(1, 4) and (2, 2) under ``"2d"`` and on (2, 2) under ``"fsdp"``, where
the port used to take its data-parallel local branch with the global
batch's capacity and statistics.  The port's gloo worlds
(``tests/_torch_lm_sharded_worker.py``) run the same cases on the same
weights.

Tolerances: logits 1e-5; the loss, ``aux_loss`` and ``drop_frac``
``F32_TOL`` relative; one train step (two microbatches) under
``test_torch_lm_sharded._check_step``'s masks; the engine's tokens
equal.
"""
import dataclasses
import os
import pickle
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)

import _torch_lm_sharded_worker as W  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenSource  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

from test_torch_lm_sharded import (F32_TOL, LOGIT_TOL,  # noqa: E402
                                   _check_step)

MOE_CF = 0.5
CASES = {"ep14": ("olmoe", (1, 4), "2d"), "ep22": ("olmoe", (2, 2), "2d"),
         "ep22 fsdp": ("olmoe fsdp", (2, 2), "fsdp")}

_SCRIPT = r"""
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, @SRC@)
from repro.common.config import OptimizerConfig, RunConfig
from repro.configs import smoke_config
from repro.launch.mesh import mesh_with_auto_axes
from repro.models.model import LM
from repro.serve.engine import Request, ServeEngine
from repro.train import optimizer as O
from repro.train import steps

assert jax.device_count() == 4, jax.device_count()
inp = pickle.loads(open(sys.argv[1], "rb").read())
cfg = smoke_config("olmoe-1b-7b").replace(dtype="float32")
cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=@CF@))
jp = LM(cfg).init(jax.random.PRNGKey(0))
jb = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
out = {}
for name, shape, pol in @CASES@:
    mesh = mesh_with_auto_axes(np.asarray(jax.devices()).reshape(shape),
                               ("data", "model"))
    lm = LM(cfg.replace(parallelism=pol), mesh)
    run = RunConfig(model=lm.cfg, opt=OptimizerConfig(**inp["opt"]),
                    microbatches=2)
    with mesh:
        lg, _ = jax.jit(lm.logits)(jp, jb)
        loss, aux = jax.jit(lm.loss)(jp, jb)
        p2, o2, m = jax.jit(steps.make_train_step(lm, run))(
            jp, O.init_opt_state(run.opt, jp), jb)
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                        max_new_tokens=inp["new"])
                for i, p in enumerate(inp["prompts"])]
        ServeEngine(lm, jp, inp["slots"], inp["max_seq"]).run(reqs)
    out[name + "/logits"] = np.asarray(lg, np.float32)
    for k, v in (("loss", loss), ("aux_loss", aux["moe_aux_loss"]),
                 ("drop_frac", aux["moe_drop_frac"]), ("ce", aux["ce"]),
                 ("step_loss", m["loss"]), ("grad_norm", m["grad_norm"])):
        out[name + "/" + k] = np.asarray(v, np.float32)
    for i, x in enumerate(jax.tree.leaves(p2)):
        out[f"{name}/params/{i}"] = np.asarray(x, np.float32)
    for i, x in enumerate(jax.tree.leaves(o2.m)):
        out[f"{name}/m/{i}"] = np.asarray(x, np.float32)
    out[name + "/tokens"] = np.asarray([r.out_tokens for r in reqs])
np.savez(sys.argv[2], **out)
print("EP-REFERENCE-DONE")
"""


def _jax_reference(tmp: Path, inputs: dict) -> subprocess.Popen:
    """Start JAX's run of every case on 4 host devices."""
    root = Path(__file__).resolve().parents[1]
    script = (_SCRIPT.replace("@SRC@", repr(str(root / "src")))
              .replace("@CF@", repr(MOE_CF))
              .replace("@CASES@", repr([(k, v[1], v[2])
                                        for k, v in CASES.items()])))
    (tmp / "jax_in.pkl").write_bytes(pickle.dumps(
        {"batch": inputs["batch"], "prompts": inputs["prompts"],
         "opt": W.OPT, "new": W.NEW, "slots": W.SLOTS,
         "max_seq": W.MAX_SEQ}))
    env = dict(os.environ)
    env.pop("REPRO_FAKE_DEVICES", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, "-c", script, str(tmp / "jax_in.pkl"),
         str(tmp / "jax_ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(root))


def _olmoe_cfgs():
    kw = dict(dtype="float32")
    jcfg, tcfg = (c.replace(**kw) for c in (j_smoke("olmoe-1b-7b"),
                                             smoke_config("olmoe-1b-7b")))
    return tuple(c.replace(moe=dataclasses.replace(c.moe,
                                                   capacity_factor=MOE_CF))
                 for c in (jcfg, tcfg))


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_ep")
    jcfg, tcfg = _olmoe_cfgs()
    jp = JLM(jcfg).init(jax.random.PRNGKey(0))
    r = np.random.default_rng(5)
    inputs = {"models": {"olmoe": (tcfg, jax.tree.map(np.asarray, jp)),
                         "olmoe fsdp": (tcfg.replace(parallelism="fsdp"),
                                        jax.tree.map(np.asarray, jp))},
              "batch": SyntheticTokenSource(DataConfig(
                  W.B, W.S, 257)).batch_at(0),
              "prompts": [r.integers(0, 257, n).astype(np.int32)
                          for n in W.LENS]}
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    proc = _jax_reference(tmp, inputs)
    got = {}
    try:
        ctx = W.spawn(tmp, "ep22", 4)
        W.wait(ctx)
        got.update({"ep22": W.results(tmp, "ep22", 4)["olmoe"],
                    "ep22 fsdp": W.results(tmp, "ep22", 4)["olmoe fsdp"]})
        ctx = W.spawn(tmp, "ep14", 4)
        W.wait(ctx)
        got["ep14"] = W.results(tmp, "ep14", 4)["olmoe"]
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "EP-REFERENCE-DONE" in log, log
    with np.load(tmp / "jax_ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    yield types.SimpleNamespace(got=got, ref=ref)
    shutil.rmtree(tmp, ignore_errors=True)


def _want(ref, case):
    n = len([k for k in ref if k.startswith(case + "/params/")])
    return {"logits": ref[case + "/logits"], "loss": float(ref[case + "/loss"]),
            "moe": {"moe_aux_loss": float(ref[case + "/aux_loss"]),
                    "moe_drop_frac": float(ref[case + "/drop_frac"])},
            "step": {"loss": float(ref[case + "/step_loss"]),
                     "grad_norm": float(ref[case + "/grad_norm"]),
                     "params": [ref[f"{case}/params/{i}"] for i in range(n)],
                     "m": [ref[f"{case}/m/{i}"] for i in range(n)]},
            "tokens": ref[case + "/tokens"].tolist()}


def test_layouts(ep):
    """Every case runs the expert-parallel branch over its "model" ranks;
    tensor parallelism only under "2d"."""
    assert ep.got["ep14"]["ep"] == (4, True)
    assert ep.got["ep22"]["ep"] == (2, True)
    assert ep.got["ep22 fsdp"]["ep"] == (2, False)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(ep, case):
    """Logits, the loss and its MoE terms: the first data block's aux
    loss and drops, as JAX returns them."""
    got, want = ep.got[case]["fwd"], _want(ep.ref, case)
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=F32_TOL)
    for k, v in want["moe"].items():
        np.testing.assert_allclose(got["moe"][k], v, rtol=F32_TOL,
                                   err_msg=k)


def test_pairs_are_dropped(ep):
    """The capacity factor of 0.5 drops pairs in every case."""
    for case in CASES:
        assert _want(ep.ref, case)["moe"]["moe_drop_frac"] > 0, case
        assert ep.got[case]["fwd"]["moe"]["moe_drop_frac"] > 0, case


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(ep, case):
    _check_step(ep.got[case]["step"], _want(ep.ref, case)["step"],
                f"olmoe {case} vs JAX")


@pytest.mark.parametrize("case", list(CASES))
def test_engine_tokens_equal_jax(ep, case):
    """Six requests on 4 slots: single-request prefills (a block of
    every row) and grouped decodes of the whole batch."""
    assert ep.got[case]["engine"] == _want(ep.ref, case)["tokens"]


def test_fsdp_on_a_model_axis_takes_the_expert_parallel_branch(ep):
    """Under ``"fsdp"`` on (2, 2) JAX's branch is picked by the mesh: the
    port's run equals JAX's and, as JAX's do, its "2d" run's forward."""
    a, b = ep.got["ep22 fsdp"]["fwd"], ep.got["ep22"]["fwd"]
    np.testing.assert_allclose(a["logits"], b["logits"], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=F32_TOL)
    ra, rb = _want(ep.ref, "ep22 fsdp"), _want(ep.ref, "ep22")
    np.testing.assert_allclose(ra["loss"], rb["loss"], rtol=F32_TOL)


def _stand_in(shape):
    mesh = dryrun.stand_in_mesh(shape)
    mesh.size = lambda axes=None: int(np.prod(
        [mesh.shape[a] for a in (mesh.axis_names if axes is None else
                                 [x for x in mesh.axis_names
                                  if x in (axes if isinstance(axes, tuple)
                                           else (axes,))])]))
    mesh.group = lambda axes: axes if mesh.size(axes) > 1 else None
    mesh.index = lambda axes: 0
    return mesh


@pytest.mark.parametrize("shape,policy,B,want", [
    ((2, 2), "2d", 4, (2, None, False)),
    ((2, 2), "2d", 1, (1, None, False)),
    ((2, 2), "fsdp", 4, (2, "model", True)),
    ((2, 2), "fsdp", 2, (1, None, False)),
    ((1, 4), "fsdp", 4, (4, "model", True)),
    ((2, 2, 2), "2d", 2, (2, ("pod",), False)),
])
def test_block_of_a_call(shape, policy, B, want):
    """A call's rows against JAX's ``shard_map`` block: ``rows`` a block,
    the axes this rank's rows are gathered over, and whether that is
    "model" (under "fsdp" the batch is cut over "model" too)."""
    cfg = smoke_config("olmoe-1b-7b").replace(parallelism=policy)
    lm = LM(cfg, _stand_in(shape))
    lo, hi = lm.batch_rows(B)
    rows = lm._enter(hi - lo, B)
    blk = lm._ep_block(rows)
    assert isinstance(blk, MOE.Block)
    got_gather = "model" if blk.over_model else blk.gather
    assert (blk.rows, got_gather, blk.over_model) == want
