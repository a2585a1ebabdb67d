"""Tensor parallelism inside the non-dense families, and the int8
compressed data-parallel reduction, against the unsharded port and JAX.

zamba2-7b (Mamba-2 superblocks, the shared attention block, a tail),
llama-3.2-vision-90b (self and gated cross-attention blocks),
xlstm-125m under ``parallelism="2d"`` (mLSTM and sLSTM) and
seamless-m4t-large-v2 (encoder and decoder with cross-attention) run at
smoke width in float32 on gloo worlds of (1, 2), (2, 2) and (1, 4)
(``tests/_torch_lm_sharded_worker.py``), on JAX's weights with the
constant leaves (the vlm gate, ``A_log``, ``D``, ``dt_bias``, the gate
biases, norm scales) replaced by seeded values, as
``tests/test_torch_families.py`` does.  JAX runs these configs through
GSPMD on its mesh, which computes the unsharded math, so the reference is
the unsharded port and unsharded JAX: logits 1e-5, the loss
``F32_TOL``, one train step under ``_check_step``'s masks, decode logits
1e-5 against the unsharded port (after a prefill and from a zero cache),
the engine's tokens equal to JAX's engine's (the audio family is not
served).  The recurrent states and cross caches of ``init_cache`` are
the pieces JAX's ``cache_shardings`` gives along "model".

``compressed_psum`` on 4 gloo ranks, each rank's gradients and residuals
its own, equals JAX's on 4 host devices (one subprocess) within 1e-5,
mean and every rank's residual, and on one rank equals JAX's on one
device; ``wire_bytes`` equals JAX's.
"""
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
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

import _torch_lm_sharded_worker as W  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch.mesh import mesh_with_auto_axes  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.train import compression as j_comp  # noqa: E402
from repro_torch.common.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import compression as t_comp  # noqa: E402

from test_torch_families import _perturbed  # noqa: E402
from test_torch_lm_sharded import (F32_TOL, LOGIT_TOL,  # noqa: E402
                                   _check_step, _jax_ref, _port_ref)

FAMILIES = {"zamba2": ("zamba2-7b", {}), "vlm": ("llama-3.2-vision-90b", {}),
            "xlstm2d": ("xlstm-125m", {"parallelism": "2d"}),
            "seamless": ("seamless-m4t-large-v2", {})}
WORLDS = {"tp12": 2, "tp22": 4, "tp14": 4}
# on (1, 4) the smoke configs' 2 kv heads of the vlm and seamless do not
# divide: every rank attends over every head and keeps its share
LOCAL_HEADS_14 = {"zamba2": True, "vlm": False, "xlstm2d": True,
                  "seamless": False}
COMP_TOL = 1e-5
COMP_SHAPES = {"b": (7,), "w": (16, 12)}

_COMP_SCRIPT = r"""
import pickle, sys
import numpy as np, jax
sys.path.insert(0, @SRC@)
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import mesh_with_auto_axes
from repro.train.compression import compressed_psum

assert jax.device_count() == 4, jax.device_count()
inp = pickle.loads(open(sys.argv[1], "rb").read())
mesh = mesh_with_auto_axes(np.asarray(jax.devices()), ("data",))
devs = list(mesh.devices.flat)


def per_device(a):
    # a replicated-shape array whose value differs per device, as the
    # data-parallel gradients compressed_psum is written for
    return jax.make_array_from_single_device_arrays(
        a.shape[1:], NamedSharding(mesh, P()),
        [jax.device_put(a[i], d) for i, d in enumerate(devs)])


g = {k: per_device(v) for k, v in inp["grads"].items()}
r = {k: per_device(v) for k, v in inp["residuals"].items()}
mean, err = compressed_psum(g, r, mesh)
out = {}
for k in g:
    by_dev = {s.device: np.asarray(s.data) for s in mean[k].addressable_shards}
    out["mean/" + k] = by_dev[devs[0]]
    by_dev = {s.device: np.asarray(s.data) for s in err[k].addressable_shards}
    out["res/" + k] = np.stack([by_dev[d] for d in devs])
np.savez(sys.argv[2], **out)
print("COMP-REFERENCE-DONE")
"""


def _models():
    """Per family: (JAX LM, JAX params, port config, numpy params)."""
    out = {}
    for name, (arch, kw) in FAMILIES.items():
        kw = dict(kw, dtype="float32")
        jlm = JLM(j_smoke(arch).replace(**kw))
        jp = _perturbed(jlm.init(jax.random.PRNGKey(0)))
        out[name] = (jlm, jax.tree.map(jnp.asarray, jp),
                     smoke_config(arch).replace(**kw), jp)
    return out


def _batch(cfg, rng):
    b = {"tokens": rng.integers(0, 257, (W.B, W.S)),
         "labels": rng.integers(0, 257, (W.B, W.S))}
    if cfg.family == "vlm":
        b["img_embeds"] = rng.normal(0, 1, (W.B, cfg.vlm.num_image_tokens,
                                            cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["enc_embeds"] = rng.normal(0, 1, (W.B, W.S, cfg.d_model)).astype(
            np.float32)
    return b


def _comp_inputs():
    r = np.random.default_rng(7)
    scale = np.array([1.0, 3.0, 0.5, 2.0], np.float32)
    return {"grads": {k: (r.normal(0, 1, (4,) + s) * scale.reshape(
                (4,) + (1,) * len(s))).astype(np.float32)
                      for k, s in COMP_SHAPES.items()},
            "residuals": {k: r.normal(0, 0.01, (4,) + s).astype(np.float32)
                          for k, s in COMP_SHAPES.items()}}


def _jax_compression(tmp: Path, inputs: dict) -> subprocess.Popen:
    root = Path(__file__).resolve().parents[1]
    (tmp / "comp_in.pkl").write_bytes(pickle.dumps(inputs))
    env = dict(os.environ)
    env.pop("REPRO_FAKE_DEVICES", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    script = _COMP_SCRIPT.replace("@SRC@", repr(str(root / "src")))
    return subprocess.Popen(
        [sys.executable, "-c", script, str(tmp / "comp_in.pkl"),
         str(tmp / "comp_ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(root))


def _unsharded(tlm, tp, inputs, batch):
    out = _port_ref(tlm, tp, batch)
    out["decode"] = W.decodes(tlm, tp, inputs, batch)
    return out


def _jax_engine(jlm, jp, inputs):
    reqs = [j_engine.Request(rid=i, prompt=np.asarray(p, np.int32),
                             max_new_tokens=W.NEW)
            for i, p in enumerate(inputs["prompts"])]
    j_engine.ServeEngine(jlm, jp, W.SLOTS, W.MAX_SEQ).run(reqs)
    return [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def fams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_tp_families")
    models = _models()
    rng = np.random.default_rng(1)
    r = np.random.default_rng(5)
    inputs = {"models": {}, "batches": {}, "tp names": list(FAMILIES),
              "prompts": [r.integers(0, 257, n).astype(np.int32)
                          for n in W.LENS],
              "decode_tokens": np.random.default_rng(11).integers(
                  0, 257, (W.SLOTS, W.MAX_SEQ)).astype(np.int64)}
    for name, (jlm, jp, tcfg, npp) in models.items():
        inputs["models"][name] = (tcfg, npp)
        inputs["batches"][name] = _batch(tcfg, rng)
    inputs.update(_comp_inputs())
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    proc = _jax_compression(tmp, {k: inputs[k]
                                  for k in ("grads", "residuals")})
    got, ref = {}, {}
    try:
        ctxs = {w: W.spawn(tmp, w, n) for w, n in WORLDS.items()}
        for name, (jlm, jp, tcfg, npp) in models.items():
            batch = inputs["batches"][name]
            tlm = LM(tcfg)
            tp = params_from_numpy(npp, "lm", device="cpu")
            ref[name] = {"port": _unsharded(tlm, tp, inputs, batch),
                         "jax": _jax_ref(jlm, jp, batch)}
            if tcfg.family != "audio":
                ref[name]["jax tokens"] = _jax_engine(jlm, jp, inputs)
        for w, n in WORLDS.items():
            W.wait(ctxs[w])
            got[w] = W.results(tmp, w, n)
        ctx = W.spawn(tmp, "compress4", 4)
        W.wait(ctx)
        got["compress4"] = W.results(tmp, "compress4", 4)
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "COMP-REFERENCE-DONE" in log, log
    with np.load(tmp / "comp_ref.npz") as z:
        ref["compress"] = {k: z[k] for k in z.files}
    yield types.SimpleNamespace(got=got, ref=ref, inputs=inputs)
    shutil.rmtree(tmp, ignore_errors=True)


CASES = [(w, n) for w in WORLDS for n in FAMILIES]


@pytest.mark.parametrize("world,name", CASES)
def test_layout(fams, world, name):
    """Tensor parallelism over the "model" ranks, the heads local where
    they divide; the states and cross caches laid out as JAX's
    ``cache_shardings``."""
    got = fams.got[world][name]
    assert got["tp"] == ((4, LOCAL_HEADS_14[name]) if world == "tp14"
                         else (2, True))
    assert got["layout"] == []


@pytest.mark.parametrize("world,shape", [("tp22", (2, 2)),
                                         ("tp14", (1, 4))])
def test_init_cache_is_the_dry_runs_piece(fams, world, shape):
    """Every arch's smoke config at 1 to 4 rows and ``max_seq`` 32 and 64:
    each ``init_cache`` leaf is the dry run's per-rank piece (JAX's rule,
    the dims found by length: on (2, 2) at 2 rows the 2 layers take the
    batch's cut, at 32 positions the 32 kv features the sequence's)."""
    assert W.layout_mismatches(fams.got[world]["layouts"], shape) == []


@pytest.mark.parametrize("world,name", CASES)
def test_forward_matches_unsharded_and_jax(fams, world, name):
    got = fams.got[world][name]["fwd"]
    for want in (fams.ref[name]["port"], fams.ref[name]["jax"]):
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=F32_TOL)


@pytest.mark.parametrize("world,name", CASES)
def test_train_step_matches_unsharded_and_jax(fams, world, name):
    got = fams.got[world][name]["step"]
    _check_step(got, fams.ref[name]["port"]["step"], f"{name} {world} port")
    _check_step(got, fams.ref[name]["jax"]["step"], f"{name} {world} JAX")


@pytest.mark.parametrize("world,name", CASES)
def test_decode_matches_unsharded(fams, world, name):
    """Three decodes after an 8-token prefill and three from a zero cache:
    the states stepped on each rank's heads, the cross caches over each
    rank's kv heads or positions."""
    got, want = fams.got[world][name]["decode"], fams.ref[name]["port"][
        "decode"]
    assert set(got) == set(want)
    for pos in want:
        np.testing.assert_allclose(got[pos], want[pos], rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"pos {pos}")


@pytest.mark.parametrize("world,name", [c for c in CASES
                                        if c[1] != "seamless"])
def test_engine_tokens_equal_jax(fams, world, name):
    assert fams.got[world][name]["engine"] == fams.ref[name]["jax tokens"]


def test_compressed_psum_on_four_ranks_matches_jax(fams):
    """The mean (the int32 sum of every rank's int8 values times the
    largest scale over 4) and each rank's residual."""
    got, ref = fams.got["compress4"], fams.ref["compress"]
    for k in COMP_SHAPES:
        np.testing.assert_allclose(got["mean"][k], ref["mean/" + k], rtol=0,
                                   atol=COMP_TOL, err_msg=k)
        np.testing.assert_allclose(got["res"][k], ref["res/" + k], rtol=0,
                                   atol=COMP_TOL, err_msg=k)


def test_compressed_psum_on_one_rank_matches_jax():
    """One rank (no group): 20 steps of error feedback equal JAX's on one
    device step by step (``tests/test_distribution.py``'s loop)."""
    mesh = mesh_with_auto_axes(np.array(jax.devices()[:1]).reshape(1,),
                               ("data",))
    g = np.random.default_rng(0).normal(0, 1, (64,)).astype(np.float32)
    jr = j_comp.init_residuals({"w": jnp.asarray(g)})
    tr = t_comp.init_residuals({"w": torch.from_numpy(g)})
    for _ in range(20):
        jm, jr = j_comp.compressed_psum({"w": jnp.asarray(g)}, jr, mesh,
                                        axis="data")
        tm, tr = t_comp.compressed_psum({"w": torch.from_numpy(g)}, tr, None)
        np.testing.assert_allclose(tm["w"].numpy(), np.asarray(jm["w"]),
                                   rtol=0, atol=COMP_TOL)
        np.testing.assert_allclose(tr["w"].numpy(), np.asarray(jr["w"]),
                                   rtol=0, atol=COMP_TOL)


def test_wire_bytes_match_jax(fams):
    tree = {k: np.zeros(s, np.float32) for k, s in COMP_SHAPES.items()}
    for nbytes in (4, 2):
        assert t_comp.wire_bytes({k: torch.from_numpy(v)
                                  for k, v in tree.items()}, nbytes) == \
            j_comp.wire_bytes(tree, nbytes)
    assert fams.got["compress4"]["wire"] == j_comp.wire_bytes(
        {k: v[0] for k, v in fams.inputs["grads"].items()})


def _drive(lm, p, cfg):
    """Logits, a prefill's and four decodes' logits, and (but for the
    audio family) the engine's tokens."""
    g = torch.Generator().manual_seed(1)
    tok = torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (4, 13)))
    more = {}
    if cfg.family == "vlm":
        more["img_embeds"] = torch.randn(4, cfg.vlm.num_image_tokens,
                                         cfg.d_model, generator=g)
    if cfg.family == "audio":
        more["enc_embeds"] = torch.randn(4, 8, cfg.d_model, generator=g)
    out = [lm.logits(p, {"tokens": tok[:, :8], "labels": tok[:, 1:9],
                         **more})[0]]
    lg, cache = lm.prefill(p, {"tokens": tok[:, :8], **more}, W.MAX_SEQ)
    out.append(lg)
    for i in range(8, 12):
        lg, cache = lm.decode(p, tok[:, i:i + 1], cache, i)
        out.append(lg)
    if cfg.family == "audio":
        return out, None
    r = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=r.integers(0, cfg.vocab_size, n).astype(
        np.int32), max_new_tokens=4) for i, n in enumerate(W.LENS)]
    ServeEngine(lm, p, W.SLOTS, W.MAX_SEQ, device="cpu").run(reqs)
    return out, [q.out_tokens for q in reqs]


@pytest.mark.parametrize("arch,kw", [
    ("olmoe-1b-7b", {}), ("kimi-k2-1t-a32b", {}), ("zamba2-7b", {}),
    ("llama-3.2-vision-90b", {}), ("xlstm-125m", {"parallelism": "2d"}),
    ("seamless-m4t-large-v2", {})])
def test_one_rank_groups_run_every_family_bitwise(arch, kw):
    """``make_host_mesh(one_rank_groups=True)``: every family takes its
    tensor-parallel path (and the MoE its expert-parallel branch) at
    n = 1, issuing each collective as a copy, and its logits, prefill and
    decode logits equal the unsharded port's bit for bit, its engine
    tokens too (``chip_smoke.py`` phase 15 on the card)."""
    cfg = smoke_config(arch).replace(dtype="float32", **kw)
    ref = LM(cfg)
    params = ref.init(torch.Generator().manual_seed(0))
    want = _drive(ref, params, cfg)
    mesh_mod.init_distributed("cpu", rank=0, world_size=1)
    try:
        lm = LM(cfg, mesh_mod.make_host_mesh(one_rank_groups=True))
        assert lm.tp.n == 1 and (lm.ep is not None) == (cfg.family == "moe")
        got = _drive(lm, lm.shard(params), cfg)
    finally:
        mesh_mod.shutdown()
    assert len(got[0]) == len(want[0])
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        assert torch.equal(a, b), f"call {i}"
    assert got[1] == want[1]
