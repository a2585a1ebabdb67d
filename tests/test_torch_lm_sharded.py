"""The LM on the port's (data, model) mesh on the CPU, against the
unsharded port and the JAX package.

Without spawning: the port's logical axes equal JAX's ``param_defs``
leaf by leaf for every config; ``param_pspecs``, ``data_spec`` and
``cache_spec`` equal JAX's on stand-in (16, 16) and (2, 16, 16) meshes
for the ``2d`` / ``fsdp`` / ``dp`` policies with and without
``fsdp_over_pod``; the placements of ``batch_shardings`` and
``cache_shardings`` equal JAX's specs; every non-dense family builds on
a "model" axis of 2 with its blocks' leaves cut as JAX's rules say; the
per-rank dry run adds up to the whole model (olmoe's experts cut over
"model" on (1, 4)); flash-decode over a cache cut into 4 position ranges, merged
(``merge_ranges``), equals one call over the whole cache (the plain
version: the kernel's own check is ``chip_smoke.py`` phase 14); the
one-rank mesh runs the unsharded ops bit for bit.

Worlds of gloo ranks (rank bodies in ``tests/_torch_lm_sharded_worker.py``)
run granite-8b's smoke config in float32 with its vocabulary padded to
260 rows (so it cuts over 2 and 4 "model" ranks) on (2, 2), (1, 4) and
(4, 1) (and under ``parallelism="fsdp"`` on (2, 2)), qwen1.5-4b's (QKV
bias, int8 cache) on (2, 2) and (1, 4),
zamba2-7b's and olmoe-1b-7b's (capacity factor 0.5: pairs dropped) on
(4, 1) and xlstm-125m's (``parallelism="dp"``) on (1, 2),
all from JAX's parameters through ``common/convert.py``.  Tolerances:
logits 1e-5 and the loss ``F32_TOL`` relative against the unsharded port
(``tests/test_torch_train.py``'s against JAX too); the grad norm 1e-6
relative (a replicated leaf counted once per rank would be off by the
world size); updated parameters 2e-5 (``tests/test_torch_train.py``'s
``PARAM_TOL``) wherever the gradient exceeds 1e-5 of its leaf's largest
(``tests/test_torch_families.py``'s mask: Adam's first
step turns a ~1e-7 relative difference of a near-zero gradient into a
step-sized one; 2.01e-5 measured at (2, 2) on an element whose first
moment is 1e-6 of its leaf's), the first moments 1e-5 everywhere; engine
tokens equal to JAX's; decode logits 1e-5 against the unsharded port at
positions 0 and on a slice boundary (the int8 cache: 1e-3 of max
|logit|, ``INT8_RTOL``).  A checkpoint of a (2, 2) world's
bfloat16 parameters and AdamW state restores onto (1, 4), (4, 1) and no
mesh bit for bit; JAX reads it and writes it back, and (1, 4) reads
JAX's file bit for bit too.

granite-8b's smoke config in bfloat16 on (1, 4) is held against JAX's
own (1, 4) mesh on 4 host devices (one subprocess,
``_torch_lm_sharded_worker.jax_serve``): prefill and decode logits within
``BF16_TP_SPACINGS`` bf16 spacings at the largest |logit|, and the
engine's tokens equal.
"""
import collections
import dataclasses
import pickle
import shutil
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several pytest workers at once, and
# every spawned rank takes a core of its own
torch.set_num_threads(1)

import _torch_lm_sharded_worker as W  # noqa: E402
from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.common.config import OptimizerConfig as JOptCfg  # noqa: E402
from repro.common.config import RunConfig as JRunConfig  # noqa: E402
from repro.common.config import SHAPES_BY_NAME  # noqa: E402
from repro.common.params import is_def  # noqa: E402
from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.common.config import OptimizerConfig, RunConfig  # noqa
from repro_torch.common.convert import params_from_numpy  # noqa: E402
from repro_torch.common.params import map_defs  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenSource  # noqa: E402
from repro_torch.kernels.flash_decode import ops as fd_ops  # noqa: E402
from repro_torch.kernels.flash_decode import ref as fd_ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import steps as t_steps  # noqa: E402

F32_TOL = 1e-5          # tests/test_torch_train.py: logits, loss
LOGIT_TOL = 1e-5        # sharded vs unsharded logits (train and decode)
BF16_KW = dict(pad_vocab_to_multiple=4)
BF16_TP_SPACINGS = 4    # bf16 (1, 4) vs JAX's (1, 4): bf16 spacings at the
                        # largest |logit| (measured 3.0)
STEP_TOL = 1e-5         # loss, grad_norm (relative), first moments
PARAM_TOL = 2e-5        # updated parameters (test_torch_train.py) ...
GRAD_FLOOR = 1e-5       # ... where |m| > this x its max (test_torch_families.py)
NORM_RTOL = 1e-6        # the global grad norm vs the unsharded norm
# the int8 cache's decode logits vs the unsharded port, of max |logit|: a
# row-parallel sum in another order moves a float32 k by an ulp, and its
# bfloat16 (position, head) scale can round one bf16 ulp (2^-8) apart;
# 2.2e-4 measured (qwen1.5-4b smoke at (1, 4), position 8)
INT8_RTOL = 1e-3
MOE_CF = 0.5            # olmoe's capacity factor on (4, 1): pairs dropped
MESHES = {"world22": (2, 2), "world14": (1, 4), "world41": (4, 1)}
STAND_IN = [(16, 16), (2, 16, 16)]
POLICIES = [("2d", False), ("2d", True), ("fsdp", False), ("fsdp", True),
            ("dp", False)]


def stand_in(shape):
    """A mesh of axis names and sizes (all the layout rules read)."""
    return dryrun.stand_in_mesh(shape)


def _port_leaves(tree):
    return [x.float().numpy() for x in t_opt.tree_leaves(tree)]


def _jax_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _np_leaves(tree):
    """The leaves of a dict tree of numpy arrays, in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    return [tree]


# -- the layout against JAX's, no spawn ---------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_logical_axes_match_jax(arch):
    """Every leaf of the port's ``param_defs`` has JAX's shape and
    ``logical_axes``, and neither tree has a leaf the other lacks."""
    flat = jax.tree_util.tree_flatten_with_path(
        JLM(j_get(arch)).param_defs(), is_leaf=is_def)[0]
    got = []
    map_defs(got.append, LM(get_config(arch)).param_defs())
    assert len(got) == len(flat)
    for (path, d), t in zip(flat, got):
        assert tuple(t.shape) == tuple(d.shape), path
        assert tuple(t.logical_axes) == tuple(d.logical_axes), path


@pytest.mark.parametrize("shape", STAND_IN)
@pytest.mark.parametrize("arch", list_archs())
def test_param_pspecs_match_jax(arch, shape):
    """``spec_for`` and ``param_pspecs`` (divisibility-safe) leaf by leaf,
    every policy with and without ``fsdp_over_pod``."""
    mesh = stand_in(shape)
    jdefs = JLM(j_get(arch)).param_defs()
    tdefs = LM(get_config(arch)).param_defs()
    jd = jax.tree.leaves(jdefs, is_leaf=is_def)
    td = []
    map_defs(td.append, tdefs)
    for pol, pod in POLICIES:
        want = jax.tree.leaves(j_rules.param_pspecs(jdefs, mesh, pod, pol),
                               is_leaf=lambda x: isinstance(x, tuple))
        got = rules.spec_leaves(rules.param_pspecs(tdefs, mesh, pod, pol))
        assert [tuple(w) for w in want] == got, (pol, pod)
        for a, b in zip(jd, td):
            assert tuple(j_rules.spec_for(a, mesh, pod, pol)) == \
                rules.spec_for(b, mesh, pod, pol)


@pytest.mark.parametrize("shape", STAND_IN)
def test_batch_rules_and_cache_spec_match_jax(shape):
    mesh = stand_in(shape)
    for pol in ("2d", "fsdp", "dp"):
        assert rules.batch_axes(mesh, pol) == j_rules.batch_axes(mesh, pol)
        for batch in (1, 2, 3, 16, 32, 64, 256, 512, 1024):
            assert rules.fit_batch_axes(mesh, batch, pol) == \
                j_rules.fit_batch_axes(mesh, batch, pol)
            assert rules.data_spec(mesh, batch, None, "model",
                                   policy=pol) == tuple(j_rules.data_spec(
                                       mesh, batch, None, "model",
                                       policy=pol))
    for batch in (1, 4, 16, 32, 256):
        for seq in (7, 16, 4096):
            assert rules.cache_spec(mesh, batch, seq) == \
                j_rules.cache_spec(mesh, batch, seq)
    for spec in [("data", "model"), (("pod", "data"), None), ("model",)]:
        if "pod" in str(spec) and len(shape) == 2:
            continue
        for dims in [(7, 13), (32, 64), (256, 256), (512,)]:
            s = spec[:len(dims)]
            assert rules.safe_spec(dims, s, mesh) == tuple(
                j_rules.safe_spec(dims, jax.sharding.PartitionSpec(*s),
                                  mesh))


@pytest.mark.parametrize("arch", ["granite-8b", "qwen1.5-4b", "xlstm-125m",
                                  "zamba2-7b", "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2", "olmoe-1b-7b"])
@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16), (2, 2), (4, 1)])
def test_batch_and_cache_shardings_match_jax(arch, shape, monkeypatch):
    """The placements of ``batch_shardings`` / ``cache_shardings`` are
    JAX's specs' (JAX's NamedShardings read through to their specs)."""
    monkeypatch.setattr(j_specs, "NamedSharding", lambda mesh, spec: spec)
    mesh = stand_in(shape)
    jcfg, tcfg = j_get(arch), get_config(arch)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        cell = SHAPES_BY_NAME[name]
        jb = j_specs.batch_shardings(jcfg, cell, mesh)
        tb = t_specs.batch_shardings(tcfg, cell, mesh)
        assert set(jb) == set(tb)
        for k in jb:
            assert tb[k] == rules.param_placements(tuple(jb[k]), mesh), k
    for batch, seq in ((cell.global_batch, cell.seq_len), (1, 64), (3, 48)):
        jc = jax.tree_util.tree_flatten_with_path(j_specs.cache_shardings(
            JLM(jcfg), batch, seq, mesh))[0]
        tc = t_specs.cache_shardings(LM(tcfg), batch, seq, mesh)
        for path, spec in jc:
            node = tc
            for p in path:
                node = node[p.key]
            assert node == rules.param_placements(tuple(spec), mesh), path


class _Rank:
    """A stand-in mesh seen from one rank: its coordinates, row-major
    positions along axes (``LMMesh.index``)."""

    def __init__(self, shape, coords):
        m = stand_in(shape)
        self.axis_names, self.shape, self.coords = m.axis_names, m.shape, \
            coords

    def index(self, axes):
        i = 0
        for a in self.axis_names:
            if a in rules.spec_axes(axes):
                i = i * self.shape[a] + self.coords[a]
        return i


def test_placements_and_pieces():
    """A ("pod", "data") entry cuts one dim over two mesh dims, outer
    first; ``local_slice`` and ``local_shape`` agree."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Rank((2, 4, 2), {"pod": 1, "data": 2, "model": 0})
    assert rules.param_placements((("pod", "data"), "model"), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert rules.param_placements((None, "data"), mesh) == [
        Replicate(), Shard(1), Replicate()]
    x = torch.arange(16 * 6).reshape(16, 6)
    piece = rules.local_slice(x, (("pod", "data"), "model"), mesh)
    assert tuple(piece.shape) == rules.local_shape((16, 6), (
        ("pod", "data"), "model"), mesh) == (2, 3)
    assert torch.equal(piece, x[12:14, 0:3])


# one leaf per family whose "model" cut its blocks read under "2d"
# (a path of keys, and the cut's entry in its spec)
NON_DENSE_CUTS = {
    "olmoe-1b-7b": (("blocks", "moe", "w_gate"), ("model", "data", None)),
    "kimi-k2-1t-a32b": (("blocks", "moe", "shared", "up", "w"),
                        ("data", "model")),
    "zamba2-7b": (("blocks", "mamba", "in_proj"), ("data", "model")),
    "xlstm-125m": (("blocks", "mlstm", "mlstm", "up"), ("data", "model")),
    "llama-3.2-vision-90b": (("blocks", "cross", "xattn", "k", "w"),
                             ("data", "model")),
    "seamless-m4t-large-v2": (("dec_blocks", "xattn", "o", "w"),
                              ("model", "data")),
}


@pytest.mark.parametrize("arch,kw", [
    ("olmoe-1b-7b", {}), ("kimi-k2-1t-a32b", {}), ("zamba2-7b", {}),
    ("xlstm-125m", {"parallelism": "2d"}), ("llama-3.2-vision-90b", {}),
    ("seamless-m4t-large-v2", {})])
def test_non_dense_family_on_a_model_axis_raises(arch, kw):
    """Every family builds on a "model" axis of 2 under "2d" (the refusal
    of slice 13 is gone): tensor parallelism with local heads, the MoE's
    expert parallelism, and the family's blocks' leaves cut over "model"
    as JAX's rules say; under "fsdp" the MoE keeps its expert
    parallelism (JAX picks it by the mesh) and nothing else is
    tensor-parallel."""
    cfg = smoke_config(arch).replace(**kw)
    mesh = stand_in((1, 2))
    mesh.group = lambda axes: (axes if rules.axes_size(mesh, axes) > 1
                               else None)
    mesh.size = lambda axes=None: rules.axes_size(
        mesh, mesh.axis_names if axes is None else axes)
    mesh.index = lambda axes: 0
    lm = LM(cfg, mesh)
    assert (lm.tp.n, lm.tp.r, lm.tp.local_heads) == (2, 0, True)
    moe = cfg.family == "moe"
    assert (lm.ep is not None) == moe
    if moe:
        assert (lm.ep.n, lm.ep.size, lm.ep.model_grads) == (2, 2, True)
    path, want = NON_DENSE_CUTS[arch]
    spec = lm.specs
    for k in path:
        spec = spec[k]
    depth = len(spec) - len(want)
    assert spec[depth:] == want, spec
    lf = LM(cfg.replace(parallelism="fsdp"), mesh)
    assert lf.tp is None and (lf.ep is not None) == moe
    if moe:
        assert lf.ep.model_grads is False


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1), (2, 2, 2)])
@pytest.mark.parametrize("arch", ["granite-8b", "qwen1.5-4b", "xlstm-125m",
                                  "olmoe-1b-7b"])
def test_dryrun_per_rank_adds_up_to_the_whole(arch, shape):
    """Each leaf's piece times the pieces it is cut into is the whole
    leaf, so the per-rank bytes of a mesh, leaf by leaf, add up to the
    one-card dry run's; a replicated leaf counts whole on every rank."""
    cfg = get_config(arch)
    mesh = dryrun.stand_in_mesh(shape)
    for shape_name in ("train_4k", "decode_32k"):
        per = dryrun.memory_per_rank(cfg, shape_name, "float32", mesh)
        whole = dryrun.memory(cfg, shape_name, "float32")
        defs = LM(cfg).param_defs()
        specs = rules.param_pspecs(defs, mesh, cfg.fsdp_over_pod,
                                   cfg.parallelism)
        total, rep = 0, 0
        for d, spec in zip(_defs(defs), rules.spec_leaves(specs)):
            local = int(np.prod(rules.local_shape(d.shape, spec, mesh)))
            cuts = int(np.prod([rules.axes_size(mesh, e) for e in spec]))
            assert local * cuts == int(np.prod(d.shape))
            nbytes = torch.empty((), dtype=d.dtype).element_size()
            total += local * cuts * nbytes
            rep += 0 if cuts > 1 else local * nbytes
        assert total == whole["weights_bytes"]
        assert per["weights_bytes"] >= rep
        if arch == "olmoe-1b-7b" and shape == (1, 4):
            # expert parallelism: the experts cut over "model", a quarter
            # of them on each rank
            moe = specs["blocks"]["moe"]
            for k in ("w_gate", "w_up", "w_down"):
                assert moe[k][1] == "model", k
            assert rules.local_shape(defs["blocks"]["moe"]["w_up"].shape,
                                     moe["w_up"], mesh)[1] == 16
        if shape_name == "train_4k":
            assert per["adamw_bytes"] > 0
        else:
            assert 0 < per["cache_bytes"] <= whole["cache_bytes"]


def _defs(defs):
    out = []
    map_defs(out.append, defs)
    return out


def test_dryrun_cli_reports_granite_per_rank(capsys):
    """granite-8b at train_4k over (1, 4): 36 layers are 82.55 GB on one
    card and a quarter of it (plus the replicated norms) on each of 4."""
    import json
    dryrun.main(["--arch", "granite-8b", "--shape", "train_4k", "--mesh",
                 "1x4", "--layers", "8"])
    got = json.loads(capsys.readouterr().out)
    pr, whole = got["per_rank"], got["published"]
    assert pr["mesh"] == {"data": 1, "model": 4}
    assert whole["total_bytes"] > 80e9 and pr["fits"]
    assert abs(pr["total_bytes"] - whole["total_bytes"] / 4) < 1e7
    assert got["cut_per_rank"]["weights_bytes"] < pr["weights_bytes"]


# -- flash-decode over a cut cache (the plain version) ----------------------------

@pytest.mark.parametrize("valid", [0, 300, 512, 528, 2048])
def test_merge_ranges_equals_one_call_over_the_cache(valid):
    """4 position ranges of a 2048-position cache, each through the plain
    flash-decode at its clamped valid length, merged: out, m and l equal
    one call over the whole cache; and with the fresh token merged after,
    the decode's attention.  Lengths: none valid (every range empty),
    only range 0 valid, a range boundary, and past it."""
    r = np.random.default_rng(valid)
    B, S, H, KV, hd, n = 2, 2048, 8, 2, 16, 4
    q, k1, v1 = (torch.from_numpy(r.normal(0, 1, s).astype(np.float32))
                 for s in ((B, 1, H, hd), (B, 1, KV, hd), (B, 1, KV, hd)))
    k, v = (torch.from_numpy(r.normal(0, 1, (B, S, KV, hd)).astype(
        np.float32)) for _ in range(2))
    whole = fd_ref.flash_decode_ref(q, k, v, kv_valid_len=valid)
    s_loc = S // n
    parts = [fd_ref.flash_decode_ref(
        q, k[:, i * s_loc:(i + 1) * s_loc].contiguous(),
        v[:, i * s_loc:(i + 1) * s_loc].contiguous(),
        kv_valid_len=min(max(valid - i * s_loc, 0), s_loc))
        for i in range(n)]
    out, m, l = fd_ops.merge_ranges(
        torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
        torch.stack([p[2] for p in parts]), lambda t: t.amax(0),
        lambda t: t.sum(0))
    np.testing.assert_allclose(out.reshape(q.shape).numpy(),
                               whole[0].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), whole[1].numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(l.numpy(), whole[2].numpy(), rtol=1e-5)
    got = fd_ops.merge_new(q, k1, v1, out.reshape(q.shape), m, l)
    want = fd_ops.flash_decode_with_new(q, k, v, k1, v1, kv_valid_len=valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


# -- the one-rank mesh ---------------------------------------------------------------

def test_host_mesh_runs_the_unsharded_ops_bitwise():
    """``make_host_mesh()`` (a one-rank gloo group in this process) is
    (1, 1) with no group to talk over; the LM on it gives the unsharded
    logits, loss and train step bit for bit; ``make_production_mesh`` of
    one rank is the same shape, with a pod axis under ``multi_pod``; and
    ``shutdown`` drops the meshes."""
    cfg = smoke_config("granite-8b").replace(dtype="float32")
    ref = LM(cfg)
    params = ref.init(torch.Generator().manual_seed(0))
    src = SyntheticTokenSource(DataConfig(4, 16, cfg.vocab_size))
    batch = {k: torch.from_numpy(v) for k, v in src.batch_at(0).items()}
    run = RunConfig(model=cfg, opt=OptimizerConfig(**W.OPT), microbatches=2)
    want = t_steps.make_train_step(ref, run)(
        params, t_opt.init_opt_state(run.opt, params), batch)
    mesh_mod.init_distributed("cpu", rank=0, world_size=1)
    try:
        mesh = mesh_mod.make_host_mesh()
        assert mesh.axis_names == ("data", "model")
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.group("data") is None and mesh.group(("data",
                                                          "model")) is None
        assert mesh_mod.make_production_mesh() is mesh
        assert mesh_mod.make_production_mesh(multi_pod=True).shape == {
            "pod": 1, "data": 1, "model": 1}
        lm = LM(cfg, mesh)
        p = lm.shard(params)
        assert all(a is b for a, b in zip(t_opt.tree_leaves(p),
                                          t_opt.tree_leaves(params)))
        assert torch.equal(lm.logits(p, batch)[0], ref.logits(params,
                                                              batch)[0])
        assert torch.equal(lm.loss(p, batch)[0], ref.loss(params, batch)[0])
        got = t_steps.make_train_step(lm, run)(
            p, t_opt.init_opt_state(run.opt, p), batch)
        for k in ("loss", "grad_norm"):
            assert torch.equal(got[2][k], want[2][k]), k
        for a, b in zip(t_opt.tree_leaves(got[0]),
                        t_opt.tree_leaves(want[0])):
            assert torch.equal(a, b)
    finally:
        mesh_mod.shutdown()
    assert not mesh_mod._LM_MESHES


def test_one_rank_groups_run_the_tensor_parallel_path(monkeypatch):
    """``make_host_mesh(one_rank_groups=True)`` gives "data" and "model"
    one-rank gloo groups: the LM takes its tensor-parallel path at n = 1
    and issues every collective (each a copy): the FSDP gathers, the
    vocab-parallel lookup and logits, the decode's flash-decode over the
    whole cache as rank 0's slice with the ranges merged over "model"
    (``merge_ranges``: one range gives its own out exactly) and the
    vocab-parallel argmax.  Its logits, engine tokens and every prefill's
    and decode's logits equal the unsharded port's bit for bit; the loss
    (a vocab-parallel logsumexp: another order of sums) within
    ``F32_TOL``."""
    cfg = smoke_config("granite-8b").replace(dtype="float32")
    ref = LM(cfg)
    params = ref.init(torch.Generator().manual_seed(0))
    src = SyntheticTokenSource(DataConfig(4, 16, cfg.vocab_size))
    batch = {k: torch.from_numpy(v) for k, v in src.batch_at(0).items()}
    r = np.random.default_rng(5)
    prompts = [r.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in W.LENS]

    def engine(lm, p):
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=W.NEW)
                for i, pr in enumerate(prompts)]
        ServeEngine(lm, p, W.SLOTS, W.MAX_SEQ, device="cpu").run(reqs)
        return [q.out_tokens for q in reqs]

    def decodes(lm, p):
        tok = torch.from_numpy(np.random.default_rng(11).integers(
            0, cfg.vocab_size, (W.SLOTS, 12)))
        lg, cache = lm.prefill(p, {"tokens": tok[:, :8]}, W.MAX_SEQ)
        out = [lg]
        for i in range(8, 12):
            lg, cache = lm.decode(p, tok[:, i:i + 1], cache, i)
            out.append(lg)
        return out

    want = (ref.logits(params, batch)[0], ref.loss(params, batch)[0],
            engine(ref, params), decodes(ref, params))
    mesh_mod.init_distributed("cpu", rank=0, world_size=1)
    try:
        mesh = mesh_mod.make_host_mesh(one_rank_groups=True)
        assert mesh is not mesh_mod.make_host_mesh()
        assert mesh.group("model") is not None
        assert mesh.group(("data", "model")) is not None
        lm = LM(cfg, mesh)
        assert (lm.tp.n, lm.tp.r, lm._vocab_cut) == (1, 0, True)
        p = lm.shard(params)
        calls = collections.Counter()
        for name in ("all_gather", "all_reduce", "reduce_scatter"):
            def counted(*a, _f=getattr(torch.distributed, name), _n=name,
                        **kw):
                calls[_n] += 1
                return _f(*a, **kw)
            monkeypatch.setattr(torch.distributed, name, counted)
        assert torch.equal(lm.logits(p, batch)[0], want[0])
        np.testing.assert_allclose(float(lm.loss(p, batch)[0]),
                                   float(want[1]), rtol=F32_TOL)
        assert engine(lm, p) == want[2]
        got = decodes(lm, p)
        assert len(got) == len(want[3])
        for i, (a, b) in enumerate(zip(got, want[3])):
            assert torch.equal(a, b), f"call {i}"
        assert calls["all_gather"] and calls["all_reduce"], calls
    finally:
        mesh_mod.shutdown()


# -- the worlds ------------------------------------------------------------------

def _jax_model(name):
    cfgs = {"granite": ("granite-8b", dict(pad_vocab_to_multiple=4)),
            "qwen": ("qwen1.5-4b", dict(pad_vocab_to_multiple=4)),
            "zamba2": ("zamba2-7b", {}), "xlstm": ("xlstm-125m", {}),
            "olmoe": ("olmoe-1b-7b", {})}
    arch, kw = cfgs[name]
    kw = dict(kw, dtype="float32")
    jcfg, tcfg = j_smoke(arch).replace(**kw), smoke_config(arch).replace(**kw)
    if name == "olmoe":
        # a capacity below the pairs: the global pair order decides which
        # rank's pairs are dropped (ranks 2 and 3 keep none on (4, 1))
        jcfg, tcfg = (c.replace(moe=dataclasses.replace(
            c.moe, capacity_factor=MOE_CF)) for c in (jcfg, tcfg))
    jlm = JLM(jcfg)
    jp = jlm.init(jax.random.PRNGKey(0))
    return jlm, jp, tcfg


def _batch(rows, vocab=257):
    src = SyntheticTokenSource(DataConfig(rows, W.S, vocab))
    return src.batch_at(0)


def _port_ref(tlm, tp, batch):
    """The unsharded port's logits, loss and train step."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    lg, _ = tlm.logits(tp, tb)
    loss, aux = tlm.loss(tp, tb)
    run = RunConfig(model=tlm.cfg, opt=OptimizerConfig(**W.OPT),
                    microbatches=2)
    p2, o2, m = t_steps.make_train_step(tlm, run)(
        tp, t_opt.init_opt_state(run.opt, tp), tb)
    return {"logits": lg.numpy(), "loss": float(loss),
            "moe": {k: float(v) for k, v in aux.items()
                    if k.startswith("moe_")},
            "step": {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "params": _port_leaves(p2), "m": _port_leaves(o2.m)}}


def _jax_ref(jlm, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lg, _ = jlm.logits(jp, jb)
    loss, _ = jlm.loss(jp, jb)
    run = JRunConfig(model=jlm.cfg, opt=JOptCfg(**W.OPT), microbatches=2)
    p2, o2, m = jax.jit(j_steps.make_train_step(jlm, run))(
        jp, j_opt.init_opt_state(run.opt, jp), jb)
    return {"logits": np.asarray(lg, np.float32), "loss": float(loss),
            "step": {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "params": _jax_leaves(p2), "m": _jax_leaves(o2.m)}}


def _serve_ref(jlm, jp, tlm, tp, inputs):
    """JAX's engine tokens and the unsharded port's decode logits."""
    reqs = [j_engine.Request(rid=i, prompt=np.asarray(p, np.int32),
                             max_new_tokens=W.NEW)
            for i, p in enumerate(inputs["prompts"])]
    stats = j_engine.ServeEngine(jlm, jp, W.SLOTS, W.MAX_SEQ).run(reqs)
    treqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                     max_new_tokens=W.NEW)
             for i, p in enumerate(inputs["prompts"])]
    ServeEngine(tlm, tp, W.SLOTS, W.MAX_SEQ, device="cpu").run(treqs)
    tok = torch.from_numpy(inputs["decode_tokens"])
    dec = {}
    for t0 in W.DECODE_AT:
        cache = (tlm.init_cache(W.SLOTS, W.MAX_SEQ, "cpu") if t0 == 0 else
                 tlm.prefill(tp, {"tokens": tok[:, :t0]}, W.MAX_SEQ)[1])
        for i in range(t0, t0 + 2):
            lg, cache = tlm.decode(tp, tok[:, i:i + 1], cache, i)
            dec[i] = lg.numpy()
    return {"jax tokens": [r.out_tokens for r in reqs],
            "port tokens": [r.out_tokens for r in treqs],
            "steps": stats["steps"], "decode": dec}


def _ckpt_target():
    """The (params, opt_state) of the worker's checkpoint as JAX arrays
    of zeros."""
    cfg = j_smoke("granite-8b")
    jp = JLM(cfg).init(jax.random.PRNGKey(0))
    zeros = jax.tree.map(jnp.zeros_like, jp)
    return (zeros, j_opt.init_opt_state(JOptCfg(**W.OPT), zeros))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_sharded")
    r = np.random.default_rng(5)
    inputs = {"models": {}, "batch": _batch(W.B), "batch8": _batch(W.B_FSDP),
              "prompts": [r.integers(0, 257, n).astype(np.int32)
                          for n in W.LENS],
              "decode_tokens": np.random.default_rng(11).integers(
                  0, 257, (W.SLOTS, W.MAX_SEQ)).astype(np.int64),
              "ckpt_cfg": smoke_config("granite-8b")}
    jax_models = {}
    for name in ("granite", "qwen", "zamba2", "xlstm", "olmoe"):
        jlm, jp, tcfg = _jax_model(name)
        jax_models[name] = (jlm, jp)
        inputs["models"][name] = (tcfg, jax.tree.map(np.asarray, jp))
    inputs["models"]["granite fsdp"] = (
        inputs["models"]["granite"][0].replace(parallelism="fsdp"),
        inputs["models"]["granite"][1])
    bf16 = dict(BF16_KW, dtype="bfloat16")
    jp16 = jax.tree.map(np.asarray, JLM(j_smoke("granite-8b").replace(
        **bf16)).init(jax.random.PRNGKey(0)))
    inputs["models"]["granite bf16"] = (
        smoke_config("granite-8b").replace(**bf16), jp16)
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    proc = W.jax_serve(tmp, [
        {"name": name, "arch": "granite-8b", "kw": bf16, "params": jp16,
         "mesh": shape, "rows": W.SLOTS, "max_seq": W.MAX_SEQ, "extras": {},
         "engine": True} for name, shape in (("tp14", (1, 4)),
                                             ("one", None))], inputs)
    ctx22 = W.spawn(tmp, "world22", 4)
    ctx12 = W.spawn(tmp, "world12", 2)
    ref = {}
    port = {}
    for name, (jlm, jp) in jax_models.items():
        tcfg, np_params = inputs["models"][name]
        port[name] = (LM(tcfg), params_from_numpy(np_params, "lm",
                                                  device="cpu"))
    for key, rows in (("batch", W.B), ("batch8", W.B_FSDP)):
        ref[("granite", key)] = _port_ref(*port["granite"], inputs[key])
        ref[("granite jax", key)] = _jax_ref(*jax_models["granite"],
                                             inputs[key])
    ref[("zamba2", "batch8")] = _port_ref(*port["zamba2"], inputs["batch8"])
    ref[("olmoe", "batch8")] = _port_ref(*port["olmoe"], inputs["batch8"])
    ref[("xlstm", "batch")] = _port_ref(*port["xlstm"], inputs["batch"])
    for name in ("granite", "qwen"):
        ref[("serve", name)] = _serve_ref(*jax_models[name], *port[name],
                                          inputs)
    W.wait(ctx22)
    got = {"world22": W.results(tmp, "world22", 4)}
    # JAX reads the port's checkpoint and writes it back in its own package
    jtree, jmeta = j_ckpt.restore(tmp / "ckpt22", _ckpt_target())
    j_ckpt.save(jtree, tmp / "ckpt_jax", step=int(jmeta["step"]))
    ctx14 = W.spawn(tmp, "world14", 4)
    ctx41 = W.spawn(tmp, "world41", 4)
    # no mesh: the port's restore of the (2, 2) world's file
    p0 = map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                  LM(inputs["ckpt_cfg"]).param_defs())
    target = (p0, t_opt.init_opt_state(OptimizerConfig(**W.OPT), p0))
    (p0, o0), meta0 = t_ckpt.restore(tmp / "ckpt22", target)
    W.wait(ctx12)
    got["world12"] = W.results(tmp, "world12", 2)
    W.wait(ctx14)
    got["world14"] = W.results(tmp, "world14", 4)
    W.wait(ctx41)
    got["world41"] = W.results(tmp, "world41", 4)
    tcfg, npp = inputs["models"]["granite bf16"]
    t16 = LM(tcfg), params_from_numpy(npp, "lm", device="cpu")
    ref["bf16"] = {"port": W.decodes(*t16, inputs, {}, prefill=True),
                   "port tokens": W.engine_tokens(*t16, inputs),
                   **W.jax_serve_results(tmp, proc)}
    yield types.SimpleNamespace(
        ref=ref, got=got, inputs=inputs, jax_ckpt=jtree,
        no_mesh=((W._tree_np(p0), int(o0.step), W._tree_np(o0.m),
                  W._tree_np(o0.v)), int(meta0["step"])))
    shutil.rmtree(tmp, ignore_errors=True)


def _bf16_gap(a, b):
    """max |a - b| over the vocabulary's 257 columns (the padded ones are
    masked), in bf16 spacings at the largest |b| (2^-6 between 2 and
    4)."""
    a, b = a[..., :257], b[..., :257]
    spacing = 2.0 ** (np.floor(np.log2(np.abs(b).max())) - 7)
    return float(np.abs(a - b).max() / spacing)


@pytest.mark.parametrize("what", ["prefill", 0, 1, 2, 8, 9, 10])
def test_dense_tp_bf16_matches_jax_tp(worlds, what):
    """granite-8b's smoke config in bfloat16 on (1, 4) (bf16 partial sums
    of the row-parallel products, all-reduced) against JAX's own (1, 4)
    mesh, its weights placed by ``param_shardings`` so that GSPMD cuts
    the products over "model": the prefill's and each decode's logits
    within ``BF16_TP_SPACINGS`` bf16 spacings at the largest |logit|.
    Measured: at most 3.0 (0.047 at logits up to 3.5); JAX's own (1, 4)
    against its one device 2.0, the unsharded port against unsharded JAX
    2.4: the port's reduction is as far from JAX's as JAX's two runs are
    from each other."""
    got = worlds.got["world14"]["bf16"]["decode"][what]
    assert _bf16_gap(got, worlds.ref["bf16"]["tp14"][what]) <= \
        BF16_TP_SPACINGS


def test_dense_tp_bf16_engine_tokens_equal_jax_tp(worlds):
    """Six requests on 4 slots: the (1, 4) engine's tokens in bfloat16
    equal JAX's engine's on its (1, 4) mesh and on one device."""
    ref = worlds.ref["bf16"]
    assert worlds.got["world14"]["bf16"]["engine"] == ref["tp14"]["tokens"]
    assert ref["tp14"]["tokens"] == ref["one"]["tokens"]
    assert ref["port tokens"] == ref["one"]["tokens"]


def test_layouts(worlds):
    """(2, 2): heads local on 2 model ranks, the 260-row vocabulary cut,
    rows 2 a data rank; (1, 4): kv heads (2) do not divide over 4, so q, k
    and v are gathered; (4, 1): no tensor parallelism, 2 rows a rank;
    (1, 2) with "dp": the batch over both axes."""
    g = worlds.got
    assert g["world22"]["layout"][:3] == (2, True, True)
    assert g["world14"]["layout"][:3] == (4, False, True)
    assert g["world41"]["layout"][0] is None
    assert g["world12"]["layout"][0] == ("data", "model")


def _check_step(got, want, what):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=STEP_TOL,
                               err_msg=what)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=STEP_TOL, err_msg=what)
    gp, gm = _np_leaves(got["params"]), _np_leaves(got["m"])
    assert len(gp) == len(want["params"])
    for i, (a, b, ma, mb) in enumerate(zip(gp, want["params"], gm,
                                           want["m"])):
        np.testing.assert_allclose(ma, mb, rtol=0, atol=STEP_TOL,
                                   err_msg=f"{what} m leaf {i}")
        big = np.abs(mb) > GRAD_FLOOR * max(np.abs(mb).max(), 1e-30)
        np.testing.assert_allclose(a[big], b[big], rtol=0, atol=PARAM_TOL,
                                   err_msg=f"{what} params leaf {i}")


@pytest.mark.parametrize("world", list(MESHES))
def test_logits_loss_and_train_step_match_unsharded_and_jax(worlds, world):
    key = "batch8" if world == "world41" else "batch"
    got = worlds.got[world]
    port, jref = (worlds.ref[("granite", key)],
                  worlds.ref[("granite jax", key)])
    np.testing.assert_allclose(got["fwd"]["logits"], port["logits"], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(got["fwd"]["logits"], jref["logits"], rtol=0,
                               atol=F32_TOL)
    for want in (port, jref):
        np.testing.assert_allclose(got["fwd"]["loss"], want["loss"],
                                   rtol=F32_TOL)
    assert got["fwd"]["ce"] == got["fwd"]["loss"]
    _check_step(got["step"], port["step"], f"{world} vs the port")
    _check_step(got["step"], jref["step"], f"{world} vs JAX")


@pytest.mark.parametrize("world", list(MESHES))
def test_grad_norm_counts_every_leaf_once(worlds, world):
    key = "batch8" if world == "world41" else "batch"
    np.testing.assert_allclose(
        worlds.got[world]["step"]["grad_norm"],
        worlds.ref[("granite", key)]["step"]["grad_norm"], rtol=NORM_RTOL)


@pytest.mark.parametrize("model", ["granite", "qwen"])
@pytest.mark.parametrize("world", ["world22", "world14"])
def test_engine_tokens_equal_jax(worlds, world, model):
    """Six requests on 4 slots (two position groups): the mesh engine's
    tokens and step count equal JAX's engine's (bf16 and int8 caches)."""
    key = "serve" if model == "granite" else "serve qwen"
    got, ref = worlds.got[world][key], worlds.ref[("serve", model)]
    assert ref["port tokens"] == ref["jax tokens"]
    assert got["tokens"] == ref["jax tokens"]
    assert got["steps"] == ref["steps"]


@pytest.mark.parametrize("model", ["granite", "qwen"])
@pytest.mark.parametrize("world", ["world22", "world14"])
def test_decode_over_the_cut_cache_matches_unsharded(worlds, world, model):
    """Decodes at position 0 (every range empty), at 8 and 16 (the slice
    boundaries of 4 and 2 ranks: the owner of the position changes) and
    the position after each; the padded vocabulary rows masked alike.
    The int8 cache (qwen) within ``INT8_RTOL`` of max |logit|."""
    key = "serve" if model == "granite" else "serve qwen"
    got, ref = worlds.got[world][key]["decode"], worlds.ref[("serve",
                                                              model)]["decode"]
    assert set(got) == set(ref) == {0, 1, 8, 9, 16, 17}
    for pos in ref:
        want = ref[pos][..., :257]
        atol = (LOGIT_TOL if model == "granite"
                else INT8_RTOL * float(np.abs(want).max()))
        np.testing.assert_allclose(got[pos][..., :257], want, rtol=0,
                                   atol=atol, err_msg=f"pos {pos}")
        np.testing.assert_array_equal(got[pos][..., 257:], ref[pos][
            ..., 257:])


def test_fsdp_only_family_matches_unsharded(worlds):
    """zamba2-7b (Mamba-2 superblocks, a shared attention block, a tail)
    on (4, 1): every cut gathered per layer, the block math unchanged."""
    got, ref = worlds.got["world41"], worlds.ref[("zamba2", "batch8")]
    np.testing.assert_allclose(got["zamba2 fwd"]["logits"], ref["logits"],
                               rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got["zamba2 fwd"]["loss"], ref["loss"],
                               rtol=F32_TOL)
    _check_step(got["zamba2 step"], ref["step"], "zamba2 (4, 1)")
    np.testing.assert_allclose(got["zamba2 step"]["grad_norm"],
                               ref["step"]["grad_norm"], rtol=NORM_RTOL)


def test_moe_on_a_data_axis_matches_unsharded(worlds):
    """olmoe-1b-7b on (4, 1) with a capacity below its pairs: the router's
    load-balance loss and the drops are the global batch's (the
    per-expert sums over "data"), the capacity is the global batch's in
    its pair order, and the microbatches are JAX's blocks of contiguous
    rows, so the logits, the loss, its MoE terms and one train step equal
    the unsharded port's."""
    got, ref = worlds.got["world41"], worlds.ref[("olmoe", "batch8")]
    assert ref["moe"]["moe_drop_frac"] > 0
    np.testing.assert_allclose(got["olmoe fwd"]["logits"], ref["logits"],
                               rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got["olmoe fwd"]["loss"], ref["loss"],
                               rtol=F32_TOL)
    for k, v in ref["moe"].items():
        np.testing.assert_allclose(got["olmoe fwd"]["moe"][k], v,
                                   rtol=F32_TOL, err_msg=k)
    _check_step(got["olmoe step"], ref["step"], "olmoe (4, 1)")
    np.testing.assert_allclose(got["olmoe step"]["grad_norm"],
                               ref["step"]["grad_norm"], rtol=NORM_RTOL)


def test_fsdp_policy_matches_unsharded_and_jax(worlds):
    """granite-8b under ``parallelism="fsdp"`` on (2, 2): no tensor
    parallelism, the batch over (data, model), the embedding's vocab cut
    over "model" and every cut gathered per layer."""
    got = worlds.got["world22"]
    assert got["fsdp layout"] == (None, ("data", "model"))
    for ref in (worlds.ref[("granite", "batch8")],
                worlds.ref[("granite jax", "batch8")]):
        np.testing.assert_allclose(got["fsdp fwd"]["logits"], ref["logits"],
                                   rtol=0, atol=LOGIT_TOL)
        np.testing.assert_allclose(got["fsdp fwd"]["loss"], ref["loss"],
                                   rtol=F32_TOL)
        _check_step(got["fsdp step"], ref["step"], "granite fsdp (2, 2)")
    np.testing.assert_allclose(
        got["fsdp step"]["grad_norm"],
        worlds.ref[("granite", "batch8")]["step"]["grad_norm"],
        rtol=NORM_RTOL)


def test_dp_policy_matches_unsharded(worlds):
    """xlstm-125m (``parallelism="dp"``): every weight replicated, the
    batch over (data, model), every gradient summed over both."""
    got, ref = worlds.got["world12"], worlds.ref[("xlstm", "batch")]
    np.testing.assert_allclose(got["fwd"]["logits"], ref["logits"], rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(got["fwd"]["loss"], ref["loss"], rtol=F32_TOL)
    _check_step(got["step"], ref["step"], "xlstm dp")
    np.testing.assert_allclose(got["step"]["grad_norm"],
                               ref["step"]["grad_norm"], rtol=NORM_RTOL)


@pytest.mark.parametrize("world", ["world41", "world12"])
def test_loader_rows_make_the_unsharded_batch(worlds, world):
    """Each rank's ``PrefetchLoader`` rows, gathered in rank order, are
    the whole batch of the unsharded loader's source."""
    src = SyntheticTokenSource(DataConfig(W.B_FSDP, 9, 100, seed=2))
    for step, got in enumerate(worlds.got[world]["loader"]):
        for k, v in src.batch_at(step).items():
            np.testing.assert_array_equal(got[k], v)


def _same_tree(a, b, what):
    W._same(a, b, what)


@pytest.mark.parametrize("where", ["world14", "world41", "no mesh"])
def test_checkpoint_restores_onto_any_mesh(worlds, where):
    """The (2, 2) world's bfloat16 parameters and AdamW state, saved as
    whole arrays, restore bit for bit onto (1, 4), (4, 1) and no mesh."""
    saved = worlds.got["world22"]["ckpt"]
    got = (worlds.no_mesh if where == "no mesh"
           else worlds.got[where]["restored"])
    assert got[1] == 1
    _same_tree(got[0], saved, where)


def test_checkpoint_round_trips_with_jax(worlds):
    """JAX's restore reads the port's file (every array equal), and the
    (1, 4) world reads the copy JAX wrote bit for bit."""
    saved = worlds.got["world22"]["ckpt"]
    jp, jo = worlds.jax_ckpt
    for a, b in zip(_jax_leaves(jp), _np_leaves(saved[0])):
        np.testing.assert_array_equal(a, b)
    assert int(jo.step) == saved[1]
    for a, b in zip(_jax_leaves(jo.m), _np_leaves(saved[2])):
        np.testing.assert_array_equal(a, b)
    got, step = worlds.got["world14"]["restored jax"]
    _same_tree(got, saved, "JAX's copy on (1, 4)")
