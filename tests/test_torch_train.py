"""The port's LM training path against the JAX package's, on the CPU: the
cross-entropy functions, ``LM.logits``/``loss`` on carried-across weights
(granite-8b's and qwen1.5-4b's smoke configs, the latter's int8 cache
held to JAX's too), the train step with one and
two microbatches, the remat policies, AdamW on nested trees, the token
pipeline and the launcher (a resume of its own checkpoint and of one the
JAX launcher wrote).  Every JAX side runs live."""
import collections
import json
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

torch.set_num_threads(1)

from repro.common.config import OptimizerConfig as JOptCfg  # noqa: E402
from repro.common.config import RunConfig as JRunConfig  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.data import pipeline as j_pipe  # noqa: E402
from repro.launch import train as j_launch  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch.common.config import OptimizerConfig  # noqa: E402
from repro_torch.common.config import RunConfig  # noqa: E402
from repro_torch.common.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data import pipeline as t_pipe  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import steps as t_steps  # noqa: E402

CE_TOL = 1e-6           # cross-entropy, float32
F32_TOL = 1e-5          # logits / loss of the float32 smoke model
BF16_RTOL = 2e-2        # the same in bfloat16, relative to max |logit|
STEP_TOL = 1e-5         # train steps: loss, grad_norm (relative), moments
# the parameters after two steps: an element whose first moment nearly
# cancels (|m| ~ 1e-4 of its leaf's gradient scale) turns the gradients'
# ~1e-6 relative difference into ~1% of a step of lr = 1e-3: 1.04e-5
# measured in one element of 16,384 (mlp.up), <= 5.4e-6 elsewhere
PARAM_TOL = 2e-5
B, S = 4, 16
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
SMOKE_ARGS = ["--arch", "granite-8b", "--smoke", "--batch", "2", "--seq",
              "16"]


def _batch(cfg, step=0):
    src = j_pipe.SyntheticTokenSource(j_pipe.DataConfig(B, S,
                                                        cfg.vocab_size))
    return src.batch_at(step)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _models(arch="granite-8b", **kw):
    """(JAX LM, JAX params, port LM, port params) on the same weights."""
    jlm = JLM(j_smoke(arch).replace(**kw))
    jp = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(smoke_config(arch).replace(**kw))
    return jlm, jp, tlm, params_from_numpy(jax.tree.map(np.asarray, jp), "lm",
                                         device="cpu")


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _t_leaves(tree):
    return [x.float().numpy() for x in t_opt.tree_leaves(tree)]


# -- cross-entropy ---------------------------------------------------------------

@pytest.mark.parametrize("vocab", [260, 257])
def test_cross_entropy_matches_jax(vocab):
    """Padded vocab (260 rows, 257 real) and an unpadded one."""
    r = np.random.default_rng(1)
    logits = r.normal(0, 3, (2, 7, 260)).astype(np.float32)
    labels = r.integers(0, 257, (2, 7)).astype(np.int32)
    want = j_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  vocab)
    got = t_layers.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels), vocab)
    np.testing.assert_allclose(float(got), float(want), rtol=CE_TOL)


@pytest.mark.parametrize("tied", [False, True])
def test_chunked_cross_entropy_matches_jax(tied):
    """S = 7 in chunks of 3 (the last one short), padded vocab; the
    chunked gradients equal the unchunked ones."""
    r = np.random.default_rng(2)
    x = r.normal(0, 1, (2, 7, 16)).astype(np.float32)
    labels = r.integers(0, 257, (2, 7)).astype(np.int32)
    emb = {"tok": r.normal(0, 0.5, (260, 16)).astype(np.float32)}
    if not tied:
        emb["unembed"] = r.normal(0, 0.5, (16, 260)).astype(np.float32)
    want = j_layers.chunked_cross_entropy(
        {k: jnp.asarray(v) for k, v in emb.items()}, jnp.asarray(x),
        jnp.asarray(labels), 257, 3)
    temb = {k: torch.from_numpy(v).requires_grad_() for k, v in emb.items()}
    tx = torch.from_numpy(x).requires_grad_()
    got = t_layers.chunked_cross_entropy(temb, tx, torch.from_numpy(labels),
                                         257, 3)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=CE_TOL)
    whole = t_layers.cross_entropy(t_layers.unembed(temb, tx),
                                   torch.from_numpy(labels), 257)
    np.testing.assert_allclose(float(got.detach()), float(whole.detach()),
                               rtol=CE_TOL)
    leaves = [tx, temb["tok" if tied else "unembed"]]
    for a, b in zip(torch.autograd.grad(got, leaves),
                    torch.autograd.grad(whole, leaves)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=CE_TOL)


# -- forward, logits, loss ----------------------------------------------------------

@pytest.mark.parametrize("dtype,chunk", [("float32", 0), ("float32", 5),
                                         ("bfloat16", 0)])
def test_logits_and_loss_match_jax(dtype, chunk):
    jlm, jp, tlm, tp = _models(dtype=dtype, loss_chunk=chunk)
    batch = _batch(jlm.cfg)
    jl, _ = jlm.logits(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jloss, jaux = jlm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = tlm.logits(tp, _tb(batch))
    tloss, taux = tlm.loss(tp, _tb(batch))
    jl = np.asarray(jl, np.float32)
    tl = tl.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(tl, jl, rtol=0, atol=F32_TOL)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=F32_TOL)
    else:
        scale = float(np.abs(jl).max())
        assert float(np.abs(tl - jl).max()) / scale < BF16_RTOL
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=BF16_RTOL)
    assert float(taux["ce"]) == float(tloss)
    assert set(taux) == set(jaux) == {"ce"}


def test_qwen_int8_config_trains_and_its_decode_raises():
    """qwen1.5-4b (QKV bias, int8 KV cache): the loss equals JAX's, and so
    do its int8 prefill (logits, the int8 values exactly, the bfloat16
    scales) and three decode steps (logits and the whole cache).  The
    name dates from when the int8 cache raised; it no longer does."""
    jlm, jp, tlm, tp = _models("qwen1.5-4b", dtype="float32")
    assert tlm.cfg.kv_cache_dtype == "int8" and tlm.cfg.qkv_bias
    batch = _batch(jlm.cfg)
    jloss, _ = jlm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, _ = tlm.loss(tp, _tb(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=F32_TOL)
    tok, t0 = _tb(batch)["tokens"], 10

    def check(jl, jc, tl, tc):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        assert set(tc["blocks"]) == set(jc["blocks"]) == {
            "k", "v", "k_scale", "v_scale"}
        for k, want in jc["blocks"].items():
            got = tc["blocks"][k]
            assert got.dtype == (torch.int8 if k in ("k", "v")
                                 else torch.bfloat16)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))

    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tok[:, :t0])}, S)
    tl, tc = tlm.prefill(tp, {"tokens": tok[:, :t0]}, S)
    check(jl, jc, tl, tc)
    for i in range(t0, t0 + 3):
        jl, jc = jlm.decode(jp, jnp.asarray(tok[:, i:i + 1]), jc,
                            jnp.int32(i))
        tl, tc = tlm.decode(tp, tok[:, i:i + 1], tc, i)
        check(jl, jc, tl, tc)


# -- the train step -------------------------------------------------------------------

@pytest.mark.parametrize("nmb", [1, 2])
def test_train_step_matches_jax(nmb):
    """Two steps of JAX's jitted step and the port's from the same float32
    weights and batches: loss and grad_norm, then the parameters and both
    moments."""
    jlm, jp, tlm, tp = _models(dtype="float32")
    jrun = JRunConfig(model=jlm.cfg, opt=JOptCfg(**OPT), microbatches=nmb)
    trun = RunConfig(model=tlm.cfg, opt=OptimizerConfig(**OPT),
                     microbatches=nmb)
    jstep = jax.jit(j_steps.make_train_step(jlm, jrun))
    tstep = t_steps.make_train_step(tlm, trun)
    jo, to = j_opt.init_opt_state(jrun.opt, jp), t_opt.init_opt_state(
        trun.opt, tp)
    for step in range(2):
        batch = _batch(jlm.cfg, step)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, _tb(batch))
        for k in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    assert int(to.step) == int(jo.step) == 2
    for jt, tt, tol in ((jp, tp, PARAM_TOL), (jo.m, to.m, STEP_TOL),
                        (jo.v, to.v, STEP_TOL)):
        for a, b in zip(_leaves(jt), _t_leaves(tt)):
            np.testing.assert_allclose(b, a, rtol=0, atol=tol)


def test_microbatched_grad_accum_matches_single():
    """``tests/test_archs.py``'s microbatch test on the port: the same data
    gives the same mean loss and grad norm at 1, 2 and 4 microbatches."""
    cfg = smoke_config("granite-8b").replace(dtype="float32")
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    batch = _tb(_batch(cfg))
    outs = {}
    for nmb in (1, 2, 4):
        run = RunConfig(model=cfg, opt=OptimizerConfig(**OPT),
                        microbatches=nmb)
        step = t_steps.make_train_step(lm, run)
        _, _, m = step(params, t_opt.init_opt_state(run.opt, params), batch)
        outs[nmb] = (float(m["loss"]), float(m["grad_norm"]))
    assert outs[1][0] == pytest.approx(outs[2][0], rel=1e-5)
    assert outs[1][1] == pytest.approx(outs[4][1], rel=1e-3)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def test_remat_policies_give_the_same_loss_and_gradients():
    """none / minimal / dots recompute the same arithmetic: loss and every
    gradient equal bitwise on the CPU.  minimal recomputes the layers'
    matrix products in backward, dots keeps them (as many ``mm`` calls as
    none) and recomputes the rest."""
    batch = _tb(_batch(smoke_config("granite-8b")))
    cfg = smoke_config("granite-8b").replace(dtype="float32")
    params = LM(cfg).init(torch.Generator().manual_seed(1))
    outs, mms = {}, {}
    for policy in ("none", "minimal", "dots"):
        lm = LM(cfg.replace(remat_policy=policy))
        with _CountOps() as ops:
            (loss, _), grads = t_steps.value_and_grad(lm.loss, params, batch)
        outs[policy] = (loss, t_opt.tree_leaves(grads))
        mms[policy] = ops.counts[torch.ops.aten.mm.default]
    for policy in ("minimal", "dots"):
        assert torch.equal(outs[policy][0], outs["none"][0])
        for a, b in zip(outs[policy][1], outs["none"][1]):
            assert torch.equal(a, b)
    assert mms["dots"] == mms["none"] < mms["minimal"]


def test_adamw_nested_slabs_and_inplace_match_the_whole_leaf(monkeypatch):
    """A nested tree with a stacked leaf: the update one slab at a time and
    in place equals the update of whole leaves bitwise."""
    r = np.random.default_rng(5)
    f32 = lambda *s: torch.from_numpy(r.normal(0, 1, s).astype(np.float32))
    params = {"blocks": {"w": f32(3, 8, 6), "s": f32(3, 6)},
              "embed": {"tok": f32(20, 6)}, "b": f32(6)}
    grads = t_opt.tree_map(lambda p: torch.randn_like(p) * 0.3, params)
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    state = t_opt.init_opt_state(cfg, params)
    state = t_opt.OptState(state.step + 4, t_opt.tree_map(
        lambda p: torch.randn_like(p) * 0.1, params), t_opt.tree_map(
        lambda p: torch.rand_like(p) * 0.1, params))
    whole = t_opt.adamw_update(cfg, params, grads, state)
    monkeypatch.setattr(t_opt, "SLAB", 10)
    copy = lambda t: t_opt.tree_map(torch.clone, t)
    p2, s2 = copy(params), t_opt.OptState(state.step, copy(state.m),
                                          copy(state.v))
    slabs = t_opt.adamw_update(cfg, p2, grads, s2, inplace=True)
    assert slabs[0] is p2 and slabs[1].m is s2.m
    for a, b in ((whole[0], p2), (whole[1].m, s2.m), (whole[1].v, s2.v)):
        for x, y in zip(t_opt.tree_leaves(a), t_opt.tree_leaves(b)):
            assert torch.equal(x, y)
    assert torch.equal(whole[2]["grad_norm"], slabs[2]["grad_norm"])


# -- the token pipeline ---------------------------------------------------------------

@pytest.mark.parametrize("hosts", [1, 2])
def test_token_source_matches_jax(hosts):
    cfg = dict(global_batch=4, seq_len=33, vocab_size=257, seed=3)
    for h in range(hosts):
        js = j_pipe.SyntheticTokenSource(j_pipe.DataConfig(**cfg), h, hosts)
        ts = t_pipe.SyntheticTokenSource(t_pipe.DataConfig(**cfg), h, hosts)
        for step in (0, 1, 7):
            want, got = js.batch_at(step), ts.batch_at(step)
            assert set(got) == set(want) == {"tokens", "labels"}
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_loader_yields_steps_in_order_and_closes():
    src = t_pipe.SyntheticTokenSource(t_pipe.DataConfig(2, 9, 100))
    loader = t_pipe.PrefetchLoader(src, device="cpu")
    it = iter(loader)
    for step in range(5):
        got = next(it)
        for k, v in src.batch_at(step).items():
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), v)
    loader.close()
    assert not loader._thread.is_alive()


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = t_pipe.SyntheticTokenSource(t_pipe.DataConfig(2, 9, 100))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pipe.PrefetchLoader(src)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(SMOKE_ARGS + ["--steps", "1"])


# -- the launcher ---------------------------------------------------------------------

def test_launcher_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    args = SMOKE_ARGS + ["--device", "cpu", "--ckpt-dir", str(tmp_path)]
    t_launch.main(args + ["--steps", "3"])
    first = capsys.readouterr().out
    assert [ln.split()[1] for ln in first.splitlines()
            if ln.startswith("step")] == ["0", "1", "2"]
    t_launch.main(args + ["--steps", "5", "--resume"])
    second = capsys.readouterr().out.splitlines()
    assert second[0] == (f"resumed from {tmp_path / 'step_00000003'} at "
                         "step 3")
    assert [ln.split()[1] for ln in second[1:]] == ["3", "4"]
    assert all(np.isfinite(float(ln.split()[2][len("loss="):]))
               for ln in second[1:])
    assert (tmp_path / "step_00000005" / "COMMITTED").exists()


def _manifest(path):
    leaves = json.loads((path / "manifest.json").read_text())["leaves"]
    return {k: (e["shape"], e["dtype"], e["crc32"], e["raw_nbytes"])
            for k, e in leaves.items()}


def test_launcher_resumes_a_jax_checkpoint(tmp_path, monkeypatch, capsys):
    """JAX's launcher trains 2 smoke steps (bf16 weights, float32 moments)
    and saves; the port's resumes at step 2 and writes the same state back:
    every leaf's dtype, shape and crc32 equal."""
    monkeypatch.setattr(sys, "argv", ["train"] + SMOKE_ARGS + [
        "--steps", "2", "--ckpt-dir", str(tmp_path)])
    j_launch.main()
    ckpt = tmp_path / "step_00000002"
    want = _manifest(ckpt)
    assert want["[0]['embed']['tok']"][1] == "bfloat16"
    assert want["[1].m['embed']['tok']"][1] == "float32"
    capsys.readouterr()
    t_launch.main(SMOKE_ARGS + ["--device", "cpu", "--steps", "2",
                                "--resume", "--ckpt-dir", str(tmp_path)])
    assert capsys.readouterr().out.splitlines() == [
        f"resumed from {ckpt} at step 2"]
    assert _manifest(ckpt) == want


@pytest.mark.parametrize("remat", ["none", "minimal", "dots"])
def test_train_step_leaves_no_tensor_to_the_cyclic_collector(remat):
    """Every tensor a step makes is freed by reference counting: one held
    in a reference cycle lives until the cyclic collector runs, which on
    the card is a step's gradients (4 GB at granite-8b's width) per step."""
    import gc
    cfg = smoke_config("granite-8b").replace(remat_policy=remat)
    run = RunConfig(model=cfg, opt=OptimizerConfig(**OPT), microbatches=2)
    lm = LM(cfg)
    params, opt = t_steps.init_train_state(lm, run,
                                           torch.Generator().manual_seed(0))
    step = t_steps.make_train_step(lm, run, donate=True)
    batch = _tb(_batch(cfg))
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        params, opt, _ = step(params, opt, batch)
        gc.collect()
        cyclic = [o for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert not cyclic
