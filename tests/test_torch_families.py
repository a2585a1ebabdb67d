"""The port's LM families (moe, ssm/xLSTM, hybrid/Mamba-2, vlm, audio)
and the int8 KV cache against the JAX package's, on the same weights:
JAX-initialised parameters carried across with the ``lm`` convert, their
zero- and one-initialised leaves (the vlm gate, ``A_log``, ``dt_bias``,
``D``, ``gate_bias``, the sLSTM ``bias``, QKV biases, norm scales)
replaced by seeded values in both trees first, so that no branch hides
behind a factor of 0 or 1.  Every JAX side runs live.

Tolerances: float32 variants 1e-4 on logits and 1e-5 on the loss, cache
leaves and parameters (``tests/test_torch_lm.py``'s; a leaf's error is
taken relative to max(1, max |leaf|)); int8 cache values exactly; the
bfloat16 ``smoke_config`` within 5e-2 of max |logit|
(``tests/test_archs.py``'s rule for JAX's own bf16 paths)."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from repro.common.config import OptimizerConfig as JOptCfg  # noqa: E402
from repro.common.config import RunConfig as JRunConfig  # noqa: E402
from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.common.config import OptimizerConfig  # noqa: E402
from repro_torch.common.config import RunConfig  # noqa: E402
from repro_torch.common.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.flash_decode import ops as t_fd  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import steps as t_steps  # noqa: E402

FAMILIES = ["olmoe-1b-7b", "kimi-k2-1t-a32b", "xlstm-125m", "zamba2-7b",
            "llama-3.2-vision-90b", "seamless-m4t-large-v2"]
INT8 = [("qwen1.5-4b", {}), ("granite-8b", {"kv_cache_dtype": "int8"})]
CASES = [(a, {}) for a in FAMILIES] + INT8
IDS = [a + ("-int8" if kw else "") for a, kw in CASES]
ENGINE = [c for c in CASES if c[0] != "seamless-m4t-large-v2"]
RECURRENT = ["xlstm-125m", "zamba2-7b"]
B, S, T0 = 2, 16, 10          # batch, cache length, prompt length
LOGIT_TOL, TOL, BF16_RTOL = 1e-4, 1e-5, 5e-2
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
# leaves that JAX initialises to constants, and the mean of their seeded
# replacement (the std is 0.3)
PERTURB = {"gate": 0.5, "A_log": 0.0, "dt_bias": 0.0, "D": 1.0,
           "gate_bias": 0.0, "bias": 0.0, "b": 0.0, "scale": 1.0}


def _perturbed(jp):
    """Numpy copy of a JAX tree with the constant leaves replaced."""
    r = np.random.default_rng(11)

    def leaf(path, x):
        a = np.asarray(x)
        name = path[-1].key
        if name in PERTURB:
            a = (PERTURB[name] + r.normal(0, 0.3, a.shape)).astype(a.dtype)
        return a
    return jax.tree_util.tree_map_with_path(leaf, jp)


@functools.lru_cache(maxsize=None)
def _models(arch, dtype, kw_items=()):
    """(JAX LM, JAX params, port LM, port params) on the same weights."""
    kw = dict(kw_items, dtype=dtype)
    jlm = JLM(j_smoke(arch).replace(**kw))
    jp = _perturbed(jlm.init(jax.random.PRNGKey(0)))
    tlm = LM(smoke_config(arch).replace(**kw))
    return jlm, jax.tree.map(jnp.asarray, jp), tlm, params_from_numpy(
        jp, "lm", device="cpu")


def _get(arch, kw, dtype="float32"):
    return _models(arch, dtype, tuple(sorted(kw.items())))


def _batch(cfg, S_tok=S, S_enc=None, seed=1):
    """Tokens and labels, plus the vlm's image / audio's encoder
    embeddings (standard normals), as numpy."""
    r = np.random.default_rng(seed)
    tok = r.integers(0, cfg.vocab_size, (B, S_tok)).astype(np.int32)
    out = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    dt = np.float32
    if cfg.family == "vlm":
        out["img_embeds"] = r.normal(
            0, 1, (B, cfg.vlm.num_image_tokens, cfg.d_model)).astype(dt)
    if cfg.family == "audio":
        out["enc_embeds"] = r.normal(
            0, 1, (B, S_enc or S_tok, cfg.d_model)).astype(dt)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict (JAX arrays or tensors)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_trees_close(jt, tt, tol, what):
    """Same paths and shapes; float leaves within tol x max(1, max |leaf|),
    int8 leaves equal."""
    jf, tf = _flat(jt), _flat(tt)
    assert set(jf) == set(tf), (what, set(jf) ^ set(tf))
    for path, jl in jf.items():
        tl = tf[path]
        assert tuple(tl.shape) == tuple(jl.shape), (what, path)
        if tl.dtype == torch.int8:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl),
                                          err_msg=f"{what} {path}")
            continue
        w, g = _np(jl), _np(tl)
        scale = max(1.0, float(np.abs(w).max()) if w.size else 1.0)
        err = float(np.abs(w - g).max()) if w.size else 0.0
        assert err <= tol * scale, (what, path, err, scale)


def _close_logits(jl, tl, V, dtype):
    w, g = _np(jl)[..., :V], _np(tl)[..., :V]
    err = float(np.abs(w - g).max())
    if dtype == "float32":
        assert err <= LOGIT_TOL, err
    else:
        assert err / float(np.abs(w).max()) < BF16_RTOL, err


# -- (a) the parameter tree ---------------------------------------------------------

@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_param_tree_matches_jax(arch, kw):
    """The port's declarations give JAX's tree: names, shapes, dtypes
    (bfloat16 weights, float32 routers, gates, norms and SSM vectors)."""
    jlm, jp, tlm, tp = _get(arch, kw, "bfloat16")
    mine = _flat(tlm.init(torch.Generator().manual_seed(0)))
    conv = _flat(tp)
    want = _flat(jp)
    assert set(mine) == set(want) == set(conv)
    for path, leaf in want.items():
        assert tuple(mine[path].shape) == tuple(leaf.shape), path
        jdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            str(leaf.dtype)]
        assert mine[path].dtype == conv[path].dtype == jdt, path


# -- (b) logits and loss ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_logits_and_loss_match_jax(arch, kw, dtype):
    """``LM.logits`` and ``LM.loss`` (with the MoE aux loss and drop
    fraction) on the same batch."""
    jlm, jp, tlm, tp = _get(arch, kw, dtype)
    batch = _batch(tlm.cfg)
    jl, _ = jlm.logits(jp, _jb(batch))
    jloss, jaux = jlm.loss(jp, _jb(batch))
    tl, _ = tlm.logits(tp, _tb(batch))
    tloss, taux = tlm.loss(tp, _tb(batch))
    _close_logits(jl, tl, tlm.cfg.vocab_size, dtype)
    assert set(taux) == set(jaux)
    rtol = TOL if dtype == "float32" else BF16_RTOL
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)
    if tlm.cfg.family == "moe":
        assert float(taux["moe_drop_frac"]) == 0.0
        assert float(tloss) != float(taux["ce"])


# -- (c) prefill, (d) decode through both routes --------------------------------------

def _prefill_batch(cfg):
    b = _batch(cfg, S_enc=T0)
    b["tokens"] = b["tokens"][:, :T0]
    del b["labels"]
    return b


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_prefill_matches_jax(arch, kw):
    """Last-position logits and every cache leaf (attention k/v and int8
    scales, recurrent states, conv tails, cross caches)."""
    jlm, jp, tlm, tp = _get(arch, kw)
    pb = _prefill_batch(tlm.cfg)
    jl, jc = jlm.prefill(jp, _jb(pb), S)
    tl, tc = tlm.prefill(tp, _tb(pb), S)
    assert tl.shape == (B, 1, tlm.cfg.padded_vocab)
    _close_logits(jl, tl, tlm.cfg.vocab_size, "float32")
    _assert_trees_close(jc, tc, TOL, "prefill cache")


@functools.lru_cache(maxsize=None)
def _jax_decode_run(arch, kw_items):
    """JAX's prefill and four decode steps: [(logits, cache)] per step."""
    jlm, jp, tlm, _ = _models(arch, "float32", kw_items)
    tok = _batch(tlm.cfg)["tokens"]
    _, jc = jlm.prefill(jp, _jb(_prefill_batch(tlm.cfg)), S)
    jdec = jax.jit(jlm.decode)
    out = []
    for i in range(T0, T0 + 4):
        jl, jc = jdec(jp, jnp.asarray(tok[:, i:i + 1]), jc, jnp.int32(i))
        out.append((jl, jc))
    return out


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_decode_matches_jax(arch, kw, use_kernel):
    """Four decode steps after a prefill: logits and every cache leaf
    against JAX's ``LM.decode``, through the port's plain route and its
    kernel route (the plain B4 on the CPU, self- and cross-attention)."""
    _, _, tlm, tp = _get(arch, kw)
    want = _jax_decode_run(arch, tuple(sorted(kw.items())))
    tok = _batch(tlm.cfg)["tokens"]
    _, tc = tlm.prefill(tp, _tb(_prefill_batch(tlm.cfg)), S)
    t_fd.LAUNCHES = 0
    for i, (jl, jc) in zip(range(T0, T0 + 4), want):
        tl, tc = tlm.decode(tp, torch.from_numpy(
            tok[:, i:i + 1].astype(np.int64)), tc, i, use_kernel=use_kernel)
        _close_logits(jl, tl, tlm.cfg.vocab_size, "float32")
        _assert_trees_close(jc, tc, TOL, f"decode cache at {i}")
    assert t_fd.LAUNCHES == 0           # CPU tensors: the plain B4


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_bf16_prefill_and_decode_match_jax(arch, kw):
    """The bfloat16 ``smoke_config``: prefill and four decode steps
    within 5e-2 of max |logit| of JAX's."""
    jlm, jp, tlm, tp = _get(arch, kw, "bfloat16")
    tok = _batch(tlm.cfg, seed=2)["tokens"]
    pb = _prefill_batch(tlm.cfg)
    pb["tokens"] = tok[:, :T0]
    jl, jc = jlm.prefill(jp, _jb(pb), S)
    tl, tc = tlm.prefill(tp, _tb(pb), S)
    pairs = [(jl, tl)]
    jdec = jax.jit(jlm.decode)
    for i in range(T0, T0 + 4):
        jl, jc = jdec(jp, jnp.asarray(tok[:, i:i + 1]), jc, jnp.int32(i))
        tl, tc = tlm.decode(tp, torch.from_numpy(
            tok[:, i:i + 1].astype(np.int64)), tc, i)
        pairs.append((jl, tl))
    V = tlm.cfg.vocab_size
    scale = max(float(np.abs(_np(w)[..., :V]).max()) for w, _ in pairs)
    errs = [float(np.abs(_np(w)[..., :V] - _np(g)[..., :V]).max())
            for w, g in pairs]
    assert max(errs) / scale < BF16_RTOL, errs


# -- (e) one train step ------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_train_step_matches_jax(arch, kw):
    """One train step from the same float32 weights and batch, the JAX
    side as ``make_train_step`` runs it with one microbatch (the jitted
    loss gradients, then ``adamw_update`` on them): the loss, its aux and
    the grad norm to 1e-5; every gradient leaf to 1e-5 of its max |g|;
    every updated
    parameter to 1e-5 where its gradient is resolved (above 1e-5 of the
    leaf's max |g|).  Below that, Adam's first step lr * g / (|g| + eps)
    turns the gradients' rounding (~1e-7 absolute) into a sizeable part
    of an update (measured: 1 to 3 elements a model, up to 3.8e-5), so
    there every parameter is held to Adam's bound, 2 lr."""
    jlm, jp, tlm, tp = _get(arch, kw)
    jrun = JRunConfig(model=jlm.cfg, opt=JOptCfg(**OPT))
    trun = RunConfig(model=tlm.cfg, opt=OptimizerConfig(**OPT))
    batch = _batch(tlm.cfg, seed=3)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        jp, _jb(batch))
    _, tg = t_steps.value_and_grad(tlm.loss, tp, _tb(batch))
    jp2, _, stats = jax.jit(j_opt.adamw_update, static_argnums=0)(
        jrun.opt, jp, jg, j_opt.init_opt_state(jrun.opt, jp))
    jm = {"loss": jloss, **stats, **jaux}
    tp_copy = t_opt.tree_map(torch.clone, tp)
    tp2, _, tm = t_steps.make_train_step(tlm, trun)(
        tp_copy, t_opt.init_opt_state(trun.opt, tp_copy), _tb(batch))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL,
                                   atol=1e-7, err_msg=k)
    jg, tg, jp2, tp2, jp1 = (_flat(t) for t in (jg, tg, jp2, tp2, jp))
    for path, g in jg.items():
        g = _np(g)
        g_max = float(np.abs(g).max())
        assert float(np.abs(_np(tg[path]) - g).max()) <= TOL * g_max, path
        want, got = _np(jp2[path]), _np(tp2[path])
        err = np.abs(got - want)
        scale = max(1.0, float(np.abs(want).max()))
        resolved = np.abs(g) > TOL * g_max
        assert float(err[resolved].max(initial=0)) <= TOL * scale, path
        assert float(err.max()) <= 2 * OPT["lr"], path
        assert not np.array_equal(want, _np(jp1[path])) or g_max == 0, path


# -- (f) the engine, (g) audio at the LM level, (h) grouped decode -----------------

def _requests(cls, vocab, lens, max_new=5):
    r = np.random.default_rng(5)
    return [cls(rid=i, prompt=r.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch,kw", ENGINE,
                         ids=[i for i, c in zip(IDS, CASES) if c in ENGINE])
def test_engine_matches_jax(arch, kw):
    """Five requests on 4 slots with prompts of 6 and 9 tokens (two
    position groups, so the masked / grouped decode runs): every
    request's tokens and the step count equal JAX's ``ServeEngine``."""
    jlm, jp, tlm, tp = _get(arch, kw)
    lens = (6, 9, 6, 9, 6)
    jreqs = _requests(j_engine.Request, jlm.cfg.vocab_size, lens)
    jstats = j_engine.ServeEngine(jlm, jp, batch_slots=4,
                                  max_seq=32).run(jreqs)
    treqs = _requests(Request, tlm.cfg.vocab_size, lens)
    tstats = ServeEngine(tlm, tp, batch_slots=4, max_seq=32,
                         device="cpu").run(treqs)
    assert tstats["steps"] == jstats["steps"]
    assert tstats["tokens"] == jstats["tokens"]
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.out_tokens == jr.out_tokens, tr.rid


def test_engine_refuses_the_audio_family():
    _, _, tlm, tp = _get("seamless-m4t-large-v2", {})
    with pytest.raises(ValueError, match="cross cache"):
        ServeEngine(tlm, tp, batch_slots=2, max_seq=32, device="cpu")


def test_audio_prefill_decode_loop_matches_jax():
    """The audio family at the LM level, as a server would drive it: one
    request's prompt (and its encoder embeddings) prefilled, then greedy
    decode steps fed back, the tokens and every logit against JAX's."""
    jlm, jp, tlm, tp = _get("seamless-m4t-large-v2", {})
    pb = _prefill_batch(tlm.cfg)
    jl, jc = jlm.prefill(jp, _jb(pb), S)
    tl, tc = tlm.prefill(tp, _tb(pb), S)
    jdec = jax.jit(jlm.decode)
    V = tlm.cfg.vocab_size
    for i in range(T0, S - 1):
        _close_logits(jl, tl, V, "float32")
        jt = np.asarray(jnp.argmax(jl[:, 0, :V], axis=-1))
        tt = torch.argmax(tl[:, 0, :V], dim=-1)
        np.testing.assert_array_equal(tt.numpy(), jt)
        jl, jc = jdec(jp, jnp.asarray(jt[:, None].astype(np.int32)), jc,
                      jnp.int32(i))
        tl, tc = tlm.decode(tp, tt[:, None], tc, i)
    _close_logits(jl, tl, V, "float32")


@pytest.mark.parametrize("arch", RECURRENT)
def test_grouped_decode_leaves_other_rows_unchanged(arch):
    """A decode for row 1 only changes row 1 of every cache leaf: the
    recurrent states (no position axis) of row 0 stay bitwise as they
    were, and row 1's equal a full-batch decode's; ``rows=[]`` writes
    nothing."""
    _, _, tlm, tp = _get(arch, {})
    tok = torch.from_numpy(_batch(tlm.cfg)["tokens"].astype(np.int64))
    _, tc = tlm.prefill(tp, {"tokens": tok[:, :T0]}, S)
    before = {p: t.clone() for p, t in _flat(tc).items()}
    lg_all, full = tlm.decode(tp, tok[:, T0:T0 + 1],
                              t_opt.tree_map(torch.clone, tc), T0)
    lg, tc = tlm.decode(tp, tok[:, T0:T0 + 1], tc, T0, rows=[1])
    assert torch.equal(lg, lg_all)
    full, after = _flat(full), _flat(tc)
    # each leaf's batch axis: where the specs of B and B + 1 rows differ
    axes = {p: next(i for i, (a, b) in enumerate(zip(s1[0], s2[0]))
                    if a != b)
            for (p, s1), s2 in zip(_flat(tlm.cache_defs(B, S)).items(),
                                   _flat(tlm.cache_defs(B + 1, S)).values())}
    states = 0
    for path, t in after.items():
        axis = axes[path]
        row0 = [slice(None)] * t.dim()
        row0[axis] = 0
        row1 = list(row0)
        row1[axis] = 1
        assert torch.equal(t[tuple(row0)], before[path][tuple(row0)]), path
        assert torch.equal(t[tuple(row1)], full[path][tuple(row1)]), path
        states += not torch.equal(t, before[path])
    assert states > 0
    snap = {p: t.clone() for p, t in after.items()}
    tlm.decode(tp, tok[:, T0:T0 + 1], tc, T0 + 1, rows=[])
    for path, t in _flat(tc).items():
        assert torch.equal(t, snap[path]), path


def _state_leaves(params, opt):
    """{path: float32 numpy} of (params, OptState) from either package."""
    out = {}
    for name, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
        out.update({(name,) + p: _np(x) for p, x in _flat(tree).items()})
    out[("step",)] = _np(opt.step)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_checkpoints_round_trip_in_jax_format(arch, tmp_path):
    """Each family's bf16 parameters and AdamW state (float32 moments,
    filled) saved by the port restore in JAX bitwise, and JAX's save of
    those restores in the port bitwise, with every leaf's dtype kept."""
    jlm, jp, tlm, tp = _get(arch, {}, "bfloat16")
    opt = t_opt.init_opt_state(OptimizerConfig(), tp)
    opt = t_opt.OptState(opt.step + 3,
                         t_opt.tree_map(lambda p: p.float() * 0.5, tp),
                         t_opt.tree_map(lambda p: p.float() ** 2, tp))
    t_ckpt.save((tp, opt), tmp_path / "port", step=3)
    jtarget = (jp, j_opt.init_opt_state(JOptCfg(), jp))
    (jp2, jopt2), meta = j_ckpt.restore(tmp_path / "port", jtarget)
    assert meta["step"] == 3
    want = _state_leaves(tp, opt)
    got = _state_leaves(jp2, jopt2)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    for a, b in zip(jax.tree.leaves((jp2, jopt2)), jax.tree.leaves(jtarget)):
        assert a.dtype == b.dtype
    j_ckpt.save((jp2, jopt2), tmp_path / "jax", step=4)
    (tp3, opt3), meta = t_ckpt.restore(tmp_path / "jax", (tp, opt))
    assert meta["step"] == 4
    back = _state_leaves(tp3, opt3)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))
    for a, b in zip(t_opt.tree_leaves(tp3), t_opt.tree_leaves(tp)):
        assert a.dtype == b.dtype


@pytest.mark.parametrize("arch", FAMILIES)
def test_launchers_run_every_family(arch, capsys):
    """``launch/train.py`` trains each family's smoke config (the vlm's
    and the audio family's batches get their zero embeddings) with two
    microbatches; ``launch/serve.py`` drains its requests for every
    family but audio, which it refuses with the cross-cache caveat."""
    t_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                  "2", "--batch", "4", "--seq", "8", "--microbatches", "2"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 2
    assert all(np.isfinite(float(ln.split()[2][len("loss="):]))
               for ln in lines)
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--slots", "2", "--prompt-len", "6", "--max-new", "3",
            "--max-seq", "16"]
    if arch == "seamless-m4t-large-v2":
        with pytest.raises(ValueError, match="cross cache"):
            t_serve.main(args)
        return
    t_serve.main(args)
    assert "'requests': 3, 'tokens': 9" in capsys.readouterr().out
