"""The port's LM (``repro_torch.models``) against the JAX package's on the
same weights: JAX-initialised parameters carried across with the ``lm``
convert, granite-8b's smoke config (float32, 8 query and 2 kv heads, so
G = 4 as the TPU kernel's dispatch wanted; head_dim 8), and the port's
own teacher-forcing consistency."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro_torch.common.convert import params_from_numpy  # noqa: E402
from repro_torch.common.params import param_bytes, param_count  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

F32_KW = dict(dtype="float32", num_heads=8, num_kv_heads=2)
B, S, T0 = 2, 16, 10          # batch, cache length, prompt length


def _tokens(cfg, seed=1):
    r = np.random.default_rng(seed)
    return r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.int64))


@pytest.fixture(scope="module")
def f32():
    """(JAX LM, JAX params, port LM, port params) of the float32 model."""
    jlm = JLM(j_smoke("granite-8b").replace(**F32_KW))
    jp = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(smoke_config("granite-8b").replace(**F32_KW))
    return jlm, jp, tlm, params_from_numpy(jax.tree.map(np.asarray, jp), "lm",
                                         device="cpu")


@pytest.fixture(scope="module")
def bf16():
    jlm = JLM(j_smoke("granite-8b"))
    jp = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(smoke_config("granite-8b"))
    return jlm, jp, tlm, params_from_numpy(jax.tree.map(np.asarray, jp), "lm",
                                         device="cpu")


@pytest.mark.parametrize("layer", ["rmsnorm", "apply_rope", "swiglu"])
def test_layers_match_jax(layer):
    """Each layer to <= 1e-6 in float32 on the same inputs."""
    r = np.random.default_rng(3)
    if layer == "rmsnorm":
        x = r.normal(0, 1, (2, 12, 64)).astype(np.float32)
        s = r.normal(1, 0.1, 64).astype(np.float32)
        want = j_layers.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x))
        got = t_layers.rmsnorm({"scale": torch.from_numpy(s)},
                               torch.from_numpy(x))
    elif layer == "apply_rope":
        x = r.normal(0, 1, (2, 40, 4, 16)).astype(np.float32)
        pos = np.arange(40)[None] + 100
        want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e7)
        got = t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                  1e7)
    else:
        x = r.normal(0, 1, (2, 12, 64)).astype(np.float32)
        ws = {n: r.normal(0, 0.1, s).astype(np.float32) for n, s in
              (("up", (64, 128)), ("gate", (64, 128)), ("down", (128, 64)))}
        want = j_layers.swiglu({n: {"w": jnp.asarray(w)}
                                for n, w in ws.items()}, jnp.asarray(x))
        got = t_layers.swiglu({n: {"w": torch.from_numpy(w)}
                               for n, w in ws.items()}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("fn", ["self_attention", "decode_attention",
                                "decode_self_attention"])
def test_attention_functions_match_jax(f32, fn):
    """The attention functions the LM does not call on its serving path,
    on the first layer's weights: full-sequence causal self-attention,
    plain single-position attention, and the decode that writes its token
    into the cache (in place here), all to <= 1e-5."""
    jlm, jp, tlm, tp = f32
    cfg, jcfg = tlm.cfg, jlm.cfg
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tl = {k: {"w": v["w"][0]} for k, v in tp["blocks"]["attn"].items()}
    r = np.random.default_rng(7)
    x = r.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    if fn == "self_attention":
        want = j_attn.self_attention(jcfg, jl, jnp.asarray(x), q_chunk=4,
                                     kv_chunk=8)
        got = t_attn.self_attention(cfg, tl, torch.from_numpy(x), q_chunk=4,
                                    kv_chunk=8)
    elif fn == "decode_attention":
        hd = cfg.resolved_head_dim
        q, k, v = (r.normal(0, 1, s).astype(np.float32) for s in (
            (B, 1, cfg.num_heads, hd), (B, S, cfg.num_kv_heads, hd),
            (B, S, cfg.num_kv_heads, hd)))
        want = j_attn.decode_attention(*map(jnp.asarray, (q, k, v)),
                                       kv_valid_len=jnp.int32(T0))
        got = t_attn.decode_attention(*map(torch.from_numpy, (q, k, v)),
                                      kv_valid_len=T0)
    else:
        kvf = cfg.num_kv_heads * cfg.resolved_head_dim
        cache = {n: r.normal(0, 1, (B, S, kvf)).astype(np.float32)
                 for n in ("k", "v")}
        want, jc = j_attn.decode_self_attention(
            jcfg, jl, jnp.asarray(x[:, :1]),
            {n: jnp.asarray(c) for n, c in cache.items()}, jnp.int32(T0))
        tc = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
        got, tc2 = t_attn.decode_self_attention(
            cfg, tl, torch.from_numpy(x[:, :1]), tc, T0)
        assert tc2 is tc
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_param_tree_matches_jax(f32):
    """The port's declarations give JAX's tree: names, shapes, dtypes."""
    _, jp, tlm, tp = f32
    mine = tlm.init(torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(jax.tree.leaves(mine))
    for path, leaf in flat_j:
        node, conv = mine, tp
        for p in path:
            node, conv = node[p.key], conv[p.key]
        assert tuple(node.shape) == tuple(leaf.shape) == tuple(conv.shape)
        assert node.dtype == conv.dtype == torch.float32


def test_granite_8b_full_width_sizes():
    """The published config at full width: 8,254,689,280 parameters (16.5
    GB in bf16) and a 4-slot x 2048-position bf16 cache of 1.21 GB."""
    lm = LM(get_config("granite-8b"))
    defs = lm.param_defs()
    assert param_count(defs) == 8_254_689_280
    # bf16 weights, float32 norm scales (two per layer and the final one)
    assert param_bytes(defs) == 2 * 8_254_689_280 + 2 * (2 * 36 + 1) * 4096
    cache = lm.cache_defs(4, 2048)["blocks"]
    assert cache["k"] == ((36, 4, 2048, 1024), torch.bfloat16)
    assert 2 * 36 * 4 * 2048 * 1024 * 2 == 1_207_959_552


def test_prefill_matches_jax(f32):
    """Last-position logits to <= 1e-4, the padded cache to <= 1e-5."""
    jlm, jp, tlm, tp = f32
    tok = _tokens(tlm.cfg)[:, :T0]
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tok)}, S)
    tl, tc = tlm.prefill(tp, {"tokens": _t(tok)}, S)
    assert tl.shape == (B, 1, tlm.cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    for k in ("k", "v"):
        assert tc["blocks"][k].shape == jc["blocks"][k].shape
        np.testing.assert_allclose(tc["blocks"][k].numpy(),
                                   np.asarray(jc["blocks"][k]), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_matches_jax(f32, use_kernel):
    """Six decode steps after a prefill: logits and the written cache to
    <= 1e-4 against JAX's ``LM.decode`` (``decode_attention_with_new``),
    through the port's plain route and its kernel route (the plain B4 on
    the CPU)."""
    jlm, jp, tlm, tp = f32
    tok = _tokens(tlm.cfg)
    _, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tok[:, :T0])}, S)
    _, tc = tlm.prefill(tp, {"tokens": _t(tok[:, :T0])}, S)
    jdec = jax.jit(jlm.decode)
    for i in range(T0, T0 + 6):
        jl, jc = jdec(jp, jnp.asarray(tok[:, i:i + 1]), jc, jnp.int32(i))
        tl, tc = tlm.decode(tp, _t(tok[:, i:i + 1]), tc, i,
                            use_kernel=use_kernel)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        for k in ("k", "v"):
            np.testing.assert_allclose(tc["blocks"][k].numpy(),
                                       np.asarray(jc["blocks"][k]), rtol=0,
                                       atol=1e-4)


def test_decode_writes_only_the_rows_asked_for(f32):
    _, _, tlm, tp = f32
    tok = _tokens(tlm.cfg)
    _, tc = tlm.prefill(tp, {"tokens": _t(tok[:, :T0])}, S)
    before = {k: v.clone() for k, v in tc["blocks"].items()}
    lg_all, _ = tlm.decode(tp, _t(tok[:, T0:T0 + 1]),
                           {"blocks": {k: v.clone() for k, v in
                                       before.items()}}, T0)
    lg, tc = tlm.decode(tp, _t(tok[:, T0:T0 + 1]), tc, T0, rows=[1])
    assert torch.equal(lg, lg_all)
    for k, v in tc["blocks"].items():
        assert torch.equal(v[:, 0], before[k][:, 0])
        assert not torch.equal(v[:, 1, T0], before[k][:, 1, T0])
        assert torch.equal(v[:, 1, :T0], before[k][:, 1, :T0])
    _, tc = tlm.decode(tp, _t(tok[:, T0:T0 + 1]), tc, T0 + 1, rows=[])
    for k, v in tc["blocks"].items():
        assert torch.equal(v[:, :, T0 + 1], before[k][:, :, T0 + 1])


def test_bf16_smoke_matches_jax(bf16):
    """bfloat16 ``smoke_config("granite-8b")``: prefill and four decode
    steps within 5e-2 of max |logit| of JAX's (tests/test_archs.py's rule
    for bf16 numerics)."""
    jlm, jp, tlm, tp = bf16
    tok = _tokens(tlm.cfg, seed=2)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(tok[:, :T0])}, S)
    tl, tc = tlm.prefill(tp, {"tokens": _t(tok[:, :T0])}, S)
    assert tl.dtype == torch.bfloat16 and tc["blocks"]["k"].dtype == \
        torch.bfloat16
    pairs = [(np.asarray(jl, np.float32), tl.float().numpy())]
    for i in range(T0, T0 + 4):
        jl, jc = jlm.decode(jp, jnp.asarray(tok[:, i:i + 1]), jc,
                            jnp.int32(i))
        tl, tc = tlm.decode(tp, _t(tok[:, i:i + 1]), tc, i)
        pairs.append((np.asarray(jl, np.float32), tl.float().numpy()))
    V = tlm.cfg.vocab_size
    scale = max(float(np.abs(w[..., :V]).max()) for w, _ in pairs) + 1e-9
    errs = [float(np.abs(w[..., :V] - g[..., :V]).max()) for w, g in pairs]
    assert max(errs) / scale < 5e-2, errs


@pytest.mark.parametrize("dtype,use_kernel", [("bfloat16", True),
                                              ("bfloat16", False),
                                              ("float32", True)])
def test_decode_matches_teacher_forcing(dtype, use_kernel):
    """The port alone (tests/test_archs.py's consistency check): the logits
    of decode at position i equal those of a prefill of the same i + 1
    tokens, within 5e-2 of max |logit| (bf16 numerics) or 1e-4 (float32)."""
    cfg = smoke_config("granite-8b").replace(dtype=dtype)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    tok = _tokens(cfg, seed=4)
    lg, cache = lm.prefill(params, {"tokens": _t(tok[:, :T0])}, S)
    V = cfg.vocab_size
    pairs = []
    for i in range(T0, S - 1):
        lg, cache = lm.decode(params, _t(tok[:, i:i + 1]), cache, i,
                              use_kernel=use_kernel)
        full, _ = lm.prefill(params, {"tokens": _t(tok[:, :i + 1])}, S)
        pairs.append((full.float()[..., :V], lg.float()[..., :V]))
    errs = [float((w - g).abs().max()) for w, g in pairs]
    if dtype == "float32":
        assert max(errs) <= 1e-4, errs
    else:
        scale = max(float(w.abs().max()) for w, _ in pairs) + 1e-9
        assert max(errs) / scale < 5e-2, errs
