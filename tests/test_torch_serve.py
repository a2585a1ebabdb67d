"""The port's serving engine (``repro_torch.serve.engine``) against the JAX
package's on the same weights and requests, its drain-budget error, and the
``lm`` convert of a JAX parameter tree."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch.common.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.flash_decode import ops as t_fd  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

F32_KW = dict(dtype="float32", num_heads=8, num_kv_heads=2)


class RecordingLM:
    """Passes every call to ``lm`` and notes each decode's ``rows``."""

    def __init__(self, lm):
        self.lm, self.cfg, self.rows = lm, lm.cfg, []

    def init_cache(self, *a, **kw):
        return self.lm.init_cache(*a, **kw)

    def prefill(self, *a, **kw):
        return self.lm.prefill(*a, **kw)

    def decode(self, *a, **kw):
        self.rows.append(kw.get("rows"))
        return self.lm.decode(*a, **kw)


@pytest.fixture(scope="module")
def models():
    jlm = JLM(j_smoke("granite-8b").replace(**F32_KW))
    jp = jlm.init(jax.random.PRNGKey(0))
    tlm = LM(smoke_config("granite-8b").replace(**F32_KW))
    return jlm, jp, tlm, params_from_numpy(jax.tree.map(np.asarray, jp), "lm",
                                         device="cpu")


def _requests(cls, vocab, lens, max_new=6):
    r = np.random.default_rng(5)
    return [cls(rid=i, prompt=r.integers(0, vocab, n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lens)]


@pytest.mark.parametrize("lens", [(8, 8, 12, 12, 5, 8), (8,) * 6])
def test_engine_matches_jax(models, lens):
    """Six requests (6 new tokens each) on 4 slots: with prompts of 8, 8,
    12, 12, 5 and 8 tokens every step has two position groups and takes the
    masked decode; with equal prompts one full-batch decode.  Every
    request's tokens and the step count equal JAX's."""
    jlm, jp, tlm, tp = models
    jreqs = _requests(j_engine.Request, jlm.cfg.vocab_size, lens)
    jstats = j_engine.ServeEngine(jlm, jp, batch_slots=4,
                                  max_seq=32).run(jreqs)
    rec = RecordingLM(tlm)
    treqs = _requests(Request, tlm.cfg.vocab_size, lens)
    t_fd.LAUNCHES = 0
    tstats = ServeEngine(rec, tp, batch_slots=4, max_seq=32,
                         device="cpu").run(treqs)
    assert t_fd.LAUNCHES == 0           # CPU tensors: the plain B4
    assert tstats["steps"] == jstats["steps"]
    assert tstats["requests"] == jstats["requests"] == len(lens)
    assert tstats["tokens"] == jstats["tokens"]
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and tr.out_tokens == jr.out_tokens, tr.rid
    masked = [r for r in rec.rows if r is not None]
    if len(set(lens)) > 1:
        assert len(masked) == len(rec.rows) >= 4
    else:
        assert not masked and rec.rows


def test_engine_drain_budget_names_stuck_slots():
    """tests/test_serve_stream.py's regression on the port: an
    admission-starved loop raises naming the stuck slots and the
    un-admitted backlog, with the JAX engine's text."""
    cfg = smoke_config("granite-8b")
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0))
    prompt = np.arange(8, dtype=np.int32) % cfg.vocab_size
    eng = ServeEngine(lm, params, batch_slots=1, max_seq=32, device="cpu")
    reqs = [Request(rid=i, prompt=prompt, max_new_tokens=6)
            for i in range(2)]
    with pytest.raises(RuntimeError) as exc:
        eng.run(reqs, max_steps=3)
    msg = str(exc.value)
    assert "did not drain in 3 steps" in msg
    assert "1 request(s) never admitted" in msg
    # prefill emits the first token, so 3 steps leave 4/6 emitted
    assert "slot 0: rid=0" in msg and "emitted=4/6" in msg

    eng2 = ServeEngine(lm, params, batch_slots=1, max_seq=32, device="cpu")
    reqs2 = [Request(rid=i, prompt=prompt, max_new_tokens=6)
             for i in range(2)]
    assert eng2.run(reqs2)["requests"] == 2


def test_engine_needs_a_card_unless_asked_for_the_cpu(models):
    _, _, tlm, tp = models
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tlm, tp, batch_slots=1, max_seq=8)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_convert_lm_keeps_tree_shapes_dtypes_and_values(dtype):
    """JAX's nested tree -> the port's: same names and stacked shapes, the
    dtype kept (bfloat16 through float32, exact), the values equal."""
    jlm = JLM(j_smoke("granite-8b").replace(dtype=dtype))
    jp = jlm.init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "lm",
                                         device="cpu")
    want_dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree.leaves(tp))
    for path, leaf in flat:
        node = tp
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == tuple(leaf.shape)
        jdt = str(np.asarray(leaf).dtype)
        assert node.dtype == want_dt[jdt], (path, jdt, node.dtype)
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert tp["blocks"]["attn"]["q"]["w"].dtype == want_dt[dtype]
    assert tp["blocks"]["ln1"]["scale"].dtype == torch.float32
