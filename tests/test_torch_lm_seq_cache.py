"""JAX's long-context cache layout on the port's mesh: when the
data-parallel axes do not divide a cache's batch, ``cache_spec`` cuts
its sequence over "data" (``repro.sharding.rules.cache_spec``'s second
case).  On a gloo world of (4, 1) ranks (``tests/_torch_lm_sharded_
worker.py``) granite-8b's smoke config (float32, its vocabulary padded to
260) and zamba2-7b's (its shared attention block's cache cut so, its
Mamba-2 states whole) hold caches of 1 and 2 rows as every row and a
quarter of the dim JAX's rule takes for the sequence (4 rows: a row a
rank); their decodes, B4's plain version on each rank's positions with
the ranges merged over "data", equal the unsharded port's within 1e-5
after a prefill and from a zero cache; the engine on 2 slots (each
request's prefill written in that layout) gives JAX's engine's tokens.

seamless-m4t-large-v2's smoke config (float32) at batch 1 and
``max_seq`` 64 holds its cross cache as its self cache, a quarter of the
64 positions a rank, and its decode (B4's plain version over each rank's
range of the cross cache, merged over "data") equals the unsharded
port's and JAX's on its own (4, 1) mesh of 4 host devices (the cache
placed by ``cache_shardings``) within 1e-5; at ``max_seq`` 32, where
JAX's rule cuts its caches' 32 kv features, it equals the unsharded
port's.

Every arch's smoke config on (4, 1), at 1 to 4 rows and ``max_seq`` 32
and 64, holds each ``init_cache`` leaf as the dry run's per-rank piece
(``launch.dryrun.cache_pieces``: JAX's rule, which finds the dims by
length, so that at 2 rows the smoke configs' 2 layers take the batch's
cut and at 32 positions the 32 kv features take the sequence's).
"""
import pickle
import shutil
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

torch.set_num_threads(1)

import _torch_lm_sharded_worker as W  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models.model import LM as JLM  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch.common.convert import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

from test_torch_lm_sharded import LOGIT_TOL  # noqa: E402

MODELS = {"granite": ("granite-8b", dict(pad_vocab_to_multiple=4),
                      ("blocks",)),
          "zamba2": ("zamba2-7b", {}, ("blocks", "attn"))}
LONG = {"seamless": "seamless-m4t-large-v2"}



@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_seq_cache")
    r = np.random.default_rng(5)
    inputs = {"models": {}, "batches": {}, "kv path": {},
              "seq names": list(MODELS),
              "prompts": [r.integers(0, 257, n).astype(np.int32)
                          for n in W.LENS],
              "decode_tokens": np.random.default_rng(11).integers(
                  0, 257, (W.SLOTS, W.MAX_SEQ)).astype(np.int64)}
    jax_models = {}
    for name, (arch, kw, path) in MODELS.items():
        kw = dict(kw, dtype="float32")
        jlm = JLM(j_smoke(arch).replace(**kw))
        jp = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
        jax_models[name] = (jlm, jp)
        inputs["models"][name] = (smoke_config(arch).replace(**kw), jp)
        inputs["batches"][name] = {}
        inputs["kv path"][name] = path
    inputs["long names"], inputs["long"], cases = list(LONG), {}, []
    for name, arch in LONG.items():
        kw = dict(dtype="float32")
        jlm = JLM(j_smoke(arch).replace(**kw))
        jp = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
        tcfg = smoke_config(arch).replace(**kw)
        jax_models[name] = (jlm, jp)
        inputs["models"][name] = (tcfg, jp)
        inputs["batches"][name] = {"enc_embeds": r.normal(
            0, 1, (1, W.S, tcfg.d_model)).astype(np.float32)}
        inputs["long"][name] = {"enc_embeds": r.normal(
            0, 1, (1, W.LONG_SEQ, tcfg.d_model)).astype(np.float32)}
        cases.append({"name": name, "arch": arch, "kw": kw, "params": jp,
                      "mesh": (4, 1), "rows": 1, "max_seq": W.LONG_SEQ,
                      "extras": inputs["long"][name], "engine": False})
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    proc = W.jax_serve(tmp, cases, inputs)
    ctx = W.spawn(tmp, "seq41", 4)
    ref = {}
    for name in MODELS:
        jlm, jp = jax_models[name]
        tcfg, npp = inputs["models"][name]
        tlm, tp = LM(tcfg), params_from_numpy(npp, "lm", device="cpu")
        reqs = [j_engine.Request(rid=i, prompt=np.asarray(p, np.int32),
                                 max_new_tokens=W.NEW)
                for i, p in enumerate(inputs["prompts"])]
        j_engine.ServeEngine(jlm, jp, 2, W.MAX_SEQ).run(reqs)
        ref[name] = {"decode": {b: W.decodes(tlm, tp, inputs, {}, b)
                                for b in (1, 2)},
                     "tokens": [q.out_tokens for q in reqs]}
    for name in LONG:
        tcfg, npp = inputs["models"][name]
        tlm, tp = LM(tcfg), params_from_numpy(npp, "lm", device="cpu")
        ref[name] = {"decode": W.decodes(tlm, tp, inputs,
                                         inputs["long"][name], 1,
                                         W.LONG_SEQ),
                     "decode 32": W.decodes(tlm, tp, inputs,
                                            inputs["batches"][name], 1)}
    W.wait(ctx)
    got = W.results(tmp, "seq41", 4)
    ref["jax"] = W.jax_serve_results(tmp, proc)
    yield types.SimpleNamespace(got=got, ref=ref)
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("name", list(MODELS))
def test_cache_positions_cut_over_data(seq, name):
    """1 and 2 rows: every row, and a quarter of the last dim of length
    32, which JAX's rule takes for the sequence: zamba2's 32 positions
    (of 64 kv features), granite's 32 kv features (2 heads of 16; its
    positions whole); 4 rows: a row a rank, all of it."""
    pieces = seq.got[name]["pieces"]
    lead = pieces[4][:-3]
    kvf = pieces[4][-1]
    if kvf == W.MAX_SEQ:
        assert pieces[1][len(lead):] == (1, W.MAX_SEQ, kvf // 4)
        assert pieces[2][len(lead):] == (2, W.MAX_SEQ, kvf // 4)
    else:
        assert pieces[1][len(lead):] == (1, W.MAX_SEQ // 4, kvf)
        assert pieces[2][len(lead):] == (2, W.MAX_SEQ // 4, kvf)
    assert pieces[4][len(lead):] == (1, W.MAX_SEQ, kvf)


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("name", list(MODELS))
def test_decode_over_positions_cut_over_data(seq, name, rows):
    got, want = seq.got[name]["decode"][rows], seq.ref[name]["decode"][rows]
    assert set(got) == set(want)
    for pos in want:
        np.testing.assert_allclose(got[pos][..., :257], want[pos][..., :257],
                                   rtol=0, atol=LOGIT_TOL,
                                   err_msg=f"pos {pos}")


@pytest.mark.parametrize("name", list(MODELS))
def test_engine_on_two_slots_equals_jax(seq, name):
    assert seq.got[name]["engine"] == seq.ref[name]["tokens"]


def test_init_cache_is_the_dry_runs_piece_on_41(seq):
    assert W.layout_mismatches(seq.got["layouts"], (4, 1)) == []


@pytest.mark.parametrize("name", list(LONG))
def test_cross_cache_positions_cut_over_data(seq, name):
    """Batch 1 at 64 positions: the self and cross caches of the 2
    decoder layers hold every row and 16 of the 64 positions of the 32
    kv features, from ``init_cache`` and from a prefill whose encoder
    states span the 64 positions."""
    for how in ("init", "prefill"):
        pieces = seq.got[name]["cross"][how]
        for leaf in ("dec_blocks.self.k", "dec_blocks.cross.k"):
            assert pieces[leaf] == (2, 1, W.LONG_SEQ // 4, 32), (how, leaf)


@pytest.mark.parametrize("name", list(LONG))
@pytest.mark.parametrize("want", ["port", "jax"])
def test_long_context_decode_over_cut_cross_cache(seq, name, want):
    """Three decodes after an 8-token prefill and three from a zero
    cache, the cross cache cut over "data": the unsharded port's and
    JAX's on its (4, 1) mesh, within ``LOGIT_TOL``."""
    got = seq.got[name]["decode"]
    ref = (seq.ref[name]["decode"] if want == "port"
           else seq.ref["jax"][name])
    for pos in got:
        np.testing.assert_allclose(got[pos], ref[pos], rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"pos {pos}")


@pytest.mark.parametrize("name", list(LONG))
def test_decode_with_features_cut_at_32(seq, name):
    """At ``max_seq`` 32 JAX's rule cuts the 32 kv features of both
    caches over "data"; the decode re-cuts them to positions around each
    call and equals the unsharded port's."""
    got, want = seq.got[name]["decode 32"], seq.ref[name]["decode 32"]
    assert set(got) == set(want)
    for pos in want:
        np.testing.assert_allclose(got[pos], want[pos], rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"pos {pos}")
