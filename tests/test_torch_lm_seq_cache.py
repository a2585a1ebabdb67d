"""JAX's long-context cache layout on the port's mesh: when the
data-parallel axes do not divide a cache's batch, ``cache_spec`` cuts
its sequence over "data" (``repro.sharding.rules.cache_spec``'s second
case).  On a gloo world of (4, 1) ranks (``tests/_torch_lm_sharded_
worker.py``) granite-8b's smoke config (float32, its vocabulary padded to
260) and zamba2-7b's (its shared attention block's cache cut so, its
Mamba-2 states whole) hold caches of 1 and 2 rows as every row and a
quarter of the positions on each rank (4 rows: a row a rank, every
position); their decodes, B4's plain version on each rank's positions
with the ranges merged over "data", equal the unsharded port's within
1e-5 after a prefill and from a zero cache; the engine on 2 slots (each
request's prefill written in that layout) gives JAX's engine's tokens.
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
    (tmp / "inputs.pkl").write_bytes(pickle.dumps(inputs))
    ctx = W.spawn(tmp, "seq41", 4)
    ref = {}
    for name, (jlm, jp) in jax_models.items():
        tcfg, npp = inputs["models"][name]
        tlm, tp = LM(tcfg), params_from_numpy(npp, "lm", device="cpu")
        reqs = [j_engine.Request(rid=i, prompt=np.asarray(p, np.int32),
                                 max_new_tokens=W.NEW)
                for i, p in enumerate(inputs["prompts"])]
        j_engine.ServeEngine(jlm, jp, 2, W.MAX_SEQ).run(reqs)
        ref[name] = {"decode": {b: W.decodes(tlm, tp, inputs, {}, b)
                                for b in (1, 2)},
                     "tokens": [q.out_tokens for q in reqs]}
    W.wait(ctx)
    got = W.results(tmp, "seq41", 4)
    yield types.SimpleNamespace(got=got, ref=ref)
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("name", list(MODELS))
def test_cache_positions_cut_over_data(seq, name):
    """1 and 2 rows: every row, a quarter of the 32 positions; 4 rows: a
    row a rank, every position."""
    pieces = seq.got[name]["pieces"]
    lead = pieces[4][:-3]
    assert pieces[1][len(lead):-1] == (1, W.MAX_SEQ // 4)
    assert pieces[2][len(lead):-1] == (2, W.MAX_SEQ // 4)
    assert pieces[4][len(lead):-1] == (1, W.MAX_SEQ)


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
