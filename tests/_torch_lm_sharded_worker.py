"""The rank bodies of ``tests/test_torch_lm_sharded.py``.

Each spawned process joins a gloo group through a file under the test's
``tmp_path``, builds the LM mesh of its world, runs that world's cases on
the CPU with one intra-op thread and pickles what it saw as whole arrays
(rows and vocab columns gathered, parameters unsharded), so every rank's
results must equal rank 0's bit for bit.  The inputs (JAX's parameters as
numpy, batches, prompts) come from a pickle the test writes.  The module
imports no JAX: the children load only the port.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np
import torch

B, S = 4, 16                   # training rows and tokens (tests/test_torch_train.py)
B_FSDP = 8                     # (4, 1): 2 rows a rank, 1 a microbatch
SLOTS, MAX_SEQ = 4, 32         # serving (tests/test_torch_serve.py)
LENS = (8, 8, 12, 12, 5, 8)    # two position groups: grouped decodes run
NEW = 6
DECODE_AT = (0, 8, 16)         # positions 0 and the slice boundaries of
                               # 4 and 2 model ranks (8 and 16 of 32)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
LONG_SEQ = 64                  # the audio family's long-context case: its
                               # cross cache of 64 positions (not 32, the
                               # smoke kv features' width) cut over "data"
LAYOUT_BATCHES = (1, 2, 3, 4)  # divided by the data ranks or not; 2 is
                               # also the smoke configs' layer count
LAYOUT_SEQS = (32, 64)         # 32 = the smoke kv features, 64 = zamba2's


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _tree_np(tree):
    if torch.is_tensor(tree):
        return _np(tree)
    if isinstance(tree, tuple):
        return tuple(_tree_np(x) for x in tree)
    return {k: _tree_np(v) for k, v in tree.items()}


def model(inputs: dict, name: str, mesh):
    """(the port's LM of config ``name`` on ``mesh``, this rank's pieces of
    JAX's parameters)."""
    from repro_torch.common.convert import params_from_numpy
    from repro_torch.models.model import LM
    cfg, jp = inputs["models"][name]
    lm = LM(cfg, mesh)
    return lm, lm.shard(params_from_numpy(jp, "lm", device="cpu"))


def logits_and_loss(lm, p, batch: dict) -> dict:
    lo, hi = lm.batch_rows(batch["tokens"].shape[0])
    local = {k: torch.from_numpy(v[lo:hi]) for k, v in batch.items()}
    lg, _ = lm.logits(p, local)
    lg = lm.gather_rows(lm.full_logits(lg), batch["tokens"].shape[0])
    loss, aux = lm.loss(p, local)
    return {"logits": _np(lg), "loss": float(loss), "ce": float(aux["ce"]),
            "moe": {k: float(v) for k, v in aux.items()
                    if k.startswith("moe_")}}


def train_step(lm, p, batch: dict, microbatches: int = 2) -> dict:
    """One step from zero moments: metrics, and the whole updated
    parameters and first moments."""
    from repro_torch.common.config import OptimizerConfig, RunConfig
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps
    run = RunConfig(model=lm.cfg, opt=OptimizerConfig(**OPT),
                    microbatches=microbatches)
    lo, hi = lm.batch_rows(batch["tokens"].shape[0])
    local = {k: torch.from_numpy(v[lo:hi]) for k, v in batch.items()}
    step = steps.make_train_step(lm, run)
    p2, o2, m = step(p, O.init_opt_state(run.opt, p), local)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _tree_np(lm.unshard(p2)),
            "m": _tree_np(lm.unshard(o2.m))}


def serve(lm, p, inputs: dict) -> dict:
    """The engine's tokens for the prompts; decode logits (whole) at
    ``DECODE_AT`` and the next position, after a prefill of the tokens
    before."""
    from repro_torch.serve.engine import Request, ServeEngine
    reqs = [Request(rid=i, prompt=np.asarray(pr, np.int32),
                    max_new_tokens=NEW)
            for i, pr in enumerate(inputs["prompts"])]
    stats = ServeEngine(lm, p, SLOTS, MAX_SEQ, device="cpu").run(reqs)
    tok = torch.from_numpy(inputs["decode_tokens"])
    lo, hi = lm.batch_rows(SLOTS)
    dec = {}
    for t0 in DECODE_AT:
        if t0 == 0:
            cache = lm.init_cache(SLOTS, MAX_SEQ, "cpu")
        else:
            _, cache = lm.prefill(p, {"tokens": tok[lo:hi, :t0]}, MAX_SEQ)
        for i in range(t0, t0 + 2):
            lg, cache = lm.decode(p, tok[lo:hi, i:i + 1], cache, i)
            dec[i] = _np(lm.gather_rows(lm.full_logits(lg), SLOTS))
    return {"tokens": [r.out_tokens for r in reqs], "steps": stats["steps"],
            "decode": dec}


def loader_rows(lm, policy: str) -> list:
    """This rank's rows of two batches of ``PrefetchLoader``, gathered."""
    from repro_torch.data.pipeline import (DataConfig, PrefetchLoader,
                                           SyntheticTokenSource)
    src = SyntheticTokenSource(DataConfig(B_FSDP, 9, 100, seed=2))
    loader = PrefetchLoader(src, "cpu", lm.mesh, policy)
    it = iter(loader)
    out = [{k: lm.gather_rows(v, B_FSDP).numpy() for k, v in next(it).items()}
           for _ in range(2)]
    loader.close()
    return out


def ckpt_state(lm):
    """granite-8b's smoke model in bfloat16 from a seed, after one train
    step: (params, opt_state) pieces and their placements."""
    from repro_torch.common.config import OptimizerConfig, RunConfig
    from repro_torch.train import optimizer as O
    from repro_torch.train import steps
    run = RunConfig(model=lm.cfg, opt=OptimizerConfig(**OPT))
    p = lm.init(torch.Generator().manual_seed(3))
    o = O.init_opt_state(run.opt, p)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, 257, (B, S)))
             for k in ("tokens", "labels")}
    lo, hi = lm.batch_rows(B)
    p, o, _ = steps.make_train_step(lm, run)(
        p, o, {k: v[lo:hi] for k, v in batch.items()})
    return (p, o), (lm.specs, O.OptState((), lm.specs, lm.specs))


def restored(lm, path: Path) -> tuple:
    """A checkpoint restored onto this mesh (into a zero target of this
    rank's pieces), unsharded."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.common.config import OptimizerConfig
    from repro_torch.common.params import map_defs
    from repro_torch.train import optimizer as O
    p = lm.shard(map_defs(lambda d: torch.zeros(d.shape, dtype=d.dtype),
                          lm.param_defs()))
    target = (p, O.init_opt_state(OptimizerConfig(**OPT), p))
    places = (lm.specs, O.OptState((), lm.specs, lm.specs))
    (p2, o2), meta = ckpt.restore(path, target, mesh=lm.mesh,
                                  placements=places)
    return (_tree_np(lm.unshard(p2)), int(o2.step), _tree_np(
        lm.unshard(o2.m)), _tree_np(lm.unshard(o2.v))), int(meta["step"])


# -- the worlds ------------------------------------------------------------------

def world22(tmp: Path, inputs: dict) -> dict:
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch.mesh import lm_device_mesh
    from repro_torch.models.model import LM
    mesh = lm_device_mesh(2, 2)
    lm, p = model(inputs, "granite", mesh)
    out = {"layout": (lm.tp.n, lm.tp.local_heads, lm._vocab_cut),
           "fwd": logits_and_loss(lm, p, inputs["batch"]),
           "step": train_step(lm, p, inputs["batch"]),
           "serve": serve(lm, p, inputs)}
    lq, pq = model(inputs, "qwen", mesh)
    out["serve qwen"] = serve(lq, pq, inputs)
    lf, pf = model(inputs, "granite fsdp", mesh)
    out["fsdp layout"] = (lf.tp, lf.dp_axes)
    out["fsdp fwd"] = logits_and_loss(lf, pf, inputs["batch8"])
    out["fsdp step"] = train_step(lf, pf, inputs["batch8"])
    lb = LM(inputs["ckpt_cfg"], mesh)
    state, places = ckpt_state(lb)
    ckpt.save(state, tmp / "ckpt22", step=1, mesh=mesh, placements=places)
    out["ckpt"] = (_tree_np(lb.unshard(state[0])), int(state[1].step),
                   _tree_np(lb.unshard(state[1].m)),
                   _tree_np(lb.unshard(state[1].v)))
    return out


def world14(tmp: Path, inputs: dict) -> dict:
    from repro_torch.launch.mesh import lm_device_mesh
    from repro_torch.models.model import LM
    mesh = lm_device_mesh(1, 4)
    lm, p = model(inputs, "granite", mesh)
    out = {"layout": (lm.tp.n, lm.tp.local_heads, lm._vocab_cut),
           "fwd": logits_and_loss(lm, p, inputs["batch"]),
           "step": train_step(lm, p, inputs["batch"]),
           "serve": serve(lm, p, inputs)}
    lq, pq = model(inputs, "qwen", mesh)
    out["serve qwen"] = serve(lq, pq, inputs)
    lb = LM(inputs["ckpt_cfg"], mesh)
    out["restored"] = restored(lb, tmp / "ckpt22")
    out["restored jax"] = restored(lb, tmp / "ckpt_jax")
    lh, ph = model(inputs, "granite bf16", mesh)
    out["bf16"] = {"decode": decodes(lh, ph, inputs, {}, prefill=True),
                   "engine": engine_tokens(lh, ph, inputs)}
    return out


def world41(tmp: Path, inputs: dict) -> dict:
    from repro_torch.launch.mesh import lm_device_mesh
    from repro_torch.models.model import LM
    mesh = lm_device_mesh(4, 1)
    lm, p = model(inputs, "granite", mesh)
    out = {"layout": (lm.tp,),
           "fwd": logits_and_loss(lm, p, inputs["batch8"]),
           "step": train_step(lm, p, inputs["batch8"])}
    lz, pz = model(inputs, "zamba2", mesh)
    out["zamba2 fwd"] = logits_and_loss(lz, pz, inputs["batch8"])
    out["zamba2 step"] = train_step(lz, pz, inputs["batch8"])
    lo, po = model(inputs, "olmoe", mesh)
    out["olmoe fwd"] = logits_and_loss(lo, po, inputs["batch8"])
    out["olmoe step"] = train_step(lo, po, inputs["batch8"])
    out["loader"] = loader_rows(lm, "2d")
    out["restored"] = restored(LM(inputs["ckpt_cfg"], mesh), tmp / "ckpt22")
    return out


def world12(tmp: Path, inputs: dict) -> dict:
    from repro_torch.launch.mesh import lm_device_mesh
    mesh = lm_device_mesh(1, 2)
    lx, px = model(inputs, "xlstm", mesh)
    return {"layout": (lx.dp_axes,),
            "fwd": logits_and_loss(lx, px, inputs["batch"]),
            "step": train_step(lx, px, inputs["batch"]),
            "loader": loader_rows(lx, "dp")}


# -- expert parallelism and the other families under tensor parallelism -----------

def extras(batch: dict, lo: int, hi: int) -> dict:
    """This rank's rows of a batch's non-token inputs (image or encoder
    embeddings), as tensors."""
    return {k: torch.from_numpy(v[lo:hi]) for k, v in batch.items()
            if k not in ("tokens", "labels")}


def decodes(lm, p, inputs: dict, batch: dict, slots: int = SLOTS,
            max_seq: int = MAX_SEQ, prefill: bool = False) -> dict:
    """Decode logits (whole) of ``slots`` rows after a prefill of 8
    tokens and from a zero cache, 3 positions each; the rows' image or
    encoder embeddings from ``batch``'s first rows (with ``prefill``, the
    prefill's logits too, under "prefill")."""
    tok = torch.from_numpy(inputs["decode_tokens"])[:slots]
    lo, hi = lm.batch_rows(slots)
    more = extras({k: v[:slots] for k, v in batch.items()}, lo, hi)
    out = {}
    for t0 in (0, 8):
        if t0 == 0:
            cache = lm.init_cache(slots, max_seq, "cpu")
        else:
            lg, cache = lm.prefill(p, {"tokens": tok[lo:hi, :t0], **more},
                                   max_seq, global_batch=slots)
            if prefill:
                out["prefill"] = _np(lm.gather_rows(lm.full_logits(lg),
                                                    slots))
        for i in range(t0, t0 + 3):
            lg, cache = lm.decode(p, tok[lo:hi, i:i + 1], cache, i,
                                  global_batch=slots)
            out[i] = _np(lm.gather_rows(lm.full_logits(lg), slots))
    return out


def shapes(tree, path: str = "") -> dict:
    """Leaf path -> shape of a nested dict of tensors."""
    if torch.is_tensor(tree):
        return {path: tuple(tree.shape)}
    out = {}
    for k, v in tree.items():
        out.update(shapes(v, f"{path}.{k}" if path else k))
    return out


def layouts(mesh) -> dict:
    """Every arch's smoke config on ``mesh``: this rank's ``init_cache``
    leaf shapes, by (arch, batch, max_seq) over ``LAYOUT_BATCHES`` x
    ``LAYOUT_SEQS``."""
    from repro_torch.configs import list_archs, smoke_config
    from repro_torch.models.model import LM
    out = {}
    for arch in list_archs():
        lm = LM(smoke_config(arch), mesh)
        for b in LAYOUT_BATCHES:
            for ms in LAYOUT_SEQS:
                out[(arch, b, ms)] = shapes(lm.init_cache(b, ms, "meta"))
    return out


def engine_tokens(lm, p, inputs: dict, slots: int = SLOTS) -> list:
    from repro_torch.serve.engine import Request, ServeEngine
    reqs = [Request(rid=i, prompt=np.asarray(pr, np.int32),
                    max_new_tokens=NEW)
            for i, pr in enumerate(inputs["prompts"])]
    ServeEngine(lm, p, slots, MAX_SEQ, device="cpu").run(reqs)
    return [r.out_tokens for r in reqs]


def cache_layout(lm, batch: int, max_seq: int) -> list:
    """The leaves of ``init_cache`` that are no attention cache (recurrent
    states, cross caches) whose piece is not ``local_shape`` of JAX's
    ``cache_specs`` along "model": [] when every one is."""
    from repro_torch.launch.specs import cache_specs
    from repro_torch.sharding import rules
    got = lm.init_cache(batch, max_seq, "cpu")
    whole = lm.cache_defs(batch, max_seq)
    specs = cache_specs(lm, batch, max_seq, lm.mesh)
    bad = []

    def walk(g, w, sp, path):
        if torch.is_tensor(g):
            if any(k in path for k in ("mamba", "mlstm", "slstm", "cross",
                                       "tail")):
                model_only = tuple(e if e == "model" else None for e in sp)
                want = rules.local_shape(w[0], model_only, lm.mesh)
                have = tuple(g.shape)
                if tuple(a for i, a in enumerate(have)
                         if model_only[i]) != tuple(
                             a for i, a in enumerate(want) if model_only[i]):
                    bad.append((path, have, want))
            return
        for k in g:
            walk(g[k], w[k], sp[k], path + (k,))
    walk(got, whole, specs, ())
    return bad


def layout_mismatches(got: dict, mesh_shape) -> list:
    """The (arch, batch, max_seq, leaf, shape, dry run's piece) of a
    world's ``layouts`` that are not the dry run's per-rank pieces
    (``launch.dryrun.cache_pieces`` on a stand-in mesh of the world's
    shape)."""
    from repro_torch.configs import list_archs, smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.models.model import LM
    mesh = dryrun.stand_in_mesh(mesh_shape)
    bad = []
    for arch in list_archs():
        lm = LM(smoke_config(arch))
        for b in LAYOUT_BATCHES:
            for ms in LAYOUT_SEQS:
                want = {k: v[0] for k, v in dryrun.cache_pieces(
                    lm, b, ms, mesh).items()}
                have = got[(arch, b, ms)]
                assert set(have) == set(want), (arch, b, ms)
                bad += [(arch, b, ms, k, have[k], want[k]) for k in want
                        if have[k] != want[k]]
    return bad


def family_world(inputs: dict, mesh, names) -> dict:
    out = {}
    for name in names:
        lm, p = model(inputs, name, mesh)
        batch = inputs["batches"][name]
        out[name] = {"fwd": logits_and_loss(lm, p, batch),
                     "step": train_step(lm, p, batch),
                     "decode": decodes(lm, p, inputs, batch),
                     "layout": cache_layout(lm, SLOTS, MAX_SEQ),
                     "tp": None if lm.tp is None else (lm.tp.n,
                                                       lm.tp.local_heads)}
        if lm.cfg.family != "audio":
            out[name]["engine"] = engine_tokens(lm, p, inputs)
    return out


def tp12(tmp: Path, inputs: dict) -> dict:
    from repro_torch.launch.mesh import lm_device_mesh
    return family_world(inputs, lm_device_mesh(1, 2), inputs["tp names"])


def tp14(tmp: Path, inputs: dict) -> dict:
    from repro_torch.launch.mesh import lm_device_mesh
    mesh = lm_device_mesh(1, 4)
    out = family_world(inputs, mesh, inputs["tp names"])
    out["layouts"] = layouts(mesh)
    return out


def tp22(tmp: Path, inputs: dict) -> dict:
    from repro_torch.launch.mesh import lm_device_mesh
    mesh = lm_device_mesh(2, 2)
    out = family_world(inputs, mesh, inputs["tp names"])
    out["layouts"] = layouts(mesh)
    return out


def ep_world(inputs: dict, mesh, names) -> dict:
    out = {}
    for name in names:
        lm, p = model(inputs, name, mesh)
        batch = inputs["batch"]
        out[name] = {"fwd": logits_and_loss(lm, p, batch),
                     "step": train_step(lm, p, batch),
                     "engine": engine_tokens(lm, p, inputs),
                     "ep": (lm.ep.n, lm.tp is not None)}
    return out


def ep14(tmp: Path, inputs: dict) -> dict:
    from repro_torch.launch.mesh import lm_device_mesh
    return ep_world(inputs, lm_device_mesh(1, 4), ["olmoe"])


def ep22(tmp: Path, inputs: dict) -> dict:
    from repro_torch.launch.mesh import lm_device_mesh
    return ep_world(inputs, lm_device_mesh(2, 2), ["olmoe", "olmoe fsdp"])


def seq41(tmp: Path, inputs: dict) -> dict:
    """JAX's long-context cache layout on (4, 1): 1 and 2 rows, which the
    4 "data" ranks do not divide, every rank holding every row and a
    quarter of the positions; the engine on 2 slots."""
    from repro_torch.launch.mesh import lm_device_mesh
    mesh = lm_device_mesh(4, 1)
    out = {}
    for name in inputs["seq names"]:
        lm, p = model(inputs, name, mesh)
        batch = inputs["batches"][name]
        pieces = {}
        for b in (1, 2, 4):
            node = lm.init_cache(b, MAX_SEQ, "cpu")
            for k in inputs["kv path"][name]:
                node = node[k]
            pieces[b] = tuple(node["k"].shape)
        out[name] = {
            "pieces": pieces,
            "decode": {b: decodes(lm, p, inputs, batch, b) for b in (1, 2)},
            "engine": engine_tokens(lm, p, inputs, 2)}
    for name in inputs.get("long names", ()):
        # the audio family at batch 1: its cross cache's positions cut
        # over "data" as its self cache's are
        lm, p = model(inputs, name, mesh)
        long = inputs["long"][name]
        cross = {"init": shapes(lm.init_cache(1, LONG_SEQ, "meta")),
                 "prefill": shapes(lm.prefill(
                     p, {"tokens": torch.zeros((1, 8), dtype=torch.long),
                         **extras(long, 0, 1)}, LONG_SEQ,
                     global_batch=1)[1])}
        out[name] = {"cross": cross,
                     "decode": decodes(lm, p, inputs, long, 1, LONG_SEQ),
                     "decode 32": decodes(lm, p, inputs,
                                          inputs["batches"][name], 1)}
    out["layouts"] = layouts(mesh)
    return out


def compress4(tmp: Path, inputs: dict) -> dict:
    """``compressed_psum`` over the world's group, rank r's gradients and
    residuals row r of the inputs': the mean, every rank's new residuals
    (gathered) and ``wire_bytes``."""
    import torch.distributed as dist
    from repro_torch.sharding import comm
    from repro_torch.train import compression as C
    r = dist.get_rank()
    g = {k: torch.from_numpy(v[r]) for k, v in inputs["grads"].items()}
    res = {k: torch.from_numpy(v[r]) for k, v in inputs["residuals"].items()}
    mean, new = C.compressed_psum(g, res, dist.group.WORLD)
    return {"mean": _tree_np(mean),
            "res": {k: _np(comm.all_gather(v[None], 0, dist.group.WORLD))
                    for k, v in new.items()},
            "wire": C.wire_bytes(g)}


def _same(a, b, what: str) -> None:
    """Every rank's results equal rank 0's, bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def entry(rank: int, world: int, name: str, tmp: str) -> None:
    """One rank of world ``name``."""
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_mod
    tmp = Path(tmp)
    inputs = pickle.loads((tmp / "inputs.pkl").read_bytes())
    mesh_mod.init_distributed("cpu", rank=rank, world_size=world,
                              init_method=f"file://{tmp / (name + '.pg')}")
    try:
        out = globals()[name](tmp, inputs)
        (tmp / f"{name}.{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        mesh_mod.shutdown()


def results(tmp: Path, name: str, world: int) -> dict:
    """Rank 0's results, after checking every rank's against them."""
    got = [pickle.loads((tmp / f"{name}.{r}.pkl").read_bytes())
           for r in range(world)]
    for r in range(1, world):
        _same(got[0], got[r], f"{name}: rank {r} vs rank 0")
    return got[0]


def spawn(tmp: Path, name: str, world: int):
    """Start world ``name`` of ``world`` ranks without waiting for it."""
    import torch.multiprocessing as mp
    return mp.spawn(entry, args=(world, name, str(tmp)), nprocs=world,
                    join=False)


def wait(ctx, seconds: float = 600.0) -> None:
    """Join a spawned world (a rank's exception is raised here); a world
    still running after ``seconds`` is killed and fails."""
    import time
    deadline = time.monotonic() + seconds
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"a spawned world ran past {seconds} s")


# -- JAX's own mesh on 4 host devices ---------------------------------------------

JAX_SERVE_SCRIPT = r"""
import contextlib, pickle, sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, @SRC@)
from repro.configs import smoke_config
from repro.launch.mesh import mesh_with_auto_axes
from repro.launch.specs import cache_shardings
from repro.models.model import LM
from repro.serve.engine import Request, ServeEngine
from repro.sharding import rules as R

assert jax.device_count() == 4, jax.device_count()
inp = pickle.loads(open(sys.argv[1], "rb").read())
out = {}
for case in inp["cases"]:
    name, rows, ms = case["name"], case["rows"], case["max_seq"]
    cfg = smoke_config(case["arch"]).replace(**case["kw"])
    if case["mesh"] is None:        # one device, no mesh
        mesh, lm = contextlib.nullcontext(), LM(cfg)
        jp = jax.tree.map(jnp.asarray, case["params"])
        cs = None
    else:
        mesh = mesh_with_auto_axes(
            np.asarray(jax.devices()).reshape(case["mesh"]), ("data", "model"))
        lm = LM(cfg, mesh)
        shard = R.param_shardings(lm.param_defs(), mesh, cfg.fsdp_over_pod,
                                  cfg.parallelism)
        jp = jax.tree.map(lambda a, s: jax.device_put(jnp.asarray(a), s),
                          case["params"], shard)
        cs = cache_shardings(lm, rows, ms, mesh)
    tok = jnp.asarray(inp["decode_tokens"][:rows], jnp.int32)
    more = {k: jnp.asarray(v[:rows]) for k, v in case["extras"].items()}
    with mesh:
        prefill = jax.jit(lm.prefill, static_argnums=(2,))
        decode = jax.jit(lm.decode)
        for t0 in (0, 8):
            if t0 == 0:
                cache = lm.init_cache(rows, ms)
            else:
                lg, cache = prefill(jp, {"tokens": tok[:, :t0], **more}, ms)
                out[name + "/prefill"] = np.asarray(lg, np.float32)
            for i in range(t0, t0 + 3):
                if cs is not None:
                    cache = jax.device_put(cache, cs)
                lg, cache = decode(jp, tok[:, i:i + 1], cache, jnp.int32(i))
                out[f"{name}/decode/{i}"] = np.asarray(lg, np.float32)
        if case["engine"]:
            reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                            max_new_tokens=inp["new"])
                    for i, p in enumerate(inp["prompts"])]
            ServeEngine(lm, jp, inp["slots"], ms).run(reqs)
            out[name + "/tokens"] = np.asarray([r.out_tokens for r in reqs])
np.savez(sys.argv[2], **out)
print("SERVE-REFERENCE-DONE")
"""


def jax_serve(tmp: Path, cases: list, inputs: dict):
    """Start JAX's prefill, decodes (as ``decodes``) and engine of each
    case on its own (data, model) mesh of 4 host devices, the parameters
    placed by JAX's ``param_shardings`` and the cache by its
    ``cache_shardings`` (a case whose mesh is None: on one device), in
    one subprocess; ``jax_serve_results`` reads them."""
    import os
    import subprocess
    import sys
    root = Path(__file__).resolve().parents[1]
    (tmp / "serve_in.pkl").write_bytes(pickle.dumps(
        {"cases": cases, "decode_tokens": inputs["decode_tokens"],
         "prompts": inputs["prompts"], "new": NEW, "slots": SLOTS}))
    env = dict(os.environ)
    env.pop("REPRO_FAKE_DEVICES", None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    script = JAX_SERVE_SCRIPT.replace("@SRC@", repr(str(root / "src")))
    return subprocess.Popen(
        [sys.executable, "-c", script, str(tmp / "serve_in.pkl"),
         str(tmp / "serve_ref.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(root))


def jax_serve_results(tmp: Path, proc) -> dict:
    """Wait for ``jax_serve``'s subprocess: {case: {"prefill", decode
    positions, "tokens"}}."""
    try:
        log, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "SERVE-REFERENCE-DONE" in log, log
    out: dict = {}
    with np.load(tmp / "serve_ref.npz") as z:
        for k in z.files:
            case, *what = k.split("/")
            key = (int(what[1]) if what[0] == "decode" else what[0])
            out.setdefault(case, {})[key] = (z[k].tolist() if key == "tokens"
                                             else z[k])
    return out
