"""The port's episode stages against the JAX package on the same inputs:
weights, scene synthesis, detector, connected components, ROIDet, codec,
utility MLP, elastic controller and the per-method control step."""
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.core import cc as j_cc  # noqa: E402
from repro.core import codec as j_codec  # noqa: E402
from repro.core import elastic as j_elastic  # noqa: E402
from repro.core import fleet as j_fleet  # noqa: E402
from repro.core import roidet as j_roidet  # noqa: E402
from repro.core import utility as j_util  # noqa: E402
from repro.data import synthetic as j_synth  # noqa: E402
from repro.models import detector as j_det  # noqa: E402
from repro_torch.ckpt import checkpoint as t_ckpt  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.common.convert import params_from_numpy  # noqa: E402
from repro_torch.core import cc as t_cc  # noqa: E402
from repro_torch.core import codec as t_codec  # noqa: E402
from repro_torch.core import elastic as t_elastic  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import roidet as t_roidet  # noqa: E402
from repro_torch.core import utility as t_util  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.models import detector as t_det  # noqa: E402

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts"


def _jax_detector(variant):
    target = jax.tree.map(
        lambda d: jax.ShapeDtypeStruct(d.shape, d.dtype),
        j_det.detector_defs(variant),
        is_leaf=lambda x: hasattr(x, "logical_axes"))
    return j_ckpt.restore(ARTIFACTS / f"detector_{variant}", target)


@pytest.fixture(scope="module")
def weights():
    """{variant: (jax params, port params)} from the committed checkpoints."""
    out = {}
    for v in ("light", "server"):
        pj, _ = _jax_detector(v)
        out[v] = (pj, t_det.load_detector(v, "cpu"))
    return out


def _scene_frames(seed=33, C=3, t=2):
    cfg = t_synth.SceneConfig(seed=seed, num_cameras=C)
    sc = t_synth.DeviceScene(cfg, device="cpu")
    return t_synth.segments_device(cfg, sc.params, sc.key, t, gt_pad=sc.G)


# -- weights ----------------------------------------------------------------

@pytest.mark.parametrize("variant", ["light", "server"])
def test_checkpoint_restore_matches_jax(variant):
    pj, mj = _jax_detector(variant)
    pt, mt = t_ckpt.restore(ARTIFACTS / f"detector_{variant}")
    assert sorted(pt) == sorted(pj) and mt["step"] == mj["step"]
    for k in pj:
        np.testing.assert_array_equal(np.asarray(pj[k]), pt[k], err_msg=k)
    conv = params_from_numpy(pt, "detector", device="cpu")
    np.testing.assert_array_equal(conv["c2"].numpy(),
                                  np.transpose(pt["c2"], (3, 2, 0, 1)))


def test_checkpoint_crc_checked(tmp_path):
    """A format-2 checkpoint (per-leaf crc32) restores, and a flipped
    payload byte is caught."""
    tree = {"a": jnp.arange(6, dtype=jnp.float32), "b": jnp.ones((2, 3))}
    j_ckpt.save(tree, tmp_path / "ck", step=3)
    got, meta = t_ckpt.restore(tmp_path / "ck")
    assert meta["step"] == 3
    np.testing.assert_array_equal(got["a"], np.arange(6, dtype=np.float32))
    data = next((tmp_path / "ck").glob("data.*.bin"))
    raw = bytearray(data.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    data.write_bytes(bytes(raw))
    with pytest.raises(t_ckpt.CheckpointCorruptError):
        t_ckpt.restore(tmp_path / "ck")


# -- scene synthesis --------------------------------------------------------

@pytest.mark.parametrize("seed,C", [(0, 3), (33, 5), (101, 4)])
def test_segments_device_bitwise(seed, C):
    jc = j_synth.SceneConfig(seed=seed, num_cameras=C)
    tc = t_synth.SceneConfig(**dataclasses.asdict(jc))
    js = j_synth.DeviceScene(jc)
    ts = t_synth.DeviceScene(tc, device="cpu")
    assert ts.G == js.G
    for t in (0, 4, 17):
        fj, bj, vj = j_synth._segments_device_jit(jc, js.params, js.key, t,
                                                  js.G)
        ft, bt, vt = t_synth.segments_device(tc, ts.params, ts.key, t,
                                             gt_pad=ts.G)
        np.testing.assert_array_equal(np.asarray(fj).view(np.int32),
                                      ft.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
        np.testing.assert_array_equal(np.asarray(vj), vt.numpy())


def test_bandwidth_trace_matches():
    for kind in ("low", "medium", "high"):
        np.testing.assert_array_equal(j_synth.bandwidth_trace(kind, 9, 3),
                                      t_synth.bandwidth_trace(kind, 9, 3))


# -- detector ---------------------------------------------------------------

@pytest.mark.parametrize("variant", ["light", "server"])
def test_detector_forward_and_decode(weights, variant):
    """Forward <= 1e-5 (convolution sums run in another order); decoded
    valid sets equal, boxes <= 1e-4 px."""
    pj, pt = weights[variant]
    frames = _scene_frames()[0].reshape(-1, 96, 160)[::4]
    gj = jax.jit(j_det.forward)(pj, jnp.asarray(frames.numpy()))
    gt = t_det.forward(pt, frames)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-5)
    bj, sj, vj = jax.jit(functools.partial(j_det.decode_boxes,
                                           conf_thresh=0.25))(gj)
    bt, st, vt = t_det.decode_boxes(gt, conf_thresh=0.25)
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-4)


def test_top_k_and_f1_ties():
    """Lowest index first among equal scores; greedy F1 equal on padded
    GT with unmatched (-1) ties."""
    x = torch.tensor([[3.0, 5, 5, 1, 5]])
    _, idx = t_det.top_k(x, 3)
    _, idx_j = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    rng = np.random.default_rng(3)
    B, K, G = 12, 16, 16
    xy = rng.uniform(0, 140, (B, K, 2)).astype(np.float32)
    pb = np.concatenate([xy, xy + rng.uniform(4, 30, (B, K, 2))], -1)
    gxy = np.round(rng.uniform(0, 140, (B, G, 2))).astype(np.float32)
    gb = np.concatenate([gxy, gxy + np.round(rng.uniform(4, 30, (B, G, 2)))],
                        -1).astype(np.float32)
    gb[:, G // 2:] = pb[:, :G // 2]          # exact matches -> IoU ties
    pv = rng.uniform(size=(B, K)) < 0.6
    gv = rng.uniform(size=(B, G)) < 0.5
    pv[0], gv[0] = False, False              # both empty -> 1
    want = jax.jit(j_det.f1_score_batch)(*map(jnp.asarray, (pb, pv, gb, gv)))
    got = t_det.f1_score_batch(*map(torch.from_numpy, (pb, pv, gb, gv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# -- connected components + ROIDet ------------------------------------------

def test_label_and_boxes_exact():
    rng = np.random.default_rng(0)
    masks = [rng.uniform(size=(12, 20)) < p for p in (0.1, 0.3, 0.55)]
    tie = np.zeros((12, 20), bool)
    tie[::2, ::2] = True                      # 60 one-block components
    tie[5:7, 0:20] = True                     # plus one long bar
    masks += [tie, np.zeros((12, 20), bool), np.ones((12, 20), bool)]
    m = np.stack(masks)
    fn = jax.jit(jax.vmap(functools.partial(j_cc.label_and_boxes,
                                            max_boxes=16)))
    bj, vj, lj = fn(jnp.asarray(m))
    bt, vt, lt = t_cc.label_and_boxes(torch.from_numpy(m), max_boxes=16)
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())


def test_roidet_fleet_matches(weights):
    """Mask exact, area and confidence <= 1e-6 (JAX kernel path in
    interpret mode, as the JAX tests run it)."""
    pj, pt = weights["light"]
    for seed, t in ((33, 2), (5, 9)):
        frames = _scene_frames(seed=seed, C=4, t=t)[0]
        fn = jax.jit(functools.partial(
            j_roidet._roidet_fleet_impl, block_size=8,
            motion_thresh=j_roidet.MOTION_THRESH,
            edge_thresh=j_roidet.EDGE_THRESH,
            conf_thresh=j_roidet.CONF_THRESH, use_kernel=True,
            max_boxes=j_roidet.MAX_BOXES))
        rj = fn(jnp.asarray(frames.numpy()), pj)
        rt = t_roidet.roidet_fleet(
            frames, pt, block_size=8, motion_thresh=t_roidet.MOTION_THRESH,
            edge_thresh=t_roidet.EDGE_THRESH,
            conf_thresh=t_roidet.CONF_THRESH, max_boxes=t_roidet.MAX_BOXES)
        np.testing.assert_array_equal(np.asarray(rj.mask), rt.mask.numpy())
        np.testing.assert_array_equal(np.asarray(rj.motion_boxes),
                                      rt.motion_boxes.numpy())
        np.testing.assert_allclose(rt.area_ratio.numpy(),
                                   np.asarray(rj.area_ratio), atol=1e-6)
        np.testing.assert_allclose(rt.confidence.numpy(),
                                   np.asarray(rj.confidence), atol=1e-6)


def test_crop_to_mask():
    """Non-ROI fill is the frame mean: XLA and PyTorch sum in another
    order, so <= 1e-6 (3e-7 relative measured)."""
    frames = _scene_frames(C=2)[0]
    rng = np.random.default_rng(2)
    masks = rng.uniform(size=(2, 12, 20)) < 0.4
    want = jax.vmap(lambda f, m: j_roidet.crop_to_mask(f, m, 8))(
        jnp.asarray(frames.numpy()), jnp.asarray(masks))
    got = t_roidet.crop_to_mask(frames, torch.from_numpy(masks), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# -- codec ------------------------------------------------------------------

def test_encode_segment_oracle():
    """The port's per-camera oracle vs ``codec.encode_segment``: <= 1e-6
    (sigma's exp and XLA's fusion of the noise add may differ by an ulp)."""
    frames = _scene_frames(C=1)[0][0]
    cfg_j, cfg_t = j_codec.CodecConfig(), t_codec.CodecConfig()
    for roi, b, r, n in ((15360.0, 200.0, 1.0, 10.0),
                         (6000.0, 1000.0, 0.75, 4.0),
                         (9000.0, 50.0, 0.5, 1.0)):
        kj = jax.random.fold_in(jax.random.PRNGKey(4), int(b))
        kt = prng.fold_in(prng.PRNGKey(4), int(b))
        dj, sj = j_codec.encode_segment(
            cfg_j, jnp.asarray(frames.numpy()), jnp.float32(roi),
            jnp.float32(b), jnp.float32(r), kj, num_frames=jnp.float32(n))
        dt, st = t_codec.encode_segment(cfg_t, frames, roi, b, r, kt,
                                        num_frames=n)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)
        assert float(st) == float(sj)


# -- control ----------------------------------------------------------------

def test_utility_mlp_init_and_table():
    pj = j_util.init_utility_mlp(jax.random.PRNGKey(0))
    pt = t_util.init_utility_mlp(prng.PRNGKey(0))
    for k in pj:
        np.testing.assert_array_equal(np.asarray(pj[k]), pt[k].numpy())
    rng = np.random.default_rng(1)
    a, c = rng.uniform(size=(2, 5)).astype(np.float32)
    br = np.asarray((50, 100, 200, 400, 800, 1000), np.float32)
    rs = np.asarray((1.0, 0.75, 0.5), np.float32)
    lam = np.ones(5, np.float32)
    uj, rj = j_util.utility_table(pj, *map(jnp.asarray, (a, c, br, rs, lam)))
    ut, rt = t_util.utility_table(pt, *map(torch.from_numpy,
                                           (a, c, br, rs, lam)))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-6)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


def _jax_control(method, **statics):
    return jax.jit(functools.partial(j_fleet._control_impl, method=method,
                                     **statics))


@pytest.mark.parametrize("method", ["deepstream", "jcab", "reducto",
                                    "static"])
def test_control_step_matches(method):
    """Picks, b and r exact; the (extra, area, alloc, feasible) pack
    <= 1e-5; the elastic state threaded over the slots <= 1e-5."""
    C = 5
    br = (50, 100, 200, 400, 800, 1000)
    rs = (1.0, 0.75, 0.5)
    w_cap = 255
    statics = dict(ecfg=j_elastic.ElasticConfig(), bitrates=br,
                   resolutions=rs, slot_seconds=1.0,
                   use_elastic=method == "deepstream", w_cap=w_cap,
                   num_cams=C)
    fn = _jax_control(method, use_kernel=False, **statics)
    rng = np.random.default_rng(7)
    mlp_j = j_util.init_utility_mlp(jax.random.PRNGKey(0))
    mlp_t = t_util.init_utility_mlp(prng.PRNGKey(0))
    jt = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(np.float32)
    ju = np.repeat(jt.max(-1)[None], C, 0).astype(np.float32)
    jr = np.repeat(np.asarray(rs, np.float32)[jt.argmax(-1)][None], C, 0)
    lam = np.ones(C, np.float32)
    est_j = j_elastic.init_state_jax()
    est_t = t_elastic.init_state("cpu")
    tau = (np.float32(300.0), np.float32(2500.0))
    live_prev = np.ones(C, bool)
    for W in (1134.0, 80.0, 400.0, 0.0, 2900.0, 3400.0, 240.0, 700.0):
        a, c = rng.uniform(0.05, 0.6, (2, C)).astype(np.float32)
        live = rng.uniform(size=C) < 0.8
        live[0] = True
        rec = bool((live & ~live_prev).any())
        W32 = np.float32(W)
        oj = fn(mlp_j, jnp.asarray(ju), jnp.asarray(jr), jnp.asarray(lam),
                jnp.asarray(a), jnp.asarray(c), W32, est_j, tau[0], tau[1],
                jnp.asarray(live), jnp.asarray(rec))
        ot = t_fleet.fleet_control_step(
            mlp_t, torch.from_numpy(ju), torch.from_numpy(jr),
            torch.from_numpy(lam), torch.from_numpy(a), torch.from_numpy(c),
            torch.tensor(W32), est_t, torch.tensor(tau[0]),
            torch.tensor(tau[1]), torch.from_numpy(live), torch.tensor(rec),
            method=method, tables=t_codec.device_tables(br, rs, "cpu"),
            **statics)
        np.testing.assert_array_equal(np.asarray(oj.b), ot.b.numpy())
        np.testing.assert_array_equal(np.asarray(oj.r), ot.r.numpy())
        np.testing.assert_allclose(ot.pack.numpy(), np.asarray(oj.pack),
                                   rtol=0, atol=1e-5 * max(1.0, W))
        for x, y in zip(oj.est[:3], ot.est[:3]):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5)
        est_j, est_t, live_prev = oj.est, ot.est, live


def test_keep_selection_matches():
    rng = np.random.default_rng(5)
    keep = rng.uniform(size=(6, 10)) < 0.4
    keep[:, 0] |= ~keep.any(axis=1)
    keep[1] = True
    keep[2] = False
    keep[2, 3] = True
    sj = j_fleet.keep_selection(jnp.asarray(keep), 4)
    st = t_fleet.keep_selection(torch.from_numpy(keep), 4)
    for name in sj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(sj, name)),
                                      getattr(st, name).numpy(),
                                      err_msg=name)
