"""The port's kernel modules: plain versions against the JAX package's
kernels (run in Pallas interpret mode, as the JAX tests run them) and
oracles, the CPU/CUDA dispatch rule, and — on a machine with a card — each
CUDA kernel against its plain version."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

from repro.core import codec as j_codec  # noqa: E402
from repro.kernels.edge_motion import ops as j_em  # noqa: E402
from repro.kernels.flash_decode import ops as j_fd  # noqa: E402
from repro.kernels.flash_decode.flash_decode import \
    flash_decode_pallas  # noqa: E402
from repro.models.attention import \
    decode_attention_with_new as j_decode_with_new  # noqa: E402
from repro.kernels.tx_codec import ops as j_tx  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.core import codec as t_codec  # noqa: E402
from repro_torch.data import synthetic as t_synth  # noqa: E402
from repro_torch.kernels.edge_motion import ops as t_em  # noqa: E402
from repro_torch.kernels.edge_motion import ref as t_em_ref  # noqa: E402
from repro_torch.kernels.flash_decode import ops as t_fd  # noqa: E402
from repro_torch.kernels.flash_decode import ref as t_fd_ref  # noqa: E402
from repro_torch.kernels.knapsack_dp import ops as t_dp  # noqa: E402
from repro_torch.kernels.knapsack_dp import ref as t_dp_ref  # noqa: E402
from repro_torch.kernels.tx_codec import ops as t_tx  # noqa: E402
from repro_torch.kernels.tx_codec import ref as t_tx_ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402


def _frames(C, M, H=96, W=160, seed=0, kind="scene"):
    if kind == "uniform":
        return np.random.default_rng(seed).uniform(0, 1, (C, M, H, W)).astype(
            np.float32)
    cfg = t_synth.SceneConfig(seed=seed, num_cameras=C, height=H, width=W)
    sc = t_synth.DeviceScene(cfg, device="cpu")
    fr = [t_synth.segments_device(cfg, sc.params, sc.key, t, gt_pad=sc.G)[0]
          for t in (1, 2)]
    return torch.cat(fr, dim=1)[:, :M].numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# -- edge_motion ------------------------------------------------------------

@pytest.mark.parametrize("C,M,H,W,bs,kind", [
    (3, 10, 96, 160, 8, "scene"),       # ROIDet pairs
    (3, 11, 96, 160, 8, "scene"),       # reducto: reference + N frames
    (2, 4, 96, 160, 8, "uniform"),
    (2, 3, 32, 64, 16, "uniform"),
])
def test_edge_motion_plain_matches_jax(C, M, H, W, bs, kind):
    """Exact: the scores are counts of booleans."""
    fr = _frames(C, M, H, W, kind=kind)
    got = t_em.segment_motion_fleet(torch.from_numpy(fr), block_size=bs,
                                    edge_thresh=0.35).numpy()
    for use_kernel in (True, False):
        want = j_em._segment_motion_fleet_impl(
            jnp.asarray(fr), block_size=bs, edge_thresh=0.35, tile_rows=None,
            use_kernel=use_kernel)
        np.testing.assert_array_equal(got, np.asarray(want))


def _popcount(x: np.ndarray) -> np.ndarray:
    """Set bits of each uint64."""
    x = x.astype(np.uint64)
    n = np.zeros(x.shape, np.int64)
    while np.any(x):
        n += (x & np.uint64(1)).astype(np.int64)
        x = x >> np.uint64(1)
    return n


def _edge_motion_grid(C: int, M: int, H: int, W: int, bs: int,
                      launch_plan):
    """The kernel's blocks under ``launch_plan`` as ``edge_motion_launch``
    sizes the grid and ``edge_motion_kernel`` decodes ``blockIdx``: per
    block (c, band, bx0, nbx, p0, np), its camera, band, first output
    block and output blocks of its column segment, first pair and pairs of
    its chunk."""
    seg_blocks, ppc = launch_plan
    nb = W // bs
    nseg = (nb + seg_blocks - 1) // seg_blocks
    nchunk = (M - 1 + ppc - 1) // ppc
    for bx in range(nseg * (H // bs)):
        for by in range(C * nchunk):
            seg, band = bx % nseg, bx // nseg
            c, chunk = by // nchunk, by % nchunk
            bx0 = seg * seg_blocks
            p0 = chunk * ppc
            yield (c, band, bx0, min(seg_blocks, nb - bx0), p0,
                   min(ppc, M - 1 - p0))


def _edge_motion_word_model(frames: np.ndarray, bs: int, thr: float,
                            launch_plan) -> np.ndarray:
    """The CUDA kernel's bit layout, in numpy: per block of the launch
    (``_edge_motion_grid``), each frame's band edge map packed into 32-bit
    ballot words (bit l of word k = column x0 + 32 k + l of the segment,
    zero past its end), XOR of consecutive frames' words, and per output
    block the popcount of its bs bits of each row, funnel-shifted out of
    two words where it straddles them.  Every output must be written by
    exactly one block."""
    C, M, H, W = frames.shape
    nb, nbands = W // bs, H // bs
    edges = (t_em_ref.sobel_mag2(torch.from_numpy(frames))
             > t_em_ref.edge_thresh2(thr)).numpy()
    out = np.full((C, M - 1, nbands, nb), -1.0, np.float32)
    lanes = np.arange(32, dtype=np.uint64)
    mask = np.uint64((1 << bs) - 1)
    for c, band, bx0, nbx, p0, npairs in _edge_motion_grid(
            C, M, H, W, bs, launch_plan):
        x0, x1 = bx0 * bs, (bx0 + nbx) * bs
        nw = -(-(x1 - x0) // 32)
        bits = np.zeros((npairs + 1, bs, nw * 32), bool)
        bits[..., :x1 - x0] = edges[c, p0:p0 + npairs + 1,
                                    band * bs:(band + 1) * bs, x0:x1]
        words = (bits.reshape(npairs + 1, bs, nw, 32).astype(np.uint64)
                 << lanes).sum(-1)
        diff = words[:-1] ^ words[1:]                  # (pairs, bs, nw)
        diff = np.concatenate(
            [diff, np.zeros(diff.shape[:2] + (1,), np.uint64)], axis=2)
        for j in range(nbx):
            lo = j * bs
            k0, off = lo >> 5, lo & 31
            d0 = diff[..., k0]
            d1 = diff[..., k0 + 1] if off + bs > 32 else 0 * d0
            funnel = ((d1 << np.uint64(32)) | d0) >> np.uint64(off)
            cnt = _popcount(funnel & mask).sum(axis=1)
            dst = out[c, p0:p0 + npairs, band, bx0 + j]
            assert np.all(dst == -1.0), "written twice"
            out[c, p0:p0 + npairs, band, bx0 + j] = cnt
    assert np.all(out >= 0.0), "an output block no block wrote"
    return out


@pytest.mark.parametrize("bs", [2, 6, 8, 16])
def test_edge_motion_bit_words_match_plain_and_jax(bs):
    """The kernel's word-level arithmetic (ballot words, XOR, a funnel-
    shifted popcount per block: bs = 6 straddles words in the whole-row
    segment) under the launch plan, whole-row segments and chunks of two
    pairs, against the plain version and the JAX package's fleet motion
    (Pallas kernel in interpret mode, and its reference): exact."""
    C, M, H, W = 2, 5, 48, 96
    fr = _frames(C, M, H, W, seed=bs, kind="uniform")
    fr[1, 2:] = fr[1, 1]          # a still camera: XOR words of zero
    want = t_em_ref.segment_motion_ref(torch.from_numpy(fr), block_size=bs,
                                       edge_thresh=0.35).numpy()
    for use_kernel in (True, False):
        np.testing.assert_array_equal(want, np.asarray(
            j_em._segment_motion_fleet_impl(
                jnp.asarray(fr), block_size=bs, edge_thresh=0.35,
                tile_rows=None, use_kernel=use_kernel)))
    nb = W // bs
    for launch_plan in (t_em.plan(C, M, H, W, bs, 132), (nb, M - 1), (nb, 2),
                        (max(1, nb // 3), 3)):
        got = _edge_motion_word_model(fr, bs, 0.35, launch_plan)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sms", [132, 114])     # H100 SXM and PCIe
def test_edge_motion_plan_covers_every_block_once(sms):
    """Every (camera, pair, band, column block) is written by exactly one
    block of the launch, as the kernel decodes its grid
    (``_edge_motion_grid``); each block's staged columns (the segment, one
    halo column each side, widened to 4-column bounds) fit its row stride,
    and shared memory stays within a block's 227 KB for W up to 1920 and M
    up to 31, and past a thousand frames of a narrow W (chunks of hundreds
    of frames); all pairs share one chunk wherever the frames fit; at the
    main path's shapes the plan is the one with the least work on the
    busiest SM: 80-column segments (120 blocks at C = 5, 384 at C = 16)."""
    for C, M, H, W, bs in ((5, 10, 96, 160, 8), (5, 11, 96, 160, 8),
                           (16, 10, 96, 160, 8), (2, 5, 36, 54, 6),
                           (2, 4, 32, 90, 2), (1, 2, 8, 160, 8),
                           (1, 31, 1080, 1920, 8), (1, 31, 1088, 1920, 16),
                           (1, 31, 1088, 1920, 32), (3, 31, 544, 960, 16),
                           (1, 64, 1088, 1920, 32), (1, 31, 1080, 1920, 1),
                           (40, 3, 64, 64, 32), (1, 150, 16, 32, 8),
                           (2, 1000, 16, 4, 4)):
        seg, ppc = t_em.plan(C, M, H, W, bs, sms)
        nb, nbands = W // bs, H // bs
        assert 1 <= seg <= nb and 1 <= ppc <= M - 1
        assert t_em.smem_bytes(bs, seg, ppc) <= t_em.MAX_SMEM_BYTES
        sw = (seg * bs + 8 + 3) // 4 * 4
        cover = np.zeros((C, M - 1, nbands, nb), np.int64)
        for c, band, bx0, nbx, p0, npairs in _edge_motion_grid(
                C, M, H, W, bs, (seg, ppc)):
            assert nbx >= 1 and npairs >= 1
            x0, x1 = bx0 * bs, (bx0 + nbx) * bs
            ca = max(x0 - 1, 0) & ~3
            cb = min((min(x1 + 1, W) + 3) & ~3, W)
            assert ca <= max(x0 - 1, 0) and cb >= min(x1 + 1, W)
            assert cb - ca <= sw
            cover[c, p0:p0 + npairs, band, bx0:bx0 + nbx] += 1
        assert np.all(cover == 1), (C, M, H, W, bs)
        narrowest = max(1, min(nb, 32 // bs))
        if t_em.smem_bytes(bs, narrowest, M - 1) <= t_em.MAX_SMEM_BYTES:
            assert ppc == M - 1, (C, M, H, W, bs)
    if sms == 132:
        assert t_em.plan(5, 10, 96, 160, 8, sms) == (10, 9)
        assert t_em.plan(5, 11, 96, 160, 8, sms) == (10, 10)
        assert t_em.plan(16, 10, 96, 160, 8, sms) == (10, 9)
    assert t_em.plan(1, 64, 1088, 1920, 32, sms) == (1, 40)
    assert t_em.plan(2, 1000, 16, 4, 4, sms) == (1, 744)


def test_edge_motion_detects_motion():
    f0 = np.full((64, 64), 0.4, np.float32)
    f1 = f0.copy()
    f1[16:32, 16:32] = 0.9
    pair = torch.from_numpy(np.stack([f0, f1])[None])
    sc = t_em_ref.segment_motion_ref(pair, block_size=8, edge_thresh=0.35)
    assert float(sc[0, 0, 2:4, 2:4].max()) > 4
    still = t_em_ref.segment_motion_ref(
        torch.from_numpy(np.stack([f0, f0])[None]), block_size=8,
        edge_thresh=0.35)
    assert float(still.max()) == 0.0


# -- tx_codec ---------------------------------------------------------------

# pool factors 1, 2, 4 and mixed; 96x160 frames, then frame sizes that are
# multiples of neither 4 nor the pool factor (edge-padded tails)
TX_RES = {"k1": (1.0, 1.0, 1.0), "k2": (0.75, 0.75, 0.75),
          "k4": (0.5, 0.5, 0.5), "mixed": (1.0, 0.74, 0.5)}
TX_CASES = ([pytest.param(r, (96, 160), id=f"res{i}")
             for i, r in enumerate(TX_RES.values())]
            + [pytest.param(r, hw, id=f"{name}-{hw[0]}x{hw[1]}")
               for hw in ((37, 45), (101, 157))
               for name, r in TX_RES.items()])


@pytest.mark.parametrize("res,hw", TX_CASES)
def test_tx_codec_plain_matches_jax(res, hw):
    """Port ``encode_fleet`` vs the JAX ``encode_fleet`` with identical
    keys: <= 1e-6 against the Pallas kernel and its vmapped oracle (the
    JAX kernel's own allowance, for a fused noise add)."""
    C = 3
    fr = (_frames(C, 10, seed=4) if hw == (96, 160)
          else _frames(C, 4, *hw, seed=4, kind="uniform"))
    roi = np.asarray([15360, 9000, 4000], np.float32)
    b = np.asarray([50, 400, 1000], np.float32)
    r = np.asarray(res, np.float32)
    n = np.minimum(np.asarray([10, 3, 7], np.float32), fr.shape[1])
    kj = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(5), i))(
        jnp.arange(C))
    kt = prng.fold_in(prng.PRNGKey(5), torch.arange(C))
    dt, st = t_tx.encode_fleet(t_codec.CodecConfig(), torch.from_numpy(fr),
                               *map(torch.from_numpy, (roi, b, r)), kt,
                               torch.from_numpy(n))
    for use_kernel in (True, False):
        dj, sj = j_tx.encode_fleet(j_codec.CodecConfig(), jnp.asarray(fr),
                                   *map(jnp.asarray, (roi, b, r)), kj,
                                   jnp.asarray(n), use_kernel=use_kernel)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("blur,with_res", [(True, True), (False, True),
                                           (True, False)])
def test_tx_codec_crf_matches_jax(blur, with_res):
    """CRF-mode fleet encode against the JAX ``encode_fleet_crf`` through
    its Pallas kernel (interpret mode) and its oracle: decoded frames
    <= 1e-6, sizes exact.  ``blur=False`` and ``res=None`` take the
    identity branch for every camera."""
    C = 3
    fr = _frames(C, 10, seed=6)
    roi = np.asarray([15360, 7000, 2500], np.float32)
    r = np.asarray([1.0, 0.74, 0.5], np.float32)
    n = np.asarray([10, 4, 7], np.float32)
    kj = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(9), i))(
        jnp.arange(C))
    kt = prng.fold_in(prng.PRNGKey(9), torch.arange(C))
    dt, st = t_tx.encode_fleet_crf(
        t_codec.CodecConfig(), torch.from_numpy(fr), torch.from_numpy(roi),
        kt, torch.from_numpy(r) if with_res else None, torch.from_numpy(n),
        blur=blur)
    for use_kernel in (True, False):
        if not use_kernel and not blur and with_res:
            continue   # the JAX oracle has no blur switch
        dj, sj = j_tx.encode_fleet_crf(
            j_codec.CodecConfig(), jnp.asarray(fr), jnp.asarray(roi), kj,
            jnp.asarray(r) if with_res else None, jnp.asarray(n), blur=blur,
            use_kernel=use_kernel)
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # the per-camera plain CRF encode agrees with the fleet one
    for c in range(C):
        if not blur and with_res:
            break
        dc, sc = t_codec.encode_segment_crf(
            t_codec.CodecConfig(), torch.from_numpy(fr[c]), float(roi[c]),
            kt[c], float(r[c]) if with_res else None, float(n[c]))
        np.testing.assert_allclose(dc.numpy(), dt[c].numpy(), rtol=0,
                                   atol=1e-6)
        assert float(sc) == float(st[c])


# -- flash_decode -----------------------------------------------------------

# the shapes of tests/test_kernels.py::test_flash_decode_matches_oracle
# (with its block size), one more with G = 1, then the GQA groups and head
# sizes of the configs at small S: G = 7 at hd 128 (yi-34b), G = 16 at
# hd 64 (llama3-405b's group), G = 1 at hd 112 (zamba2)
FD_SHAPES = [(2, 256, 8, 2, 64, 64, "f32"), (1, 512, 16, 4, 128, 128, "f32"),
             (3, 128, 8, 8, 32, 64, "f32"), (2, 256, 8, 2, 64, 64, "bf16"),
             (2, 192, 4, 4, 16, 64, "f32"), (1, 128, 14, 2, 128, 64, "f32"),
             (1, 128, 32, 2, 64, 64, "f32"), (2, 64, 4, 4, 112, 64, "f32"),
             (1, 128, 14, 2, 128, 64, "bf16")]
FD_DT = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16)}


def _fd_inputs(B, S, H, KV, hd, seed=0):
    r = np.random.default_rng(seed)
    return [r.normal(0, 1, s).astype(np.float32)
            for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, 1, KV, hd), (B, 1, KV, hd))]


def _valid_len(S, kind):
    return {"zero": 0, "one": 1, "ragged": S * 3 // 4 + 1, "full": S}[kind]


def _assert_stats(m, l, m_want, l_want):
    """m to <= 1e-5; l to <= 1e-5 of max(1, max l): l sums up to S
    exponentials, and two summation orders differ by float32 rounding of
    that sum, ~1e-6 of it (the JAX harness's scaled rule)."""
    np.testing.assert_allclose(m, m_want, rtol=0, atol=1e-5)
    scale = max(1.0, float(np.max(np.abs(l_want))))
    np.testing.assert_allclose(l, l_want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("kind", ["zero", "one", "ragged", "full"])
@pytest.mark.parametrize("B,S,H,KV,hd,bs,dt", FD_SHAPES)
def test_flash_decode_plain_matches_jax_kernel(B, S, H, KV, hd, bs, dt,
                                               kind):
    """The port's plain (out, m, l) against the Pallas kernel in interpret
    mode: out to <= 1e-5 in float32 and 2e-2 in bfloat16 (the JAX kernel
    test's rules, tests/test_kernels.py), m and l as ``_assert_stats``."""
    q, k, v, _, _ = _fd_inputs(B, S, H, KV, hd)
    jd, td = FD_DT[dt]
    vl = _valid_len(S, kind)
    jo, jm, jl = flash_decode_pallas(
        *(jnp.asarray(x).astype(jd) for x in (q, k, v)),
        kv_valid_len=jnp.int32(vl), block_s=bs, interpret=True)
    t_fd.LAUNCHES = 0
    to, tm, tl = t_fd.flash_decode(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), kv_valid_len=vl)
    assert t_fd.LAUNCHES == 0
    assert to.dtype == td and tm.shape == (B, KV, H // KV, 1)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), rtol=0,
                               atol=1e-5 if dt == "f32" else 2e-2)
    _assert_stats(tm.numpy(), tl.numpy(), np.asarray(jm), np.asarray(jl))
    if vl == 0:     # every position weighs alike: the mean of V
        assert float(tm.max()) == float(np.float32(-1e30))
        assert float(tl.min()) == float(tl.max()) == S


@pytest.mark.parametrize("kind", ["zero", "one", "ragged", "full"])
@pytest.mark.parametrize("B,S,H,KV,hd", [
    (2, 128, 8, 2, 128), (1, 128, 14, 2, 128), (1, 128, 32, 2, 64),
    (2, 64, 4, 4, 112)])
def test_flash_decode_bf16_arithmetic_meets_the_bf16_rule(B, S, H, KV, hd,
                                                          kind):
    """The kernel's bf16 arithmetic (``flash_decode_ref(round_p=True)``:
    float32 scores of bf16 q and k, P rounded to bf16 before P.V, float32
    accumulation) against the Pallas kernel in bf16, interpret mode: out
    within the bf16 rule (2e-2), m and l as ``_assert_stats``."""
    q, k, v, _, _ = _fd_inputs(B, S, H, KV, hd, seed=hd + H)
    vl = _valid_len(S, kind)
    jo, jm, jl = flash_decode_pallas(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
        kv_valid_len=jnp.int32(vl), block_s=64, interpret=True)
    to, tm, tl = t_fd_ref.flash_decode_ref(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        kv_valid_len=vl, round_p=True)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo, np.float32), rtol=0, atol=2e-2)
    _assert_stats(tm.numpy(), tl.numpy(), np.asarray(jm), np.asarray(jl))


@pytest.mark.parametrize("B,S,H,KV,hd,vl", [
    (2, 256, 8, 2, 64, 0), (2, 256, 8, 2, 64, 1), (2, 256, 8, 2, 64, 100),
    (2, 256, 8, 2, 64, 256), (3, 128, 8, 8, 32, 77), (1, 512, 16, 4, 128, 0)])
def test_flash_decode_with_new_matches_jax(B, S, H, KV, hd, vl):
    """Old cache + fresh token: the port's merge against JAX's kernel route
    and plain route, and its plain route against JAX's, <= 1e-5 in
    float32; with valid_len = 0 the result is exactly the fresh v1."""
    q, k, v, k1, v1 = _fd_inputs(B, S, H, KV, hd, seed=vl)
    jx = [jnp.asarray(x) for x in (q, k, v, k1, v1)]
    tx = [torch.from_numpy(x) for x in (q, k, v, k1, v1)]
    got = t_fd.flash_decode_with_new(*tx, kv_valid_len=vl).numpy()
    got_plain = t_attn.decode_attention_with_new(*tx,
                                                 kv_valid_len=vl).numpy()
    want_kern = np.asarray(j_fd.flash_decode_with_new(
        *jx, kv_valid_len=jnp.int32(vl), force_kernel=True))
    want_plain = np.asarray(j_decode_with_new(*jx,
                                              kv_valid_len=jnp.int32(vl)))
    for a, b in ((got, want_kern), (got, want_plain),
                 (got_plain, want_plain)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    if vl == 0:
        G = H // KV
        want_v1 = np.repeat(v1.reshape(B, 1, KV, 1, hd), G, axis=3)
        np.testing.assert_array_equal(got, want_v1.reshape(B, 1, H, hd))


# -- dispatch ---------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    fr = torch.from_numpy(_frames(2, 4, kind="uniform"))
    t_em.LAUNCHES = t_tx.LAUNCHES = 0
    t_em.segment_motion_fleet(fr, block_size=8, edge_thresh=0.35)
    ones = torch.ones(2)
    t_tx.tx_codec(fr, fr, ones * 8, ones * 0.1,
                  torch.tensor([1, 2], dtype=torch.int32))
    assert t_em.LAUNCHES == 0 and t_tx.LAUNCHES == 0


def test_knapsack_cpu_tensors_take_the_plain_version():
    util = torch.rand(5, 6, generator=torch.Generator().manual_seed(0))
    costs = torch.tensor([1, 2, 4, 8, 16, 20], dtype=torch.int32)
    t_dp.LAUNCHES = 0
    vals, choices = t_dp.solve_values(util, costs, 127)
    picks, total = t_dp.solve_device(util, costs, torch.tensor(60),
                                     w_cap=127)
    assert t_dp.LAUNCHES == 0
    want_v, want_c = t_dp_ref.knapsack_dp_ref(util, costs, 127)
    assert torch.equal(vals, want_v) and torch.equal(choices, want_c)
    assert int(costs[picks].sum()) <= 60


def test_knapsack_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        t_dp.knapsack_dp_cuda(torch.zeros(5, 6),
                              torch.ones(6, dtype=torch.int32), 127)


def test_cuda_wrappers_refuse_cpu_tensors():
    fr = torch.zeros((2, 4, 32, 64))
    with pytest.raises(ValueError):
        t_em.edge_motion_cuda(fr, block_size=8, edge_thresh=0.35)
    ones = torch.ones(2)
    with pytest.raises(ValueError):
        t_tx.tx_codec_cuda(fr, fr, ones, ones,
                           torch.ones(2, dtype=torch.int32))


def test_flash_decode_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.zeros(s) for s in ((2, 1, 8, 64), (2, 32, 2, 64),
                                         (2, 32, 2, 64)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_fd.flash_decode_cuda(q.half(), k.half(), v.half(), 4)
    with pytest.raises(ValueError, match="shapes do not match"):
        t_fd.flash_decode_cuda(q, k, v[:, :16], 4)
    with pytest.raises(ValueError, match="shapes do not match"):
        t_fd.flash_decode_cuda(torch.zeros((2, 1, 7, 64)), k, v, 4)
    with pytest.raises(ValueError, match="multiple of 16"):
        t_fd.flash_decode_cuda(q[..., :56].bfloat16().contiguous(),
                               k[..., :56].bfloat16().contiguous(),
                               v[..., :56].bfloat16().contiguous(), 4)
    with pytest.raises(ValueError, match="at most 16"):
        t_fd.flash_decode_cuda(torch.zeros((2, 1, 34, 64)), k, v, 4)
    with pytest.raises(ValueError, match="contiguous"):
        t_fd.flash_decode_cuda(q, k.transpose(1, 2).contiguous()
                               .transpose(1, 2), v, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        t_fd.flash_decode_cuda(q, k, v, 4)


def test_flash_decode_split_plan_covers_every_position():
    """The ranges the kernel is launched with are whole 64-position tiles
    that cover the valid positions exactly, none empty, fill the card's
    block slots when they can, keep the float32 partials within
    PARTIAL_SHARE of the K and V bytes, and the ring has 1 to STAGES
    stages that fit a block's shared memory."""
    for elem, G, hd in ((2, 4, 128), (2, 16, 64), (2, 7, 112), (4, 4, 8),
                        (4, 16, 256), (2, 1, 256)):
        for n_pos in (1, 63, 64, 65, 511, 528, 1500, 2048, 32768):
            for blocks in (1, 8, 32, 64, 512):
                per, nsplit, stages = t_fd.split_plan(n_pos, blocks, 132, G,
                                                      hd, elem)
                tiles = -(-n_pos // t_fd.TILE)
                assert (nsplit - 1) * per < tiles <= nsplit * per
                assert 1 <= nsplit <= t_fd.MAX_SPLITS
                assert 1 <= stages <= min(t_fd.STAGES, per)
                assert t_fd.smem_bytes(elem, hd, stages) <= \
                    t_fd.MAX_SMEM_BYTES
                if nsplit > 1:
                    part = nsplit * G * (hd + 2) * 4
                    assert part <= t_fd.PARTIAL_SHARE * 2 * n_pos * hd * elem
    # granite-8b's decode (B=4, KV=8, G=4, hd=128, bf16) at 2048 and 528
    # valid positions: 8 ranges of 4 tiles, 3 stages (two blocks per SM);
    # 5 ranges of 2 tiles, 2 stages; partials 1.6% and 3.8% of K and V
    assert t_fd.split_plan(2048, 32, 132) == (4, 8, 3)
    assert t_fd.split_plan(528, 32, 132) == (2, 5, 2)
    for n, nsplit in ((2048, 8), (528, 5)):
        assert 32 * nsplit * 4 * 130 * 4 <= 0.1 * 2 * 32 * n * 128 * 2


def test_flash_decode_tensor_map_cache(monkeypatch):
    """A tensor map is encoded once per (data_ptr, shape, dtype), and the
    cache keeps at most MAP_CACHE_SIZE maps (least recently used out)."""
    calls = []

    def encode(dtype, ptr, B, S, KV, hd, blob):
        calls.append((dtype, ptr, B, S, KV, hd))
        return 0

    monkeypatch.setattr(t_fd, "_fns", lambda: (encode, None, None))
    monkeypatch.setattr(t_fd, "_MAPS", t_fd.OrderedDict())
    monkeypatch.setattr(t_fd, "MAP_CACHE_SIZE", 2)
    cache = torch.zeros((2, 32, 4, 64), dtype=torch.bfloat16)
    a = t_fd.tensor_map(cache)
    assert t_fd.tensor_map(cache) is a and len(calls) == 1
    assert calls[0] == (1, cache.data_ptr(), 2, 32, 4, 64)
    view = cache.view(2, 32, 4, 64)      # the same memory, shape and dtype
    assert t_fd.map_key(view) == t_fd.map_key(cache)
    assert t_fd.tensor_map(view) is a and len(calls) == 1
    other = cache.view(2, 32, 8, 32)
    assert t_fd.map_key(other) != t_fd.map_key(cache)
    t_fd.tensor_map(other)
    t_fd.tensor_map(cache[1:])           # another address: a third map
    assert len(calls) == 3 and len(t_fd._MAPS) == 2
    assert t_fd.map_key(cache) not in t_fd._MAPS


def test_flash_decode_workspace_is_kept_per_device():
    """The partials and counters are allocated once per device, grown when
    a call needs more, and the counters start at 0."""
    dev = torch.device("cpu")
    t_fd._WORKSPACE.pop(t_fd.workspace_key(dev), None)
    parts, counts = t_fd.workspace(dev, 100, 8)
    assert parts.numel() >= 100 and counts.numel() >= 8
    assert counts.dtype == torch.int32 and int(counts.abs().sum()) == 0
    again = t_fd.workspace(dev, 50, 4)
    assert again[0] is parts and again[1] is counts
    bigger = t_fd.workspace(dev, 1000, 4)
    assert bigger[0].numel() >= 1000 and bigger[1] is counts
    assert t_fd.workspace_key(dev) == ("cpu", None)
    assert t_fd.workspace_key(torch.device("cuda", 1)) == ("cuda", 1)
    t_fd._WORKSPACE.pop(t_fd.workspace_key(dev))


# -- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("C,M,H,W,bs,kind,offset", [
    (5, 10, 96, 160, 8, "scene", 0), (5, 11, 96, 160, 8, "scene", 0),
    (16, 10, 96, 160, 8, "scene", 0), (16, 11, 96, 160, 8, "scene", 0),
    (2, 5, 36, 54, 6, "uniform", 0),     # W % 4 != 0; bs straddles words
    (2, 4, 32, 90, 2, "uniform", 0),
    (3, 2, 96, 160, 8, "uniform", 0),    # M = 2: one pair
    (2, 4, 16, 640, 8, "uniform", 1),    # base one float past 16 bytes
    (1, 150, 16, 32, 8, "uniform", 0),   # the plan's chunks of 140 pairs
    (2, 1000, 16, 4, 4, "uniform", 0),   # chunks of 744 pairs: more frames
                                         # than a block has threads
])
def test_edge_motion_cuda_matches_plain(cuda, C, M, H, W, bs, kind, offset):
    """Bitwise, one launch per call, under the launch plan, whole-row
    segments with as many pairs as fit, and chunks of one pair (each frame
    restaged per pair)."""
    src = torch.from_numpy(_frames(C, M, H, W, kind=kind)).to(cuda)
    flat = torch.empty(src.numel() + offset, device=cuda)
    fr = flat[offset:].view(C, M, H, W)
    fr.copy_(src)
    assert fr.is_contiguous() and (fr.data_ptr() % 16 != 0) == bool(offset)
    want = t_em_ref.segment_motion_ref(fr, block_size=bs, edge_thresh=0.35)
    fit = max(p for p in range(1, M) if t_em.smem_bytes(
        bs, W // bs, p) <= t_em.MAX_SMEM_BYTES)
    for launch_plan in (None, (W // bs, fit), (W // bs, 1)):
        before = t_em.LAUNCHES
        got = t_em._launch(fr, bs, 0.35, launch_plan)
        torch.cuda.synchronize()
        assert t_em.LAUNCHES == before + 1
        assert torch.equal(got, want), launch_plan
    before = t_em.LAUNCHES
    assert torch.equal(t_em.segment_motion_fleet(fr, block_size=bs,
                                                 edge_thresh=0.35), want)
    assert t_em.LAUNCHES == before + 1


TX_KS = ((1,) * 5, (2,) * 5, (4,) * 5, (1, 2, 4, 2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("ks,hw", [
    pytest.param(ks, (96, 160), id=f"ks{i}") for i, ks in enumerate(TX_KS)]
    + [pytest.param(ks, hw, id=f"ks{i}-{hw[0]}x{hw[1]}")
       for hw in ((37, 45), (101, 157)) for i, ks in enumerate(TX_KS)])
def test_tx_codec_cuda_matches_plain(cuda, ks, hw):
    """Bitwise, also where H and W are multiples of neither 4 nor k."""
    C = len(ks)
    fr = torch.from_numpy(
        _frames(C, 10, seed=2) if hw == (96, 160)
        else _frames(C, 4, *hw, seed=2, kind="uniform")).to(cuda)
    noise = prng.normal(prng.fold_in(prng.PRNGKey(3, device=cuda),
                                     torch.arange(C, device=cuda)),
                        fr.shape[1:])
    levels = torch.linspace(4.0, 256.0, C, device=cuda)
    sigma = torch.linspace(0.001, 0.3, C, device=cuda)
    kcam = torch.tensor(ks, dtype=torch.int32, device=cuda)
    before = t_tx.LAUNCHES
    got = t_tx.tx_codec(fr, noise, levels, sigma, kcam)
    torch.cuda.synchronize()
    assert t_tx.LAUNCHES == before + 1
    want = t_tx_ref.tx_codec_ref(fr, noise, levels, sigma, kcam)
    assert torch.equal(got, want)


def _dp_table(kind, I, J, seed, device):
    r = np.random.default_rng(seed)
    util = r.uniform(0, 1, (I, J)).astype(np.float32)
    if kind == "dead":
        dead = r.choice(I, size=max(I // 2, 1), replace=False)
        util[dead] = -1e9
        util[dead, 0] = 0.0
    elif kind == "ties":
        util = (np.round(util * 4) / 4).astype(np.float32)
        util[:, 1] = util[:, 0]
    return torch.from_numpy(util).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,I,W", [
    ("uniform", 5, 127), ("uniform", 16, 127), ("uniform", 3, 255),
    ("uniform", 32, 200), ("dead", 5, 127), ("dead", 16, 127),
    ("ties", 5, 127), ("uniform", 8, 20000),   # rows past 48 KB of smem
])
def test_knapsack_cuda_matches_plain(cuda, kind, I, W):
    """Values bitwise and choices equal: the kernel's strict > keeps the
    lowest j, as ``torch.argmax`` does; the fused solve's picks and total
    equal the plain backtrack's, one launch per solve."""
    util = _dp_table(kind, I, 6, I + W, cuda)
    costs = torch.tensor([1, 2, 4, 8, 16, 20], dtype=torch.int32,
                         device=cuda)
    before = t_dp.LAUNCHES
    vals, choices = t_dp.solve_values(util, costs, W)
    torch.cuda.synchronize()
    assert t_dp.LAUNCHES == before + 1
    want_v, want_c = t_dp_ref.knapsack_dp_ref(util, costs, W)
    assert torch.equal(vals, want_v)
    assert torch.equal(choices, want_c)
    # the sweep and the bounded backtrack in one launch, against the plain
    # backtrack of the plain sweep
    for Wg in (I, (I + W) // 2, W):
        wg = torch.tensor(Wg, dtype=torch.int32, device=cuda)
        before = t_dp.LAUNCHES
        picks, total = t_dp.solve_device(util, costs, wg, w_cap=W)
        torch.cuda.synchronize()
        assert t_dp.LAUNCHES == before + 1
        want_p, want_t = t_dp_ref.backtrack_device(want_c, costs, want_v, wg)
        assert picks.dtype == torch.int64 and torch.equal(picks, want_p)
        assert torch.equal(total, want_t)


@pytest.mark.cuda
@pytest.mark.parametrize("costs,W", [
    ((0, 33, 65, 100, 7, 300), 255),       # costs past 32: rotated rows
    ((1, 40, 64, 96, 129, 31, 2, 3, 5, 9, 17), 1023),   # 11, block sweep
    ((3, 70), 200), ((2, 5, 1, 7, 11, 13, 4, 8, 6), 127)])
@pytest.mark.parametrize("I", [1, 4, 9])
def test_knapsack_cuda_costs_matches_plain(cuda, costs, W, I):
    """The one-warp sweep with costs of more than a warp's 32 columns, a
    zero cost and more options than it keeps in registers: values,
    choices, picks and total equal to the plain versions."""
    c = torch.tensor(costs, dtype=torch.int32, device=cuda)
    u = _dp_table("uniform", I, len(costs), W + I, cuda)
    vals, choices = t_dp.knapsack_dp_cuda(u, c, W)
    want_v, want_c = t_dp_ref.knapsack_dp_ref(u, c, W)
    assert torch.equal(vals, want_v) and torch.equal(choices, want_c)
    wg = torch.tensor(W // 3, dtype=torch.int32, device=cuda)
    picks, total = t_dp.solve_device(u, c, wg, w_cap=W)
    want_p, want_t = t_dp_ref.backtrack_device(want_c, c, want_v, wg)
    assert torch.equal(picks, want_p) and torch.equal(total, want_t)


@pytest.mark.cuda
@pytest.mark.parametrize("blur", [True, False])
def test_tx_codec_crf_cuda_matches_plain(cuda, blur):
    C = 5
    fr = torch.from_numpy(_frames(C, 10, seed=2)).to(cuda)
    keys = prng.fold_in(prng.PRNGKey(3, device=cuda),
                        torch.arange(C, device=cuda))
    roi = torch.linspace(2000.0, 15360.0, C, device=cuda)
    r = torch.tensor([1.0, 0.75, 0.5, 0.74, 1.0], device=cuda)
    got, size = t_tx.encode_fleet_crf(t_codec.CodecConfig(), fr, roi, keys,
                                      r, blur=blur)
    torch.cuda.synchronize()
    for c in range(C):
        want, want_size = t_codec.encode_segment_crf(
            t_codec.CodecConfig(), fr[c], roi[c], keys[c],
            r[c] if blur else None)
        assert float((got[c] - want).abs().max()) <= 1e-6
        if blur:
            assert float(size[c]) == float(want_size)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd,vl", [
    (4, 2048, 32, 8, 128, 0), (4, 2048, 32, 8, 128, 1),
    (4, 2048, 32, 8, 128, 511), (4, 2048, 32, 8, 128, 2048),
    (2, 256, 8, 8, 64, 100), (2, 32, 8, 2, 8, 5), (2, 256, 14, 2, 128, 200),
    (1, 256, 32, 2, 64, 100), (1, 128, 4, 4, 112, 77),
    (4, 2048, 32, 8, 128, 512)])        # ends on a range boundary
def test_flash_decode_cuda_matches_plain(cuda, dt, B, S, H, KV, hd, vl):
    """Kernel vs plain version on the card: out to <= 1e-5 in float32 and
    2e-2 in bfloat16, m and l as ``_assert_stats``; the fresh-token merge
    of the kernel's stats against the same merge of the plain ones.  The
    bf16 kernel takes head sizes in steps of 16 and refuses others."""
    td = FD_DT[dt][1]
    q, k, v, k1, v1 = (torch.from_numpy(x).to(cuda, td)
                       for x in _fd_inputs(B, S, H, KV, hd))
    if dt == "bf16" and hd % 16:
        with pytest.raises(ValueError, match="multiple of 16"):
            t_fd.flash_decode(q, k, v, kv_valid_len=vl)
        return
    before = t_fd.LAUNCHES
    out, m, l = t_fd.flash_decode(q, k, v, kv_valid_len=vl)
    torch.cuda.synchronize()
    assert t_fd.LAUNCHES == before + 1
    wo, wm, wl = t_fd_ref.flash_decode_ref(q, k, v, kv_valid_len=vl)
    tol = 1e-5 if dt == "f32" else 2e-2
    assert float((out.float() - wo.float()).abs().max()) <= tol
    _assert_stats(m.cpu().numpy(), l.cpu().numpy(), wm.cpu().numpy(),
                  wl.cpu().numpy())
    got = t_fd.flash_decode_with_new(q, k, v, k1, v1, kv_valid_len=vl)
    want = t_fd.merge_new(q, k1, v1, wo, wm, wl)
    assert float((got.float() - want.float()).abs().max()) <= tol
