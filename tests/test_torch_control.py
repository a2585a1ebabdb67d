"""The port's control layer against the JAX package's: the plain knapsack
DP against the Pallas kernel (interpret mode, as the JAX kernel tests run
it), the host solve against the JAX solve and the exhaustive oracle, the
host allocators and the float64 elastic controller, the greedy allocators,
and the whole-trace control loops (``elastic.update_scan``,
``fleet.fleet_control_scan``) against JAX's scans and their own
stepwise loops."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

from repro.core import allocation as j_alloc  # noqa: E402
from repro.core import elastic as j_elastic  # noqa: E402
from repro.core import fleet as j_fleet  # noqa: E402
from repro.core import utility as j_util  # noqa: E402
from repro.kernels.knapsack_dp import ops as j_dp  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.core import allocation as t_alloc  # noqa: E402
from repro_torch.core import codec as t_codec  # noqa: E402
from repro_torch.core import elastic as t_elastic  # noqa: E402
from repro_torch.core import fleet as t_fleet  # noqa: E402
from repro_torch.core import utility as t_util  # noqa: E402
from repro_torch.kernels.knapsack_dp import ops as t_dp  # noqa: E402
from repro_torch.kernels.knapsack_dp import ref as t_dp_ref  # noqa: E402

COSTS = np.array([1, 2, 4, 8, 16, 20], np.int32)   # the default codec grid
BITRATES = (50, 100, 200, 400, 800, 1000)


def _table(kind, I, J, seed):
    """(I, J) float32 utility tables, made with numpy from a seed."""
    r = np.random.default_rng(seed)
    util = r.uniform(0, 1, (I, J)).astype(np.float32)
    if kind == "dead":
        # dead cameras: only the cheapest option is open, at zero utility
        dead = r.choice(I, size=max(I // 2, 1), replace=False)
        util[dead] = -1e9
        util[dead, 0] = 0.0
    elif kind == "ties":
        # a coarse grid makes equal candidates common at every w
        util = (np.round(util * 4) / 4).astype(np.float32)
        util[:, 1] = util[:, 0]
    return util


@pytest.mark.parametrize("kind,I,J,W,seed", [
    ("uniform", 5, 6, 127, 0),      # main path, C=5
    ("uniform", 3, 6, 255, 1),      # the harness's pinned capacity
    ("uniform", 32, 6, 200, 2),
    ("dead", 5, 6, 127, 3),
    ("dead", 16, 6, 127, 4),
    ("ties", 5, 6, 127, 5),
    ("ties", 8, 3, 40, 6),
])
def test_knapsack_plain_matches_pallas(kind, I, J, W, seed):
    """Values bitwise, choices exactly equal to the Pallas kernel's."""
    util = _table(kind, I, J, seed)
    costs = COSTS[:J]
    vj, cj = j_dp.solve_values(jnp.asarray(util), jnp.asarray(costs), W,
                               use_kernel=True)
    vt, ct = t_dp_ref.knapsack_dp_ref(torch.from_numpy(util),
                                      torch.from_numpy(costs), W)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    vd, cd = t_dp.solve_values(torch.from_numpy(util),
                               torch.from_numpy(costs), W)
    assert torch.equal(vd, vt) and torch.equal(cd, ct)


@pytest.mark.parametrize("I", [1, 3, 5, 16])
@pytest.mark.parametrize("kind", ["uniform", "dead", "ties"])
def test_solves_match_jax(kind, I):
    """The device solve (sweep at w_cap = 127, backtrack bounded by Wg) and
    the host solve on CPU tensors against JAX's ``solve_device`` (Pallas
    kernel in interpret mode, and the plain sweep) and JAX's ``solve``, at
    Wg = cmin * I (the all-minimum clamp), a middle value and w_cap: picks
    and totals exact."""
    util = _table(kind, I, 6, 100 + I)
    costs = COSTS
    w_cap = 127
    cmin = int(costs.min())
    for Wg in (cmin * I, (cmin * I + w_cap) // 2, w_cap):
        pt, tt = t_dp.solve_device(torch.from_numpy(util),
                                   torch.from_numpy(costs),
                                   torch.tensor(Wg, dtype=torch.int32),
                                   w_cap=w_cap)
        assert pt.dtype == torch.int64 and tt.dim() == 0
        for use_kernel in (True, False):
            pj, tj = j_dp.solve_device(jnp.asarray(util), jnp.asarray(costs),
                                       jnp.int32(Wg), w_cap=w_cap,
                                       use_kernel=use_kernel)
            np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
            assert float(tt) == float(tj)
        ph, th = t_dp.solve(util, costs, Wg, device="cpu")
        pjh, tjh = j_dp.solve(util, costs, Wg, use_kernel=True)
        np.testing.assert_array_equal(ph, pjh)
        assert th == tjh == float(tt)
        np.testing.assert_array_equal(ph, pt.numpy())
        assert int(costs[ph].sum()) <= max(Wg, cmin * I)


def test_solve_table_placement():
    """The fused solve keeps its one-byte choice table in shared memory at
    the fleet's shapes and goes to a scratch table in device memory where
    it does not fit (W = 20000) or a choice needs more than a byte; the
    shared memory a launch asks for stays within a block's 227 KB."""
    assert t_dp.table_in_smem(5, 6, 128) and t_dp.table_in_smem(16, 6, 128)
    assert t_dp.smem_bytes(5, 6, 128, solve=True) == 4 * (30 + 6) + 640
    assert t_dp.smem_bytes(5, 6, 128, solve=False) == 4 * (30 + 6)
    assert t_dp.table_in_smem(32, 6, 201)
    assert not t_dp.table_in_smem(8, 6, 20001)
    assert not t_dp.table_in_smem(5, 300, 128)
    assert t_dp.smem_bytes(8, 6, 20001, solve=True) == \
        t_dp.smem_bytes(8, 6, 20001, solve=False) == 4 * (48 + 6) + 8 * 20001
    for I, J, wp1 in ((5, 6, 128), (16, 6, 1024), (200, 6, 1024),
                      (32, 6, 201), (8, 6, 20001), (1, 255, 1)):
        assert t_dp.smem_bytes(I, J, wp1, solve=True) <= t_dp.MAX_SMEM_BYTES


@pytest.mark.parametrize("I,J,W,seed", [
    (3, 4, 9, 0), (4, 3, 17, 1), (5, 4, 30, 2), (4, 6, 40, 3), (2, 6, 7, 4),
])
def test_host_solve_matches_jax_and_oracle(I, J, W, seed):
    r = np.random.default_rng(seed)
    util = r.uniform(0, 1, (I, J)).astype(np.float32)
    costs = r.integers(1, max(W // I, 2) + 1, J).astype(np.int32)
    costs[0] = 1
    pt, vt = t_dp.solve(util, costs, W, device="cpu")
    pj, vj = j_dp.solve(util, costs, W, use_kernel=True)
    _, ve = t_dp_ref.exhaustive_oracle(util, costs, W)
    np.testing.assert_array_equal(pt, pj)
    assert vt == vj
    assert vt == pytest.approx(ve, abs=1e-5)
    assert costs[pt].sum() <= W
    assert util[np.arange(I), pt].sum() == pytest.approx(ve, abs=1e-5)


def _same_allocation(got, want):
    np.testing.assert_array_equal(got.bitrates_kbps, want.bitrates_kbps)
    np.testing.assert_array_equal(got.resolutions, want.resolutions)
    assert got.predicted_utility == want.predicted_utility
    assert got.feasible == want.feasible


# W in Kbps: an outage, W < 0, below the clamp, exactly on a grid multiple,
# and ordinary capacities
@pytest.mark.parametrize("W", [0.0, -5.0, 120.0, 1000.0, 1037.5, 2600.0,
                               6000.0])
@pytest.mark.parametrize("dead", [False, True])
def test_host_allocators_match_jax(W, dead):
    r = np.random.default_rng(int(W) % 97 + 3 * dead)
    I = 5
    util = r.uniform(0, 1, (I, 6)).astype(np.float32)
    best_res = r.choice([1.0, 0.75, 0.5], (I, 6)).astype(np.float32)
    live = np.ones(I, bool)
    if dead:
        live[[1, 3]] = False
    got = t_alloc.allocate_dp_host(util, best_res, BITRATES, W, live=live,
                                   device="cpu")
    want = j_alloc.allocate_dp(util, best_res, BITRATES, W, use_kernel=True,
                               live=live)
    _same_allocation(got, want)
    _same_allocation(t_alloc.allocate_fair_host(BITRATES, W, I, live=live),
                     j_alloc.allocate_fair(BITRATES, W, I, live=live))


def test_host_allocators_random_tables():
    r = np.random.default_rng(11)
    for _ in range(20):
        I = int(r.integers(1, 7))
        util = r.uniform(0, 1, (I, 6)).astype(np.float32)
        best_res = r.choice([1.0, 0.75, 0.5], (I, 6)).astype(np.float32)
        live = r.uniform(size=I) > 0.3
        live[0] = True
        W = float(r.uniform(-100, 1200 * I))
        _same_allocation(
            t_alloc.allocate_dp_host(util, best_res, BITRATES, W, live=live,
                                     device="cpu"),
            j_alloc.allocate_dp(util, best_res, BITRATES, W, live=live))
        _same_allocation(
            t_alloc.allocate_fair_host(BITRATES, W, I, live=live),
            j_alloc.allocate_fair(BITRATES, W, I, live=live))


def test_grid_floor_precision_matches_jax():
    """A capacity one float64 ulp under a grid multiple: the host path
    floors W/d in float64 (19 units, below the 20-camera clamp), the
    device path in float32 (20 units, feasible), in both packages."""
    I = 20
    W = float(np.nextafter(1000.0, 0.0))
    util = np.random.default_rng(0).uniform(0, 1, (I, 6)).astype(np.float32)
    best_res = np.ones((I, 6), np.float32)
    host = t_alloc.allocate_dp_host(util, best_res, BITRATES, W,
                                    device="cpu")
    _same_allocation(host, j_alloc.allocate_dp(util, best_res, BITRATES, W))
    assert not host.feasible
    w_cap = t_alloc.dp_capacity(BITRATES, 2000.0)
    *_, feas_t = t_alloc.allocate_dp(torch.from_numpy(util),
                                     torch.from_numpy(best_res), BITRATES,
                                     torch.tensor(W, dtype=torch.float32),
                                     w_cap=w_cap,
                                     rates=torch.tensor(BITRATES,
                                                        dtype=torch.float32))
    *_, feas_j = j_alloc.allocate_dp_jax(jnp.asarray(util),
                                         jnp.asarray(best_res), BITRATES,
                                         jnp.float32(W), w_cap=w_cap)
    assert bool(feas_t) and bool(feas_j)


def test_update_host_matches_jax_update():
    """A 20-slot sequence through borrow, repay, budget clamp and a debt
    reset: every state field and every extra equal in float64."""
    cfg_t, cfg_j = t_elastic.ElasticConfig(), j_elastic.ElasticConfig()
    r = np.random.default_rng(2)
    areas = r.uniform(0.0, 1.5, 20)
    areas[5:9] = 2.5                       # a burst of ROI area
    W = r.uniform(100.0, 3000.0, 20)
    W[5:9] = 200.0                         # while the link is low
    W[12:16] = 4000.0                      # then high: repay
    st_t, st_j = t_elastic.HostElasticState(), j_elastic.ElasticState()
    borrowed = repaid = 0.0
    for t in range(20):
        reset = t == 17
        st_t, ex_t, log_t = t_elastic.update_host(
            cfg_t, st_t, float(areas[t]), float(W[t]), 1500.0, 2500.0,
            reset_debt=reset)
        st_j, ex_j, log_j = j_elastic.update(
            cfg_j, st_j, float(areas[t]), float(W[t]), 1500.0, 2500.0,
            reset_debt=reset)
        assert ex_t == ex_j
        assert (st_t.a_ema, st_t.a_var, st_t.debt_kbits, st_t.initialized) \
            == (st_j.a_ema, st_j.a_var, st_j.debt_kbits, st_j.initialized)
        assert log_t == log_j
        borrowed += log_t["borrowed"]
        repaid += log_t["repaid"]
    assert borrowed > 0 and repaid > 0


def test_solve_refuses_no_device():
    """The host solve runs on the card unless told otherwise."""
    util = np.ones((2, 3), np.float32)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        t_dp.solve(util, COSTS[:3], 5)


def _greedy_case(r, I, W=None):
    util = np.sort(r.uniform(0, 1, (I, 6)), axis=1).astype(np.float32)
    util[:, 3:] = util[:, 3:4]          # a plateau: zero-gain upgrades
    best_res = r.choice([1.0, 0.75, 0.5], (I, 6)).astype(np.float32)
    live = r.uniform(size=I) > 0.3
    live[0] = True
    if W is None:
        W = float(r.uniform(-100, 1200 * I))
    return util, best_res, live, W


@pytest.mark.parametrize("W", [0.0, -5.0, 120.0, 1000.0, 2600.0, 6000.0,
                               None])
def test_greedy_allocators_match_jax(W):
    """Host greedy against JAX's ``allocate_greedy``, device greedy against
    ``allocate_greedy_jax`` (picks, b, r and feasibility exact, the total
    to float32 rounding): random tables with plateaus and dead cameras, W <= 0 and
    infeasible capacities included."""
    r = np.random.default_rng(17 if W is None else int(W) % 89 + 5)
    for _ in range(8 if W is None else 2):
        I = int(r.integers(1, 7))
        util, best_res, live, Wc = _greedy_case(r, I, W)
        _same_allocation(
            t_alloc.allocate_greedy_host(util, best_res, BITRATES, Wc,
                                         live=live),
            j_alloc.allocate_greedy(util, best_res, BITRATES, Wc, live=live))
        got = t_alloc.allocate_greedy(
            torch.from_numpy(util), torch.from_numpy(best_res), BITRATES,
            torch.tensor(Wc, dtype=torch.float32),
            live=torch.from_numpy(live))
        want = j_alloc.allocate_greedy_jax(
            jnp.asarray(util), jnp.asarray(best_res), BITRATES,
            jnp.float32(Wc), live=jnp.asarray(live))
        for name, g, w in zip(("picks", "b", "res", "total", "feasible"),
                              got, want):
            if name == "total":     # a float32 sum, in another order
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=name)


def test_update_scan_matches_jax_and_steps():
    """Borrow, repay and the budget clamp over 16 slots: the port's scan
    equals its own stepwise ``update`` bitwise and JAX's ``update_scan``
    to float32 rounding."""
    cfg_t, cfg_j = t_elastic.ElasticConfig(), j_elastic.ElasticConfig()
    r = np.random.default_rng(5)
    areas = r.uniform(0.0, 1.5, 16).astype(np.float32)
    areas[4:8] = 2.5
    W = r.uniform(100.0, 3000.0, 16).astype(np.float32)
    W[4:8] = 200.0
    W[10:13] = 4000.0
    tau = (torch.tensor(1500.0), torch.tensor(2500.0))
    st, extras = t_elastic.update_scan(
        cfg_t, t_elastic.init_state("cpu"), torch.from_numpy(areas),
        torch.from_numpy(W), *tau)
    st_s = t_elastic.init_state("cpu")
    for t in range(16):
        st_s, ex = t_elastic.update(cfg_t, st_s, torch.tensor(areas[t]),
                                    torch.tensor(W[t]), *tau)
        assert torch.equal(ex, extras[t])
    for a, b in zip(st, st_s):
        assert torch.equal(a, b)
    jst, jex = j_elastic.update_scan(cfg_j, j_elastic.init_state_jax(),
                                     jnp.asarray(areas), jnp.asarray(W),
                                     jnp.float32(1500.0), jnp.float32(2500.0))
    np.testing.assert_allclose(extras.numpy(), np.asarray(jex), rtol=1e-6,
                               atol=1e-3)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert float(extras.max()) > 0 and float(extras.min()) < 0


@pytest.mark.parametrize("method", ["deepstream", "deepstream_no_elastic",
                                    "jcab", "static"])
def test_fleet_control_scan_matches_jax_and_steps(method):
    """T = 6 slots at C = 4 with a dead camera and a reconnect: the scan
    equals T ``fleet_control_step`` calls bitwise and JAX's
    ``fleet_control_scan`` (b and r exact, packs and state <= 1e-5)."""
    from repro_torch.core.elastic import ElasticConfig
    T, C = 6, 4
    r = np.random.default_rng(hash(method) % 1000)
    a = r.uniform(0, 0.6, (T, C)).astype(np.float32)
    c = r.uniform(0, 1, (T, C)).astype(np.float32)
    W = r.uniform(150, 4000, T).astype(np.float32)
    live = np.ones((T, C), bool)
    live[2:4, 1] = False
    rec = np.zeros(T, bool)
    rec[4] = True
    jcab = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(np.float32)
    jcab_util = np.repeat(jcab.max(-1)[None], C, 0).astype(np.float32)
    res = np.asarray((1.0, 0.75, 0.5), np.float32)
    jcab_res = np.repeat(res[jcab.argmax(-1)][None], C, 0)
    lam = np.linspace(0.5, 1.5, C).astype(np.float32)
    use_elastic = method == "deepstream"
    w_cap = t_alloc.trace_capacity(BITRATES, W, C,
                                   elastic_borrow_kbps=1500.0)
    statics = dict(bitrates=BITRATES, resolutions=(1.0, 0.75, 0.5),
                   slot_seconds=1.0, use_elastic=use_elastic, w_cap=w_cap,
                   num_cams=C)
    deep = method.startswith("deepstream")
    mlp_t = t_util.init_utility_mlp(prng.PRNGKey(0)) if deep else None
    tt = lambda x: torch.from_numpy(np.asarray(x))
    tau = (torch.tensor(600.0), torch.tensor(2400.0))
    tables = t_codec.device_tables(BITRATES, (1.0, 0.75, 0.5), "cpu")
    b, rr, packs, est = t_fleet.fleet_control_scan(
        mlp_t, tt(jcab_util), tt(jcab_res), tt(lam),
        tt(a) if deep else None, tt(c) if deep else None, tt(W),
        t_elastic.init_state("cpu"), *tau, tt(live), tt(rec), method=method,
        ecfg=ElasticConfig(), tables=tables, **statics)
    est_s = t_elastic.init_state("cpu")
    for t in range(T):
        co = t_fleet.fleet_control_step(
            mlp_t, tt(jcab_util), tt(jcab_res), tt(lam),
            tt(a[t]) if deep else None, tt(c[t]) if deep else None,
            tt(W[t]), est_s, *tau, tt(live[t]), tt(rec[t]), method=method,
            ecfg=ElasticConfig(), tables=tables, **statics)
        est_s = co.est
        assert torch.equal(co.b, b[t]) and torch.equal(co.r, rr[t])
        assert torch.equal(co.pack, packs[t])
    for x, y in zip(est, est_s):
        assert torch.equal(x, y)
    jb, jr, jpacks, jest = j_fleet.fleet_control_scan(
        method, j_util.init_utility_mlp(jax.random.PRNGKey(0)) if deep
        else None, jnp.asarray(jcab_util), jnp.asarray(jcab_res),
        jnp.asarray(lam), jnp.asarray(a) if deep else None,
        jnp.asarray(c) if deep else None, jnp.asarray(W),
        j_elastic.init_state_jax(), jnp.float32(600.0), jnp.float32(2400.0),
        ecfg=j_elastic.ElasticConfig(), use_kernel=True,
        live_trace=jnp.asarray(live), reconnect_trace=jnp.asarray(rec),
        **statics)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(rr.numpy(), np.asarray(jr))
    scale = max(1.0, float(np.abs(np.asarray(jpacks)).max()))
    np.testing.assert_allclose(packs.numpy(), np.asarray(jpacks), rtol=0,
                               atol=1e-5 * scale)
    for x, y in zip(est, jest):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-5)
