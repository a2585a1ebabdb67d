"""The port's scenario families (``repro_torch.data.scenarios``) against
the JAX package's: every trace, scene and fault family, the soak stream
and the chaos schedule, array for array over several seeds and lengths."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.data import scenarios as j_sc  # noqa: E402
from repro_torch.data import scenarios as t_sc  # noqa: E402

SEEDS = (0, 3, 11)


def test_registries_match():
    assert t_sc.trace_families() == j_sc.trace_families()
    assert t_sc.scene_families() == j_sc.scene_families()
    assert t_sc.fault_families() == j_sc.fault_families()
    assert t_sc.ZERO_FLOOR_FAMILIES == j_sc.ZERO_FLOOR_FAMILIES
    assert (t_sc.TRACE_REFERENCE_CAMS, t_sc.SOAK_SLOTS, t_sc.FLOOR_KBPS) == (
        j_sc.TRACE_REFERENCE_CAMS, j_sc.SOAK_SLOTS, j_sc.FLOOR_KBPS)


@pytest.mark.parametrize("name", j_sc.trace_families())
def test_trace_families_match(name):
    for seed in SEEDS:
        for T in (1, 5, 11, 64):
            for cams in (None, 3, 16):
                np.testing.assert_array_equal(
                    t_sc.make_trace(name, T, seed=seed, num_cams=cams),
                    j_sc.make_trace(name, T, seed=seed, num_cams=cams),
                    err_msg=f"{name} T={T} seed={seed} cams={cams}")


@pytest.mark.parametrize("name", j_sc.scene_families())
def test_scene_families_match(name):
    for seed in SEEDS:
        assert dataclasses.asdict(t_sc.make_scene(name, seed)) == \
            dataclasses.asdict(j_sc.make_scene(name, seed))


@pytest.mark.parametrize("name", j_sc.fault_families())
def test_fault_families_match(name):
    for seed in SEEDS:
        for T, C in ((4, 3), (11, 5), (20, 16)):
            np.testing.assert_array_equal(
                t_sc.make_faults(name, T, C, seed=seed),
                j_sc.make_faults(name, T, C, seed=seed),
                err_msg=f"{name} T={T} C={C} seed={seed}")


def test_fault_contract_is_checked():
    with pytest.raises(ValueError, match="liveness"):
        t_sc.make_faults("none", 3, 0)


@pytest.mark.parametrize("family", ["camera_churn", "sensor_corrupt"])
def test_soak_stream_matches(family):
    for seed in SEEDS:
        for got, want in zip(
                t_sc.make_soak_stream(200, 4, seed=seed, fault_family=family),
                j_sc.make_soak_stream(200, 4, seed=seed, fault_family=family)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("poisoned", [False, True])
def test_chaos_schedule_matches(poisoned):
    for seed in SEEDS:
        for T in (48, 200, 1000):
            assert t_sc.make_chaos_schedule(T, 8, seed=seed,
                                            poisoned=poisoned) == \
                j_sc.make_chaos_schedule(T, 8, seed=seed, poisoned=poisoned)
