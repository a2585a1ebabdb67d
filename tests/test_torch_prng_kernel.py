"""The threefry normal draw's dispatch (``prng.normal`` and
``prng.normal_erfinv``): fake keys take the kernel's stand-in, CPU keys the
torch code, and the wrapper refuses what the kernel does not take; on a
machine with a card, the kernel against the torch code, bitwise.  No JAX
here: ``tests/test_torch_prng.py`` holds the torch code to ``jax.random``."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

# one intra-op thread: the suite runs several pytest workers at once, and
# PyTorch's default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

from repro_torch.common import device as t_device  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.kernels.threefry_normal import ops as tf_ops  # noqa: E402

CELL = (16, (10, 96, 160))      # ds16.stream: (16, 2) keys, one slot's frames
DRAWS = {"normal": True, "normal_erfinv": False}
# (key batch shape, draw shape) of the card's cases: the cell's, one () key
# over an odd count, (3,) keys over (3, 5, 7), and one value a key
CARD_CASES = [((16,), (10, 96, 160)), ((), (1001,)), ((3,), (3, 5, 7)),
              ((), (1,)), ((5,), ())]


def _keys(batch, seed=5, device="cpu"):
    n = int(np.prod(batch)) if batch else 1
    k = prng.fold_in(prng.PRNGKey(seed), torch.arange(n))
    return k.reshape(tuple(batch) + (2,)).to(device)


def _torch_draw(keys, shape, scaled):
    """The torch code the CPU runs, whatever the keys' device."""
    e = prng.erf_inv(prng.uniform(keys, shape, prng._LO, 1.0))
    return e * prng.SQRT2 if scaled else e


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().contiguous().view(torch.int32).numpy()


@pytest.fixture
def recorded():
    calls = []
    saved = t_device.KERNEL_RECORDER
    t_device.KERNEL_RECORDER = lambda *a: calls.append(a)
    yield calls
    t_device.KERNEL_RECORDER = saved


@pytest.mark.parametrize("draw", sorted(DRAWS))
@pytest.mark.parametrize("batch,shape", [((16,), CELL[1]), ((), (7,)),
                                         ((3,), (3, 5, 7)), ((5,), ())])
def test_fake_keys_take_the_stand_in(draw, batch, shape, recorded):
    with FakeTensorMode():
        keys = torch.zeros(tuple(batch) + (2,), dtype=torch.int64)
        out = getattr(prng, draw)(keys, shape)
        assert tuple(out.shape) == tuple(batch) + shape
        assert out.dtype == torch.float32
    n_keys, n = int(np.prod(batch)), int(np.prod(shape))
    assert recorded == [("threefry_normal", tf_ops.OPS_PER_VALUE * n_keys * n,
                         16 * n_keys + 4 * n_keys * n)]


@pytest.mark.parametrize("draw", sorted(DRAWS))
def test_cpu_keys_never_reach_the_wrapper(draw, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("CPU keys reached the kernel's module")
    for name in ("threefry_normal_cuda", "threefry_normal_stand_in"):
        monkeypatch.setattr(tf_ops, name, refuse)
    keys = _keys(CELL[:1])
    got = getattr(prng, draw)(keys, CELL[1])
    assert got.shape == (CELL[0],) + CELL[1] and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_torch_draw(keys, CELL[1],
                                                    DRAWS[draw])))


@pytest.mark.parametrize("keys,match", [
    (torch.zeros((4, 2), dtype=torch.int64), "CUDA"),
    (torch.zeros((4, 2), dtype=torch.int32), "int64"),
    (torch.zeros((4, 3), dtype=torch.int64), r"\(\.\.\., 2\)"),
    (torch.zeros((), dtype=torch.int64), r"\(\.\.\., 2\)"),
    (torch.zeros((2, 4), dtype=torch.int64).t(), "contiguous")])
def test_wrapper_refuses_what_the_kernel_does_not_take(keys, match):
    lo, span = prng._bounds(prng._LO, 1.0)
    before = tf_ops.LAUNCHES
    with pytest.raises(ValueError, match=match):
        tf_ops.threefry_normal_cuda(keys, (3,), lo, span, True)
    assert tf_ops.LAUNCHES == before


def test_cost_counts_keys_once_and_values_once():
    ops, nbytes = tf_ops.cost(*CELL[:1], int(np.prod(CELL[1])))
    assert nbytes == 16 * 16 + 4 * 2_457_600
    assert ops == tf_ops.OPS_PER_VALUE * 2_457_600


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (threefry_normal is a CUDA kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("draw", sorted(DRAWS))
@pytest.mark.parametrize("case", range(len(CARD_CASES)))
def test_kernel_equals_the_torch_code_bitwise(cuda, draw, case):
    batch, shape = CARD_CASES[case]
    keys = _keys(batch, seed=2 ** 31 + 77)
    before = tf_ops.LAUNCHES
    got = getattr(prng, draw)(keys.to(cuda), shape)
    torch.cuda.synchronize()
    assert tf_ops.LAUNCHES == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.float32
    want = _torch_draw(keys, shape, DRAWS[draw])
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the torch code on the card gives the same bits
    np.testing.assert_array_equal(
        _bits(got), _bits(_torch_draw(keys.to(cuda), shape, DRAWS[draw])))
