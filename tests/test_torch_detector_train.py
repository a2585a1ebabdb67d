"""The port's detector trainer (``repro_torch.train.detector_train`` and the
training half of ``repro_torch.models.detector``) against the JAX
package's, on the CPU: the seeded init, the targets and training batches,
the loss and its gradients (at exact ties too), an 8-step training run
step by step, and checkpoints both ways.  Every JAX side runs live."""
import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.data.synthetic import MultiCameraScene as JScene  # noqa: E402
from repro.data.synthetic import SceneConfig as JSceneConfig  # noqa: E402
from repro.models import detector as j_det  # noqa: E402
from repro.train import detector_train as j_train  # noqa: E402
from repro_torch.common import prng  # noqa: E402
from repro_torch.common.convert import params_from_numpy  # noqa: E402
from repro_torch.common.convert import params_to_numpy  # noqa: E402
from repro_torch.data.synthetic import MultiCameraScene  # noqa: E402
from repro_torch.data.synthetic import SceneConfig  # noqa: E402
from repro_torch.models import detector as t_det  # noqa: E402
from repro_torch.models.detector import load_detector  # noqa: E402
from repro_torch.train import detector_train as t_train  # noqa: E402

LOSS_RTOL = 1e-6        # detection_loss on the same weights and batch
# With the head zeroed every BCE term is exactly log 2: XLA's CPU reduce
# sums them one after another in float32 (n cells: up to n * 2**-24 off
# the true mean; 1.9e-6 at n = 480), torch pairwise (1.7e-7 off)
TIE_LOSS_RTOL = 8 * 6 * 10 * 2.0 ** -24
GRAD_TOL = 1e-5         # each gradient leaf, relative to its max |g|
STEP_RTOL = 1e-5        # each training step's loss
PARAM_TOL = 1e-6        # weights after 8 steps, relative to max |w| per
                        # leaf (4.7e-7 measured)


def _hwio(jtree) -> dict:
    return {k: np.array(v) for k, v in jtree.items()}


def _batch(n=8, seed=0):
    """A JAX training batch (frames, targets) as numpy."""
    scene = JScene(JSceneConfig(seed=100))
    return j_train.make_training_batch(scene, np.random.default_rng(seed), n)


@pytest.mark.parametrize("variant", ["light", "server"])
def test_init_detector_matches_jax(variant):
    want = _hwio(j_det.init_detector(jax.random.PRNGKey(3), variant))
    got = t_det.init_detector(prng.PRNGKey(3), variant)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == params_from_numpy(
            {k: w}, "detector", device="cpu")[k].shape
        np.testing.assert_array_equal(params_to_numpy(got, "detector")[k], w)


def test_encode_targets_and_training_batch_match_jax():
    boxes = [(3, 4, 40, 30), (150, 80, 159, 95), (0, 0, 1, 1),
             (70, 20, 90, 70)]
    np.testing.assert_array_equal(t_det.encode_targets(boxes, 6, 10),
                                  j_det.encode_targets(boxes, 6, 10))
    jf, jt = _batch(8)
    tf, tt = t_train.make_training_batch(
        MultiCameraScene(SceneConfig(seed=100)), np.random.default_rng(0), 8,
        degrade=True)
    assert tf.dtype == jf.dtype and tt.dtype == jt.dtype
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tt, jt)
    assert tt[..., 0].sum() > 0


@pytest.mark.parametrize("case", ["init", "zero_head", "committed"])
def test_detection_loss_and_grads_match_jax(case):
    """``zero_head``: every objectness logit is exactly 0, where jnp.abs
    and jnp.maximum have their tie gradients."""
    variant = "light"
    jp = j_det.init_detector(jax.random.PRNGKey(0), variant)
    if case == "zero_head":
        jp = dict(jp, head=jnp.zeros_like(jp["head"]))
    elif case == "committed":
        jp = j_ckpt.restore(t_det.ARTIFACTS / "detector_light", jp)[0]
    fr, tg = _batch(8)
    jl, jg = jax.jit(jax.value_and_grad(j_det.detection_loss))(
        jp, jnp.asarray(fr), jnp.asarray(tg))
    tp = params_from_numpy(_hwio(jp), "detector", device="cpu")
    (tl, tgr) = t_train.value_and_grad(t_det.detection_loss, tp,
                                       torch.from_numpy(fr),
                                       torch.from_numpy(tg))
    np.testing.assert_allclose(
        float(tl), float(jl),
        rtol=TIE_LOSS_RTOL if case == "zero_head" else LOSS_RTOL)
    want = _hwio(jg)
    got = params_to_numpy(tgr, "detector")
    assert float(np.abs(want["head"]).max()) > 0
    for k, w in want.items():   # a zero gradient must be zero in the port
        scale = float(np.abs(w).max())
        assert float(np.abs(got[k] - w).max()) <= GRAD_TOL * scale, k


class _JitRecorder(types.ModuleType):
    """``jax`` as ``repro.train.detector_train`` sees it, with ``jit``
    recording each step's loss (the third output of the jitted step)."""

    def __init__(self, losses):
        super().__init__("jax")
        self.losses = losses

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        step = jax.jit(fn, **kw)

        def run(*args):
            out = step(*args)
            self.losses.append(float(out[2]))
            return out
        return run


def test_train_detector_matches_jax(monkeypatch):
    """8 steps at batch 4 from seed 0: each step's loss and the final
    weights against JAX's ``train_detector``."""
    j_losses, t_losses = [], []
    monkeypatch.setattr(j_train, "jax", _JitRecorder(j_losses))
    want = _hwio(j_train.train_detector("light", steps=8, batch=4,
                                        cache=False))
    plain = t_train.value_and_grad

    def recorded(*args):
        out = plain(*args)
        t_losses.append(float(out[0]))
        return out
    monkeypatch.setattr(t_train, "value_and_grad", recorded)
    got = params_to_numpy(t_train.train_detector(
        "light", steps=8, batch=4, cache=False, device="cpu"), "detector")
    assert len(j_losses) == len(t_losses) == 8
    np.testing.assert_allclose(t_losses, j_losses, rtol=STEP_RTOL)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-3)
        assert float(np.abs(got[k] - w).max()) <= PARAM_TOL * scale, k


def test_train_detector_cache_restores_the_committed_weights():
    got = t_train.train_detector("light", cache=True, device="cpu")
    want = load_detector("light", "cpu")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k])


def test_train_detector_saves_what_jax_restores(tmp_path, monkeypatch):
    """A port-trained detector saved into a cache directory is JAX's
    checkpoint: JAX's ``train_detector`` (cache=True) restores it equal in
    HWIO, with JAX's metadata."""
    monkeypatch.setattr(t_train, "ARTIFACTS", tmp_path)
    monkeypatch.setattr(j_train, "ARTIFACTS", tmp_path)
    got = params_to_numpy(t_train.train_detector(
        "light", steps=2, batch=2, cache=True, device="cpu"), "detector")
    meta = json.loads((tmp_path / "detector_light" / "manifest.json")
                      .read_text())
    assert meta["step"] == 2 and meta["metadata"]["variant"] == "light"
    assert np.isfinite(meta["metadata"]["loss"])
    want = _hwio(j_train.train_detector("light", steps=2, batch=2,
                                        cache=True))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_train_detector_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.train_detector("light", steps=1, batch=2, cache=False)
