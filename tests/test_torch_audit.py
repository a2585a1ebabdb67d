"""The port's static audit (``repro_torch.analysis``) against the JAX
package's: the registry's matrix of episode programs, two harvests per
episode, keys independent of the fleet size, no host read in any
registered program (``graph_audit.NoHostReads``), and the manifest
against JAX's ``get_programs()``, name by name and input by input, with
every difference one that ``manifest.EXCEPTIONS`` names.  The programs
run at the harness's small shapes (C = 3, an episode for 2 slots)."""
import json

import pytest
import torch
from jax.tree_util import DictKey, tree_flatten_with_path

# one intra-op thread: the suite runs several pytest workers at once
torch.set_num_threads(1)

import harness  # noqa: E402
from repro.analysis import programs as j_programs  # noqa: E402
from repro.core.fleet import EPISODE_BUCKETS  # noqa: E402
from repro_torch.analysis import graph_audit, manifest  # noqa: E402
from repro_torch.analysis import programs as t_programs  # noqa: E402
from repro_torch.core import fleet  # noqa: E402
from repro_torch.data.synthetic import SceneConfig  # noqa: E402

SMALL = SceneConfig(seed=0, num_cameras=3)


@pytest.fixture(scope="module")
def programs():
    return t_programs.get_programs(canon=t_programs.Canonical(
        t_programs.canonical_system("cpu", SMALL)))


def test_canonical_deployment_as_jax():
    assert t_programs.W_CAP_KBPS == j_programs.W_CAP_KBPS == \
        harness.W_CAP_KBPS
    assert t_programs.EVAL_FRAMES == j_programs.EVAL_FRAMES
    assert t_programs.CTRL_SCAN_T == j_programs.CTRL_SCAN_T
    assert tuple(t_programs.METHODS) == tuple(j_programs.METHODS)
    assert tuple(fleet.EPISODE_BUCKETS) == tuple(EPISODE_BUCKETS)


def test_matrix_count(programs):
    episodes = [p for p in programs if p.kind == "episode"]
    assert [p.name for p in episodes] == [
        f"episode/{m}/b{b}" for m in j_programs.METHODS
        for b in EPISODE_BUCKETS]
    assert all(p.graphs == ("full0", "full1", "drain0", "drain1")
               and p.statics.pipelined for p in episodes)
    assert len(programs) == 21
    assert all(t.is_meta for p in programs for t in p.inputs.values())


def test_audit_holds_over_the_registry(programs):
    """Every program under NoHostReads, two harvests per episode at T = 2,
    and the key multiset at C = 5 and 9."""
    assert graph_audit.audit(programs, device="cpu") == []


@pytest.mark.parametrize("grown", [9, 16])
def test_key_ops_do_not_depend_on_the_fleet_size(grown):
    base = graph_audit.key_op_multiset(5, "cpu")
    assert graph_audit.check_key_ops(base, graph_audit.key_op_multiset(
        grown, "cpu"), f"C=5 vs C={grown}") is None
    assert base["aten.__lshift__.Scalar"] == 60


def test_key_ops_check_catches_a_per_camera_chain():
    base = graph_audit.key_op_multiset(5, "cpu")
    grown = base.copy()
    grown["aten.add.Tensor"] += 4            # one more op per extra camera
    assert "depend on the fleet size" in graph_audit.check_key_ops(
        base, grown, "C=5 vs C=9")


def test_audit_catches_an_injected_host_read(programs, monkeypatch):
    keep = fleet.keep_selection

    def reads(k, F):
        k.sum().item()
        return keep(k, F)
    monkeypatch.setattr(fleet, "keep_selection", reads)
    failures = graph_audit.audit([p for p in programs
                                  if p.name == "episode/static/b8"],
                                 device="cpu")
    assert ("no-host-read[episode/static/b8]: host read: item"
            in failures), failures


def test_two_harvest_shapes(programs):
    prog = next(p for p in programs if p.name == "episode/reducto/b16")
    packs, cpacks, carry = prog.run(2)
    assert graph_audit.stacked_outputs((packs, cpacks, carry), 2) == \
        [(2, 2, 3), (2, 4)]


def _key_name(k) -> str:
    return str(k.key) if isinstance(k, DictKey) else k.name


def jax_reference():
    """JAX's registry as {program: (kind, [(input, shape, dtype)])}, each
    leaf named by ``manifest.JAX_ARGS``."""
    ref = {}
    for p in j_programs.get_programs():
        inputs = []
        for arg, tree in zip(manifest.JAX_ARGS[p.kind], p.abs_args,
                             strict=True):
            for path, leaf in tree_flatten_with_path(tree)[0]:
                name = arg + "".join("." + _key_name(k) for k in path)
                inputs.append((name, tuple(leaf.shape), str(leaf.dtype)))
        ref[p.name] = (p.kind, inputs)
    return ref


def test_manifest_against_jax_programs():
    drift, used = manifest.diff_against(
        manifest.build_manifest(device="cpu"), jax_reference())
    assert drift == [], "\n".join(drift)
    assert used == set(range(len(manifest.EXCEPTIONS))), \
        "an exception no difference needs: remove it"


def test_manifest_names_an_unexplained_difference():
    ref = jax_reference()
    kind, inputs = ref["episode/jcab/b16"]
    ref["episode/jcab/b16"] = (kind, [
        (n, s + (1,) if n == "carry.ref" else s, d) for n, s, d in inputs])
    drift, _ = manifest.diff_against(manifest.build_manifest(device="cpu"),
                                     ref)
    assert len(drift) == 1 and "episode/jcab/b16: carry.ref" in drift[0]


def test_manifest_cli(capsys):
    assert manifest.main(["--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out)
    entry = doc["programs"]["episode/deepstream/b32"]
    assert entry["graphs"] == ["full0", "full1", "drain0", "drain1"]
    assert ["xs.trace", [32], "float32"] in entry["inputs"]
    assert len(doc["programs"]) == 21


@pytest.mark.parametrize("entry", ["graph_audit", "manifest", "registry"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                           entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"graph_audit": lambda: graph_audit.main(["--cameras", "3"]),
            "manifest": lambda: manifest.main([]),
            "registry": lambda: t_programs.get_programs(kinds=["ctrl"])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call[entry]()
