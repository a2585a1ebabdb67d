"""The port's dry-run sweep (``repro_torch.launch.sweep``) and its report
(``repro_torch.roofline.report``) against the dry run and the JAX
package.

Every test writes its artifacts under its own ``tmp_path``
(``sweep.ARTIFACT_DIR`` monkeypatched), never into ``artifacts/``.  Each
artifact of the ``single`` ((16, 16)), ``multi`` ((2, 16, 16)) and
``1x4`` sweeps equals ``dryrun.run_cell`` of its cell; the skipped cells
are exactly JAX's ``cell_supported`` refusals (the eight full-attention
archs at ``long_500k``); a cell made to raise is written as ``error``
with its message and counted as failed; a second sweep reuses the
artifacts unless ``force``.  The report's analytic columns equal JAX's
``analytic_terms`` exactly at its defaults (``TPU_V5E``, ``MeshDims()``)
for every arch x shape, and the port's own at ``H100_SXM`` on one card
and on the sweep's meshes; ``main`` prints both tables with no cell
missing.
"""
import json

import pytest
import torch

from repro.common.config import SHAPES_BY_NAME as J_SHAPES
from repro.common.config import TPU_V5E as J_TPU_V5E
from repro.configs import get_config as j_get_config
from repro.launch.specs import arch_run_config as j_run_config
from repro.launch.specs import cell_supported as j_cell_supported
from repro.roofline.analytic import analytic_terms as j_analytic
from repro_torch.common.config import H100_SXM, SHAPES_BY_NAME, TPU_V5E
from repro_torch.configs import canonical, get_config, list_archs
from repro_torch.launch import dryrun, sweep
from repro_torch.launch.specs import arch_run_config
from repro_torch.roofline import report
from repro_torch.roofline.analytic import MeshDims, analytic_terms

CELLS = [(a, s) for a in list_archs() for s in SHAPES_BY_NAME]
MESHES = {"single": (16, 16), "multi": (2, 16, 16), "1x4": (1, 4)}


@pytest.fixture
def art(tmp_path, monkeypatch):
    monkeypatch.setattr(sweep, "ARTIFACT_DIR", tmp_path / "dryrun_torch")
    return tmp_path / "dryrun_torch"


def _read(art, arch, shape, mesh):
    return json.loads((art / f"{canonical(arch)}__{shape}__{mesh}.json")
                      .read_text())


@pytest.mark.parametrize("mesh", list(MESHES))
def test_artifacts_equal_run_cell(art, mesh):
    lines = []
    res = sweep.sweep([mesh], echo=lines.append)
    assert len(res) == len(CELLS) == 40
    assert sweep.mesh_shape(mesh) == MESHES[mesh]
    for arch, shape in CELLS:
        want = json.loads(json.dumps(dryrun.run_cell(
            arch, shape, mesh=MESHES[mesh])))
        assert _read(art, arch, shape, mesh) == want, (arch, shape)
    assert lines[-1] == "\nSWEEP DONE: 32 ok, 8 skip, 0 failed / 40 cells"


def test_skips_are_jax_refusals(art):
    res = sweep.sweep(["single"], echo=lambda s: None)
    skipped = {(r["arch"], r["shape"]) for r in res if r["status"] == "skip"}
    refused = {(a, s) for a, s in CELLS if not j_cell_supported(a, s)[0]}
    assert skipped == refused
    assert len(refused) == 8 and {s for _, s in refused} == {"long_500k"}


def test_a_cell_that_raises_is_recorded_as_error(art, monkeypatch):
    real = dryrun.run_cell

    def run_cell(arch, shape, layers=None, mesh=None):
        if (canonical(arch), shape) == ("granite_8b", "decode_32k"):
            raise RuntimeError("made to fail")
        return real(arch, shape, layers, mesh)
    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    lines = []
    res = sweep.sweep(["1x4"], archs=["granite-8b", "zamba2-7b"],
                      echo=lines.append)
    bad = [r for r in res if r["status"] == "error"]
    assert len(bad) == 1
    assert bad[0]["error"] == "RuntimeError: made to fail"
    assert _read(art, "granite-8b", "decode_32k", "1x4") == bad[0]
    assert lines[-1] == "\nSWEEP DONE: 6 ok, 1 skip, 1 failed / 8 cells"
    assert any("error   RuntimeError: made to fail" in x for x in lines)
    assert sweep.main(["--mesh", "1x4", "--archs", "granite-8b"]) == 1
    monkeypatch.setattr(dryrun, "run_cell", real)
    # an error is run again; an ok or skip artifact is reused
    assert sweep.main(["--mesh", "1x4", "--archs", "granite-8b"]) == 0
    assert _read(art, "granite-8b", "decode_32k", "1x4")["status"] == "ok"


def test_rerun_reuses_artifacts_unless_forced(art):
    sweep.sweep(["single"], archs=["xlstm-125m"], echo=lambda s: None)
    p = art / "xlstm_125m__train_4k__single.json"
    d = json.loads(p.read_text())
    p.write_text(json.dumps(dict(d, marker=1)))
    sweep.sweep(["single"], archs=["xlstm-125m"], echo=lambda s: None)
    assert json.loads(p.read_text())["marker"] == 1
    sweep.sweep(["single"], archs=["xlstm-125m"], force=True,
                echo=lambda s: None)
    assert json.loads(p.read_text()) == d


def test_cut_depths(art):
    """``--layers``: the cells of an arch also at a cut depth, as
    ``run_cell(arch, shape, layers, mesh)``; an artifact without that cut
    is not reused."""
    sweep.sweep(["1x4"], archs=["olmoe-1b-7b"], echo=lambda s: None)
    assert sweep.main(["--mesh", "1x4", "--archs", "olmoe-1b-7b",
                       "--layers", "olmoe-1b-7b=4"]) == 0
    for shape in ("train_4k", "decode_32k"):
        got = _read(art, "olmoe-1b-7b", shape, "1x4")
        want = json.loads(json.dumps(dryrun.run_cell(
            "olmoe-1b-7b", shape, 4, mesh=(1, 4))))
        assert got == want and got["cut"]["layers"] == 4


def test_cli_both_and_dxm(art, capsys):
    assert sweep.main(["--mesh", "both"]) == 0
    assert sweep.main(["--mesh", "1x4", "--shapes", "decode_32k"]) == 0
    out = capsys.readouterr().out
    assert "SWEEP DONE: 64 ok, 16 skip, 0 failed / 80 cells" in out
    assert "SWEEP DONE: 10 ok, 0 skip, 0 failed / 10 cells" in out
    assert len(list(art.glob("*.json"))) == 90
    with pytest.raises(ValueError):
        sweep.mesh_shape("1x4x2x2")


def test_report_analytic_columns_equal_jax():
    """At JAX's defaults (``TPU_V5E``, the (16, 16) ``MeshDims()``) every
    arch x shape's terms equal JAX's ``analytic_terms`` exactly."""
    assert vars(TPU_V5E) == vars(J_TPU_V5E)
    rows = report.roofline_rows(TPU_V5E, MeshDims())
    assert [(r["arch"], r["shape"]) for r in rows] == CELLS
    for r in rows:
        want = j_analytic(j_get_config(r["arch"]), J_SHAPES[r["shape"]],
                          j_run_config(r["arch"], r["shape"],
                                       "single").microbatches)
        assert {k: r[k] for k in want} == want, (r["arch"], r["shape"])


@pytest.mark.parametrize("mesh", [report.ONE_CARD, sweep.mesh_dims((16, 16)),
                                  sweep.mesh_dims((2, 16, 16)),
                                  sweep.mesh_dims((1, 4))])
def test_report_at_h100_is_the_ports_analytic_terms(mesh):
    for r in report.roofline_rows(H100_SXM, mesh):
        want = analytic_terms(get_config(r["arch"]),
                              SHAPES_BY_NAME[r["shape"]],
                              arch_run_config(r["arch"],
                                              r["shape"]).microbatches,
                              mesh, H100_SXM)
        assert {k: r[k] for k in want} == want
    if mesh == report.ONE_CARD:
        assert all(r["a_collective_s"] == 0 for r in report.roofline_rows(
            H100_SXM, mesh))


def test_report_prints_both_tables(art, capsys):
    sweep.main(["--mesh", "both"])
    sweep.main(["--mesh", "1x4"])
    capsys.readouterr()
    assert report.main([]) == 0
    out = capsys.readouterr().out
    for head in ("## Dry-run table", "## What fits where",
                 "## Roofline table, one card", "## Roofline table, mesh "
                 "single (256 cards, tp 16"):
        assert head in out
    assert "MISSING" not in out
    assert out.count("H100_SXM constants: 989 TFLOP/s, 3.35 TB/s HBM, "
                     "450 GB/s link, 80 GB") == 3
    dry = out.split("## What fits")[0]
    assert dry.count("| ok |") == 96 and dry.count("| skip |") == 24
    assert "granite_8b | train_4k | 1x4 | ok |" in dry


# -- the traced sweep (``--trace``): a subprocess a cell ---------------------------

TRACED = ("xlstm-125m", "decode_32k")     # a cell that traces in seconds


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a card")
def test_trace_takes_the_card_unless_asked_for_the_cpu(art):
    """A trace's fake tensors take the card's device type: without a card
    ``build_cell``, ``trace_cell`` and ``dryrun --trace`` raise (the
    error is the cell's record) unless the caller asks for the CPU."""
    from repro_torch.launch.mesh import fake_world, shutdown
    from repro_torch.launch.specs import build_cell
    mesh = fake_world((1, 1))
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_cell(*TRACED, mesh)
    finally:
        shutdown()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.trace_cell(*TRACED, (1, 1))
    assert dryrun.main(["--arch", TRACED[0], "--shape", TRACED[1],
                        "--trace"]) == 1
    d = _read(art, *TRACED, "1x1")
    assert d["status"] == "error" and "device='cpu'" in d["error"]


def test_trace_cli_writes_jax_blocks(art):
    """``dryrun --trace --mesh 16x16`` writes the sweep's ``single``
    artifact with JAX's blocks: rank 0 of a world of 256."""
    assert dryrun.main(["--arch", TRACED[0], "--shape", TRACED[1],
                        "--mesh", "16x16", "--trace", "--device",
                        "cpu"]) == 0
    d = _read(art, *TRACED, "single")
    assert {"memory", "cost", "collectives", "roofline", "devices",
            "trace_s", "meta"} <= set(d)
    assert d["devices"] == 256 and d["activations"] == "traced"
    assert set(d["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes",
                                "peak_estimate_bytes"}
    assert set(d["cost"]) >= {"flops", "bytes accessed", "transcendentals"}
    assert d["memory"]["alias_bytes"] == d["per_rank"]["cache_bytes"]
    assert d["memory"]["argument_bytes"] >= d["per_rank"]["total_bytes"]
    assert d["roofline"]["bottleneck"] in ("compute_s", "memory_s",
                                           "collective_s")
    # the shapes-only figures are the untraced run's
    plain = json.loads(json.dumps(dryrun.run_cell(*TRACED,
                                                  mesh=(16, 16))))
    assert {k: d[k] for k in plain if k != "activations"} == {
        k: v for k, v in plain.items() if k != "activations"}


def test_traced_sweep_runs_a_subprocess_a_cell(art, monkeypatch):
    calls = []
    real = sweep.subprocess.run

    def run(cmd, **kw):
        calls.append(cmd)
        return real(cmd, **kw)
    monkeypatch.setattr(sweep.subprocess, "run", run)
    lines = []
    res = sweep.sweep(["1x4"], archs=[TRACED[0], "granite-8b"],
                      shapes=[TRACED[1], "long_500k"], trace=True,
                      device="cpu", echo=lines.append)
    assert [r["status"] for r in res] == ["ok", "ok", "ok", "skip"]
    assert len(calls) == 4 and all("--trace" in c for c in calls)
    assert "peak=" in lines[0] and "dom=" in lines[0] and "frac=" in lines[0]
    assert lines[-1] == "\nSWEEP DONE: 3 ok, 1 skip, 0 failed / 4 cells"
    # a traced artifact is reused; an untraced one is traced again
    calls.clear()
    sweep.sweep(["1x4"], archs=[TRACED[0]], shapes=[TRACED[1]], trace=True,
                echo=lambda s: None)
    assert calls == []
    sweep.sweep(["1x4"], archs=[TRACED[0]], shapes=["long_500k"],
                force=True, echo=lambda s: None)
    assert calls == [] and "memory" not in _read(art, TRACED[0],
                                                  "long_500k", "1x4")
    sweep.sweep(["1x4"], archs=[TRACED[0]], shapes=["long_500k"],
                trace=True, device="cpu", echo=lambda s: None)
    assert len(calls) == 1


def test_traced_cell_that_runs_out_of_time_is_recorded(art):
    lines = []
    res = sweep.sweep(["1x4"], archs=[TRACED[0]], shapes=[TRACED[1]],
                      trace=True, timeout=0.5, echo=lines.append)
    assert res[0]["status"] == "timeout"
    assert res[0]["error"].startswith("trace exceeded 0.5s")
    assert _read(art, *TRACED, "1x4")["status"] == "timeout"
    # its shapes-only figures stay
    want = json.loads(json.dumps(dryrun.run_cell(*TRACED, mesh=(1, 4))))
    assert {k: res[0][k] for k in want if k != "status"} == {
        k: v for k, v in want.items() if k != "status"}
    assert lines[-1] == "\nSWEEP DONE: 0 ok, 0 skip, 1 failed / 1 cells"
    assert "timeout" in lines[0]
    # a timeout runs again next time
    res = sweep.sweep(["1x4"], archs=[TRACED[0]], shapes=[TRACED[1]],
                      trace=True, device="cpu", echo=lambda s: None)
    assert res[0]["status"] == "ok"


def test_report_reads_the_traced_columns(art, capsys):
    sweep.main(["--mesh", "both"])
    sweep.main(["--mesh", "1x4"])
    sweep.main(["--mesh", "single", "--archs", TRACED[0], "--shapes",
                TRACED[1], "--trace", "--device", "cpu"])
    capsys.readouterr()
    d = _read(art, *TRACED, "single")
    assert report.main([]) == 0
    out = capsys.readouterr().out
    dry = out.split("## What fits")[0]
    arch = canonical(TRACED[0])
    row = next(x for x in dry.splitlines()
               if x.startswith(f"| {arch} | {TRACED[1]} | single |"))
    assert d["trace_device"] == "cpu"
    assert row.endswith(f"| {d['memory']['peak_estimate_bytes'] / 1e9:.1f} "
                        "(cpu) "
                        f"| {d['roofline']['collective_traffic_per_chip'] / 1e9:.2f} "
                        f"| {d['trace_s']:.0f} |")
    assert dry.count("not traced") == 96 - 1
    roof = out.split("## Roofline table, mesh single")[1]
    row = next(x for x in roof.splitlines()
               if x.startswith(f"| {arch} | {TRACED[1]} |"))
    assert f"| {d['roofline']['collective_s']:.4f} |" in row
