"""JAX's side of ``tests/test_torch_dryrun_trace.py``, run as a script in
a subprocess of 4 host devices (``--xla_force_host_platform_device_count
=4``): for each case, JAX's ``launch.specs.build_cell`` at a smoke config
and a small shape cell on a (data, model) mesh; each argument leaf's
shard shape, and (``compile``) ``memory_analysis()``, the collectives
``parse_collectives`` reads from the compiled HLO and the donated leaf
indices, written as JSON.

    python _torch_dryrun_trace_worker.py IN.json OUT.json
"""
import json
import sys
import warnings
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402

from repro.common.config import OptimizerConfig, RunConfig, ShapeCell  # noqa
from repro.configs import smoke_config  # noqa: E402
from repro.launch import specs  # noqa: E402
from repro.launch.mesh import mesh_with_auto_axes  # noqa: E402
from repro.roofline.analysis import parse_collectives  # noqa: E402

DONATE = {"train": (0, 1), "decode": (2,), "prefill": ()}


def main() -> None:
    assert jax.device_count() == 4, jax.device_count()
    cases = json.loads(Path(sys.argv[1]).read_text())
    out = {}
    for c in cases:
        cfg = smoke_config(c["arch"]).replace(**c.get("kw", {}))
        run = RunConfig(model=cfg, opt=OptimizerConfig(),
                        microbatches=c["microbatches"])
        cell = ShapeCell(c["shape"], c["seq"], c["batch"], c["kind"])
        specs.arch_run_config = lambda *a, run=run: run
        specs.SHAPES_BY_NAME[c["shape"]] = cell
        mesh = mesh_with_auto_axes(
            np.asarray(jax.devices()).reshape(c["mesh"]), ("data", "model"))
        fn, args, in_sh, out_sh, meta = specs.build_cell(c["arch"],
                                                         c["shape"], mesh)
        leaves = jax.tree.leaves(args)
        shards = jax.tree.leaves(in_sh)
        rec = {"meta": meta,
               "shards": [[list(s.shard_shape(a.shape)), str(a.dtype)]
                          for a, s in zip(leaves, shards)]}
        if c["compile"]:
            with warnings.catch_warnings(), mesh:
                warnings.simplefilter("ignore")
                lowered = jax.jit(fn, in_shardings=in_sh,
                                  out_shardings=out_sh,
                                  donate_argnums=DONATE[c["kind"]]
                                  ).lower(*args)
                compiled = lowered.compile()
            mem = compiled.memory_analysis()
            rec["memory"] = {
                "argument_bytes": int(mem.argument_size_in_bytes),
                "output_bytes": int(mem.output_size_in_bytes),
                "temp_bytes": int(mem.temp_size_in_bytes),
                "alias_bytes": int(mem.alias_size_in_bytes)}
            rec["collectives"] = parse_collectives(compiled.as_text())
            info = jax.tree.leaves(lowered.args_info,
                                   is_leaf=lambda x: hasattr(x, "donated"))
            rec["donated"] = [i for i, a in enumerate(info) if a.donated]
        out[c["name"]] = rec
    Path(sys.argv[2]).write_text(json.dumps(out))
    print("DRYRUN-TRACE-REFERENCE-DONE")


if __name__ == "__main__":
    main()
