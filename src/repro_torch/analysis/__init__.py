"""Static audit of the port: the counterpart of ``repro.analysis``.

The port's main contract is that an episode's slot step, captured as CUDA
graphs, never waits on the card before its one harvest.  The card checks
it at run time (``torch.cuda.set_sync_debug_mode("error")`` in
``chip_smoke.py``); these passes check it from the source and from one
eager run of each program on the CPU, in seconds.

Three passes
------------
``repro_torch.analysis.lint`` (CLI: ``python -m repro_torch.analysis.lint``)
    AST pass over ``src/repro_torch/`` (no import of the linted code),
    inside the registered scopes (``lint.TRACED_SCOPES``: the slot step and
    the ``_EpisodeGraph`` bodies of ``core/fleet.py``, the device control
    and elastic update, ``core/codec.py``, the episode's dispatch, the
    utility MLP, the device allocators, the fleet encode, the stream's
    window dispatch, and the LM's decode path), with JAX's rule ids:

    ===============  ========================================================
    rule id          fires on
    ===============  ========================================================
    ``host-sync``    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()``
                     / ``float()`` / ``int()`` / ``bool()`` of a non-constant
                     / ``np.asarray`` / ``.synchronize()``
    ``traced-branch``  Python ``if``/``while`` on a value a ``torch.`` call
                     made in the same scope — a host read of the device
    ``unseeded-rng``  numpy's global RNG, stdlib ``random.*``, ``torch.rand*``
                     / ``randn*`` / ``randint`` / ``normal`` without
                     ``generator=``
    ===============  ========================================================

``repro_torch.analysis.graph_audit`` (CLI: ``python -m repro_torch.analysis.graph_audit``)
    Over the registry of ``programs`` (every ``episode/<method>/b<bucket>``
    graph set, the slot step, the control programs): matrix-count,
    two-harvest, fleet-size-independent keys (a ``TorchDispatchMode`` op
    multiset at C = 5 and 9), no host read in any program
    (``NoHostReads``, a ``TorchFunctionMode``), and JAX's donation check
    (no program writes its inputs; the LM's train step and decode write
    exactly the leaves JAX donates).

``repro_torch.analysis.manifest`` (CLI: ``python -m repro_torch.analysis.manifest``)
    Each program's name, graphs and input shapes and dtypes by name; the
    tests compare it live with JAX's registry, with every difference named
    in ``manifest.EXCEPTIONS``; traced (the CLI's default), JAX's
    signature, donated inputs, cost and memory fields.

Pragma grammar
--------------
As in JAX: a justified exception carries ``# audit: allow(<rule>)`` with a
one-line reason on the offending line or the line directly above it, or
on (or directly above) a ``def`` line, covering that whole function::

    # audit: allow(host-sync) one designed fetch: the final loss, after the loop
    return params, float(loss.detach())

The rule id must match exactly; a bare ``# audit: allow`` matches nothing.
A finding that marks a real sync in a captured scope is a fault, repaired
in the code; the pragmas mark designed fetches (the fit's final loss, the
host allocator's table, the MoE group sizes, the engine's sampled tokens)
and host values (static ints, host numpy arrays) inside a scope.

The traced dry run
------------------
``repro_torch.analysis.trace_cost`` is the counterpart of JAX's lowering
and compiling of a program for its ``memory_analysis()``,
``cost_analysis()`` and collectives: a program runs once on fake tensors
(on a fake process group for one rank of a mesh of any size) under a
dispatch mode that counts its live storages, products, bytes,
transcendentals, collectives and the kernels' stand-ins' launches.  The
manifest's traced fields, the audit's donation check and the dry run's
``--trace`` (``launch/dryrun.py``, ``launch/sweep.py``,
``roofline/report.py``) read it.

What has no counterpart
-----------------------
The Pallas ``INTERPRET`` switches: the port's kernels are CUDA C++ built
for the card, with plain PyTorch versions on the CPU.
"""
