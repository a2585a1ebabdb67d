#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:  ``python3 chip_smoke.py``  (``--profile`` adds a torch.profiler
pass over one episode and host-sync counts of both runners).  It needs no
JAX.  In order it prints:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build time (nvcc for sm_90a, every source at once);
  3. each hand-written kernel against its plain PyTorch version on the card
     at the main path's shapes: edge_motion exact, tx_codec bitwise in
     bitrate and CRF mode (also at frame sizes that are multiples of
     neither 4 nor the pool factor, every pool factor), knapsack_dp values
     bitwise and choices equal (plus the host solve against the
     exhaustive oracle), flash_decode in bf16 and f32 at granite-8b's
     decode shape (B=4, S=2048, 32/8 heads, hd=128) and at the GQA groups
     and head sizes of the other configs (G = 1, 7, 16; hd 64, 112, 128),
     valid lengths 0 to 2048 and one on a range boundary, with and
     without the fresh token;
  4. the four-method whole-trace episode (5 cameras, 96x160, 10 frames per
     slot, T=8): finite logs, F1 in [0, 1], every kernel of the path
     launched, the card's logs equal to the port's own CPU run (<= 1e-5);
  5. the pipelined ``run()`` loop, four methods, same cells: the same
     checks, knapsack_dp launched once per slot for deepstream and jcab,
     logs equal to the card's episode and to the CPU ``run()`` (<= 1e-5);
  6. ``alloc="host"`` against device control, and the sequential runner
     against the pipelined one, on the card;
  7. the LM serving tier: the f32 smoke engine run on the card against
     the CPU (tokens identical, logits <= 1e-4), then ``ServeEngine`` over
     granite-8b at its published width and depth with seeded random bf16
     weights (6 requests on 4 slots, max_seq 2048, 16 new tokens each):
     every request drains, flash_decode runs once per layer and decode
     call and never in prefill, one request's last decode agrees with a
     prefill of its tokens and the kernel route with the plain one (both
     within 5e-2 of max |logit|); prefill and decode ms, tokens/s, peak
     memory and one profiled decode;
  8. ms/slot of both runners per method at C=5 and C=16 (median of 3 after
     a warm-up, with min and max, the two runners timed in turns), and
     each kernel's time beside its plain version's and its bound (and, for
     flash_decode, scaled_dot_product_attention's as the library
     yardstick), tagged with the card and power limit;
  9. the wall time, one JSON line of kernel records, then the device line
     (last).

Each path runs with every kernel's launch counter set to 0 just before it
and read just after.  Any mismatch ends the run with a non-zero exit code;
no phase's failure is caught.  Without a CUDA device it exits non-zero
before printing a result.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12      # H100 SXM float32, outside the tensor cores
METHODS = ("deepstream", "jcab", "reducto", "static")
T_SLOTS = 8
T_CPU = 4                    # slots of the CPU runs the card is held to
LOG_KEYS = ("utility", "bytes", "alloc_kbps", "extra", "area")
DP_COSTS = (1, 2, 4, 8, 16, 20)   # the default codec's grid (d = 50 Kbps)


def cuda_ms(torch, fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(prof, name=None) -> float:
    """Kernel time recorded on the card (CUPTI) in a profiler window: every
    kernel, or those whose name contains ``name``."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation
               and (name is None or name in e.key))


def device_ms(torch, fn, iters: int, name=None) -> float:
    """Mean kernel time on the card per call of ``fn`` (launch gaps on the
    host excluded), from torch.profiler."""
    return device_ms_count(torch, fn, iters, name)[0]


def device_ms_count(torch, fn, iters: int, name=None):
    """``device_ms`` and the kernels per call it counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = device_us(prof, name)
    if not us > 0.0:
        raise AssertionError(f"the profiler recorded no kernel time for "
                             f"{name or 'the plain version'}")
    count = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and not e.is_user_annotation
                and (name is None or name in e.key))
    return us / 1e3 / iters, count / iters


def max_log_diff(ref: dict, got: dict, keys, tol: float,
                 what: str = "card vs CPU") -> dict:
    """Per-key max |got - ref|; raises past tol * max(1, |ref|max) (the
    JAX package's harness rule)."""
    import numpy as np
    out = {}
    for k in keys:
        r, g = np.asarray(ref[k], float), np.asarray(got[k], float)
        d = float(np.max(np.abs(r - g))) if r.size else 0.0
        scale = max(1.0, float(np.max(np.abs(r))) if r.size else 1.0)
        if not d <= tol * scale:
            raise AssertionError(f"key {k}: {what} diff {d} > {tol * scale}")
        out[k] = d
    return out


def check_close(ref: dict, got: dict, atol: dict, rtol: dict, what: str
                ) -> dict:
    """Per-key max |got - ref| against absolute and relative tolerances
    (the JAX package's cross-mode test tolerances)."""
    import numpy as np
    out = {}
    for k in sorted(set(atol) | set(rtol)):
        r, g = np.asarray(ref[k], float), np.asarray(got[k], float)
        d = np.abs(g - r)
        lim = atol.get(k, 0.0) + rtol.get(k, 0.0) * np.abs(r)
        if not np.all(d <= lim):
            raise AssertionError(f"{what} key {k}: diff {d.max()} beyond "
                                 f"atol {atol.get(k, 0.0)} rtol "
                                 f"{rtol.get(k, 0.0)}")
        out[k] = float(d.max()) if d.size else 0.0
    return out


def check_logs(logs: dict, what: str) -> None:
    import numpy as np
    for k in LOG_KEYS + ("mean_f1",):
        if not np.all(np.isfinite(logs[k])):
            raise AssertionError(f"{what}: non-finite {k}")
    if not np.all((logs["mean_f1"] >= 0.0) & (logs["mean_f1"] <= 1.0)):
        raise AssertionError(f"{what}: F1 outside [0, 1]")


def slot_ms(torch, run, T: int) -> float:
    """ms/slot of one run on the host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / T


# -- the LM serving tier (slice 3) ---------------------------------------

FD_SHAPE = (4, 2048, 32, 8, 128)           # granite-8b decode: B, S, H, KV, hd
FD_VALID = (0, 1, 511, 1500, 2048)
# where the run sits; a full cache; one tile in one range (the latency of
# a single block: launch, q, one tile, no merge)
FD_TIMED = (528, 2048, 64)
BF16_FLOPS_PER_S = 989e12                  # H100 SXM bf16 tensor cores
SMALL_PROMPTS = (8, 8, 12, 12, 5, 8)       # tests/test_torch_serve.py
FULL_PROMPTS = (512, 512, 384, 384, 512, 256)
FULL_NEW, FULL_SLOTS, FULL_SEQ = 16, 4, 2048


def fd_inputs(torch, dev, dtype, B, S, H, KV, hd, seed=0):
    """q, k, v, k1, v1 of standard normals from numpy (seeded)."""
    import numpy as np
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(0, 1, s).astype(np.float32)).to(
                dev, dtype)
            for s in ((B, 1, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, 1, KV, hd), (B, 1, KV, hd))]


# B4's parity shapes (B, S, H, KV, hd): granite-8b's decode, then the GQA
# groups and head sizes of the other configs: G = 1 at hd 128, G = 7
# (yi-34b, 56/8), G = 16 (llama3-405b, 128/8), G = 1 at hd 64
# (seamless-m4t) and at hd 112 (zamba2)
FD_PARITY = (FD_SHAPE, (4, 2048, 8, 8, 128), (2, 2048, 56, 8, 128),
             (1, 2048, 128, 8, 128), (2, 2048, 16, 16, 64),
             (1, 2048, 32, 32, 112))


def range_boundary_len(fd_ops, B, S, KV, G, hd, elem, sms) -> int:
    """The longest valid length below S that ends exactly on the last of
    several ranges of the kernel's plan."""
    for n in range(S - 64, 63, -64):
        per, nsplit, _ = fd_ops.split_plan(n, B * KV, sms, G, hd, elem)
        if nsplit > 1 and n % (per * fd_ops.TILE) == 0:
            return n
    raise AssertionError(f"no range boundary below {S}")


def check_flash_decode(torch, dev) -> dict:
    """B4 against its plain version on the card at every FD_PARITY shape
    in bf16 and f32, at valid lengths FD_VALID and one that ends on a range
    boundary: ``flash_decode`` (out, m, l) and ``flash_decode_with_new``
    (against the same merge of the plain version's stats).  out to <= 1e-5
    in float32 and 2e-2 in bfloat16 (tests/test_kernels.py's rules), m to
    <= 1e-5, l to <= 1e-5 of max(1, max l) (a sum of up to S exponentials;
    the JAX harness's scaled rule).  The wrapper's shared-memory plan is
    held to the library's own.  Returns the worst |diff| of out per
    dtype."""
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref
    sms = fd_ops._sm_count(dev)
    smem_c = fd_ops._fns()[1]
    worst = {}
    for shape in FD_PARITY:
        B, S, H, KV, hd = shape
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, k1, v1 = fd_inputs(torch, dev, dt, *shape)
            elem = q.element_size()
            for st in (1, 2, 3):
                if smem_c(int(elem == 2), hd, st) != fd_ops.smem_bytes(
                        elem, hd, st):
                    raise AssertionError("the wrapper plans with another "
                                         "shared-memory size than the kernel")
            tol = 1e-5 if dt == torch.float32 else 2e-2
            edge = range_boundary_len(fd_ops, B, S, KV, H // KV, hd, elem,
                                      sms)
            for vl in FD_VALID + (edge,):
                before = fd_ops.LAUNCHES
                out, m, l = fd_ops.flash_decode_cuda(q, k, v, vl)
                torch.cuda.synchronize()
                if fd_ops.LAUNCHES != before + 1:
                    raise AssertionError("flash_decode counted "
                                         f"{fd_ops.LAUNCHES - before} launches")
                wo, wm, wl = fd_ref.flash_decode_ref(q, k, v, kv_valid_len=vl)
                e_out = float((out.float() - wo.float()).abs().max())
                e_m = float((m - wm).abs().max())
                e_l = float((l - wl).abs().max())
                l_tol = 1e-5 * max(1.0, float(wl.abs().max()))
                got = fd_ops.flash_decode_with_new(q, k, v, k1, v1,
                                                   kv_valid_len=vl)
                want = fd_ops.merge_new(q, k1, v1, wo, wm, wl)
                e_new = float((got.float() - want.float()).abs().max())
                key = str(dt).split(".")[-1]
                worst[key] = max(worst.get(key, 0.0), e_out, e_new)
                n_pos = min(vl, S) if vl > 0 else S
                plan = fd_ops.split_plan(n_pos, B * KV, sms, H // KV, hd,
                                         elem)
                print(f"flash_decode vs plain {shape} {key} valid {vl} "
                      f"(plan {plan}): max |diff| out {e_out:.3g}, m "
                      f"{e_m:.3g}, l {e_l:.3g} (<= {l_tol:.3g}); with the "
                      f"fresh token {e_new:.3g}")
                if not (e_out <= tol and e_new <= tol and e_m <= 1e-5
                        and e_l <= l_tol):
                    raise AssertionError("flash_decode differs from its "
                                         "plain version")
    return worst


def check_tx_codec_ragged(torch, dev) -> float:
    """B2 against its plain version at frame sizes that are multiples of
    neither 4 nor any pool factor, each branch alone and mixed, in bitrate
    mode (the kernel's wrapper) and CRF mode (the fleet encode against the
    per-camera plain encode): bitwise equal.  Returns the worst |diff|."""
    from repro_torch.common import prng
    from repro_torch.core import codec
    from repro_torch.kernels.tx_codec import ops as tx_ops
    from repro_torch.kernels.tx_codec import ref as tx_ref
    worst = 0.0
    for C, N, H, W in ((4, 3, 101, 157), (4, 2, 37, 45), (3, 2, 9, 13)):
        gen = torch.Generator(device=dev).manual_seed(H * W)
        frames = torch.rand((C, N, H, W), device=dev, generator=gen)
        keys = prng.fold_in(prng.PRNGKey(13, device=dev),
                            torch.arange(C, device=dev))
        noise = prng.normal(keys, frames.shape[1:])
        levels = torch.linspace(4.0, 256.0, C, device=dev)
        sigma = torch.linspace(0.001, 0.3, C, device=dev)
        for ks in ([1] * C, [2] * C, [4] * C, [8] * C,
                   [(1, 2, 4, 8)[i % 4] for i in range(C)]):
            kcam = torch.tensor(ks, dtype=torch.int32, device=dev)
            got = tx_ops.tx_codec_cuda(frames, noise, levels, sigma, kcam)
            torch.cuda.synchronize()
            want = tx_ref.tx_codec_ref(frames, noise, levels, sigma, kcam)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            print(f"tx_codec vs plain {(C, N, H, W)} k={ks}: max |diff| "
                  f"{err}")
            if not torch.equal(got, want):
                raise AssertionError("tx_codec differs from its plain "
                                     "version")
        res = torch.tensor([1.0, 0.75, 0.5, 0.25], device=dev)[
            torch.arange(C, device=dev) % 4]
        roi = torch.linspace(500.0, float(H * W), C, device=dev)
        for blur in (True, False):
            got, _ = tx_ops.encode_fleet_crf(codec.CodecConfig(), frames, roi,
                                             keys, res, blur=blur)
            torch.cuda.synchronize()
            err = 0.0
            for c in range(C):
                want, _ = codec.encode_segment_crf(
                    codec.CodecConfig(), frames[c], roi[c], keys[c],
                    res[c] if blur else None)
                err = max(err, float((got[c] - want).abs().max()))
            worst = max(worst, err)
            print(f"tx_codec CRF vs plain {(C, N, H, W)} blur={blur}: max "
                  f"|diff| {err}")
            if err != 0.0:
                raise AssertionError("tx_codec CRF differs from its plain "
                                     "version")
    return worst


def sass_counts(lib_path) -> dict:
    """Tensor-core (HMMA, HGMMA) and TMA-load (UTMALDG) instructions in a
    built library's SASS, where the toolkit has cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass))
            for op in ("HMMA", "HGMMA", "UTMALDG")}


class TimedLM:
    """Passes calls to ``lm`` with a synchronize and a host clock around
    each, and keeps what the checks need: per call the kind, ms, position,
    rows and logits.  At decode call ``compare_at`` it first runs the same
    decode through the plain route (``use_kernel=False``, writing no cache
    row) and keeps both logits."""

    def __init__(self, torch, lm, compare_at=None):
        self.torch, self.lm, self.cfg = torch, lm, lm.cfg
        self.calls, self.compare_at, self.compared = [], compare_at, None
        self.n_decode = 0

    def init_cache(self, *a, **kw):
        return self.lm.init_cache(*a, **kw)

    def _timed(self, fn, *a, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        self.torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def prefill(self, params, batch, max_seq):
        from repro_torch.kernels.flash_decode import ops as fd_ops
        before = fd_ops.LAUNCHES
        (logits, cache), ms = self._timed(self.lm.prefill, params, batch,
                                          max_seq)
        if fd_ops.LAUNCHES != before:
            raise AssertionError("prefill launched flash_decode")
        self.calls.append(("prefill", ms, batch["tokens"].shape[1], None,
                           logits.float().cpu()))
        return logits, cache

    def decode(self, params, tokens, cache, pos, rows=None):
        if self.n_decode == self.compare_at:
            plain, _ = self.lm.decode(params, tokens, cache, pos, rows=[],
                                      use_kernel=False)
        (logits, cache), ms = self._timed(self.lm.decode, params, tokens,
                                          cache, pos, rows=rows)
        if self.n_decode == self.compare_at:
            self.compared = (pos, plain.float().cpu(), logits.float().cpu())
        self.n_decode += 1
        self.calls.append(("decode", ms, pos, rows, logits.float().cpu()))
        return logits, cache


def lm_card_vs_cpu(torch, dev) -> None:
    """The f32 smoke engine run of tests/test_torch_serve.py on the card
    and on the CPU, same seeded weights: tokens identical, every call's
    logits within 1e-4, flash_decode launched once per layer and decode
    call on the card."""
    import numpy as np
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = smoke_config("granite-8b").replace(dtype="float32", num_heads=8,
                                             num_kv_heads=2)
    lm = LM(cfg)
    cpu_params = lm.init(torch.Generator().manual_seed(0))
    runs = {}
    for where in ("cpu", dev):
        params = _to(torch, cpu_params, where)
        rng = np.random.default_rng(5)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                        .astype(np.int32), max_new_tokens=6)
                for i, n in enumerate(SMALL_PROMPTS)]
        rec = TimedLM(torch, lm)
        fd_ops.LAUNCHES = 0
        stats = ServeEngine(rec, params, batch_slots=4, max_seq=32,
                            device=where).run(reqs)
        runs[str(where)] = (stats, [r.out_tokens for r in reqs], rec.calls,
                            fd_ops.LAUNCHES, rec.n_decode)
    (cs, ctok, ccalls, _, _), (gs, gtok, gcalls, n_fd, n_dec) = (
        runs["cpu"], runs[str(dev)])
    diff = max(float((a[4] - b[4]).abs().max())
               for a, b in zip(ccalls, gcalls))
    print(f"LM engine f32 smoke (d=64, 2 layers, G=4, hd=8) card vs CPU: "
          f"{gs['requests']} requests, {gs['steps']} steps, tokens "
          f"{'identical' if gtok == ctok else 'DIFFERENT'}, max |logit diff| "
          f"{diff:.3g} over {len(gcalls)} calls; flash_decode launches "
          f"{n_fd} for {n_dec} decode calls")
    if gtok != ctok or gs["steps"] != cs["steps"] or len(gcalls) != len(
            ccalls) or not diff <= 1e-4:
        raise AssertionError("the card's LM engine differs from the CPU's")
    if n_fd != cfg.num_layers * n_dec or n_dec == 0:
        raise AssertionError("flash_decode not launched once per layer and "
                             "decode call")


def _to(torch, tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _to(torch, v, device) for k, v in tree.items()}



def lm_full_width(torch, dev, tag: str, reset_counts, read_counts) -> int:
    """ServeEngine over granite-8b at its published config (36 layers,
    d_model 4096, 32/8 heads, d_ff 14336, vocab 49152, bf16), weights from
    a seeded torch.Generator on the card: 4 slots, max_seq 2048, prompts of
    512, 512, 384, 384, 512 and 256 tokens, 16 new tokens each.  Checks
    that every request drains, that flash_decode ran 36 times per decode
    call and never in prefill, that one request's last decode logits agree
    with a prefill of the same tokens (teacher forcing) and that the kernel
    route agrees with ``use_kernel=False`` at one decode, both within 5e-2
    of max |logit| (tests/test_archs.py's bf16 rule).  Every launch
    counter is set to 0 just before the engine run and read just after;
    no other kernel may have launched.  Returns the flash_decode launches
    of the engine run."""
    import numpy as np
    from repro_torch.common.params import param_count
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.models.model import LM
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config("granite-8b")
    lm = LM(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(lm.param_defs())
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=FULL_NEW)
            for i, n in enumerate(FULL_PROMPTS)]
    rec = TimedLM(torch, lm, compare_at=2)
    eng = ServeEngine(rec, params, batch_slots=FULL_SLOTS, max_seq=FULL_SEQ,
                      device=dev)
    reset_counts()
    stats = eng.run(reqs)
    counts = read_counts()
    launches = counts.pop("flash_decode")
    peak = torch.cuda.max_memory_allocated()
    pre = [c for c in rec.calls if c[0] == "prefill"]
    dec = [c for c in rec.calls if c[0] == "decode"]
    if not (stats["requests"] == len(reqs) and all(
            r.done and len(r.out_tokens) == FULL_NEW for r in reqs)):
        raise AssertionError(f"not every request drained: {stats}")
    if launches != cfg.num_layers * len(dec) or not dec or any(
            counts.values()):
        raise AssertionError(f"flash_decode launched {launches} times for "
                             f"{len(dec)} decode calls of {cfg.num_layers} "
                             f"layers; others {counts}")
    V = cfg.vocab_size
    # teacher forcing: request 0 (slot 0) made its last token at decode
    # position len(prompt) + FULL_NEW - 2, from out_tokens[-2]
    r0 = reqs[0]
    last = len(r0.prompt) + FULL_NEW - 2
    # (request 4 reuses slot 0 later and passes the same position)
    lg_dec = [c for c in dec if c[2] == last and (
        c[3] is None or 0 in c[3])][0][4][0, 0, :V]
    if int(lg_dec.argmax()) != r0.out_tokens[-1]:
        raise AssertionError("the recorded decode logits did not pick the "
                             "emitted token")
    toks = np.concatenate([r0.prompt, r0.out_tokens[:-1]]).astype(np.int64)
    lg_pre, _ = lm.prefill(params, {"tokens": torch.as_tensor(
        toks[None], device=dev)}, FULL_SEQ)
    lg_pre = lg_pre.float().cpu()[0, 0, :V]
    scale = float(lg_pre.abs().max())
    e_tf = float((lg_dec - lg_pre).abs().max())
    pos_c, plain, kern = rec.compared
    e_route = float((plain[..., :V] - kern[..., :V]).abs().max())
    s_route = float(plain[..., :V].abs().max())
    pre_ms = [c[1] for c in pre]
    dec_ms = [c[1] for c in dec]
    step_ms = (stats["wall_s"] * 1e3 - sum(pre_ms)) / stats["steps"]
    print(f"granite-8b full width ({n_params:,} parameters, bf16, init "
          f"{init_s:.2f} s on the card): {stats['requests']} requests, "
          f"{stats['tokens']} tokens, {stats['steps']} steps, "
          f"{len(dec)} decode calls, flash_decode launches {launches} "
          f"(= {cfg.num_layers} x {len(dec)}), none in {len(pre)} prefills "
          f"{tag}")
    print(f"granite-8b prefill ms per request (prompt "
          f"{[c[2] for c in pre]}): {[round(x, 3) for x in pre_ms]} {tag}")
    print(f"granite-8b decode ms per call: median "
          f"{statistics.median(dec_ms):.3f} (min {min(dec_ms):.3f}, max "
          f"{max(dec_ms):.3f}, {len(dec_ms)} calls); per engine step "
          f"{step_ms:.3f} ms; {stats['tok_per_s']:.2f} tokens/s over "
          f"{stats['wall_s']:.3f} s; peak memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes) {tag}")
    print(f"granite-8b teacher forcing (request 0, position {last}): max "
          f"|decode - prefill| {e_tf:.4g} of max |logit| {scale:.4g} "
          f"({e_tf / scale:.4g}); kernel vs plain route at decode position "
          f"{pos_c}: {e_route:.4g} of {s_route:.4g} "
          f"({e_route / s_route:.4g})")
    if not (e_tf / scale < 5e-2 and e_route / s_route < 5e-2):
        raise AssertionError("granite-8b decode disagrees with teacher "
                             "forcing or with the plain route")
    # one profiled decode of all 4 slots at the position the run reached
    from torch.profiler import ProfilerActivity, profile
    # (a masked decode, as the engine ran; the run is over, so writing the
    # two rows at this position changes nothing that is read again)
    tokens = torch.zeros((FULL_SLOTS, 1), dtype=torch.long, device=dev)
    pos = max(FULL_PROMPTS) + FULL_NEW
    lm.decode(params, tokens, eng.cache, pos, rows=[0, 1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.decode(params, tokens, eng.cache, pos, rows=[0, 1])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    busy = device_us(prof) / 1e3
    fd = device_us(prof, "fd_") / 1e3
    n_fd = sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "fd_" in e.key)
    if n_fd != cfg.num_layers:
        raise AssertionError(f"the profiled decode ran {n_fd} flash_decode "
                             f"kernels for {cfg.num_layers} layers")
    n_kernels = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation)
    gemm = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation
               and any(w in e.key.lower() for w in
                       ("gemm", "gemv", "nvjet", "cutlass"))) / 1e3
    print(f"granite-8b one decode (4 slots, 2 rows written, position {pos}) "
          f"under the "
          f"profiler: wall {wall:.3f} ms, kernels {busy:.3f} ms "
          f"({100 * busy / wall:.1f}% busy) in {n_kernels} kernels, "
          f"flash_decode {fd:.3f} ms in {n_fd} kernels (one per layer), "
          f"matrix products {gemm:.3f} ms, weights-read floor "
          f"{2 * n_params / HBM_BYTES_PER_S * 1e3:.3f} ms {tag}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=12))
    import collections
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lm.decode(params, tokens, eng.cache, pos, rows=[0, 1])
    torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(f"{Path(w.filename).name}:{w.lineno}"
                                for w in caught)
    print(f"granite-8b host syncs in one decode call: "
          f"{sum(sites.values())} {dict(sites.most_common())}")
    del params, eng, rec
    torch.cuda.empty_cache()
    return launches


def flash_decode_record(torch, dev, launches: int, worst: float,
                        tag: str) -> dict:
    """B4's times at the LM decode's shape in bf16, at the valid lengths
    FD_TIMED: the kernel (profiler), the plain version, and
    scaled_dot_product_attention with the same mask (enable_gqa) as the
    library yardstick, beside the bound.  The record holds the first
    length (where the run sits); the others ride along under
    ``at_valid``."""
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode import ref as fd_ref
    F = torch.nn.functional
    B, S, H, KV, hd = FD_SHAPE
    q, k, v, _, _ = fd_inputs(torch, dev, torch.bfloat16, *FD_SHAPE)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    per = {}
    for vl in FD_TIMED:
        mask = (torch.arange(S, device=dev) < vl)[None, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        want = fd_ref.flash_decode_ref(q, k, v, kv_valid_len=vl)[0]
        e_lib = float((lib().transpose(1, 2).float() - want.float())
                      .abs().max())
        # per recorded kernel: the profiler may miss a window's first few
        ms, per_call = device_ms_count(
            torch, lambda: fd_ops.flash_decode_cuda(q, k, v, vl), 100, "fd_")
        if not 0.9 <= per_call <= 1.0:
            raise AssertionError(f"flash_decode ran {per_call} kernels per "
                                 "call, not one")
        ms /= per_call
        plain_ms = device_ms(torch, lambda: fd_ref.flash_decode_ref(
            q, k, v, kv_valid_len=vl), 10)
        library_ms = device_ms(torch, lib, 20)
        # K and V rows below vl read once; q read, out, m and l written
        nbytes = 2 * B * vl * KV * hd * 2 + 2 * B * H * hd * 2 + 2 * B * H * 4
        flops = 4 * B * H * vl * hd
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / BF16_FLOPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        tiles, nsplit, stages = fd_ops.split_plan(
            vl, B * KV, fd_ops._sm_count(dev), H // KV, hd, 2)
        print(f"kernel flash_decode {FD_SHAPE} bf16 valid {vl} ({nsplit} "
              f"ranges of {tiles} tiles x {B * KV} blocks, {stages} stages, "
              f"{per_call:g} kernel per call): {ms * 1e3:.2f} us on the card, "
              f"plain {plain_ms * 1e3:.2f} us, sdpa {library_ms * 1e3:.2f} "
              f"us (max |diff| vs plain {e_lib:.3g}), bound "
              f"{bound_ms * 1e3:.3f} us ({nbytes} bytes, {flops} flops; "
              f"{100 * bound_ms / ms:.1f}% of it) {tag}")
        per[vl] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": bound_ms,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    first = per[FD_TIMED[0]]
    from repro_torch.kernels import build
    sass = sass_counts(build.library_path("flash_decode"))
    if sass and not sass["HMMA"] + sass["HGMMA"]:
        raise AssertionError("flash_decode's SASS has no tensor-core "
                             "instruction")
    products = ("wgmma" if sass.get("HGMMA") else "mma.sync") if sass \
        else "mma.sync (source; no cuobjdump)"
    print(f"flash_decode SASS: {sass or 'cuobjdump not found'}; bf16 "
          f"products by {products}")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode/flash_decode.py:66",
            "shape": list(FD_SHAPE), "valid_len": FD_TIMED[0],
            "launches": launches, "max_abs_err": worst, **first,
            "bf16_products": products, "sass": sass,
            "at_valid": {str(vl): per[vl] for vl in FD_TIMED[1:]}}



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one deepstream episode and count "
                         "host syncs of both runners")
    args = ap.parse_args(argv)
    t_begin = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's card path cannot run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.common import prng
    from repro_torch.core import codec
    from repro_torch.core.scheduler import DeepStreamSystem, SystemConfig
    from repro_torch.core.utility import init_utility_mlp
    from repro_torch.data.synthetic import (DeviceScene, SceneConfig,
                                            bandwidth_trace, segments_device)
    from repro_torch.kernels import build
    from repro_torch.kernels.edge_motion import ops as em_ops
    from repro_torch.kernels.edge_motion import ref as em_ref
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.knapsack_dp import ops as dp_ops
    from repro_torch.kernels.knapsack_dp import ref as dp_ref
    from repro_torch.kernels.tx_codec import ops as tx_ops
    from repro_torch.kernels.tx_codec import ref as tx_ref
    from repro_torch.models.detector import load_detector

    counters = {"edge_motion": em_ops, "tx_codec": tx_ops,
                "knapsack_dp": dp_ops, "flash_decode": fd_ops}

    def reset_counts() -> None:
        for mod in counters.values():
            mod.LAUNCHES = 0

    def read_counts() -> dict:
        return {k: mod.LAUNCHES for k, mod in counters.items()}

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, Python "
          f"{sys.version.split()[0]}")
    tag = f"[{smi}]"

    t0 = time.perf_counter()
    libs = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s for "
          f"{len(libs)} sources (nvcc, sm_90a, in parallel)")
    for name in libs:
        log = build.BUILD_DIR / f"{name}.log"
        if log.exists():   # written by the nvcc run of this build
            text = log.read_text()
            regs = re.findall(r"Used (\d+) registers", text)
            spills = sorted(set(re.findall(r"(\d+) bytes spill stores",
                                           text)))
            print(f"ptxas {name}: registers per kernel {regs}, spill "
                  f"stores {spills} bytes")

    # -- 3. kernels vs their plain versions on the card -----------------
    bs, thr = 8, 0.35
    worst = {"edge_motion": 0.0, "tx_codec": 0.0, "knapsack_dp": 0.0}
    for C in (5, 16):
        scene = DeviceScene(SceneConfig(seed=7, num_cameras=C), device=dev)
        frames = segments_device(scene.cfg, scene.params, scene.key, 3,
                                 gt_pad=scene.G)[0]
        ref_frames = segments_device(scene.cfg, scene.params, scene.key, 2,
                                     gt_pad=scene.G)[0][:, -1:]
        gen = torch.Generator(device=dev).manual_seed(C)
        noise_fr = torch.rand(frames.shape, device=dev, generator=gen)
        cases = {"roidet": frames,
                 "reducto": torch.cat([ref_frames, frames], dim=1),
                 "uniform": noise_fr}
        for name, fr in cases.items():
            got = em_ops.edge_motion_cuda(fr.contiguous(), block_size=bs,
                                          edge_thresh=thr)
            torch.cuda.synchronize()
            want = em_ref.segment_motion_ref(fr, block_size=bs,
                                             edge_thresh=thr)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst["edge_motion"] = max(worst["edge_motion"], err)
            print(f"edge_motion vs plain C={C} {name} {tuple(fr.shape)}: "
                  f"max |diff| {err} (sum {float(want.sum()):.0f})")
            if err != 0.0:
                raise AssertionError("edge_motion differs from its plain "
                                     "version")
        keys = prng.fold_in(prng.PRNGKey(11, device=dev),
                            torch.arange(C, device=dev))
        noise = prng.normal(keys, frames.shape[1:])
        rates = torch.tensor([50, 100, 200, 400, 800, 1000], device=dev,
                             dtype=torch.float32)[torch.arange(C, device=dev)
                                                  % 6]
        roi = torch.full((C,), 96.0 * 160.0, device=dev)
        levels, sigma, _ = codec.rate_terms(
            codec.CodecConfig(), roi, rates, torch.ones(C, device=dev),
            torch.full((C,), 10.0, device=dev))
        branches = {"k=1": [1] * C, "k=2": [2] * C, "k=4": [4] * C,
                    "mixed": [(1, 2, 4)[i % 3] for i in range(C)]}
        for name, ks in branches.items():
            kcam = torch.tensor(ks, dtype=torch.int32, device=dev)
            got = tx_ops.tx_codec_cuda(frames, noise, levels, sigma, kcam)
            torch.cuda.synchronize()
            want = tx_ref.tx_codec_ref(frames, noise, levels, sigma, kcam)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst["tx_codec"] = max(worst["tx_codec"], err)
            print(f"tx_codec vs plain C={C} {name} {tuple(frames.shape)}: "
                  f"max |diff| {err}")
            if not torch.equal(got, want):
                raise AssertionError("tx_codec differs from its plain "
                                     "version")
        # CRF mode: the fleet encode through the kernel against the
        # per-camera plain CRF encode (every blur branch, then select)
        res = torch.tensor([1.0, 0.75, 0.5, 0.74], device=dev)[
            torch.arange(C, device=dev) % 4]
        roi_crf = torch.linspace(2000.0, 96.0 * 160.0, C, device=dev)
        for blur in (True, False):
            got, sizes = tx_ops.encode_fleet_crf(
                codec.CodecConfig(), frames, roi_crf, keys, res, blur=blur)
            torch.cuda.synchronize()
            err = 0.0
            for c in range(C):
                want, want_size = codec.encode_segment_crf(
                    codec.CodecConfig(), frames[c], roi_crf[c], keys[c],
                    res[c] if blur else None)
                err = max(err, float((got[c] - want).abs().max()))
                if blur and float(sizes[c]) != float(want_size):
                    raise AssertionError("CRF sizes differ")
            worst["tx_codec"] = max(worst["tx_codec"], err)
            print(f"tx_codec CRF vs plain C={C} blur={blur}: max |diff| "
                  f"{err}")
            if err != 0.0:
                raise AssertionError("tx_codec CRF differs from its plain "
                                     "version")

    costs_dev = torch.tensor(DP_COSTS, dtype=torch.int32, device=dev)
    dp_cases = []
    for I, W, kind in ((5, 127, "uniform"), (16, 127, "uniform"),
                       (32, 200, "uniform"), (5, 127, "dead"),
                       (16, 127, "dead"), (5, 127, "ties"),
                       (16, 127, "ties")):
        rng = np.random.default_rng(I * 1000 + W)
        util = rng.uniform(0, 1, (I, 6)).astype(np.float32)
        if kind == "dead":      # dead cameras: cheapest option at 0 only
            dead = rng.choice(I, size=I // 2, replace=False)
            util[dead] = -1e9
            util[dead, 0] = 0.0
        elif kind == "ties":    # coarse values: equal candidates everywhere
            util = (np.round(util * 4) / 4).astype(np.float32)
            util[:, 1] = util[:, 0]
        dp_cases.append((I, W, kind, util))
    for I, W, kind, util in dp_cases:
        u = torch.from_numpy(util).to(dev)
        vals, choices = dp_ops.knapsack_dp_cuda(u, costs_dev, W)
        torch.cuda.synchronize()
        want_v, want_c = dp_ref.knapsack_dp_ref(u, costs_dev, W)
        torch.cuda.synchronize()
        err = float((vals - want_v).abs().max())
        bad = int((choices != want_c).sum())
        worst["knapsack_dp"] = max(worst["knapsack_dp"], err)
        print(f"knapsack_dp vs plain ({I}, 6, {W + 1}) {kind}: max |diff| "
              f"values {err}, choices differing {bad}")
        if not (torch.equal(vals, want_v) and bad == 0):
            raise AssertionError("knapsack_dp differs from its plain version")
    util5 = dp_cases[0][3]
    picks, total = dp_ops.solve(util5, np.asarray(DP_COSTS, np.int32), 127,
                                device=dev)
    o_picks, o_total = dp_ref.exhaustive_oracle(
        util5, np.asarray(DP_COSTS), 127)
    print(f"knapsack_dp host solve (5, 6, 128) vs exhaustive oracle: picks "
          f"{picks.tolist()} vs {o_picks.tolist()}, total {total} vs "
          f"{o_total}")
    if not (np.array_equal(picks, o_picks) and abs(total - o_total) <= 1e-5):
        raise AssertionError("host solve differs from the exhaustive oracle")

    worst["tx_codec"] = max(worst["tx_codec"],
                            check_tx_codec_ragged(torch, dev))
    worst["flash_decode"] = max(check_flash_decode(torch, dev).values())

    # -- 4. the episode, four methods, card vs the port's CPU run -------
    light_h, server_h = load_detector("light", "cpu"), load_detector(
        "server", "cpu")

    def make_system(C: int, device, **kw) -> DeepStreamSystem:
        s = DeepStreamSystem(SystemConfig(scene=SceneConfig(
            seed=7, num_cameras=C), **kw), light_h, server_h, device=device)
        s.mlp = init_utility_mlp(prng.PRNGKey(0, device=s.device))
        s.tau_wl, s.tau_wh = 10.0, 50.0
        s.jcab_table = np.linspace(0.2, 0.8, 18).reshape(6, 3).astype(
            np.float32)
        return s

    def needs(method: str) -> tuple:
        """The kernels a method's main path launches."""
        return (("edge_motion",) if method in ("deepstream", "reducto")
                else ()) + ("tx_codec",) + (
            ("knapsack_dp",) if method in ("deepstream", "jcab") else ())

    trace = bandwidth_trace("medium", T_SLOTS, seed=3)
    gpu_sys, cpu_sys = make_system(5, dev), make_system(5, "cpu")
    launches_episode = dict.fromkeys(counters, 0)
    episode_logs = {}
    for method in METHODS:
        scene = DeviceScene(gpu_sys.cfg.scene, device=dev)
        reset_counts()
        logs = gpu_sys.run_episode(scene, trace, method)
        n = read_counts()
        episode_logs[method] = logs
        for k in counters:
            launches_episode[k] += n[k]
        check_logs(logs, f"episode {method}")
        if any(n[k] == 0 for k in needs(method)):
            raise AssertionError(f"episode {method}: kernel not launched on "
                                 f"the main path {n}")
        cpu_logs = cpu_sys.run_episode(
            DeviceScene(cpu_sys.cfg.scene, device="cpu"), trace, method)
        diffs = max_log_diff(cpu_logs, logs, LOG_KEYS, 1e-5)
        print(f"episode {method} C=5 T={T_SLOTS}: launches "
              + " ".join(f"{k} {v}" for k, v in n.items())
              + f"; mean F1 {float(np.mean(logs['mean_f1'])):.4f}; card vs "
              "CPU max diff "
              + " ".join(f"{k}={v:.3g}" for k, v in diffs.items()))

    # -- 5. run(), pipelined, four methods -------------------------------
    launches_run = dict.fromkeys(counters, 0)
    run_logs = {}
    for method in METHODS:
        scene = DeviceScene(gpu_sys.cfg.scene, device=dev)
        reset_counts()
        logs = gpu_sys.run(scene, trace, method)
        n = read_counts()
        run_logs[method] = logs
        for k in counters:
            launches_run[k] += n[k]
        check_logs(logs, f"run {method}")
        if any(n[k] == 0 for k in needs(method)):
            raise AssertionError(f"run {method}: kernel not launched on the "
                                 f"main path {n}")
        want_dp = T_SLOTS if "knapsack_dp" in needs(method) else 0
        if n["knapsack_dp"] != want_dp:
            raise AssertionError(f"run {method}: knapsack_dp launched "
                                 f"{n['knapsack_dp']} times, not {want_dp}")
        d_ep = max_log_diff(episode_logs[method], logs, LOG_KEYS, 1e-5,
                            "run vs episode")
        cpu_logs = cpu_sys.run(DeviceScene(cpu_sys.cfg.scene, device="cpu"),
                               trace[:T_CPU], method)
        head = {k: v[:T_CPU] for k, v in logs.items()}
        d_cpu = max_log_diff(cpu_logs, head, LOG_KEYS, 1e-5)
        print(f"run {method} C=5 T={T_SLOTS}: launches "
              + " ".join(f"{k} {v}" for k, v in n.items())
              + f"; mean F1 {float(np.mean(logs['mean_f1'])):.4f}; vs the "
              "card's episode max diff "
              + " ".join(f"{k}={v:.3g}" for k, v in d_ep.items())
              + f"; vs CPU run() (T={T_CPU}) "
              + " ".join(f"{k}={v:.3g}" for k, v in d_cpu.items()))

    # -- 6. host control and the sequential runner on the card ----------
    host_sys = make_system(5, dev, pipeline=False, alloc="host")
    seq_sys = make_system(5, dev, batched=False)
    tr4 = trace[:4]
    tr2 = trace[:2]
    for label, system, methods, tr, ref_tol in (
            ("alloc=host", host_sys, ("deepstream", "jcab"), tr4,
             (dict(utility=1e-5, bytes=1e-3, alloc_kbps=1e-3, extra=1e-3,
                   area=1e-4), {})),
            ("sequential", seq_sys, ("deepstream", "reducto"), tr2,
             (dict(utility=1e-3), dict(bytes=1e-6, alloc_kbps=1e-6)))):
        n_total = dict.fromkeys(counters, 0)
        for method in methods:
            reset_counts()
            logs = system.run(DeviceScene(system.cfg.scene, device=dev), tr,
                              method)
            n = read_counts()
            for k in counters:
                n_total[k] += n[k]
            check_logs(logs, f"{label} {method}")
            ref = gpu_sys.run(DeviceScene(gpu_sys.cfg.scene, device=dev), tr,
                              method)
            d = check_close(ref, logs, *ref_tol, f"{label} {method}")
            print(f"{label} {method} C=5 T={len(tr)}: launches "
                  + " ".join(f"{k} {v}" for k, v in n.items())
                  + "; vs pipelined device control max diff "
                  + " ".join(f"{k}={v:.3g}" for k, v in d.items()))
        if n_total["knapsack_dp"] == 0 or n_total["edge_motion"] == 0:
            raise AssertionError(f"{label}: B1 or B3 not launched {n_total}")

    # -- 7. the LM serving tier: small width card vs CPU, then full width
    lm_card_vs_cpu(torch, dev)
    lm_launches = lm_full_width(torch, dev, tag, reset_counts, read_counts)

    # -- 8. times --------------------------------------------------------
    for C in (5, 16):
        s = gpu_sys if C == 5 else make_system(C, dev)
        tr = trace * C / 5
        for method in METHODS:
            # both runners in turns (episode, run, run, episode, ...) after
            # one warm-up each, so host drift hits them alike
            runners = ("run_episode", "run")
            ms = {r: [] for r in runners}
            for rnd in range(4):
                for r in (runners if rnd % 2 == 0 else runners[::-1]):
                    scene = DeviceScene(s.cfg.scene, device=dev)
                    t_ms = slot_ms(torch, lambda: getattr(s, r)(
                        scene, tr, method), T_SLOTS)
                    if rnd > 0:
                        ms[r].append(t_ms)
            for r in runners:
                print(f"ms/slot {r} {method} C={C} T={T_SLOTS}: median "
                      f"{statistics.median(ms[r]):.3f} (min {min(ms[r]):.3f}"
                      f", max {max(ms[r]):.3f}, 3 runs) {tag}")

    scene = DeviceScene(SceneConfig(seed=7, num_cameras=5), device=dev)
    frames = segments_device(scene.cfg, scene.params, scene.key, 3,
                             gt_pad=scene.G)[0].contiguous()
    C, N, H, W = frames.shape
    keys = prng.fold_in(prng.PRNGKey(11, device=dev),
                        torch.arange(C, device=dev))
    noise = prng.normal(keys, frames.shape[1:])
    levels = torch.full((C,), 64.0, device=dev)
    sigma = torch.full((C,), 0.01, device=dev)
    kcam = torch.tensor([1, 2, 4, 1, 2], dtype=torch.int32, device=dev)
    px = C * N * H * W
    dp_util = torch.from_numpy(dp_cases[0][3]).to(dev)
    dpI, dpJ, dpW = 5, len(DP_COSTS), 127
    records = []
    for name, kname, fn, plain, shape, nbytes, ops, src, tpu in (
            ("edge_motion", "edge_motion_kernel",
             lambda: em_ops.edge_motion_cuda(frames, block_size=bs,
                                             edge_thresh=thr),
             lambda: em_ref.segment_motion_ref(frames, block_size=bs,
                                               edge_thresh=thr),
             list(frames.shape),
             4 * (px + C * (N - 1) * (H // bs) * (W // bs)),
             # two 3x3 Sobel |g|^2 (14 flops each), compare, XOR, sum
             C * (N - 1) * H * W * 33,
             "src/repro_torch/csrc/edge_motion.cu",
             "src/repro/kernels/edge_motion/edge_motion.py:48"),
            ("tx_codec", "tx_codec_kernel",
             lambda: tx_ops.tx_codec_cuda(frames, noise, levels, sigma, kcam),
             lambda: tx_ref.tx_codec_ref(frames, noise, levels, sigma, kcam),
             list(frames.shape),
             4 * 3 * px,
             # pool sum (up to 15 adds) + divide, quantise (3), fma, clip (2)
             px * 8,
             "src/repro_torch/csrc/tx_codec.cu",
             "src/repro/kernels/tx_codec/tx_codec.py:78"),
            ("knapsack_dp", "knapsack_dp_kernel",
             lambda: dp_ops.knapsack_dp_cuda(dp_util, costs_dev, dpW),
             lambda: dp_ref.knapsack_dp_ref(dp_util, costs_dev, dpW),
             [dpI, dpJ, dpW + 1],
             # util and costs read, values and choices written, once each
             4 * (dpI * dpJ + dpJ + (dpW + 1) + dpI * (dpW + 1)),
             # per (i, w, j): add, compare, select
             dpI * dpJ * (dpW + 1) * 3,
             "src/repro_torch/csrc/knapsack_dp.cu",
             "src/repro/kernels/knapsack_dp/knapsack_dp.py:54")):
        # ms: kernel time on the card; stream_ms: back-to-back calls timed
        # with CUDA events, which includes the host's launch gaps
        ms = device_ms(torch, fn, 100, kname)
        plain_ms = device_ms(torch, plain, 10)
        stream_ms = cuda_ms(torch, fn)
        plain_stream_ms = cuda_ms(torch, plain, iters=20)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        print(f"kernel {name} {tuple(shape)}: {ms * 1e3:.2f} us on "
              f"the card ({stream_ms * 1e3:.2f} us per call back to back), "
              f"plain {plain_ms * 1e3:.2f} us ({plain_stream_ms * 1e3:.2f} "
              f"us), bound {bound_ms * 1e3:.4f} us "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}) {tag}")
        records.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "shape": shape, "launches": launches_run[name],
            "launches_episode": launches_episode[name],
            "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
            "stream_ms": stream_ms, "plain_stream_ms": plain_stream_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    # B2 with every camera on the identity branch: no staged band, one
    # round of loads
    ones = torch.ones(C, dtype=torch.int32, device=dev)
    tx_id_ms = device_ms(torch, lambda: tx_ops.tx_codec_cuda(
        frames, noise, levels, sigma, ones), 100, "tx_codec_kernel")
    print(f"kernel tx_codec {tuple(frames.shape)} identity branch only: "
          f"{tx_id_ms * 1e3:.2f} us on the card {tag}")
    records[1]["identity_ms"] = tx_id_ms
    records.append(flash_decode_record(torch, dev, lm_launches,
                                       worst["flash_decode"], tag))

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        scene = DeviceScene(gpu_sys.cfg.scene, device=dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gpu_sys.run_episode(scene, trace, "deepstream")
            wall = time.perf_counter() - t0
        from torch.autograd import DeviceType
        dev_us = device_us(prof)
        n_kernels = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and not e.is_user_annotation)
        print(f"profile deepstream C=5 T={T_SLOTS}: wall {wall * 1e3:.1f} ms, "
              f"{n_kernels} kernels on the card taking {dev_us / 1e3:.1f} ms "
              f"({100 * dev_us / 1e3 / (wall * 1e3):.1f}% busy) {tag}")
        print(prof.key_averages().table(sort_by="self_device_time_total",
                                        row_limit=15))
        # where each runner still waits on the card (host syncs per site)
        import collections
        import warnings
        for runner in ("run_episode", "run"):
            for method in METHODS:
                scene = DeviceScene(gpu_sys.cfg.scene, device=dev)
                torch.cuda.set_sync_debug_mode("warn")
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    getattr(gpu_sys, runner)(scene, trace, method)
                torch.cuda.set_sync_debug_mode("default")
                sites = collections.Counter(
                    f"{Path(w.filename).name}:{w.lineno}" for w in caught)
                print(f"host syncs {runner} {method} C=5 T={T_SLOTS}: "
                      f"{sum(sites.values())} {dict(sites.most_common())}")

    print(f"chip_smoke wall time: {time.perf_counter() - t_begin:.1f} s "
          f"{tag}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
