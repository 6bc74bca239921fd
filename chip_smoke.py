#!/usr/bin/env python3
"""Smoke run of dipoorlet_torch on one NVIDIA GPU: the port's quickest proof
that it builds and runs on the card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero before
the last line:
  1. environment: the card's name and power limit (as nvidia-smi prints
     them, on a line of their own), torch and nvcc versions, and the
     kernels' build time;
  2. kernels: each CUDA kernel against its plain PyTorch version on the card
     at the main path's shapes ((16, n) for every tapped tensor size of
     ResNet-18@224, bf16 and f32), with CUDA-event times (median of 25
     after warm-up) beside the least time the card could take; then one
     ``octav_many`` call and one ``bin_count_many`` call over all 50 tapped
     tensors of a batch, as the main path makes them, timed by CUDA events
     around the call and by the kernels' own durations in a
     ``torch.profiler`` trace, with one line per OCTAV size class and one
     comparing the histogram's grid with one of 64K-element blocks;
  3. the main path: ``python -m dipoorlet_torch``'s ``main`` on the card for
     ``-A mse``, ``-A hist`` and ``-A minmax`` with ``-D trt`` over 100
     synthetic samples of ResNet-18@224 (1000 classes, seed 0), with the
     kernels' launch counts of each run; one more ``-A minmax`` run comes
     first, before any other CUDA work of the process, for a user's cold
     per-phase times;
  4. card against CPU: the calibration statistics of 16 samples in f32 on
     the card (kernels) and on the CPU (plain versions);
  5. one warm ``-A hist`` statistics pass under ``torch.profiler``: the
     share of its wall span the kernels keep the card busy, and the 5
     kernels with the most total time.
The last line is {"ok": true, "device": {...}}.  Scratch files go to
build/chip_smoke/ in the checkout.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from argparse import Namespace
from collections import Counter

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
LANES_PER_SM = 128             # Hopper: 4 schedulers x 32 lanes issue one instruction a clock
BATCH = 16
BINS = 2048
N_SAMPLES = 100
N_TAPPED = 50                  # ResNet-18's tensors with a calibrated range
TIMED_RUNS = 25
# the Pallas kernels each CUDA kernel replaces, in the JAX package
REPLACES = {"octav": "calib/kernels.py:26 (_octav_kernel)",
            "bin_count": "calib/kernels.py:138 (_hist_kernel)"}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def median_ms(fn, runs=TIMED_RUNS, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# -- phase 1 ------------------------------------------------------------------
def environment():
    """Prints the card and builds the kernels; returns the card's rate of
    simple instructions (compare, add, count: one each, where an f32 peak
    counts a fused multiply-add as two): SMs x 128 lanes x its top SM clock."""
    import torch
    from dipoorlet_torch.calib import build
    smi = nvidia_smi("name,power.limit")
    print(smi, flush=True)
    nvcc = subprocess.run([build.find_nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    build_s = build.build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    ops_per_s = sms * LANES_PER_SM * clock_hz
    emit("environment", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, kernel_build_s=build_s, sms=sms, max_sm_clock_hz=clock_hz,
         ops_per_s=ops_per_s)
    return ops_per_s


# -- phase 2 ------------------------------------------------------------------
def activation_like(n, relu, dtype, gen):
    """(16, n) on the card: signed normal values (inputs, conv outputs, logits)
    or their ReLU (about half exact zeros)."""
    import torch
    x = torch.randn((BATCH, n), generator=gen, device="cuda") * 2.0
    if relu:
        x = torch.relu(x)
    return x.to(dtype).contiguous()


def check_kernels(tensor_sizes, ops_per_s):
    """Each kernel against its plain version at every (size, dtype, data
    kind); times at the main path's default dtype (bf16), one tensor per
    call.  Returns each kernel's per-shape times summed over a batch's
    tensors."""
    import torch
    from dipoorlet_torch.calib import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(0)
    counts = Counter(tensor_sizes)
    valid = torch.ones(BATCH, device="cuda")
    valid[BATCH // 2] = 0.0  # one masked sample per batch, as a padded batch has
    rows = {"octav": [], "bin_count": []}
    octav_worst = {"s_rel": 0.0, "minmax_exact": True}
    for n in sorted(counts, reverse=True):
        for dtype in (torch.bfloat16, torch.float32):
            elem = torch.tensor([], dtype=dtype).element_size()
            for relu in (True, False):
                x = activation_like(n, relu, dtype, gen)
                # OCTAV, both dynamic_sym values
                for dyn in (False, True):
                    got = K.octav(x, dyn)
                    want, iters = K.octav_reference(x, dyn, return_iterations=True)
                    torch.cuda.synchronize()
                    s_rel = ((got[:, 0] - want[:, 0]).abs()
                             / want[:, 0].abs().clamp(min=1e-30)).max().item()
                    exact = torch.equal(got[:, 1:], want[:, 1:])
                    octav_worst["s_rel"] = max(octav_worst["s_rel"], s_rel)
                    octav_worst["minmax_exact"] &= exact
                    if s_rel > 1e-4 or not exact:
                        raise AssertionError(f"octav disagrees at n={n} {dtype} relu={relu} "
                                             f"dynamic_sym={dyn}: s rel err {s_rel}, "
                                             f"min/max exact {exact}")
                    if dtype == torch.bfloat16 and relu and not dyn:
                        ops = n * (5 * BATCH + 3 * iters.sum().item())  # pass 1 + fixed point
                        rows["octav"].append(dict(
                            n=n, count=counts[n],
                            kernel_ms=median_ms(lambda: K.octav(x, dyn)),
                            plain_ms=median_ms(lambda: K.octav_reference(x, dyn), runs=20),
                            bytes_ms=1e3 * (x.numel() * elem + BATCH * 12) / HBM_BYTES_PER_S,
                            ops_ms=1e3 * ops / ops_per_s,
                            library_ms=None,
                            max_abs_err=(got - want).abs().max().item(),
                            iterations=int(iters.max().item())))
                # histogram: binning scales from the valid rows' |x| max
                amax = x[valid > 0].float().abs().amax()
                scales = torch.stack([amax, amax]).reciprocal().mul(BINS).float()
                got = torch.zeros(BINS, dtype=torch.int64, device="cuda")
                want = torch.zeros_like(got)
                K.bin_count(x, valid, scales, 1, BINS, got)
                K.bin_count_reference(x, valid, scales, 1, BINS, want)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"bin_count disagrees at n={n} {dtype} relu={relu}: "
                                         f"{(got - want).abs().max().item()} max count diff")
                if dtype == torch.bfloat16 and relu:
                    out = torch.zeros_like(got)
                    absx = x[valid > 0].float().abs()
                    # a masked row's blocks return at once: only valid rows are read
                    read = int((valid > 0).sum().item()) * n
                    rows["bin_count"].append(dict(
                        n=n, count=counts[n],
                        kernel_ms=median_ms(lambda: K.bin_count(x, valid, scales, 1, BINS, out)),
                        plain_ms=median_ms(lambda: K.bin_count_reference(
                            x, valid, scales, 1, BINS, out), runs=20),
                        bytes_ms=1e3 * (read * elem + BATCH * 4 + 8 + 2 * BINS * 8)
                        / HBM_BYTES_PER_S,
                        ops_ms=1e3 * 5 * read / ops_per_s,
                        library_ms=median_ms(lambda: torch.histc(
                            absx, bins=BINS, min=0.0, max=float(amax))),
                        max_abs_err=(got - want).abs().max().item()))
    emit("kernel_shapes", octav=rows["octav"], bin_count=rows["bin_count"],
         note="bf16, (16, n) with one sample masked for bin_count; post-ReLU data; "
              "times are CUDA-event medians, L2 not flushed")
    emit("kernel_agreement", octav_s_max_rel_err=octav_worst["s_rel"],
         octav_min_max_exact=octav_worst["minmax_exact"], bin_count_bit_exact=True,
         sizes=sorted(counts), dtypes=["bfloat16", "float32"])

    return {k: sum(r["kernel_ms"] * r["count"] for r in rs) for k, rs in rows.items()}


def traced_launches(events, lo, hi):
    """Correlation ids of the launches the host made in [lo, hi] (µs)."""
    return {e["args"]["correlation"] for e in events
            if e.get("cat") == "cuda_runtime" and lo <= e["ts"] <= hi
            and "correlation" in e.get("args", {})}


def kernel_device_ms(fn, kernels_per_call, name, calls=TIMED_RUNS, attempts=3):
    """The card's own time for the kernels one ``fn()`` launches, from a
    ``torch.profiler`` trace over ``calls`` calls: the median per call of
    the span from its first kernel's start to its last kernel's end (the
    kernels of one call may overlap), and each kernel's median duration, in
    launch order.  The timed calls follow as many untimed ones in the same
    trace, and only the kernels the timed calls launched are read: the
    tracer has been seen to miss launches of a trace's first
    milliseconds.  A trace that still lacks one of the timed kernels is
    taken again, at most ``attempts`` times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            with record_function("timed_calls"):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        trace = os.path.join(WORK, f"{name}_trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        (timed,) = [e for e in events if e.get("name") == "timed_calls"
                    and e.get("cat") == "user_annotation"]
        launched = traced_launches(events, timed["ts"], timed["ts"] + timed["dur"])
        # the correlation id follows the order of the host's launch calls
        kernels = sorted((e for e in events if e.get("cat") == "kernel"
                          and name in e.get("name", "")
                          and e["args"]["correlation"] in launched),
                         key=lambda e: e["args"]["correlation"])
        if len(kernels) == calls * kernels_per_call:
            break
        emit("profiler_retry", kernel=name, attempt=attempt, kernels_seen=len(kernels),
             expected=calls * kernels_per_call)
    else:
        raise AssertionError(f"the profiler saw {len(kernels)} {name} kernels in {calls} calls, "
                             f"expected {kernels_per_call} per call, in {attempts} traces")
    spans = []
    for c in range(calls):
        call = kernels[c * kernels_per_call:(c + 1) * kernels_per_call]
        spans.append((max(e["ts"] + e["dur"] for e in call) - min(e["ts"] for e in call)) / 1e3)
    return statistics.median(spans), [statistics.median(e["dur"] / 1e3 for e in
                                                        kernels[k::kernels_per_call])
                                      for k in range(kernels_per_call)]


def octav_batch(tensor_sizes, ops_per_s, per_tensor_ms):
    """One ``octav_many`` call over all tapped tensors of a batch, as
    ``run_octav`` makes it (bf16, (16, n) post-ReLU rows): agreement with the
    plain version, the call's CUDA-event time (which also holds whatever
    host time the card waits for, as the per-shape rows do) and the
    kernels' device time per size class."""
    import torch
    from dipoorlet_torch.calib import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(1)
    xs = [activation_like(n, True, torch.bfloat16, gen) for n in tensor_sizes]
    plan = K.octav_plan([(n, torch.bfloat16) for n in tensor_sizes])
    got = K.octav_many(xs, False)
    want, iters = zip(*(K.octav_reference(x, False, return_iterations=True) for x in xs))
    want = torch.stack(want)
    torch.cuda.synchronize()
    s_rel = ((got[..., 0] - want[..., 0]).abs()
             / want[..., 0].abs().clamp(min=1e-30)).max().item()
    exact = torch.equal(got[..., 1:], want[..., 1:])
    if s_rel > 1e-4 or not exact:
        raise AssertionError(f"octav_many over the batch disagrees: s rel err {s_rel}, "
                             f"min/max exact {exact}")
    call_ms = median_ms(lambda: K.octav_many(xs, False))
    device_ms, class_ms = kernel_device_ms(lambda: K.octav_many(xs, False), len(plan),
                                           "octav_kernel")
    plain_ms = median_ms(lambda: torch.stack([K.octav_reference(x, False) for x in xs]),
                         runs=3, warmup=1)
    for launch, ms in zip(plan, class_ms):
        emit("octav_class", cluster=launch.cluster, blocks_per_sm=launch.per_sm,
             tensors=len(launch.entries), sizes=sorted({tensor_sizes[i] for i in launch.entries}),
             blocks=len(launch.entries) * BATCH * launch.cluster,
             smem_bytes_per_block=launch.smem_bytes, device_ms=ms)
    # the bound: x read once and (s, min, max) written once; pass 1 takes 5
    # operations per element, each iteration 3 (as many iterations as each
    # row of this run needed)
    elements = sum(x.numel() for x in xs)
    bytes_ms = 1e3 * (elements * xs[0].element_size() + got.numel() * 4) / HBM_BYTES_PER_S
    ops = sum(n * (5 * BATCH + 3 * int(it.sum())) for n, it in zip(tensor_sizes, iters))
    ops_ms = 1e3 * ops / ops_per_s
    emit("kernel_batch", kernel="octav", tensors=len(xs), dtype="bfloat16", launches=len(plan),
         call_ms=call_ms, device_ms=device_ms, per_tensor_calls_ms=per_tensor_ms,
         plain_ms=plain_ms, bytes_ms=bytes_ms, ops_ms=ops_ms, s_max_rel_err=s_rel,
         min_max_exact=exact,
         note="one octav_many call for the whole batch of 16; call_ms: CUDA-event median of "
              f"{TIMED_RUNS}; device_ms: median span from the call's first kernel start to "
              "its last kernel end in a torch.profiler trace (the classes run side by side, "
              "so each class's device_ms is taken while sharing the card); "
              "per_tensor_calls_ms: the per-shape octav rows summed over the 50 tensors")
    return dict(name="octav", route="cuda", source="dipoorlet_torch/calib/csrc/octav.cu",
                replaces=REPLACES["octav"], launches=0,
                max_abs_err=(got - want).abs().max().item(), ms=call_ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None)


def hist_scales(xs, valid):
    """The binning scales of the fused minmax->hist pass: bins / amax over
    each tensor's valid rows."""
    import torch
    amax = torch.stack([x[valid > 0].float().abs().amax() for x in xs])
    return torch.where(amax > 0, BINS / amax, 0.0).float()


def hist_batch(tensor_sizes, ops_per_s, per_tensor_ms):
    """One ``bin_count_many`` call over all tapped tensors of a batch, as
    ``_hist_pass`` makes it (bf16, (16, n) post-ReLU rows, one sample
    masked): bit-exact agreement with the plain version per tensor in bf16
    and f32, post-ReLU and signed; the call's CUDA-event time, the kernel's
    device time from a profiler trace, the plain version's, and
    ``torch.histc`` summed over the tensors.  Then the grid the main path
    does not take, 64K-element blocks instead of a grid sized to the card,
    checked bit for bit and timed beside the main path's on the same
    inputs."""
    import torch
    from dipoorlet_torch.calib import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(2)
    valid = torch.ones(BATCH, device="cuda")
    valid[BATCH // 2] = 0.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t = len(tensor_sizes)
    data, worst = {}, 0
    for dtype in (torch.bfloat16, torch.float32):
        for relu in (True, False):
            xs = [activation_like(n, relu, dtype, gen) for n in tensor_sizes]
            scales = hist_scales(xs, valid)
            got = torch.zeros((t, BINS), dtype=torch.int64, device="cuda")
            K.bin_count_many(xs, valid, scales, BINS, got)
            want = torch.stack([K.bin_count_reference(x, valid, scales, i, BINS,
                                                      torch.zeros_like(got[0]))
                                for i, x in enumerate(xs)])
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            if err != 0:
                raise AssertionError(f"bin_count_many over the batch disagrees ({dtype}, "
                                     f"relu={relu}): {err} max diff")
            if dtype == torch.bfloat16:
                data[relu] = (xs, scales, want)
    xs, scales, want = data[True]
    plan = K.bin_count_plan([(n, torch.bfloat16) for n in tensor_sizes], BATCH, BINS, sms)
    out = torch.zeros((t, BINS), dtype=torch.int64, device="cuda")
    call_ms = median_ms(lambda: K.bin_count_many(xs, valid, scales, BINS, out))
    device_ms, _ = kernel_device_ms(lambda: K.bin_count_many(xs, valid, scales, BINS, out),
                                    len(plan), "bin_count_kernel")
    plain_ms = median_ms(lambda: [K.bin_count_reference(x, valid, scales, i, BINS, out[i])
                                  for i, x in enumerate(xs)], runs=5, warmup=1)
    absx = [x[valid > 0].float().abs() for x in xs]
    amax = [float(a.amax()) for a in absx]
    library_ms = median_ms(lambda: [torch.histc(a, bins=BINS, min=0.0, max=m)
                                    for a, m in zip(absx, amax)])
    # the bound: the valid rows of x read once, valid and scales read once,
    # out read and written once; 5 operations per element read (|x| * scale,
    # convert, clamp twice, count)
    read = int((valid > 0).sum().item()) * sum(tensor_sizes)
    bytes_ms = 1e3 * (read * xs[0].element_size() + valid.numel() * 4 + scales.numel() * 4
                      + 2 * out.numel() * 8) / HBM_BYTES_PER_S
    ops_ms = 1e3 * 5 * read / ops_per_s
    (launch,) = plan
    emit("kernel_batch", kernel="bin_count", tensors=t, dtype="bfloat16", launches=len(plan),
         grid=launch.grid, per_block=launch.per_block, flushes=launch.flushes,
         global_atomics_at_most=launch.flushes * BINS, call_ms=call_ms, device_ms=device_ms,
         per_tensor_calls_ms=per_tensor_ms, plain_ms=plain_ms, library_ms=library_ms,
         bytes_ms=bytes_ms, ops_ms=ops_ms, max_abs_err=worst,
         note="one bin_count_many call for the whole batch of 16, one sample masked; call_ms: "
              f"CUDA-event median of {TIMED_RUNS}; device_ms: median kernel span in a "
              "torch.profiler trace; library_ms: torch.histc over each tensor's valid |x|, "
              "summed; per_tensor_calls_ms: the per-shape bin_count rows summed over the 50 "
              "tensors")

    designs = []
    rows = [out.data_ptr() + i * BINS * 8 for i in range(t)]
    fixed = K.bin_count_plan([(n, torch.bfloat16) for n in tensor_sizes], BATCH, BINS, sms,
                             per_block=1 << 16)
    for relu in (True, False):
        for v in (launch, *fixed):
            vx, vscales, vwant = data[relu]

            def run():
                K.launch_bin_count(v, vx, list(range(t)), rows, valid, vscales, BINS)
            out.zero_()
            run()
            err = (out - vwant).abs().max().item()
            worst = max(worst, err)
            if err != 0:
                raise AssertionError(f"bin_count, grid {v.grid}: {err} max diff")
            ms, _ = kernel_device_ms(run, 1, "bin_count_kernel")
            designs.append(dict(data="post-ReLU" if relu else "signed", grid=v.grid,
                                per_block=v.per_block, smem_bytes=v.smem_bytes,
                                flushes=v.flushes, device_ms=ms, main_path=v == launch))
    emit("hist_design", designs=designs,
         note="bf16, the 50 tensors of a batch of 16, one sample masked; device_ms as in "
              "kernel_batch; main_path marks the design bin_count_many takes")
    return dict(name="bin_count", route="cuda", source="dipoorlet_torch/calib/csrc/histogram.cu",
                replaces=REPLACES["bin_count"], launches=0, max_abs_err=worst, ms=call_ms,
                device_ms=device_ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=library_ms)


# -- phase 3 ------------------------------------------------------------------
def prepare_model():
    import torch
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from torch_export import MODEL_ZOO
    from dipoorlet_torch.runtime.data import make_synthetic_dataset
    from dipoorlet_torch.utils.export import export
    model_path = os.path.join(WORK, "resnet18_224.onnx")
    torch.manual_seed(0)
    model = MODEL_ZOO["resnet18"](num_classes=1000)
    t0 = time.time()
    export(model, torch.randn(1, 3, 224, 224), model_path)
    export_s = time.time() - t0
    data_dir = os.path.join(WORK, "data")
    make_synthetic_dataset(data_dir, {"input": [1, 3, 224, 224]}, N_SAMPLES, seed=0)
    return model_path, data_dir, export_s


def tapped_sizes(model_path):
    import math
    from dipoorlet_torch.graph import GraphIR
    from dipoorlet_torch.runtime import Executor
    g = GraphIR.load(model_path)
    ex = Executor(g)
    return [math.prod(g.get_tensor_shape(n)) for n in ex.all_tensor_names()]


def run_cli(model_path, data_dir, algo, label, n_tensors, expect_launches):
    """One ``python -m dipoorlet_torch`` run on the card; the launch counts
    are set to 0 just before it and read just after."""
    from dipoorlet_torch.__main__ import main as cli
    from dipoorlet_torch.calib import kernels as K
    out = os.path.join(WORK, f"out_{algo}_{label}")
    argv = ["-M", model_path, "-I", data_dir, "-O", out, "-N", str(N_SAMPLES),
            "-A", algo, "-D", "trt"]
    # the CLI's own log goes to a file beside its outputs
    with open(os.path.join(WORK, f"cli_{algo}_{label}.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        K.reset_launches()
        t0 = time.time()
        phases = cli(argv)
        wall = time.time() - t0
        got = dict(K.LAUNCHES)
    with open(os.path.join(out, "model_res.json.rank0")) as f:
        cos = json.load(f)["output"][0]
    with open(os.path.join(out, "trt_clip_val.json")) as f:
        n_ranges = len(json.load(f)["blob_range"])
    emit("main_path", algo=algo, process=label, argv=argv, wall_s=wall, phase_s=phases,
         launches=got, model_cosine=cos, trt_ranges=n_ranges)
    if got != expect_launches:
        raise AssertionError(f"-A {algo}: launches {got}, expected {expect_launches}")
    if n_ranges != n_tensors:
        raise AssertionError(f"-A {algo}: {n_ranges} activation ranges, expected {n_tensors}")
    for artifact in ("quant_model.onnx", "layer_snr.json"):
        if not os.path.exists(os.path.join(out, artifact)):
            raise AssertionError(f"-A {algo}: {artifact} missing")
    if not cos == cos or abs(cos) == float("inf"):
        raise AssertionError(f"-A {algo}: model cosine {cos} is not finite")
    if algo == "minmax" and not cos > 0.99:
        raise AssertionError(f"-A minmax: model cosine {cos} <= 0.99")
    return got


def main_path(model_path, data_dir, tensor_sizes):
    """-A mse, -A hist and -A minmax in a process that has run the CLI once
    already.  Per batch, each kernel launches once per launch of its planner
    over the tapped tensors (in bf16, the CLI's default statistics dtype):
    OCTAV once per size class, the histogram once per 64 tensors."""
    import torch
    from dipoorlet_torch.calib import kernels as K
    batches = -(-N_SAMPLES // BATCH)
    n_tensors = len(tensor_sizes)
    sizes = [(n, torch.bfloat16) for n in tensor_sizes]
    octav = batches * len(K.octav_plan(sizes))
    hist = batches * len(K.bin_count_plan(sizes, BATCH, BINS))
    expect = {"mse": {"octav": octav, "bin_count": 0},
              "hist": {"octav": 0, "bin_count": hist},
              "minmax": {"octav": 0, "bin_count": 0}}
    return {algo: run_cli(model_path, data_dir, algo, "warm", n_tensors, want)
            for algo, want in expect.items()}


# -- phase 4 ------------------------------------------------------------------
def card_vs_cpu(model_path, data_dir):
    """f32 clip values of 16 samples: kernels on the card against the plain
    versions on the CPU, through the same algorithm code."""
    import torch
    from dipoorlet_torch.calib.algorithms import tensor_cali_dispatcher
    from dipoorlet_torch.graph import GraphIR
    g = GraphIR.load(model_path)
    clips, worst = {}, {}
    for algo in ("minmax", "hist", "mse"):
        for dev in ("cuda", "cpu"):
            args = Namespace(input_dir=data_dir, data_num=BATCH, batch_size=BATCH,
                             bf16_calib=False, device=torch.device(dev), bins=BINS,
                             threshold=0.99999, deploy="trt", stats_chunk=0, act_quant=algo)
            clips[algo, dev] = tensor_cali_dispatcher(algo, g, args)
    # minmax: cuDNN and CPU convolutions round differently (rtol 1e-4);
    # hist: a count may move one bin at an edge (one bin width, plus the
    # width's own f32 drift); OCTAV: the fixed point amplifies the rounding
    # of its f32 sums (rtol 1e-3)
    for algo in ("minmax", "hist", "mse"):
        err = 0.0
        for name, (lo_c, hi_c) in clips[algo, "cpu"].items():
            lo_g, hi_g = clips[algo, "cuda"][name]
            for a, b in ((lo_g, lo_c), (hi_g, hi_c)):
                if algo == "hist":
                    mm = clips["minmax", "cpu"][name]
                    width = max(-mm[0], mm[1]) / BINS
                    e = abs(a - b) / (width + 1e-4 * abs(b))
                else:
                    e = abs(a - b) / max(abs(a), abs(b)) if a != b else 0.0
                err = max(err, float(e))
        limit = {"minmax": 1e-4, "hist": 1.0, "mse": 1e-3}[algo]
        worst[algo] = {"worst": err, "limit": limit,
                       "unit": "bin widths" if algo == "hist" else "relative"}
        if not err <= limit:
            raise AssertionError(f"card against CPU, -A {algo}: worst {err} over {limit}")
    emit("card_vs_cpu", samples=BATCH, dtype="float32", **worst)


# -- phase 5 ------------------------------------------------------------------
def merged_ms(intervals, lo, hi):
    """Milliseconds of [lo, hi] (µs) covered by the union of (start, end) µs."""
    busy, reach = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, reach), min(b, hi)
        if b > a:
            busy += b - a
            reach = b
    return busy / 1e3


def calib_trace(model_path, data_dir):
    """One warm ``StatsRunner.run_minmax_hist`` pass (the ``-A hist``
    statistics: bf16 forwards, 100 samples, batch 16) under
    ``torch.profiler``: the share of the pass's wall span in which a kernel
    ran (the device is idle for the rest), and the 5 kernels with the most
    total time.  The same pass's wall time without the profiler comes
    first."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from dipoorlet_torch.calib.stats import StatsRunner
    from dipoorlet_torch.graph import GraphIR
    from dipoorlet_torch.runtime import Executor
    from dipoorlet_torch.runtime.data import CalibDataset
    ex = Executor(GraphIR.load(model_path))
    runner = StatsRunner(ex, device="cuda", compute_dtype=torch.bfloat16)
    params = ex.init_params()
    dataset = CalibDataset(data_dir, ex.input_shapes(), N_SAMPLES)
    runner.run_minmax_hist(params, dataset, BINS, batch_size=BATCH)
    t0 = time.perf_counter()
    runner.run_minmax_hist(params, dataset, BINS, batch_size=BATCH)  # ends in a host sync
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the tracer may miss launches of its first milliseconds (kernel_device_ms)
        for _ in range(TIMED_RUNS):
            torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with record_function("calib_pass"):
            runner.run_minmax_hist(params, dataset, BINS, batch_size=BATCH)
    trace = os.path.join(WORK, "calib_pass_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    (span,) = [e for e in events if e.get("name") == "calib_pass"
               and e.get("cat") == "user_annotation"]
    lo, hi = span["ts"], span["ts"] + span["dur"]
    kernels = [e for e in events if e.get("cat") == "kernel" and lo <= e["ts"] <= hi]
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy", "gpu_memset")
              and lo <= e["ts"] <= hi]
    if not kernels:
        raise AssertionError("the profiler saw no kernel in the calibration pass")
    kernel_ms = merged_ms([(e["ts"], e["ts"] + e["dur"]) for e in kernels], lo, hi)
    copy_ms = merged_ms([(e["ts"], e["ts"] + e["dur"]) for e in copies], lo, hi)
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (total + e["dur"] / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    emit("calib_trace", pass_="run_minmax_hist", samples=N_SAMPLES, batch=BATCH, bins=BINS,
         dtype="bfloat16", wall_s=wall_s, traced_span_ms=span["dur"] / 1e3,
         kernel_busy_ms=kernel_ms, kernel_busy_share=kernel_ms * 1e3 / span["dur"],
         copy_busy_ms=copy_ms, kernels=len(kernels), copies=len(copies),
         top_kernels=[dict(name=name[:160], total_ms=total, launches=count)
                      for name, (total, count) in top],
         note="wall_s: the same pass without the profiler, host clock; the busy shares are "
              "of the traced span (the profiler adds host time to it); the idle share is "
              "1 - kernel_busy_share - the copies' share")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "dipoorlet_torch")):
        print(f"chip_smoke: no dipoorlet_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dipoorlet_torch.device import full_fp32_math
    full_fp32_math()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    t0 = time.time()
    ops_per_s = environment()
    model_path, data_dir, export_s = prepare_model()
    # a user's run: the first CUDA work of the process (context, cuDNN and
    # cuBLAS set-up, the graph passes' first imports) happens inside it
    run_cli(model_path, data_dir, "minmax", "cold", N_TAPPED, {"octav": 0, "bin_count": 0})
    sizes = tapped_sizes(model_path)
    emit("model", name="resnet18", image=224, classes=1000, seed=0, export_s=export_s,
         tapped_tensors=len(sizes), elements_per_sample=sum(sizes), samples=N_SAMPLES)
    if len(sizes) != N_TAPPED:
        raise AssertionError(f"ResNet-18 has {len(sizes)} tapped tensors, expected {N_TAPPED}")
    per_tensor_ms = check_kernels(sizes, ops_per_s)
    kernels = [octav_batch(sizes, ops_per_s, per_tensor_ms["octav"]),
               hist_batch(sizes, ops_per_s, per_tensor_ms["bin_count"])]
    launches = main_path(model_path, data_dir, sizes)
    for k in kernels:
        k["launches"] = launches["mse" if k["name"] == "octav" else "hist"][k["name"]]
    card_vs_cpu(model_path, data_dir)
    calib_trace(model_path, data_dir)
    emit("done", seconds=time.time() - t0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
