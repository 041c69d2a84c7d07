#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (radarays_ros_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels from csrc/ and the host builder from
native/src/, checks each kernel against its plain torch version, runs the
trace exactness gate, and drives the main paths — batched KAIST-preset
radar frames over a ~1M-triangle scene, over the ~10k-triangle companion
scene and over bench.py's ~10M-triangle scale, and material fitting (Adam
through the differentiable frame) at the KAIST image size.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times [ROOT [PHASE ...]]

Phases (one line of figures each; any failure raises and exits non-zero):
  1. environment: card name and power limit, torch/CUDA versions, TF32 off;
  2. build: nvcc of the kernel library and c++ of the host builder
     (seconds);
  3. each kernel vs its plain version on the card at the trace gate's
     shapes (200k-triangle scene, 131,072-ray fan, ray block 2048; K4 on
     the same fan against the scene's supergroups of 8 chunks, under the
     hierarchical threshold) and the bin kernel and its backward on a
     synthetic (400, 200) signal set with the KAIST taps;
  4. trace gate: engine "kernel" vs engine "sweep" on the fan (0 hit and 0
     object mismatches), and a 4096-ray subset vs the brute oracle;
  5. frames: KAIST preset over make_urban_scene(83000, 300, seed=7) in
     batches of 4 — throughput with CUDA events, the launch count of every
     kernel over the timed run; then the batch's bounces one by one
     through the pipeline's _bounce, the rays in its ray-major order, and
     on each bounce's rays and budgets K3, K2 and K1 against their plain
     versions: one line per bounce with the valid share and hit rate of
     the lanes, the ranked chunks (nvisit mean and max), K1's visits as the
     plain version's loop counts them (per 32-lane group, per 128-lane
     CTA, per block), the visits the lanes need (per lane, the ranked
     entries of its block <= min(best_t, t_last) at the end), the chunks
     each lane keeps itself (its own slab test, entry <= min(best_t,
     t_last)), and each kernel's plain ms, bitwise check and bound; K5 and
     its backward against their plain versions on the batch's signals,
     with the share of output cells whose tap window holds a nonzero value
     and the nonzero tap terms per such cell; and one frame rendered
     through the kernels and through the plain versions under the frame
     contract of tests/test_oracle.py:70-87;
  6. frames: the same preset over the 10k companion scene
     make_urban_scene(800, 300, seed=7) (40 chunks: the flat prep K4, not
     K2/K3) — throughput, launch counts (K4, K1, K5 > 0; K2, K3 and K5's
     backward = 0), the per-bounce lines for K4 and K1, and one frame
     through the kernels and through the plain versions;
  7. the fit (benchmarks/opti_scale.py at the KAIST image size): the
     refraction tree (opaque fast path off), 2 reflections, scene
     make_urban_scene(200, 150, seed=11), 3 frames on a circular
     trajectory, targets at the true parameters, 60 Adam steps split
     around a checkpoint save and load — steps/s, start and final PSNR,
     evaluations to 40 dB, launch counts (K4, K1, K5 and its backward
     > 0); one loss and gradient through the kernels and through the
     plain versions (loss bit-equal, gradient finite, nonzero and within
     1e-5 x max|g|), and K5 and its backward, and K4 on the first pass's
     rays, at the fit's shapes;
  8. the command line (io.cli.main, in this process so that the launch
     counters see it) over files written to a temporary directory: phase
     5's scene as a binary PLY, a scene config, the KAIST preset (and its
     include_motion twin) and a circular TUM trajectory —
     a. `prime-cache` (cold host build) against the warm start from the
        cache (bit-equal to phase 5's build), and `info`'s counts;
     b. `simulate --batch 4 --synced` of 8 frames as .npy, bit-identical to
        an in-process simulate_frames with the same poses and generator
        seed (K1, K2, K3, K5 launch, K4 not), and the same run as PNG;
     c. `simulate` with include_motion (per-azimuth poses, 2 frames), and
        one such frame through the kernels and through the plain versions
        under the frame contract;
     d. `rays --bounces 4`, one shot and a 360-ray fan: the kernel engine's
        JSON equals the sweep engine's, the shot's segments equal brute's
        (order, kinds, media exactly; positions and energies within 1e-4);
     e. `eval` stamp-synced against 8b's frames, `render` of one frame, and
        `optimize` (10 gradient steps, slot 1) on the 10k scene's PLY: a
        finite loss, a checkpoint, and an --out-config read back;
  9. the trace extras and the explorer:
     a. the saturated trace (benchmarks/engines.py --saturated) on phase
        5's scene, engine "kernel", ray block 2048, four sets of
        1,048,576 rays: (i) the coherent fan, (ii) incoherent rays
        (random origins and directions) unsorted, (iii) sorted by
        sort_rays, (iv) sorted with the two-phase requeue at 75 m — each
        set's Mrays/s (median of 3, CUDA events), hit rate, peak memory,
        K1-K3 launches and bounds, and brute on 2,048 of its rays under
        the trace contract; (iii) and (iv) against (ii) (hit equal, t
        within rtol 1e-5, obj_id apart on under 2 % of the lanes and only
        on exact-distance ties); K3, K2 and K1 bitwise against their plain
        versions on 131,072 rays of (iii);
     b. a KAIST batch at ~1M triangles with trace_two_phase_cap 75 against
        single phase: one frame under the frame contract, K1-K3 twice a
        bounce, frames/s of both in turns;
     c. the "mxu" engine with TF32 off: the trace gate's 4,096 rays
        against brute (0 hit, 0 object mismatches), and a KAIST batch on
        the 10k companion — one frame under the frame contract of the
        kernel frame, ms per bounce, peak memory, frames/s;
     d. the explorer panels on the card against the CPU, and `explore
        --panel fresnel --json` through the CLI;
 10. the profiler's figures, taken last because a torch.profiler session
     leaves the host slower for the rest of the process: one batch of
     phases 5 and 6 each under torch.profiler (its kernels, copies,
     synchronizing calls, the device's idle share, and no copy issued
     inside bin_signals, by a check that must count the copy of its
     positive control, made inside a range of that name), every
     kernel's time at the shapes and on the inputs of phases 3, 5, 6,
     7 and 9a, and a check that each K4 call is its one kernel (no fill,
     memset or copy in its profiled window);
 11. the multi-device layouts (radarays_ros_tpu_torch.parallel) in 4 gloo
     ranks sharing the one card (parallel/launch.py:run_ranks; the ranks
     load phase 5's host build from a scene cache this process writes, and
     take the cone draws and Perlin offsets made here): a. azimuth x 4,
     c. azimuth x sample 2 x 2 (SUM), and once with signal_denoising=0
     and scroll_image=3 (MAX), b. scene x 4 (976 chunks a shard), d.
     azimuth x scene 2 x 2 — each frame under the frame contract of this
     process's simulate_frame on the same inputs (and whether bitwise),
     ms a frame (CUDA events in rank 0 after a barrier), each rank's peak
     and resident scene MiB, the launch counts of every rank (K1, K2, K3,
     K5 > 0), K1-K3 on each rank's bounce-1 rays and K5 on its signals
     bitwise against their plain versions, ms a combine in b and d (and
     of the same combine on host tensors), in a the frame apart (the
     wedge's render alone, the assembly's all-reduce alone on card and
     on host tensors); in b
     the combined traces of phase 4's fan and of bounce 1 against the
     unsharded kernel trace (hit equal, t bitwise off exact-distance ties,
     ties counted); e. train_step_sharded over 4 on phase 7's fit setup:
     the loss within 1e-6 relative and the gradient within 1e-5 x max|g|
     of this process's loss of the same global objective, parameters
     finite and moved, K1, K4, K5 and its backward launched in every rank
     and bitwise on its inputs; then the dry run on one NCCL rank. The
     ranks' times are those of 4 processes sharing one card, not scaling;
 12. bench.py's huge_10m scale, run after phase 9 and before phase 10's
     profiler (its kernel times are queued for phase 10, and its scene is
     freed before phase 11): the KAIST preset over make_urban_scene(830000,
     950, seed=7), 9,961,472 triangles in 38,912 chunks, traced with the
     auto prep group of 4 chunks (9,728 supergroups, 10 K3 words a tile) —
     a. the cold start through the command line: the scene as a binary PLY,
        `prime-cache` into this run's RADARAYS_SCENE_CACHE (the builder and
        each stage's seconds, the entry's GB), again ("already primed"),
        the warm load bit-equal to the cold build, the host's peak RSS;
     b. the host build of phase 5's 1M scene by the C++ library and by
        NumPy (RADARAYS_NO_NATIVE=1), stage by stage, every array and both
        device tables bit-equal;
     c. frames_phase at 10M (frames/s, launches, K3, K2, K1 and K5 against
        their plain versions on every bounce, one frame through the kernels
        and the plain versions), the resident scene and peak device MiB;
     d. the kernel trace against brute on 2,048 rays of phase 4's fan
        (equal hit and obj_id, t and normals within 1e-4);
     e. bounce 1's rays at prep group 1 against group 4: equal hits and
        objects, K1-K3 bitwise against their plain versions at both, and
        their times and bounds (in phase 10);
 13. the bench twins (radarays_ros_tpu_torch/bench/), run last, each as a
     user runs it — `python -m radarays_ros_tpu_torch.bench.<name>` in a
     process of its own with this run's environment and scene cache
     (where phase 12 left the 10M build) — and their JSON lines checked
     (every time and rate finite and above 0, the card named, parity
     exact, the kernels of each path launched: K1, K2, K3, K5 at 1M and
     10M, K1, K4, K5 at 10k, K5's backward in the fit, whose start
     gradient must be finite and nonzero): headline (the 1M line, the 10k
     and 10M companions in its details), engines --saturated,
     profile_frame, opti_scale, multichip on 2 gloo ranks sharing the
     card, sweep_kernel_ab (the SAH order at chunk size 256), order_ab
     --proxy and --hw for the median order, chunksize_ab --hw at 128, 384
     and 512 (a size refused although K1's stages fit the card fails the
     run) and make_demo (its PNGs read back); then the twins' shapes
     through the kernels and through the plain versions: a batch of 20
     frames with explicit random inputs at 1M (chunk sizes 128, 256, 384
     and 512), 10k and 10M (run after phase 12, while its scene is
     resident), bit-identical, and one loss and gradient of opti_scale's
     fit (as phase 7's, with K5, its backward and K4 bitwise at the fit's
     shapes). Each twin's seconds.
A kernel's time (ms) is its mean device time per launch from
torch.profiler's CUDA activity over a loop of wrapper calls (K3's and K4's
with the window's other device work: K3's memset that zeroes its words, an
older K4 wrapper's entry fill); wrapper_ms is CUDA events around the same
loop, so wrapper_ms - ms is the host's cost per call; ms_source says which
(events where the profile held no device time). A kernel's bound is the
larger of its operations over PEAK_OPS (the published f32 rate) and its
bytes over PEAK_BYTES, counting each input byte once and the work these
inputs need: K1, for each lane, the chunks its own slab test keeps with an
entry <= min(best_t, t_last) at the end, x chunk size x 56 operations, and
the coefficients of the distinct chunks some lane needs; K2 the slab tests
under the set coarse bits (K3 every supergroup, K4 every box) x 20; K5 2
operations per tap term whose point value is nonzero (the terms it runs);
its backward 2 per tap and valid signal, and the cotangent cells in some
signal's window.
The last three lines of stdout are the kernel table as JSON, the card's name
and power limit as nvidia-smi prints them, and the result JSON. Each row of
the table (sweep, prep_hier, coarse_words, prep_flat, bin, bin_bwd): its
launches over the run of the path that measured it (K1, K2, K3, K5 in
phase 5's timed batches, K4 in phase 6's, K5's backward in phase 7's Adam
steps) and per batch (per step for the backward); ms, wrapper_ms, plain_ms
and bound_ms per launch averaged over a batch's launches, ms_by_bounce; the
largest error; bound_by; library_ms (null: no single PyTorch call computes
these functions) with a library_note saying why; path_10m, the same
figures from phase 12c for K1, K2, K3 and K5 (null for the others);
launches_per_batch_of_20, the launches a batch of 20 made in phase 13's
headline twin at 1M, 10k and 10M (null for a companion it skipped). Details
also go to chiprun_out/chip_smoke.json.

With --kernel-times the script runs, through the port found under ROOT
(default: this checkout), one batch of each frame path (phases 5 and 6, or
those named after ROOT):
every trace kernel on each bounce and K5's forward, each checked against
its plain version and timed by device time and wrapper events, and the
batch's profile with the copies made inside bin_signals; it prints one
JSON line. Two checkouts run in turns in one call compare their kernels
on one card.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

BATCH = 4            # frames per simulate_frames call on the main path
TIMED_BATCHES = 10
GATE_RAYS = 131072
FIT_STEPS = 60       # Adam steps of phase 7, split around a checkpoint
FIT_TARGET_DB = 40.0
CLI_FRAMES = 8       # frames of phase 8b's synced replay
CLI_SEED = 5
SAT_RAYS = 1_048_576  # rays of each saturated-trace set (phase 9a)
SAT_CAP = 75.0       # its two-phase cap [m] (benchmarks/engines.py:128)
# bench.py:119-182: air, and opaque wall-stone on every object
AIR = dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0)
WALL = dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over `reps` calls after one warm-up,
    with CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps: int, name: str, whole: bool = False) -> dict:
    """A kernel's time per launch over `reps` calls of its wrapper fn, after
    one warm-up: `ms`, the mean device time of the CUDA kernel KERNEL[name]
    from torch.profiler's CUDA activity (with whole, plus the time of every
    other device event in the window per launch: K3's memset that zeroes
    its words, the entry fill an older K4 wrapper launched); `wrapper_ms`,
    CUDA events around the loop of wrapper calls (cuda_ms: the host's work
    per call included); the host-to-device copies and the other device
    events (kernels, memsets, copies) in the profiled window. Should the
    profile hold no such kernel, ms is wrapper_ms and ms_source says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wrapper = cuda_ms(fn, reps)
    for _ in range(3):       # a profile may miss the launches at its start
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [e for e in dev if KERNEL[name] in e.name]
        if 2 * len(mine) >= reps:
            break
    others = [e for e in dev if KERNEL[name] not in e.name]
    htod = sum("HtoD" in e.name for e in dev)
    if not mine:
        return dict(ms=wrapper, wrapper_ms=wrapper, htod_copies=htod,
                    ms_source="CUDA events around the wrapper loop (the "
                              "profile held no device time)")
    # the mean over the launches the profile caught (it may miss one at
    # its start)
    ms = sum(e.time_range.elapsed_us() for e in mine) / len(mine) / 1e3
    extra = {}
    if whole and others:
        extra["companion_ms"] = sum(e.time_range.elapsed_us()
                                    for e in others) / len(mine) / 1e3
        extra["companions"] = sorted({e.name[:80] for e in others})
        ms += extra["companion_ms"]
    return dict(ms=ms, wrapper_ms=wrapper, htod_copies=htod,
                profiled_launches=len(mine), other_device_events=len(others),
                **extra, ms_source="torch.profiler CUDA kernel time"
                + (" incl. the window's other device work" if whole else ""))


# Profiler work waits until every end-to-end figure is taken: after a
# torch.profiler session the host enqueues more slowly for the rest of the
# process (on the H100 the host-bound batches of phases 5 and 6 ran slower
# behind one), so kernel_ms and batch_profile run in phase 10, after the
# CLI and the trace extras.
DEFERRED = []


def timed(row: dict, fn, reps: int, name: str, whole: bool = False) -> dict:
    """Queue kernel_ms(fn, reps, name, whole) for phase 10, which adds its
    figures to row; returns row."""
    DEFERRED.append(lambda: row.update(kernel_ms(fn, reps, name, whole)))
    return row


def max_abs(a, b) -> float:
    """Max |a - b| over entries finite in both; the non-finite patterns
    must agree exactly."""
    import torch

    a, b = a.float(), b.float()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    check(torch.equal(fa, fb) and torch.equal(a[~fa], b[~fb]),
          "non-finite entries differ")
    return float((a[fa] - b[fb]).abs().max()) if fa.any() else 0.0


def frame_contract(got, want) -> dict:
    """tests/test_oracle.py:70-87 on two FrameResults of one frame."""
    import numpy as np

    img = got.image_float.double().cpu().numpy()
    ref = want.image_float.double().cpu().numpy()
    check(ref.max() > 0, "reference frame is empty")
    np.testing.assert_allclose(img, ref, atol=2e-4 * ref.max(), rtol=2e-3)
    np.testing.assert_allclose(got.max_val.double().cpu().numpy(),
                               want.max_val.double().cpu().numpy(),
                               rtol=1e-4, atol=1e-6)
    diff = np.abs(got.image_u8.cpu().numpy().astype(int)
                  - want.image_u8.cpu().numpy().astype(int))
    within = float((diff <= 1).mean())
    check(within >= 0.995 and diff.max() <= 3,
          f"u8 frame contract: {within:.4f} within 1, max {diff.max()}")
    return dict(u8_within_1=within, u8_max_diff=int(diff.max()),
                float_max_abs_diff=float(np.abs(img - ref).max()),
                bitwise=bool(np.array_equal(img, ref)))


def fan(n_rays: int, device):
    """The bench.py:78-85 gate fan: 400 azimuths x n_rays // 400
    elevations from default_rng(0) normal(0, 0.06), origin (0, 0, 2)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    A = 400
    S = n_rays // A
    az = np.repeat(np.linspace(0, 2 * np.pi, A, endpoint=False), S)
    el = np.tile(rng.normal(0, 0.06, S), A)
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).astype(np.float32)
    o = np.broadcast_to(np.array([0, 0, 2.0], np.float32), d.shape).copy()
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))


# The card's published peaks for the bounds (NVIDIA's H100 SXM data sheet,
# at a 700 W power limit): 67 TFLOP/s in f32 outside the tensor cores, and
# the HBM rate. Operations are counted as separate multiplies and adds. The
# kernels' -fmad=false build issues each as an instruction of its own, so
# they can reach at most half this rate; that is their choice (bit-equality
# with the plain versions), not the function's, and the bound ignores it.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PAIR = 56        # K1: one (ray, triangle) test, sweep.cu's inner loop
OPS_SLAB = 20        # K2/K3/K4: one (lane, box) slab test, prep.cu:slab_keep
LIBRARY_NOTE = {
    "sweep": "no PyTorch call computes a ranked nearest-hit sweep with "
             "early termination",
    "prep_hier": "no PyTorch call computes slab entries under a coarse "
                 "bitmap (the plain version is many ops)",
    "coarse_words": "no PyTorch call computes packed per-tile slab-overlap "
                    "bits",
    "prep_flat": "no PyTorch call computes per-block slab entries and lane "
                 "t_last in one call",
    "bin": "index_add_ would bin without the 35 fused denoise taps; the "
           "fused function has no single PyTorch call",
    "bin_bwd": "gather would take the cotangent at the cells without the "
               "35 taps' adjoint correlation; no single PyTorch call "
               "computes both"}
# each wrapper's CUDA kernel, as the profiler names it
KERNEL = {"sweep": "sweep_kernel", "prep_hier": "prep_hier_kernel",
          "coarse_words": "coarse_words_kernel",
          "prep_flat": "prep_flat_kernel", "bin": "bin_kernel",
          "bin_bwd": "bin_bwd_kernel"}


def bound(ops: float, nbytes: float) -> dict:
    """The least time for `ops` operations and `nbytes` bytes on the card:
    the larger of ops / PEAK_OPS and bytes / PEAK_BYTES, in ms."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops=float(ops), bytes=float(nbytes))


def popcount(words):
    """Set bits per row of an int32 word array (rows, n_words)."""
    import torch

    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    return ((words[..., None] >> shifts) & 1).sum(dim=(-1, -2))


def kernels_vs_plain(st, o, d, bud, rb: int, reps: int,
                     group: int = 0) -> dict:
    """The culling prep (K3 and K2, or K4 below the hierarchical threshold)
    and K1 against their plain versions on one ray set, over supergroups of
    `group` chunks (0: the trace's auto group); returns per-kernel
    {max_abs_err, bitwise, ms, plain_ms, bound_ms, bound_by, ...}."""
    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    group = group or CT._auto_prep_group(st.n_chunks)
    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(st, o, d, bud,
                                                    ray_block=rb, group=group)
    Rp, Cp = o.shape[0], lo.shape[0]
    ray_bytes = Rp * (12 + 12 + 4)              # o, 1/d, budget
    out = {}
    if Cp % CT._SG == 0 and Cp // CT._SG >= 8:
        rbt = next(r for r in (1024, 512, 256, 128) if rb % r == 0)
        slo, shi = CT._coarse_boxes(lo, hi)
        w_k = CT.coarse_words(slo, shi, o, inv_d, bud, 1000.0, rbt)
        w_p = CT._coarse_words_plain(slo, shi, o, inv_d, bud, 1000.0, rbt)
        n_bad = int((w_k != w_p).sum())
        check(n_bad == 0, f"K3 coarse words: {n_bad} words differ")
        out["coarse_words"] = timed(dict(
            max_abs_err=0.0, bitwise=True,
            plain_ms=cuda_ms(lambda: CT._coarse_words_plain(
                slo, shi, o, inv_d, bud, 1000.0, rbt), max(1, reps // 5)),
            **bound(Rp * slo.shape[0] * OPS_SLAB,
                    ray_bytes + slo.shape[0] * 24 + w_k.numel() * 4)),
            lambda: CT.coarse_words(slo, shi, o, inv_d, bud, 1000.0, rbt),
            reps, "coarse_words", whole=True)
        args = (w_k, lo, hi, o, inv_d, bud, 1000.0, rb, rbt)
        set_bits = popcount(w_k)                                 # (G,)
        out["prep_hier"], e_k, t_k = prep_row(
            "prep_hier", lambda: CT.prep_hier(*args),
            lambda: CT._prep_plain(*args[1:], words=w_k),
            int(set_bits.sum()) * CT._SG * rbt,
            ray_bytes + Cp * 24 + w_k.numel() * 4, reps, boxes=Cp,
            set_bits_per_tile_mean=float(set_bits.float().mean()),
            set_bits_per_tile_max=int(set_bits.max()),
            supergroups=int(slo.shape[0]))
    else:
        out["prep_flat"], e_k, t_k = flat_vs_plain(lo, hi, o, inv_d, bud,
                                                   rb, reps)
    out["sweep"] = sweep_vs_plain(st, e_k, C2, o, d, t_k, bud, reps,
                                  boxes=(st.chunk_lo, st.chunk_hi, inv_d),
                                  group=group)
    for row in out.values():
        row["group"] = group
    return out


def flat_vs_plain(lo, hi, o, inv_d, bud, rb: int, reps: int) -> tuple:
    """K4 against its plain version (the flat branch of _run_prep) on one
    ray set and box table: prep_row's (row, entry, t_last)."""
    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    Rp, Cp = o.shape[0], lo.shape[0]
    check(not (Cp % CT._SG == 0 and Cp // CT._SG >= 8),
          f"{Cp} boxes take the hierarchical prep, not K4")
    args = (lo, hi, o, inv_d, bud, 1000.0, rb)
    if "rbt" in inspect.signature(CT.prep_flat).parameters:
        # an older checkout's wrapper (--kernel-times) took the tile
        args += (next(r for r in (256, 512, 128) if rb % r == 0),)
    return prep_row("prep_flat", lambda: CT.prep_flat(*args),
                    lambda: CT._run_prep(*args[:5], t_max=1000.0, RB=rb,
                                         kernels=False),
                    Rp * Cp, Rp * (12 + 12 + 4) + Cp * 24, reps, boxes=Cp)


def prep_row(name: str, kernel, plain, tests: int, in_bytes: int,
             reps: int, **extra) -> tuple:
    """A prep kernel's (entry, t_last) from kernel() bit for bit against
    plain()'s; returns (its row: the plain version's time, the bound of
    `tests` slab tests over in_bytes of inputs and the outputs, and its
    time by kernel_ms on kernel(), queued, K4's with the window's other
    device work; entry; t_last)."""
    import torch

    e_k, t_k = kernel()
    e_p, t_p = plain()
    err = max(max_abs(e_k, e_p), max_abs(t_k, t_p))
    bitwise = bool(torch.equal(e_k, e_p) and torch.equal(t_k, t_p))
    check(bitwise, f"{name}: not bitwise (max abs error {err})")
    return timed(dict(max_abs_err=err, bitwise=bitwise, slab_tests=tests,
                      **extra, plain_ms=cuda_ms(plain, max(1, reps // 5)),
                      **bound(tests * OPS_SLAB, in_bytes + e_k.numel() * 4
                              + t_k.numel() * 4)),
                 kernel, reps, name, whole=name == "prep_flat"), e_k, t_k


def lane_kept(lo, hi, o, inv_d, cap, lim):
    """For each lane, the chunks its own slab test keeps (as the prep tests
    them) with an entry <= lim: the visits that lane needs to prove its
    nearest hit. Returns the counts (R,) and which chunks some lane needs
    (C,) bool."""
    import torch

    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    R, C = o.shape[0], lo.shape[0]
    n = torch.empty(R, dtype=torch.int64, device=o.device)
    seen = torch.zeros(C, dtype=torch.bool, device=o.device)
    step = max(1, (1 << 24) // C)
    for r0 in range(0, R, step):
        sl = slice(r0, r0 + step)
        keep, tn0 = CT._slab_keep(lo[None], hi[None], o[sl, None],
                                  inv_d[sl, None], cap[sl, None])
        need = keep & (tn0 <= lim[sl, None])
        n[sl] = need.sum(dim=1)
        seen |= need.any(dim=0)
    return n, seen


def sweep_vs_plain(st, e_k, C2: int, o, d, t_k, bud, reps: int,
                   boxes, group: int = 1) -> dict:
    """K1 against its plain version after the prep's entries e_k over
    supergroups of `group` chunks, with the supergroup visits the plain
    version's loop made, the visits the lanes need by their block's ranking
    (per lane, the ranked entries of its block <= min(best_t, t_last) at
    the end), and the chunks each lane keeps itself (lane_kept on the chunk
    boxes = (lo, hi, inv_d), whatever the group), from which the bound is
    counted."""
    import torch

    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    nvisit, order, entry = CT._rank(e_k[:, :C2])
    args = (nvisit, order, entry, o, d, t_k, st.coef, st.fetch)
    kw = dict(tc=st.chunk_size, group=group, t_min=0.0)
    bt_k, bi_k, rows_k = CT.sweep(*args, **kw)
    bt_p, bi_p, rows_p, visits = CT._sweep_plain(*args, **kw,
                                                 with_visits=True)
    n_win = int((bi_k != bi_p).sum())
    check(n_win == 0, f"K1 sweep: {n_win} winners differ")
    err = max(max_abs(bt_k, bt_p), max_abs(rows_k, rows_p))
    check(err <= 1e-6 * 1000.0, f"K1 sweep: max abs error {err}")
    B, RB = nvisit.shape[0], o.shape[0] // nvisit.shape[0]
    lim = torch.minimum(bt_p, t_k).view(B, RB)
    needed = torch.minimum(
        torch.searchsorted(entry[:, :-1].contiguous(), lim, right=True),
        nvisit[:, None].long())                                   # (B, RB)
    kept, seen = lane_kept(*boxes[:2], o, boxes[2],
                           torch.clamp_max(bud, 1000.0), lim.view(-1))
    block_visits = visits.amax(dim=1)                             # (B,)
    cta = visits.view(B, -1, 128 // 32).amax(dim=2)       # K1's CTAs
    lanes = int((bud > 0).sum())
    tri_bytes = st.chunk_size * 22 * 4
    hit = (bud > 0) & (bt_p <= torch.clamp_max(bud, 1000.0))
    return timed(dict(
        max_abs_err=err, bitwise=bool(torch.equal(bt_k, bt_p)
                                      and torch.equal(rows_k, rows_p)),
        winners_differ=n_win,
        hit_rate=float(hit.float().sum() / max(lanes, 1)),
        live_lanes=lanes, ranked_chunks_max=int(nvisit.max()),
        ranked_chunks_mean=float(nvisit.float().mean()),
        visits_block_mean=float(block_visits.float().mean()),
        visits_block_max=int(block_visits.max()),
        visits_cta128_mean=float(cta.float().mean()),
        visits_group32_mean=float(visits.float().mean()),
        visits_needed_lane_mean=float(needed.float().mean()),
        visits_needed_lane_max=int(needed.max()),
        chunks_kept_lane_mean=float(kept.float().mean()),
        chunks_kept_lane_max=int(kept.max()),
        distinct_chunks_needed=int(seen.sum()),
        plain_ms=cuda_ms(lambda: CT._sweep_plain(*args, **kw), 1),
        **bound(float(kept.sum()) * st.chunk_size * OPS_PAIR,
                int(seen.sum()) * tri_bytes + o.shape[0] * (12 + 12 + 4)
                + order.numel() * 8 + o.shape[0] * (4 + 4 + 64))),
        lambda: CT.sweep(*args, **kw), reps, "sweep")


def per_launch(rows: list) -> dict:
    """One kernel's figures over the bounces of a batch (one launch each):
    ms, plain_ms and bound_ms per launch averaged over the bounces, beside
    their lists by bounce; the largest error; bitwise on every bounce."""
    n = len(rows)
    ops, nbytes = sum(r["ops"] for r in rows), sum(r["bytes"] for r in rows)
    out = dict(
        bitwise=all(r["bitwise"] for r in rows),
        max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in rows) / n,
        ms_by_bounce=[r["ms"] for r in rows],
        wrapper_ms=sum(r["wrapper_ms"] for r in rows) / n,
        wrapper_ms_by_bounce=[r["wrapper_ms"] for r in rows],
        ms_source="; ".join(sorted({r["ms_source"] for r in rows})),
        plain_ms=sum(r["plain_ms"] for r in rows) / n,
        plain_ms_by_bounce=[r["plain_ms"] for r in rows],
        **bound(ops / n, nbytes / n),
        bound_ms_by_bounce=[r["bound_ms"] for r in rows])
    out["by_bounce"] = rows
    return out


def tap_windows(mask, W: int, mode: int):
    """For each cell c of the rows of a bool mask (rows, n_cells): does the
    tap window [c - (W-1-mode), c + mode] hold a set cell? The window of
    K5's output c, and the cells p its backward reads around a signal's
    cell are those whose window holds that cell."""
    import torch

    x = torch.nn.functional.pad(mask.float()[:, None], (W - 1 - mode, mode))
    return torch.nn.functional.max_pool1d(x, W, 1)[:, 0] > 0


def kernel_rows(by_bounce: list, k5: dict) -> dict:
    """A path's kernels after phase 10: per_launch over the bounces for the
    trace kernels, K5 and its backward (one launch a batch) as they are."""
    rows = {k: per_launch([b[k] for b in by_bounce]) for k in by_bounce[0]}
    for k, v in k5.items():
        rows[k] = dict(v, ms_by_bounce=[v["ms"]])
    return rows


def bin_vs_plain(cell, s, weights, mode, n_cells: int, reps: int) -> dict:
    """K5 and its backward against their plain versions, bit for bit
    (bin_fwd_vs_plain, then bin_bwd_vs_plain on the forward's output)."""
    wt = None if weights is None else tuple(float(x) for x in weights)
    kw = dict(n_cells=n_cells, combine="sum", weights=wt, w_mode=mode)
    fwd, got = bin_fwd_vs_plain(cell, s, kw, reps)
    return {"bin": fwd, "bin_bwd": bin_bwd_vs_plain(cell, s, got, kw, reps)}


def bin_fwd_vs_plain(cell, s, kw: dict, reps: int) -> tuple:
    """K5's forward against _bin_plain, bit for bit, for bin_signals'
    keyword arguments kw (combine "sum"); returns (its row, the kernel's
    output). The bound counts what these inputs need: the (cell, strength)
    inputs read and the f32 image written once, and 2 operations a tap term
    whose point value is nonzero (window_share of the cells have such a
    term in their tap window, terms_per_window of them on average)."""
    import torch

    from radarays_ros_tpu_torch.image.cuda_draw import _bin_plain, bin_signals

    n_cells, wt, mode = kw["n_cells"], kw["weights"], kw["w_mode"]
    got = bin_signals(cell, s, **kw)
    want = _bin_plain(cell, s, **kw)
    fwd_bits = torch.equal(got.view(torch.int32), want.view(torch.int32))
    check(fwd_bits, f"K5 bin: not bitwise ({max_abs(got, want)})")
    W = 1 if wt is None else len(wt)
    point = _bin_plain(cell, s, n_cells=n_cells, combine="sum")
    windows = tap_windows(point != 0, W, mode)
    # a nonzero cell src is a term of the outputs [src - mode, src - mode
    # + W - 1] inside the row
    src = (point != 0).nonzero()[:, 1]
    terms = int((torch.clamp(src - mode + W - 1, max=n_cells - 1)
                 - torch.clamp(src - mode, min=0) + 1).sum())
    rows = cell.shape[0]
    fwd = timed(dict(max_abs_err=0.0, bitwise=fwd_bits,
                     window_share=float(windows.float().mean()),
                     terms_per_window=terms / max(int(windows.sum()), 1),
                     plain_ms=cuda_ms(lambda: _bin_plain(cell, s, **kw), 2),
                     **bound(2 * terms,
                             cell.numel() * 8 + rows * n_cells * 4)),
                lambda: bin_signals(cell, s, **kw), reps, "bin")
    return fwd, got


def bin_bwd_vs_plain(cell, s, got, kw: dict, reps: int) -> dict:
    """K5's backward kernel, for a fixed random cotangent on the forward's
    output got, against _bin_bwd and _bin_bwd_signals, bit for bit. The
    bound: 8 bytes read and 4 written a signal, the cotangent cells in some
    valid signal's window read once, 2 operations a tap a valid signal."""
    import torch

    from radarays_ros_tpu_torch.image.cuda_draw import (_bin_bwd,
                                                        _bin_bwd_signals,
                                                        bin_bwd)

    n_cells, wt, mode = kw["n_cells"], kw["weights"], kw["w_mode"]
    W = 1 if wt is None else len(wt)
    rows = cell.shape[0]
    g = torch.randn(got.shape, device=got.device,
                    generator=torch.Generator(got.device).manual_seed(1))
    ds = bin_bwd(cell, s, got, g, **kw)
    for plain in (_bin_bwd, _bin_bwd_signals):
        ref = plain(cell, s, got, g, **kw)
        bits = torch.equal(ds.view(torch.int32), ref.view(torch.int32))
        check(bits, f"K5 backward vs {plain.__name__}: not bitwise "
                    f"({max_abs(ds, ref)})")
    ok = (cell >= 0) & (cell < n_cells)
    hit = torch.zeros(rows, n_cells + 1, dtype=torch.bool, device=cell.device)
    hit.scatter_(1, torch.where(ok, cell, n_cells).long(), True)
    read = tap_windows(hit[:, :n_cells], W, mode)
    return timed(dict(max_abs_err=0.0, bitwise=True,
                      plain_ms=cuda_ms(lambda: _bin_bwd(cell, s, got, g,
                                                        **kw), 2),
                      signals_plain_ms=cuda_ms(lambda: _bin_bwd_signals(
                          cell, s, got, g, **kw), 2),
                      **bound(2 * W * int(ok.sum()),
                              cell.numel() * 12 + int(read.sum()) * 4)),
                 lambda: bin_bwd(cell, s, got, g, **kw), reps, "bin_bwd")


def kaist_setup(device, n_buildings: int = 83000, extent: float = 300.0):
    """bench.py:119-182: the MulRan KAIST preset over the urban scene
    (~1M triangles, or the 10k companion at 800 buildings, or bench.py's
    ~10M companion at 830,000 over extent 950), opaque wall-stone
    everywhere, the material map baked."""
    from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
    from radarays_ros_tpu_torch.geom.scene import Scene
    from radarays_ros_tpu_torch.sim.config import RadarModelConfig

    t0 = time.perf_counter()
    parts, names = make_urban_scene(n_buildings=n_buildings, extent=extent,
                                    seed=7)
    scene = Scene.compose(parts, names, chunk_size=256)
    del parts, names
    t1 = time.perf_counter()
    stages = {}
    host = scene.host_arrays(cache=False, stages=stages)
    t_host = time.perf_counter()
    st, params = kaist_tensors(host, scene.n_objects, device)
    t2 = time.perf_counter()
    cfg = RadarModelConfig(
        n_angles=400, n_cells=3424, resolution=0.0595238, n_samples=50,
        n_reflections=4, beam_sample_dist=2,
        beam_sample_dist_normal_p_in_cone=0.8, energy_max=0.72,
        signal_max=110.0, signal_denoising=1,
        signal_denoising_triangular_width=35,
        signal_denoising_triangular_mode=0.35, ambient_noise=2,
        ambient_noise_at_signal_0=0.1, ambient_noise_at_signal_1=0.03,
        ambient_noise_energy_max=0.1, ambient_noise_energy_min=0.05,
        record_multi_reflection=True, record_multi_path=False,
        opaque_materials=True, trace_engine="kernel", draw_method="auto",
        trace_ray_block=2048, trace_aux_baked=True)
    return scene, st, params, cfg, dict(
        scene_gen_s=t1 - t0, host_build_s=t_host - t1,
        host_build_stages=stages, host_build_and_upload_s=t2 - t1,
        n_triangles=st.n_triangles, n_chunks=st.n_chunks), host


def kaist_tensors(host, n_objects: int, device):
    """Upload a host build with the KAIST materials (wall-stone on every
    object, beam width 10 deg) and bake the material map, as Radar does."""
    import numpy as np

    from radarays_ros_tpu_torch.geom.scene import bake_tri_aux, scene_tensors
    from radarays_ros_tpu_torch.sim.config import Materials, RadarParams

    st = scene_tensors(host, device)
    params = RadarParams.make(Materials.from_list([AIR, WALL], device=device),
                              np.ones(n_objects, np.int32),
                              beam_width_deg=10.0)
    st = bake_tri_aux(st, params.object_materials.float()[
        st.obj_ids.clamp(0, n_objects - 1).long()])
    return st, params


def counters():
    """Every kernel wrapper of the port, by kernel name."""
    from radarays_ros_tpu_torch.image.cuda_draw import bin_bwd, bin_signals
    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    return {"sweep": CT.sweep, "prep_hier": CT.prep_hier,
            "coarse_words": CT.coarse_words, "prep_flat": CT.prep_flat,
            "bin": bin_signals, "bin_bwd": bin_bwd}


def zero_counts() -> dict:
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def read_counts(wrappers) -> dict:
    return {k: fn.launches for k, fn in wrappers.items()}


def batch_poses():
    """The poses of a frames batch: BATCH frames 0.5 m apart in x."""
    import numpy as np
    import torch

    from radarays_ros_tpu_torch.utils.transforms import make_pose

    return torch.from_numpy(np.stack(
        [make_pose([0.5 * f, 0.25 * f, 2.0]) for f in range(BATCH)]))


def batch_waves(params, cfg, poses, gen, dev):
    """A batch's starting waves, the cone drawn from generator gen:
    (waves, sensor_pos, the cone's local directions)."""
    import torch

    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.wave.cone import sample_cone_local

    local = torch.stack([sample_cone_local(
        gen, params.beam_width, cfg.n_samples, cfg.beam_sample_dist,
        cfg.beam_sample_dist_normal_p_in_cone) for _ in range(poses.shape[0])])
    return (*P.start_waves(params, cfg, poses, local_dirs=local, device=dev),
            local)


def ray_major(x):
    """An (N, A, S, ...) wave field in the trace's ray-major order, flat."""
    return x.movedim(0, 2).reshape(-1, *x.shape[3:]).contiguous()


def bounce_rays(st, params, cfg, waves, sensor_pos):
    """The batch's bounces one by one through the pipeline's _bounce:
    yields (pass_id, waves, o, d, budget), the rays and budgets in its
    ray-major order."""
    import torch

    from radarays_ros_tpu_torch.sim import pipeline as P

    for pass_id in range(cfg.n_reflections):
        yield (pass_id, waves, ray_major(waves.orig), ray_major(waves.dir),
               ray_major(P.trace_budget(cfg, waves)))
        with torch.no_grad():
            waves, _ = P._bounce(cfg, params, st, waves, sensor_pos, pass_id)


def bin_inputs(st, params, cfg, waves, sensor_pos):
    """K5's inputs for a batch's signals, as image/draw.py hands them to
    bin_signals: (cell, s), invalid signals at cell n_cells with s 0."""
    import torch

    from radarays_ros_tpu_torch.image.draw import bin_cells
    from radarays_ros_tpu_torch.sim import pipeline as P

    with torch.no_grad():
        times, strengths, valid = P.collect_signals(st, params, cfg, waves,
                                                    sensor_pos)
    N, A = times.shape[:2]
    c = bin_cells(times.reshape(N * A, -1), cfg.resolution)
    ok = valid.reshape(N * A, -1) & (c >= 0) & (c < cfg.n_cells)
    return (torch.where(ok, c, cfg.n_cells).to(torch.int32).contiguous(),
            torch.where(ok, strengths.reshape(N * A, -1), 0.0).contiguous())


def batch_profile(run) -> dict:
    """One call of run() under torch.profiler (CPU and CUDA activity): the
    device's kernels, copies by kind (those from or to pageable host
    memory synchronize the host) and by the host op that issued them, its
    busy share of the window from its first to its last event, the host's
    synchronizing runtime calls, and the memcpy runtime calls made inside
    bin_signals (its autograd Function, _Bin)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evs = prof.events()
    dev = [e for e in evs if e.device_type == DeviceType.CUDA]
    cpu = [e for e in evs if e.device_type == DeviceType.CPU]
    copies = collections.Counter(e.name for e in dev
                                 if e.name.startswith("Memcpy"))
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    window = end - min(e.time_range.start for e in dev)

    def chain(e):
        names = []
        while e is not None and len(names) < 3:
            names.append(e.name)
            e = e.cpu_parent
        return " < ".join(names)

    # (the profiler's own buffer marker lists the copies it interrupts)
    by_op = collections.Counter(chain(e) for e in cpu for k in e.kernels
                                if k.name.startswith("Memcpy")
                                and e.name != "Activity Buffer Request")
    by_op["(no host op)"] = sum(copies.values()) - sum(by_op.values())
    return dict(
        kernels=sum(not e.name.startswith(("Memcpy", "Memset"))
                    for e in dev),
        copies=dict(copies), copies_by_op=dict(by_op),
        pageable_copies=sum(n for k, n in copies.items() if "Pageable" in k),
        sync_calls=dict(collections.Counter(
            e.name for e in cpu if e.name in (
                "cudaStreamSynchronize", "cudaDeviceSynchronize",
                "cudaEventSynchronize", "cudaMemcpy"))),
        device_busy_ms=busy / 1e3, device_window_ms=window / 1e3,
        device_idle_share=1.0 - busy / window,
        bin_calls=sum(e.name == "_Bin" for e in cpu),
        memcpy_calls_in_bin=memcpy_calls_in(cpu, "_Bin"))


def memcpy_calls_in(cpu, op: str) -> int:
    """The memcpy runtime calls (cudaMemcpy*) that the host made inside the
    time ranges of the host op `op`, among a profile's CPU events: a copy
    that op issued, whatever the profiler attributes the device copy to."""
    spans = [e.time_range for e in cpu if e.name == op]
    return sum(e.name.startswith("cudaMemcpy") and any(
        r.start <= e.time_range.start <= r.end for r in spans) for e in cpu)


def copy_check_control(dev) -> int:
    """The positive control of the copy check: memcpy_calls_in over a range
    named as bin_signals' Function (_Bin) that holds the copy K5's wrapper
    once made on every call (its taps, a pageable numpy array, to
    the device). A check that sees the copy counts at least 1."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    taps = np.linspace(0.0, 1.0, 35, dtype=np.float32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("_Bin"):
            torch.as_tensor(taps, device=dev)
        torch.cuda.synchronize()
    return memcpy_calls_in([e for e in prof.events()
                            if e.device_type == DeviceType.CPU], "_Bin")


def frames_phase(tag: str, st, params, cfg, dev, expect_zero=(),
                 min_column_share: float = 0.5):
    """Timed KAIST batches on one scene (the launch count of every kernel
    over the timed run; those in expect_zero must stay at 0, the others
    must launch; every frame has signal in at least min_column_share of
    its columns), each kernel of the path vs its plain version on each
    bounce of a batch, and one frame through the kernels and through the
    plain versions under the frame contract; the batch profile and the
    kernels' times are queued for phase 10. Returns (frame figures,
    launches, the trace kernels vs plain by bounce, K5 and its backward vs
    plain, frame vs plain)."""
    import torch

    from radarays_ros_tpu_torch.sim import pipeline as P

    poses = batch_poses()
    gen = torch.Generator(dev).manual_seed(0)

    def run_batch():
        return P.simulate_frames(st, params, cfg, poses, generator=gen)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = run_batch()                              # warm-up, not counted
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    wrappers = zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_BATCHES):
        res = run_batch()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(wrappers)
    dev_ms = start.elapsed_time(end)
    n_frames = TIMED_BATCHES * BATCH
    check(all((n == 0) == (k in expect_zero) for k, n in launches.items()),
          f"launches {launches}: {list(expect_zero)} must be 0, the others "
          "above 0")
    nz_cols = (res.image_u8 > 0).any(dim=1).float().mean(dim=1)
    check(bool((nz_cols >= min_column_share).all()),
          f"trivial image: {nz_cols.tolist()}")
    check(bool(torch.isfinite(res.image_float).all()), "non-finite image")
    check(tuple(res.image_u8.shape) == (BATCH, cfg.n_cells, cfg.n_angles),
          f"image shape {tuple(res.image_u8.shape)}")
    frames = dict(
        batch=BATCH, timed_batches=TIMED_BATCHES,
        frames_per_s=n_frames / (dev_ms / 1e3),
        ms_per_frame=dev_ms / n_frames, wall_frames_per_s=n_frames / wall,
        warmup_batch_s=warm_s, launches=launches,
        nonzero_column_share=nz_cols.tolist(),
        mean_pixel=float(res.image_u8.float().mean()))
    log(f"[{tag} frames] {json.dumps(frames)}")
    del warm, res
    DEFERRED.append(lambda: frames.update(profile=batch_profile(run_batch)))

    # kernels vs plain on each bounce's rays
    waves0, sensor_pos, local = batch_waves(params, cfg, poses, gen, dev)
    by_bounce = []
    for pass_id, waves, o, d, budget in bounce_rays(st, params, cfg, waves0,
                                                    sensor_pos):
        mb = kernels_vs_plain(st, o, d, budget, rb=cfg.trace_ray_block,
                              reps=10)
        s = mb["sweep"]
        line = dict(
            bounce=pass_id + 1, rays=int(waves.valid.numel()),
            valid_share=float(waves.valid.float().mean()),
            hit_rate=s["hit_rate"], nvisit_mean=s["ranked_chunks_mean"],
            nvisit_max=s["ranked_chunks_max"],
            visits_block_mean=s["visits_block_mean"],
            visits_block_max=s["visits_block_max"],
            visits_cta128_mean=s["visits_cta128_mean"],
            visits_group32_mean=s["visits_group32_mean"],
            visits_needed_lane_mean=s["visits_needed_lane_mean"],
            visits_needed_lane_max=s["visits_needed_lane_max"],
            chunks_kept_lane_mean=s["chunks_kept_lane_mean"],
            chunks_kept_lane_max=s["chunks_kept_lane_max"],
            **{k: {kk: v[kk] for kk in ("bitwise", "plain_ms", "bound_ms",
                                        "bound_by")}
               for k, v in mb.items()})
        log(f"[{tag} bounce {pass_id + 1}] {json.dumps(line)}")
        by_bounce.append(mb)

    cell, strength = bin_inputs(st, params, cfg, waves0, sensor_pos)
    w, mode = cfg.denoiser()
    k5 = bin_vs_plain(cell, strength, w, mode, cfg.n_cells, reps=20)
    log(f"[{tag} K5 vs plain: {cell.shape[0]} rows] " + json.dumps(
        {k: {kk: v[kk] for kk in ("bitwise", "plain_ms", "bound_ms",
                                  "bound_by", "window_share",
                                  "terms_per_window") if kk in v}
         for k, v in k5.items()}))

    # one frame through the kernels and through the plain versions
    pose = poses[0]
    rbeg = torch.randint(0, 1000, (cfg.n_angles,), generator=gen, device=dev)
    kw = dict(local_dirs=local[0], random_begin=rbeg)
    t0 = time.perf_counter()
    fk = P.simulate_frame(st, params, cfg, pose, **kw)
    torch.cuda.synchronize()
    kernel_frame_s = time.perf_counter() - t0
    plain_cfg = cfg.replace(trace_engine="sweep", draw_method="plain")
    t0 = time.perf_counter()
    fp = P.simulate_frame(st, params, plain_cfg, pose, **kw)
    torch.cuda.synchronize()
    plain_frame_s = time.perf_counter() - t0
    fvp = dict(kernel_frame_s=kernel_frame_s, plain_frame_s=plain_frame_s,
               **frame_contract(fk, fp))
    log(f"[{tag} frame kernels vs plain] {json.dumps(fvp)}")
    return frames, launches, by_bounce, k5, fvp


def fit_setup(device):
    """benchmarks/opti_scale.py at the KAIST image size: its scene, true
    and start materials (wall on buildings, "glass" on the ground), the
    9-dim vector (beam width + both slots), the refraction tree with 2
    reflections, 3 frames on its circular trajectory, fixed cone draws."""
    import math

    import numpy as np
    import torch

    from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
    from radarays_ros_tpu_torch.geom.scene import Scene, bake_tri_aux
    from radarays_ros_tpu_torch.opti.optimize import ParamVector
    from radarays_ros_tpu_torch.sim.config import (Materials,
                                                   RadarModelConfig,
                                                   RadarParams)
    from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

    parts, names = make_urban_scene(n_buildings=200, extent=150.0, seed=11)
    scene = Scene.compose(parts, names, chunk_size=256)
    st = scene.to_device(device, cache=False)
    om = np.ones(scene.n_objects, np.int32)
    om[0] = 2                                      # the ground
    st = bake_tri_aux(st, torch.from_numpy(om).to(device).float()[
        st.obj_ids.clamp(0, len(om) - 1).long()])

    def params(mats, deg):
        return RadarParams.make(Materials.from_list(mats, device=device), om,
                                beam_width_deg=deg)

    air = dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0)
    true = params([air,
                   dict(velocity=0.0, ambient=0.85, diffuse=0.15,
                        specular=900.0),
                   dict(velocity=0.0, ambient=0.35, diffuse=0.6,
                        specular=150.0)], 10.0)
    start = params([air,
                    dict(velocity=0.0, ambient=0.3, diffuse=0.6,
                         specular=150.0),
                    dict(velocity=0.0, ambient=0.9, diffuse=0.05,
                         specular=2000.0)], 7.0)
    cfg = RadarModelConfig(
        n_angles=400, n_cells=3424, resolution=0.0595238, n_samples=50,
        n_reflections=2, beam_sample_dist=2,
        beam_sample_dist_normal_p_in_cone=0.8, energy_max=0.72,
        signal_max=110.0, signal_denoising=1,
        signal_denoising_triangular_width=35,
        signal_denoising_triangular_mode=0.35, ambient_noise=0,
        record_multi_reflection=True, record_multi_path=False,
        opaque_materials=False, trace_engine="kernel", draw_method="auto",
        trace_ray_block=2048, trace_aux_baked=True)
    # Trajectory.circular(radius=25, n=3, period=8) + 2 m of height
    ang = 2 * np.pi * np.arange(3) / 3
    poses = np.zeros((3, 7), np.float32)
    poses[:, 0], poses[:, 1], poses[:, 2] = (25 * np.cos(ang),
                                             25 * np.sin(ang), 2.0)
    poses[:, 5] = np.sin((ang + np.pi / 2) / 2)
    poses[:, 6] = np.cos((ang + np.pi / 2) / 2)
    gen = torch.Generator(device).manual_seed(3)
    draws = [sample_cone_draws(gen, cfg.n_samples, cfg.beam_sample_dist)
             for _ in range(3)]
    pv = ParamVector(material_slots=(1, 2), tune_beam_width=True,
                     tune_n_reflections=False)
    return (st, true, start, cfg, torch.from_numpy(poses),
            tuple(torch.stack(d) for d in zip(*draws)), pv)


def fit_vs_plain(st, start, cfg, poses, draws, targets, pv,
                 reps: int) -> dict:
    """One loss and gradient of a fit's objective at `start` through the
    kernels and through the plain versions (the loss bitwise, the gradient
    within 1e-5 of its largest entry: autograd of the plain binning sums
    in another order than K5's backward), then K5, K5's backward and K4
    bitwise against their plain versions at the fit's shapes (the start's
    signals, the first pass's rays), timed over `reps` calls."""
    import torch

    from radarays_ros_tpu_torch.opti.optimize import (default_objective,
                                                      step_loss_fn)
    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    info = {}

    def loss_grad(c):
        obj = default_objective(st, c, poses, targets, cone_draws=draws)
        step_loss, _, to_z = step_loss_fn(obj, start, pv)
        z = to_z(pv.to_vec(start)).requires_grad_(True)
        loss = step_loss(z)
        loss.backward()
        return loss.detach(), z.grad

    lk, gk = loss_grad(cfg)
    lp, gp = loss_grad(cfg.replace(trace_engine="sweep", draw_method="plain"))
    g_err = float((gk - gp).abs().max())
    info.update(loss_kernel=float(lk), loss_plain=float(lp),
                loss_bitwise=bool(torch.equal(lk, lp)),
                grad_kernel=gk.tolist(), grad_plain=gp.tolist(),
                grad_max_abs_err=g_err)
    check(bool(torch.isfinite(gk).all()), f"non-finite gradient {gk}")
    check(bool(gk.abs().max() > 0), "all-zero gradient")
    check(info["loss_bitwise"], f"loss kernel {lk} vs plain {lp}")
    check(g_err <= 1e-5 * float(gp.abs().max()),
          f"gradient kernel vs plain: max abs error {g_err}")

    # K5 forward and backward at the fit's shapes (the start's signals)
    with torch.no_grad():
        waves, sensor_pos = P.start_waves(start, cfg, poses,
                                          cone_draws=draws,
                                          device=st.device)
    cell, s = bin_inputs(st, start, cfg, waves, sensor_pos)
    w, mode = cfg.denoiser()
    k5 = bin_vs_plain(cell, s, w, mode, cfg.n_cells, reps=reps)
    # and K4 on the first pass's rays and budgets, in ray-major order
    o, _, inv_d, bud, lo, hi, _ = CT._prep_inputs(
        st, ray_major(waves.orig), ray_major(waves.dir),
        ray_major(P.trace_budget(cfg, waves)),
        ray_block=cfg.trace_ray_block, group=1)
    k4 = flat_vs_plain(lo, hi, o, inv_d, bud, cfg.trace_ray_block, reps)[0]
    info["kernels_fit_shapes"] = dict(k5, prep_flat=k4, rows=cell.shape[0],
                                      signals_per_row=cell.shape[1])
    return info


def fit_phase(dev) -> dict:
    """Phase 7: targets at the true parameters, 60 Adam steps around a
    checkpoint save and load, launch counts, PSNR, and one loss and
    gradient through the kernels and through the plain versions."""
    import math
    import tempfile

    import torch

    from radarays_ros_tpu_torch.opti.checkpoint import (load_checkpoint,
                                                        save_checkpoint)
    from radarays_ros_tpu_torch.opti.optimize import (default_objective,
                                                      optimize_gradient)
    from radarays_ros_tpu_torch.sim import pipeline as P

    t0 = time.perf_counter()
    st, true, start, cfg, poses, draws, pv = fit_setup(dev)
    with torch.no_grad():
        targets = P.float_u8_image(P.simulate_frames(
            st, true, cfg, poses, cone_draws=draws), cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(bool(torch.isfinite(targets).all()) and float(targets.max()) > 0,
          "fit targets are empty or not finite")
    objective = default_objective(st, cfg, poses, targets, cone_draws=draws)
    info = dict(n_triangles=st.n_triangles, n_chunks=st.n_chunks,
                setup_s=setup_s, true_psnr_db=-float(objective(true)))

    wrappers = zero_counts()
    half = FIT_STEPS // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res1 = optimize_gradient(objective, start, pv, steps=half, lr=0.08)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit_ck.npz")
        save_checkpoint(path, res1.params, vec=res1.vec,
                        history=res1.history, step=half)
        resumed, extras = load_checkpoint(path, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res2 = optimize_gradient(objective, resumed, pv,
                             steps=FIT_STEPS - half, lr=0.04)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    # the first half carries the process's first backward passes (a
    # one-time cost of several seconds); the second half is steady state
    second_s = time.perf_counter() - t1
    launches = read_counts(wrappers)
    hist = list(res1.history) + list(res2.history)
    check(all(launches[k] > 0 for k in ("prep_flat", "sweep", "bin",
                                        "bin_bwd"))
          and launches["prep_hier"] == 0 and launches["coarse_words"] == 0,
          f"fit launches {launches}")
    check(extras["step"] == half, "checkpoint step")
    check(all(map(math.isfinite, hist)), "non-finite fit loss")
    to_target = next((i + 1 for i, v in enumerate(hist)
                      if v <= -FIT_TARGET_DB), None)
    info.update(steps=FIT_STEPS, fit_s=fit_s, steps_per_s=FIT_STEPS / fit_s,
                first_half_s=fit_s - second_s, second_half_s=second_s,
                steady_steps_per_s=(FIT_STEPS - half) / second_s,
                start_psnr_db=-hist[0], final_psnr_db=-min(hist),
                evals_to_target=to_target, target_psnr_db=FIT_TARGET_DB,
                resumed_from_step=int(extras["step"]), launches=launches,
                final_vec=[float(x) for x in res2.vec],
                history_psnr_db=[-v for v in hist])
    check(info["final_psnr_db"] > info["start_psnr_db"],
          "the fit's PSNR did not rise")

    info.update(fit_vs_plain(st, start, cfg, poses, draws, targets, pv,
                             reps=20))
    long = ("grad_kernel", "grad_plain", "history_psnr_db")
    log(f"[7 fit] {json.dumps({k: v for k, v in info.items() if k not in long})}")
    return info


def cli(argv) -> tuple:
    """io.cli.main in this process: (captured stdout, wall seconds); a
    nonzero exit code fails the run."""
    import contextlib
    import io

    from radarays_ros_tpu_torch.io.cli import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli {argv[0]} exited {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue(), dt


def show(tag: str, info: dict, *keys) -> None:
    log(f"[{tag}] " + json.dumps({k: info[k] for k in keys}))


def match(pattern: str, text: str):
    import re

    m = re.search(pattern, text)
    check(m is not None, f"no line matching {pattern!r} in {text[-2000:]!r}")
    return m


def segments_close(got: dict, want: dict) -> float:
    """Two rays JSONs hold the same segments: order, bounce, kind, medium
    and material exactly, positions and energies within 1e-4. Returns the
    largest difference."""
    import numpy as np

    check(got["n_rays"] == want["n_rays"]
          and len(got["segments"]) == len(want["segments"]) > 0,
          "rays: segment counts differ or are 0")
    err = 0.0
    for a, b in zip(got["segments"], want["segments"]):
        check(all(a[k] == b[k] for k in ("bounce", "kind", "medium",
                                         "material_id")), f"rays: {a} vs {b}")
        va = np.array(a["start"] + a["end"] + [a["energy"]])
        vb = np.array(b["start"] + b["end"] + [b["energy"]])
        err = max(err, float(np.abs(va - vb).max()))
    check(err <= 1e-4, f"rays: segments {err} apart")
    return err


def cli_phase(dev, scene5, host5, cfg, info5, scene10) -> dict:
    """Phase 8: the user's path through io.cli on files (module doc)."""
    import tempfile

    import numpy as np
    import torch

    from radarays_ros_tpu_torch.geom.mesh import load_mesh, save_ply
    from radarays_ros_tpu_torch.io.config import (load_scene_config,
                                                  save_preset,
                                                  save_scene_config)
    from radarays_ros_tpu_torch.io.image_io import read_png_gray
    from radarays_ros_tpu_torch.io.trajectory import Trajectory
    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.sim.config import Materials
    from radarays_ros_tpu_torch.wave.cone import sample_cone_local

    K_1M = ("sweep", "prep_hier", "coarse_words", "bin")
    info = {}
    t_phase = time.perf_counter()
    old_cache = os.environ.get("RADARAYS_SCENE_CACHE")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        def path(name):
            return os.path.join(tmp, name)

        os.environ["RADARAYS_SCENE_CACHE"] = path("cache")
        try:
            # ---- the files a user brings
            t0 = time.perf_counter()
            save_ply(path("urban_1m.ply"), scene5)
            info["ply_write_s"] = time.perf_counter() - t0
            info["ply_mib"] = os.path.getsize(path("urban_1m.ply")) / 2**20
            save_ply(path("urban_10k.ply"), scene10)
            for name, n_obj, wall in (
                    ("scene_1m.yaml", scene5.n_objects, WALL),
                    ("scene_10k.yaml", scene10.n_objects, WALL),
                    ("start_10k.yaml", scene10.n_objects,
                     dict(WALL, ambient=0.6, diffuse=0.3, specular=1000.0))):
                save_scene_config(path(name), Materials.from_list([AIR, wall]),
                                  np.ones(n_obj, np.int32), material_id_air=0)
            save_preset(path("kaist.yaml"), cfg, beam_width_deg=10.0)
            save_preset(path("kaist_motion.yaml"),
                        cfg.replace(include_motion=True), beam_width_deg=10.0)
            Trajectory.circular(radius=5.0, n=CLI_FRAMES, period=4.0,
                                z=2.0).save_tum(path("traj.txt"))
            traj = Trajectory.load_tum(path("traj.txt"))
            common = ["--mesh", path("urban_1m.ply"), "--scene-config",
                      path("scene_1m.yaml"), "--traj", path("traj.txt"),
                      "--seed", CLI_SEED, "--device", "cuda"]
            kaist = ["--preset", path("kaist.yaml")]

            # ---- 8a. PLY load, prime-cache (cold) vs the warm start, info
            t0 = time.perf_counter()
            loaded = load_mesh(path("urban_1m.ply"))
            info["ply_load_s"] = time.perf_counter() - t0
            check(np.array_equal(loaded.verts, scene5.verts)
                  and np.array_equal(loaded.obj_ids, scene5.obj_ids),
                  "the PLY does not read back to phase 5's scene")
            out, info["prime_cache_s"] = cli(["prime-cache", "--mesh",
                                              path("urban_1m.ply")])
            match(r"primed \d+ triangles", out)
            t0 = time.perf_counter()
            warm = loaded.host_arrays(cache=True)
            info["warm_start_s"] = time.perf_counter() - t0
            info["cold_build_s_phase5"] = info5["host_build_s"]
            check(hosts_equal(warm, host5),
                  "the warm SceneHost differs from the cold build")
            out, info["info_s"] = cli(["info", "--mesh",
                                       path("urban_1m.ply")])
            n_tri = int(match(r"triangles: (\d+)", out).group(1))
            n_chunk, cs = map(int, match(r"chunks:\s+(\d+) x (\d+)",
                                         out).groups())
            check(n_tri == scene5.n_triangles
                  and n_chunk == info5["n_chunks"]
                  and n_chunk * cs == info5["n_triangles"],
                  f"info: {n_tri} triangles, {n_chunk} x {cs} chunks")
            show("8a cache", info, *info)

            # ---- 8b. synced batch replay, .npy and .png
            sim = ["simulate", *common, *kaist, "--batch", BATCH,
                   "--synced", "--frames", CLI_FRAMES]
            wrappers = zero_counts()
            out, info["simulate_npy_s"] = cli(
                sim + ["--format", "npy", "--out", path("sim_npy")])
            launches = read_counts(wrappers)
            check(all(launches[k] > 0 for k in K_1M)
                  and launches["prep_flat"] == 0,
                  f"simulate launches {launches}")
            line = match(rf"{CLI_FRAMES} frames \(batched x{BATCH}\) in "
                         r"([\d.]+) s -> ([\d.]+) Hz", out)
            info.update(simulate_launches=launches,
                        cli_npy_line=line.group(0),
                        cli_npy_frames_per_s=float(line.group(2)))
            got = np.stack([np.load(path(f"sim_npy/frame_{i:05d}.npy"))
                            for i in range(CLI_FRAMES)])
            st, params = kaist_tensors(host5, scene5.n_objects, dev)
            gen = torch.Generator(dev).manual_seed(CLI_SEED)
            with torch.no_grad():
                want = np.concatenate([P.simulate_frames(
                    st, params, cfg, torch.from_numpy(traj.poses_at(
                        traj.stamps[b:b + BATCH])), generator=gen)
                    .image_u8.cpu().numpy()
                    for b in range(0, CLI_FRAMES, BATCH)])
            check(got.shape == (CLI_FRAMES, cfg.n_cells, cfg.n_angles)
                  and np.array_equal(got, want),
                  "CLI frames differ from the in-process simulate_frames")
            info["nonzero_column_share"] = (got > 0).any(axis=1).mean(
                axis=1).tolist()
            check(min(info["nonzero_column_share"]) > 0.5, "trivial frames")
            out, info["simulate_png_s"] = cli(
                sim + ["--format", "png", "--out", path("sim_png")])
            info["cli_png_frames_per_s"] = float(match(
                r"frames \(batched x\d+\) in [\d.]+ s -> ([\d.]+) Hz",
                out).group(1))
            check(np.array_equal(read_png_gray(path(
                "sim_png/frame_00000.png")), got[0]),
                "the PNG frame differs from the .npy")
            show("8b simulate", info, "simulate_npy_s", "cli_npy_line",
                 "cli_npy_frames_per_s", "simulate_png_s",
                 "cli_png_frames_per_s", "simulate_launches")

            # ---- 8c. include_motion: per-azimuth poses
            wrappers = zero_counts()
            out, info["motion_s"] = cli(
                ["simulate", *common, "--preset", path("kaist_motion.yaml"),
                 "--synced", "--frames", 2, "--format", "npy", "--out",
                 path("motion")])
            info["motion_launches"] = read_counts(wrappers)
            check(all(info["motion_launches"][k] > 0 for k in K_1M),
                  f"motion launches {info['motion_launches']}")
            match(r"2 frames in [\d.]+ s", out)
            mframes = [np.load(path(f"motion/frame_{i:05d}.npy"))
                       for i in range(2)]
            check(all(f.shape == (cfg.n_cells, cfg.n_angles) and f.any()
                      for f in mframes), "motion frames empty or misshapen")
            mcfg = cfg.replace(include_motion=True)
            poses = torch.from_numpy(traj.poses_for_scan(
                traj.stamps[0], 0.25, cfg.n_angles)).to(dev)
            g = torch.Generator(dev).manual_seed(1)
            kw = dict(local_dirs=sample_cone_local(
                g, params.beam_width, cfg.n_samples, cfg.beam_sample_dist,
                cfg.beam_sample_dist_normal_p_in_cone),
                random_begin=torch.randint(0, 1000, (cfg.n_angles,),
                                           generator=g, device=dev))
            with torch.no_grad():
                fk = P.simulate_frame(st, params, mcfg, poses, **kw)
                fp = P.simulate_frame(st, params, mcfg.replace(
                    trace_engine="sweep", draw_method="plain"), poses, **kw)
            info["motion_frame_vs_plain"] = frame_contract(fk, fp)
            del st, fk, fp
            show("8c include_motion", info, "motion_s", "motion_launches",
                 "motion_frame_vs_plain")

            # ---- 8d. rays: a 4-bounce shot and a 360-ray fan
            rays = {}
            for mode, extra in (("single", []), ("fan", ["--all-directions"])):
                for engine in ("kernel", "sweep") + (
                        ("brute",) if mode == "single" else ()):
                    out_json = path(f"rays_{mode}_{engine}.json")
                    wrappers = zero_counts()
                    _, dt = cli(["rays", *common, *kaist, "--bounces", 4,
                                 "--yaw", 0.3, "--engine", engine,
                                 "--compact", "--out", out_json, *extra])
                    rays[mode, engine] = json.loads(open(out_json).read())
                    info[f"rays_{mode}_{engine}_s"] = dt
                    if engine == "kernel":
                        n = read_counts(wrappers)
                        info[f"rays_{mode}_launches"] = n
                        check(n["sweep"] == n["prep_hier"]
                              == n["coarse_words"] == 4 and n["bin"] == 0,
                              f"rays {mode} launches {n}")
                check(rays[mode, "kernel"] == rays[mode, "sweep"],
                      f"rays {mode}: kernel JSON differs from sweep's")
                info[f"rays_{mode}_segments"] = len(
                    rays[mode, "kernel"]["segments"])
            info["rays_single_vs_brute_max_err"] = segments_close(
                rays["single", "kernel"], rays["single", "brute"])
            info["rays_single_equals_brute"] = (
                rays["single", "kernel"] == rays["single", "brute"])
            show("8d rays", info, *(k for k in info if k.startswith("rays_")))

            # ---- 8e. eval against 8b's frames, render, optimize
            with open(path("sim_npy/stamps.txt"), "w") as f:
                f.writelines(f"frame_{i:05d}.npy {float(traj.stamps[i])!r}\n"
                             for i in range(CLI_FRAMES))
            out, info["eval_s"] = cli(
                ["eval", "--real", path("sim_npy"), *common, *kaist,
                 "--metrics", "psnr,ssim",
                 "--out", path("eval.json")])
            report = json.loads(open(path("eval.json")).read())
            check(report["n_frames"] == CLI_FRAMES
                  and report["out_of_traj"] == 0
                  and report["sync_error_s"]["max"] == 0.0
                  and np.isfinite(report["summary"]["psnr"]["mean"]),
                  f"eval report {report['summary']}")
            info["eval_summary"] = report["summary"]
            out, info["render_s"] = cli(
                ["render", "--frame", path("sim_npy/frame_00000.npy"),
                 "--out", path("cart.png"), "--color", "--stats-out",
                 path("stats.json")])
            check(os.path.getsize(path("cart.png")) > 0
                  and "polar_stats" in json.loads(open(path("stats.json"))
                                                  .read()), "render output")
            # optimize on the 10k scene: the target rendered at the true
            # materials, the fit started from another wall
            ten = ["--mesh", path("urban_10k.ply"), "--preset",
                   path("kaist.yaml"), "--traj", path("traj.txt"),
                   "--seed", CLI_SEED, "--device", "cuda"]
            cli(["simulate", *ten, "--scene-config", path("scene_10k.yaml"),
                 "--format", "npy", "--out", path("target")])
            wrappers = zero_counts()
            out, info["optimize_s"] = cli(
                ["optimize", *ten, "--scene-config", path("start_10k.yaml"),
                 "--target", path("target/frame_00000.npy"), "--slots", 1,
                 "--steps", 10, "--checkpoint", path("fit.npz"),
                 "--out-config", path("fit.yaml")])
            info["optimize_launches"] = read_counts(wrappers)
            check(all(info["optimize_launches"][k] > 0
                      for k in ("sweep", "prep_flat", "bin", "bin_bwd"))
                  and info["optimize_launches"]["prep_hier"] == 0,
                  f"optimize launches {info['optimize_launches']}")
            info["optimize_initial_psnr_db"] = float(match(
                r"initial PSNR ([-\d.]+) dB", out).group(1))
            info["optimize_final_psnr_db"] = float(match(
                r"final PSNR ([-\d.]+) dB over 10 evaluations", out).group(1))
            fitted = load_scene_config(path("fit.yaml"))
            check(np.isfinite(info["optimize_final_psnr_db"])
                  and os.path.getsize(path("fit.npz")) > 0
                  and all(bool(torch.isfinite(t).all())
                          for t in fitted.materials)
                  and fitted.materials.n == 2, "optimize outputs")
            info["fitted_wall"] = [float(t[1]) for t in fitted.materials]
            show("8e eval/render/optimize", info, "eval_s", "eval_summary",
                 "render_s", "optimize_s", "optimize_launches",
                 "optimize_initial_psnr_db", "optimize_final_psnr_db",
                 "fitted_wall")
            info["phase_s"] = time.perf_counter() - t_phase
            show("8 cli", info, "phase_s")
        finally:
            if old_cache is None:
                os.environ.pop("RADARAYS_SCENE_CACHE", None)
            else:
                os.environ["RADARAYS_SCENE_CACHE"] = old_cache
    return info


def sweep_bounds(st, o, d, bud, rb: int) -> dict:
    """The bounds of K3, K2 and K1 (bound()) on one sweep_winners call's
    rays, counted as kernels_vs_plain counts them, from the kernels'
    own outputs (no plain version: the unsorted set would take minutes)."""
    import torch

    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    o, d, inv_d, bud, lo, hi, C2 = CT._prep_inputs(st, o, d, bud,
                                                    ray_block=rb, group=1)
    Rp, Cp = o.shape[0], lo.shape[0]
    rbt = next(r for r in (1024, 512, 256, 128) if rb % r == 0)
    slo, shi = CT._coarse_boxes(lo, hi)
    w = CT.coarse_words(slo, shi, o, inv_d, bud, 1000.0, rbt)
    e, t_last = CT.prep_hier(w, lo, hi, o, inv_d, bud, 1000.0, rb, rbt)
    nvisit, order, entry = CT._rank(e[:, :C2])
    bt, _, _ = CT.sweep(nvisit, order, entry, o, d, t_last, st.coef,
                        st.fetch, tc=st.chunk_size, group=1, t_min=0.0)
    kept, seen = lane_kept(lo[:C2], hi[:C2], o, inv_d,
                           torch.clamp_max(bud, 1000.0),
                           torch.minimum(bt, t_last))
    ray_bytes = Rp * (12 + 12 + 4)
    return dict(
        live_lanes=int((bud > 0).sum()),
        coarse_words=bound(Rp * slo.shape[0] * OPS_SLAB,
                           ray_bytes + slo.shape[0] * 24 + w.numel() * 4),
        prep_hier=bound(int(popcount(w).sum()) * CT._SG * rbt * OPS_SLAB,
                        ray_bytes + Cp * 24 + w.numel() * 4
                        + e.numel() * 4 + t_last.numel() * 4),
        sweep=dict(bound(float(kept.sum()) * st.chunk_size * OPS_PAIR,
                         int(seen.sum()) * st.chunk_size * 22 * 4 + ray_bytes
                         + order.numel() * 8 + Rp * (4 + 4 + 64)),
                   chunks_kept_lane_mean=float(kept.float().mean()),
                   ranked_chunks_mean=float(nvisit.float().mean())))


def trace_kernel_ms(fn, reps: int) -> dict:
    """One profile of `reps` calls of fn (a whole trace): the mean device
    time per launch of K1, K2 and K3 (K3 without its memset, which the
    window's other work hides), each launch's in order (under the
    two-phase requeue phase 1, then phase 2) and the launches caught."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {}
    for k in ("sweep", "prep_hier", "coarse_words"):
        mine = [e for e in dev if KERNEL[k] in e.name]
        each = [e.time_range.elapsed_us() / 1e3 for e in mine]
        out[k] = dict(profiled_launches=len(mine),
                      ms=sum(each) / max(len(each), 1), ms_by_launch=each)
    return out


def trace_contract(want, got, idx=None, ties: bool = False) -> dict:
    """tests/test_trace.py:77-83 between two TraceResults (at rows idx of
    got): hit equal, t within 1e-4 on hits, normals within 1e-4, obj_id
    equal — or, with ties, differing on under 2 % of the lanes, each at
    the same distance within 1e-5."""
    import torch

    if idx is not None:
        got = type(got)(*(None if x is None else x[idx] for x in got))
    hit = want.hit
    check(torch.equal(hit, got.hit), "trace contract: hits differ")
    dt = float((want.t[hit] - got.t[hit]).abs().max()) if hit.any() else 0.0
    check(torch.allclose(got.t[hit], want.t[hit], rtol=1e-4, atol=1e-4),
          f"trace contract: t {dt} apart")
    obj = want.obj_id != got.obj_id
    share = float(obj.float().mean())
    check(torch.allclose(got.normal[~obj], want.normal[~obj], atol=1e-4),
          "trace contract: normals differ")
    if ties:
        check(share < 0.02 and torch.allclose(
            got.t[obj], want.t[obj], rtol=1e-5),
              f"obj_id differs on {share:.4%} of the lanes, or off ties")
    else:
        check(not bool(obj.any()), f"trace contract: {int(obj.sum())} obj_id "
              "mismatches")
    return dict(hit_mismatches=0, obj_mismatches=int(obj.sum()),
                obj_mismatch_share=share, max_abs_dt=dt)


SAT_SETS = (("i coherent", "coherent", {}),
            ("ii incoherent", "incoherent", {}),
            ("iii incoherent sorted", "incoherent", {"sort_rays": True}),
            ("iv incoherent sorted two-phase", "incoherent",
             {"sort_rays": True, "two_phase_cap": SAT_CAP}))


def saturated_phase(st, smi: str) -> dict:
    """Phase 9a: the saturated trace (benchmarks/engines.py --saturated)
    on phase 5's scene, engine "kernel", ray block 2048, for each of
    SAT_SETS: Mrays/s (median of 3 traces, CUDA events), hit rate, peak
    device memory, the K1/K2/K3 launches of one trace, the brute oracle on
    a 2048-ray subset, the kernels' bounds on each sweep's rays and (queued
    for phase 10) their device time per launch; then the gates: (iii) and
    (iv) against (ii), and K3/K2/K1 bitwise against their plain versions
    on a 131,072-ray slice of (iii)."""
    import torch

    from radarays_ros_tpu_torch.trace import cuda_trace as CT
    from radarays_ros_tpu_torch.trace.api import trace

    from radarays_ros_tpu_torch.bench import common as BC
    from radarays_ros_tpu_torch.bench.engines import incoherent_rays

    # the ray sets of benchmarks/engines.py:51-68, each from default_rng(0)
    rays = {"coherent": BC.on(st.device, *BC.radar_fan(SAT_RAYS)),
            "incoherent": BC.on(st.device, *incoherent_rays(st, SAT_RAYS))}
    out, res = {}, {}
    for tag, which, kw in SAT_SETS:
        t_set = time.perf_counter()
        o, d = rays[which]
        n = o.shape[0]
        sub = torch.arange(0, n, n // 2048, device=st.device)[:2048]

        def run(o=o, d=d, kw=kw):
            return trace(st, o, d, engine="kernel", ray_block=2048, **kw)

        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls = []
        winners = CT.sweep_winners

        def spy(scene, origs, dirs, budget, **k):
            calls.append((origs, dirs, budget))
            return winners(scene, origs, dirs, budget, **k)

        CT.sweep_winners = spy
        try:
            wrappers = zero_counts()
            r = run()
            torch.cuda.synchronize()
            launches = read_counts(wrappers)
        finally:
            CT.sweep_winners = winners
        peak = torch.cuda.max_memory_allocated()
        ms = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        med = sorted(ms)[1]
        phases = 2 if "two_phase_cap" in kw else 1
        check(all(launches[k] == phases for k in ("sweep", "prep_hier",
                                                   "coarse_words"))
              and launches["prep_flat"] == 0,
              f"{tag}: launches {launches}")
        brute = trace(st, o[sub], d[sub], engine="brute")
        row = dict(
            rays=int(o.shape[0]), options=kw, ms=med, ms_runs=ms,
            mrays_per_s=o.shape[0] / med / 1e3,
            hit_rate=float(r.hit.float().mean()),
            peak_mib=peak / 2**20, peak_over_resident_mib=(peak - resident)
            / 2**20, launches={k: launches[k] for k in (
                "sweep", "prep_hier", "coarse_words")},
            vs_brute_2048=trace_contract(brute, r, sub, ties=True),
            bounds_by_sweep=[sweep_bounds(st, *c, rb=2048) for c in calls],
            gpu=smi)
        # a launch's bound, averaged over the trace's sweeps (two under
        # the two-phase requeue)
        row["bound_per_launch"] = {k: bound(
            sum(b[k]["ops"] for b in row["bounds_by_sweep"]) / len(calls),
            sum(b[k]["bytes"] for b in row["bounds_by_sweep"]) / len(calls))
            for k in ("sweep", "prep_hier", "coarse_words")}
        row["live_lanes_by_sweep"] = [b["live_lanes"]
                                      for b in row["bounds_by_sweep"]]
        res[tag] = r
        out[tag] = row
        row["set_s"] = time.perf_counter() - t_set
        log(f"[9a saturated {tag}] " + json.dumps(
            {k: v for k, v in row.items() if k != "bounds_by_sweep"}))
        # the unsorted set's trace takes seconds: one profiled trace
        reps = 1 if which == "incoherent" and not kw else 2
        DEFERRED.append(lambda row=row, run=run, reps=reps:
                        row.update(kernel_ms=trace_kernel_ms(run, reps)))
    ref = res["ii incoherent"]
    for tag in ("iii incoherent sorted", "iv incoherent sorted two-phase"):
        got = res[tag]
        check(torch.equal(ref.hit, got.hit), f"{tag}: hits differ from (ii)")
        check(torch.allclose(got.t[ref.hit], ref.t[ref.hit], rtol=1e-5),
              f"{tag}: t differs from (ii)")
        out[tag]["vs_ii"] = trace_contract(ref, got, ties=True)
        out[tag]["bitwise_vs_ii"] = all(
            torch.equal(a, b) for a, b in zip(ref[:4], got[:4]))
        log(f"[9a {tag} vs ii] {json.dumps(out[tag]['vs_ii'])}")
    # the kernels against their plain versions on a slice of (iii)
    t_slice = time.perf_counter()
    o, d = rays["incoherent"]
    perm = torch.sort(CT._ray_sort_key(o, d), stable=True).indices[:GATE_RAYS]
    bud = torch.full((GATE_RAYS,), 1000.0, device=st.device)
    out["kernels_sorted_slice"] = mk = kernels_vs_plain(
        st, o[perm].contiguous(), d[perm].contiguous(), bud, rb=2048, reps=5)
    out["kernels_sorted_slice_s"] = time.perf_counter() - t_slice
    log(f"[9a kernels vs plain, {GATE_RAYS} rays of (iii)] " + json.dumps(
        {k: {kk: v[kk] for kk in ("bitwise", "max_abs_err", "plain_ms",
                                  "bound_ms", "bound_by")}
         for k, v in mk.items()}))
    return out


def batches_per_s(st, params, cfg, reps: int = 3) -> float:
    """Frames/s of `reps` KAIST batches after a warm-up batch (CUDA
    events), the draws from one generator seeded 0."""
    import torch

    from radarays_ros_tpu_torch.sim import pipeline as P

    poses = batch_poses()
    gen = torch.Generator(st.device).manual_seed(0)
    with torch.no_grad():
        ms = cuda_ms(lambda: P.simulate_frames(st, params, cfg, poses,
                                               generator=gen), reps)
    return BATCH / (ms / 1e3)


def frame_pair(st, params, cfg, other, seed: int = 1) -> dict:
    """One KAIST frame under cfg and under `other` on the same explicit
    draws: the frame contract of the second against the first."""
    import torch

    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.wave.cone import sample_cone_local

    g = torch.Generator(st.device).manual_seed(seed)
    kw = dict(local_dirs=sample_cone_local(
        g, params.beam_width, cfg.n_samples, cfg.beam_sample_dist,
        cfg.beam_sample_dist_normal_p_in_cone),
        random_begin=torch.randint(0, 1000, (cfg.n_angles,), generator=g,
                                   device=st.device))
    pose = batch_poses()[0]
    with torch.no_grad():
        want = P.simulate_frame(st, params, cfg, pose, **kw)
        got = P.simulate_frame(st, params, other, pose, **kw)
    return frame_contract(got, want)


def two_phase_frames(st, params, cfg, smi: str) -> dict:
    """Phase 9b: the KAIST batch at ~1M triangles with trace_two_phase_cap
    SAT_CAP against single phase: one frame under the frame contract (and
    whether it is bit-identical), the launches of one batch (K1-K3 twice a
    bounce), and frames/s of both in turns (single, two-phase, two-phase,
    single)."""
    import torch

    from radarays_ros_tpu_torch.sim import pipeline as P

    cfg2 = cfg.replace(trace_two_phase_cap=SAT_CAP)
    out = dict(cap_m=SAT_CAP, frame_vs_single=frame_pair(st, params, cfg,
                                                         cfg2))
    wrappers = zero_counts()
    with torch.no_grad():
        P.simulate_frames(st, params, cfg2, batch_poses(),
                          generator=torch.Generator(st.device).manual_seed(0))
    torch.cuda.synchronize()
    out["launches_per_batch"] = launches = read_counts(wrappers)
    check(all(launches[k] == 2 * cfg.n_reflections
              for k in ("sweep", "prep_hier", "coarse_words")),
          f"two-phase launches {launches}")
    runs = [("single", cfg), ("two_phase", cfg2), ("two_phase", cfg2),
            ("single", cfg)]
    fps = [(name, batches_per_s(st, params, c)) for name, c in runs]
    out.update(frames_per_s_in_turns=fps, gpu=smi)
    log(f"[9b two-phase frames] {json.dumps(out)}")
    return out


def mxu_phase(gate, o, d, brute, dev, smi: str) -> dict:
    """Phase 9c: the "mxu" engine — against the brute oracle on the trace
    gate's 4096 rays (0 hit and 0 object mismatches), then a KAIST batch on
    the 10k companion: one frame under the frame contract of the kernel
    frame, ms per bounce (CUDA events, each bounce's rays and budgets), the
    peak memory of one bounce's trace, frames/s, and the TF32 switches."""
    import torch

    from radarays_ros_tpu_torch.geom.scene import with_planes
    from radarays_ros_tpu_torch.trace.api import trace

    tf32 = dict(matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                matmul_precision=torch.get_float32_matmul_precision())
    check(not tf32["matmul_allow_tf32"]
          and tf32["matmul_precision"] == "highest", f"TF32 on: {tf32}")
    rm = trace(with_planes(gate), o, d, engine="mxu")
    out = dict(tf32, gate_rays=int(o.shape[0]),
               gate_vs_brute=trace_contract(brute, rm))
    _, st, params, cfg, info, _ = kaist_setup(dev, n_buildings=800)
    st = with_planes(st)
    mcfg = cfg.replace(trace_engine="mxu")
    out.update(n_triangles=info["n_triangles"], tri_chunk=cfg.trace_tri_chunk,
               frame_vs_kernel=frame_pair(st, params, cfg, mcfg))
    gen = torch.Generator(dev).manual_seed(0)
    waves0, sensor_pos, _ = batch_waves(params, cfg, batch_poses(), gen, dev)
    ms, peak = [], []
    for _, _, o_b, d_b, bud in bounce_rays(st, params, mcfg, waves0,
                                           sensor_pos):
        def run(o_b=o_b, d_b=d_b, bud=bud):
            return trace(st, o_b, d_b, engine="mxu", t_budget=bud,
                         ray_block=cfg.trace_ray_block,
                         tri_chunk=cfg.trace_tri_chunk)

        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak.append((torch.cuda.max_memory_allocated() - resident) / 2**20)
        ms.append(cuda_ms(run, 3))
    out.update(rays_per_bounce=int(waves0.valid.numel()), ms_by_bounce=ms,
               ms_per_bounce=sum(ms) / len(ms), peak_over_resident_mib=peak,
               frames_per_s=batches_per_s(st, params, mcfg),
               kernel_frames_per_s=batches_per_s(st, params, cfg), gpu=smi)
    log(f"[9c mxu] {json.dumps(out)}")
    return out


def fresnel_spread(v1: float, v2: float) -> dict:
    """How far fresnel_curve(v1, v2)'s outputs move on the CPU when its
    incidence directions move by one or two f32 ulps in x or z: the
    reference's angle form is ill-conditioned near normal incidence
    (acos near 1) and near the critical angle (the refraction root near
    0), where the card's and the CPU's transcendentals, each within a few
    ulps, may land that far apart. Per point, for each output."""
    import numpy as np
    import torch

    from radarays_ros_tpu_torch.wave.fresnel import fresnel_split

    n_pts = 181
    angles = np.linspace(0.0, np.pi / 2.0 - 1e-3, n_pts).astype(np.float32)
    d0 = np.stack([np.sin(angles), np.zeros_like(angles), -np.cos(angles)],
                  -1)

    def outputs(d):
        full = [torch.full((n_pts,), x) for x in (1.0, 0.5, v1, v2)]
        res = fresnel_split(torch.tensor([0.0, 0.0, 1.0]).expand(n_pts, 3),
                            torch.from_numpy(d), *full)
        refr = res.refraction_dir.numpy()
        return {"reflectance": res.reflection_energy.numpy(),
                "transmittance": res.refraction_energy.numpy(),
                "refraction_angle_deg": np.degrees(np.arctan2(
                    np.abs(refr[:, 0]), np.maximum(-refr[:, 2], 1e-12)))}

    base = outputs(d0)
    spread = {k: np.zeros(n_pts) for k in base}
    for ax in (0, 2):
        for way in (np.float32(np.inf), np.float32(-np.inf)):
            d = d0.copy()
            for _ in range(2):
                d[:, ax] = np.nextafter(d[:, ax], way)
                for k, v in outputs(d).items():
                    dv = np.abs(v - base[k])
                    spread[k] = np.maximum(spread[k], np.where(
                        np.isfinite(dv), dv, 0.0))
    return spread


def explorer_phase(dev) -> dict:
    """Phase 9d: each explorer panel's data on the card against the same
    call on the CPU: brdf and slab within rtol and atol 1e-6, the slab
    tree's structure equal; fresnel within the same plus, at each point,
    the CPU's own move under a one- or two-ulp change of the incidence
    direction (fresnel_spread), the points beyond 1e-6 counted; beams by
    the reference's statistics (tests/test_viz.py:74-89; the card's draws
    are its own); and `cli explore --panel fresnel --json` on the card."""
    import tempfile

    import numpy as np

    from radarays_ros_tpu_torch.viz.beams import beam_panel
    from radarays_ros_tpu_torch.viz.brdf import brdf_curve, fresnel_curve
    from radarays_ros_tpu_torch.viz.reflections import propagate_slab_rays

    def close(a, b, what, slack=0.0):
        a, b = np.asarray(a, float), np.asarray(b, float)
        lim = 1e-6 + 1e-6 * np.abs(b) + slack
        check(a.shape == b.shape and bool(np.all(
            (np.abs(a - b) <= lim) | (np.isnan(a) & np.isnan(b)))),
              f"explore {what}: card and CPU differ (largest difference "
              f"{np.nanmax(np.abs(a - b)) if a.shape == b.shape else None})")
        ok = np.isfinite(a) & np.isfinite(b)
        return float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0

    err, beyond = {}, {}
    brdf = [brdf_curve(1.0, 0.2, 30.0, device=dv) for dv in (dev, "cpu")]
    err["brdf"] = close(brdf[0]["energy"], brdf[1]["energy"], "brdf")
    for name, v in (("fresnel_in", (0.3, 0.15)), ("fresnel_out",
                                                  (0.15, 0.3))):
        card, cpu = fresnel_curve(*v, device=dev), fresnel_curve(*v,
                                                                 device="cpu")
        check(card["total_internal_reflection"]
              == cpu["total_internal_reflection"], f"{name}: TIR")
        slack = fresnel_spread(*v)
        err[name] = max(close(card[k], cpu[k], f"{name} {k}", slack[k])
                        for k in slack)
        beyond[name] = {k: int(np.sum(np.abs(np.asarray(card[k], float)
                                             - np.asarray(cpu[k], float))
                                      > 1e-6)) for k in slack}
    card = propagate_slab_rays([0.0, -0.2], [0.3, 0.15, 0.3], device=dev)
    cpu = propagate_slab_rays([0.0, -0.2], [0.3, 0.15, 0.3], device="cpu")
    for k in ("segments", "leaks"):
        check(len(card[k]) == len(cpu[k]) > 0
              and all(a["medium"] == b["medium"]
                      for a, b in zip(card[k], cpu[k])), f"slab {k}")
    err["slab"] = max(close([s[f] for s in card[k]], [s[f] for s in cpu[k]],
                            f"slab {k} {f}")
                      for k, fs in (("segments", ("p0", "p1", "energy")),
                                    ("leaks", ("p0", "dir", "energy")))
                      for f in fs)
    panel = beam_panel(width_deg=8.0, n_samples=4000, p_in_cone=0.8, seed=1,
                       device=dev)
    fr = {k: v["frac_in_cone"] for k, v in panel.items()}
    h1 = np.asarray(panel["D1_uniform_radius"]["r_hist"], float)
    h2 = np.asarray(panel["D2_uniform_disk"]["r_hist"], float)
    check(fr["D1_uniform_radius"] == 1.0 and fr["D2_uniform_disk"] == 1.0
          and abs(fr["D3_normal"] - 0.8) <= 0.03
          and h2[-8:].sum() / h2.sum() > h1[-8:].sum() / h1.sum(),
          f"beam statistics {fr}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fresnel.json")
        cli(["explore", "--panel", "fresnel", "--v1", 0.3, "--v2", 0.15,
             "--json", path, "--device", "cuda"])
        data = json.loads(open(path).read())
    want = fresnel_curve(0.3, 0.15, device=dev)
    check(json.dumps(data) == json.dumps(want),
          "cli explore --json differs from the in-process data")
    out = dict(max_abs_diff_card_vs_cpu=err,
               fresnel_points_beyond_1e6=beyond, beams_frac_in_cone=fr,
               cli_explore_fresnel_json=True)
    log(f"[9d explore] {json.dumps(out)}")
    return out


HUGE_BUILDINGS = 830000   # bench.py:324, the huge_10m scale companion
HUGE_EXTENT = 950.0
HUGE_GATE_RAYS = 2048     # rays of the fan held against brute at 10M


def peak_rss_gib() -> float:
    """The process's peak resident set so far (ru_maxrss, KiB on Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def hosts_equal(a, b) -> bool:
    """Two SceneHost builds bit for bit (dtypes and every array's bytes)."""
    import numpy as np

    return all(x == y if name == "chunk_size" else
               (np.asarray(x).dtype == np.asarray(y).dtype
                and np.asarray(x).shape == np.asarray(y).shape
                and np.asarray(x).tobytes() == np.asarray(y).tobytes())
               for name, x, y in zip(a._fields, a, b))


def native_vs_numpy(scene, host) -> dict:
    """12b: the host build of `scene` (phase 5's 1M scene, whose build by
    the library is `host`) by the library and by NumPy (RADARAYS_NO_NATIVE
    =1), stage by stage, and the device tables of both: every array bit
    for bit."""
    import numpy as np

    from radarays_ros_tpu_torch.geom.scene import device_tables

    out, builds, tables = {}, {}, {}
    old = os.environ.get("RADARAYS_NO_NATIVE")
    try:
        for name, flag in (("native", "0"), ("numpy", "1")):
            os.environ["RADARAYS_NO_NATIVE"] = flag
            stages = {}
            t0 = time.perf_counter()
            builds[name] = scene._build_host(stages)
            stages["build_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tables[name] = device_tables(builds[name])
            stages["tables_s"] = time.perf_counter() - t0
            out[name] = stages
    finally:
        if old is None:
            os.environ.pop("RADARAYS_NO_NATIVE", None)
        else:
            os.environ["RADARAYS_NO_NATIVE"] = old
    out["host_bitwise"] = hosts_equal(builds["native"], builds["numpy"])
    out["host_bitwise_phase5"] = hosts_equal(builds["native"], host)
    out["tables_bitwise"] = all(
        a.tobytes() == b.tobytes() and a.dtype == b.dtype == np.float32
        for a, b in zip(tables["native"], tables["numpy"]))
    out["speedup"] = out["numpy"]["build_s"] / out["native"]["build_s"]
    log(f"[12b native vs numpy, 1M] {json.dumps(out)}")
    check(out["host_bitwise"] and out["host_bitwise_phase5"]
          and out["tables_bitwise"],
          "the library's build differs from the NumPy build")
    return out


def huge_phase(dev, smi: str, scene5, host5, cache_dir: str) -> tuple:
    """Phase 12, bench.py's huge_10m scale (make_urban_scene(830000, 950,
    seed=7), the KAIST preset, prep group auto = 4): a. the cold start
    through the CLI (the scene as a binary PLY, prime-cache into the
    run's cache cache_dir, where phase 13's headline twin finds it; again:
    already primed; the warm load bit-equal to the cold build), the host's
    peak RSS; b. native_vs_numpy on phase 5's 1M scene; c. frames_phase
    at 10M, with the resident scene and peak device MiB; d. kernel
    against brute on 2,048 rays of the fan; e. the bounce-1 rays of c at
    prep group 1 against the auto group 4 (hits and objects equal; K1-K3
    against their plain versions, their times queued). Returns (details,
    (the scene tensors, params, cfg), c's launches, its trace kernels by
    bounce, its K5 rows, e's kernels by group)."""
    import tempfile

    import numpy as np
    import torch

    from radarays_ros_tpu_torch.geom.mesh import load_mesh, save_ply
    from radarays_ros_tpu_torch.trace import cuda_trace as CT
    from radarays_ros_tpu_torch.trace.api import trace

    t_phase = time.perf_counter()
    info = dict(gpu=smi, rss_gib_before=peak_rss_gib())
    scene, st, params, cfg, setup, host = kaist_setup(
        dev, n_buildings=HUGE_BUILDINGS, extent=HUGE_EXTENT)
    info.update(setup=setup, rss_gib_after_setup=peak_rss_gib())
    log(f"[12 scene] {json.dumps(setup)}")
    check(CT._auto_prep_group(st.n_chunks) == 4,
          f"{st.n_chunks} chunks: auto prep group is not 4")

    # ---- 12a. the cold start through the command line
    old_cache = os.environ.get("RADARAYS_SCENE_CACHE")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_10m_") as tmp:
        os.environ["RADARAYS_SCENE_CACHE"] = cache_dir
        try:
            ply = os.path.join(tmp, "urban_10m.ply")
            t0 = time.perf_counter()
            save_ply(ply, scene)
            a = dict(ply_write_s=time.perf_counter() - t0,
                     ply_gib=os.path.getsize(ply) / 2**30)
            out, a["prime_cache_s"] = cli(["prime-cache", "--mesh", ply])
            m = match(r"primed (\d+) triangles \((\d+) chunks\) in "
                      r"([\d.]+)s -> (\S+) \(([\d.]+) GB\)", out)
            a["cache_gb"] = float(m.group(5))
            check(int(m.group(1)) == scene.n_triangles
                  and int(m.group(2)) == st.n_chunks, out)
            m = match(r"builder (\w+) \((\w+)\): ordering ([\d.]+) s, planes"
                      r" and AABBs ([\d.]+) s, coef and fetch tables "
                      r"([\d.]+) s, store ([\d.]+) s", out)
            check(m.group(1) == "native", f"prime-cache ran {m.group(1)}")
            a.update(builder=m.group(1), variant=m.group(2),
                     order_s=float(m.group(3)), planes_s=float(m.group(4)),
                     tables_s=float(m.group(5)), store_s=float(m.group(6)))
            a["rss_gib_after_prime"] = peak_rss_gib()
            out, a["prime_again_s"] = cli(["prime-cache", "--mesh", ply])
            match(r"already primed", out)
            t0 = time.perf_counter()
            loaded = load_mesh(ply)
            a["ply_load_s"] = time.perf_counter() - t0
            check(np.array_equal(loaded.verts, scene.verts)
                  and np.array_equal(loaded.obj_ids, scene.obj_ids),
                  "the 10M PLY does not read back to the scene")
            t0 = time.perf_counter()
            warm = loaded.host_arrays(cache=True)
            a["warm_start_s"] = time.perf_counter() - t0
            a["warm_bitwise_cold"] = hosts_equal(warm, host)
            check(a["warm_bitwise_cold"],
                  "the warm 10M build differs from the cold build")
            del loaded, warm
        finally:
            if old_cache is None:
                os.environ.pop("RADARAYS_SCENE_CACHE", None)
            else:
                os.environ["RADARAYS_SCENE_CACHE"] = old_cache
    a["rss_gib_peak"] = peak_rss_gib()
    info["cold_start"] = a
    log(f"[12a cold start, 10M] {json.dumps(a)}")
    del scene, host

    # ---- 12b. the library against NumPy at 1M
    info["native_vs_numpy_1m"] = native_vs_numpy(scene5, host5)

    # ---- 12c. frames at 10M
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frames, launches, bb, k5, fvp = frames_phase(
        "12", st, params, cfg, dev, expect_zero=("prep_flat", "bin_bwd"))
    frames.update(scene_mib=scene_mib(st),
                  peak_mib=torch.cuda.max_memory_allocated() / 2**20,
                  prep_group=CT._auto_prep_group(st.n_chunks))
    info.update(frames=frames, frame_vs_plain=fvp)
    log(f"[12c memory] scene {frames['scene_mib']:.1f} MiB, peak "
        f"{frames['peak_mib']:.1f} MiB")

    # ---- 12d. the trace gate at 10M: kernel against brute
    o, d = fan(GATE_RAYS, dev)
    rk = trace(st, o, d, engine="kernel")
    sub = torch.arange(0, o.shape[0], o.shape[0] // HUGE_GATE_RAYS,
                       device=dev)[:HUGE_GATE_RAYS]
    t0 = time.perf_counter()
    rb_ = trace(st, o[sub], d[sub], engine="brute")
    torch.cuda.synchronize()
    hit_b = rb_.hit
    gate = dict(rays=int(sub.numel()), brute_s=time.perf_counter() - t0,
                hit_rate=float(hit_b.float().mean()),
                hit_mismatches=int((rk.hit[sub] != hit_b).sum()),
                obj_mismatches=int((rk.obj_id[sub] != rb_.obj_id).sum()),
                max_abs_dt=float((rk.t[sub][hit_b] - rb_.t[hit_b]).abs()
                                 .max()) if hit_b.any() else 0.0,
                max_abs_dn=float((rk.normal[sub] - rb_.normal).abs().max()))
    gate["contract"] = bool(
        gate["hit_mismatches"] == 0 and gate["obj_mismatches"] == 0
        and torch.allclose(rk.t[sub][hit_b], rb_.t[hit_b], rtol=1e-4,
                           atol=1e-4)
        and torch.allclose(rk.normal[sub], rb_.normal, atol=1e-4))
    info["trace_gate"] = gate
    log(f"[12d trace gate, 10M] {json.dumps(gate)}")
    check(gate["contract"] and gate["hit_rate"] > 0.5,
          "the 10M trace misses the brute contract")
    del rk, rb_, o, d

    # ---- 12e. prep group 1 against the auto group 4 on bounce 1's rays
    gen = torch.Generator(dev).manual_seed(0)
    waves0, sensor_pos, _ = batch_waves(params, cfg, batch_poses(), gen, dev)
    _, _, o, d, budget = next(bounce_rays(st, params, cfg, waves0,
                                          sensor_pos))
    res = {g: trace(st, o, d, engine="kernel", t_budget=budget,
                    prep_group=g, ray_block=cfg.trace_ray_block)
           for g in (1, 4)}
    groups = {g: kernels_vs_plain(st, o, d, budget, rb=cfg.trace_ray_block,
                                  reps=10, group=g) for g in (1, 4)}
    e = dict(rays=int(o.shape[0]),
             hit_equal=bool(torch.equal(res[1].hit, res[4].hit)),
             obj_equal=bool(torch.equal(res[1].obj_id, res[4].obj_id)),
             t_bitwise=bool(torch.equal(res[1].t, res[4].t)),
             hit_rate=float(res[4].hit.float().mean()))
    for g, rows in groups.items():
        e[f"group_{g}"] = {k: {kk: v[kk] for kk in (
            "bitwise", "plain_ms", "bound_ms", "bound_by")} for k, v in
            rows.items()}
    info["groups_1_vs_4"] = e
    log(f"[12e prep group 1 vs 4, bounce 1] {json.dumps(e)}")
    check(e["hit_equal"] and e["obj_equal"],
          "prep group 1 and 4 trace different hits")
    del res, waves0
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"[12 phase] {info['phase_s']:.1f} s")
    return info, (st, params, cfg), launches, bb, k5, groups


RANKS = 4            # phase 11's ranks, all on the one card
LAYOUT_REPS = 5      # timed frames per layout in phase 11
COMBINE_REPS = 10    # timed combines per scene layout
FIT_LR = 1e-3        # the training step's SGD rate (the reference default)
# phase 11's sub-phases: (tag, layout, config overrides), the layouts that
# hold the whole scene first, so that the scene layouts' peaks hold only
# their shards
SUBPHASES = (("a", "az", {}), ("c", "az_smp", {}),
             ("c max", "az_smp", dict(signal_denoising=0, scroll_image=3)),
             ("b", "scene", {}), ("d", "az_scene", {}))
SUBPHASE_NAMES = {"a": "azimuth x 4", "b": "scene x 4",
                  "c": "azimuth x sample 2 x 2",
                  "c max": "azimuth x sample 2 x 2, MAX, scroll 3",
                  "d": "azimuth x scene 2 x 2"}
SHARING = "4 ranks sharing one card, not scaling"


def scene_mib(st) -> float:
    """Device MiB of a SceneTensors' tensors."""
    import torch

    return sum(t.numel() * t.element_size() for t in st
               if isinstance(t, torch.Tensor)) / 2**20


def k5_bitwise(cell, s, cfg) -> bool:
    """K5 on a wedge's signals (bin_inputs: invalid ones at cell n_cells)
    against its plain version, bit for bit, in the config's combine."""
    import torch

    from radarays_ros_tpu_torch.image.cuda_draw import _bin_plain, bin_signals

    w, mode = cfg.denoiser()
    if w is None:
        s = torch.where(cell < cfg.n_cells, s, -torch.inf).contiguous()
        kw = dict(n_cells=cfg.n_cells, combine="max")
    else:
        kw = dict(n_cells=cfg.n_cells, combine="sum",
                  weights=tuple(float(x) for x in w), w_mode=mode)
    got, want = bin_signals(cell, s, **kw), _bin_plain(cell, s, **kw)
    bits = torch.equal(got.view(torch.int32), want.view(torch.int32))
    check(bits, f"K5 ({kw['combine']}) on a rank's signals: not bitwise")
    return bits


def rank_wedge(cfg, mesh):
    """This rank's azimuth rows and cone samples in a layout's mesh."""
    A, S = cfg.n_angles, cfg.n_samples
    rows, samples = slice(0, A), slice(0, S)
    if "az" in mesh.shape:
        n, i = mesh.shape["az"], mesh.coords["az"]
        rows = slice(i * A // n, (i + 1) * A // n)
    if "smp" in mesh.shape:
        n, i = mesh.shape["smp"], mesh.coords["smp"]
        samples = slice(i * S // n, (i + 1) * S // n)
    return rows, samples


def ranks_ms(fn, reps: int) -> float:
    """cuda_ms(fn, reps) with every rank starting after a barrier (fn's
    collectives keep the ranks in step)."""
    import torch.distributed as dist

    dist.barrier()
    return cuda_ms(fn, reps)


def ranks_host_ms(fn, reps: int) -> float:
    """Mean wall ms of fn() over `reps` calls after one warm-up, every rank
    starting after a barrier; the card is synchronized at both ends (for
    collectives of host tensors, which CUDA events do not time)."""
    import torch
    import torch.distributed as dist

    fn()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def layouts_rank_chip(rank: int, world: int, device, cache_dir: str,
                      key: str, n_objects: int, cfg, pose, inputs,
                      fit_target) -> dict:
    """Phase 11 in one rank (a run_ranks worker): the phase-5 scene from
    the cache the parent wrote, every layout of SUBPHASES driven with the
    launch counts zeroed just before and read just after, timed over
    LAYOUT_REPS frames, peak memory, and on this rank's own inputs the
    trace kernels of bounce 1 and K5 against their plain versions; in the
    scene layouts the combine's time, and in "b" the combined traces of the
    gate fan and of bounce 1; then the training step on the fit's setup.
    Returns rank 0's frames and traces and every rank's figures."""
    import contextlib
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from radarays_ros_tpu_torch.geom.cache import load_scene_host
    from radarays_ros_tpu_torch.parallel import sharding as SH
    from radarays_ros_tpu_torch.parallel.dryrun import LAYOUTS, baked
    from radarays_ros_tpu_torch.parallel.groups import scene_axis
    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.trace.api import combine_trace_shards, trace
    from radarays_ros_tpu_torch.wave.cone import cone_local

    def numpy(res):
        return tuple(None if x is None else x.cpu().numpy() for x in res)

    t0 = time.perf_counter()
    host = load_scene_host(key, cache_dir=Path(cache_dir))
    check(host is not None, "a rank found no host build in the cache")
    st, params = kaist_tensors(host, n_objects, device)
    mine = dict(rank=rank, device=str(device), load_upload_s=time.perf_counter()
                - t0, whole_scene_mib=scene_mib(st))
    out = {}
    pose = torch.as_tensor(pose, device=device)
    draws = tuple(torch.as_tensor(x, device=device)
                  for x in inputs["cone_draws"])
    local = cone_local(*draws, params.beam_width, cfg.beam_sample_dist,
                       cfg.beam_sample_dist_normal_p_in_cone)
    rb = cfg.trace_ray_block
    for tag, layout, overrides in SUBPHASES:
        fn, make, sharded = LAYOUTS[layout]
        c = cfg.replace(**overrides)
        mesh = make()
        if sharded and st is not None:
            del st                      # the scene layouts hold shards only
            st = None
            torch.cuda.empty_cache()
        scene = (baked(SH.scene_shard(host, mesh, device), params, c)
                 if sharded else st)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)

        def run():
            return fn(scene, params, c, pose, mesh, device=device, **inputs)

        wrappers = zero_counts()
        res = run()
        torch.cuda.synchronize()
        row = dict(launches=read_counts(wrappers),
                   resident_scene_mib=scene_mib(scene))
        if rank == 0:
            out[tag] = numpy(res)
        del res
        row["ms_per_frame"] = ranks_ms(run, LAYOUT_REPS)
        row["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
        # this rank's inputs: its wedge's bounce-1 rays and its signals
        rows, samples = rank_wedge(c, mesh)
        if tag == "a":
            # the frame apart: the wedge's render alone (no collective in
            # this layout), and the assembly's all-reduce alone on the
            # card's tensors (gloo stages them through the host) and on
            # host tensors of the same shapes
            a0, A_loc = rows.start, rows.stop - rows.start
            rbeg = torch.as_tensor(inputs["random_begin"], device=device)
            row["wedge_ms"] = ranks_ms(lambda: SH._wedge_frame(
                scene, params, c, c, pose, local, a0, A_loc, 0,
                c.n_samples, rbeg, None), LAYOUT_REPS)
            for key, on in (("assemble_ms", device), ("assemble_host_ms",
                                                      "cpu")):
                wedge = (torch.zeros((A_loc, c.n_cells), dtype=torch.uint8,
                                     device=on),
                         torch.zeros((A_loc, c.n_cells), device=on),
                         torch.zeros((A_loc,), device=on))
                row[key] = ranks_host_ms(lambda: SH._assemble(
                    c, a0, *wedge, mesh.groups["az"]), LAYOUT_REPS)
        waves, sp = SH.wedge_waves(params, c, pose, local, rows, samples,
                                   device)
        o, d, bud = (ray_major(x) for x in (waves.orig, waves.dir,
                                            P.trace_budget(c, waves)))
        axis = "scene" if "scene" in mesh.shape else None
        ctx = (scene_axis(axis, mesh.groups[axis]) if axis
               else contextlib.nullcontext())
        with ctx, torch.no_grad():
            cell, s = bin_inputs(scene, params, c.replace(
                trace_scene_axis=axis), waves, sp)
        row["kernels_bitwise"] = dict(
            {k: v["bitwise"] for k, v in kernels_vs_plain(
                scene, o, d, bud, rb, reps=1).items()},
            bin=k5_bitwise(cell, s, c))
        row.update(rays_bounce1=int(o.shape[0]), k5_rows=int(cell.shape[0]))
        if axis:
            group = mesh.groups[axis]
            got = trace(scene, o, d, engine="kernel", t_budget=bud,
                        ray_block=rb, with_aux=c.trace_aux_baked)
            row["combine_ms"] = ranks_ms(
                lambda: combine_trace_shards(got, group), COMBINE_REPS)
            on_host = type(got)(*(None if x is None else x.cpu()
                                  for x in got))
            row["combine_host_ms"] = ranks_host_ms(
                lambda: combine_trace_shards(on_host, group), COMBINE_REPS)
            if tag == "b":
                if rank == 0:
                    out["b bounce 1"] = numpy(combine_trace_shards(got,
                                                                   group))
                else:
                    combine_trace_shards(got, group)
                fo, fd = fan(GATE_RAYS, device)
                merged = combine_trace_shards(
                    trace(scene, fo, fd, engine="kernel"), group)
                if rank == 0:
                    out["b fan"] = numpy(merged)
            del got
        mine[tag] = row
        del scene
    # e: the training step on the fit's setup, over all ranks
    st_f, _, start, cfg_f, poses_f, draws_f, _ = fit_setup(device)
    pose_f = poses_f[0]
    kw = dict(cone_draws=(draws_f[0][0], draws_f[1][0]), device=device)
    mesh = SH.make_mesh()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    wrappers = zero_counts()
    loss, new = SH.train_step_sharded(st_f, start, cfg_f, pose_f, fit_target,
                                      mesh, lr=FIT_LR, **kw)
    torch.cuda.synchronize()
    row = dict(launches=read_counts(wrappers), loss=float(loss),
               new_params=[x.cpu().tolist() for x in (*new.materials,
                                                      new.beam_width)])
    row["ms_per_step"] = ranks_ms(lambda: SH.train_step_sharded(
        st_f, start, cfg_f, pose_f, fit_target, mesh, lr=FIT_LR, **kw), 3)
    row["peak_mib"] = torch.cuda.max_memory_allocated(device) / 2**20
    loss_g, (g_mat, g_bw) = SH.sharded_loss_and_grads(
        st_f, start, cfg_f, pose_f, fit_target, mesh, **kw)
    row.update(loss_of_grads=float(loss_g), grads=torch.cat(
        [*g_mat, g_bw.reshape(1)]).cpu().tolist())
    rows, samples = rank_wedge(cfg_f, mesh)
    waves, sp = SH.wedge_waves(start, cfg_f, pose_f, cone_local(
        *kw["cone_draws"], start.beam_width, cfg_f.beam_sample_dist,
        cfg_f.beam_sample_dist_normal_p_in_cone), rows, samples, device)
    o, d, bud = (ray_major(x) for x in (waves.orig, waves.dir,
                                        P.trace_budget(cfg_f, waves)))
    cell, s = bin_inputs(st_f, start, cfg_f, waves, sp)
    w, mode = cfg_f.denoiser()
    row["kernels_bitwise"] = dict(
        {k: v["bitwise"] for k, v in kernels_vs_plain(
            st_f, o, d, bud, cfg_f.trace_ray_block, reps=1).items()},
        **{k: v["bitwise"] for k, v in bin_vs_plain(
            cell, s, w, mode, cfg_f.n_cells, reps=1).items()})
    mine["e"] = row
    ranks = [None] * world
    dist.all_gather_object(ranks, mine)
    out["ranks"] = ranks
    return out


def layouts_phase(dev, host, n_objects: int, cfg, smi: str) -> dict:
    """Phase 11: the multi-device layouts over RANKS gloo ranks on the one
    card against this process's single-frame render on the same inputs
    (module doc), then the dry run on one NCCL rank."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from radarays_ros_tpu_torch.geom.cache import store_scene_host
    from radarays_ros_tpu_torch.parallel import sharding as SH
    from radarays_ros_tpu_torch.parallel.dryrun import dryrun_multidevice
    from radarays_ros_tpu_torch.parallel.launch import run_ranks
    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.sim.config import Materials
    from radarays_ros_tpu_torch.trace.api import trace
    from radarays_ros_tpu_torch.wave.cone import cone_local, sample_cone_draws

    t_phase = time.perf_counter()
    st, params = kaist_tensors(host, n_objects, dev)
    gen = torch.Generator(dev).manual_seed(11)
    draws = sample_cone_draws(gen, cfg.n_samples, cfg.beam_sample_dist)
    rbeg = torch.randint(0, 1000, (cfg.n_angles,), generator=gen, device=dev)
    pose = batch_poses()[0]
    inputs = dict(cone_draws=tuple(x.cpu().numpy() for x in draws),
                  random_begin=rbeg.cpu().numpy())
    with torch.no_grad():
        refs = {tag: P.simulate_frame(st, params, cfg.replace(**ov), pose,
                                      cone_draws=draws, random_begin=rbeg)
                for tag, _, ov in SUBPHASES}
        local = cone_local(*draws, params.beam_width, cfg.beam_sample_dist,
                           cfg.beam_sample_dist_normal_p_in_cone)
        waves, _ = SH.wedge_waves(params, cfg, pose, local, slice(None),
                                  slice(None), dev)
        o, d, bud = (ray_major(x) for x in (waves.orig, waves.dir,
                                            P.trace_budget(cfg, waves)))
        ref_traces = {
            "b bounce 1": trace(st, o, d, engine="kernel", t_budget=bud,
                                ray_block=cfg.trace_ray_block,
                                with_aux=cfg.trace_aux_baked),
            "b fan": trace(st, *fan(GATE_RAYS, dev), engine="kernel")}
    del st, waves, o, d, bud
    # e: the single-process loss and gradient of the same global objective
    st_f, true, start, cfg_f, poses_f, draws_f, _ = fit_setup(dev)
    d0 = (draws_f[0][0], draws_f[1][0])
    with torch.no_grad():
        target = P.simulate_frame(st_f, true, cfg_f, poses_f[0],
                                  cone_draws=d0).image_float
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (*start.materials, start.beam_width)]
    p = start._replace(materials=Materials(*leaves[:4]), beam_width=leaves[4])
    loss1 = SH.psnr_loss(P.simulate_frame(st_f, p, cfg_f, poses_f[0],
                                          cone_draws=d0).image_float,
                         target, cfg_f.signal_max)
    g1 = torch.cat([g.reshape(-1) for g in torch.autograd.grad(
        loss1, leaves)])
    del st_f

    with tempfile.TemporaryDirectory(prefix="chip_smoke_layouts_") as tmp:
        store_scene_host("phase11", host, cache_dir=Path(tmp))
        t0 = time.perf_counter()
        out = run_ranks(layouts_rank_chip, RANKS, backend="gloo",
                        device="cuda",
                        args=(tmp, "phase11", n_objects, cfg,
                              pose.numpy(), inputs,
                              target.cpu().numpy()))
        ranks_s = time.perf_counter() - t0
    ranks = out["ranks"]
    info = dict(gpu=smi, ranks=RANKS, backend="gloo", label=SHARING,
                ranks_wall_s=ranks_s, per_rank=ranks)
    want_k = {"sweep", "prep_hier", "coarse_words", "bin"}
    for tag, layout, _ in SUBPHASES:
        ref = refs[tag]
        u8, img, mv = (torch.from_numpy(x) for x in out[tag])
        got = P.FrameResult(image_u8=u8, image_float=img, max_val=mv)
        row = dict(layout=SUBPHASE_NAMES[tag], **frame_contract(got, ref))
        check(all(r[tag]["launches"][k] > 0 for r in ranks for k in want_k),
              f"11{tag}: a rank did not launch K1, K2, K3 and K5: "
              f"{[r[tag]['launches'] for r in ranks]}")
        check(all(all(r[tag]["kernels_bitwise"].values()) for r in ranks),
              f"11{tag}: kernels vs plain {[r[tag]['kernels_bitwise'] for r in ranks]}")
        row.update(
            ms_per_frame_rank0=ranks[0][tag]["ms_per_frame"],
            peak_mib_per_rank=[r[tag]["peak_mib"] for r in ranks],
            resident_scene_mib_per_rank=[r[tag]["resident_scene_mib"]
                                         for r in ranks],
            whole_scene_mib=ranks[0]["whole_scene_mib"],
            launches_per_rank=[r[tag]["launches"] for r in ranks],
            kernels_bitwise_per_rank=[r[tag]["kernels_bitwise"]
                                      for r in ranks],
            rays_bounce1_per_rank=[r[tag]["rays_bounce1"] for r in ranks])
        if "combine_ms" in ranks[0][tag]:
            row["combine_ms_per_bounce_rank0"] = ranks[0][tag]["combine_ms"]
        for key in ("combine_host_ms", "wedge_ms", "assemble_ms",
                    "assemble_host_ms"):
            if key in ranks[0][tag]:
                row[key + "_rank0"] = ranks[0][tag][key]
        if tag == "b":
            row["fan_vs_unsharded"] = shard_trace_contract(
                out["b fan"], ref_traces["b fan"])
            row["bounce_1_vs_unsharded"] = shard_trace_contract(
                out["b bounce 1"], ref_traces["b bounce 1"])
        info[tag] = row
        log(f"[11{tag} {SUBPHASE_NAMES[tag]}; {SHARING}] "
            f"{json.dumps({k: v for k, v in row.items() if k != 'launches_per_rank'})}")
    # e: the training step against the single-process objective
    e = [r["e"] for r in ranks]
    want_e = {"sweep", "prep_flat", "bin", "bin_bwd"}
    check(all(r["launches"][k] > 0 for r in e for k in want_e),
          f"11e launches {[r['launches'] for r in e]}")
    check(all(all(r["kernels_bitwise"].values()) for r in e),
          f"11e kernels vs plain {[r['kernels_bitwise'] for r in e]}")
    gr = torch.tensor(e[0]["grads"], dtype=torch.float32)
    g1 = g1.detach().cpu()
    g_err = float((gr - g1).abs().max())
    loss1 = float(loss1.detach())
    l_err = abs(e[0]["loss_of_grads"] - loss1) / abs(loss1)
    old = torch.cat([x.detach().reshape(-1).cpu()
                     for x in (*start.materials, start.beam_width)])
    new = torch.tensor([v for x in e[0]["new_params"]
                        for v in np.ravel(x)], dtype=torch.float32)
    row = dict(layout="train_step_sharded, azimuth x 4", loss=e[0]["loss"],
               loss_single=float(loss1), loss_rel_err=l_err,
               grad_max_abs_err=g_err, grad_max=float(g1.abs().max()),
               params_finite=bool(torch.isfinite(new).all()),
               params_moved=bool((new != old).any()),
               ms_per_step_rank0=e[0]["ms_per_step"],
               peak_mib_per_rank=[r["peak_mib"] for r in e],
               launches_per_rank=[r["launches"] for r in e],
               kernels_bitwise_per_rank=[r["kernels_bitwise"] for r in e])
    info["e"] = row
    log(f"[11e train step; {SHARING}] "
        f"{json.dumps({k: v for k, v in row.items() if k != 'launches_per_rank'})}")
    check(l_err <= 1e-6, f"11e loss {e[0]['loss_of_grads']} vs {float(loss1)}")
    check(g_err <= 1e-5 * float(g1.abs().max()),
          f"11e gradient: max abs error {g_err}")
    check(row["params_finite"] and row["params_moved"], "11e parameters")
    check(all(r["loss"] == e[0]["loss"] for r in e), "11e ranks' losses")
    # the NCCL path: the dry run on one rank
    t0 = time.perf_counter()
    nccl = dryrun_multidevice(1, device="cuda", backend="nccl")
    info["nccl_dryrun"] = dict(world=1, wall_s=time.perf_counter() - t0,
                               layouts=sorted(k for k in nccl
                                              if k != "train"),
                               train_loss=nccl["train"][0])
    log(f"[11 nccl dry run] {json.dumps(info['nccl_dryrun'])}")
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"[11 layouts] {info['phase_s']:.1f} s")
    return info


def shard_trace_contract(got, want) -> dict:
    """A scene-sharded trace (numpy TraceResult fields of rank 0) against
    the unsharded kernel trace: hit equal, t bit for bit on hits but for
    exact-distance ties (the lanes whose obj_id differs: the shards' sweep
    ranks ties by its own order), where t agrees within rtol 1e-6."""
    import numpy as np

    hit, t, _, obj = got[:4]
    w_hit, w_t, w_obj = (x.cpu().numpy() for x in (want.hit, want.t,
                                                   want.obj_id))
    check(np.array_equal(hit, w_hit), f"{int((hit != w_hit).sum())} hits "
          "differ from the unsharded trace")
    ties = obj != w_obj
    exact = hit & ~ties
    check(np.array_equal(t[exact], w_t[exact]),
          f"{int((t[exact] != w_t[exact]).sum())} distances differ off ties")
    np.testing.assert_allclose(t[ties], w_t[ties], rtol=1e-6, atol=0)
    check(ties.mean() < 0.02, f"{int(ties.sum())} tie lanes")
    return dict(rays=int(hit.size), hit_rate=float(hit.mean()),
                hit_mismatches=0, tie_lanes=int(ties.sum()),
                tie_lanes_t_bitwise=int((t[ties] == w_t[ties]).sum()),
                t_bitwise_on_hits=bool(np.array_equal(t[hit], w_t[hit])))


# ---------------------------------------------------------- 13. bench twins

BENCH_BATCH = 20          # the twins' batch (bench.py:189)
# the kernels each twin's path must launch (K1 sweep, K2 prep_hier, K3
# coarse_words, K4 prep_flat, K5 bin, K5's backward bin_bwd)
AT_1M = ("sweep", "prep_hier", "coarse_words", "bin")
AT_10K = ("sweep", "prep_flat", "bin")
AB_SIZES = (128, 384, 512)   # chunksize_ab's sizes besides the default 256


def twin(name: str, *args, env=None, timeout: float = 600.0) -> tuple:
    """Run `python -m radarays_ros_tpu_torch.bench.<name> *args` as a user
    does, from the checkout with this run's environment (and env): its
    stdout JSON lines, parsed, and its seconds. A twin that fails or prints
    no JSON line fails the phase."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", f"radarays_ros_tpu_torch.bench.{name}",
         *args], cwd=HERE, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, **(env or {})))
    seconds = time.perf_counter() - t0
    check(run.returncode == 0, f"bench twin {name} {' '.join(args)} exited "
          f"{run.returncode}:\n{run.stderr[-4000:]}")
    lines = [json.loads(ln) for ln in run.stdout.splitlines()
             if ln.startswith("{")]
    check(bool(lines), f"bench twin {name} printed no JSON line")
    return lines, seconds


def positive(rec: dict, *keys) -> None:
    """Every key of rec is a finite number above 0."""
    import math

    for k in keys:
        v = rec.get(k)
        check(isinstance(v, (int, float)) and math.isfinite(v) and v > 0,
              f"{k} = {v!r} in {rec}")


def launched(rec: dict, kernels, key: str = "kernel_launches") -> None:
    n = rec[key]
    check(all(n[k] > 0 for k in kernels),
          f"launches {n}: {list(kernels)} must each launch")


def bitwise_batch(b, expect) -> dict:
    """One batch of BENCH_BATCH frames on b (a common.Benchmark, or its
    scene, params and cfg) at the KAIST pose with explicit random inputs,
    through the kernels and through the plain versions: the frames must be
    bit-identical, and each kernel in expect launched."""
    import numpy as np
    import torch

    from radarays_ros_tpu_torch.bench import common as BC
    from radarays_ros_tpu_torch.sim import pipeline as P
    from radarays_ros_tpu_torch.utils.transforms import make_pose
    from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

    st, params, cfg = b[:3]
    dev = st.device
    poses = torch.from_numpy(np.tile(make_pose([0.0, 0.0, 2.0]),
                                     (BENCH_BATCH, 1)))
    gen = torch.Generator(dev).manual_seed(20)
    draws = [sample_cone_draws(gen, cfg.n_samples, cfg.beam_sample_dist)
             for _ in range(BENCH_BATCH)]
    kw = dict(cone_draws=tuple(torch.stack(d) for d in zip(*draws)),
              random_begin=torch.randint(0, 1000, (BENCH_BATCH,
                                                   cfg.n_angles),
                                         generator=gen, device=dev))
    BC.zero_launches()
    fk = P.simulate_frames(st, params, cfg, poses, **kw)
    launches = BC.read_launches()
    fp = P.simulate_frames(st, params, cfg.replace(
        trace_engine="sweep", draw_method="plain"), poses, **kw)
    torch.cuda.synchronize()
    out = dict(frames=BENCH_BATCH, n_triangles=st.n_triangles,
               chunk_size=st.chunk_size, launches=launches,
               bitwise=all(torch.equal(x, y) for x, y in zip(fk, fp)),
               mean_pixel=float(fk.image_u8.float().mean()))
    check(all(launches[k] > 0 for k in expect),
          f"launches {launches}: {list(expect)} must each launch")
    check(out["bitwise"], f"the batch of {BENCH_BATCH} on {st.n_triangles} "
          f"triangles (chunk size {st.chunk_size}) through the kernels "
          "differs from the plain versions")
    check(out["mean_pixel"] > 0, "empty frames")
    return out


def bench_phase(dev, smi: str, cache_dir: str, bits_10m: dict) -> dict:
    """Phase 13: every bench twin run as a user runs it, in a process of
    its own, with the scene cache of this run (phase 12's 10M build is
    there); then the twins' shapes through the kernels and the plain
    versions: a batch of 20 at 1M (chunk sizes 128, 256, 384, 512) and at
    10k (bits_10m: the 10M batch, run while phase 12's scene was
    resident), and one loss and gradient of opti_scale's fit."""
    import math
    import tempfile

    import torch

    from radarays_ros_tpu_torch.bench import common as BC
    from radarays_ros_tpu_torch.bench import make_demo
    from radarays_ros_tpu_torch.bench import opti_scale as OS
    from radarays_ros_tpu_torch.bench.headline import METRIC
    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    t_phase = time.perf_counter()
    env = {"RADARAYS_SCENE_CACHE": cache_dir}
    info, secs = dict(gpu=smi), {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
        # a. the headline: one stdout line, the companions in --details
        path = os.path.join(tmp, "details.json")
        lines, secs["headline"] = twin("headline", "--details", path,
                                       env=env, timeout=900)
        check(len(lines) == 1, f"headline printed {len(lines)} lines")
        h = lines[0]
        check(h["metric"] == METRIC and h["unit"] == "Hz"
              and "vs_baseline" not in h, f"headline keys {sorted(h)}")
        check(h["parity"]["exact"] is True, f"parity {h['parity']}")
        x = h["extra"]
        positive(h, "value")
        positive(x, "fenced_best_hz", "fenced_trimmed_median_hz",
                 "mrays_per_sec", "rays_per_frame", "n_triangles")
        check(x["device"] == smi and x["batch"] == BENCH_BATCH
              and x["trace_engine"] == "kernel", f"headline extra {x}")
        launched(x, AT_1M)
        with open(path) as f:
            details = json.load(f)
        small, huge = details["small_10k"], details["huge_10m"]
        check("skipped" not in small, f"10k companion: {small}")
        positive(small, "sustained_hz", "best_hz", "trimmed_median_hz")
        launched(small, AT_10K)
        if "skipped" in huge:
            log(f"[13 headline] huge_10m skipped: {huge['skipped']}")
        else:
            positive(huge, "sustained_hz", "best_hz", "trimmed_median_hz")
            launched(huge, AT_1M)
        info["headline"] = details
        log(f"[13 headline] {json.dumps(h)}")
        log("[13 headline companions] " + json.dumps(
            {k: details[k] for k in ("small_10k", "huge_10m")}))

        # b. the saturated trace suite
        lines, secs["engines"] = twin("engines", "--saturated", env=env)
        check(lines[0]["device"] == smi and len(lines) == 5,
              f"engines lines {lines}")
        for r in lines[1:]:
            positive(r, "mrays_per_sec", "ms", "hit_rate", "peak_mib")
            launched(r, ("sweep", "prep_hier", "coarse_words"))
        info["engines"] = lines

        # c. the profile of one batch of 20
        lines, secs["profile_frame"] = twin("profile_frame", env=env)
        p = lines[0]
        positive(p, "device_total_ms", "device_window_ms", "kernels",
                 "checksum")
        check(0.0 <= p["device_idle_share"] < 1.0 and p["top_groups"]
              and p["device"] == smi and p["bin_calls"] == 1,
              f"profile {p}")
        launched(p, AT_1M)
        info["profile_frame"] = p

        # d. the fit, gradient and black-box, at the reference's defaults;
        # the gradient Adam starts from must be finite and nonzero
        lines, secs["opti_scale"] = twin(
            "opti_scale", "--checkpoint", os.path.join(tmp, "ck.npz"),
            env=env)
        check(len(lines) == 4 and lines[0]["device"] == smi,
              f"opti_scale lines {lines}")
        g, bb = lines[2], lines[3]
        check(g["bench"] == "opti_gradient" and g["resumed_from_step"] == 30
              and bb["bench"] == "opti_black_box", f"{g} {bb}")
        positive(g, "final_psnr_db", "wall_s", "steps_per_s",
                 "start_grad_norm")
        check(all(map(math.isfinite, g["start_grad"]))
              and math.isfinite(g["beam_width_central_difference"]),
              f"start gradient {g['start_grad']}, beam width central "
              f"difference {g['beam_width_central_difference']}")
        positive(bb, "final_psnr_db", "wall_s", "evaluations")
        launched(g, ("sweep", "prep_flat", "bin", "bin_bwd"))
        info["opti_scale"] = lines
        log("[13 opti_scale start gradient] " + json.dumps(
            {k: g[k] for k in ("start_grad", "start_grad_norm",
                               "beam_width_central_difference")}))

        # e. the layouts, 2 gloo ranks sharing the card
        lines, secs["multichip"] = twin("multichip", "--ranks", "2",
                                        env=env)
        check(len(lines) == 3 and all(r["ranks_share_one_card"] is True
                                      and r["device"] == smi
                                      for r in lines), f"multichip {lines}")
        for r in lines[1:]:
            positive(r, "best_hz", "med_hz")
            launched(r, ("sweep", "bin"), "kernel_launches_rank0")
        info["multichip"] = lines

        # f. the sweep kernel A/B stages: the SAH order at chunk size 256,
        # the row the two A/Bs below are read against
        lines, secs["sweep_kernel_ab"] = twin("sweep_kernel_ab", env=env)
        check(lines[0]["order_variant"] == "sah", f"env {lines[0]}")
        info["sweep_kernel_ab"] = lines
        ab_checks(lines, smi)

        # g. leaf orders: the host proxy, then the median order's stages
        lines, secs["order_ab_proxy"] = twin("order_ab", "--proxy", env=env)
        check([r["variant"] for r in lines] == ["median", "sah"],
              f"order_ab proxy {lines}")
        for r in lines:
            positive(r, "mean_overlaps_per_ray", "total_overlaps",
                     "n_chunks")
        info["order_ab_proxy"] = lines
        lines, secs["order_ab_hw"] = twin(
            "order_ab", "--hw", "--variants", "median", env=env)
        check({r["variant"] for r in lines} == {"median"}
              and lines[0]["order_variant"] == "median",
              f"order_ab --hw lines {lines}")
        ab_checks(lines, smi)
        info["order_ab_hw"] = lines

        # h. chunk sizes on the card (256 is sweep_kernel_ab's row); a
        # size is refused only when K1's stages exceed the card's limit
        lines, secs["chunksize_ab"] = twin(
            "chunksize_ab", "--hw", "--sizes", ",".join(map(str, AB_SIZES)),
            env=env)
        info["chunksize_ab"] = lines
        limit = CT.sweep_smem_limit(dev.index)
        for tc in AB_SIZES:
            mine = [r for r in lines if r.get("chunk_size") == tc]
            if mine and mine[0]["stage"] == "refused":
                check(CT.sweep_smem_bytes(tc) > limit,
                      f"chunk size {tc} ({CT.sweep_smem_bytes(tc)} bytes of "
                      f"K1 stages, the card's limit {limit}) was refused: "
                      f"{mine[0]['refused']}")
                log(f"[13 chunksize_ab] {tc} refused: {mine[0]['refused']}")
                continue
            ab_checks([lines[0]] + mine, smi)

        # i. the demo frame into a temporary directory
        out = os.path.join(tmp, "demo")
        lines, secs["make_demo"] = twin("make_demo", "--out", out, env=env)
        dm = lines[0]
        shapes = [make_demo.read_back(f).shape for f in dm["files"]]
        check(shapes == [(3424, 400), (800, 800, 3)] and dm["device"] == smi
              and "panel" in dm, f"make_demo {dm} {shapes}")
        positive(dm, "frame_s")
        info["make_demo"] = dict(dm, shapes=shapes)

    # j. the twins' shapes, kernels against plain versions, bit for bit
    t0 = time.perf_counter()
    bits = {"10m": bits_10m}
    with BC.environ(RADARAYS_SCENE_CACHE=cache_dir):
        for tc in (256, *AB_SIZES):
            bits[f"1m_chunk_{tc}"] = bitwise_batch(
                BC.build_benchmark(83000, chunk_size=tc, device=dev), AT_1M)
        bits["10k"] = bitwise_batch(BC.build_benchmark(800, device=dev),
                                    AT_10K)
    info["bitwise_batch20"] = bits
    secs["bitwise_batch20"] = time.perf_counter() - t0
    log(f"[13 bitwise batch of 20, kernels vs plain] {json.dumps(bits)}")
    t0 = time.perf_counter()
    fs = OS.fit_setup(200, 3, dev)
    fit = fit_vs_plain(fs["scene"], fs["start"], fs["cfg"], fs["poses"],
                       fs["cone_draws"], fs["targets"], fs["pv"], reps=3)
    info["opti_scale_vs_plain"] = fit
    secs["opti_scale_vs_plain"] = time.perf_counter() - t0
    log("[13 opti_scale step, kernels vs plain] " + json.dumps(
        {k: fit[k] for k in ("loss_kernel", "loss_plain", "loss_bitwise",
                             "grad_kernel", "grad_plain",
                             "grad_max_abs_err")}))
    info["seconds"] = secs
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"[13 bench twins] {json.dumps(secs)}")
    log(f"[13 phase] {info['phase_s']:.1f} s")
    return info


def ab_checks(lines: list, smi: str) -> None:
    """The lines of sweep_kernel_ab's stages (an env line, then parity,
    trace_marginal and frame_1m): the card named, parity exact, every
    time and rate above 0, K1 launched."""
    stages = {r["stage"]: r for r in lines}
    check(stages["env"]["device"] == smi and set(stages) == {
        "env", "parity", "trace_marginal", "frame_1m"}, f"A/B lines {lines}")
    check(stages["parity"]["exact"] is True, f"parity {stages['parity']}")
    positive(stages["trace_marginal"], "t1_ms", "t5_ms",
             "marginal_trace_ms", "mrays_per_sec_marginal")
    positive(stages["frame_1m"], "sustained_hz", "best_hz",
             "trimmed_median_hz")
    launched(stages["trace_marginal"], ("sweep",))
    launched(stages["frame_1m"], AT_1M)


def kernel_times(dev, smi: str, phases=("5", "6")) -> dict:
    """The --kernel-times run, through the port that sys.path finds first
    (main puts ROOT there): for each frame path in phases (phase 5's
    ~1M-triangle scene, phase 6's 10k companion) one KAIST batch, every
    trace kernel of
    the path on each bounce and K5's forward (kernels_vs_plain,
    bin_fwd_vs_plain: checked bit for bit, timed by kernel_ms), and one
    batch under the profiler (batch_profile: copies inside bin_signals).
    Every input comes from fixed seeds, so checkouts run in turns in one
    call compare their kernels on one card."""
    import torch

    from radarays_ros_tpu_torch import cuda_build
    from radarays_ros_tpu_torch.image import cuda_draw
    from radarays_ros_tpu_torch.sim import pipeline as P

    b = cuda_build.build()
    out = dict(package=os.path.dirname(os.path.dirname(cuda_draw.__file__)),
               gpu=smi, build_s=b.seconds)
    for tag in phases:
        _, st, params, cfg, _, _ = kaist_setup(
            dev, n_buildings={"5": 83000, "6": 800}[tag])
        poses = batch_poses()
        gen = torch.Generator(dev).manual_seed(0)
        waves0, sensor_pos, _ = batch_waves(params, cfg, poses, gen, dev)
        by_bounce = [kernels_vs_plain(st, o, d, budget,
                                      rb=cfg.trace_ray_block, reps=50)
                     for _, _, o, d, budget in bounce_rays(
                         st, params, cfg, waves0, sensor_pos)]
        cell, s = bin_inputs(st, params, cfg, waves0, sensor_pos)
        w, mode = cfg.denoiser()
        kw = dict(n_cells=cfg.n_cells, combine="sum",
                  weights=tuple(float(x) for x in w), w_mode=mode)
        k5 = {"bin": bin_fwd_vs_plain(cell, s, kw, reps=50)[0]}
        while DEFERRED:
            DEFERRED.pop(0)()
        rows = kernel_rows(by_bounce, k5)
        out[tag] = dict(
            profile=batch_profile(lambda: P.simulate_frames(
                st, params, cfg, poses, generator=gen)),
            kernels={k: {kk: v[kk] for kk in (
                "ms", "wrapper_ms", "ms_source", "ms_by_bounce", "bound_ms",
                "plain_ms")} for k, v in rows.items()})
        del st
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--kernel-times"]:
        root = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else HERE
        sys.path.insert(0, root)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(json.dumps({"kernel_times": kernel_times(
            torch.device("cuda"), smi, sys.argv[3:] or ("5", "6"))}),
            flush=True)
        return 0
    dev = torch.device("cuda")
    # the scene cache of this run: phase 12 primes the 10M scene into it,
    # phase 13's twins find their builds there
    import shutil
    import tempfile

    run_cache = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    try:
        return run(dev, run_cache)
    finally:
        shutil.rmtree(run_cache, ignore_errors=True)


def run(dev, run_cache: str) -> int:
    """Phases 1-13 and the result lines (main's body)."""
    import numpy as np
    import torch

    import radarays_ros_tpu_torch  # noqa: F401  (sets the TF32 switches)
    from radarays_ros_tpu_torch import cuda_build
    from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
    from radarays_ros_tpu_torch.geom.scene import Scene
    from radarays_ros_tpu_torch.sim.config import RadarModelConfig
    from radarays_ros_tpu_torch.trace.api import trace

    details = {}
    t_main = time.perf_counter()

    # ---- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    tf32 = dict(matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                matmul_precision=torch.get_float32_matmul_precision())
    check(not tf32["matmul_allow_tf32"] and not tf32["cudnn_allow_tf32"]
          and tf32["matmul_precision"] == "highest", f"TF32 on: {tf32}")
    details["env"] = dict(gpu=smi, torch=torch.__version__,
                          cuda=torch.version.cuda, python=sys.version.split()[0],
                          device_count=torch.cuda.device_count(), **tf32)
    log(f"[1 env] {json.dumps(details['env'])}")

    # ---- 2. build: the kernels, and the host builder in C++
    from radarays_ros_tpu_torch.native import builder as native_builder

    b = cuda_build.build()
    nb = native_builder.build()
    details["build"] = dict(seconds=b.seconds, library=b.path.name,
                            native_s=nb.seconds, native_library=nb.path.name)
    log(f"[2 build] nvcc {b.seconds:.2f} s -> {b.path.name}; c++ "
        f"{nb.seconds:.2f} s -> {nb.path.name}")
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        f.write(b.log)

    # ---- 3. kernels vs plain at the gate's shapes
    t0 = time.perf_counter()
    parts, names = make_urban_scene(n_buildings=16600, extent=140.0, seed=11)
    gate = Scene.compose(parts, names, chunk_size=256).to_device(
        dev, cache=False)
    gate_build = time.perf_counter() - t0
    o, d = fan(GATE_RAYS, dev)          # 400 x 327 = 130,800 rays
    n_rays = o.shape[0]
    bud = torch.full((n_rays,), 1000.0, device=dev)
    gk = kernels_vs_plain(gate, o, d, bud, rb=2048, reps=5)
    # K4 on the same fan against the scene's supergroups of 8 chunks, fewer
    # than 256 boxes (the flat prep's side of the threshold)
    from radarays_ros_tpu_torch.trace import cuda_trace as CT
    o8, _, inv8, bud8, lo8, hi8, _ = CT._prep_inputs(gate, o, d, bud,
                                                     ray_block=2048, group=8)
    gk["prep_flat"] = flat_vs_plain(lo8, hi8, o8, inv8, bud8, 2048, 5)[0]
    w, mode = RadarModelConfig(signal_denoising_triangular_width=35,
                               signal_denoising_triangular_mode=0.35
                               ).denoiser()
    rng = np.random.default_rng(1)
    cell = torch.from_numpy(rng.integers(-10, 3434, (400, 200))
                            .astype(np.int32)).to(dev)
    s = torch.from_numpy(rng.exponential(1.0, (400, 200))
                         .astype(np.float32)).to(dev)
    gk.update(bin_vs_plain(cell, s, w, mode, 3424, reps=20))
    details["kernels_gate"] = dict(n_triangles=gate.n_triangles,
                                   n_chunks=gate.n_chunks,
                                   host_build_s=gate_build, kernels=gk)
    log(f"[3 kernels vs plain, gate shapes: {gate.n_triangles} tris, "
        f"{gate.n_chunks} chunks, {n_rays} rays] "
        + json.dumps({k: {kk: v[kk] for kk in ("bitwise", "max_abs_err",
                                              "plain_ms")}
                      for k, v in gk.items()}))

    # ---- 4. trace gate
    rk = trace(gate, o, d, engine="kernel")
    rs = trace(gate, o, d, engine="sweep")
    common = rk.hit & rs.hit
    hit_mm = int((rk.hit != rs.hit).sum())
    obj_mm = int((rk.obj_id[common] != rs.obj_id[common]).sum())
    max_dt = float((rk.t[common] - rs.t[common]).abs().max())
    sub = torch.arange(0, n_rays, n_rays // 4096, device=dev)[:4096]
    rb_ = trace(gate, o[sub], d[sub], engine="brute")
    hit_b = rb_.hit
    brute_ok = (torch.equal(hit_b, rk.hit[sub])
                and torch.equal(rb_.obj_id, rk.obj_id[sub])
                and torch.allclose(rk.t[sub][hit_b], rb_.t[hit_b],
                                   rtol=1e-4, atol=1e-4)
                and torch.allclose(rk.normal[sub], rb_.normal, atol=1e-4))
    details["trace_gate"] = dict(
        n_rays=n_rays, hit_rate=float(rk.hit.float().mean()),
        hit_mismatches=hit_mm, obj_mismatches_on_common_hits=obj_mm,
        max_abs_dt_on_common_hits=max_dt, brute_subset=int(sub.numel()),
        brute_contract=bool(brute_ok))
    log(f"[4 trace gate] {json.dumps(details['trace_gate'])}")
    check(hit_mm == 0 and obj_mm == 0, "trace gate mismatches")
    check(brute_ok, "brute contract on the 4096-ray subset")
    gate_sub = (gate, o[sub], d[sub], rb_)        # for phase 9c
    del rk, rs, o, d

    # ---- 5. frames on the main path
    scene, st, params, cfg, info, host5 = kaist_setup(dev)
    log(f"[5 scene] {json.dumps(info)}")
    frames, launches, bb5, k5_5, fvp = frames_phase(
        "5", st, params, cfg, dev, expect_zero=("prep_flat", "bin_bwd"))
    frames["gpu"] = smi
    details.update(frames=frames, frame_vs_plain=fvp)
    scene5, cfg5, info5 = scene, cfg, info
    del st

    # ---- 6. frames on the 10k companion scene (the flat prep K4)
    scene, st, params, cfg, info, _ = kaist_setup(dev, n_buildings=800)
    log(f"[6 scene] {json.dumps(info)}")
    frames10, launches10, bb6, k5_6, fvp10 = frames_phase(
        "6", st, params, cfg, dev,
        expect_zero=("prep_hier", "coarse_words", "bin_bwd"),
        min_column_share=0.1)      # 800 buildings over 600 m x 600 m
    frames10["gpu"] = smi
    details.update(frames_10k=frames10, frame_vs_plain_10k=fvp10)
    scene10 = scene
    del scene, st

    # ---- 7. the fit
    details["fit"] = fit_phase(dev)
    details["fit"]["gpu"] = smi

    # ---- 8. the command line on the card
    details["cli"] = cli_phase(dev, scene5, host5, cfg5, info5, scene10)
    details["cli"]["gpu"] = smi

    # ---- 9. the trace extras on the card, and the explorer
    t0 = time.perf_counter()
    st5, params5 = kaist_tensors(host5, scene5.n_objects, dev)
    n_objects5 = scene5.n_objects
    del scene10
    details["saturated"] = saturated_phase(st5, smi)
    t1 = time.perf_counter()
    details["two_phase_frames"] = two_phase_frames(st5, params5, cfg5, smi)
    del st5
    t2 = time.perf_counter()
    details["mxu"] = mxu_phase(*gate_sub, dev, smi)
    del gate_sub
    t3 = time.perf_counter()
    details["explore"] = explorer_phase(dev)
    details["phase_9_parts_s"] = dict(
        saturated=t1 - t0, two_phase_frames=t2 - t1, mxu=t3 - t2,
        explore=time.perf_counter() - t3)
    details["phase_9_s"] = time.perf_counter() - t0
    log(f"[9 trace extras] {details['phase_9_s']:.1f} s "
        f"{json.dumps(details['phase_9_parts_s'])}")

    # ---- 12. bench.py's ~10M-triangle scale, before the profiler
    huge, b12, launches12, bb12, k5_12, groups12 = huge_phase(
        dev, smi, scene5, host5, run_cache)
    details["huge_10m"] = huge
    del scene5

    # ---- 10. the profiler's figures, after every end-to-end figure
    t0 = time.perf_counter()
    while DEFERRED:
        DEFERRED.pop(0)()
    control = copy_check_control(dev)
    details["copy_check_control"] = control
    log(f"[10 copy check, positive control] memcpy_calls_in_bin {control}")
    check(control >= 1, "the copy check missed a copy made inside _Bin")
    for tag, fr in (("5", frames), ("6", frames10),
                    ("12", huge["frames"])):
        log(f"[10 batch profile, phase {tag}] {json.dumps(fr['profile'])}")
        check(fr["profile"]["bin_calls"] > 0
              and fr["profile"]["memcpy_calls_in_bin"] == 0,
              "bin_signals issued a copy")
    # each K4 call is its one kernel: no fill, memset or copy in its window
    flat = [("gate", gk["prep_flat"]),
            ("fit", details["fit"]["kernels_fit_shapes"]["prep_flat"])] + [
        (f"6 bounce {i + 1}", mb["prep_flat"]) for i, mb in enumerate(bb6)]
    alone = {k: dict(profiled_launches=r.get("profiled_launches", 0),
                     other_device_events=r.get("other_device_events"))
             for k, r in flat}
    details["prep_flat_alone"] = alone
    log(f"[10 K4 launches alone] {json.dumps(alone)}")
    check(all(v["profiled_launches"] > 0 and v["other_device_events"] == 0
              for v in alone.values()),
          "a K4 wrapper call ran device work besides its kernel")
    times = ("ms", "wrapper_ms", "ms_source")
    log("[10 kernel times, gate shapes] " + json.dumps(
        {k: {kk: v[kk] for kk in times} for k, v in gk.items()}))
    for tag, bb in (("5", bb5), ("6", bb6), ("12", bb12)):
        for i, mb in enumerate(bb):
            log(f"[10 kernel times, phase {tag} bounce {i + 1}] " + json.dumps(
                {k: {kk: v[kk] for kk in times} for k, v in mb.items()}))
    mk, mk10 = kernel_rows(bb5, k5_5), kernel_rows(bb6, k5_6)
    mk12 = kernel_rows(bb12, k5_12)
    details.update(kernels_main_path=mk, kernels_10k=mk10, kernels_10m=mk12)
    for tag, rows in (("5", mk), ("6", mk10),
                      ("7", details["fit"]["kernels_fit_shapes"]),
                      ("12", mk12)):
        log(f"[10 kernel times, phase {tag}, per launch] " + json.dumps(
            {k: {kk: v[kk] for kk in (*times, "plain_ms", "bound_ms",
                                      "bound_by") if kk in v}
             for k, v in rows.items() if isinstance(v, dict)}))
    sat = details["saturated"]
    log("[10 kernel times, saturated sets, per launch] " + json.dumps(
        {tag: {k: dict(v, **{kk: sat[tag]["bound_per_launch"][k][kk]
                             for kk in ("bound_ms", "bound_by")})
               for k, v in sat[tag]["kernel_ms"].items()}
         for tag, _, _ in SAT_SETS}))
    groups = {f"group_{g}": {k: {kk: v[kk] for kk in (
        *times, "plain_ms", "bound_ms", "bound_by")} for k, v in rows.items()}
        for g, rows in groups12.items()}
    huge["groups_1_vs_4"]["kernel_ms"] = groups
    log(f"[10 kernel times, phase 12e, prep group 1 vs 4] "
        f"{json.dumps(groups)}")
    details["profiler_phase_s"] = time.perf_counter() - t0
    # phase 13's batch of 20 at 10M, kernels against plain versions, while
    # the scene is resident; its tensors go before the ranks load phase
    # 5's build
    t0 = time.perf_counter()
    bits_10m = dict(bitwise_batch(b12, AT_1M),
                    seconds=time.perf_counter() - t0)
    del b12, bb12, groups12
    import gc

    gc.collect()
    torch.cuda.empty_cache()

    # ---- 11. the multi-device layouts, ranks sharing the card
    details["layouts"] = layouts_phase(dev, host5, n_objects5, cfg5, smi)
    del host5

    # ---- 13. the bench twins, as a user runs them
    gc.collect()
    details["bench"] = bench_phase(dev, smi, run_cache, bits_10m)
    bench = details["bench"]["headline"]
    per_batch = {
        tag: {k: n / r["timed_batches"] for k, n in
              r["kernel_launches"].items()} if "kernel_launches" in r
        else None
        for tag, r in (("1m", bench["headline"]["extra"]),
                       ("10k", bench["small_10k"]),
                       ("10m", bench["huge_10m"]))}

    source = {"sweep": "radarays_ros_tpu_torch/csrc/sweep.cu",
              "prep_hier": "radarays_ros_tpu_torch/csrc/prep.cu",
              "coarse_words": "radarays_ros_tpu_torch/csrc/prep.cu",
              "prep_flat": "radarays_ros_tpu_torch/csrc/prep.cu",
              "bin": "radarays_ros_tpu_torch/csrc/bin.cu",
              "bin_bwd": "radarays_ros_tpu_torch/csrc/bin.cu"}
    replaces = {
        "sweep": "radarays_ros_tpu/trace/pallas_trace.py:99",
        "prep_hier": "radarays_ros_tpu/trace/pallas_trace.py:523",
        "coarse_words": "radarays_ros_tpu/trace/pallas_trace.py:584",
        "prep_flat": "radarays_ros_tpu/trace/pallas_trace.py:488",
        "bin": "radarays_ros_tpu/image/pallas_draw.py:33",
        "bin_bwd": "radarays_ros_tpu/image/pallas_draw.py:111"}
    # each row from the path whose run and shapes measured it: K4 runs only
    # on scenes under 256 supergroups (phase 6), K5's backward only in the
    # fit (phase 7: launches per Adam step), the rest on the 1M-triangle
    # frames (phase 5)
    fit = details["fit"]
    rows = {k: (launches10, mk10, TIMED_BATCHES, "6 frames at 10k")
            if k == "prep_flat" else (launches, mk, TIMED_BATCHES,
                                      "5 frames at 1M") for k in source}
    rows["bin_bwd"] = (fit["launches"], fit["kernels_fit_shapes"],
                       FIT_STEPS, "7 fit, per Adam step")
    # ms (device time), wrapper_ms, plain_ms and bound_ms are per launch,
    # averaged over the launches of one batch (K1-K4: one a bounce; K5:
    # one a batch)
    table = []
    for k in source:
        n, m, per, path = rows[k][0][k], rows[k][1][k], *rows[k][2:]
        m12 = mk12.get(k) if k in ("sweep", "prep_hier", "coarse_words",
                                   "bin") else None
        at_10m = None if m12 is None else dict(
            launches=launches12[k], launches_per_batch=launches12[k]
            / TIMED_BATCHES, ms=m12["ms"], wrapper_ms=m12["wrapper_ms"],
            ms_by_bounce=m12.get("ms_by_bounce", [m12["ms"]]),
            plain_ms=m12["plain_ms"], bound_ms=m12["bound_ms"],
            bound_by=m12["bound_by"], max_abs_err=m12["max_abs_err"],
            prep_group=huge["frames"]["prep_group"])
        table.append(dict(
            name=k, route="cuda", source=source[k], replaces=replaces[k],
            path=path, launches=n, launches_per_batch=n / per,
            max_abs_err=m["max_abs_err"], ms=m["ms"],
            wrapper_ms=m["wrapper_ms"], ms_source=m["ms_source"],
            ms_by_bounce=m.get("ms_by_bounce", [m["ms"]]),
            plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=None,
            library_note=LIBRARY_NOTE[k], path_10m=at_10m,
            launches_per_batch_of_20={
                tag: None if v is None else v[k]
                for tag, v in per_batch.items()}))
    details["kernels"] = table
    details["total_s"] = time.perf_counter() - t_main
    log(f"[total] {details['total_s']:.1f} s from phase 1 to the table")
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=2)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
