"""The port's spans (utils/profiling.py:annotate) and the benchmark's
readers of them (portbench/metrics/): the shared no-op without a
profiler; under torch.profiler on the CPU, the fit loop's `rr.fit.run` and
`rr.fit.eval` spans and the compiled entry's one `rr.frame.entry` a call;
the three readers on hand-built traces; and, on the card, a compiled
frame's one `rr.graph.build` followed by replays, with no span inside the
build and none among the device's events.

Small sizes (16 azimuths, 128 cells, 6 samples), as
tests/test_torch_opti.py; the port runs its plain versions on the CPU.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness import Spec
from portbench.tracing import CALL_SPAN, Trace, from_profiler
from radarays_ros_tpu_torch.geom.primitives import make_box
from radarays_ros_tpu_torch.geom.scene import Scene
from radarays_ros_tpu_torch.opti import optimize as O
from radarays_ros_tpu_torch.sim import pipeline as P
from radarays_ros_tpu_torch.sim.config import (Materials, RadarModelConfig,
                                               RadarParams)
from radarays_ros_tpu_torch.utils.profiling import annotate
from radarays_ros_tpu_torch.utils.transforms import make_pose
from radarays_ros_tpu_torch.wave.cone import sample_cone_draws

torch.set_num_threads(2)

_MATS = [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
         dict(velocity=0.05, ambient=0.3, diffuse=0.6, specular=150.0),
         dict(velocity=0.2, ambient=0.9, diffuse=0.05, specular=2000.0)]
_CFG = dict(n_angles=16, n_cells=128, resolution=0.25, n_samples=6,
            beam_sample_dist=2, n_reflections=1, energy_max=0.72,
            signal_max=110.0, signal_denoising=1,
            signal_denoising_triangular_width=7,
            signal_denoising_triangular_mode=0.35, ambient_noise=0,
            record_multi_reflection=True, opaque_materials=False,
            trace_ray_block=128)
_PV = dict(material_slots=(1, 2), tune_beam_width=False,
           tune_n_reflections=False)


@pytest.fixture(scope="module")
def room():
    """tests/test_torch_opti.py's room: (scene, params, cfg, pose, draws)
    on the CPU."""
    parts = [make_box((0, 0, 0), (40.0, 40.0, 10.0))[:, ::-1, :],
             make_box((8.0, 2.0, 0.0), (2.0, 2.0, 10.0)),
             make_box((-6.0, -7.0, 0.0), (4.0, 1.0, 10.0))]
    st = Scene.compose(parts, chunk_size=8).to_device("cpu")
    params = RadarParams.make(Materials.from_list(_MATS), [1, 2, 2], 9.0)
    cfg = RadarModelConfig(**_CFG)
    pose = torch.from_numpy(make_pose([0.5, -0.3, 1.5]))
    draws = sample_cone_draws(torch.Generator().manual_seed(0),
                              cfg.n_samples, cfg.beam_sample_dist)
    return st, params, cfg, pose, draws


def _spans(prof, prefix="rr."):
    """[(name, start_us, end_us)] of the profiler's CPU spans named
    prefix*, in start order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith(prefix)), key=lambda s: s[1])


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def _objective(room):
    st, params, cfg, pose, draws = room
    target = P.simulate_frame(st, params, cfg, pose,
                              cone_draws=draws).image_float.detach()

    def loss_of_params(p):
        res = P.simulate_frame(st, p, cfg, pose, cone_draws=draws)
        return torch.mean((res.image_float - target) ** 2)

    return loss_of_params


# ------------------------------------------------------------ the primitive

def test_annotate_without_profiler_is_one_shared_noop():
    assert not torch.autograd._profiler_enabled()
    a, b = annotate("rr.a"), annotate("rr.b")
    assert a is b
    with a:
        with b:
            pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("rr.a"):
            torch.ones(2).sum()
    assert annotate("rr.a") is a
    assert [s[0] for s in _spans(prof)] == ["rr.a"]


# ------------------------------------------------------------ the fit loop

def test_optimize_gradient_spans(room):
    """One rr.fit.run holding `steps` rr.fit.eval spans, in order; Adam's
    step lies outside every evaluation."""
    st, params, cfg, pose, draws = room
    steps = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = O.optimize_gradient(_objective(room), params,
                                  O.ParamVector(**_PV), steps=steps,
                                  lr=0.05)
    spans = _spans(prof)
    runs = [s for s in spans if s[0] == "rr.fit.run"]
    evals = [s for s in spans if s[0] == "rr.fit.eval"]
    assert len(runs) == 1 and len(res.history) == steps
    assert len(evals) == steps
    assert all(_inside(e, runs[0]) for e in evals)
    assert all(a[2] <= b[1] for a, b in zip(evals, evals[1:]))
    adam = _spans(prof, "Optimizer.step")
    assert adam and not any(_inside(a, e) for a in adam for e in evals)
    assert not [s for s in spans if s[0].startswith("rr.graph.")]


def test_optimize_black_box_spans(room):
    """One rr.fit.run holding len(history) rr.fit.eval spans: one a call of
    the objective."""
    st, params, cfg, pose, draws = room
    pv = O.ParamVector(**_PV)
    loss_of_params = _objective(room)
    loss_of_vec = O.compiled(
        lambda x: loss_of_params(pv.to_params(params, x)[0]))

    def f(x):
        return float(loss_of_vec(torch.as_tensor(x, dtype=torch.float32)))

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, hist = O.optimize_black_box(f, pv.bounds(), n_seeds=3,
                                          iters=3, seed=1,
                                          x0=pv.to_vec(params))
    spans = _spans(prof)
    runs = [s for s in spans if s[0] == "rr.fit.run"]
    evals = [s for s in spans if s[0] == "rr.fit.eval"]
    assert len(runs) == 1 and len(hist) > 3
    assert len(evals) == len(hist)
    assert all(_inside(e, runs[0]) for e in evals)


# ------------------------------------------------------------ the entry

@pytest.mark.parametrize("batched", [False, True])
def test_compiled_entry_opens_one_span_a_call(room, batched):
    st, params, cfg, pose, draws = room
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if batched:
            res = P.simulate_frames_jit(
                st, params, cfg, pose[None],
                cone_draws=tuple(d[None] for d in draws))
        else:
            res = P.simulate_frame_jit(st, params, cfg, pose,
                                       cone_draws=draws)
    assert res.image_u8.any()
    assert [s[0] for s in _spans(prof)] == ["rr.frame.entry"]


# ------------------------------------------------------------ the readers

def _read(metric, trace):
    return Spec().reader(metric)(types.SimpleNamespace(trace=trace))


def _trace(host):
    return Trace([("sweep_kernel", 0, 5)], host, (0, 5000), 0, 0)


def test_entry_to_launch_reader():
    """The median over outermost entries with a replay of (replay's end -
    entry's start): 55, 50 and 70 us; the nested entry and the entry
    that built its graph are not read."""
    host = [("rr.frame.entry", 0, 100), ("rr.frame.entry", 5, 90),
            ("aten::copy_", 10, 20), ("rr.graph.replay", 40, 55),
            ("rr.frame.entry", 200, 320), ("rr.graph.replay", 230, 250),
            ("rr.frame.entry", 400, 490), ("rr.graph.replay", 450, 470),
            ("rr.frame.entry", 600, 900), ("rr.graph.build", 610, 890)]
    got = _read("entry.to_launch_ms.live", _trace(host))
    assert got == pytest.approx(0.055)


def test_fit_host_reader():
    """From the end of evaluation i to the end of the replay in
    evaluation i+1, inside one fit: 30 and 80 us in the first fit, 70 in
    the second (its first evaluation has no predecessor); the evaluation
    outside any fit is not read."""
    host = [("rr.fit.run", 0, 1000),
            ("rr.fit.eval", 10, 100), ("rr.graph.build", 15, 90),
            ("rr.fit.eval", 120, 200), ("rr.graph.replay", 125, 130),
            ("Optimizer.step#Adam.step", 210, 250),
            ("rr.fit.eval", 260, 300), ("rr.graph.replay", 270, 280),
            ("rr.fit.run", 2000, 2500),
            ("rr.fit.eval", 2010, 2100), ("rr.graph.replay", 2020, 2030),
            ("rr.fit.eval", 2150, 2200), ("rr.graph.replay", 2160, 2170),
            ("rr.fit.eval", 3000, 3100), ("rr.graph.replay", 3010, 3020)]
    assert _read("fit.host_ms_per_eval", _trace(host)) == \
        pytest.approx(0.07)


def test_fit_capture_reader():
    """The builds inside the fits (75 us) over the fits (2); the build
    outside them is not counted; no build in a fit reads 0."""
    host = [("rr.fit.run", 0, 1000), ("rr.graph.build", 15, 90),
            ("rr.fit.run", 2000, 2500), ("rr.graph.build", 3000, 3100)]
    assert _read("fit.capture_ms_per_fit", _trace(host)) == \
        pytest.approx(0.0375)
    assert _read("fit.capture_ms_per_fit",
                 _trace([("rr.fit.run", 0, 10)])) == 0.0


@pytest.mark.parametrize("metric", ["entry.to_launch_ms.live",
                                    "fit.host_ms_per_eval",
                                    "fit.capture_ms_per_fit"])
def test_readers_without_spans_read_none(metric):
    """A trace of a program without the spans (the parent's) and no
    trace at all read None."""
    host = [("aten::copy_", 10, 20), ("cudaGraphLaunch", 40, 55),
            ("Optimizer.step#Adam.step", 60, 80)]
    assert _read(metric, _trace(host)) is None
    assert _read(metric, None) is None


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
def test_compiled_frame_spans_on_card():
    """Under the profiler a new frame graph is one rr.graph.build with no
    span inside it, then only replays, each inside its rr.frame.entry;
    no rr.* name reaches the device's events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the compiled frame is a CUDA "
                    "graph")
    from radarays_ros_tpu_torch.geom.primitives import make_urban_scene
    from radarays_ros_tpu_torch.geom.scene import INVALID_OBJ_ID

    dev = torch.device("cuda")
    parts, names = make_urban_scene(n_buildings=20, extent=40.0, seed=1)
    st = Scene.compose(parts, names, chunk_size=64).to_device(dev)
    ids = st.obj_ids
    n_obj = int(ids[ids != INVALID_OBJ_ID].max()) + 1
    params = RadarParams.make(Materials.from_list(_MATS[:2], device=dev),
                              np.ones(n_obj, np.int32), 10.0)
    # a cfg no other test captures: the first call builds a graph
    cfg = RadarModelConfig(n_angles=64, n_cells=512, resolution=0.1,
                           n_samples=8, n_reflections=3, ambient_noise=2,
                           signal_max=97.0, trace_engine="kernel")
    pose = torch.from_numpy(make_pose([0.5, 0.5, 2.0])).to(dev)
    g = torch.Generator(dev).manual_seed(0)
    c0 = P.frame_graphs.captures
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with torch.profiler.record_function(CALL_SPAN):
                P.simulate_frame_jit(st, params, cfg, pose, generator=g)
                torch.cuda.synchronize()
    assert P.frame_graphs.captures - c0 == 1
    spans = _spans(prof)
    entries = [s for s in spans if s[0] == "rr.frame.entry"]
    builds = [s for s in spans if s[0] == "rr.graph.build"]
    replays = [s for s in spans if s[0] == "rr.graph.replay"]
    assert len(entries) == 3 and len(builds) == 1 and len(replays) == 2
    assert _inside(builds[0], entries[0])
    assert not any(_inside(s, builds[0]) for s in spans if s != builds[0])
    assert [sum(_inside(r, e) for r in replays) for e in entries] \
        == [0, 1, 1]
    trace = from_profiler(prof, 3, 0)
    assert trace.kernels()
    assert not [d for d in trace.device if d[0].startswith("rr.")]
    assert _read("entry.to_launch_ms.live", trace) > 0
