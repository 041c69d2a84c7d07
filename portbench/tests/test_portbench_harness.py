"""The port's benchmark harness on the CPU at tiny sizes: cells found by
name, a cell added as data files only, the result line, the device rule,
no JAX, and the comparison that decides `correct` (sound runs pass, the
TF32 control and the planted faults fail).

    python -m pytest portbench/tests -q -p no:cacheprovider

The card-only case (`cuda` marker) runs one real cell and skips here.
"""

from __future__ import annotations

import ast
import copy
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check as CK
from portbench import generator as G
from portbench import harness as H
from portbench.reference import fit as RFit

ROOT = Path(__file__).resolve().parents[2]
BASE = ROOT / "portbench"
SPEC = H.Spec()
CELLS = [w["name"] for w in SPEC.data["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SEED = 2**31 + 12345


def tiny_config(conf: dict) -> dict:
    """The configuration at a size the CPU runs in seconds: every setting
    kept but the image (24 azimuths, 800 cells), the samples (8) and the
    scene (300 boxes over 60 m, the ring at 25 m)."""
    c = copy.deepcopy(conf)
    c["radar"].update(n_angles=24, n_cells=800, n_samples=8)
    c["scene"].update(n_buildings=300, extent=60.0, chunk_size=64,
                      ring_radius=25.0, ring_half_width=6.0)
    c.get("trajectory", c.get("frames"))["radius"] = 25.0
    return c


def tiny_traffic(traffic: dict) -> dict:
    """One call or fit a window, every answer of it kept for the check."""
    t = copy.deepcopy(traffic)
    if t["kind"] == "frames":
        t["batch"] = min(t["batch"], 3)
        t["check"] = {"frames": 64, "columns": 24}
    elif t["method"] == "gradient":
        t["steps"] = 5
    else:
        t.update(n_seeds=4, iters=4)
        t["check"]["evals"] = 4
    t["trace_calls"] = 1
    return t


def run_tiny(cell: str, trace: bool = False, seconds: float = 0.0,
             spec=SPEC, **kw) -> dict:
    w = spec.workload(cell)
    conf = kw.pop("conf", None) or tiny_config(spec.config(w["config"]))
    traffic = kw.pop("traffic", None) or tiny_traffic(
        spec.traffic(w["traffic"]))
    return H.run_cell(cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                      spec=spec, conf=conf, traffic=traffic,
                      log=lambda m: None, **kw)


# ------------------------------------------------------------ the files

def test_every_cell_config_and_metric_found_by_name():
    d = SPEC.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in d["configs"]:
        assert NAME.match(c["name"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in d["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        SPEC.config(w["config"])
        G.kind(SPEC.traffic(w["traffic"])["kind"]).Cell
        G.reference(SPEC.config(w["config"]))
        assert SPEC.limits(w["name"]), f"no limits for {w['name']}"
        reported = {m["name"] for m in SPEC.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = SPEC.per_layer(w["name"])
        assert layer and all(m["moves"] in reported for m in layer)
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and callable(SPEC.reader(m["name"]))
    for m in d["per_layer"]:
        assert m["moves"] in e2e


def test_the_kaist_preset_is_the_frozen_copy():
    from portbench import frozen

    conf = SPEC.config("kaist02-1m")
    assert conf["radar"] == frozen.KAIST
    assert conf["materials"] == [frozen.AIR, frozen.WALL]
    fit = SPEC.config("kaist02-fit")
    assert fit["radar"] == dict(frozen.KAIST, n_reflections=2,
                                ambient_noise=0, opaque_materials=False)


def test_a_cell_added_as_data_files_only_runs(tmp_path):
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(BASE / sub, base / sub)
    conf = tiny_config(SPEC.config("kaist02-1m"))
    conf["name"] = "tiny-town"
    (base / "configs" / "tiny-town.json").write_text(json.dumps(conf))
    traffic = tiny_traffic(SPEC.traffic("stream20"))
    traffic["batch"] = 2
    (base / "traffic" / "pairs2.json").write_text(json.dumps(traffic))
    shutil.copy(base / "limits" / "kaist02-1m.stream20.json",
                base / "limits" / "tiny-town.pairs2.json")
    data = copy.deepcopy(SPEC.data)
    data["configs"].append(dict(name="tiny-town", source="test",
                                file="portbench/configs/tiny-town.json",
                                reduced=[], why="test"))
    data["workloads"].append(dict(name="tiny-town.pairs2",
                                  config="tiny-town", traffic="pairs2",
                                  chips=1, why="test"))
    for m in data["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("tiny-town.pairs2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    spec = H.Spec(tmp_path / "BENCHMARK.json", base)
    out = H.run_cell("tiny-town.pairs2", SEED, 0.0, False, "cpu",
                     time.perf_counter(), spec=spec, log=lambda m: None)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert out["attempted"] == 2


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    out = run_tiny("kaist02-1m.stream20", trace=trace)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] * trace + ["check"]
    assert list(out) == want
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in out["check"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_no_card_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    for path in BASE.rglob("*.py"):
        assert not _imports(path) & set(H.FORBIDDEN), path
    # the reference imports nothing of the program either
    for path in (BASE / "reference").rglob("*.py"):
        assert "radarays_ros_tpu_torch" not in _imports(path), path
    code = ("import time, json; from portbench import harness as H; "
            "from portbench.tests import test_portbench_harness as T; "
            "T.run_tiny('kaist02-fit.bbox60'); "
            "print(json.dumps(H.loaded_forbidden()))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == []


# ------------------------------------------------------ the comparison

@pytest.mark.parametrize("cell", CELLS)
def test_tiny_window_agrees_with_the_reference(cell):
    out = run_tiny(cell)
    assert out["correct"], out["check"]
    assert out["failed"] == 0


def test_tf32_control_fails_the_frame_comparison():
    w = SPEC.workload("kaist02-1m.stream20")
    conf = tiny_config(SPEC.config(w["config"]))
    cell = G.kind("frames").Cell(conf, tiny_traffic(SPEC.traffic("stream20")),
                                 SEED, "cpu")
    win = cell.window(0.0, 0)
    rows, u8, mv, _ = CK.frame_rows(win.kept, 24, 24,
                                    np.random.default_rng(0), "cpu")
    soup, om = cell.sys.soup, cell.sys.object_materials
    ref = CK.reference_columns(conf, soup, om, rows, "cpu")
    ctl = CK.reference_columns(conf, soup, om, rows, "cpu", tf32=True)
    limits = SPEC.limits("kaist02-1m.stream20")
    prog = CK.frame_numbers(u8, mv, *ref)
    assert all(prog[k] <= limits[k] for k in prog)
    control = CK.frame_numbers(*ctl, *ref)
    assert any(control[k] > limits[k] for k in control), control


@pytest.mark.parametrize("cell", ["kaist02-fit.adam60", "kaist02-fit.bbox60"])
def test_tf32_control_fails_the_fit_comparison(cell):
    w = SPEC.workload(cell)
    conf = tiny_config(SPEC.config(w["config"]))
    traffic = tiny_traffic(SPEC.traffic(w["traffic"]))
    fc = G.kind("fit").Cell(conf, traffic, SEED, "cpu")
    win = fc.window(0.0, 0)
    rec = win.kept[0]
    ctl = RFit.Problem.make(conf, fc.sys.soup, fc.sys.object_materials,
                            fc.poses, fc.draws, "cpu", tf32=True)
    p, tg = fc.problem, fc.targets_u8
    limits = SPEC.limits(cell)
    if traffic["method"] == "gradient":
        ref = p.follow(rec["v0"], tg, 3, rec["lr"])
        c = ctl.follow(rec["v0"], tg, 3, rec["lr"])
        fake = dict(history=c["loss"], lr=rec["lr"],
                    steps=[(c["z"][k], c["grad"][min(k, 2)])
                           for k in range(4)])
        control = CK.adam_numbers(p, tg, fake, ref)
    else:
        picks = CK.bbox_pick(rec, 4, np.random.default_rng(0))
        with torch.no_grad():
            vals = [float(ctl.loss_v(torch.as_tensor(
                rec["evals"][i][0], dtype=torch.float32), tg))
                for i in picks]
        control = CK.bbox_numbers(p, tg, rec, picks, vals)
    assert any(control[k] > limits[k] for k in control), control


# ------------------------------------------------------ planted faults

def _frames_fault(kind):
    from radarays_ros_tpu_torch.sim import pipeline as P

    real_many, real_one = P.simulate_frames_jit, P.simulate_frame_jit
    last = {}

    def half(*a, **k):
        res = real_many(*a, **k)
        n = res.image_u8.shape[0] // 2
        return type(res)(*(torch.cat([x[:-n], torch.zeros_like(x[-n:])])
                           for x in res))

    def altered(*a, **k):
        res = real_many(*a, **k)
        return res._replace(image_u8=torch.roll(res.image_u8, 1, dims=1))

    def stale(*a, **k):
        res = real_one(*a, **k)
        return last.setdefault("res", res)

    def altered_one(*a, **k):
        res = real_one(*a, **k)
        return res._replace(image_u8=torch.roll(res.image_u8, 1, dims=0))

    return {"half_batch": ("simulate_frames_jit", half),
            "altered": ("simulate_frames_jit", altered),
            "unchanged": ("simulate_frame_jit", stale),
            "altered_one": ("simulate_frame_jit", altered_one)}[kind]


@pytest.mark.parametrize("cell,fault", [
    ("kaist02-1m.stream20", "half_batch"), ("kaist02-1m.stream20", "altered"),
    ("kaist02-1m.live1", "unchanged"), ("kaist02-1m.live1", "altered_one")])
def test_planted_frame_fault_is_not_correct(cell, fault, monkeypatch):
    from radarays_ros_tpu_torch.sim import pipeline as P

    name, fn = _frames_fault(fault)
    monkeypatch.setattr(P, name, fn)
    traffic = tiny_traffic(SPEC.traffic(SPEC.workload(cell)["traffic"]))
    if traffic["batch"] == 1:
        traffic["check"]["frames"] = 64
    out = run_tiny(cell, seconds=0.5 if traffic["batch"] == 1 else 0.0,
                   traffic=traffic)
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell,fault", [
    ("kaist02-fit.adam60", "unchanged"), ("kaist02-fit.adam60", "half_batch"),
    ("kaist02-fit.adam60", "altered"), ("kaist02-fit.bbox60", "half_batch"),
    ("kaist02-fit.bbox60", "altered")])
def test_planted_fit_fault_is_not_correct(cell, fault, monkeypatch):
    """The faults a fit can have: Adam's state left unchanged (a zero
    gradient), half of the batch of frames left out of the objective, the
    objective's value altered by 10 % where it is produced. The black-box
    fit holds no state."""
    from radarays_ros_tpu_torch.opti import optimize as O

    if fault == "half_batch":
        real = O.default_objective

        def half(scene, cfg, poses, target, *, cone_draws=None, **kw):
            n = (poses.shape[0] + 1) // 2
            return real(scene, cfg, poses[:n], target[:n],
                        cone_draws=tuple(d[:n] for d in cone_draws), **kw)

        monkeypatch.setattr(O, "default_objective", half)
    elif cell.endswith("adam60"):
        real_vg = O.value_and_grad

        def vg(fn):
            inner = real_vg(fn)

            def call(z):
                loss, g = inner(z)
                if fault == "unchanged":
                    return loss, torch.zeros_like(g)
                return loss * 1.1, g
            return call

        monkeypatch.setattr(O, "value_and_grad", vg)
    else:
        real_c = O.compiled

        def comp(fn):
            inner = real_c(fn)
            return lambda *a: inner(*a) * 1.1

        monkeypatch.setattr(O, "compiled", comp)
    out = run_tiny(cell)
    assert not out["correct"], out["check"]


# ----------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark measures the card)")


@pytest.mark.cuda
def test_one_real_cell_on_the_card(card):
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "kaist02-1m.stream20", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu"


# ------------------------------------------------------- the reference

def _rays(verts, n: int = 1500, seed: int = 0):
    """Rays over a tiny scene: random ones, some level and some with a zero
    x component (the slab test's planes), and some from the soup's own
    vertices (hits at t = 0 on shared edges)."""
    g = torch.Generator().manual_seed(seed)
    o = torch.cat([torch.rand(n, 2, generator=g) * 80 - 40,
                   torch.rand(n, 1, generator=g) * 6], 1)
    d = torch.randn(n, 3, generator=g)
    d[:300, 2] = 0
    d[300:400, 0] = 0
    o[:150] = torch.as_tensor(verts[:150, 0])
    return o, d / d.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_culled_trace_equals_the_whole_soup(dtype):
    """Skipping the blocks a ray cannot hit changes no answer: the same
    hits, t, normals and objects as one block holding the whole soup,
    which tests every triangle."""
    from portbench.reference import frame as RF
    from portbench.scenes.urban import soup

    verts, obj, _ = soup(seed=3, n_buildings=400, extent=60.0,
                         clear_radius=10.0, ring_radius=25.0,
                         ring_half_width=6.0)
    o, d = (x.to(dtype) for x in _rays(verts))
    whole = RF.trace(RF.geometry(verts, obj, dtype, "cpu",
                                 block=verts.shape[0]), o, d)
    for block in (16, 256):
        geo = RF.geometry(verts, obj, dtype, "cpu", block=block)
        assert geo.lo.shape[0] == -(-verts.shape[0] // block)
        culled = RF.trace(geo, o, d, rays=512)
        for a, b in zip(whole, culled):
            assert torch.equal(a, b)
    assert bool(whole[0].any()) and not bool(whole[0].all())


def test_reference_products_ignore_the_process_tf32_flags():
    from portbench.reference import frame as RF

    m, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, cd.allow_tf32)
    try:
        m.allow_tf32 = cd.allow_tf32 = True
        with RF.exact_matmul():
            assert not m.allow_tf32 and not cd.allow_tf32
        assert m.allow_tf32 and cd.allow_tf32
    finally:
        m.allow_tf32, cd.allow_tf32 = saved


def test_setup_s_leaves_out_the_reference_targets(monkeypatch):
    """A fit's targets are the reference's frames: their seconds are
    logged apart and not counted in setup_s."""
    real = RFit.Problem.targets

    def slow(self):
        time.sleep(5.0)
        return real(self)

    monkeypatch.setattr(RFit.Problem, "targets", slow)
    t0 = time.perf_counter()
    out = run_tiny("kaist02-fit.bbox60")
    assert out["correct"], out["check"]
    assert out["metrics"]["setup_s"]["value"] < (
        time.perf_counter() - t0) - 5.0
