"""The bench twins (radarays_ros_tpu_torch/bench/) run as a user runs them,
at small sizes on the CPU (`--device cpu`, the kernels' plain versions):
their JSON lines and keys, their outputs, the import guard (no JAX, nothing
of radarays_ros_tpu) and the card guard (no card and no --device cpu:
they raise). The comparisons with the JAX harnesses are in
tests/test_torch_bench.py.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from radarays_ros_tpu_torch.bench import common as C
from radarays_ros_tpu_torch.bench import headline as H

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
TWINS = ("headline", "engines", "profile_frame", "opti_scale", "multichip",
         "sweep_kernel_ab", "order_ab", "chunksize_ab", "make_demo")
SMALL = dict(n_angles=16, n_cells=256, resolution=0.25, n_samples=4,
             trace_ray_block=128)
# bench.py:290-311's keys; the twin drops vs_baseline (a ratio against the
# TPU north star) and adds the kernels' launches and the timed batch count
REF_KEYS = {"metric", "value", "unit", "vs_baseline", "parity", "extra"}
REF_EXTRA = {"protocol", "fenced_best_hz", "fenced_trimmed_median_hz",
             "n_triangles", "mrays_per_sec", "rays_per_frame", "device",
             "trace_engine", "batch"}


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]


def test_headline_main_small(tmp_path, capsys):
    details_root = ROOT / "BENCH_DETAILS.json"
    before = hashlib.sha256(details_root.read_bytes()).hexdigest()
    path = tmp_path / "d" / "details.json"
    details = H.main(["--device", "cpu", "--details", str(path)],
                     headline=dict(n_buildings=30, extent=60.0),
                     companions=(("small_10k", dict(n_buildings=10,
                                                    extent=40.0)),),
                     cfg_overrides=SMALL,
                     parity_kw=dict(n_buildings=20, n_rays=4000))
    lines = _lines(capsys)
    assert len(lines) == 1
    line = lines[0]
    assert set(line) == REF_KEYS - {"vs_baseline"}
    assert set(line["extra"]) == REF_EXTRA | {"kernel_launches",
                                              "timed_batches"}
    assert line["metric"] == H.METRIC and line["unit"] == "Hz"
    assert line["parity"]["exact"] is True
    assert line["value"] > 0 and line["extra"]["fenced_best_hz"] > 0
    x = line["extra"]
    assert x["device"] == "cpu" and x["batch"] == 20
    assert x["timed_batches"] == 17
    assert x["rays_per_frame"] == 16 * 4 * 4
    assert set(x["kernel_launches"]) == set(C.KERNELS)
    # on the CPU the wrappers run their plain versions: no launch
    assert not any(x["kernel_launches"].values())
    on_disk = json.loads(path.read_text())
    assert on_disk == details and on_disk["headline"] == line
    assert on_disk["small_10k"]["sustained_hz"] > 0
    assert hashlib.sha256(details_root.read_bytes()).hexdigest() == before


def test_headline_companion_over_budget_is_skipped(tmp_path, capsys,
                                                   monkeypatch):
    monkeypatch.setenv("RADARAYS_BENCH_BUDGET_S", "0")
    details = H.main(["--device", "cpu", "--details",
                      str(tmp_path / "d.json")],
                     headline=dict(n_buildings=10, extent=40.0),
                     companions=(("huge_10m", dict(n_buildings=10)),),
                     cfg_overrides=SMALL,
                     parity_kw=dict(n_buildings=10, n_rays=800))
    assert "skipped" in details["huge_10m"]
    assert len(_lines(capsys)) == 1


def test_measure_scale_fetches_every_batch():
    b = C.build_benchmark(30, 60.0, cfg_overrides=SMALL, device="cpu")
    m = H.measure_scale(0, n_iters=3, batch=2, n_stream=4, scene=b,
                        device="cpu", seed=1)
    assert len(m["checksums"]) == m["timed_batches"] == 7
    assert all(s > 0 for s in m["checksums"])
    # fresh random inputs every batch
    assert len(set(m["checksums"])) > 1
    assert m["sustained_hz"] > 0 and m["best_hz"] >= m["trimmed_median_hz"]


def test_engines_agree_with_brute(capsys):
    from radarays_ros_tpu_torch.bench import engines as E

    b = C.build_benchmark(40, 60.0, device="cpu")
    o, d = C.on("cpu", *C.radar_fan(1200, el_std=0.03))
    engines = ["brute", "sweep", "kernel", "mxu", "auto"]
    res = E.trace_engines(b.scene, o, d, engines, torch.device("cpu"), n=1)
    want = res["brute"]["result"]
    assert want.hit.any()
    for e in engines[1:]:
        got = res[e]["result"]
        assert torch.equal(got.hit, want.hit), e
        assert torch.equal(got.obj_id, want.obj_id), e
        assert res[e]["seconds"] > 0
    recs = E.saturated(b.scene, torch.device("cpu"), n_rays=2000)
    assert [r["set"] for r in recs] == [s for s, _, _ in E.SAT_SETS]
    for r in recs:
        assert r["mrays_per_sec"] > 0 and 0 < r["hit_rate"] <= 1
        assert r["peak_mib"] is None          # no device memory on the CPU
    assert _lines(capsys) == recs


def test_profile_frame_reads_only_its_own_run(capsys):
    from radarays_ros_tpu_torch.bench import profile_frame as PF

    argv = ["--device", "cpu", "--buildings", "30", "--top", "5"]
    first = PF.main(argv, cfg_overrides=SMALL)
    second = PF.main(argv, cfg_overrides=SMALL)
    for p in (first, second):
        assert p["top_groups"] and p["top_ops"]
        assert p["device_total_ms"] > 0 and p["checksum"] > 0
        # one batch: one binning call, however many runs came before
        assert p["bin_calls"] == 1
        assert p["device_idle_share"] is None       # no device: not measured
    assert len(_lines(capsys)) == 2


@pytest.mark.parametrize("name,group", [
    ("(anonymous namespace)::sweep_kernel(int const*, float*)",
     "sweep_kernel"),
    ("void (anonymous namespace)::prep_hier_kernel(int const*)",
     "prep_hier_kernel"),
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel>",
     "at::native::elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("aten::index", "aten::index")])
def test_profile_group_names(name, group):
    from radarays_ros_tpu_torch.bench.profile_frame import group_name

    assert group_name(name) == group


def test_multichip_two_cpu_ranks_match_one_process(capsys):
    from radarays_ros_tpu_torch.bench import multichip as MC
    from radarays_ros_tpu_torch.geom.scene import scene_tensors
    from radarays_ros_tpu_torch.parallel.dryrun import baked
    from radarays_ros_tpu_torch.sim.config import params_from_numpy
    from radarays_ros_tpu_torch.sim.pipeline import simulate_frame

    out = MC.main(["--cpu-ranks", "2", "--iters", "1"])
    lines = _lines(capsys)
    assert [ln.get("bench") for ln in lines] == [
        None, "frame_sharded_1d_az", "frame_sharded_2d_az_smp"]
    assert lines[0]["ranks"] == 2 and lines[0]["backend"] == "gloo"
    assert all(ln["ranks_share_one_card"] is False for ln in lines)
    assert all(ln["best_hz"] > 0 for ln in lines[1:])
    host, params_np, cfg, poses = MC.setup(True, 800)
    params = params_from_numpy(*params_np)
    st = baked(scene_tensors(host, "cpu"), params, cfg)
    inp = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, tuple)
           else tuple(torch.from_numpy(x) for x in v)
           for k, v in MC.inputs(cfg, 0).items()}
    one = simulate_frame(st, params, cfg, torch.from_numpy(poses), **inp)
    ref = one.image_float.double().numpy()
    assert ref.max() > 0
    for name in ("az", "az_smp"):
        u8, img, max_val = out[name]["frame"]
        np.testing.assert_allclose(img.astype(np.float64), ref,
                                   atol=2e-4 * ref.max(), rtol=2e-3)
        np.testing.assert_allclose(max_val, one.max_val.numpy(), rtol=1e-4,
                                   atol=1e-6)
        diff = np.abs(u8.astype(int) - one.image_u8.numpy().astype(int))
        assert (diff <= 1).mean() >= 0.995 and diff.max() <= 3
    # the azimuth layout is the one-process frame bit for bit
    assert np.array_equal(out["az"]["frame"][1], one.image_float.numpy())


def test_make_demo_pngs_read_back(tmp_path, capsys):
    from radarays_ros_tpu_torch.bench import make_demo as MD
    from radarays_ros_tpu_torch.io.image_io import read_png_gray

    rec = MD.main(["--device", "cpu", "--out", str(tmp_path)],
                  scene_kw=dict(n_blocks=2, street_w=12.0, block_len=18.0,
                                seed=3, clutter=0.5),
                  cfg_overrides=dict(n_angles=32, n_cells=512,
                                     resolution=0.25, n_samples=4))
    polar, cart = (Path(f) for f in rec["files"])
    assert polar.parent == tmp_path and cart.parent == tmp_path
    img = read_png_gray(polar)
    assert img.shape == (512, 32) and img.max() > 0
    assert np.array_equal(MD.read_back(polar), img)
    rgb = MD.read_back(cart)
    assert rgb.shape == (800, 800, 3) and rgb.any()
    assert "not in the repository" in rec["panel"]
    assert _lines(capsys) == [rec]


def test_sweep_kernel_ab_stages_small(capsys):
    from radarays_ros_tpu_torch.bench import sweep_kernel_ab as SK

    recs = SK.main(["--device", "cpu", "--buildings", "30"],
                   parity_kw=dict(n_buildings=20, n_rays=4000),
                   marginal_kw=dict(n_rays=4000, k=3),
                   frame_kw=dict(n_iters=2, batch=2, n_stream=2),
                   cfg_overrides=SMALL)
    assert [r["stage"] for r in recs] == ["env", "parity", "trace_marginal",
                                          "frame_1m"]
    assert recs[1]["exact"] is True
    assert recs[2]["t1_ms"] > 0 and "t3_ms" in recs[2]
    assert recs[3]["sustained_hz"] > 0
    assert _lines(capsys) == recs


def test_chunksize_ab_records_a_refused_size(capsys, monkeypatch):
    """A size K1's wrapper refuses (ChunkSizeRefused before any launch) is
    recorded and the A/B goes on; a size it takes runs the stages."""
    from radarays_ros_tpu_torch.bench import chunksize_ab as CA
    from radarays_ros_tpu_torch.bench import sweep_kernel_ab as SK
    from radarays_ros_tpu_torch.trace.cuda_trace import ChunkSizeRefused

    real = SK.stages

    def stages(dev, *, chunk_size, **kw):
        if chunk_size == 64:
            raise ChunkSizeRefused("sweep: chunk size 64 refused")
        return real(dev, chunk_size=chunk_size, **kw)

    monkeypatch.setattr(SK, "stages", stages)
    recs = CA.main(["--hw", "--device", "cpu", "--buildings", "30",
                    "--sizes", "64,128", "--skip-marginal", "--skip-frame"],
                   parity_kw=dict(n_buildings=20, n_rays=4000))
    assert [(r["stage"], r.get("chunk_size")) for r in recs] == [
        ("env", None), ("refused", 64), ("parity", 128)]
    assert recs[2]["exact"] is True
    capsys.readouterr()


@pytest.mark.parametrize("error", [
    ValueError("sweep: inconsistent shapes"),
    ValueError("sweep: coef must be 16-byte aligned"),
    RuntimeError("parity failed")])
def test_chunksize_ab_fails_on_any_other_error(error, capsys, monkeypatch):
    """Only a shared-memory refusal is recorded: any other error at a size
    (a shape or alignment fault, a failed gate) fails the A/B."""
    from radarays_ros_tpu_torch.bench import chunksize_ab as CA
    from radarays_ros_tpu_torch.bench import sweep_kernel_ab as SK

    def stages(dev, **kw):
        raise error

    monkeypatch.setattr(SK, "stages", stages)
    with pytest.raises(type(error), match=str(error)):
        CA.main(["--hw", "--device", "cpu", "--sizes", "128"])
    capsys.readouterr()


@pytest.mark.parametrize("name", TWINS + ("common",))
def test_twin_imports_without_jax_or_the_reference(name):
    """Each bench module imports with JAX and the JAX package blocked (and
    the reference's bench.py and benchmarks/)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, fullname, path=None, target=None):\n"
        "        top = fullname.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'radarays_ros_tpu', 'bench',\n"
        "                   'benchmarks'):\n"
        "            raise ImportError(f'blocked: {fullname}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.modules['jax'] = None\n"
        f"import radarays_ros_tpu_torch.bench.{name} as m\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'radarays_ros_tpu') and sys.modules[k] is not None]\n"
        "assert not bad, bad\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr


@pytest.mark.parametrize("name", TWINS)
def test_twin_raises_without_a_card(name, monkeypatch):
    import importlib

    mod = importlib.import_module(f"radarays_ros_tpu_torch.bench.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"order_ab": ["--proxy"], "chunksize_ab": ["--proxy"]}.get(
        name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
