"""The port's command line (radarays_ros_tpu_torch.io.cli) end to end on a
tiny mesh with --device cpu, against the JAX package's CLI run in the same
process, and the debug-ray tracer (viz/rays.py) against the reference's.

Frames: the presets make neither package draw anything that matters —
beam width 0 (every cone sample is exactly the beam axis in both packages)
and no ambient noise — so the two CLIs render the same frames up to the
engines' float differences. The CLI writes u8 frames only, so they are
held to the u8 clause of the frame contract (tests/test_oracle.py:70-87:
within 1 on >= 99.5% of pixels, never more than 3 apart); image_float and
max_val of the same path are held in tests/test_torch_io.py and
tests/test_torch_pipeline.py.
"""

import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from radarays_ros_tpu.geom.primitives import make_box
from radarays_ros_tpu.io import cli as jcli
from radarays_ros_tpu.io.config import (save_preset as j_save_preset,
                                        load_scene_config as j_load_scene)
from radarays_ros_tpu.io.trajectory import Trajectory
from radarays_ros_tpu.sim.config import RadarModelConfig as JxConfig

from radarays_ros_tpu_torch.io import cli as pcli
from radarays_ros_tpu_torch.io.image_io import write_png_gray

torch.set_num_threads(2)

def _materials(wall_amb: float, pillar_vel: float = 0.0) -> str:
    rows = [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
            dict(velocity=0.0, ambient=wall_amb, diffuse=0.2,
                 specular=200.0),
            dict(velocity=pillar_vel, ambient=0.6, diffuse=0.3,
                 specular=60.0)]
    body = "".join(
        f"- velocity: {r['velocity']}\n  ambient: {r['ambient']}\n"
        f"  diffuse: {r['diffuse']}\n  specular: {r['specular']}\n"
        for r in rows)
    return (f"materials:\n{body}material_id_air: 0\n"
            "object_materials: [1, 2]\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A closed room with a pillar as OBJ, scene configs, presets and a
    circular trajectory."""
    d = tmp_path_factory.mktemp("cli")
    walls = make_box((0, 0, 0), (20.0, 20.0, 6.0))[:, ::-1, :]
    pillar = make_box((4.0, 1.0, 0), (1.5, 1.5, 6.0))
    lines, vi = [], 1
    for name, tris in (("walls", walls), ("pillar", pillar)):
        lines.append(f"o {name}")
        for t in tris:
            lines += [f"v {v[0]} {v[1]} {v[2]}" for v in t]
            lines.append(f"f {vi} {vi + 1} {vi + 2}")
            vi += 3
    (d / "scene.obj").write_text("\n".join(lines) + "\n")
    (d / "true.yaml").write_text(_materials(0.9))
    (d / "wrong.yaml").write_text(_materials(0.3))
    (d / "refr.yaml").write_text(_materials(0.7, pillar_vel=0.1))
    base = dict(n_angles=16, n_cells=128, n_samples=2, n_reflections=2,
                resolution=0.25, ambient_noise=0, signal_denoising=1,
                signal_denoising_triangular_width=5,
                signal_denoising_triangular_mode=0.4, z_offset=1.0)
    j_save_preset(d / "preset.yaml", JxConfig(**base), beam_width_deg=0.0)
    j_save_preset(d / "motion.yaml", JxConfig(**base, include_motion=True),
                  beam_width_deg=0.0)
    Trajectory.circular(radius=2.0, n=6, period=3.0).save_tum(d / "traj.txt")
    return d


def _run(main, argv, capsys):
    rc = main([str(a) for a in argv])
    return rc, capsys.readouterr().out


def _frames(d):
    return [np.load(p) for p in sorted(d.glob("frame_*.npy"))]


def _assert_u8_contract(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert want.max() > 0
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= 0.995, f"{(diff > 1).sum()} px"
    assert diff.max() <= 3


def _segments_close(got, want):
    """Debug-ray segments: the same in order, bounce, kind, medium and
    material, positions and energies within 1e-4."""
    assert got["n_rays"] == want["n_rays"]
    assert len(got["segments"]) == len(want["segments"]) > 0
    for a, b in zip(got["segments"], want["segments"]):
        for k in ("bounce", "kind", "medium", "material_id"):
            assert a[k] == b[k], (k, a, b)
        np.testing.assert_allclose(a["start"] + a["end"] + [a["energy"]],
                                   b["start"] + b["end"] + [b["energy"]],
                                   rtol=0, atol=1e-4)


def test_info_prints_the_reference_lines(files, capsys):
    argv = ["info", "--mesh", files / "scene.obj", "--chunk-size", "8"]
    rc, out = _run(pcli.main, argv, capsys)
    jrc, jout = _run(jcli.main, argv, capsys)
    assert rc == jrc == 0
    assert out == jout
    assert "chunks:    8 x 8" in out and "1: pillar (12 tris)" in out


@pytest.mark.parametrize("mode", ["loop", "motion", "batch"])
def test_simulate_frames_meet_the_contract_against_jax_cli(files, tmp_path,
                                                           capsys, mode):
    """The per-frame loop (Radar.simulate_image), include_motion per-azimuth
    poses (poses_for_scan) and the batched mode (simulate_frames) against
    the JAX CLI's frames; the batched frames are also bit-identical to an
    in-process simulate_frames with the same poses and generator seed."""
    preset = files / ("motion.yaml" if mode == "motion" else "preset.yaml")
    common = ["simulate", "--mesh", files / "scene.obj", "--chunk-size", 8,
              "--preset", preset, "--scene-config", files / "true.yaml",
              "--traj", files / "traj.txt", "--frames", 3, "--format", "npy",
              "--seed", 4]
    if mode == "batch":
        common += ["--batch", 2, "--synced"]
    rc, out = _run(pcli.main, common + ["--out", tmp_path / "p",
                                        "--device", "cpu"], capsys)
    assert rc == 0
    assert re.search(r"3 frames (\(batched x2\) )?in [\d.]+ s -> [\d.]+ Hz",
                     out)
    jrc, _ = _run(jcli.main, common + ["--out", tmp_path / "j"], capsys)
    assert jrc == 0
    got, want = _frames(tmp_path / "p"), _frames(tmp_path / "j")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_u8_contract(g, w)
    if mode != "batch":
        return
    from radarays_ros_tpu_torch.geom.mesh import load_mesh
    from radarays_ros_tpu_torch.io.trajectory import Trajectory as PTraj
    from radarays_ros_tpu_torch.sim.pipeline import simulate_frames
    from radarays_ros_tpu_torch.sim.radar import Radar

    scene = load_mesh(files / "scene.obj", chunk_size=8)
    args = pcli.build_parser().parse_args(
        [str(a) for a in common + ["--device", "cpu"]])
    cfg, params = pcli._load_cfg_params(args, scene)
    radar = Radar(scene, params, cfg, seed=4, device="cpu")
    tr = PTraj.load_tum(files / "traj.txt")
    gen = torch.Generator().manual_seed(4)
    stamps = np.concatenate([tr.stamps[:3], tr.stamps[2:3]])
    imgs = [simulate_frames(radar._scene_tensors, radar.params, radar.cfg,
                            torch.from_numpy(tr.poses_at(stamps[b:b + 2])),
                            generator=gen).image_u8.numpy()
            for b in (0, 2)]
    for k, g in enumerate(got):
        np.testing.assert_array_equal(g, imgs[k // 2][k % 2])


@pytest.mark.parametrize("engine", ["brute", "mxu"])
def test_simulate_on_engines_without_aux(files, tmp_path, capsys, engine):
    """simulate --engine brute|mxu: engines that return no baked material
    (Radar bakes it for the sweep engines) render the JAX CLI's frames
    under the u8 contract; brute used to fail at the first frame. The
    reference is the JAX CLI on its culled engine: the reference's brute
    misses the rays aimed exactly at the room's corners (its Moller-
    Trumbore test is strict on the edge two walls share), where its plane
    engines, and every engine of the port, hit."""
    common = ["simulate", "--mesh", files / "scene.obj", "--chunk-size", 8,
              "--preset", files / "preset.yaml", "--scene-config",
              files / "refr.yaml", "--frames", 2, "--format", "npy"]
    rc, _ = _run(pcli.main, common + ["--engine", engine, "--out",
                                      tmp_path / "p", "--device", "cpu"],
                 capsys)
    assert rc == 0
    jrc, _ = _run(jcli.main, common + ["--engine", "culled", "--out",
                                       tmp_path / "j"], capsys)
    assert jrc == 0
    got, want = _frames(tmp_path / "p"), _frames(tmp_path / "j")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_u8_contract(g, w)


def test_optimize_initial_psnr_matches_jax_cli(files, tmp_path, capsys):
    """Both CLIs score the same start against the same target (printed at
    3 decimals, so the two readings may straddle a rounding boundary)."""
    rc, _ = _run(pcli.main, [
        "simulate", "--mesh", files / "scene.obj", "--chunk-size", 8,
        "--preset", files / "preset.yaml", "--scene-config",
        files / "true.yaml", "--format", "npy", "--out", tmp_path / "t",
        "--device", "cpu"], capsys)
    assert rc == 0
    argv = ["optimize", "--mesh", files / "scene.obj", "--chunk-size", 8,
            "--preset", files / "preset.yaml", "--scene-config",
            files / "wrong.yaml", "--target", tmp_path / "t/frame_00000.npy",
            "--steps", 0]
    rc, out = _run(pcli.main, argv + ["--device", "cpu"], capsys)
    jrc, jout = _run(jcli.main, argv, capsys)
    assert rc == jrc == 0

    def initial(text):
        return float(re.search(r"initial PSNR ([-\d.]+) dB", text).group(1))

    assert initial(out) < 100.0                  # the start is off target
    assert abs(initial(out) - initial(jout)) <= 1e-3 + 1e-9


def test_optimize_writes_checkpoint_and_config(files, tmp_path, capsys):
    """A few gradient steps, a resumable checkpoint and an --out-config the
    reference's loader reads; a second run resumes from the checkpoint."""
    from radarays_ros_tpu_torch.io.config import load_scene_config

    rc, _ = _run(pcli.main, [
        "simulate", "--mesh", files / "scene.obj", "--chunk-size", 8,
        "--preset", files / "preset.yaml", "--scene-config",
        files / "true.yaml", "--format", "png", "--out", tmp_path / "t",
        "--device", "cpu"], capsys)
    assert rc == 0
    argv = ["optimize", "--mesh", files / "scene.obj", "--chunk-size", 8,
            "--preset", files / "preset.yaml", "--scene-config",
            files / "wrong.yaml", "--target", tmp_path / "t/frame_00000.png",
            "--steps", 4, "--lr", 0.1, "--checkpoint", tmp_path / "ck.npz",
            "--out-config", tmp_path / "fit.yaml", "--device", "cpu"]
    rc, out = _run(pcli.main, argv, capsys)
    assert rc == 0 and (tmp_path / "ck.npz").exists()
    final = float(re.search(r"final PSNR ([-\d.]+) dB over 4 evaluations",
                            out).group(1))
    assert np.isfinite(final)
    fitted, jfitted = (load_scene_config(tmp_path / "fit.yaml"),
                       j_load_scene(tmp_path / "fit.yaml"))
    for a, b in zip(fitted.materials, jfitted.materials):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(fitted.object_materials, [1, 2])
    resume = argv[:argv.index("--steps")] + [
        "--steps", 2, "--method", "black-box", "--checkpoint",
        tmp_path / "ck.npz", "--device", "cpu"]
    rc, out = _run(pcli.main, resume, capsys)
    assert rc == 0 and "resumed checkpoint at step 4" in out
    assert re.search(r"final PSNR [-\d.]+ dB over \d+ evaluations", out)


def test_preset_aux_flag_does_not_reach_unbaked_scenes(files, tmp_path,
                                                       capsys):
    """A preset dumped from a running Radar's config carries
    trace_aux_baked: true, but optimize and eval upload unbaked scenes:
    the flag is cleared on load (else every hit would read material 0),
    so the score is the same as under the preset without it."""
    from radarays_ros_tpu_torch.io.config import load_preset, save_preset

    cfg, bw, _ = load_preset(files / "preset.yaml")
    save_preset(tmp_path / "baked.yaml", cfg.replace(trace_aux_baked=True),
                beam_width_deg=bw)
    common = ["--mesh", files / "scene.obj", "--chunk-size", 8,
              "--device", "cpu"]
    rc, _ = _run(pcli.main, ["simulate", *common, "--preset",
                             files / "preset.yaml", "--scene-config",
                             files / "true.yaml", "--format", "npy",
                             "--out", tmp_path / "t"], capsys)
    assert rc == 0
    scores = []
    for preset in (files / "preset.yaml", tmp_path / "baked.yaml"):
        rc, out = _run(pcli.main, [
            "optimize", *common, "--preset", preset, "--scene-config",
            files / "wrong.yaml", "--target", tmp_path / "t/frame_00000.npy",
            "--steps", 0], capsys)
        assert rc == 0
        scores.append(re.search(r"initial PSNR ([-\d.]+) dB", out).group(1))
    assert scores[0] == scores[1]


def test_render_output_is_byte_identical(tmp_path, capsys):
    rng = np.random.default_rng(3)
    polar = (rng.random((120, 48)) ** 5 * 255).astype(np.uint8)
    other = (rng.random((90, 70)) ** 3 * 255).astype(np.uint8)
    write_png_gray(tmp_path / "polar.png", polar)
    write_png_gray(tmp_path / "other.png", other)
    outs = {}
    for who, main in (("port", pcli.main), ("ref", jcli.main)):
        d = tmp_path / who
        d.mkdir()
        argv = ["render", "--frame", tmp_path / "polar.png", "--out",
                d / "cart.png", "--color", "--stretch", "--size", 96,
                "--max-range", 5.0, "--against-polar", tmp_path / "other.png",
                "--against-crop", "0,0,40,60", "--against-image",
                tmp_path / "other.png", "--against-center", "30,40",
                "--stats-out", d / "stats.json"]
        rc, out = _run(main, argv, capsys)
        assert rc == 0
        outs[who] = out.replace(str(d), "DIR")
    assert outs["port"] == outs["ref"]
    for name in ("cart.png", "stats.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    rc, _ = _run(pcli.main, ["render", "--frame", tmp_path / "polar.png",
                             "--out", tmp_path / "gray.png"], capsys)
    assert rc == 0 and (tmp_path / "gray.png").exists()


def test_argument_errors(files, tmp_path, capsys, monkeypatch):
    """--synced without --traj returns 2 before any scene is loaded; a CUDA
    device that is not there is an error, never a CPU fallback; the
    reference's mxu engine gives the sweep's rays and its explore command
    the reference's data (both refused before they were ported)."""
    from radarays_ros_tpu_torch.geom import mesh as pmesh

    def no_load(*a, **k):
        raise AssertionError("the scene was loaded")

    monkeypatch.setattr(pmesh, "load_mesh", no_load)
    rc, _ = _run(pcli.main, ["simulate", "--mesh", files / "scene.obj",
                             "--synced", "--device", "cpu"], capsys)
    assert rc == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("simulate", "rays", "optimize"):
        argv = [cmd, "--mesh", files / "scene.obj"]
        if cmd == "optimize":
            argv += ["--target", tmp_path / "none.npy"]
        assert pcli.main([str(a) for a in argv]) == 2
        assert "no CUDA device" in capsys.readouterr().err
    monkeypatch.undo()
    rays = {}
    for engine in ("mxu", "sweep"):
        rc, out = _run(pcli.main, [
            "rays", "--mesh", files / "scene.obj", "--chunk-size", 8,
            "--scene-config", files / "refr.yaml", "--bounces", 3,
            "--all-directions", "--n-fan", 24, "--engine", engine, "--compact", "--device",
            "cpu"], capsys)
        assert rc == 0
        rays[engine] = json.loads(out)
    _segments_close(rays["mxu"], rays["sweep"])
    with pytest.raises(SystemExit):             # --panel is required
        pcli.main(["explore"])
    capsys.readouterr()
    rc, out = _run(pcli.main, ["explore", "--panel", "fresnel", "--json",
                               tmp_path / "p.json", "--device", "cpu"],
                   capsys)
    assert rc == 0
    assert jcli.main(["explore", "--panel", "fresnel", "--json",
                      str(tmp_path / "j.json")]) == 0
    np.testing.assert_allclose(
        *(np.asarray(json.loads((tmp_path / f).read_text())["reflectance"])
          for f in ("p.json", "j.json")), rtol=1e-6, atol=1e-6)
    rc = pcli.main(["eval", "--real", str(tmp_path)])
    assert rc == 2


def test_eval_synced_and_dirs(files, tmp_path, capsys):
    """eval against a live simulation at the stamps of MulRan-style frame
    names (the frames the CLI itself rendered), and dir-vs-dir."""
    rc, _ = _run(pcli.main, [
        "simulate", "--mesh", files / "scene.obj", "--chunk-size", 8,
        "--preset", files / "preset.yaml", "--scene-config",
        files / "true.yaml", "--traj", files / "traj.txt", "--synced",
        "--frames", 3, "--format", "npy", "--out", tmp_path / "render",
        "--device", "cpu"], capsys)
    assert rc == 0
    tr = Trajectory.load_tum(files / "traj.txt")
    real = tmp_path / "real"
    real.mkdir()
    for i, f in enumerate(sorted((tmp_path / "render").glob("*.npy"))):
        ns = int((tr.stamps[i] + 0.013) * 1e9) + 1_600_000_000_000_000_000
        np.save(real / f"{ns}.npy", np.load(f))
    rc, out = _run(pcli.main, [
        "eval", "--real", real, "--mesh", files / "scene.obj",
        "--chunk-size", 8, "--preset", files / "preset.yaml",
        "--scene-config", files / "true.yaml", "--traj", files / "traj.txt",
        "--metrics", "psnr,mae", "--out", tmp_path / "report.json",
        "--device", "cpu"], capsys)
    assert rc == 0 and "sync error" in out
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["mode"] == "real_vs_sim_synced" and report["n_frames"] == 3
    assert report["out_of_traj"] == 3          # stamps are epoch seconds
    rc, out = _run(pcli.main, ["eval", "--real", tmp_path / "render",
                               "--sim", tmp_path / "render", "--metrics",
                               "psnr,ssim,mae"], capsys)
    assert rc == 0
    assert re.search(r"mae: mean 0\.0000 .* over 3 frames", out)


def test_rays_command(files, tmp_path, capsys):
    base = ["rays", "--mesh", files / "scene.obj", "--chunk-size", 8,
            "--scene-config", files / "refr.yaml", "--device", "cpu"]
    rc, out = _run(pcli.main, base + ["--bounces", 3, "--out",
                                      tmp_path / "r.json"], capsys)
    assert rc == 0 and "segments" in out
    data = json.loads((tmp_path / "r.json").read_text())
    assert data["n_rays"] == 1 and data["segments"][0]["medium"] == "air"
    rc, _ = _run(pcli.main, base + ["--bounces", 1, "--spin", 3,
                                    "--yaw-increment", 0.5, "--out",
                                    tmp_path / "s.json"], capsys)
    data = json.loads((tmp_path / "s.json").read_text())
    assert rc == 0 and data["n_rays"] == 3
    assert sorted({s["yaw"] for s in data["segments"]}) == [0.0, 0.5, 1.0]
    rc, out = _run(pcli.main, base + ["--cone", "--bounces", 2, "--compact",
                                      "--engine", "pallas3"], capsys)
    assert rc == 0 and json.loads(out)["n_rays"] == 10
    monkey_argv = ["ray-reflection-test"] + [str(a) for a in base[1:]] + [
        "--bounces", 1, "--out", str(tmp_path / "e.json")]
    old = sys.argv
    try:
        sys.argv = [str(a) for a in monkey_argv]
        assert pcli.main_ray_reflection() == 0
    finally:
        sys.argv = old
    assert (tmp_path / "e.json").exists()


def test_cli_imports_neither_jax_nor_yaml():
    code = ("import sys, radarays_ros_tpu_torch.io.cli, "
            "radarays_ros_tpu_torch.viz, radarays_ros_tpu_torch.opti.evaluate;"
            " bad = {'jax', 'yaml', 'radarays_ros_tpu', 'PIL'} & "
            "set(sys.modules); assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
