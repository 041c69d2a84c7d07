"""The port's IO layer (radarays_ros_tpu_torch.io: YAML configs,
trajectories, PNG frames, real-frame sequences), cartesian views,
evaluation, profiling and the Radar front-end's pose fallback, against the
JAX package run on CPU.

NumPy parts must be bit-equal; torch parts are held at 1e-6. The YAML
reader and writer of the port are held against PyYAML both ways. The
per-azimuth frame (include_motion poses) is held against the reference's
frame under the frame contract of tests/test_oracle.py:70-87.
"""

import dataclasses
import json
import struct
import types
import zlib

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from radarays_ros_tpu.io import config as jcfgio
from radarays_ros_tpu.io import image_io as jimg
from radarays_ros_tpu.io import realdata as jreal
from radarays_ros_tpu.io import trajectory as jtraj
from radarays_ros_tpu.sim import config as JCFG
from radarays_ros_tpu.utils import transforms as jtf
from radarays_ros_tpu.viz import cartesian as jcart

from radarays_ros_tpu_torch.io import config as pcfgio
from radarays_ros_tpu_torch.io import image_io as pimg
from radarays_ros_tpu_torch.io import realdata as preal
from radarays_ros_tpu_torch.io import trajectory as ptraj
from radarays_ros_tpu_torch.sim.config import RadarModelConfig, port_engine
from radarays_ros_tpu_torch.utils import transforms as ptf
from radarays_ros_tpu_torch.viz import cartesian as pcart

from test_io import DYNCFG_YAML, PARALLEL_YAML, STRUCTURED_YAML

torch.set_num_threads(2)


# ---------------------------------------------------------------- YAML

def _same_materials(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("text", [STRUCTURED_YAML, PARALLEL_YAML],
                         ids=["structured", "parallel"])
def test_scene_config_texts_match_reference(tmp_path, text):
    p = tmp_path / "scene.yaml"
    p.write_text(text)
    got, want = pcfgio.load_scene_config(p), jcfgio.load_scene_config(p)
    _same_materials(got.materials, want.materials)
    np.testing.assert_array_equal(got.object_materials,
                                  want.object_materials)
    assert got.object_materials.dtype == np.int32
    assert got.material_id_air == want.material_id_air
    assert got.raw == want.raw


def test_dyncfg_preset_matches_reference(tmp_path):
    p = tmp_path / "preset.yaml"
    p.write_text(DYNCFG_YAML)
    cfg, bw, flat = pcfgio.load_preset(p)
    jcfg, jbw, jflat = jcfgio.load_preset(p)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert bw == jbw == 10.0 and flat == jflat
    assert pcfgio.load_yaml(p) == jcfgio.load_yaml(p)


def test_files_each_package_writes_load_equal_in_both(tmp_path):
    """save_preset / save_scene_config of either package, read by both
    loaders (the port's reader and the reference's PyYAML loader) to equal
    configs and materials."""
    from radarays_ros_tpu_torch.sim.config import Materials

    entries = [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
               dict(velocity=1e-5, ambient=0.85, diffuse=0.15,
                    specular=900.0),
               dict(velocity=0.12, ambient=0.1, diffuse=0.6, specular=3e3)]
    kw = dict(n_samples=77, signal_max=99.5, include_motion=True,
              reflection_model="cook_torrance", trace_k_chunks=12,
              trace_scene_axis="scene", trace_two_phase_cap=75.0,
              resolution=0.0595238)
    writers = {
        "port": (lambda p: pcfgio.save_preset(p, RadarModelConfig(**kw), 3.5),
                 lambda p: pcfgio.save_scene_config(
                     p, Materials.from_list(entries), [1, 2, 0], 0)),
        "ref": (lambda p: jcfgio.save_preset(p, JCFG.RadarModelConfig(**kw),
                                             3.5),
                lambda p: jcfgio.save_scene_config(
                    p, JCFG.Materials.from_list(entries), [1, 2, 0], 0)),
    }
    texts = {}
    for who, (w_preset, w_scene) in writers.items():
        w_preset(tmp_path / f"{who}_p.yaml")
        w_scene(tmp_path / f"{who}_s.yaml")
        texts[who] = [(tmp_path / f"{who}_{k}.yaml").read_text()
                      for k in "ps"]
        for k in "ps":
            path = tmp_path / f"{who}_{k}.yaml"
            assert pcfgio.load_yaml(path) == jcfgio.load_yaml(path)
        cfg, bw, _ = pcfgio.load_preset(tmp_path / f"{who}_p.yaml")
        jcfg, jbw, _ = jcfgio.load_preset(tmp_path / f"{who}_p.yaml")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg == RadarModelConfig(**kw) and bw == jbw == 3.5
        sc = pcfgio.load_scene_config(tmp_path / f"{who}_s.yaml")
        jsc = jcfgio.load_scene_config(tmp_path / f"{who}_s.yaml")
        _same_materials(sc.materials, jsc.materials)
        np.testing.assert_array_equal(sc.object_materials, [1, 2, 0])
    # the port lays the files out as PyYAML's safe_dump does
    assert texts["port"] == texts["ref"]


def test_velocity_table_matches_reference(tmp_path):
    p = tmp_path / "radar.yaml"
    p.write_text("velocities: [0.3, 0.001, 0.05]  # m/ns\n")
    np.testing.assert_array_equal(pcfgio.velocity_table(p),
                                  jcfgio.velocity_table(p))


@pytest.mark.parametrize("text", [
    "a: 1\nb:\n  - x\n  - y: [1, 2.5, 'q', \"r\\tz\", ~, yes]\n    z: null\n",
    "- &anc !!python/object/new:pkg.Cls\n  dictitems:\n    k: 0x1F\n"
    "  state: []\n- *anc\n- {}\n- []\n- 1.0e-05\n- 1e5\n- .inf\n- -7\n",
    "--- \n# comment\nkey: 'it''s # not a comment'  # but this is\n"
    "seq:\n- - 1\n  - 2\n- 3\nempty:\nlast: 017\n",
], ids=["block", "tags_anchors", "comments_nested"])
def test_yaml_reader_equals_pyyaml(text):
    class Loader(yaml.SafeLoader):
        pass

    Loader.add_multi_constructor("tag:yaml.org,2002:python/object/new:",
                                 jcfgio._config_tag)
    got = pcfgio.parse_yaml(text)
    want = yaml.load(text, Loader=Loader)
    assert got == want
    assert pcfgio.parse_yaml(pcfgio.dump_yaml(got, sort_keys=False)) == got
    assert yaml.safe_load(pcfgio.dump_yaml(got, sort_keys=False)) == got


@pytest.mark.parametrize("text", [
    "a: |\n  block\n", "a: {b: 1}\n", "a: [1,\n  2]\n", "a: 2001-12-14\n",
    "a: !!binary abc\n", "a: b\n  c\n", "? a\n: b\n", "a: 1\n---\nb: 2\n",
    "a: *nowhere\n", "<<: 1\n", "a:\n\tb: 1\n", "a: 'open\n"])
def test_yaml_reader_refuses_the_unsupported(text):
    with pytest.raises(pcfgio.YamlSubsetError):
        pcfgio.parse_yaml(text)


def test_from_dict_over_every_field():
    """RadarModelConfig.from_dict as the reference's: every field taken from
    the dict (a value unlike its default), unknown keys ignored."""
    d = {}
    for f in dataclasses.fields(RadarModelConfig):
        v = f.default
        if isinstance(v, bool):
            v = not v
        elif isinstance(v, int):
            v = v + 3
        elif isinstance(v, float):
            v = v + 0.5
        elif v is None:
            v = 7
        elif f.name == "trace_engine":
            v = "brute"
        elif f.name == "draw_method":
            v = "plain"
        else:
            v = v + "_x"
        d[f.name] = v
    d.update(groups={"x": 1}, unknown_key=5)
    cfg = RadarModelConfig.from_dict(d)
    jcfg = JCFG.RadarModelConfig.from_dict(d)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for f in dataclasses.fields(RadarModelConfig):
        assert getattr(cfg, f.name) == d[f.name] != f.default, f.name


@pytest.mark.parametrize("ref,port", [("pallas3", "kernel"),
                                      ("culled", "sweep"), ("auto", "auto"),
                                      ("brute", "brute"), ("kernel", "kernel"),
                                      ("sweep", "sweep"), ("mxu", "mxu")])
def test_reference_engine_names_map_to_the_port(ref, port):
    assert port_engine(ref) == port
    assert RadarModelConfig.from_dict({"trace_engine": ref}).trace_engine \
        == port


def test_mxu_engine_loads(tmp_path):
    """A reference preset on the dense engine, with its triangle chunk and
    the requeue cap, loads into the port as it is."""
    path = tmp_path / "preset.yaml"
    jcfgio.save_preset(path, JCFG.RadarModelConfig(
        trace_engine="mxu", trace_tri_chunk=1024, trace_two_phase_cap=40.0))
    cfg, _, _ = pcfgio.load_preset(path)
    assert (cfg.trace_engine, cfg.trace_tri_chunk,
            cfg.trace_two_phase_cap) == ("mxu", 1024, 40.0)


def test_unknown_draw_method_is_refused_at_load(tmp_path):
    """A preset whose draw_method neither package knows raises when it
    loads, not at the first frame."""
    path = tmp_path / "preset.yaml"
    jcfgio.save_preset(path, JCFG.RadarModelConfig(draw_method="splat"))
    with pytest.raises(ValueError, match="unknown draw_method 'splat'"):
        pcfgio.load_preset(path)


# ---------------------------------------------------------------- poses

def _traj_pair():
    rng = np.random.default_rng(4)
    stamps = np.sort(rng.uniform(0.0, 5.0, 9))
    q = rng.normal(size=(9, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[3] = -q[2]                                   # a hemisphere flip
    poses = np.concatenate([rng.normal(size=(9, 3)), q], 1)
    return (ptraj.Trajectory(stamps, poses), jtraj.Trajectory(stamps, poses))


def test_trajectory_matches_reference_bitwise(tmp_path):
    tr, jtr = _traj_pair()
    np.testing.assert_array_equal(tr.stamps, jtr.stamps)
    np.testing.assert_array_equal(tr.poses, jtr.poses)
    q = np.linspace(-1.0, 6.0, 31)
    np.testing.assert_array_equal(tr.poses_at(q), jtr.poses_at(q))
    for s in (-0.5, 0.0, 2.2, 7.0):
        np.testing.assert_array_equal(tr.pose_at(s), jtr.pose_at(s))
    np.testing.assert_array_equal(tr.poses_for_scan(1.3, 0.25, 32),
                                  jtr.poses_for_scan(1.3, 0.25, 32))
    tr.save_tum(tmp_path / "a.txt")
    jtr.save_tum(tmp_path / "b.txt")
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()
    back, jback = (ptraj.Trajectory.load_tum(tmp_path / "a.txt"),
                   jtraj.Trajectory.load_tum(tmp_path / "a.txt"))
    np.testing.assert_array_equal(back.poses, jback.poses)
    np.testing.assert_array_equal(back.stamps, jback.stamps)
    c, jc = (ptraj.Trajectory.circular(3.0, 12, 4.0, z=1.5),
             jtraj.Trajectory.circular(3.0, 12, 4.0, z=1.5))
    np.testing.assert_array_equal(c.poses, jc.poses)
    one = ptraj.Trajectory([1.0], tr.poses[:1])
    np.testing.assert_array_equal(
        one.poses_at([0.0, 9.0]),
        jtraj.Trajectory([1.0], tr.poses[:1]).poses_at([0.0, 9.0]))
    qa, qb = tr.poses[0, 3:].astype(np.float64), tr.poses[5, 3:]
    a = np.linspace(-0.5, 1.5, 9)
    np.testing.assert_array_equal(ptraj._slerp(qa, qb, a),
                                  jtraj._slerp(qa, qb, a))


def test_quat_from_euler_and_interpolate_poses():
    for rpy in ((0.0, 0.0, 0.0), (0.1, -0.4, 2.5), (np.pi, 0.2, -np.pi / 2)):
        np.testing.assert_array_equal(ptf.quat_from_euler(*rpy),
                                      jtf.quat_from_euler(*rpy))
    pa = ptf.make_pose([1.0, 2.0, 0.5], jtf.quat_from_euler(0.1, 0.0, 0.3))
    for qb in (jtf.quat_from_euler(0.0, 0.2, 1.9),
               -jtf.quat_from_euler(0.1, 0.0, 0.3),   # same rotation
               jtf.quat_from_euler(0.1, 0.0, 0.3 + 1e-7)):   # lerp branch
        pb = ptf.make_pose([-3.0, 0.5, 1.0], qb)
        alphas = np.arange(16, dtype=np.float32) / 16
        got = ptf.interpolate_poses(pa, pb, torch.from_numpy(alphas))
        want = np.asarray(jtf.interpolate_poses(pa, pb, jnp.asarray(alphas)))
        assert got.shape == (16, 7) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_extrapolate_pose_matches_reference():
    """Radar.extrapolate_pose on the same two-entry history, bit-equal."""
    from radarays_ros_tpu.sim.radar import Radar as JRadar
    from radarays_ros_tpu_torch.sim.radar import Radar

    p0 = ptf.make_pose([1.0, 0.0, 0.2], jtf.quat_from_euler(0, 0, 0.1))
    p1 = ptf.make_pose([1.5, 0.25, 0.2], jtf.quat_from_euler(0, 0.05, 0.4))
    for hist in ([(0.0, p0), (0.25, p1)], [(0.0, p0)], [(1.0, p0), (1.0, p1)]):
        for stamp in (None, 0.1, 0.5, 3.0):
            me = types.SimpleNamespace(_pose_history=hist, _last_pose=p1)
            np.testing.assert_array_equal(
                Radar.extrapolate_pose(me, stamp),
                JRadar.extrapolate_pose(me, stamp))


# ---------------------------------------------------------------- images

def _png_with_filters(img: np.ndarray) -> bytes:
    """An 8-bit grayscale PNG whose rows use every filter type 0-4."""
    h, w = img.shape
    rows, prev = [], np.zeros(w, np.int32)
    for y in range(h):
        cur = img[y].astype(np.int32)
        f = y % 5
        left = np.concatenate([[0], cur[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        if f == 0:
            pred = np.zeros(w, np.int32)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8)
                    .tobytes())
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_bytes_and_readers_match_reference(tmp_path):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    rgb = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    pimg.write_png_gray(tmp_path / "a.png", img)
    jimg.write_png_gray(tmp_path / "b.png", img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    pimg.write_png_rgb(tmp_path / "c.png", rgb)
    jimg.write_png_rgb(tmp_path / "d.png", rgb)
    assert (tmp_path / "c.png").read_bytes() == (tmp_path / "d.png").read_bytes()
    np.testing.assert_array_equal(pimg.read_png_gray(tmp_path / "a.png"), img)
    (tmp_path / "f.png").write_bytes(_png_with_filters(img))
    got = pimg.read_png_gray(tmp_path / "f.png")
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, jimg.read_png_gray(tmp_path / "f.png"))
    np.testing.assert_array_equal(pimg.read_image_gray(tmp_path / "f.png"),
                                  img)
    with pytest.raises(ValueError, match="only 8-bit grayscale"):
        pimg.read_png_gray(tmp_path / "c.png")
    for ext in ("png", "npy"):
        pimg.save_frame(tmp_path / f"g.{ext}", img)
        jimg.save_frame(tmp_path / f"h.{ext}", img)
        assert (tmp_path / f"g.{ext}").read_bytes() == \
            (tmp_path / f"h.{ext}").read_bytes()
    with pytest.raises(ValueError, match="unsupported frame format"):
        pimg.save_frame(tmp_path / "x.jpg", img)


def test_polar_to_points_and_cartesian_match_reference():
    rng = np.random.default_rng(8)
    polar = (rng.random((96, 32)) ** 6 * 255).astype(np.uint8)
    for kw in (dict(resolution=0.25), dict(resolution=0.5, threshold=40,
                                           scroll=5)):
        np.testing.assert_array_equal(pimg.polar_to_points(polar, **kw),
                                      jimg.polar_to_points(polar, **kw))
    for kw in (dict(size=64), dict(size=65, max_cell=40, scroll=3),
               dict(size=48, bilinear=False)):
        cart = pcart.polar_to_cartesian(polar, **kw)
        np.testing.assert_array_equal(cart,
                                      jcart.polar_to_cartesian(polar, **kw))
    np.testing.assert_array_equal(pcart.stretch_contrast(cart),
                                  jcart.stretch_contrast(cart))
    np.testing.assert_array_equal(pcart.colorize_papercolor(cart),
                                  jcart.colorize_papercolor(cart))
    a, ja = pcart.imaging_stats(polar), jcart.imaging_stats(polar)
    b = pcart.cartesian_stats(cart, noise_threshold=20)
    jb = jcart.cartesian_stats(cart, noise_threshold=20)
    assert json.dumps(a) == json.dumps(ja) and json.dumps(b) == json.dumps(jb)
    assert pcart.compare_imaging_stats(a, b) == jcart.compare_imaging_stats(
        ja, jb)


def test_real_frame_sequence_matches_reference(tmp_path):
    d = tmp_path / "mulran"
    d.mkdir()
    base_ns = 1566535952000000000
    for k in range(4):
        np.save(d / f"{base_ns + k * 250_000_000}.npy",
                np.full((8, 4), k, np.uint8))
    named = tmp_path / "named"
    named.mkdir()
    for k, name in enumerate(("b.png", "a.png", "c.npy")):
        if name.endswith(".png"):
            pimg.write_png_gray(named / name, np.full((6, 3), k, np.uint8))
        else:
            np.save(named / name, np.full((6, 3), k, np.uint8))
    (named / "stamps.txt").write_text("# comment\nb.png 2.5\na.png 1.0\n")
    plain = tmp_path / "plain"
    plain.mkdir()
    for name in ("x.npy", "y.npy"):
        np.save(plain / name, np.zeros((2, 2), np.uint8))
    for kw in (dict(directory=d), dict(directory=named),
               dict(directory=named, transpose=True),
               dict(directory=plain, rate=2.0)):
        seq, jseq = preal.RealFrameSequence(**kw), jreal.RealFrameSequence(**kw)
        assert seq.paths == jseq.paths
        np.testing.assert_array_equal(seq.stamps, jseq.stamps)
        for i in range(len(seq)):
            np.testing.assert_array_equal(seq.frame(i), jseq.frame(i))
        for s in (seq.stamps[0] - 1.0, float(seq.stamps.mean()), 1e12):
            assert seq.nearest(s) == jseq.nearest(s)


# ---------------------------------------------------------------- evaluate

def test_evaluate_dirs_matches_reference(tmp_path):
    from radarays_ros_tpu.opti.evaluate import evaluate_dirs as j_eval
    from radarays_ros_tpu_torch.opti.evaluate import evaluate_dirs

    rng = np.random.default_rng(9)
    real, sim = tmp_path / "real", tmp_path / "sim"
    real.mkdir()
    sim.mkdir()
    for k in range(3):
        a = (rng.random((48, 24)) ** 4 * 255).astype(np.uint8)
        b = np.clip(a.astype(int) + rng.integers(-20, 21, a.shape), 0,
                    255).astype(np.uint8)
        pimg.write_png_gray(real / f"{k:03d}.png", a)
        np.save(sim / f"{k:03d}.npy", b)
    metrics = ["psnr", "ssim", "mi", "nmi", "voi", "mae"]
    got = evaluate_dirs(real, sim, metrics=metrics, limit=2)
    want = j_eval(real, sim, metrics=metrics, limit=2)
    assert got["n_frames"] == want["n_frames"] == 2
    for fg, fw in zip(got["per_frame"], want["per_frame"]):
        for m in metrics:
            np.testing.assert_allclose(fg[m], fw[m], rtol=1e-5, atol=1e-5)
    for m in metrics:
        for k in ("mean", "std", "min", "max"):
            np.testing.assert_allclose(got["summary"][m][k],
                                       want["summary"][m][k],
                                       rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- profiling

def test_stage_timer():
    from radarays_ros_tpu_torch.utils.profiling import StageTimer

    t = StageTimer()
    t.add("a", 0.25)
    t.add("a", 0.5)
    t.add("b", 0.5)
    assert t.counts == {"a": 2, "b": 1}
    assert t.totals == {"a": 0.75, "b": 0.5}


# ---------------------------------------------------------------- Radar

def test_radar_stamps_extrapolation_and_reseed():
    """simulate(stamp=...) keeps the two-entry history, simulate(None,
    stamp=...) renders the extrapolated pose, and reseed=False repeats the
    previous frame's noise (the generator's state is restored)."""
    from radarays_ros_tpu_torch.geom.primitives import make_box
    from radarays_ros_tpu_torch.geom.scene import Scene
    from radarays_ros_tpu_torch.sim.config import Materials, RadarParams
    from radarays_ros_tpu_torch.sim.radar import Radar

    scene = Scene.compose([make_box((0, 0, 0), (30.0, 30.0, 8.0))[:, ::-1],
                           make_box((6.0, 1.0, 0.0), (2.0, 2.0, 8.0))],
                          chunk_size=8)
    params = RadarParams.make(Materials.from_list(
        [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
         dict(velocity=0.0, ambient=0.9, diffuse=0.1, specular=200.0)]),
        [1, 1], beam_width_deg=6.0)
    cfg = RadarModelConfig(n_angles=16, n_cells=96, resolution=0.25,
                           n_samples=3, n_reflections=2, ambient_noise=1)
    radar = Radar(scene, params, cfg, seed=3, device="cpu",
                  verbose_timing=True)
    p0 = ptf.make_pose([0.0, 0.0, 1.0])
    p1 = ptf.make_pose([1.0, 0.5, 1.0], jtf.quat_from_euler(0, 0, 0.2))
    a = radar.simulate_image(p0, stamp=0.0)
    b = radar.simulate_image(p1, stamp=0.5)
    assert radar.timer.counts["frame"] == 2
    assert [s for s, _ in radar._pose_history] == [0.0, 0.5]
    c = radar.simulate_image(None, stamp=1.0)
    np.testing.assert_array_equal(radar._last_pose,
                                  radar.extrapolate_pose(1.0))
    np.testing.assert_allclose(radar._last_pose[:3], [2.0, 1.0, 1.0],
                               atol=1e-6)
    d = radar.simulate_image(None, stamp=1.0, reseed=False)
    np.testing.assert_array_equal(c, d)               # same noise draw
    e = radar.simulate_image(None, stamp=1.0)
    assert not np.array_equal(d, e)                   # fresh noise
    assert a.max() > 0 and b.shape == a.shape


# ---------------------------------------------------------------- per-azimuth

@pytest.fixture(scope="module")
def motion_world():
    from test_torch_pipeline import _both_params, _parts, _MATS, _MATS_T
    from radarays_ros_tpu.geom.scene import Scene as JxScene
    from radarays_ros_tpu_torch.geom.scene import Scene

    parts = _parts()
    st = Scene.compose(parts, chunk_size=8).to_device("cpu")
    sa = JxScene.compose(parts, chunk_size=8).device_arrays(cache=False)
    return st, sa, {True: _both_params(_MATS), False: _both_params(_MATS_T)}


@pytest.mark.parametrize("opaque", [True, False],
                         ids=["opaque", "refraction"])
def test_per_azimuth_pose_frame_matches_reference(motion_world, opaque):
    """include_motion: one frame rendered from (n_angles, 7) per-azimuth
    poses — the reference's simulate_frame with its interpolate_poses, the
    port's simulate_frame with its own interpolate_poses — under the frame
    contract, with the same cone directions and Perlin offsets."""
    from test_torch_pipeline import _CFG, _assert_frame_contract, _inputs
    from radarays_ros_tpu.sim.pipeline import simulate_frame_jit
    from radarays_ros_tpu_torch.sim.pipeline import simulate_frame

    st, sa, params = motion_world
    jparams, pparams = params[opaque]
    kw = dict(_CFG, opaque_materials=opaque, include_motion=True)
    cfg = RadarModelConfig(**kw)
    pa = ptf.make_pose([0.5, -0.3, 1.0])
    pb = ptf.make_pose([2.5, 1.2, 1.0], jtf.quat_from_euler(0, 0, 0.6))
    alphas = np.arange(cfg.n_angles, dtype=np.float32) / cfg.n_angles
    jposes = jtf.interpolate_poses(pa, pb, jnp.asarray(alphas))
    poses = ptf.interpolate_poses(pa, pb, torch.from_numpy(alphas))
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=1e-6)
    key = jax.random.PRNGKey(13)
    ref = simulate_frame_jit(sa, jparams, JCFG.RadarModelConfig(**kw),
                             jposes, tuple(jax.random.split(key)))
    dirs, begin = _inputs(key, cfg, jparams.beam_width)
    got = simulate_frame(st, pparams, cfg, poses,
                         local_dirs=torch.from_numpy(dirs),
                         random_begin=torch.from_numpy(begin))
    _assert_frame_contract(got.image_float, got.max_val, got.image_u8,
                           ref.image_float, ref.max_val, ref.image_u8)
    # the poses vary across the scan: the frame differs from a static one
    still = simulate_frame(st, pparams, cfg, torch.from_numpy(pa),
                           local_dirs=torch.from_numpy(dirs),
                           random_begin=torch.from_numpy(begin))
    assert not torch.equal(still.image_float, got.image_float)


# the KAIST preset's fields (bench.py:119-182) at a frame small enough for
# the reference's interpret-mode kernels on CPU: 16 azimuths x 128 cells of
# 0.25 m, 6 samples, 3 reflections, ray blocks of 128, the scene unbaked
_KAIST_SMALL = dict(
    n_angles=16, n_cells=128, resolution=0.25, n_samples=6, n_reflections=3,
    beam_sample_dist=2, beam_sample_dist_normal_p_in_cone=0.8,
    energy_max=0.72, signal_max=110.0, signal_denoising=1,
    signal_denoising_triangular_width=35,
    signal_denoising_triangular_mode=0.35, ambient_noise=2,
    ambient_noise_at_signal_0=0.1, ambient_noise_at_signal_1=0.03,
    ambient_noise_energy_max=0.1, ambient_noise_energy_min=0.05,
    record_multi_reflection=True, record_multi_path=False,
    opaque_materials=True, trace_engine="pallas3", trace_ray_block=128)


@pytest.mark.parametrize("method", ["auto", "scatter", "sort", "pallas"])
def test_reference_preset_draw_method_renders_in_the_port(motion_world,
                                                          tmp_path, method):
    """A preset the JAX package writes with each of its draw methods loads
    through the port's load_preset (the three binning methods the reference
    holds equal become the port's "auto") and renders on CPU within the
    frame contract of the reference's frame under the same preset."""
    from test_torch_pipeline import _assert_frame_contract, _inputs
    from radarays_ros_tpu.sim.pipeline import simulate_frame_jit
    from radarays_ros_tpu_torch.sim.pipeline import simulate_frame

    st, sa, params = motion_world
    jparams, pparams = params[True]
    path = tmp_path / "kaist.yaml"
    jcfgio.save_preset(path, JCFG.RadarModelConfig(**_KAIST_SMALL,
                                                   draw_method=method),
                       beam_width_deg=15.0)
    assert f"draw_method: {method}" in path.read_text()
    cfg, bw, _ = pcfgio.load_preset(path)
    jcfg, jbw, _ = jcfgio.load_preset(path)
    assert (cfg.draw_method, cfg.trace_engine) == ("auto", "kernel")
    assert jcfg.draw_method == method and bw == jbw == 15.0
    pose = ptf.make_pose([0.5, -0.3, 1.0])
    key = jax.random.PRNGKey(21)
    ref = simulate_frame_jit(sa, jparams, jcfg, jnp.asarray(pose),
                             tuple(jax.random.split(key)))
    dirs, begin = _inputs(key, cfg, jparams.beam_width)
    got = simulate_frame(st, pparams, cfg, torch.from_numpy(pose),
                         local_dirs=torch.from_numpy(dirs),
                         random_begin=torch.from_numpy(begin))
    assert (got.image_u8 > 0).any()
    _assert_frame_contract(got.image_float, got.max_val, got.image_u8,
                           ref.image_float, ref.max_val, ref.image_u8)
