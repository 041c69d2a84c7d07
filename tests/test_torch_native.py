"""The port's C++ host builder (radarays_ros_tpu_torch.native) against its
NumPy build and the JAX package's NumPy functions, on the same inputs: the
SAH permutation, chunk AABBs, planes and the device tables bit for bit
(at 1 and 8 OpenMP threads), the OBJ reader, the build's wiring (the cache
key, RADARAYS_NO_NATIVE, RADARAYS_ORDER_VARIANT, a failed build raising),
a KAIST-shaped frame at prep group 4 against the JAX frame, and the public
names the port copies from the JAX package (primitives, Perlin noise, the
quantile, cone directions, AmbientNoiseParams).
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from radarays_ros_tpu.geom import mesh as JM
from radarays_ros_tpu.geom import primitives as JG
from radarays_ros_tpu.geom import scene as JS
from radarays_ros_tpu.image import perlin as JP
from radarays_ros_tpu.sim import config as JCFG
from radarays_ros_tpu.wave import cone as JC
from radarays_ros_tpu.wave import radar_math as JR

from radarays_ros_tpu_torch.geom import cache as pcache
from radarays_ros_tpu_torch.geom import mesh as PM
from radarays_ros_tpu_torch.geom import primitives as G
from radarays_ros_tpu_torch.geom import scene as S
from radarays_ros_tpu_torch.image import perlin as PP
from radarays_ros_tpu_torch.native import builder as nb
from radarays_ros_tpu_torch.wave import cone as PC
from radarays_ros_tpu_torch.wave import radar_math as PR

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(a):
    """Float arrays as their bit patterns (signed zeros and NaNs count)."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_bits_equal(got, want, name=""):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


def _padded(verts, tc):
    """verts padded with far triangles to whole chunks, as _build_host."""
    C = -(-verts.shape[0] // tc)
    C = -(-C // 8) * 8
    far = np.full((C * tc - verts.shape[0], 3, 3), 1e8, np.float32)
    far[:, 1, 0] += 1.0
    far[:, 2, 1] += 1.0
    return np.concatenate([verts, far])


@pytest.fixture(scope="module")
def tris():
    return np.random.default_rng(11).normal(size=(2048, 3, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def urban():
    """An urban scene with centroid ties (the faces of each box) and nodes
    above the library's task threshold, padded to chunks of 256."""
    parts, names = G.make_urban_scene(n_buildings=3000, extent=150.0, seed=5)
    return _padded(S.Scene.compose(parts, names).verts, 256)


# ------------------------------------------------------------ orderings

_ORDER_SCRIPT = textwrap.dedent("""
    import ctypes, json, sys
    import numpy as np
    from radarays_ros_tpu_torch.native import builder as nb
    z = np.load(sys.argv[1])
    out = {}
    for name in ("random", "urban"):
        v = z[name]
        for tc in (16, 64, 256):
            out[f"{name}_{tc}"] = nb.sah_split_order(
                v.mean(axis=1), v.min(axis=1), v.max(axis=1), tc)
    np.savez(sys.argv[2], **out)
    print(json.dumps(ctypes.CDLL("libgomp.so.1").omp_get_max_threads()))
""")


@pytest.fixture(scope="module")
def numpy_orders(tris, urban):
    out = {}
    for name, v in (("random", tris), ("urban", urban)):
        for tc in (16, 64, 256):
            args = (v.mean(axis=1), v.min(axis=1), v.max(axis=1), tc)
            want = S._median_split_order_sah(*args)
            np.testing.assert_array_equal(want,
                                          JS._median_split_order_sah(*args))
            out[f"{name}_{tc}"] = want
    return out


@pytest.mark.parametrize("threads", [1, 8])
def test_sah_order_bit_equal_at_any_thread_count(tmp_path, tris, urban,
                                                 numpy_orders, threads):
    """rr_sah_split_order's permutation equals the port's and the JAX
    package's NumPy SAH at chunk sizes 16, 64 and 256, on random triangles
    and on an urban scene with centroid ties, in a process whose OpenMP
    runtime runs `threads` threads."""
    nb.build()                       # built once, here, for the subprocess
    np.savez(tmp_path / "in.npz", random=tris, urban=urban)
    res = subprocess.run(
        [sys.executable, "-c", _ORDER_SCRIPT, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        cwd=REPO, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": str(threads),
             "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == threads
    with np.load(tmp_path / "out.npz") as got:
        for k, want in numpy_orders.items():
            np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_median_order_holds_the_reference_contract(tris):
    """RADARAYS_ORDER_VARIANT=median: the NumPy copy equals the JAX
    package's; the library's split is a permutation with full leaves of the
    same quality (nth_element and argpartition may order ties otherwise),
    as tests/test_native.py holds the reference's."""
    rng = np.random.default_rng(3)
    tc = 64
    c = rng.uniform(-50, 50, (4096, 3)).astype(np.float32)
    o_np = S._median_split_order(c, tc)
    np.testing.assert_array_equal(o_np, JS._median_split_order(c, tc))
    o_c = nb.median_split_order(c, tc)
    assert sorted(o_c.tolist()) == list(range(4096))

    def mean_leaf_volume(order):
        v = c[order].reshape(-1, tc, 3)
        return float(np.prod(v.max(axis=1) - v.min(axis=1), axis=1).mean())

    assert mean_leaf_volume(o_c) <= mean_leaf_volume(o_np) * 1.10
    assert mean_leaf_volume(o_np) <= mean_leaf_volume(o_c) * 1.10


# ------------------------------------------------------- planes, tables

def test_numpy_sums_an_axis_of_three_from_zero_in_order():
    """The C++ planes repeat NumPy's float32 order: np.sum and
    np.linalg.norm over an axis of 3 add the terms in order to +0 (so a sum
    of -0 terms is +0). Pinned here, since another NumPy could differ."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(100_000, 3))
         * rng.uniform(0, 1e3, (100_000, 1))).astype(np.float32)
    x[:7] = [[-0.0, -0.0, -0.0], [0.0, -0.0, -0.0], [-0.0, 0.0, -0.0],
             [1e-30, 1e8, -1e8], [1e8, -1e8, 1e-30], [3.0, 1e8, -1e8],
             [-0.0, -0.0, 0.0]]
    zero = np.float32(0.0)
    want = ((zero + x[:, 0]) + x[:, 1]) + x[:, 2]
    _assert_bits_equal(np.sum(x, axis=-1), want)
    sq = x * x
    _assert_bits_equal(np.linalg.norm(x, axis=-1),
                       np.sqrt(((zero + sq[:, 0]) + sq[:, 1]) + sq[:, 2]))


@pytest.mark.parametrize("kind", ["random", "urban"])
def test_planes_aabbs_and_tables_bit_equal(tris, urban, kind):
    """normals, planes_o, chunk AABBs, coef and fetch from the library equal
    the port's NumPy build bit for bit (and the JAX package's planes); the
    urban scene's ground and box faces give -0 offsets."""
    v = tris if kind == "random" else urban[:40960]
    n_np, po_np = S._triangle_planes(v)
    jn, jpo, _ = JS._triangle_planes(v)
    _assert_bits_equal(n_np, jn, "reference normals")
    _assert_bits_equal(po_np, jpo, "reference planes_o")
    n_c, po_c = nb.triangle_planes(v)
    _assert_bits_equal(n_c, n_np, "normals")
    _assert_bits_equal(po_c, po_np, "planes_o")
    if kind == "urban":
        assert (_bits(po_np[:, 3]) == 0x80000000).any()   # -0 offsets
    for tc in (16, 64, 256):
        lo, hi = nb.chunk_aabbs(v, tc)
        ch = v.reshape(-1, tc, 3, 3)
        _assert_bits_equal(lo, ch.min(axis=(1, 2)), f"lo {tc}")
        _assert_bits_equal(hi, ch.max(axis=(1, 2)), f"hi {tc}")
    _assert_bits_equal(nb.edge_coefficients(po_np),
                       S.edge_coefficients(po_np), "coef")
    ids = (np.arange(v.shape[0]) % 7).astype(np.int32)
    ids[::5] = S.INVALID_OBJ_ID
    _assert_bits_equal(nb.fetch_rows(v, n_np, ids),
                       S.fetch_rows(v, n_np, ids), "fetch")


def test_bridge_refuses_bad_shapes(tris):
    with pytest.raises(ValueError, match="chunk"):
        nb.sah_split_order(tris.mean(axis=1)[:100], tris.min(axis=1)[:100],
                           tris.max(axis=1)[:100], 64)
    with pytest.raises(ValueError, match="verts must be shaped"):
        nb.triangle_planes(tris.reshape(-1, 9))
    with pytest.raises(ValueError, match="4 a triangle"):
        nb.edge_coefficients(np.zeros((6, 4), np.float32))


# ------------------------------------------------------------------ OBJ

_OBJ_REFERENCE_TEST = (        # tests/test_native.py:test_obj_parse_parity
    "o first\n"
    "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
    "f 1 2 3 4\n"
    "g second\n"
    "v 0 0 1\nv 1 0 1\nv 0 1 1\n"
    "f 5/1/1 6/2/2 7/3/3\n"
    "f -3 -2 -1\n")
_OBJ_EXTRAS = (
    "# a comment\r\n"
    "v 0.1 0.2 0.30000001192092896 1.0\r\n"   # a w coordinate, CRLF
    "v 1e-3 -2.5E+2 7\rv .5 5. -0\n"          # a lone CR ends a line too
    "vt 0.5 0.5\nvn 0 0 1\n\n   \t\n"
    "f 1 2 3\n"                                # before any o/g: object 0
    "o\n"                                      # unnamed: object_0
    "v 3.4028234e38 1e-45 0.1\n"
    "f 1/2 2//3 4\n"
    "usemtl stone\ns off\n"
    "g  spaced   name ignored\n"
    "f -4 -3 -2 -1\n"                          # a quad of negatives
    "o last")                                  # no newline at the end


@pytest.mark.parametrize("text", [_OBJ_REFERENCE_TEST, _OBJ_EXTRAS],
                         ids=["reference_test", "extras"])
def test_obj_reader_bit_equal_to_python(tmp_path, text, monkeypatch):
    path = tmp_path / "t.obj"
    path.write_bytes(text.encode())
    want = PM._load_obj(path, 8)
    jwant = JM._load_obj(path, 8)
    verts, obj_ids, names = nb.parse_obj(path)
    _assert_bits_equal(verts, want.verts)
    _assert_bits_equal(verts, jwant.verts)
    np.testing.assert_array_equal(obj_ids, want.obj_ids)
    assert obj_ids.dtype == np.int32
    assert (names or None) == (list(want.object_names)
                               if want.object_names else None)
    got = PM.load_mesh(path, chunk_size=8)        # through the library
    _assert_bits_equal(got.verts, want.verts)
    assert got.object_names == want.object_names
    monkeypatch.setenv("RADARAYS_NO_NATIVE", "1")
    monkeypatch.setattr(nb, "parse_obj", None)    # the Python reader only
    _assert_bits_equal(PM.load_mesh(path, chunk_size=8).verts, want.verts)


def test_obj_reader_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        nb.parse_obj(tmp_path / "missing.obj")
    with pytest.raises(FileNotFoundError):
        PM.load_mesh(tmp_path / "missing.obj")
    bad = tmp_path / "bad.obj"
    for text, where in (("v 0 0 0\nv 1 0 0\nv 0 x 0\n", "line 3"),
                        ("v 0 0\n", "line 1"),
                        ("v 0 0 0\nf 1 a 3\n", "line 2"),
                        ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 9\n",
                         "face index"),
                        ("v 0 0 0\n# no faces\n", "without faces")):
        bad.write_text(text)
        with pytest.raises(ValueError, match=where):
            nb.parse_obj(bad)


# ------------------------------------------------------- build wiring

def _hosts_and_keys(monkeypatch, scene):
    out = {}
    for no_native in ("0", "1"):
        monkeypatch.setenv("RADARAYS_NO_NATIVE", no_native)
        stages = {}
        host = scene._build_host(stages)
        key = pcache.scene_cache_key(scene.verts, scene.obj_ids,
                                     scene.chunk_size)
        out[stages["builder"]] = (host, key)
    return out


@pytest.mark.parametrize("chunk_size", [16, 64])
def test_host_build_equal_with_and_without_native(monkeypatch, chunk_size):
    """Scene.host_arrays through the library and through NumPy: every array
    bit-equal and one cache key (the SAH bytes do not name the builder)."""
    parts, names = G.make_urban_scene(n_buildings=300, extent=80.0, seed=2)
    scene = S.Scene.compose(parts, names, chunk_size=chunk_size)
    monkeypatch.delenv("RADARAYS_ORDER_VARIANT", raising=False)
    out = _hosts_and_keys(monkeypatch, scene)
    (h_c, k_c), (h_np, k_np) = out["native"], out["numpy"]
    for name, x, y in zip(h_c._fields, h_c, h_np):
        if name == "chunk_size":
            assert x == y
        else:
            _assert_bits_equal(x, y, name)
    assert k_c == k_np
    assert nb.builder_version() == nb.BUILDER_VERSION
    monkeypatch.setenv("RADARAYS_NO_NATIVE", "0")
    tables = S.device_tables(h_c)
    monkeypatch.setenv("RADARAYS_NO_NATIVE", "1")
    for x, y in zip(tables, S.device_tables(h_c)):
        _assert_bits_equal(x, y)


def test_median_variant_names_its_builder(monkeypatch):
    """RADARAYS_ORDER_VARIANT=median: the same triangle multiset and leaves
    no worse than 1.25x the NumPy split's mean volume from the library
    (tests/test_native.py's contract); its cache keys name the builder and
    differ from the SAH key; an unknown variant is refused."""
    parts, names = G.make_urban_scene(n_buildings=60, extent=50.0, seed=2)
    scene = S.Scene.compose(parts, names, chunk_size=16)
    monkeypatch.setenv("RADARAYS_ORDER_VARIANT", "sah")
    k_sah = pcache.scene_cache_key(scene.verts, scene.obj_ids, 16)
    monkeypatch.setenv("RADARAYS_ORDER_VARIANT", "median")
    out = _hosts_and_keys(monkeypatch, scene)
    (h_c, k_c), (h_np, k_np) = out["native"], out["numpy"]
    assert len({k_c, k_np, k_sah}) == 3

    def rows(h):
        r = h.verts.reshape(-1, 9)
        return r[np.lexsort(r.T[::-1])]

    np.testing.assert_array_equal(rows(h_c), rows(h_np))

    def mean_chunk_volume(h):
        real = h.chunk_lo[:, 0] < 1e7
        return float(np.prod((h.chunk_hi - h.chunk_lo)[real], axis=1).mean())

    assert mean_chunk_volume(h_c) <= mean_chunk_volume(h_np) * 1.25
    assert mean_chunk_volume(h_np) <= mean_chunk_volume(h_c) * 1.25
    monkeypatch.setenv("RADARAYS_ORDER_VARIANT", "morton")
    with pytest.raises(ValueError, match="RADARAYS_ORDER_VARIANT"):
        scene.host_arrays(cache=False)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The builder with an empty build directory and no cached library;
    the real one is loaded again afterwards."""
    monkeypatch.setattr(nb, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.delenv("RADARAYS_NO_NATIVE", raising=False)
    nb.build.cache_clear()
    yield
    nb.build.cache_clear()


def test_missing_compiler_raises_without_fallback(fresh_build, monkeypatch):
    parts, names = G.make_urban_scene(n_buildings=5, extent=20.0, seed=0)
    scene = S.Scene.compose(parts, names, chunk_size=8)
    monkeypatch.setattr(nb.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C.. compiler"):
        scene.host_arrays(cache=False)


def test_compile_error_raises_with_the_compiler_output(fresh_build,
                                                       monkeypatch,
                                                       tmp_path):
    src = tmp_path / "builder.cpp"
    src.write_text('extern "C" int rr_builder_version(void) { return x; }\n')
    monkeypatch.setattr(nb, "_SRC", src)
    with pytest.raises(RuntimeError, match="(?s)failed.*builder.cpp:1:"):
        nb.build()
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_prime_cache_reports_the_builder_stages(tmp_path, monkeypatch,
                                                capsys):
    from radarays_ros_tpu_torch.io import cli

    monkeypatch.setenv("RADARAYS_SCENE_CACHE", str(tmp_path / "scenes"))
    monkeypatch.delenv("RADARAYS_NO_NATIVE", raising=False)
    parts, names = G.make_urban_scene(n_buildings=40, extent=40.0, seed=1)
    mesh = tmp_path / "town.ply"
    PM.save_ply(mesh, S.Scene.compose(parts, names))
    argv = ["prime-cache", "--mesh", str(mesh)]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "builder native (sah): ordering" in out
    for stage in ("planes and AABBs", "coef and fetch tables", "store"):
        assert stage in out
    assert cli.main(argv) == 0
    assert "already primed" in capsys.readouterr().out


# ------------------------------------------------ a frame at prep group 4

def test_kaist_shaped_frame_at_prep_group_4_matches_reference():
    """The KAIST preset's physics (50 samples, 4 reflections, opaque
    wall-stone, triangular denoise 35/0.35, two-octave Perlin noise, the
    material map baked) on a small urban scene built by the library,
    traced with supergroups of 4 chunks, against the JAX frame (pallas3,
    prep group 4, interpret mode) under the frame contract of
    tests/test_oracle.py:70-87. Angles and cells are cut for the CPU."""
    from radarays_ros_tpu.sim.pipeline import simulate_frame_jit

    from radarays_ros_tpu_torch.geom.scene import bake_tri_aux
    from radarays_ros_tpu_torch.sim.config import (RadarModelConfig,
                                                   params_from_numpy)
    from radarays_ros_tpu_torch.sim.pipeline import simulate_frame
    from radarays_ros_tpu_torch.utils.transforms import make_pose

    parts, names = G.make_urban_scene(n_buildings=150, extent=40.0, seed=7)
    scene = S.Scene.compose(parts, names, chunk_size=8)
    host = scene.host_arrays(cache=False)
    assert nb.enabled() and host.chunk_lo.shape[0] % 4 == 0
    mats = [dict(velocity=0.3, ambient=1.0, diffuse=0.0, specular=1.0),
            dict(velocity=0.0, ambient=1.0, diffuse=0.0, specular=3000.0)]
    om = np.ones(scene.n_objects, np.int32)
    jparams = JCFG.RadarParams.make(JCFG.Materials.from_list(mats), om,
                                    beam_width_deg=10.0)
    m = jparams.materials
    params = params_from_numpy(*(np.asarray(x) for x in (
        m.velocity, m.ambient, m.diffuse, m.specular,
        jparams.object_materials, jparams.beam_width)))
    kw = dict(n_angles=12, n_cells=640, resolution=0.0595238, n_samples=50,
              n_reflections=4, beam_sample_dist=2,
              beam_sample_dist_normal_p_in_cone=0.8, energy_max=0.72,
              signal_max=110.0, signal_denoising=1,
              signal_denoising_triangular_width=35,
              signal_denoising_triangular_mode=0.35, ambient_noise=2,
              ambient_noise_at_signal_0=0.1, ambient_noise_at_signal_1=0.03,
              ambient_noise_energy_max=0.1, ambient_noise_energy_min=0.05,
              record_multi_reflection=True, record_multi_path=False,
              opaque_materials=True, trace_ray_block=128,
              trace_prep_group=4)
    jcfg = JCFG.RadarModelConfig(**kw, trace_engine="pallas3",
                                 draw_method="pallas")
    cfg = RadarModelConfig(**kw, trace_engine="sweep", trace_aux_baked=True)
    sa = JS.Scene.compose(parts, names, chunk_size=8).device_arrays(
        cache=False)
    st = scene.to_device("cpu", cache=False)
    st = bake_tri_aux(st, params.object_materials.float()[
        st.obj_ids.clamp(0, scene.n_objects - 1).long()])
    pose = make_pose([0.5, 0.25, 2.0])
    key = jax.random.PRNGKey(5)
    ref = simulate_frame_jit(sa, jparams, jcfg, jnp.asarray(pose),
                             tuple(jax.random.split(key)))
    k_cone, k_noise = jax.random.split(key)
    dirs = np.array(JC.sample_cone_local(
        k_cone, jparams.beam_width, jcfg.n_samples, jcfg.beam_sample_dist,
        jcfg.beam_sample_dist_normal_p_in_cone))
    begin = np.array(jax.random.randint(jax.random.split(k_noise)[0],
                                        (jcfg.n_angles,), 0, 1000))
    got = simulate_frame(st, params, cfg, torch.from_numpy(pose),
                         local_dirs=torch.from_numpy(dirs),
                         random_begin=torch.from_numpy(begin))
    o_img = np.asarray(ref.image_float, np.float64)
    assert o_img.max() > 0 and (got.image_u8 > 0).any()
    np.testing.assert_allclose(got.image_float.numpy().astype(np.float64),
                               o_img, atol=2e-4 * o_img.max(), rtol=2e-3)
    np.testing.assert_allclose(got.max_val.numpy().astype(np.float64),
                               np.asarray(ref.max_val, np.float64),
                               rtol=1e-4, atol=1e-6)
    diff = np.abs(got.image_u8.numpy().astype(int)
                  - np.asarray(ref.image_u8).astype(int))
    assert (diff <= 1).mean() >= 0.995 and diff.max() <= 3


# ------------------------------------------------- the 32-bit index width

def test_trace_refuses_scenes_past_the_kernels_index_width():
    from radarays_ros_tpu_torch.trace import cuda_trace as CT

    CT._check_index_width(2**31 - 1, 80_000)
    with pytest.raises(ValueError, match="32-bit"):
        CT._check_index_width(2**31, 80_000)
    with pytest.raises(ValueError, match="32-bit"):
        CT._check_index_width(1000, 2**31)


# -------------------------------------------------------- public names

@pytest.mark.parametrize("kw", [dict(), dict(n_blocks=3, clutter=0.5, seed=4),
                                dict(n_blocks=2, clutter=0.0, extent=90.0)])
def test_make_canyon_scene_bit_identical(kw):
    parts, names = G.make_canyon_scene(**kw)
    jparts, jnames = JG.make_canyon_scene(**kw)
    assert names == jnames and len(parts) == len(jparts)
    for p, q in zip(parts, jparts):
        _assert_bits_equal(p, q)


@pytest.mark.parametrize("kw", [dict(), dict(center=(1, -2, 3), radius=0.4,
                                             height=2.5, segments=7,
                                             capped=False)])
def test_make_cylinder_bit_identical(kw):
    _assert_bits_equal(G.make_cylinder(**kw), JG.make_cylinder(**kw))


@pytest.mark.parametrize("sub", [0, 1, 3])
def test_make_icosphere_bit_identical(sub):
    _assert_bits_equal(G.make_icosphere((1, 2, 3), 2.5, sub),
                       JG.make_icosphere((1, 2, 3), 2.5, sub))
    tris = np.asarray(G._rot_z(G.make_icosphere(subdivisions=sub), 0.7,
                               (1.0, 2.0)))
    _assert_bits_equal(tris, JG._rot_z(JG.make_icosphere(subdivisions=sub),
                                       0.7, (1.0, 2.0)))


def test_perlin_noise_matches_reference_and_oracle():
    """perlin_noise against the JAX package's on the CPU (same f32 order:
    bit for bit) and the NumPy float64 oracle (f32 rounding); the two-octave
    blend likewise."""
    rng = np.random.default_rng(9)
    x = rng.uniform(-300, 300, 4000).astype(np.float32)
    y = rng.uniform(-300, 300, 4000).astype(np.float32)
    z = rng.uniform(-5, 5, 4000).astype(np.float32)
    got = PP.perlin_noise(torch.from_numpy(x), torch.from_numpy(y),
                          torch.from_numpy(z)).numpy()
    _assert_bits_equal(got, np.asarray(JP.perlin_noise(x, y, z)))
    oracle = np.array([PP.perlin_noise_reference(float(a), float(b), float(c))
                       for a, b, c in zip(x[:300], y[:300], z[:300])])
    np.testing.assert_array_equal(
        oracle, [JP.perlin_noise_reference(float(a), float(b), float(c))
                 for a, b, c in zip(x[:300], y[:300], z[:300])])
    np.testing.assert_allclose(got[:300], oracle, atol=2e-5)
    assert np.abs(got).max() <= 1.0
    hilo = PP.perlin_noise_hilo(3.0, 7.0, torch.from_numpy(x[:500]),
                                torch.from_numpy(y[:500]), 0.05, 0.2, 0.9)
    _assert_bits_equal(hilo.numpy(), np.asarray(JP.perlin_noise_hilo(
        3.0, 7.0, x[:500], y[:500], 0.05, 0.2, 0.9)))


def test_quantile_matches_reference():
    p = np.linspace(0.01, 0.99, 99).astype(np.float32)
    got = PR.quantile(torch.from_numpy(p)).numpy()
    _assert_bits_equal(got, np.asarray(JR.quantile(p)))
    assert float(PR.quantile(0.8)) == float(JR.quantile(0.8))
    assert PR.M_C == JR.M_C


@pytest.mark.parametrize("dist", [0, 1, 2, 3])
def test_sample_cone_dirs_matches_reference_distribution(dist):
    """sample_cone_dirs draws from a torch.Generator: its directions equal
    cone_dirs on the same draws, stay unit, and their offsets from the mean
    direction have the reference's moments (the streams differ)."""
    mean = np.array([0.6, 0.8, 0.0], np.float32)
    width, n = np.float32(np.deg2rad(8.0)), 40_000
    got = PC.sample_cone_dirs(torch.Generator().manual_seed(1), mean, width,
                              n, dist, 0.8)
    draws = PC.sample_cone_draws(torch.Generator().manual_seed(1), n, dist)
    assert torch.equal(got, PC.cone_dirs(*draws, mean, width, dist, 0.8))
    ref = np.asarray(JC.sample_cone_dirs(jax.random.PRNGKey(1), mean, width,
                                         n, dist, 0.8))
    got = got.numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    ang = np.arccos(np.clip(got @ mean, -1, 1))
    ang_ref = np.arccos(np.clip(ref @ mean, -1, 1))
    np.testing.assert_allclose(ang.mean(), ang_ref.mean(), rtol=0.03)
    np.testing.assert_allclose(ang.std(), ang_ref.std(), rtol=0.05)
    np.testing.assert_allclose(got.mean(axis=0), ref.mean(axis=0), atol=2e-3)


def test_ambient_noise_params_and_package_exports():
    import radarays_ros_tpu
    import radarays_ros_tpu_torch
    from radarays_ros_tpu_torch import geom, image, sim, trace, wave

    from radarays_ros_tpu_torch.sim.config import AmbientNoiseParams

    assert dataclasses.asdict(AmbientNoiseParams()) == dataclasses.asdict(
        JCFG.AmbientNoiseParams())
    for name in ("RadarModelConfig", "RadarParams", "Materials",
                 "AmbientNoiseParams", "Radar", "Scene"):
        assert hasattr(radarays_ros_tpu, name)
        assert hasattr(radarays_ros_tpu_torch, name), name
    import radarays_ros_tpu.geom as jgeom
    import radarays_ros_tpu.image as jimage
    import radarays_ros_tpu.wave as jwave
    for mod, jmod, skip in ((geom, jgeom, {"SceneArrays"}),
                            (image, jimage, set()), (wave, jwave, set())):
        names = {n for n in vars(jmod) if not n.startswith("_")
                 and not isinstance(getattr(jmod, n), type(sys))}
        assert names - skip <= set(vars(mod)), names - set(vars(mod))
    assert sim.AmbientNoiseParams is AmbientNoiseParams
    assert trace.trace is not None

