"""The port's mesh IO (radarays_ros_tpu_torch.geom.mesh) and scene cache
(geom/cache.py) against the JAX package.

Every format is read by both packages from the same bytes, written by the
reference's save_ply/save_mesh or by hand; vertices, object ids and object
names must be bit-equal, and the files the port writes byte-identical to
the reference's. The binary PLY reader's one-read path for uniform faces is
held bit-identical to the record-by-record loop it replaces.
"""

import os

import numpy as np
import pytest
import torch

from radarays_ros_tpu.geom import mesh as jmesh
from radarays_ros_tpu.geom.primitives import make_box
from radarays_ros_tpu.geom.scene import Scene as JxScene

from radarays_ros_tpu_torch.geom import cache as pcache
from radarays_ros_tpu_torch.geom import mesh as pmesh
from radarays_ros_tpu_torch.geom.scene import Scene

torch.set_num_threads(2)


def _scenes():
    parts = [make_box((0, 0, 0), (20.0, 20.0, 6.0))[:, ::-1, :],
             make_box((5.0, 0.5, 0), (1.0, 1.5, 6.0)),
             make_box((-4.0, -3.0, 1.0), (2.0, 1.0, 2.0))]
    names = ["walls", "pillar", "crate"]
    return (JxScene.compose(parts, names, chunk_size=8),
            Scene.compose(parts, names, chunk_size=8))


def _assert_same_scene(got, want):
    np.testing.assert_array_equal(got.verts, want.verts)
    assert got.verts.dtype == want.verts.dtype == np.float32
    np.testing.assert_array_equal(got.obj_ids, want.obj_ids)
    assert got.obj_ids.dtype == want.obj_ids.dtype == np.int32
    assert (list(got.object_names) if got.object_names else None) == \
        (list(want.object_names) if want.object_names else None)
    assert got.chunk_size == want.chunk_size


_OBJ_TEXT = """\
# hand-written: groups, a quad, slashes, negative indices, unnamed group
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3
o first
v 0 0 1
v 1 0 1
v 1 1 1
v 0 1 1
f 5/1/1 6/2/1 7/3/1 8/4/1
g
v 2 2 2
v 3 2 2
v 2 3 2
f -3 -2 -1
g last group
f 1 3 4
"""

_STL_ASCII = """\
solid test
  facet normal 0 0 1
    outer loop
      vertex 0 0 0
      vertex 1 0 0
      vertex 0 1 0
    endloop
  endfacet
  facet normal 0 0 1
    outer loop
      vertex 1 1 0.5
      vertex 2 1 0.5
      vertex 1 2 0.25
    endloop
  endfacet
endsolid test
"""

_DAE = """\
<?xml version="1.0" encoding="utf-8"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
  <asset><unit meter="0.5"/><up_axis>Y_UP</up_axis></asset>
  <library_geometries>
    <geometry id="quad" name="Quad">
      <mesh>
        <source id="quad-pos">
          <float_array id="quad-pos-array" count="12">0 0 0 1 0 0 1 1 0 0 1 0</float_array>
          <technique_common><accessor source="#quad-pos-array" count="4" stride="3"/></technique_common>
        </source>
        <vertices id="quad-verts"><input semantic="POSITION" source="#quad-pos"/></vertices>
        <polylist count="1">
          <input semantic="VERTEX" source="#quad-verts" offset="0"/>
          <input semantic="NORMAL" source="#quad-pos" offset="1"/>
          <vcount>4</vcount>
          <p>0 0 1 1 2 2 3 3</p>
        </polylist>
      </mesh>
    </geometry>
    <geometry id="tri" name="Tri">
      <mesh>
        <source id="tri-pos">
          <float_array id="tri-pos-array" count="9">0 0 0 2 0 0 0 2 1</float_array>
        </source>
        <vertices id="tri-verts"><input semantic="POSITION" source="#tri-pos"/></vertices>
        <triangles count="1">
          <input semantic="VERTEX" source="#tri-verts" offset="0"/>
          <p>0 1 2</p>
        </triangles>
      </mesh>
    </geometry>
  </library_geometries>
  <library_nodes>
    <node id="lib-tri" name="shared_tri">
      <instance_geometry url="#tri"/>
    </node>
  </library_nodes>
  <library_visual_scenes>
    <visual_scene id="scene">
      <node id="n1" name="moved_quad">
        <translate>1 2 3</translate>
        <rotate>0 0 1 90</rotate>
        <scale>2 2 2</scale>
        <instance_geometry url="#quad"/>
      </node>
      <node id="n2" name="group">
        <matrix>1 0 0 5 0 1 0 0 0 0 1 0 0 0 0 1</matrix>
        <instance_node url="#lib-tri"/>
        <node id="n3" name="child_quad">
          <instance_geometry url="#quad"/>
        </node>
      </node>
    </visual_scene>
  </library_visual_scenes>
</COLLADA>
"""


def _mixed_ply(endian: str) -> bytes:
    """A binary PLY with a quad, a triangle and a pentagon (mixed polygon
    sizes: the record loop), an object id before the list and a double
    vertex coordinate."""
    e = "<" if endian == "little" else ">"
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                      [2, 2, 1], [3, 2, 1], [3, 3, 1]], np.float64)
    head = ("ply\nformat binary_" + endian + "_endian 1.0\n"
            "comment mixed polygons\n"
            "element vertex 7\nproperty double x\nproperty double y\n"
            "property double z\nelement face 3\nproperty short object_id\n"
            "property list uchar uint vertex_indices\nend_header\n").encode()
    body = verts.astype(e + "f8").tobytes()
    for obj, face in ((2, [0, 1, 2, 3]), (0, [4, 5, 6]),
                      (1, [0, 1, 2, 4, 3])):
        body += np.array(obj, e + "i2").tobytes()
        body += np.array(len(face), "u1").tobytes()
        body += np.array(face, e + "u4").tobytes()
    return head + body


def _quad_ply() -> bytes:
    """Big-endian binary PLY of uniform quads (the one-read path), with a
    scalar after the list and an extra vertex property."""
    verts = np.array([[0, 0, 0, 7], [1, 0, 0, 7], [1, 1, 0, 7], [0, 1, 0, 7],
                      [0, 0, 2, 7], [1, 0, 2, 7]], np.float32)
    head = ("ply\nformat binary_big_endian 1.0\nelement vertex 6\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float confidence\nelement face 2\n"
            "property list uchar int vertex_indices\nproperty int object_id\n"
            "end_header\n").encode()
    body = verts.astype(">f4").tobytes()
    for face, obj in (([0, 1, 2, 3], 4), ([0, 1, 5, 4], 1)):
        body += np.array(4, "u1").tobytes() + np.array(face, ">i4").tobytes()
        body += np.array(obj, ">i4").tobytes()
    return head + body


@pytest.mark.parametrize("kind", [
    "ply_binary", "ply_ascii", "save_mesh_ply", "save_mesh_obj",
    "save_mesh_stl", "obj_hand", "stl_ascii", "dae", "ply_mixed_little",
    "ply_mixed_big", "ply_quads_big"])
def test_load_mesh_matches_reference(tmp_path, kind):
    jscene, _ = _scenes()
    ext = {"obj_hand": ".obj", "save_mesh_obj": ".obj", "stl_ascii": ".stl",
           "save_mesh_stl": ".stl", "dae": ".dae"}.get(kind, ".ply")
    path = tmp_path / f"m{ext}"
    if kind == "ply_binary":
        jmesh.save_ply(path, jscene)
    elif kind == "ply_ascii":
        jmesh.save_ply(path, jscene, binary=False)
    elif kind.startswith("save_mesh_"):
        jmesh.save_mesh(path, jscene)
    elif kind == "obj_hand":
        path.write_text(_OBJ_TEXT)
    elif kind == "stl_ascii":
        path.write_text(_STL_ASCII)
    elif kind == "dae":
        path.write_text(_DAE)
    elif kind == "ply_quads_big":
        path.write_bytes(_quad_ply())
    else:
        path.write_bytes(_mixed_ply(kind.rsplit("_", 1)[1]))
    got = pmesh.load_mesh(path, chunk_size=8)
    want = jmesh.load_mesh(path, chunk_size=8)
    _assert_same_scene(got, want)
    assert got.n_triangles > 0
    if ext == ".obj":
        # the reference prefers its native parser when built; the port
        # equals the Python parser as well, names and ids included
        _assert_same_scene(got, jmesh._load_obj(path, 8))


def test_ply_uniform_faces_read_equals_record_loop(tmp_path, monkeypatch):
    """The one-read path for uniform faces against the record loop on the
    same file (a 3,000-face scene written by the reference)."""
    parts = [make_box((i * 3.0, 0, 0), (1.0, 1.0 + i, 2.0))
             for i in range(250)]
    jscene = JxScene.compose(parts, [f"b{i}" for i in range(250)])
    path = tmp_path / "many.ply"
    jmesh.save_ply(path, jscene)
    fast = pmesh.load_mesh(path)
    calls = []
    orig_loop = pmesh._ply_read_list_loop

    def loop(*a):
        calls.append(1)
        return orig_loop(*a)

    monkeypatch.setattr(pmesh, "_ply_read_uniform_lists", lambda *a: None)
    monkeypatch.setattr(pmesh, "_ply_read_list_loop", loop)
    slow = pmesh.load_mesh(path)
    assert calls
    _assert_same_scene(fast, slow)
    np.testing.assert_array_equal(fast.obj_ids, jscene.obj_ids)
    np.testing.assert_array_equal(fast.verts, jscene.verts)


@pytest.mark.parametrize("fmt", ["ply_binary", "ply_ascii", "obj", "ply",
                                 "stl"])
def test_written_files_are_byte_identical(tmp_path, fmt):
    jscene, scene = _scenes()
    a, b = tmp_path / f"ref_{fmt}", tmp_path / f"port_{fmt}"
    if fmt.startswith("ply_"):
        a, b = a.with_suffix(".ply"), b.with_suffix(".ply")
        jmesh.save_ply(a, jscene, binary=fmt == "ply_binary")
        pmesh.save_ply(b, scene, binary=fmt == "ply_binary")
    else:
        a, b = a.with_suffix("." + fmt), b.with_suffix("." + fmt)
        jmesh.save_mesh(a, jscene)
        pmesh.save_mesh(b, scene)
    assert a.read_bytes() == b.read_bytes()
    _assert_same_scene(pmesh.load_mesh(b, chunk_size=8),
                       jmesh.load_mesh(a, chunk_size=8))


def test_load_mesh_errors(tmp_path):
    with pytest.raises(ValueError, match="unsupported mesh format"):
        pmesh.load_mesh(tmp_path / "x.fbx")
    (tmp_path / "x.ply").write_bytes(b"nope\n")
    with pytest.raises(ValueError, match="not a PLY"):
        pmesh.load_mesh(tmp_path / "x.ply")


# ---------------------------------------------------------------- cache

@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    d = tmp_path / "scenes"
    monkeypatch.setenv("RADARAYS_SCENE_CACHE", str(d))
    monkeypatch.delenv("RADARAYS_SCENE_CACHE_DISABLE", raising=False)
    monkeypatch.delenv("RADARAYS_SCENE_CACHE_MAX_GB", raising=False)
    return d


def _assert_same_host(a, b):
    assert a._fields == b._fields
    for name, x, y in zip(a._fields, a, b):
        if name == "chunk_size":
            assert x == y and isinstance(x, int)
        else:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_scene_cache_round_trip(cache_dir):
    _, scene = _scenes()
    cold = scene.host_arrays(cache=False)
    assert not cache_dir.exists()
    built = scene.host_arrays(cache=True)
    entries = list(cache_dir.glob("*.npz"))
    assert len(entries) == 1
    _assert_same_host(built, cold)
    warm = scene.host_arrays(cache=True)
    _assert_same_host(warm, cold)
    st = scene.to_device("cpu", cache=True)
    assert st.n_chunks == cold.chunk_lo.shape[0]
    # the auto setting leaves small scenes uncached
    assert scene.n_triangles < 200_000
    os.unlink(entries[0])
    scene.host_arrays()
    assert not list(cache_dir.glob("*.npz"))


def test_scene_cache_key_is_the_ports_own(cache_dir):
    """The port's entries are keyed apart from the JAX package's, and by
    content: other vertices, ids or chunk size give another key."""
    from radarays_ros_tpu.geom import cache as jcache

    _, scene = _scenes()
    k = pcache.scene_cache_key(scene.verts, scene.obj_ids, 8)
    for flavor in ("numpy", "numpy-sah", pcache.BUILDER_FLAVOR):
        assert k != jcache.scene_cache_key(scene.verts, scene.obj_ids, 8,
                                           flavor)
    assert k != pcache.scene_cache_key(scene.verts, scene.obj_ids, 16)
    ids = scene.obj_ids.copy()
    ids[0] += 1
    assert k != pcache.scene_cache_key(scene.verts, ids, 8)
    v = scene.verts.copy()
    v[0, 0, 0] = np.nextafter(v[0, 0, 0], np.float32(1e9))
    assert k != pcache.scene_cache_key(v, scene.obj_ids, 8)


@pytest.mark.parametrize("damage", ["truncated", "missing_field", "garbage"])
def test_scene_cache_damaged_entry_is_a_miss(cache_dir, damage):
    _, scene = _scenes()
    cold = scene.host_arrays(cache=True)
    (path,) = cache_dir.glob("*.npz")
    if damage == "truncated":
        path.write_bytes(path.read_bytes()[:200])
    elif damage == "garbage":
        path.write_bytes(b"\0" * 64)
    else:
        with np.load(path) as z:
            kept = {k: z[k] for k in z.files if k != "planes_o"}
        np.savez(path, **kept)
    key = path.stem
    assert pcache.load_scene_host(key) is None
    _assert_same_host(scene.host_arrays(cache=True), cold)   # rebuilt
    assert pcache.load_scene_host(key) is not None


def test_scene_cache_disable_and_eviction(cache_dir, monkeypatch):
    _, scene = _scenes()
    monkeypatch.setenv("RADARAYS_SCENE_CACHE_DISABLE", "1")
    scene.host_arrays(cache=True)
    assert not cache_dir.exists()
    monkeypatch.delenv("RADARAYS_SCENE_CACHE_DISABLE")
    other = Scene(scene.verts + 1.0, scene.obj_ids, chunk_size=8)
    scene.host_arrays(cache=True)
    (first,) = cache_dir.glob("*.npz")
    os.utime(first, (1, 1))                   # least recently used
    monkeypatch.setenv("RADARAYS_SCENE_CACHE_MAX_GB",
                       str(first.stat().st_size * 1.5 / 1e9))
    other.host_arrays(cache=True)
    (left,) = cache_dir.glob("*.npz")
    assert left != first                      # the old entry was evicted
