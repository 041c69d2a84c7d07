"""The port's host builders (radarays_ros_tpu_torch.geom) against the JAX
package: procedural scenes, SAH ordering, planes and chunk AABBs must be
bit-identical, since the port cannot import the reference's NumPy code."""

import numpy as np
import pytest
import torch

from radarays_ros_tpu.geom import primitives as JG
from radarays_ros_tpu.geom import scene as JS
from radarays_ros_tpu.native import builder as native_builder

from radarays_ros_tpu_torch.geom import primitives as G
from radarays_ros_tpu_torch.geom import scene as S

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [dict(n_buildings=40, extent=60.0, seed=3),
                                dict(n_buildings=300, extent=140.0, seed=11),
                                dict(n_buildings=5, extent=20.0, seed=0,
                                     ground=False)])
def test_make_urban_scene_bit_identical(kw):
    parts, names = G.make_urban_scene(**kw)
    jparts, jnames = JG.make_urban_scene(**kw)
    assert names == jnames
    for p, q in zip(parts, jparts):
        assert p.dtype == q.dtype == np.float32
        np.testing.assert_array_equal(p, q)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_make_box_and_plane_bit_identical(axis):
    np.testing.assert_array_equal(G.make_box((1, 2, 3), (4.5, 2.0, 7.0)),
                                  JG.make_box((1, 2, 3), (4.5, 2.0, 7.0)))
    np.testing.assert_array_equal(
        G.make_plane((1, -2, 0.5), (3.0, 5.0), axis, flip=True),
        JG.make_plane((1, -2, 0.5), (3.0, 5.0), axis, flip=True))


def test_sah_order_bit_identical():
    tris = np.random.default_rng(11).normal(size=(2048, 3, 3)) \
        .astype(np.float32)
    args = (tris.mean(axis=1), tris.min(axis=1), tris.max(axis=1), 64)
    np.testing.assert_array_equal(S._median_split_order_sah(*args),
                                  JS._median_split_order_sah(*args))


def test_triangle_planes_bit_identical():
    tris = np.random.default_rng(5).normal(size=(1000, 3, 3)) \
        .astype(np.float32)
    n, po = S._triangle_planes(tris)
    jn, jpo, _ = JS._triangle_planes(tris)
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(po, jpo)


@pytest.mark.parametrize("chunk_size", [8, 16])
def test_host_build_bit_identical(monkeypatch, chunk_size):
    """Padding, SAH order, normals, planes and chunk AABBs equal the
    reference's NumPy Scene.device_arrays build."""
    monkeypatch.setattr(native_builder, "available", lambda: False)
    monkeypatch.setenv("RADARAYS_ORDER_VARIANT", "sah")
    parts, names = G.make_urban_scene(n_buildings=60, extent=80.0, seed=4)
    h = S.Scene.compose(parts, names, chunk_size=chunk_size).host_arrays()
    sa = JS.Scene.compose(parts, names, chunk_size=chunk_size) \
        .device_arrays(cache=False)
    np.testing.assert_array_equal(h.verts, sa.verts)
    np.testing.assert_array_equal(h.obj_ids, sa.obj_ids)
    np.testing.assert_array_equal(h.normals, sa.normals)
    np.testing.assert_array_equal(h.planes_o, sa.planes_o)
    np.testing.assert_array_equal(h.chunk_lo, sa.chunk_aabb_lo)
    np.testing.assert_array_equal(h.chunk_hi, sa.chunk_aabb_hi)
    assert h.verts.shape[0] % (8 * chunk_size) == 0


def test_edge_coefficients_reconstruct_reference_tables():
    """coef's A_k/B_k and (n, c) equal the values the reference splits into
    its bf16 sweep table: summing the table's three bf16 parts per slot
    reconstructs them exactly."""
    parts, names = G.make_urban_scene(n_buildings=10, extent=30.0, seed=2)
    h = S.Scene.compose(parts, names, chunk_size=8).host_arrays()
    coef = S.edge_coefficients(h.planes_o)
    a_tbl, b_tbl = JS._sweep_tables(h.planes_o, 8)
    T = coef.shape[0]
    C = T // 8
    # B table (40, C*3*tc): rows 0-17 = B_k,c part i (pairs (i, j)); the
    # table-side parts of a slot are i in _SPLIT_PAIRS order, so summing
    # the first-part slots (i = 0, 1, 2 at j = 0, 0, 0) gives the value
    e = b_tbl.astype(np.float32).T.reshape(C, 3, 8, 40).transpose(0, 2, 1, 3) \
        .reshape(T, 3, 40)
    pairs = JS._SPLIT_PAIRS
    sel = [pairs.index((i, 0)) for i in range(3)]

    def value(cols, comp):          # cols (T, 3, 40) -> (T, 3) component c
        return sum(cols[..., comp * 6 + s] for s in sel)

    B = np.stack([value(e, c) for c in range(3)], -1)          # (T, 3, 3)
    A = np.stack([value(e[..., 18:], c) for c in range(3)], -1)
    np.testing.assert_array_equal(coef[:, 13:22].reshape(T, 3, 3), B)
    np.testing.assert_array_equal(coef[:, 4:13].reshape(T, 3, 3), A)
    np.testing.assert_array_equal(coef[:, 0:3], h.planes_o[0::4, :3])
    np.testing.assert_array_equal(coef[:, 3], h.planes_o[0::4, 3])


def test_scene_tensors_fetch_rows_and_bake():
    parts, names = G.make_urban_scene(n_buildings=8, extent=30.0, seed=1)
    scene = S.Scene.compose(parts, names, chunk_size=8)
    h = scene.host_arrays()
    st = S.scene_tensors(h, "cpu")
    f = st.fetch.numpy()
    np.testing.assert_array_equal(f[:, 0:3], h.verts[:, 0])
    np.testing.assert_array_equal(f[:, 3:6], h.verts[:, 1] - h.verts[:, 0])
    np.testing.assert_array_equal(f[:, 6:9], h.verts[:, 2] - h.verts[:, 0])
    np.testing.assert_array_equal(f[:, 9:12], h.normals)
    np.testing.assert_array_equal(f[:, 12].view(np.int32), h.obj_ids)
    assert (h.obj_ids == S.INVALID_OBJ_ID).any()    # padding present
    assert st.coef.shape == (st.n_triangles, 22)
    assert st.n_chunks * st.chunk_size == st.n_triangles
    row = torch.arange(st.n_triangles, dtype=torch.float32)
    baked = S.bake_tri_aux(st, row)
    np.testing.assert_array_equal(baked.fetch[:, 13].numpy(), row.numpy())
    assert (st.fetch[:, 13] == 0).all()               # original untouched
    with pytest.raises(ValueError, match="tri_aux"):
        S.bake_tri_aux(st, row[:-1])
