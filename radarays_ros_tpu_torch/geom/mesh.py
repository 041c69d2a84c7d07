"""Mesh file IO: PLY (ascii + binary), OBJ, STL (ascii + binary) and Collada
DAE (counterpart of radarays_ros_tpu/geom/mesh.py, which replaces the
reference's rmagine map import, radar_simulator.cpp:149,164). NumPy, and
the C++ reader of native/builder.py for OBJ.

OBJ object/group statements (`o`/`g`) split the mesh into objects, giving
the per-triangle object ids that feed the `object_materials` lookup; PLY and
STL files yield a single object unless a per-face integer property named
`object_id` (PLY) is present.

Two differences from the reference, neither visible in the result:

  * a binary PLY whose faces all have the same vertex count is read with
    one structured `np.frombuffer` instead of a Python loop per face (at 1M
    faces the loop is 1M iterations); mixed polygons keep the loop, and the
    two give bit-identical scenes (tests/test_torch_mesh.py);
  * OBJ files are read by the port's C++ reader (native/builder.py:
    parse_obj), bit-equal to the Python `_load_obj` (tests/
    test_torch_native.py), as the reference reads them through its own when
    built; RADARAYS_NO_NATIVE=1 selects `_load_obj`.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from radarays_ros_tpu_torch.geom.scene import Scene


def load_mesh(path, chunk_size: int = 256) -> Scene:
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".ply":
        return _load_ply(path, chunk_size)
    if ext == ".obj":
        from radarays_ros_tpu_torch.native import builder as nb

        if nb.enabled():
            verts, obj_ids, names = nb.parse_obj(path)
            return Scene(verts, obj_ids, names or None, chunk_size)
        return _load_obj(path, chunk_size)
    if ext == ".stl":
        return _load_stl(path, chunk_size)
    if ext == ".dae":
        return _load_dae(path, chunk_size)
    raise ValueError(
        f"unsupported mesh format: {ext} (supported: .ply .obj .stl .dae)")


# ---------------------------------------------------------------- PLY

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _load_ply(path: Path, chunk_size: int) -> Scene:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [properties])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(("list", tokens[2], tokens[3],
                                            tokens[4]))
                else:
                    elements[-1][2].append(("scalar", tokens[1], tokens[2]))
            elif tokens[0] == "end_header":
                break
        if fmt == "ascii":
            data = _ply_read_ascii(f, elements)
        elif fmt in ("binary_little_endian", "binary_big_endian"):
            data = _ply_read_binary(
                f, elements, "<" if fmt.endswith("little_endian") else ">")
        else:
            raise ValueError(f"{path}: unknown PLY format {fmt}")

    verts = data["vertex"]
    xyz = np.stack([verts["x"], verts["y"], verts["z"]],
                   axis=-1).astype(np.float32)
    face_el = data.get("face")
    if face_el is None:
        raise ValueError(f"{path}: PLY has no face element")
    idx = face_el["__list__"]
    tris = _fan_triangulate(idx)
    obj_ids = np.zeros(len(tris), np.int32)
    if "object_id" in face_el:
        per_face_obj = np.asarray(face_el["object_id"], np.int32)
        obj_ids = per_face_obj[_fan_face_origin(idx)]
    return Scene(xyz[np.asarray(tris, np.int64)], obj_ids,
                 chunk_size=chunk_size)


def _fan_triangulate(faces):
    """Fan triangles (face[0], face[k], face[k+1]) in face order; `faces`
    is a list of index lists or an (F, n) array of equal-size faces."""
    if isinstance(faces, np.ndarray):
        F, n = faces.shape
        if n < 3:
            return np.zeros((0, 3), np.int64)
        fans = [np.stack([faces[:, 0], faces[:, k], faces[:, k + 1]], -1)
                for k in range(1, n - 1)]
        return np.stack(fans, axis=1).reshape(-1, 3).astype(np.int64)
    tris = []
    for face in faces:
        for k in range(1, len(face) - 1):
            tris.append((face[0], face[k], face[k + 1]))
    return np.asarray(tris, np.int64)


def _fan_face_origin(faces):
    if isinstance(faces, np.ndarray):
        F, n = faces.shape
        return np.repeat(np.arange(F, dtype=np.int64), max(n - 2, 0))
    out = []
    for i, face in enumerate(faces):
        out.extend([i] * (len(face) - 2))
    return np.asarray(out, np.int64)


def _ply_read_ascii(f, elements):
    data = {}
    text = f.read().decode("ascii", "replace").split()
    pos = 0
    for name, count, props in elements:
        cols = {p[1] if p[0] == "list" else p[2]: [] for p in props}
        lists = []
        for _ in range(count):
            for p in props:
                if p[0] == "list":
                    n = int(text[pos])
                    pos += 1
                    lists.append([float(text[pos + i]) for i in range(n)])
                    pos += n
                else:
                    cols[p[2]].append(float(text[pos]))
                    pos += 1
        el = {k: np.asarray(v) for k, v in cols.items() if v}
        if lists:
            el["__list__"] = [[int(v) for v in li] for li in lists]
        data[name] = el
    return data


def _ply_read_uniform_lists(f, count, props, endian):
    """One structured read of an element whose list properties all have the
    count of the first record; None (file position restored) when the
    element has more than one list property, or any record's count
    differs."""
    lists = [p for p in props if p[0] == "list"]
    if count == 0 or len(lists) != 1:
        return None
    start = f.tell()
    # the first record's list count fixes the record layout
    fields, offset, n = [], 0, 0
    for p in props:
        if p[0] == "list":
            cnt_dt = np.dtype(endian + _PLY_DTYPES[p[1]])
            raw = f.read(offset + cnt_dt.itemsize)
            f.seek(start)
            if len(raw) < offset + cnt_dt.itemsize:
                return None
            n = int(np.frombuffer(raw, cnt_dt, 1, offset)[0])
            item_dt = np.dtype(endian + _PLY_DTYPES[p[2]])
            fields += [("__count__", cnt_dt), ("__list__", item_dt, (n,))]
            offset += cnt_dt.itemsize + item_dt.itemsize * n
        else:
            dt = np.dtype(endian + _PLY_DTYPES[p[1]])
            fields.append((p[2], dt))
            offset += dt.itemsize
    if n == 0:
        return None
    rec_dt = np.dtype(fields)
    buf = f.read(rec_dt.itemsize * count)
    if len(buf) < rec_dt.itemsize * count:
        f.seek(start)
        return None
    rec = np.frombuffer(buf, rec_dt, count)
    if not np.all(rec["__count__"] == n):
        f.seek(start)
        return None
    el = {p[2]: rec[p[2]].astype(rec.dtype[p[2]].newbyteorder("="))
          for p in props if p[0] == "scalar"}
    el["__list__"] = rec["__list__"].reshape(count, n).astype(np.int64)
    return el


def _ply_read_binary(f, elements, endian):
    data = {}
    for name, count, props in elements:
        has_list = any(p[0] == "list" for p in props)
        if not has_list:
            dt = np.dtype([(p[2], endian + _PLY_DTYPES[p[1]]) for p in props])
            arr = np.frombuffer(f.read(dt.itemsize * count), dtype=dt,
                                count=count)
            data[name] = {p[2]: arr[p[2]] for p in props}
            continue
        el = _ply_read_uniform_lists(f, count, props, endian)
        if el is None:
            el = _ply_read_list_loop(f, count, props, endian)
        data[name] = el
    return data


def _ply_read_list_loop(f, count, props, endian):
    """The reference's record-by-record read (mixed polygon sizes)."""
    el = {p[2]: [] for p in props if p[0] == "scalar"}
    lists = []
    for _ in range(count):
        for p in props:
            if p[0] == "list":
                cnt_dt = np.dtype(endian + _PLY_DTYPES[p[1]])
                n = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
                item_dt = np.dtype(endian + _PLY_DTYPES[p[2]])
                vals = np.frombuffer(f.read(item_dt.itemsize * n), item_dt, n)
                lists.append([int(v) for v in vals])
            else:
                item_dt = np.dtype(endian + _PLY_DTYPES[p[1]])
                el[p[2]].append(
                    np.frombuffer(f.read(item_dt.itemsize), item_dt)[0])
    el = {k: np.asarray(v) for k, v in el.items() if v}
    el["__list__"] = lists
    return el


def save_ply(path, scene: Scene, binary: bool = True):
    """Write a Scene back to PLY with a per-face object_id property (the
    export role of the reference's mesh_publisher, mesh_publisher.cpp)."""
    verts = scene.verts.reshape(-1, 3)
    n_v = verts.shape[0]
    n_f = scene.n_triangles
    faces = np.arange(n_v, dtype=np.int32).reshape(n_f, 3)
    header = (
        "ply\n"
        + ("format binary_little_endian 1.0\n" if binary
           else "format ascii 1.0\n")
        + f"element vertex {n_v}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {n_f}\n"
        "property list uchar int vertex_indices\n"
        "property int object_id\n"
        "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(verts.astype("<f4").tobytes())
            face_dt = np.dtype([("n", "u1"), ("i", "<i4", 3), ("obj", "<i4")])
            rec = np.empty(n_f, face_dt)
            rec["n"] = 3
            rec["i"] = faces
            rec["obj"] = scene.obj_ids
            f.write(rec.tobytes())
        else:
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n".encode())
            for face, obj in zip(faces, scene.obj_ids):
                f.write(f"3 {face[0]} {face[1]} {face[2]} {obj}\n".encode())


# ---------------------------------------------------------------- OBJ

def _load_obj(path: Path, chunk_size: int) -> Scene:
    verts = []
    tris = []
    obj_ids = []
    names = []
    current = 0
    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append((float(t[1]), float(t[2]), float(t[3])))
            elif t[0] in ("o", "g"):
                # every o/g statement opens a new object
                names.append(t[1] if len(t) > 1 else f"object_{len(names)}")
                current = len(names) - 1
            elif t[0] == "f":
                idx = [int(tok.split("/")[0]) for tok in t[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
                    obj_ids.append(current)
    v = np.asarray(verts, np.float32)
    tri_idx = np.asarray(tris, np.int64)
    return Scene(v[tri_idx], np.asarray(obj_ids, np.int32),
                 names or None, chunk_size)


# ---------------------------------------------------------------- STL

def _load_stl(path: Path, chunk_size: int) -> Scene:
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    if head[:5].lower() == b"solid" and b"facet" in rest[:1000]:
        tris = []
        cur = []
        for line in (head + rest).decode("ascii", "replace").splitlines():
            t = line.split()
            if t[:1] == ["vertex"]:
                cur.append((float(t[1]), float(t[2]), float(t[3])))
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
        verts = np.asarray(tris, np.float32)
    else:
        n = struct.unpack("<I", rest[:4])[0]
        dt = np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)), ("attr", "<u2")])
        rec = np.frombuffer(rest[4:4 + n * dt.itemsize], dt, n)
        verts = np.ascontiguousarray(rec["v"], np.float32)
    return Scene(verts, np.zeros(len(verts), np.int32), chunk_size=chunk_size)


# ---------------------------------------------------------------- DAE

def _dae_tag(el) -> str:
    """Element tag with the COLLADA namespace stripped."""
    return el.tag.rsplit("}", 1)[-1]


def _dae_find_all(parent, tag):
    return [el for el in parent.iter() if _dae_tag(el) == tag]


def _dae_children(parent, tag):
    return [el for el in parent if _dae_tag(el) == tag]


def _dae_floats(text) -> np.ndarray:
    return np.asarray((text or "").split(), np.float64)


def _dae_geometry_triangles(geom) -> np.ndarray:
    """(T, 3, 3) float64 triangle soup of one <geometry>, local coords:
    <triangles>, <polylist> and <polygons> (fan-triangulated), with the
    VERTEX input resolved through the <vertices> POSITION indirection."""
    mesh = _dae_children(geom, "mesh")
    if not mesh:
        return np.zeros((0, 3, 3))
    mesh = mesh[0]

    sources = {}
    for src in _dae_children(mesh, "source"):
        arr = _dae_children(src, "float_array")
        if arr:
            acc = _dae_find_all(src, "accessor")
            stride = int(acc[0].get("stride", 3)) if acc else 3
            data = _dae_floats(arr[0].text)
            sources["#" + src.get("id", "")] = data.reshape(-1, stride)[:, :3]

    vertices = {}
    for v in _dae_children(mesh, "vertices"):
        for inp in _dae_children(v, "input"):
            if inp.get("semantic") == "POSITION":
                vertices["#" + v.get("id", "")] = sources.get(
                    inp.get("source"), np.zeros((0, 3)))

    tris = []
    for prim in mesh:
        kind = _dae_tag(prim)
        if kind not in ("triangles", "polylist", "polygons"):
            continue
        inputs = _dae_children(prim, "input")
        v_off, positions, stride = 0, None, 1
        for inp in inputs:
            off = int(inp.get("offset", 0))
            stride = max(stride, off + 1)
            if inp.get("semantic") == "VERTEX":
                v_off = off
                positions = vertices.get(inp.get("source"))
                if positions is None:
                    positions = sources.get(inp.get("source"))
        if positions is None or not len(positions):
            continue

        def emit_polygon(idx):
            for k in range(1, len(idx) - 1):
                tris.append(positions[[idx[0], idx[k], idx[k + 1]]])

        if kind == "polylist":
            vcount = np.asarray(
                (_dae_children(prim, "vcount")[0].text or "").split(), int)
            p = np.asarray(
                (_dae_children(prim, "p")[0].text or "").split(), int)
            p = p.reshape(-1, stride)[:, v_off]
            pos = 0
            for n in vcount:
                emit_polygon(p[pos:pos + n])
                pos += n
        else:
            for p_el in _dae_children(prim, "p"):
                p = np.asarray((p_el.text or "").split(), int)
                p = p.reshape(-1, stride)[:, v_off]
                if kind == "triangles":
                    for i in range(0, len(p), 3):
                        tris.append(positions[p[i:i + 3]])
                else:  # <polygons>: one <p> per polygon
                    emit_polygon(p)
    if not tris:
        return np.zeros((0, 3, 3))
    return np.stack(tris)


def _dae_node_transform(node) -> np.ndarray:
    """Compose this node's transform elements in document order -> 4x4."""
    M = np.eye(4)
    for el in node:
        tag = _dae_tag(el)
        if tag == "matrix":
            M = M @ _dae_floats(el.text).reshape(4, 4)
        elif tag == "translate":
            T = np.eye(4)
            T[:3, 3] = _dae_floats(el.text)[:3]
            M = M @ T
        elif tag == "rotate":
            x, y, z, deg = _dae_floats(el.text)[:4]
            axis = np.array([x, y, z])
            n = np.linalg.norm(axis)
            if n > 0:
                axis /= n
                a = np.deg2rad(deg)
                K = np.array([[0, -axis[2], axis[1]],
                              [axis[2], 0, -axis[0]],
                              [-axis[1], axis[0], 0]])
                R4 = np.eye(4)
                R4[:3, :3] = (np.eye(3) + np.sin(a) * K
                              + (1 - np.cos(a)) * (K @ K))
                M = M @ R4
        elif tag == "scale":
            S = np.eye(4)
            S[[0, 1, 2], [0, 1, 2]] = _dae_floats(el.text)[:3]
            M = M @ S
    return M


def _load_dae(path: Path, chunk_size: int) -> Scene:
    """Minimal Collada import: library_geometries, the visual-scene node
    hierarchy (matrix/translate/rotate/scale, instance_geometry,
    instance_node), the asset unit scale and Y_UP/X_UP -> Z_UP. Each scene
    node instancing geometry becomes one object named after the node;
    without a visual scene every geometry loads once at identity."""
    import xml.etree.ElementTree as ET

    root = ET.parse(str(path)).getroot()
    if _dae_tag(root) != "COLLADA":
        raise ValueError(f"{path}: not a COLLADA document")

    unit = 1.0
    up = "Z_UP"
    for asset in _dae_children(root, "asset"):
        for u in _dae_children(asset, "unit"):
            unit = float(u.get("meter", "1"))
        for ua in _dae_children(asset, "up_axis"):
            up = (ua.text or "Z_UP").strip()

    geoms = {}
    for lib in _dae_children(root, "library_geometries"):
        for geom in _dae_children(lib, "geometry"):
            tris = _dae_geometry_triangles(geom)
            geoms["#" + geom.get("id", "")] = (
                tris, geom.get("name") or geom.get("id") or "geometry")

    lib_nodes = {}
    for lib in _dae_children(root, "library_nodes"):
        for node in _dae_children(lib, "node"):
            lib_nodes["#" + node.get("id", "")] = node

    parts, names = [], []

    def walk(node, M):
        M = M @ _dae_node_transform(node)
        for el in node:
            tag = _dae_tag(el)
            if tag == "instance_geometry":
                tris, gname = geoms.get(el.get("url", ""), (None, None))
                if tris is not None and len(tris):
                    v = tris.reshape(-1, 3) @ M[:3, :3].T + M[:3, 3]
                    parts.append(v.reshape(-1, 3, 3))
                    names.append(node.get("name") or node.get("id") or gname)
            elif tag == "instance_node":
                target = lib_nodes.get(el.get("url", ""))
                if target is not None:
                    walk(target, M)
            elif tag == "node":
                walk(el, M)

    for lib in _dae_children(root, "library_visual_scenes"):
        for vs in _dae_children(lib, "visual_scene"):
            for node in _dae_children(vs, "node"):
                walk(node, np.eye(4))

    if not parts:
        for tris, gname in geoms.values():
            if len(tris):
                parts.append(tris)
                names.append(gname)
    if not parts:
        raise ValueError(f"{path}: no triangle geometry found")

    verts = np.concatenate(parts, axis=0) * unit
    if up == "Y_UP":          # (x, y, z) -> (x, -z, y)
        verts = verts[:, :, [0, 2, 1]] * np.array([1.0, -1.0, 1.0])
    elif up == "X_UP":        # (x, y, z) -> (-z, y, x)
        verts = verts[:, :, [2, 1, 0]] * np.array([-1.0, 1.0, 1.0])
    obj_ids = np.concatenate(
        [np.full(len(p), i, np.int32) for i, p in enumerate(parts)])
    return Scene(verts.astype(np.float32), obj_ids, names, chunk_size)


# ---------------------------------------------------------------- export

def save_mesh(path, scene: Scene) -> None:
    """Write a Scene to disk: .obj with one object per id, or binary .ply /
    .stl as a single soup (the reference's mesh_publisher counterpart,
    mesh_publisher.cpp:15-172)."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".obj":
        lines = []
        vi = 1
        names = scene.object_names or [
            f"object_{i}" for i in range(scene.n_objects)]
        for oid in range(scene.n_objects):
            tris = scene.verts[scene.obj_ids == oid]
            if not len(tris):
                continue
            lines.append(f"o {names[oid] if oid < len(names) else oid}")
            for t in tris:
                for v in t:
                    lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
                lines.append(f"f {vi} {vi + 1} {vi + 2}")
                vi += 3
        path.write_text("\n".join(lines) + "\n")
    elif ext == ".ply":
        T = scene.n_triangles
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {T * 3}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {T}\n"
            "property list uchar int vertex_indices\n"
            "property int object_id\n"
            "end_header\n"
        ).encode("ascii")
        v = np.ascontiguousarray(scene.verts.reshape(-1, 3), "<f4")
        face = np.empty(T, np.dtype([("n", "u1"), ("idx", "<i4", 3),
                                     ("obj", "<i4")]))
        face["n"] = 3
        face["idx"] = np.arange(T * 3, dtype=np.int32).reshape(T, 3)
        face["obj"] = scene.obj_ids
        path.write_bytes(header + v.tobytes() + face.tobytes())
    elif ext == ".stl":
        T = scene.n_triangles
        e1 = scene.verts[:, 1] - scene.verts[:, 0]
        e2 = scene.verts[:, 2] - scene.verts[:, 0]
        n = np.cross(e1, e2)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        rec = np.empty(T, np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)),
                                    ("attr", "<u2")]))
        rec["n"] = n
        rec["v"] = scene.verts
        rec["attr"] = 0
        path.write_bytes(b"\0" * 80 + struct.pack("<I", T) + rec.tobytes())
    else:
        raise ValueError(f"unsupported export format {ext}")
