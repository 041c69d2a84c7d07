"""The benchmark's scenes, one module a kind: `soup(**params)` returns
(verts (T, 3, 3) float32, object ids (T,) int32, number of objects)."""
