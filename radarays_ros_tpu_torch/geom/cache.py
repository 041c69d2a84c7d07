"""On-disk cache of finished host builds (counterpart of
radarays_ros_tpu/geom/cache.py).

The SAH ordering and plane precompute of a ~1M-triangle scene take many
seconds of NumPy on the host; the reference's Embree map import takes
seconds (src/radar_simulator.cpp:149). `Scene.host_arrays(cache=...)`
therefore persists the finished `SceneHost`, keyed by a content hash of
(vertices, object ids, chunk_size, layout version, builder flavor), and a
warm start costs one np.load.

The port's entries hold its own host build (`SceneHost`: f32 planes and
AABBs, no bf16 kernel tables), so its layout version and builder flavor are
its own and are folded into the key: an entry of the JAX package can never
be mistaken for one of the port's, even in a shared cache directory. The
flavor (geom/scene.py:cache_flavor) names the ordering variant and the
builder's table version, and for the median split the builder too: the SAH
build's bytes are the same from the C++ library and from NumPy, so the two
share its entries.

Storage: one .npz per scene under RADARAYS_SCENE_CACHE (default
~/.cache/radarays_tpu/scenes), written atomically (temporary file + rename)
so concurrent builders race benignly; an entry missing a field (a
half-written or foreign file) is a miss. After every store the least
recently used entries are evicted until the directory fits
RADARAYS_SCENE_CACHE_MAX_GB (default 24; 0 disables eviction).
"""

from __future__ import annotations

import hashlib
import logging
import os
import tempfile
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np

_log = logging.getLogger(__name__)

# bump when the SceneHost field set or a table layout changes
LAYOUT_VERSION = 1

# the prefix of the port's builder flavors (geom/scene.py:cache_flavor)
BUILDER_FLAVOR = "torch"

DEFAULT_MAX_GB = 24.0


def default_cache_dir() -> Path:
    env = os.environ.get("RADARAYS_SCENE_CACHE")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "radarays_tpu" / "scenes"


def scene_cache_key(verts: np.ndarray, obj_ids: np.ndarray, chunk_size: int,
                    builder_flavor: Optional[str] = None) -> str:
    """Content hash of everything host_arrays derives its output from; the
    flavor defaults to that of the active builder and ordering."""
    if builder_flavor is None:
        from radarays_ros_tpu_torch.geom.scene import cache_flavor

        builder_flavor = cache_flavor()
    h = hashlib.sha256()
    h.update(f"torch-v{LAYOUT_VERSION}|{chunk_size}|{builder_flavor}|"
             f"{verts.shape}|{obj_ids.shape}|".encode())
    h.update(np.ascontiguousarray(verts, np.float32).tobytes())
    h.update(np.ascontiguousarray(obj_ids, np.int32).tobytes())
    return h.hexdigest()[:32]


def load_scene_host(key: str, cache_dir: Optional[Path] = None):
    """Return the cached SceneHost for `key`, or None."""
    from radarays_ros_tpu_torch.geom.scene import SceneHost

    path = (cache_dir or default_cache_dir()) / f"{key}.npz"
    if not path.exists():
        return None
    try:
        with np.load(path) as z:
            if not set(SceneHost._fields) <= set(z.files):
                return None          # written by another field set
            fields = {name: z[name] for name in SceneHost._fields}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile):
        return None                  # truncated or corrupt: rebuild
    fields["chunk_size"] = int(fields["chunk_size"])
    try:  # refresh mtime: LRU eviction treats this entry as just used
        os.utime(path)
    except OSError:
        pass
    return SceneHost(**fields)


def store_scene_host(key: str, host, cache_dir: Optional[Path] = None) -> Path:
    """Persist a SceneHost under `key` (atomic rename)."""
    d = cache_dir or default_cache_dir()
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"{key}.npz"
    out = {name: np.asarray(val) for name, val in zip(host._fields, host)}
    out["chunk_size"] = np.int64(host.chunk_size)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **out)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _log.info("scene cache: wrote %s (%.2f GB)", path.name,
              path.stat().st_size / 1e9)
    _evict_to_cap(d, keep=path)
    return path


def _evict_to_cap(d: Path, keep: Optional[Path] = None) -> None:
    """Evict least-recently-used entries until the cache fits its cap; the
    just-written entry `keep` is never evicted."""
    try:
        cap_gb = float(os.environ.get("RADARAYS_SCENE_CACHE_MAX_GB",
                                      str(DEFAULT_MAX_GB)))
    except ValueError:
        cap_gb = DEFAULT_MAX_GB
    if cap_gb <= 0:
        return
    cap = int(cap_gb * 1e9)
    try:
        entries = [(p.stat().st_mtime, p.stat().st_size, p)
                   for p in d.glob("*.npz")]
    except OSError:
        return
    total = sum(sz for _, sz, _ in entries)
    for _, sz, p in sorted(entries):  # oldest mtime first
        if total <= cap:
            break
        if keep is not None and p == keep:
            continue
        try:
            p.unlink()
            total -= sz
            _log.info("scene cache: evicted %s (%.2f GB) to fit the %.1f GB "
                      "cap", p.name, sz / 1e9, cap_gb)
        except OSError:
            pass
