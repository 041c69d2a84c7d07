"""Debug visualization: ray-reflection traces (rviz markers -> data), the
paper-style cartesian view and the 2-D physics explorer panels (explore.py
over brdf.py, reflections.py and beams.py) — counterpart of
radarays_ros_tpu/viz."""

from radarays_ros_tpu_torch.viz.rays import (  # noqa: F401
    segments_to_polylines,
    trace_debug_rays,
)
