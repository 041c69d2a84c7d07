"""Debug visualization: ray-reflection traces (rviz markers -> data) and the
paper-style cartesian view (counterpart of radarays_ros_tpu/viz; the
explorer panels of viz/explore.py, brdf.py, beams.py and reflections.py
are not ported yet, ROADMAP M12)."""

from radarays_ros_tpu_torch.viz.rays import (  # noqa: F401
    segments_to_polylines,
    trace_debug_rays,
)
