from radarays_ros_tpu_torch.trace.api import TraceResult, trace  # noqa: F401
