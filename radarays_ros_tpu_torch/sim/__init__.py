from radarays_ros_tpu_torch.sim.config import (  # noqa: F401
    RadarModelConfig,
    RadarParams,
    Materials,
    AmbientNoiseParams,
)
from radarays_ros_tpu_torch.sim.pipeline import simulate_frame  # noqa: F401
from radarays_ros_tpu_torch.sim.radar import Radar  # noqa: F401
