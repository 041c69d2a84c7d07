"""IO layer: YAML configs, trajectories, polar-image files, real-frame
sequences and the CLI (counterpart of radarays_ros_tpu/io); see
io/config.py, io/trajectory.py, io/image_io.py, io/realdata.py, io/cli.py.
"""

from radarays_ros_tpu_torch.io.config import (  # noqa: F401
    SceneConfig,
    flatten_dyncfg,
    load_preset,
    load_scene_config,
    load_yaml,
    save_preset,
    save_scene_config,
    velocity_table,
)
from radarays_ros_tpu_torch.io.image_io import (  # noqa: F401
    polar_to_points,
    read_png_gray,
    save_frame,
    write_png_gray,
)
from radarays_ros_tpu_torch.io.trajectory import Trajectory  # noqa: F401
