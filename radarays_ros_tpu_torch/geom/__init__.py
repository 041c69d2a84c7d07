from radarays_ros_tpu_torch.geom.scene import Scene, SceneTensors  # noqa: F401
from radarays_ros_tpu_torch.geom.primitives import (  # noqa: F401
    make_box,
    make_plane,
    make_cylinder,
    make_icosphere,
)
from radarays_ros_tpu_torch.geom.mesh import load_mesh, save_ply  # noqa: F401
