from radarays_ros_tpu_torch.wave.types import (  # noqa: F401
    Waves,
    make_start_wave_attrs,
)
from radarays_ros_tpu_torch.wave.cone import (  # noqa: F401
    sample_cone_dirs,
    sample_cone_local,
    sample_cone_mean,
)
from radarays_ros_tpu_torch.wave.fresnel import (  # noqa: F401
    fresnel_split,
    back_reflection_shader,
    get_incidence_angle,
)
from radarays_ros_tpu_torch.wave.radar_math import (  # noqa: F401
    M_C,
    erfinvf,
    quantile,
)
