"""Material optimization: metrics, param-vector parity, optimizers, workload
(counterpart of radarays_ros_tpu/opti; its evaluate.py waits for the port's
I/O modules)."""

from radarays_ros_tpu_torch.opti.metrics import (  # noqa: F401
    mse,
    mutual_information,
    normalized_mutual_information,
    psnr,
    ssim,
    variation_of_information,
)
from radarays_ros_tpu_torch.opti.optimize import (  # noqa: F401
    OptResult,
    ParamVector,
    default_objective,
    optimize_black_box,
    optimize_gradient,
    sweep_n_reflections,
)
from radarays_ros_tpu_torch.opti.workload import (  # noqa: F401
    RadarImageServer,
    msg_to_params,
    params_to_msg,
)
