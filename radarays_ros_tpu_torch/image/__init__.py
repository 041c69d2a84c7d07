from radarays_ros_tpu_torch.image.perlin import (  # noqa: F401
    perlin_noise,
    perlin_noise_hilo,
)
from radarays_ros_tpu_torch.image.denoise import (  # noqa: F401
    make_denoiser_triangular,
    make_denoiser_gaussian,
    make_denoiser_maxwell_boltzmann,
    build_denoiser,
)
from radarays_ros_tpu_torch.image.draw import (  # noqa: F401
    draw_signals,
    apply_ambient_noise,
)
