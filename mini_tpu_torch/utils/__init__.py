from mini_tpu_torch.utils.timing import Timing, time_fn, wall_timer  # noqa: F401
from mini_tpu_torch.utils.validate import (  # noqa: F401
    validate_exact,
    validate_close,
    display_device_data,
)
from mini_tpu_torch.utils.checkpoint import save_pytree, load_pytree  # noqa: F401
from mini_tpu_torch.utils.profiling import trace, scope, annotate  # noqa: F401
