from compressed_tensors_tpu_torch.engine.generate import (  # noqa: F401
    greedy_generate,
    make_step_fns,
)
from compressed_tensors_tpu_torch.engine.serving import (  # noqa: F401
    Completion,
    Request,
    ServingEngine,
)
