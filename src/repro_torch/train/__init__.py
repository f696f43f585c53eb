"""Training on the port (the reference's ``train/``): AdamW, checkpoints
in the reference's on-disk layout, the checkpoint/restart supervisor and
compressed data-parallel gradients."""

from repro_torch.train.checkpoint import (  # noqa: F401
    AsyncCheckpointer,
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.fault_tolerance import (  # noqa: F401
    FailureInjector,
    InjectedFailure,
    StragglerDetector,
    SupervisorReport,
    TrainSupervisor,
)
from repro_torch.train.grad_compression import (  # noqa: F401
    dequantize_int8,
    init_error_state,
    make_compressed_dp_train_step,
    quantize_int8,
    topk_sparsify,
)
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    global_norm,
    init_opt_state,
)
