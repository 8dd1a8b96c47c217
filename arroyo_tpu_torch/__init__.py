"""arroyo_tpu_torch — the PyTorch/CUDA port of arroyo_tpu.

The same streaming engine (columnar batches, watermarks, keyed window
state, checkpoints) with its device state in torch tensors and its device
kernels written by hand in CUDA C++ for Hopper (``csrc/``, bound in
``kernels/``).  The package imports neither ``jax`` nor ``arroyo_tpu``:
the framework-neutral pieces it needs are carried over as copies, module
for module under the same names, so each module has an obvious
counterpart in ``arroyo_tpu``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :mod:`arroyo_tpu_torch.device`); nothing falls back
to the host quietly."""

__version__ = "0.1.0"

from .types import (  # noqa: F401
    Batch,
    CheckpointBarrier,
    Message,
    TaskInfo,
    Watermark,
    range_for_server,
    server_for_hash,
)
from .graph.logical import (  # noqa: F401
    AggKind,
    AggSpec,
    Program,
    SlidingWindow,
    Stream,
    TumblingWindow,
)
