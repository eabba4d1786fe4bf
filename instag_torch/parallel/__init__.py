"""The parallel modes on ``torch.distributed`` (counterpart of
instag_tpu/parallel/): one process a rank, one device a process.

  * frame data parallelism for adaptation (``--data_parallel B``): the
    model is replicated, each of the W ranks renders and differentiates
    ``B / W`` of a step's B frames, and the gradients are mean-reduced
    before one optimizer update (``train.face``, ``train.mouth``,
    ``train.fuse``; ``data_parallel.make_dp_face_step``). With W = 1 this
    is ``--data_parallel B`` on one card;
  * identity parallelism for pre-training (``--identity_parallel``,
    ``identity_parallel``): one identity a rank, its cloud, PMF and their
    optimizers on its rank; the UMF replicated, its gradients
    mean-reduced;
  * tensor-parallel rendering (``tensor_parallel``): splats sharded for
    the projection, the projected rows gathered, tile-row bands
    composited a rank;
  * the multi-process input and checkpoint helpers (``multihost``).

The collectives are explicit (``comm``); the process group and the
placement helpers are in ``mesh``.
"""

from .comm import all_gather, check_replicas, gather_rows  # noqa: F401
from .mesh import (init_distributed, replicate,  # noqa: F401
                   shard_leading_axis, shutdown)
