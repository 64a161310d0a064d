"""Crash safety: atomic snapshots, async checkpointing, preemption, chaos —
the port of ``gene2vec_tpu/resilience/``, module for module.

* :mod:`.snapshot` — write-to-temp + fsync + atomic-rename primitives and
  CRC-stamped per-checkpoint ``MANIFEST`` files, so a torn or bit-rotted
  export is *detectable* (verification), not just unlikely (rename
  atomicity).  ``io/checkpoint.py`` routes every save and every
  discovery scan through this module.
* :mod:`.async_writer` — double-buffered background checkpoint writer:
  the train loop stages a host copy and returns; disk I/O runs on the
  writer thread (``ckpt_*`` metrics quantify the overhead).
* :mod:`.preempt` — SIGTERM/SIGINT → cooperative drain-checkpoint-exit
  with a distinct exit code (:data:`~gene2vec_tpu_torch.resilience.preempt.
  EXIT_PREEMPTED`) and an ``interrupted=true`` run-manifest stamp.
* :mod:`.chaos` — fault injection (kill a child CLI at step N, truncate
  a checkpoint, corrupt a CRC, delete the newest export) for the
  resilience tests and drills.
* :mod:`.faults` — deterministic HTTP fault injection inside the server
  (``cli/serve.py --faults``).
"""

from gene2vec_tpu_torch.resilience.preempt import (  # noqa: F401
    EXIT_PREEMPTED,
    PreemptionHandler,
)
from gene2vec_tpu_torch.resilience.snapshot import (  # noqa: F401
    MANIFEST_SUFFIX,
    VerifyResult,
    verify_manifest,
    write_manifest,
)
