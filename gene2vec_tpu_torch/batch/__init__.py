"""Offline analytics plane: resumable batch jobs on the serving stack —
the port of ``gene2vec_tpu/batch/``.

Three job types run at background priority against live serving state:

* ``knn_graph`` — the full-vocab kNN graph: every row as a query through
  the retrieval engine (exact-rescored in quant/ivf modes), packed per
  row so the final artifact is bit-identical however the build was
  chunked or how many times it was killed and resumed;
* ``pair_scores`` — bulk GGIPNN interaction scoring over a candidate
  pair list, one text line per pair;
* ``export`` — a streaming word2vec-format embedding export, chunked
  through the same commit protocol.

The plane is three layers: :mod:`.artifact` (the chunk store with its
CRC'd cursor; the reference's bytes on disk), :mod:`.runner` (job loops
generic over a query backend: in-process engine on the card, a server's
batcher lane, a fleet's resilient client or shard scatter) and
:mod:`.jobs` (the journal, the worker and the ``/v1/jobs`` surface
mounted on ``cli.serve --jobs-dir`` and ``cli.fleet --jobs-dir``).
``python -m gene2vec_tpu_torch.cli.batch`` submits, waits and fetches.
"""

from gene2vec_tpu_torch.batch.artifact import ChunkedArtifact, load_graph
from gene2vec_tpu_torch.batch.jobs import JobManager, JobSpec, dispatch_jobs

__all__ = [
    "ChunkedArtifact",
    "JobManager",
    "JobSpec",
    "dispatch_jobs",
    "load_graph",
]
