"""Online similarity serving over training exports — the port of
``gene2vec_tpu/serve/`` for one model on one card.

* :mod:`~gene2vec_tpu_torch.serve.registry` — checkpoint discovery and
  atomic hot swap of the device-resident L2-normalized table;
* :mod:`~gene2vec_tpu_torch.serve.ann` — the int8 table and the IVF
  index (host build, device placement);
* :mod:`~gene2vec_tpu_torch.serve.engine` — the bucketed top-k engine
  over the serving kernels K7-K9r (exact | quant | ivf);
* :mod:`~gene2vec_tpu_torch.serve.batcher` — micro-batching with
  max-delay / max-batch admission, bounded queue, deadlines, LRU;
* :mod:`~gene2vec_tpu_torch.serve.eventloop` — the non-blocking
  HTTP/1.1 front end;
* :mod:`~gene2vec_tpu_torch.serve.server` — the JSON routes and the
  event-loop adapter;
* :mod:`~gene2vec_tpu_torch.serve.client` — the resilient HTTP client
  (retry-safe failover, circuit breakers, a retry budget, hedging);
* :mod:`~gene2vec_tpu_torch.serve.fleet` — the replica supervisor and the
  front-door proxy.

``python -m gene2vec_tpu_torch.cli.serve`` runs one server,
``python -m gene2vec_tpu_torch.cli.fleet`` a supervised fleet of them.
"""
