"""Row-shard helpers for the serving fleet — the numpy part of
``gene2vec_tpu/parallel/sharding.py`` (:mod:`.sharding`).  The mesh,
the device placement rules and the distributed top-k are the multi-GPU
port's (ROADMAP A13)."""
