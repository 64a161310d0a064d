"""The provenance stamp of ``gene2vec_tpu/obs/ledger.py`` (its one part
the port's CLIs use so far; the ledger's ingest and adapters stay with
the observability item)."""

from __future__ import annotations

import sys
import time
from typing import Dict


def provenance_stamp(doc: Dict) -> Dict:
    """Stamp ``schema_version`` / ``command`` / ``created_unix`` into a
    bench or quality-eval JSON product, so the reference's ledger ingests
    it with provenance instead of marking it ``legacy_unstamped``."""
    doc.setdefault("schema_version", 1)
    doc.setdefault("command", " ".join([sys.executable, *sys.argv]))
    doc.setdefault("created_unix", time.time())
    return doc
