"""Batch-job client: submit/status/cancel/fetch against a serve front
door, or run a job locally against an export dir — the port of
``gene2vec_tpu/cli/batch.py``.

``python -m gene2vec_tpu_torch.cli.batch submit --url http://... --type
knn_graph --k 10 --wait --out graph_dir`` drives the whole lifecycle:
submit (idempotent under ``--job-id``), poll to completion, and
reassemble the artifact dir locally — CRC-verified against the
manifest, so a torn fetch never masquerades as a graph.

``--export-dir`` instead of ``--url`` runs the job in-process against
the newest verified checkpoint on ``--device`` (``cuda`` unless ``cpu``
is asked for; no serving stack, the engine's kernels directly).  Local
runs write straight into ``--out`` under the same cursor commit
protocol, so re-running the identical command after a kill RESUMES from
the committed chunk and converges to the bit-identical final artifact.

Emits the repo's one-line JSON contract on stdout.
"""

from __future__ import annotations

import argparse
import base64
import json
import sys
import time
import urllib.error
import urllib.request
from typing import List, Optional, Tuple


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="batch",
        description="Offline batch jobs (kNN graph / pair scores / "
                    "embedding export) on a serve fleet or a local "
                    "checkpoint.",
    )
    p.add_argument("verb",
                   choices=("submit", "status", "cancel", "fetch",
                            "list"),
                   help="lifecycle verb; 'submit' with --export-dir "
                        "runs locally instead of through a front door")
    p.add_argument("--url", default=None,
                   help="serve front door (single replica with "
                        "--jobs-dir, or the fleet proxy)")
    p.add_argument("--export-dir", default=None,
                   help="local mode: run the job in-process against "
                        "the newest verified checkpoint here")
    p.add_argument("--type", default="knn_graph",
                   choices=("knn_graph", "pair_scores", "export"),
                   dest="job_type")
    p.add_argument("--k", type=int, default=10,
                   help="neighbors per row (knn_graph)")
    p.add_argument("--chunk-rows", type=int, default=256,
                   help="records per committed chunk")
    p.add_argument("--pairs-file", default=None,
                   help="pair_scores input: one 'GENE_A<TAB>GENE_B' "
                        "per line")
    p.add_argument("--job-id", default=None,
                   help="explicit job id (submit is idempotent under "
                        "it; required for status/cancel/fetch)")
    p.add_argument("--wait", action="store_true",
                   help="poll after submit until the job settles")
    p.add_argument("--poll-s", type=float, default=0.5)
    p.add_argument("--timeout-s", type=float, default=3600.0,
                   help="--wait gives up (exit 1, job keeps running) "
                        "after this long")
    p.add_argument("--out", default=None, metavar="DIR",
                   help="artifact destination dir: local mode writes "
                        "the job here directly; remote fetch "
                        "reassembles the artifact here (CRC-verified)")
    p.add_argument("--index", default="exact",
                   choices=("exact", "quant", "ivf"),
                   help="local mode retrieval index")
    p.add_argument("--ggipnn-checkpoint", default=None,
                   help="local mode: trained GGIPNN head for "
                        "pair_scores")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="local mode: where the table and the engine run "
                        "(no GPU and no 'cpu' refuses to start)")
    return p


def _http(url: str, method: str = "GET",
          body: Optional[dict] = None) -> Tuple[int, dict]:
    data = json.dumps(body).encode("utf-8") if body is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=60.0) as resp:
            return resp.status, json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read().decode("utf-8"))
        except (ValueError, OSError):
            return e.code, {"error": f"HTTP {e.code}"}


def _read_pairs(path: str) -> List[List[str]]:
    pairs: List[List[str]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                pairs.append([parts[0], parts[1]])
    if not pairs:
        raise SystemExit(f"error: no pairs in {path}")
    return pairs


def _fetch_part(url: str, job_id: str, part: str) -> Tuple[bytes, dict]:
    blob = b""
    offset = 0
    while True:
        status, doc = _http(
            f"{url}/v1/jobs/{job_id}/artifact"
            f"?offset={offset}&part={part}"
        )
        if status != 200:
            raise SystemExit(
                f"error: artifact fetch -> {status}: {doc.get('error')}"
            )
        blob += base64.b64decode(doc["data_b64"])
        offset = len(blob)
        if doc["eof"]:
            return blob, doc


def _fetch(url: str, job_id: str, out_dir: str) -> dict:
    from gene2vec_tpu_torch.batch.artifact import write_fetched_artifact

    data, doc = _fetch_part(url, job_id, "data")
    tokens: Optional[bytes] = None
    if doc.get("meta", {}).get("type") == "knn_graph":
        tokens, _ = _fetch_part(url, job_id, "tokens")
    write_fetched_artifact(
        out_dir, data, doc.get("meta", {}), doc["chunks"],
        doc["records"], doc["data_crc32"], tokens_bytes=tokens,
    )
    return {
        "job_id": job_id,
        "artifact_dir": out_dir,
        "data_bytes": len(data),
        "data_crc32": doc["data_crc32"],
        "records": doc["records"],
        "meta": doc.get("meta", {}),
    }


def _wait(url: str, job_id: str, poll_s: float,
          timeout_s: float) -> dict:
    deadline = time.monotonic() + timeout_s
    while True:
        status, doc = _http(f"{url}/v1/jobs/{job_id}")
        if status != 200:
            raise SystemExit(
                f"error: status -> {status}: {doc.get('error')}"
            )
        if doc.get("state") in ("done", "failed", "cancelled"):
            return doc
        if time.monotonic() > deadline:
            doc["wait_timeout"] = True
            return doc
        time.sleep(poll_s)


def _run_local(args) -> dict:
    import os

    from gene2vec_tpu_torch.batch.artifact import ChunkedArtifact
    from gene2vec_tpu_torch.batch.jobs import JobSpec
    from gene2vec_tpu_torch.batch.runner import EngineBackend, run_job
    from gene2vec_tpu_torch.serve.engine import SimilarityEngine
    from gene2vec_tpu_torch.serve.registry import ModelRegistry

    if not args.out:
        raise SystemExit("error: local mode needs --out DIR")
    # raises without a GPU unless --device cpu
    registry = ModelRegistry(args.export_dir, index_mode=args.index,
                             device=args.device)
    if not registry.refresh():
        raise SystemExit(
            f"error: no verified checkpoint under {args.export_dir}"
        )
    backend = EngineBackend(
        registry.model,
        SimilarityEngine(index=args.index),
        ggipnn_checkpoint=args.ggipnn_checkpoint,
    )
    spec = JobSpec(
        type=args.job_type, k=args.k, chunk_rows=args.chunk_rows,
        pairs=_read_pairs(args.pairs_file)
        if args.job_type == "pair_scores" else None,
        job_id=args.job_id,
    )
    art = ChunkedArtifact(args.out)
    result = run_job(spec, backend, art)
    result["mode"] = "local"
    result["type"] = args.job_type
    result["iteration"] = int(backend.iteration)
    result["artifact_dir"] = os.path.abspath(args.out)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.verb == "submit" and args.export_dir:
        print(json.dumps(_run_local(args)))
        return 0
    if not args.url:
        raise SystemExit(
            "error: need --url (or --export-dir for local submit)"
        )
    url = args.url.rstrip("/")
    if args.verb == "list":
        status, doc = _http(f"{url}/v1/jobs")
    elif args.verb == "submit":
        body = {
            "type": args.job_type, "k": args.k,
            "chunk_rows": args.chunk_rows,
        }
        if args.job_type == "pair_scores":
            if not args.pairs_file:
                raise SystemExit(
                    "error: pair_scores needs --pairs-file"
                )
            body["pairs"] = _read_pairs(args.pairs_file)
        if args.job_id:
            body["job_id"] = args.job_id
        status, doc = _http(f"{url}/v1/jobs", "POST", body)
        if status == 200 and args.wait:
            doc = _wait(url, doc["job_id"], args.poll_s, args.timeout_s)
            if doc.get("state") == "done" and args.out:
                doc["fetch"] = _fetch(url, doc["job_id"], args.out)
    else:
        if not args.job_id:
            raise SystemExit(f"error: {args.verb} needs --job-id")
        if args.verb == "status":
            status, doc = _http(f"{url}/v1/jobs/{args.job_id}")
        elif args.verb == "cancel":
            status, doc = _http(
                f"{url}/v1/jobs/{args.job_id}/cancel", "POST"
            )
        else:  # fetch
            if not args.out:
                raise SystemExit("error: fetch needs --out DIR")
            doc = _fetch(url, args.job_id, args.out)
            status = 200
    print(json.dumps(doc))
    if status != 200:
        return 1
    return 1 if doc.get("state") in ("failed",) or doc.get(
        "wait_timeout"
    ) else 0


if __name__ == "__main__":
    sys.exit(main())
