"""The port's batch plane (``batch/{artifact,runner,jobs}.py``) against
the JAX package's: the cases of ``tests/test_batch.py`` run through both
packages, and the port's artifacts held byte for byte against the
reference's.

* the chunk-commit protocol (torn tails, rotted cursors, post-commit rot,
  finalize, fetched artifacts) behaves alike in both;
* ``run_job`` over each package's ``EngineBackend`` on the same seeded
  table writes the same ``TOKENS.txt`` and the same records for
  ``knn_graph``, ``pair_scores`` and ``export``, except near-ties: a
  score whose float32 dot differs by one ulp between the two packages
  can round to the neighbouring 6th decimal.  The test counts those
  records (every neighbour id equal, every score within one 1e-6 step)
  and holds the count to a quarter of the records; on these seeded tables
  it is 3 of 24 graph rows, 1 of 17 pairs and 0 export rows.  Where no
  record differs, ``DATA.bin``, the cursor and ``ARTIFACT.json`` are
  byte-equal; where some do, the manifest differs in its data CRC only;
* an interrupted job resumes to the uninterrupted control's bytes;
* the job manager, ``/v1/jobs`` dispatch, the batch lane's weights, the
  Pacer and the shard-group backend hold the reference's behaviour;
* the unchanged reference ``load_graph`` reads the port's artifact, and
  ``graph_neighborhood_ratio`` and the dashboard's graph lookup equal the
  reference's on it.

The reference's ``passes_batch`` gate cases (``analysis/``, the bench's
budget) have no port counterpart: the port's bench is ROADMAP A18's."""

import base64
import os
import threading
import time
import types
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gene2vec_tpu.batch import artifact as ref_artifact
from gene2vec_tpu.batch import jobs as ref_jobs
from gene2vec_tpu.batch import runner as ref_runner
from gene2vec_tpu.eval import target_function as ref_tf
from gene2vec_tpu.serve import engine as ref_engine
from gene2vec_tpu.serve import registry as ref_registry
from gene2vec_tpu.serve import shardgroup as ref_shardgroup
from gene2vec_tpu.serve import tenancy as ref_tenancy
from gene2vec_tpu.viz import dash_app as ref_dash
from gene2vec_tpu_torch.batch import artifact as port_artifact
from gene2vec_tpu_torch.batch import jobs as port_jobs
from gene2vec_tpu_torch.batch import runner as port_runner
from gene2vec_tpu_torch.eval import target_function as port_tf
from gene2vec_tpu_torch.serve import engine as port_engine
from gene2vec_tpu_torch.serve import registry as port_registry
from gene2vec_tpu_torch.serve import shardgroup as port_shardgroup
from gene2vec_tpu_torch.serve import tenancy as port_tenancy
from gene2vec_tpu_torch.viz import dash_app as port_dash

V, D, K = 24, 6, 4
PKGS = {
    "port": types.SimpleNamespace(
        artifact=port_artifact, runner=port_runner, jobs=port_jobs, engine=port_engine,
        registry=port_registry, tenancy=port_tenancy, shardgroup=port_shardgroup,
        unit=lambda emb: torch.from_numpy(port_registry.l2_normalize(emb))),
    "reference": types.SimpleNamespace(
        artifact=ref_artifact, runner=ref_runner, jobs=ref_jobs, engine=ref_engine,
        registry=ref_registry, tenancy=ref_tenancy, shardgroup=ref_shardgroup,
        unit=lambda emb: jnp.asarray(ref_registry.l2_normalize(emb))),
}
ARTIFACT_FILES = ("DATA.bin", "TOKENS.txt", "ARTIFACT.json", "CURSOR.json")


def _emb(v=V, d=D, seed=0):
    return np.random.RandomState(seed).randn(v, d).astype(np.float32)


def _model(pkg, emb=None, iteration=1):
    emb = _emb() if emb is None else emb
    tokens = tuple(f"G{i}" for i in range(emb.shape[0]))
    return PKGS[pkg].registry.LoadedModel(
        dim=emb.shape[1], iteration=iteration, tokens=tokens,
        index={t: i for i, t in enumerate(tokens)}, emb=emb,
        unit=PKGS[pkg].unit(emb), source="synthetic", meta={})


def _backend(pkg, model=None, ckpt=None):
    p = PKGS[pkg]
    return p.runner.EngineBackend(model if model is not None else _model(pkg),
                                  p.engine.SimilarityEngine(max_batch=8),
                                  ggipnn_checkpoint=ckpt)


def _spec(pkg, kind="knn_graph", **kw):
    body = {"type": kind, "k": K, "chunk_rows": 4}
    body.update(kw)
    return PKGS[pkg].jobs.JobSpec.from_body(body)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _head_checkpoint(path, vocab, dim):
    from gene2vec_tpu_torch.models.ggipnn import GGIPNN

    net = GGIPNN(vocab, dim)
    net.reset_parameters(torch.Generator().manual_seed(7))
    np.savez(str(path), **net.to_flat())
    return str(path)


# -- artifact commit protocol ---------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_pack_unpack_graph_roundtrip(pkg):
    art = PKGS[pkg].artifact
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 100, size=(5, K)).astype(np.int32)
    scores = rng.rand(5, K).astype(np.float32)
    packed = art.pack_graph_rows(ids, scores)
    assert packed == ref_artifact.pack_graph_rows(ids, scores)
    out_ids, out_scores = art.unpack_graph(packed, K)
    np.testing.assert_array_equal(out_ids, ids)
    np.testing.assert_array_equal(out_scores, scores)
    with pytest.raises(ValueError, match="matching"):
        art.pack_graph_rows(ids, scores[:3])


def _torn_tail(d, art):
    with open(art.data_path, "ab") as f:
        f.write(b"torn!")


def _rotted_cursor(d, art):
    with open(os.path.join(d, "CURSOR.json"), "w") as f:
        f.write("{not json")


RECOVERY = {
    # the writer died mid-append: the committed prefix comes back
    "torn_tail": (_torn_tail, (2, 8, b"aaaabbbb")),
    # CURSOR.json rotted: recovery falls back one commit, never to zero
    "rotted_cursor": (_rotted_cursor, (1, 4, b"aaaa")),
}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(RECOVERY))
def test_artifact_recovers_like_reference(tmp_path, pkg, case):
    damage, (records, nbytes, data) = RECOVERY[case]
    d = str(tmp_path / "job")
    art = PKGS[pkg].artifact.ChunkedArtifact(d)
    art.append_chunk(b"aaaa", 1)
    art.append_chunk(b"bbbb", 1)
    damage(d, art)
    art2 = PKGS[pkg].artifact.ChunkedArtifact(d)
    assert (art2.records_done, art2.data_bytes, _read(art2.data_path)) == (
        records, nbytes, data)


def _lose_both_cursors(d, art):
    os.unlink(os.path.join(d, "CURSOR.json"))


def _flip_committed_byte(d, art):
    with open(art.data_path, "r+b") as f:
        f.seek(2)
        f.write(b"X")


def _truncate_below_commit(d, art):
    with open(art.data_path, "r+b") as f:
        f.truncate(4)


REFUSALS = {
    "both_cursors_lost": (_lose_both_cursors, "refusing to truncate"),
    "post_commit_rot": (_flip_committed_byte, "CRC mismatch"),
    "truncated_below_commit": (_truncate_below_commit, "truncated after commit"),
}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_artifact_refuses_like_reference(tmp_path, pkg, case):
    damage, match = REFUSALS[case]
    d = str(tmp_path / "job")
    art = PKGS[pkg].artifact.ChunkedArtifact(d)
    art.append_chunk(b"aaaabbbb", 2)
    damage(d, art)
    with pytest.raises(IOError, match=match):
        PKGS[pkg].artifact.ChunkedArtifact(d)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_artifact_finalize_idempotent_and_verify(tmp_path, pkg):
    art = PKGS[pkg].artifact.ChunkedArtifact(str(tmp_path / "job"))
    art.append_chunk(b"abcd", 1)
    p1 = art.finalize({"type": "export"})
    assert p1 == art.finalize({"type": "export"}) and art.verify()
    with pytest.raises(IOError, match="already finalized"):
        art.append_chunk(b"more", 1)
    with open(art.data_path, "r+b") as f:
        f.write(b"Z")
    assert not art.verify()


def test_commit_protocol_bytes_equal_reference(tmp_path):
    """The same appends, commits and finalize leave the same bytes on disk:
    data, cursor (with its self-CRC), previous cursor and manifest."""
    for pkg in PKGS:
        art = PKGS[pkg].artifact.ChunkedArtifact(str(tmp_path / pkg))
        art.write_tokens(["G0", "G1"])
        for chunk in (b"abcd", b"efgh", b"ij"):
            art.append_chunk(chunk, len(chunk) // 2)
        art.finalize({"type": "export", "k": 0})
    for name in (*ARTIFACT_FILES, "CURSOR.prev.json"):
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "reference" / name), name


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_write_fetched_artifact_rejects_bad_crc(tmp_path, pkg):
    art = PKGS[pkg].artifact
    with pytest.raises(IOError, match="CRC"):
        art.write_fetched_artifact(str(tmp_path / "f"), b"data", {}, 1, 1, data_crc32=12345)
    assert not os.path.exists(str(tmp_path / "f" / "DATA.bin"))
    good = zlib.crc32(b"data") & 0xFFFFFFFF
    art.write_fetched_artifact(str(tmp_path / pkg), b"data", {"type": "export"}, 1, 1,
                               data_crc32=good, tokens_bytes=b"G0\n")
    got = art.ChunkedArtifact(str(tmp_path / pkg))
    assert got.verify() and got.records_done == 1


def test_fetched_artifact_bytes_equal_reference(tmp_path):
    good = zlib.crc32(b"payload") & 0xFFFFFFFF
    for pkg in PKGS:
        PKGS[pkg].artifact.write_fetched_artifact(
            str(tmp_path / pkg), b"payload", {"type": "knn_graph", "k": 2}, 3, 7,
            data_crc32=good, tokens_bytes=b"G0\nG1\n")
    for name in ARTIFACT_FILES:
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "reference" / name)


# -- the port's artifacts are the reference's, byte for byte ---------------------


#: one step in the 6th decimal (the rounding of a served score), plus the
#: float32 spacing near 1 in which a graph record stores it
ROUND_STEP = 1e-6 + 2 ** -23


def _near_tie_records(kind, port_bytes, ref_bytes):
    """Records that differ between the two artifacts; each must be a near
    tie: the same genes and neighbour ids, every score within one rounding
    step of the reference's."""
    if kind == "knn_graph":
        pi, ps = port_artifact.unpack_graph(port_bytes, K)
        ri, rs = ref_artifact.unpack_graph(ref_bytes, K)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_allclose(ps, rs, rtol=0, atol=ROUND_STEP)
        return int((ps != rs).any(axis=1).sum())
    port_lines = port_bytes.decode().splitlines()
    ref_lines = ref_bytes.decode().splitlines()
    assert len(port_lines) == len(ref_lines)
    differ = [(p, r) for p, r in zip(port_lines, ref_lines) if p != r]
    for p, r in differ:
        assert p.split()[:-1] == r.split()[:-1]
        assert abs(float(p.split()[-1]) - float(r.split()[-1])) <= ROUND_STEP
    return len(differ)


@pytest.mark.parametrize("kind", ["knn_graph", "pair_scores", "export"])
def test_run_job_artifact_bytes_equal_reference(tmp_path, kind):
    emb = _emb(seed=4)
    ckpt = _head_checkpoint(tmp_path / "head.npz", V, D)
    extra = {}
    if kind == "pair_scores":
        extra["pairs"] = [[f"G{i}", f"G{(i * 7 + 3) % V}"] for i in range(17)]
    for pkg in PKGS:
        art = PKGS[pkg].artifact.ChunkedArtifact(str(tmp_path / pkg))
        PKGS[pkg].runner.run_job(_spec(pkg, kind, **extra),
                                 _backend(pkg, _model(pkg, emb), ckpt=ckpt), art)
    got, want = tmp_path / "port", tmp_path / "reference"
    records = {"knn_graph": V, "pair_scores": 17, "export": V}[kind]
    ties = _near_tie_records(kind, _read(got / "DATA.bin"), _read(want / "DATA.bin"))
    assert ties <= records // 4, f"{ties} of {records} records differ"
    if (want / "TOKENS.txt").exists() or (got / "TOKENS.txt").exists():
        assert _read(got / "TOKENS.txt") == _read(want / "TOKENS.txt")
    if ties == 0:
        for name in ARTIFACT_FILES:
            if (want / name).exists():
                assert _read(got / name) == _read(want / name), name
    else:
        import json

        docs = [json.loads(_read(d / "ARTIFACT.json")) for d in (got, want)]
        for doc in docs:
            doc.pop("data_crc32")
        assert docs[0] == docs[1]
    # the unchanged reference loader reads the port's graph
    if kind == "knn_graph":
        tokens, ids, scores, meta = ref_artifact.load_graph(str(got))
        assert tokens == [f"G{i}" for i in range(V)] and ids.shape == (V, K)
        assert meta["type"] == "knn_graph" and meta["k"] == K
        assert not (ids == np.arange(V)[:, None]).any()  # self excluded


# -- interrupt-resume bit-identity, every job type --------------------------------


def _interrupt_then_resume(tmp_path, pkg, spec, make_backend, stop_after=2):
    art_mod, runner = PKGS[pkg].artifact, PKGS[pkg].runner
    d = str(tmp_path / "interrupted")
    art = art_mod.ChunkedArtifact(d)
    with pytest.raises(runner.JobCancelled):
        runner.run_job(spec, make_backend(), art,
                       should_stop=lambda: art.chunks_done >= stop_after)
    assert 0 < art.records_done
    with open(art.data_path, "ab") as f:
        f.write(b"\x00\x01torn")  # died mid-append after the cancel point
    art2 = art_mod.ChunkedArtifact(d)
    assert art2.chunks_done == stop_after
    result = runner.run_job(spec, make_backend(), art2)
    assert result["resumed_records"] == art.records_done
    control = art_mod.ChunkedArtifact(str(tmp_path / "control"))
    runner.run_job(spec, make_backend(), control)
    return _read(art2.data_path), _read(control.data_path), result


@pytest.mark.parametrize("kind", ["knn_graph", "pair_scores", "export"])
def test_resume_bit_identical(tmp_path, kind):
    extra = {}
    if kind == "pair_scores":
        extra["pairs"] = [[f"G{i}", f"G{(i * 7 + 3) % V}"] for i in range(17)]
    model = _model("port", _emb(seed=5))
    resumed, control, result = _interrupt_then_resume(
        tmp_path, "port", _spec("port", kind, **extra), lambda: _backend("port", model))
    assert resumed == control
    assert result["records"] == (17 if kind == "pair_scores" else V)
    if kind == "knn_graph":
        tokens, ids, _, _ = port_artifact.load_graph(str(tmp_path / "interrupted"))
        assert tokens == [f"G{i}" for i in range(V)] and ids.shape == (V, K)
    elif kind == "pair_scores":
        a, b, s = resumed.decode().splitlines()[0].split("\t")
        assert [a, b] == ["G0", "G3"] and 0.0 <= float(s) <= 1.0
    else:
        # the artifact is a word2vec text export, byte for byte
        from gene2vec_tpu_torch.io.emb_io import write_word2vec_format

        path = str(tmp_path / "w2v.txt")
        write_word2vec_format(path, list(model.tokens), model.emb)
        assert resumed == _read(path)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_resume_is_noop_past_completion(tmp_path, pkg):
    p = PKGS[pkg]
    spec = _spec(pkg)
    first = p.runner.run_job(spec, _backend(pkg), p.artifact.ChunkedArtifact(str(tmp_path)))
    again = p.runner.run_job(spec, _backend(pkg), p.artifact.ChunkedArtifact(str(tmp_path)))
    assert again["records"] == first["records"] == again["resumed_records"]


# -- the job manager + /v1/jobs dispatch ------------------------------------------


def _manager(tmp_path, pkg="port", model=None, **kw):
    return PKGS[pkg].jobs.JobManager(str(tmp_path / "jobs"),
                                     backend_factory=lambda: _backend(pkg, model), **kw)


def _wait_state(mgr, job_id, states=("done", "failed", "cancelled"), timeout=30.0):
    t0 = time.monotonic()
    doc = None
    while time.monotonic() - t0 < timeout:
        status, doc = mgr.status(job_id)
        if status == 200 and doc["state"] in states:
            return doc
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} never reached {states}: {doc}")


def test_manager_runs_job_to_done_like_reference(tmp_path):
    docs = {}
    for pkg in PKGS:
        mgr = _manager(tmp_path / pkg, pkg).start()
        try:
            assert mgr.submit(_spec(pkg, job_id="g1"))["state"] in ("pending", "running")
            doc = _wait_state(mgr, "g1")
            assert mgr.submit(_spec(pkg, job_id="g1"))["state"] == "done"
            assert [j["job_id"] for j in mgr.list_jobs()["jobs"]] == ["g1"]
        finally:
            mgr.stop()
        docs[pkg] = {k: doc[k] for k in ("state", "records_done", "records_total",
                                         "iteration", "error", "type")}
        docs[pkg]["chunks"] = doc["result"]["chunks"]
    assert docs["port"] == docs["reference"]
    assert docs["port"]["state"] == "done" and docs["port"]["records_done"] == V


def test_manager_shutdown_midjob_resumes_running_first(tmp_path):
    model = _model("port", _emb(seed=9))
    slow = threading.Event()

    class SlowBackend(port_runner.EngineBackend):
        def knn_rows(self, start, n, k):
            if start >= 8 and not slow.is_set():
                time.sleep(0.05)
            return super().knn_rows(start, n, k)

    def factory():
        return SlowBackend(model, port_engine.SimilarityEngine(max_batch=8))

    mgr = port_jobs.JobManager(str(tmp_path / "jobs"), backend_factory=factory).start()
    mgr.submit(_spec("port", job_id="resume-me"))
    t0 = time.monotonic()
    while time.monotonic() - t0 < 30.0:
        if (mgr.status("resume-me")[1].get("records_done") or 0) >= 8:
            break
        time.sleep(0.01)
    mgr.stop()  # shutdown, not cancel: the journal stays "running"
    doc = mgr._read_journal("resume-me")
    assert doc["state"] == "running" and doc["records_done"] >= 8
    slow.set()
    mgr2 = port_jobs.JobManager(str(tmp_path / "jobs"), backend_factory=factory).start()
    try:
        done = _wait_state(mgr2, "resume-me")
        assert done["state"] == "done" and done["result"]["resumed_records"] > 0
    finally:
        mgr2.stop()
    control = port_artifact.ChunkedArtifact(str(tmp_path / "control"))
    port_runner.run_job(_spec("port"), factory(), control)
    assert _read(os.path.join(mgr2.job_dir("resume-me"), "DATA.bin")) == _read(
        control.data_path)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_manager_pins_iteration_across_swap(tmp_path, pkg):
    mgr = _manager(tmp_path, pkg, model=_model(pkg, iteration=2))
    os.makedirs(mgr.job_dir("stale"), exist_ok=True)
    mgr._write_journal("stale", {
        "spec": _spec(pkg, job_id="stale").to_doc(), "state": "running",
        "created_unix": 0, "records_done": 0, "records_total": None, "error": None,
        "iteration": 1,
    })
    mgr.start()
    try:
        doc = _wait_state(mgr, "stale")
        assert doc["state"] == "failed" and "swapped" in doc["error"]
    finally:
        mgr.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_manager_cancel_pending_job(tmp_path, pkg):
    mgr = _manager(tmp_path, pkg)  # worker not started: jobs stay pending
    mgr.submit(_spec(pkg, job_id="p1"))
    status, doc = mgr.cancel("p1")
    assert status == 200 and doc["state"] == "cancelled"
    assert mgr.cancel("p1")[0] == 409 and mgr.cancel("ghost")[0] == 404


def test_dispatch_jobs_routes_like_reference(tmp_path):
    """The same /v1/jobs requests answer the same statuses and documents
    (timestamps aside) from both packages' managers, and the artifact
    pages reassemble to the manifest CRC."""
    out = {}
    for pkg in PKGS:
        dispatch = PKGS[pkg].jobs.dispatch_jobs
        assert dispatch(None, "GET", "/v1/jobs", {}, None)[0] == 404
        mgr = _manager(tmp_path / pkg, pkg).start()
        seen = []
        try:
            seen.append(dispatch(mgr, "POST", "/v1/jobs", {}, {"type": "nope"}))
            dispatch(mgr, "POST", "/v1/jobs", {},
                     {"type": "knn_graph", "k": K, "chunk_rows": 4, "job_id": "via-http"})
            _wait_state(mgr, "via-http")
            status, doc = dispatch(mgr, "GET", "/v1/jobs/via-http", {}, None)
            seen.append((status, {k: v for k, v in doc.items()
                                  if k not in ("created_unix", "updated_unix", "result")}))
            blob, offset = b"", 0
            while True:
                status, page = dispatch(mgr, "GET", "/v1/jobs/via-http/artifact",
                                        {"offset": [str(offset)], "limit": ["64"]}, None)
                assert status == 200
                blob += base64.b64decode(page["data_b64"])
                offset = page["offset"] + 64
                if page["eof"]:
                    break
            assert (zlib.crc32(blob) & 0xFFFFFFFF) == page["data_crc32"]
            status, page = dispatch(mgr, "GET", "/v1/jobs/via-http/artifact",
                                    {"part": ["tokens"]}, None)
            # the data CRC differs where a near-tie record does (above)
            page.pop("data_crc32")
            seen.append((status, page))
            for method, route, query in (("GET", "/v1/jobs/../etc", {}),
                                         ("GET", "/v1/jobs/via-http/artifact",
                                          {"offset": ["x"]}),
                                         ("GET", "/v1/jobs/via-http/artifact",
                                          {"part": ["nope"]}),
                                         ("POST", "/v1/jobs/via-http/cancel", {}),
                                         ("DELETE", "/v1/jobs", {})):
                seen.append(dispatch(mgr, method, route, query, None))
        finally:
            mgr.stop()
        out[pkg] = seen
    assert out["port"] == out["reference"]
    assert out["port"][0][0] == 400 and out["port"][1][1]["state"] == "done"


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("body,match", [
    ({"type": "mine_bitcoin"}, "'type'"),
    ({"type": "knn_graph", "k": 0}, "'k'"),
    ({"type": "knn_graph", "chunk_rows": 0}, "chunk_rows"),
    ({"type": "pair_scores", "pairs": []}, "'pairs'"),
    ({"type": "export", "job_id": "../escape"}, "job_id"),
])
def test_jobspec_validation(pkg, body, match):
    with pytest.raises(ValueError, match=match):
        PKGS[pkg].jobs.JobSpec.from_body(body)


def test_jobspec_docs_equal_reference():
    for body in ({"type": "export", "pairs": [["A", "B"]]},
                 {"type": "pair_scores", "pairs": [["A", "B"]], "job_id": "j.1"},
                 {"type": "knn_graph", "k": 7, "chunk_rows": 512}):
        got = port_jobs.JobSpec.from_body(dict(body)).to_doc()
        assert got == ref_jobs.JobSpec.from_body(dict(body)).to_doc()
    assert port_jobs.JobSpec.from_body({"type": "export", "pairs": [["A", "B"]]}).pairs is None


# -- background priority: the batch lane's weight and the Pacer -------------------


def test_batch_lane_constants_equal_reference():
    assert port_tenancy.BATCH_TENANT == ref_tenancy.BATCH_TENANT == "batch"
    assert port_tenancy.DEFAULT_BATCH_WEIGHT == ref_tenancy.DEFAULT_BATCH_WEIGHT


def _drain(pkg, pushes, pops):
    t = PKGS[pkg].tenancy
    q = t.FairQueue(weight_of=lambda x: t.DEFAULT_BATCH_WEIGHT if x == t.BATCH_TENANT else 1.0)
    out = []
    for step in pushes:
        if step == "pop":
            out.append(q.pop())
        else:
            q.push(*step)
    return out + [q.pop() for _ in range(pops)]


FAIR_SCRIPTS = {
    "cannot_starve_interactive": (
        [("batch", ("b", i)) for i in range(200)] + [("default", ("d", i)) for i in range(100)],
        100),
    "never_fully_starves": (
        [x for i in range(50) for x in (("batch", ("b", i)), ("default", ("d", i)),
                                         ("default", ("d2", i)))], 60),
    "idle_lane_cannot_hoard_credit": (
        [("batch", "b0"), "pop"] + [x for i in range(40) for x in (
            ("batch", ("b", i)), ("default", ("d", i)))], 20),
}


@pytest.mark.parametrize("case", sorted(FAIR_SCRIPTS))
def test_fairqueue_batch_lane_like_reference(case):
    pushes, pops = FAIR_SCRIPTS[case]
    got = _drain("port", pushes, pops)
    assert got == _drain("reference", pushes, pops)
    window = [x for x in got if isinstance(x, tuple)]
    batch_served = sum(1 for t, _ in window if t == "b")
    if case == "cannot_starve_interactive":
        assert batch_served <= 10
        d = [i for t, i in window if t == "d"]
        assert d == sorted(d)
    elif case == "never_fully_starves":
        assert batch_served >= 1
    else:
        assert batch_served <= 2


def test_server_batch_lane_weight():
    """A server drains the batch lane at ``batch_weight``, tenancy on or
    off, as the reference's does."""
    from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig

    app = ServeApp.__new__(ServeApp)
    for tenants in (None,):
        app.tenants, app.config = tenants, ServeConfig(batch_weight=0.125)
        assert app._tenant_weight("batch") == 0.125 and app._tenant_weight("x") == 1.0
    assert ServeConfig().batch_weight == port_tenancy.DEFAULT_BATCH_WEIGHT


def _pacer_run(pkg):
    clock = {"t": 0.0}
    slept = []

    def sleep(s):
        slept.append(s)
        clock["t"] += s

    pressure = {"v": 1.0}
    Pacer = PKGS[pkg].runner.Pacer
    p = Pacer(guard=lambda: pressure["v"], guard_max=0.5, clock=lambda: clock["t"], sleep=sleep)

    def stop():
        if clock["t"] > 1.0:
            pressure["v"] = 0.0
        return False

    p.wait(0.0, stop)
    p2 = Pacer(guard=lambda: 1.0, guard_max=0.5, clock=lambda: clock["t"], sleep=sleep)
    p2.wait(0.0, lambda: True)
    p3 = Pacer(duty=0.5, clock=lambda: 0.0, sleep=slept.append)
    p3.wait(2.0, None)
    return slept, p.yielded_s, p2.yielded_s


def test_pacer_yields_and_duty_cycle_like_reference():
    got = _pacer_run("port")
    assert got == _pacer_run("reference")
    slept, yielded, yielded_stopped = got
    assert yielded > 1.0 and max(slept[:-1]) <= 1.0 and yielded_stopped <= 0.1
    assert slept[-1] == 2.0


# -- ShardGroupBackend: tenant tagging, sub-request cap, pressure -----------------


class _FakeRouting:
    def __init__(self, tokens, dim=D):
        self.tokens, self.dim, self.iteration = list(tokens), dim, 1
        self.index = {t: i for i, t in enumerate(tokens)}


class _FakeGroup:
    """Captures what a scatter leg sees: the ambient scatter headers at
    call time and each sub-request's query count."""

    def __init__(self, pkg, tokens, max_queries=64):
        self.pkg = pkg
        self.config = types.SimpleNamespace(max_queries_per_request=max_queries)
        self.routing = _FakeRouting(tokens)
        self.calls = []

    def _ambient(self):
        return getattr(PKGS[self.pkg].shardgroup._SCATTER_HEADERS, "value", None)

    def similar(self, body):
        self.calls.append((len(body["genes"]), self._ambient()))
        tok = self.routing.tokens
        return 200, {"results": [{"neighbors": [
            {"gene": tok[(j + 1) % len(tok)], "score": 0.5} for j in range(body["k"])]}
            for _ in body["genes"]]}

    def interaction(self, body):
        self.calls.append((len(body["pairs"]), self._ambient()))
        return 200, {"scores": [{"pair": p, "score": 0.25} for p in body["pairs"]]}

    def embedding(self, body):
        self.calls.append((len(body["genes"]), self._ambient()))
        return 200, {"embeddings": [{"gene": g, "vector": [0.0] * self.routing.dim}
                                    for g in body["genes"]]}


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_shardgroup_backend_tags_every_leg_with_batch_tenant(pkg):
    group = _FakeGroup(pkg, [f"G{i}" for i in range(40)])
    be = PKGS[pkg].runner.ShardGroupBackend(group, sub_queries=16)
    ids, scores = be.knn_rows(0, 40, 2)
    assert be.pair_scores([("G0", "G1")]) == [0.25]
    assert len(be.vector_rows(0, 5)) == 5
    assert [n for n, _ in group.calls] == [16, 16, 8, 1, 5]
    assert all(h == {"X-Tenant": "batch"} for _, h in group.calls)
    assert group._ambient() is None
    assert ids[0].tolist() == [1, 2] and scores.dtype == np.float32


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_shardgroup_backend_cap_pressure_and_degraded(pkg):
    be_cls = PKGS[pkg].runner.ShardGroupBackend
    assert be_cls(_FakeGroup(pkg, ["G0", "G1"], max_queries=8), sub_queries=64)._sub == 8
    group = _FakeGroup(pkg, ["G0", "G1"])
    assert be_cls(group).pressure() == 0.0
    assert be_cls(group, pressure_fn=lambda: 0.75).pressure() == 0.75

    def broken():
        raise RuntimeError("aggregator gone")

    assert be_cls(group, pressure_fn=broken).pressure() == 1.0  # yield, never idle
    group = _FakeGroup(pkg, [f"G{i}" for i in range(8)])
    real = group.similar

    def degraded(body):
        status, doc = real(body)
        doc["results"][0]["degraded"] = True
        return status, doc

    group.similar = degraded
    with pytest.raises(PKGS[pkg].runner.ChunkFailed, match="degraded"):
        be_cls(group, sub_queries=4).knn_rows(0, 4, 2)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_retrying_backs_off_then_raises_like_reference(pkg):
    runner = PKGS[pkg].runner
    slept, calls = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise runner.ChunkFailed("down")
        return "ok"

    assert runner._retrying(flaky, attempts=5, sleep=slept.append) == "ok"
    assert slept == [0.25, 0.5]
    with pytest.raises(runner.ChunkFailed, match="after 3 attempts"):
        runner._retrying(lambda: (_ for _ in ()).throw(OSError("x")), attempts=3,
                         sleep=slept.append)


# -- the precomputed-graph consumers ------------------------------------------------


def _clustered_emb(v=40, d=8, clusters=4, seed=11):
    rng = np.random.RandomState(seed)
    cent = rng.randn(clusters, d).astype(np.float32) * 3
    return np.vstack([cent[i % clusters] + 0.2 * rng.randn(d).astype(np.float32)
                      for i in range(v)]), clusters


def test_graph_neighborhood_ratio_equals_reference_on_port_artifact(tmp_path):
    emb, clusters = _clustered_emb()
    d = str(tmp_path / "graph")
    port_runner.run_job(_spec("port"), _backend("port", _model("port", emb)),
                        port_artifact.ChunkedArtifact(d))
    gmt = tmp_path / "planted.gmt"
    gmt.write_text("".join(
        f"CLUSTER{c}\turl\t" + "\t".join(f"G{i}" for i in range(40) if i % clusters == c) + "\n"
        for c in range(clusters)))
    got = port_tf.graph_neighborhood_ratio(d, str(gmt))
    assert got == ref_tf.graph_neighborhood_ratio(d, str(gmt))
    assert got["genes_scored"] == 40 and got["k"] == K and got["ratio"] > 1.5
    bad = tmp_path / "mismatch.gmt"
    bad.write_text("P\turl\tNOT_A_GENE\tALSO_NOT\n")
    for mod in (port_tf, ref_tf):
        with pytest.raises(ValueError, match="no graph gene"):
            mod.graph_neighborhood_ratio(d, str(bad))
    # the dashboard's offline Neighbors box answers as the reference's
    got_lookup, want_lookup = port_dash.load_graph_neighbors(d), ref_dash.load_graph_neighbors(d)
    for gene, k in (("G0", 3), ("G13", 10), ("NOPE", 3)):
        assert got_lookup(gene, k) == want_lookup(gene, k)
    # and the intrinsic-eval CLI's graph document is the reference's
    from gene2vec_tpu.cli import evaluate as ref_cli
    from gene2vec_tpu_torch.cli import evaluate as port_cli

    outs = {}
    for name, cli in (("port", port_cli), ("reference", ref_cli)):
        out = tmp_path / f"{name}.json"
        assert cli.main(["--graph-dir", d, str(gmt), "--out", str(out)]) == 0
        import json

        doc = json.loads(out.read_text())
        for key in ("created_unix", "command"):
            doc.pop(key, None)
        outs[name] = doc
    assert outs["port"] == outs["reference"]


def test_server_jobs_surface_runs_on_the_batch_lane_like_reference(tmp_path):
    """``ServeConfig(jobs_dir=)``: ``/v1/jobs`` on a single server, the job
    querying that server's own batcher on the batch lane
    (``BatcherBackend``); the same export through both packages' servers
    writes the same graph (near-ties aside), job routes collapse to one
    ``/v1/jobs`` label, and a server without a job store answers 404."""
    import json

    from gene2vec_tpu.serve.server import ServeApp as RefApp
    from gene2vec_tpu.serve.server import ServeConfig as RefConfig
    from gene2vec_tpu_torch.io.checkpoint import save_iteration
    from gene2vec_tpu_torch.io.vocab import Vocab
    from gene2vec_tpu_torch.serve.server import ServeApp, ServeConfig
    from gene2vec_tpu_torch.sgns.model import SGNSParams

    emb = _emb(seed=6)
    save_iteration(str(tmp_path / "export"), D, 1,
                   SGNSParams(torch.from_numpy(emb), torch.zeros(V, D)),
                   Vocab([f"G{i}" for i in range(V)], np.arange(V, 0, -1)), txt_output=False)
    apps = {
        "port": ServeApp(port_registry.ModelRegistry(str(tmp_path / "export"), device="cpu"),
                         config=ServeConfig(max_delay_ms=1.0, cache_size=0,
                                            jobs_dir=str(tmp_path / "port_jobs"))),
        "reference": RefApp(ref_registry.ModelRegistry(str(tmp_path / "export")),
                            config=RefConfig(max_delay_ms=1.0, cache_size=0,
                                             jobs_dir=str(tmp_path / "ref_jobs"))),
    }
    data = {}
    for name, app in apps.items():
        assert app.registry.refresh()
        app.start()
        try:
            status, doc = app.handle("POST", "/v1/jobs", {"type": "knn_graph", "k": K,
                                                          "chunk_rows": 8, "job_id": "g"})
            assert status == 200
            deadline = time.monotonic() + 60.0
            while app.handle("GET", "/v1/jobs/g", None)[1]["state"] != "done":
                assert time.monotonic() < deadline
                time.sleep(0.05)
            status, page = app.handle("GET", "/v1/jobs/g/artifact?part=tokens", None)
            assert status == 200 and page["eof"]
            data[name] = _read(os.path.join(app.jobs.job_dir("g"), "DATA.bin"))
        finally:
            app.stop()
    assert _near_tie_records("knn_graph", data["port"], data["reference"]) <= V // 4
    text = apps["port"].metrics.prometheus_text()
    assert 'serve_route_seconds_count{route="/v1/jobs"}' in text
    assert "batch_chunks_committed_total 3" in text
    plain = ServeApp(port_registry.ModelRegistry(str(tmp_path / "export"), device="cpu"),
                     config=ServeConfig(cache_size=0))
    assert plain.handle("GET", "/v1/jobs", None) == (404, {"error": "no route GET /v1/jobs"})
    assert json.dumps(plain._route_labels("/v1/jobs/g")) == '{"route": "other"}'
