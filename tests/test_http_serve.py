"""HTTP recommendation service: endpoints, errors, cold-start path."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from ttamm.serve import RetrievalService, build_flat_index, start_in_thread


@pytest.fixture(scope="module")
def server():
    rng = np.random.default_rng(7)
    items = rng.normal(0, 1, (50, 8)).astype(np.float32)
    users = rng.normal(0, 1, (10, 8)).astype(np.float32)
    service = RetrievalService(
        index=build_flat_index(items, normalize=True),
        user_embeddings=users,
        user_ids=[f"U{i}" for i in range(10)],
        item_ids=[f"ASIN{i:03d}" for i in range(50)],
        user_to_idx={f"U{i}": i for i in range(10)},
        similarity="cosine",
    )
    srv, _thread = start_in_thread(service, port=0, backend="numpy")
    yield srv, service
    srv.shutdown()
    srv.server_close()


def _get(srv, path):
    port = srv.server_address[1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(srv, path, payload):
    port = srv.server_address[1]
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(server):
    srv, _ = server
    status, body = _get(srv, "/healthz")
    assert status == 200
    assert body == {"status": "ok", "users": 10, "items": 50, "similarity": "cosine"}


def test_get_recommend_matches_service(server):
    srv, service = server
    status, body = _get(srv, "/v1/recommend?user_id=U3&k=5")
    assert status == 200
    expected = service.recommend_for_user("U3", k=5, backend="numpy")
    assert [it["asin"] for it in body["items"]] == [a for a, _ in expected]
    assert body["items"][0]["score"] == pytest.approx(expected[0][1])


def test_post_recommend_user(server):
    srv, _ = server
    status, body = _post(srv, "/v1/recommend", {"user_id": "U0", "k": 3})
    assert status == 200
    assert len(body["items"]) == 3


def test_post_cold_start_embedding(server):
    srv, service = server
    emb = np.ones(8, np.float32)
    status, body = _post(srv, "/v1/recommend", {"embedding": emb.tolist(), "k": 4})
    assert status == 200
    expected = service.recommend_for_embedding(emb, k=4, backend="numpy")
    assert [it["asin"] for it in body["items"]] == [a for a, _ in expected]


def test_unknown_user_404(server):
    srv, _ = server
    status, body = _get(srv, "/v1/recommend?user_id=NOBODY")
    assert status == 404
    assert "unknown user_id" in body["error"]


def test_bad_requests(server):
    srv, _ = server
    assert _get(srv, "/v1/recommend")[0] == 400  # missing user_id
    assert _get(srv, "/v1/recommend?user_id=U1&k=zebra")[0] == 400
    assert _get(srv, "/nope")[0] == 404
    assert _post(srv, "/v1/recommend", {})[0] == 400  # neither id nor embedding
    assert (
        _post(srv, "/v1/recommend", {"user_id": "U1", "embedding": [1.0]})[0] == 400
    )  # both
    assert _post(srv, "/v1/recommend", {"user_id": "U1", "k": 0})[0] == 400
    assert _post(srv, "/v1/recommend", {"embedding": [1.0, 2.0]})[0] == 400  # bad dim
