"""PyTorch port, the HTTP server (particle_fm_tpu_torch/server.py) over a
CPU artifact of the port (serving.py), as tests/test_server.py drives the
JAX package's: a real ThreadingHTTPServer and a real HTTP client (urllib):
the health and meta routes, conditional sampling with explicit masks and
per-sample multiplicities, requests chunked past the artifact's batch, seed
determinism and independence, and the 400, 404 and 413 paths. The samples
over HTTP equal `serve_batches` on the same artifact. The same bad requests
sent to a JAX server over the same model's JAX artifact get the same status
codes and messages.
"""

from __future__ import annotations

import http.client
import json
import threading
import urllib.error
import urllib.request
from urllib.parse import urlparse

import jax
import numpy as np
import pytest

from particle_fm_tpu import serving as jserving
from particle_fm_tpu.models.flow_matching import FlowMatchingModel as JaxModel
from particle_fm_tpu.server import make_server as jax_make_server
from particle_fm_tpu_torch import serving
from particle_fm_tpu_torch.models.flow_matching import FlowMatchingModel
from particle_fm_tpu_torch.server import RequestError, SamplerService, make_server

MODEL = dict(num_particles=8, features=3, hidden_dim=16, latent=4, layers=1, global_cond_dim=2,
             local_cond_dim=2)
EXPORT = dict(batch_size=4, num_points=8, features=3, cond_dim=2, use_mask=True,
              ode_solver="midpoint", ode_steps=4, means=np.array([0.1, -0.2, 0.3]),
              stds=np.array([1.5, 2.0, 0.5]))


def _request(url, body=None):
    req = urllib.request.Request(
        url,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _status(url, body=None):
    """(status code, JSON body) of a request, errors included."""
    try:
        return _request(url, body)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    host, port = srv.server_address[:2]
    return t, f"http://{host}:{port}"


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = FlowMatchingModel(**MODEL)
    net = model.init(seed=0, device="cpu")
    out = str(tmp_path_factory.mktemp("artifact") / "exported")
    serving.export_sampler(model, net, **EXPORT, device="cpu", out_dir=out)
    return out


@pytest.fixture(scope="module")
def server(artifact):
    srv = make_server(artifact, port=0)  # any free port; warm-up included
    t, url = _serve(srv)
    srv.url = url
    try:
        yield srv
    finally:
        srv.shutdown()
        t.join(timeout=10)


@pytest.fixture(scope="module")
def url(server):
    return server.url


@pytest.fixture(scope="module")
def jax_url(tmp_path_factory):
    model = JaxModel(**MODEL)
    blob, meta = jserving.export_sampler(model, model.init(jax.random.PRNGKey(0)), **EXPORT)
    out = jserving.save_exported(str(tmp_path_factory.mktemp("jax_artifact") / "exported"),
                                 blob, meta)
    srv = jax_make_server(out, port=0)
    t, jurl = _serve(srv)
    try:
        yield jurl
    finally:
        srv.shutdown()
        t.join(timeout=10)


def test_healthz_and_meta(url, artifact):
    status, body = _request(f"{url}/healthz")
    assert status == 200 and body["status"] == "ok"
    assert body["requests_served"] >= 1  # the warm-up counts
    status, meta = _request(f"{url}/meta")
    assert status == 200
    assert meta["batch_size"] == 4 and meta["output_units"] == "physical"
    assert meta == serving.load_exported(artifact)[1]


def test_sample_chunked_conditional(url):
    # 6 samples > batch 4: two batches, the last one padded
    rs = np.random.RandomState(0)
    cond = rs.randn(6, 2).astype(np.float32).tolist()
    mult = [8, 5, 3, 8, 1, 7]
    body = {"n_samples": 6, "seed": 3, "cond": cond, "num_points": mult}
    status, out = _request(f"{url}/sample", body)
    assert status == 200 and out["shape"] == [6, 8, 3]
    x = np.asarray(out["samples"], np.float32)
    assert np.isfinite(x).all()
    for i, m in enumerate(mult):  # the multiplicity mask zeroes the padding rows
        assert np.all(x[i, m:] == 0)
        assert np.abs(x[i, :m]).max() > 0
    _, again = _request(f"{url}/sample", body)
    np.testing.assert_array_equal(np.asarray(again["samples"], np.float32), x)
    _, other = _request(f"{url}/sample", dict(body, seed=4))
    assert np.abs(np.asarray(other["samples"]) - x).max() > 1e-3


def test_samples_over_http_equal_serve_batches(url, server):
    rs = np.random.RandomState(1)
    cond = rs.randn(7, 2).astype(np.float32)
    mult = np.array([8, 2, 5, 8, 1, 7, 3])
    _, out = _request(f"{url}/sample", {"n_samples": 7, "seed": 12, "cond": cond.tolist(),
                                        "num_points": mult.tolist()})
    mask = (np.arange(8)[None, :] < mult[:, None]).astype(np.float32)[..., None]
    svc = server.service
    want = serving.serve_batches(svc.fn, svc.meta, 7, cond=cond, mask=mask, seed=12)
    np.testing.assert_array_equal(np.asarray(out["samples"], np.float32), want)


def test_sample_explicit_mask_2d(url):
    cond = np.zeros((2, 2), np.float32).tolist()
    mask = [[1, 1, 1, 0, 0, 0, 0, 0], [1] * 8]
    status, body = _request(f"{url}/sample", {"n_samples": 2, "cond": cond, "mask": mask})
    assert status == 200
    x = np.asarray(body["samples"])
    assert x.shape == (2, 8, 3) and np.all(x[0, 3:] == 0)


BAD = [
    ({}, "n_samples"),
    ({"n_samples": 0}, ">= 1"),
    ({"n_samples": 2}, "'cond'"),  # a conditional artifact
    ({"n_samples": 2, "cond": [[0.0, 0.0]]}, "cond shape"),  # wrong rows
    ({"n_samples": 2, "cond": [[0.0, 0.0]] * 2, "num_points": [9, 2]}, "[0, 8]"),
    ({"n_samples": 2, "cond": [[0.0, 0.0]] * 2, "mask": [[1] * 5] * 2}, "mask shape"),
    ({"n_samples": 100000}, "cap"),  # > max_n_samples
    ({"n_samples": 2, "cond": [[0.0, 0.0]] * 2, "seed": "abc"}, "'seed'"),
    ({"n_samples": 2, "cond": [[0.0, 0.0]] * 2, "seed": -1}, "'seed'"),
]


@pytest.mark.parametrize("body,frag", BAD)
def test_sample_bad_requests_400(url, body, frag):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _request(f"{url}/sample", body)
    assert exc.value.code == 400
    assert frag in json.loads(exc.value.read())["error"]


@pytest.mark.parametrize("route,body", [("/sample", b) for b, _ in BAD]
                         + [("/sample", {"n_samples": "x"}), ("/sample", [1, 2]),
                            ("/nope", None), ("/nope", {"n_samples": 1})])
def test_bad_requests_get_the_jax_servers_codes(url, jax_url, route, body):
    code, out = _status(f"{url}{route}", body)
    jcode, jout = _status(f"{jax_url}{route}", body)
    assert code == jcode and code in (400, 404)
    assert out == jout


def test_unknown_route_404(url):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _request(f"{url}/nope")
    assert exc.value.code == 404


def test_oversized_body_413_without_reading(url):
    """A Content-Length above the cap is refused (413) before the body is
    read: a client that never sends the bytes it announced cannot hold the
    server."""
    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    try:
        conn.putrequest("POST", "/sample")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(10**12))
        conn.endheaders()
        conn.send(b"{}")
        resp = conn.getresponse()
        assert resp.status == 413
        assert "exceeds" in json.loads(resp.read())["error"]
    finally:
        conn.close()


def test_mask_rejected_when_artifact_unmasked():
    """An artifact exported with use_mask=False answers a client mask with
    400, rather than ignoring it."""
    svc = SamplerService.__new__(SamplerService)  # no artifact needed
    svc.meta = {"use_mask": False, "num_points": 8}
    with pytest.raises(RequestError, match="without mask support"):
        svc._build_mask({"mask": [[1] * 8]}, 1)
    with pytest.raises(RequestError, match="without mask support"):
        svc._build_mask({"num_points": [4]}, 1)
    assert svc._build_mask({}, 1) is None


def test_chunk_seed_independence(url):
    """Each chunk's seed hashes (seed, chunk): with equal cond, seed s+1's
    chunk 0 is not seed s's chunk 1."""
    cond = [[0.25, -0.5]] * 6
    _, a = _request(f"{url}/sample", {"n_samples": 6, "seed": 3, "cond": cond})
    _, b = _request(f"{url}/sample", {"n_samples": 6, "seed": 4, "cond": cond})
    xa = np.asarray(a["samples"], np.float32)  # chunks [0:4], [4:6]
    xb = np.asarray(b["samples"], np.float32)
    assert np.abs(xb[:2] - xa[4:6]).max() > 1e-3
