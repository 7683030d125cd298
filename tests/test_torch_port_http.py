"""The port's HTTP front end against mrisr_tpu/serve/http.py (CPU): a bundle
the JAX package writes, served over HTTP by the port, answers each request
with the port engine's output for it and within rel-L2 0.02 of the JAX
package's forward; both servers answer the same endpoints the same way
over one forward (health, stats, 404, 400 on a bad body)."""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrisr_tpu.ckpt.fold_bn import fold_unet_batchnorm as jax_fold
from mrisr_tpu.serve import bundle as jb
from mrisr_tpu.serve import quant as jq
from mrisr_tpu.serve.engine import InferenceEngine as JaxEngine
from mrisr_tpu.serve.http import ServingServer as JaxServer
from mrisr_tpu_torch.serve import (
    InferenceEngine,
    load_bundle,
    make_bundle_apply,
)
from mrisr_tpu_torch.serve.http import ServingServer, serve_bundle
from torch_port_util import jax_unet_variables, noise, rel_l2

torch.set_num_threads(2)

F, HW = 4, 16


def _post(url, body: bytes):
    req = urllib.request.Request(url + "/predict", data=body)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as resp:
        return resp.status, resp.read()


def _status(fn, *args):
    try:
        return fn(*args)[0]
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()) if e.code == 400 else None


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    v = jax_unet_variables(F, HW, seed=81)
    folded = jax.tree.map(np.asarray, jax_fold(v["params"], v["batch_stats"]))
    x = noise((5, HW, HW, 2), seed=82)
    calib = jq.calibrate_unet(folded, [jnp.asarray(x)], dtype=jnp.float32)
    path = jb.save_bundle(str(tmp_path_factory.mktemp("http") / "b"),
                          jq.quantize_unet(folded, calib), model_name="unet",
                          quant="int8_fused", base_features=F,
                          image_size=(HW, HW))
    return path, x


def test_served_bundle_matches_engine_and_jax(bundle):
    """Five requests from five client threads (batch 2: wrap-padded
    batches): each answer equals the port's forward of that input, all
    within rel-L2 0.02 of the JAX package's bundle forward; /stats counts
    them."""
    path, x = bundle
    want = np.asarray(jb.make_bundle_apply(*jb.load_bundle(path))(
        jnp.asarray(x)))
    fwd = make_bundle_apply(*load_bundle(path), device="cpu")
    with serve_bundle(path, port=0, batch_size=2, max_delay_ms=20.0,
                      device="cpu").start_background() as srv:
        url = f"http://{srv.host}:{srv.port}"
        got = {}

        def client(i):
            status, body = _post(url, _npy(x[i]))
            assert status == 200
            got[i] = np.load(io.BytesIO(body))

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(x))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        stats = json.loads(_get(url, "/stats")[1])
    got = np.stack([got[i] for i in range(len(x))])
    assert got.shape == (5, HW, HW, 1) and got.dtype == np.float32
    for i in range(len(x)):
        np.testing.assert_array_equal(
            got[i], fwd(torch.from_numpy(x[i:i + 1])).numpy()[0])
    assert rel_l2(got, want) < 0.02
    assert stats["requests"] == 5 and stats["batches"] >= 3


def _mean_plus_one_port(x):
    return x.mean(dim=-1, keepdim=True) + 1.0


@jax.jit
def _mean_plus_one_jax(x):
    return jnp.mean(x, axis=-1, keepdims=True) + 1.0


def test_endpoints_match_jax_server():
    """The same forward behind both servers: the same answer, health,
    stats keys, 404 and a 400 with a JSON error on a body that is not an
    .npy or has the wrong shape."""
    shape = (8, 8, 2)
    x = np.random.default_rng(83).random(shape, np.float32)
    servers = {
        "jax": JaxServer(JaxEngine(_mean_plus_one_jax, batch_size=4,
                                   input_shape=shape, max_delay_ms=5.0),
                         port=0),
        "port": ServingServer(InferenceEngine(
            _mean_plus_one_port, batch_size=4, input_shape=shape,
            max_delay_ms=5.0, device="cpu"), port=0)}
    seen = {}
    for name, srv in servers.items():
        with srv.start_background():
            url = f"http://{srv.host}:{srv.port}"
            status, body = _post(url, _npy(x))
            assert status == 200
            y = np.load(io.BytesIO(body))
            assert _get(url, "/healthz") == (200, b"ok")
            stats = json.loads(_get(url, "/stats")[1])
            assert _status(_get, url, "/nope") == (404, None)
            bad = _status(_post, url, b"not an npy")
            wrong = _status(_post, url, _npy(np.zeros((4, 4, 2),
                                                      np.float32)))
            seen[name] = (y, set(stats), stats["requests"], bad[0],
                          wrong[0], set(bad[1]))
    np.testing.assert_allclose(seen["port"][0], seen["jax"][0], rtol=1e-6)
    assert seen["port"][1:] == seen["jax"][1:]
    assert seen["port"][2:5] == (1, 400, 400)
    assert seen["port"][5] == {"error"}


def test_phases_endpoint_serves_the_engine_phase_counters():
    """``/stats/phases``: the engine's time by phase, every documented
    key, non-negative, the requests counted and their queue wait over
    zero; ``/stats`` keeps the JAX server's keys."""
    from mrisr_tpu_torch.serve.http import PHASE_KEYS

    shape = (8, 8, 2)
    x = np.random.default_rng(84).random(shape, np.float32)
    srv = ServingServer(InferenceEngine(
        _mean_plus_one_port, batch_size=4, input_shape=shape,
        max_delay_ms=5.0, device="cpu"), port=0)
    with srv.start_background():
        url = f"http://{srv.host}:{srv.port}"
        for _ in range(3):
            assert _post(url, _npy(x))[0] == 200
        status, body = _get(url, "/stats/phases")
        phases = json.loads(body)
        assert "queue_wait_s" not in json.loads(_get(url, "/stats")[1])
    assert status == 200 and set(phases) == set(PHASE_KEYS)
    assert phases["requests"] == 3 and phases["batches"] == 3
    assert phases["queue_wait_s"] > 0
    assert all(v >= 0 for v in phases.values())
