"""The port's launcher flags against the JAX reference's, on the CPU:
``cluster_sim --backend torch|python`` (the reference's ``--backend
jax|python``: the same summary lines, and the two port backends the same
schedule), and ``serve --sched-status`` (its payloads equal the
reference's, ``/healthz`` apart from the backend's name; the endpoints
served over a socket for ``--max-requests`` requests)."""
import argparse
import io
import json
import threading
import urllib.request
from contextlib import redirect_stdout

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.launch import cluster_sim as jsim  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import cluster_sim as tsim  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

FLEET = ["--chips", "64", "--tenants", "3", "--horizon", "120", "--quantum",
         "5", "--arrival-rate", "0.1", "--save-mib-per-tick", "512",
         "--fast-tier-cap-mib", "1024"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = main(argv)
    return res, buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("policy", ["omfs", "backfill_cr"])
def test_cluster_sim_backends_print_the_references_lines(policy):
    """``--backend torch`` prints the reference ``jax`` backend's summary,
    ``--backend python`` the reference ``python`` backend's; with a pass
    depth above every queue the two port backends give one schedule."""
    argv = FLEET + ["--policy", policy, "--pass-depth", "4096"]
    port_torch, t_lines = _run(tsim.main, argv + ["--backend", "torch",
                                                  "--device", "cpu"])
    port_py, p_lines = _run(tsim.main, argv + ["--backend", "python"])
    _, j_lines = _run(jsim.main, argv + ["--backend", "jax"])
    _, jp_lines = _run(jsim.main, argv + ["--backend", "python"])
    assert t_lines[-1] == j_lines[-1] and t_lines[-1].startswith("utilization")
    assert p_lines[-1] == jp_lines[-1] and " jain " in p_lines[-1]
    assert "backend=torch" in t_lines[0] and "backend=python" in p_lines[0]
    assert port_torch.signature() == port_py.signature()
    assert port_torch.backend == "torch" and port_py.backend == "python"
    assert "preemptions 0 " not in t_lines[-1]


def test_cluster_sim_refuses_the_references_backend_names():
    for name in ("jax", "cuda"):
        with pytest.raises(SystemExit):
            _run(tsim.main, ["--backend", name])


def _ns(**kw):
    base = dict(tenants=3, horizon=80, chips=32, seed=0, arrival_rate=0.1,
                quantum=6, policy="omfs", backend="python", device="cpu",
                host="127.0.0.1", port=0, max_requests=0)
    base.update(kw)
    return argparse.Namespace(**base)


def _trace_without_ids(body):
    """A trace with its job ids renumbered from the first span's and the
    backend's name blanked: each package numbers the jobs its generator
    makes from its own counter, and the trace names its backend."""
    trace = json.loads(body)
    first = min(e["args"]["jid"] for e in trace["traceEvents"]
                if e.get("ph") == "X")
    for e in trace["traceEvents"]:
        if e.get("ph") == "X":
            e["args"]["jid"] -= first
            e["name"] = f"job {e['args']['jid']}"
        elif e.get("ph") in ("s", "f"):
            e["id"] -= first
    trace["otherData"]["backend"] = "any"
    return trace


@pytest.mark.parametrize("policy", ["omfs", "backfill_cr"])
@pytest.mark.parametrize("backend,ref_backend", [("torch", "jax"),
                                                 ("python", "python")])
def test_sched_status_payloads_equal_the_references(backend, ref_backend,
                                                    policy):
    ours = tserve.sched_status_payloads(_ns(backend=backend, policy=policy))
    theirs = jserve.sched_status_payloads(_ns(backend=ref_backend,
                                              policy=policy))
    assert set(ours) == set(theirs) == {"/metrics", "/trace.json",
                                        "/healthz"}
    for path in ours:
        assert ours[path][0] == theirs[path][0]
    assert ours["/metrics"][1] == theirs["/metrics"][1]
    assert b"sched_events_total" in ours["/metrics"][1]
    assert _trace_without_ids(ours["/trace.json"][1]) == _trace_without_ids(
        theirs["/trace.json"][1])
    health, jhealth = (json.loads(p["/healthz"][1]) for p in (ours, theirs))
    assert health.pop("backend") == backend
    assert jhealth.pop("backend") == ref_backend
    assert health == jhealth
    assert health["status"] == "ok" and health["events"] > 0
    assert health["events_dropped"] == 0


def test_sched_status_torch_equals_python():
    torch_p = tserve.sched_status_payloads(_ns(backend="torch"))
    py_p = tserve.sched_status_payloads(_ns(backend="python"))
    assert torch_p["/metrics"] == py_p["/metrics"]
    assert _trace_without_ids(torch_p["/trace.json"][1]) == \
        _trace_without_ids(py_p["/trace.json"][1])


def test_sched_status_serves_over_a_socket():
    args = _ns(max_requests=4)
    payloads = tserve.sched_status_payloads(args)
    server = tserve.sched_status_server(args, payloads)
    host, port = server.server_address[:2]
    out = io.StringIO()

    def serve():
        with redirect_stdout(out):
            tserve.serve_sched_status(args, server)

    thread = threading.Thread(target=serve)
    thread.start()
    got = {}
    for path in ("/metrics", "/trace.json?x=1", "/healthz"):
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=30) as resp:
            got[path.split("?")[0]] = (resp.headers["Content-Type"],
                                       resp.read())
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://{host}:{port}/nope", timeout=30)
    assert err.value.code == 404
    thread.join(timeout=30)
    assert not thread.is_alive()          # --max-requests 4: it ended
    assert got == payloads
    assert f"sched-status on http://{host}:{port}" in out.getvalue()


def test_serve_main_needs_arch_without_sched_status():
    with pytest.raises(SystemExit):
        with redirect_stdout(io.StringIO()):
            tserve.main(["--smoke"])
