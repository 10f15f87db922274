"""The port's ``kaeg-sim`` CLI (``simulator/cli.py``) against the JAX
package's: ``list`` prints the same lines; ``run --device cpu`` prints the
JAX report on the same seed and scenarios, field by field (the uuid4
incident ids and the host-timed ``device_seconds`` left out); an unknown
scenario gives rc 2 with the same message; ``run`` without ``--device``
needs the card; ``create``/``cleanup`` send the JAX injector's requests
to a canned K8s server. The pattern is tests/test_cli.py."""
from __future__ import annotations

import importlib
import json
import threading
from http.server import ThreadingHTTPServer

import pytest
import torch

from tests import test_live_backend as canned

JAX_PKG = "kubernetes_aiops_evidence_graph_tpu"
PORT_PKG = "kubernetes_aiops_evidence_graph_tpu_torch"

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)


def _cli(pkg):
    return importlib.import_module(pkg + ".simulator.cli")


def _both(argv, capsys, port_extra=()):
    out = {}
    for pkg in (JAX_PKG, PORT_PKG):
        extra = list(port_extra) if pkg == PORT_PKG else []
        rc = _cli(pkg).main(list(argv) + extra)
        cap = capsys.readouterr()
        out[pkg] = (rc, cap.out, cap.err)
    return out


def test_list_prints_the_jax_lines(capsys):
    out = _both(["list"], capsys)
    assert out[PORT_PKG] == out[JAX_PKG]
    assert out[PORT_PKG][0] == 0 and len(out[PORT_PKG][1].splitlines()) == 10


def _comparable(report: dict) -> dict:
    report = json.loads(json.dumps(report))
    report["graph"].pop("device_seconds")
    for entry in report["incidents"]:
        entry.pop("incident")
    return report


@pytest.mark.parametrize("backend", ["both", "tpu", "cpu"])
def test_run_report_equals_the_jax_report(backend, capsys):
    argv = ["run", "-s", "crashloop_deploy", "-s", "oom", "-s", "imagepull",
            "--pods", "64", "--seed", "0", "--backend", backend]
    out = _both(argv, capsys, port_extra=("--device", "cpu"))
    reports = {}
    for pkg, (rc, stdout, _err) in out.items():
        assert rc == 0
        reports[pkg] = json.loads(stdout)
    want, got = reports[JAX_PKG], reports[PORT_PKG]
    assert len(got["incidents"]) == 3
    if backend == "cpu":
        assert "graph" not in got and "graph" not in want
        for entry in (*got["incidents"], *want["incidents"]):
            entry.pop("incident")
        assert got == want
        return
    assert got["graph"]["device_seconds"] >= 0.0
    assert _comparable(got) == _comparable(want)
    for entry in got["incidents"]:
        assert entry["tpu_top1"]["rule"] == entry["expected_rule"]
        if backend == "both":
            assert entry["tpu_top1"]["rule"] == entry["cpu_top1"]["rule"]
            assert abs(entry["tpu_top1"]["confidence"]
                       - entry["cpu_top1"]["confidence"]) < 1e-3


def test_unknown_scenario_gives_rc_2_and_the_jax_message(capsys):
    out = _both(["run", "-s", "no_such_fault"], capsys,
                port_extra=("--device", "cpu"))
    assert out[PORT_PKG] == out[JAX_PKG]
    assert out[PORT_PKG][0] == 2 and "no_such_fault" in out[PORT_PKG][2]


def test_run_needs_the_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _cli(PORT_PKG).main(["run", "-s", "oom", "--pods", "64"])


@pytest.fixture(scope="module")
def k8s():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), canned._Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("argv", [
    ["create", "-s", "crashloop", "-n", "payments"],
    ["create", "-s", "slowapp"],
    ["cleanup", "-n", "payments"]], ids=["create", "create-service",
                                         "cleanup"])
def test_create_and_cleanup_send_the_jax_requests(argv, k8s, capsys):
    out = {}
    for pkg in (JAX_PKG, PORT_PKG):
        canned.WRITES.clear()
        rc = _cli(pkg).main(argv + ["--k8s-url", k8s])
        out[pkg] = (rc, capsys.readouterr().out, list(canned.WRITES))
    assert out[PORT_PKG] == out[JAX_PKG]
    if argv[0] == "create":
        assert out[PORT_PKG][0] == 0 and json.loads(out[PORT_PKG][1])["created"]
        assert [m for m, _p, _b in out[PORT_PKG][2]][:2] == ["DELETE", "POST"]
