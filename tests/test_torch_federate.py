"""The port's fleet launcher on the CPU: the ``local`` role against a
``FedKTSession`` on the socket transport, one ``coordinator`` and two
``party`` OS processes against the ``local`` role, journal resume and a
seeded chaos round through the CLI, the roster checks, and the default
device (the card) raising where there is none.

Tolerance: exact — the JSON reports agree key for key (accuracy as the
report rounds it, epsilon, arrivals, drops, every wire-byte count),
wall-clock seconds aside.
"""
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.federation import SocketTransport
from repro_torch.launch import federate

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--parties", "2", "--learner", "rf", "--trees", "3", "--depth",
         "3", "--subsets", "2", "--n-train", "800", "--engine", "vmap",
         "--privacy", "L2", "--seed", "3"]


def _report(text):
    """The JSON report a role printed (after any status lines)."""
    out = json.loads(text[text.index("{"):])
    out.pop("seconds")
    return out


def _local(capsys, *extra):
    federate.main(["local", "--device", "cpu", "--port", "0", *FLAGS,
                   *extra])
    return _report(capsys.readouterr().out)


@pytest.fixture(scope="module")
def local_report():
    """The local role's report, computed once for the module."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        federate.main(["local", "--device", "cpu", "--port", "0", *FLAGS])
    return _report(buf.getvalue())


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_local_role_equals_the_socket_session(capsys, local_report):
    ns = federate.parse_args(["local", "--device", "cpu", "--port", "0",
                              *FLAGS])
    res = federate.build_session(ns, SocketTransport(port=0)).run()
    federate._report(res)
    assert _report(capsys.readouterr().out) == local_report
    assert local_report["arrived"] == 2
    assert local_report["dropped_parties"] == []
    assert local_report["epsilon"] > 0
    assert res.meta["device"] == "cpu"


def test_coordinator_and_party_processes_equal_the_local_role(local_report):
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.federate"]
    common = ["--device", "cpu", "--port", port, *FLAGS]
    procs = [subprocess.Popen(cmd + ["coordinator", *common,
                                     "--deadline-s", "120"],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=ROOT)]
    procs += [subprocess.Popen(cmd + ["party", "--party-id", str(i),
                                      "--retries", "10", *common],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True, env=env,
                               cwd=ROOT) for i in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    coord_out = outs[0][0]
    assert coord_out.startswith("coordinator: waiting for 2 parties")
    assert _report(coord_out) == local_report
    for i in range(2):
        assert f"party {i} (rf): update delivered" in outs[1 + i][0]


def test_local_role_resumes_its_journal(capsys, tmp_path, local_report):
    journal = str(tmp_path / "round.jrnl")
    first = _local(capsys, "--journal", journal)
    again = _local(capsys, "--journal", journal, "--resume")
    assert first["resumed"] is False and again["resumed"] is True
    assert again["replayed_parties"] == [0, 1]
    for rep in (first, again):
        rep = {k: v for k, v in rep.items() if k in local_report}
        assert rep == local_report


def test_local_role_chaos_round(capsys, local_report):
    out = _local(capsys, "--chaos", "--chaos-seed", "4")
    assert out["chaos"]
    assert {k: v for k, v in out.items() if k != "chaos"} == local_report


def _roster(parties, learners):
    return federate.party_kinds(federate.parse_args(
        ["local", "--parties", str(parties), "--learners", learners]))


def test_roster_checks():
    with pytest.raises(SystemExit, match="names 2 kinds"):
        _roster(3, "rf,gbdt")
    with pytest.raises(SystemExit, match="unknown learner kind 'svm'"):
        _roster(2, "rf,svm")
    assert _roster(3, "rf,gbdt,nn") == ["rf", "gbdt", "nn"]
    assert federate.parse_args(["local"]).device == "cuda"


@pytest.mark.parametrize("role", ["local", "coordinator", "party"])
def test_roles_ask_for_the_card_and_raise_without_one(role):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-card path is "
                    "checked on CPU-only hosts")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        federate.main([role, "--port", "1", "--retries", "1", *FLAGS])
