"""``python -m eksml_tpu_torch.launch`` on the CPU: two ranks of a stand-in
child (stdlib only, no trainer, no JAX).

The stand-in writes its env and argv to ``<STUB_DIR>/rank<r>.json`` and a
line to its stdout, then waits.  On SIGTERM it writes ``rank<r>.term`` and
exits ``STUB_TERM_RANK<r>`` (default 77; ``ignore`` keeps it waiting);
``STUB_END_RANK<r>=<code>@<seconds>`` ends it on its own.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from eksml_tpu_torch import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 20.0        # each test's own bound on the launcher

STUB = '''
import json, os, signal, sys, time
rank = os.environ["LOCAL_RANK"]
d = os.environ["STUB_DIR"]
on_term = os.environ.get("STUB_TERM_RANK" + rank, "77")
end = os.environ.get("STUB_END_RANK" + rank)
got = []
def handler(signum, frame):
    got.append(signum)
    with open(os.path.join(d, "rank%s.term" % rank), "w") as f:
        f.write(str(signum))
signal.signal(signal.SIGTERM, handler)
keys = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
        "LOCAL_WORLD_SIZE", "LOCAL_RANK")
with open(os.path.join(d, "rank%s.json" % rank), "w") as f:
    json.dump({"env": {k: os.environ.get(k) for k in keys},
               "argv": sys.argv[1:], "pid": os.getpid()}, f)
print("stub rank %s up" % rank, flush=True)
t0 = time.monotonic()
while True:
    if got and on_term != "ignore":
        sys.exit(int(on_term))
    if end:
        code, after = end.split("@")
        if time.monotonic() - t0 > float(after):
            sys.exit(int(code))
    time.sleep(0.02)
'''


def start(tmp_path, *extra, env=None):
    (tmp_path / "launch_stub.py").write_text(STUB)
    full = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}",
                STUB_DIR=str(tmp_path), COORDINATOR_ADDRESS="10.0.0.1:8476",
                NUM_PROCESSES="3", PROCESS_ID="2", **(env or {}))
    cmd = [sys.executable, "-m", "eksml_tpu_torch.launch",
           "--nproc-per-node", "2", *extra, "launch_stub", "--flag", "x"]
    return subprocess.Popen(cmd, env=full, cwd=str(tmp_path),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, timeout=LIMIT):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out, err


def wait_for(paths, timeout=LIMIT):
    deadline = time.monotonic() + timeout
    while not all(os.path.exists(p) for p in paths):
        assert time.monotonic() < deadline, f"never appeared: {paths}"
        time.sleep(0.02)


def rows(tmp_path):
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]


def test_each_rank_has_the_pod_env_and_its_local_rank(tmp_path):
    proc = start(tmp_path, env={"STUB_END_RANK0": "0@0.1",
                                "STUB_END_RANK1": "0@0.3"})
    rc, out, err = finish(proc)
    assert rc == 0, err
    for r, row in enumerate(rows(tmp_path)):
        assert row["env"] == {"COORDINATOR_ADDRESS": "10.0.0.1:8476",
                              "NUM_PROCESSES": "3", "PROCESS_ID": "2",
                              "LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": str(r)}
        assert row["argv"] == ["--flag", "x"]
        assert f"[rank {r}] stub rank {r} up" in out.splitlines()
    # the rank that ended first with 0 did not cut its sibling short
    assert not any((tmp_path / f"rank{r}.term").exists() for r in range(2))


@pytest.mark.parametrize("on_term,want", [
    ({}, 77),
    ({"STUB_TERM_RANK1": "3"}, 3),
    ({"STUB_TERM_RANK0": "0"}, 1),
    ({"STUB_TERM_RANK1": "ignore"}, 128 + signal.SIGKILL),
])
def test_sigterm_reaches_every_rank(tmp_path, on_term, want):
    proc = start(tmp_path, "--stop-budget", "1", env=on_term)
    wait_for([tmp_path / f"rank{r}.json" for r in range(2)])
    proc.send_signal(signal.SIGTERM)        # the pod's PID 1 only
    rc, _, err = finish(proc)
    assert rc == want, err
    for r, row in enumerate(rows(tmp_path)):
        # each rank process had the signal itself
        assert (tmp_path / f"rank{r}.term").read_text() == \
            str(int(signal.SIGTERM))
        with pytest.raises(ProcessLookupError):
            os.kill(row["pid"], 0)


def test_a_crashing_rank_stops_its_sibling(tmp_path):
    proc = start(tmp_path, env={"STUB_END_RANK1": "5@0.3"})
    rc, _, err = finish(proc)
    assert rc == 5, err
    assert (tmp_path / "rank0.term").exists()
    assert not (tmp_path / "rank1.term").exists()
    assert "ranks exited [77, 5]: job exit code 5" in err


def test_rank_group_reaps_and_reports(tmp_path):
    """The core the operator's actuator shares: ranks to log files, a
    stop that reaps them, the codes kept."""
    (tmp_path / "launch_stub.py").write_text(STUB)
    base = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}",
                STUB_DIR=str(tmp_path))
    group = launch.RankGroup(stop_budget=LIMIT)
    assert group.poll() is None and group.stop() is None
    logs = [str(tmp_path / f"log{r}.txt") for r in range(2)]
    group.start([sys.executable, "-m", "launch_stub"],
                launch.rank_envs(2, base), logs=logs, cwd=str(tmp_path))
    wait_for([tmp_path / f"rank{r}.json" for r in range(2)])
    assert group.running and group.poll() is None
    with pytest.raises(RuntimeError):
        group.start([sys.executable, "-m", "launch_stub"],
                    launch.rank_envs(1, base))
    assert group.stop() == 77 and group.last_exit_codes == [77, 77]
    assert not group.running
    assert [open(p).read() for p in logs] == [
        f"stub rank {r} up\n" for r in range(2)]
