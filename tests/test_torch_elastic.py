"""The sharded pipeline's fault and resume drills through the port's CLI, on
the CPU (``--device cpu --dop N``: gloo ranks spawned by the launcher).

Each run is a subprocess, so rank 0's report reaches its stderr: a preempt
storm under the supervisor, exit 75 and a resume on fewer ranks, a flipped bit
on a host pull repaired by a re-pull, a wedged collective turned into a
preemption by the watchdog, and a failed rank failing the launch at once.
Every output must be byte-identical to the single-device run's (exact).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_rank_cases
from rdfind_tpu.utils.synth import write_nt
from rdfind_tpu_torch.parallel import launch, mesh
from rdfind_tpu_torch.utils import synth
from torch_harness import port_module, time_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# ~5 dep-slice passes on 4 ranks for the file below.
BUDGET = "2048"


@pytest.fixture(scope="module")
def nt_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("nt") / "data.nt"
    write_nt(path, np.asarray(synth.generate_triples(
        500, seed=4, n_predicates=6, n_entities=50), np.int32))
    return str(path)


def _cli(nt_file, out, *args, env=None):
    """One CLI run (strategy 0, support 3); returns (rc, stderr, lines)."""
    full_env = {**os.environ, "RDFIND_BACKOFF_BASE_MS": "1",
                "RDFIND_PAIR_ROW_BUDGET": BUDGET, **(env or {})}
    proc = subprocess.run(
        [sys.executable, "-m", "rdfind_tpu_torch.programs.rdfind", nt_file,
         "--support", "3", "--traversal-strategy", "0", "--device", "cpu",
         "--output", str(out), "--counters", "1", *args],
        capture_output=True, text=True, timeout=100, env=full_env,
        cwd=REPO)
    lines = open(out).read().splitlines() if os.path.exists(out) else None
    return proc.returncode, proc.stderr, lines


def _counter(stderr, key):
    for ln in stderr.splitlines():
        if ln.startswith(f"{key}: "):
            return ln.split(": ", 1)[1]
    return None


@pytest.fixture(scope="module")
def single(nt_file, tmp_path_factory):
    out = tmp_path_factory.mktemp("single") / "out.txt"
    rc, err, lines = _cli(nt_file, out)
    assert rc == 0, err
    return lines


def test_dop4_output_equals_single_device(nt_file, single, tmp_path):
    rc, err, lines = _cli(nt_file, tmp_path / "out.txt", "--dop", "4")
    assert rc == 0, err
    assert lines == single
    assert _counter(err, "stat-dist_backend") == "gloo"
    assert int(_counter(err, "stat-n_pair_passes")) > 1


def test_preempt_storm_under_the_supervisor(nt_file, single, tmp_path):
    faults = ";".join(f"preempt@discover:pass={p}" for p in range(3))
    rc, err, lines = _cli(nt_file, tmp_path / "out.txt", "--dop", "4",
                          "--checkpoint-dir", str(tmp_path / "ck"),
                          "--retry-on-preempt", "3",
                          env={"RDFIND_FAULTS": faults})
    assert rc == 0, err
    assert lines == single
    assert err.count("supervisor retry") == 3
    assert _counter(err, "supervisor-attempts") == "3"
    assert _counter(err, "stat-resumed_passes") == "3"


def test_exit_75_then_resume_on_two_ranks(nt_file, single, tmp_path):
    ck = tmp_path / "ck"
    rc, err, _ = _cli(nt_file, tmp_path / "a.txt", "--dop", "4",
                      "--checkpoint-dir", str(ck),
                      env={"RDFIND_FAULTS": "preempt@discover:pass=1"})
    assert rc == 75, err
    assert any(f.startswith("progress-") for f in os.listdir(ck))
    rc, err, lines = _cli(nt_file, tmp_path / "b.txt", "--dop", "2",
                          "--checkpoint-dir", str(ck),
                          env={"RDFIND_INTEGRITY": "1"})
    assert rc == 0, err
    assert lines == single
    resume = eval(_counter(err, "stat-elastic_resume"))  # a printed dict
    assert resume["from_num_dev"] == 4 and resume["to_num_dev"] == 2
    assert resume["resharded_blocks"] == 2
    assert int(_counter(err, "stat-resumed_passes")) == 2
    assert int(_counter(err, "stat-integrity_verified")) >= 2


def test_flip_at_host_pull_repaired_by_a_re_pull(nt_file, single, tmp_path):
    cert = tmp_path / "cert.json"
    rc, err, lines = _cli(nt_file, tmp_path / "out.txt", "--dop", "4",
                          env={"RDFIND_INTEGRITY": "1",
                               "RDFIND_FAULTS": "flip@host_pull:nth=1",
                               "RDFIND_CERT": str(cert)})
    assert rc == 0, err
    assert lines == single
    c = json.load(open(cert))
    assert c["summary"]["mismatches"] == 1
    assert c["summary"]["repaired"] == 1
    assert c["output_digest"] == _counter(err, "output-digest")


def test_flip_on_one_rank_is_repaired_by_every_rank(nt_file, single,
                                                   tmp_path):
    """A flip in rank 2's copy only: the verdict is the mesh's, so every
    rank re-pulls together (a re-pull on rank 2 alone would enter gathers
    its peers never join)."""
    cert = tmp_path / "cert.json"
    rc, err, lines = _cli(nt_file, tmp_path / "out.txt", "--dop", "4",
                          env={"RDFIND_INTEGRITY": "1",
                               "RDFIND_FAULTS": "flip@host_pull:nth=2:rank=2",
                               "RDFIND_CERT": str(cert)})
    assert rc == 0, err
    assert lines == single
    c = json.load(open(cert))
    assert c["summary"]["mismatches"] == 1
    assert c["summary"]["repaired"] == 1


def test_failed_copy_on_one_rank_retries_that_copy_alone(nt_file, single,
                                                         tmp_path):
    """Host pulls that fail on rank 1 only (a quarter of them, from the
    fault plan's seeded draw, the copies after a gather among them) retry
    rank 1's local copy alone; the gathers ran once on every rank, so the
    run goes on in step."""
    rc, err, lines = _cli(nt_file, tmp_path / "out.txt", "--dop", "4",
                          env={"RDFIND_FAULTS":
                               "host_pull:rank=1:times=-1:p=0.25",
                               "RDFIND_PULL_RETRIES": "5"})
    assert rc == 0, err
    assert lines == single


def test_persistent_pull_failure_names_its_rank(nt_file, tmp_path):
    """Every pull failing on rank 1 exhausts its retries: the launch fails
    naming rank 1, the rank that failed first, not a peer whose collective
    it broke."""
    rc, err, _ = _cli(nt_file, tmp_path / "out.txt", "--dop", "4",
                      env={"RDFIND_FAULTS": "host_pull:rank=1:times=-1"})
    assert rc == 1
    assert "rank 1 failed (exit 1): InjectedFault" in err


def test_wedge_fires_the_watchdog_into_a_preemption(nt_file, tmp_path):
    """wedge@pairs sleeps inside the armed collective on every rank; the
    watchdog fires after 1 s, writes its marker and turns the hang into
    Preempted: the CLI's exit 75, long before any collective timeout."""
    wd = tmp_path / "wd"
    t0 = time.monotonic()
    rc, err, _ = _cli(nt_file, tmp_path / "out.txt", "--dop", "4",
                      "--checkpoint-dir", str(tmp_path / "ck"),
                      env={"RDFIND_WATCHDOG": "1",
                           "RDFIND_COLLECTIVE_TIMEOUT_S": "1",
                           "RDFIND_WATCHDOG_DIR": str(wd),
                           "RDFIND_FAULTS": "wedge@pairs"})
    assert rc == 75, err
    assert "rdfind: preempted" in err
    marker = json.load(open(wd / "wedge-host0.json"))
    assert marker["site"] == "pairs"
    assert marker["reason"].startswith("timeout after 1.0s")
    assert time.monotonic() - t0 < 60


def test_hard_wedge_exits_75_through_the_hard_exit(nt_file, tmp_path):
    """wedge@pairs:hard blocks every rank where the watchdog's Preempted
    cannot reach it, as a wedged gloo or NCCL call does: each rank's
    watchdog exits 75 with no report after its grace, and the launcher reads
    that as a preemption, so the CLI exits 75."""
    t0 = time.monotonic()
    rc, err, _ = _cli(nt_file, tmp_path / "out.txt", "--dop", "4",
                      "--checkpoint-dir", str(tmp_path / "ck"),
                      env={"RDFIND_WATCHDOG": "1",
                           "RDFIND_COLLECTIVE_TIMEOUT_S": "1",
                           "RDFIND_WATCHDOG_GRACE_S": "1",
                           "RDFIND_WATCHDOG_DIR": str(tmp_path / "wd"),
                           "RDFIND_FAULTS": "wedge@pairs:hard"})
    assert rc == 75, err
    assert "watchdog's hard exit" in err
    assert time.monotonic() - t0 < 60


def test_supervisor_relaunches_after_a_hard_exit():
    """Exit 75 with no report is a preemption: the supervisor relaunches,
    and with no retry budget it raises Preempted (the CLI's exit 75)."""
    from rdfind_tpu_torch.runtime import faults
    got = launch.supervise(torch_rank_cases.hard_exit_first, 2,
                           args_for=lambda attempt, world: (attempt,),
                           budget=1, device="cpu")
    assert got == 1
    with pytest.raises(faults.Preempted, match="hard exit"):
        launch.supervise(torch_rank_cases.hard_exit_first, 2,
                         args_for=lambda attempt, world: (attempt,),
                         budget=0, device="cpu")


def test_failed_rank_fails_the_launch_at_once():
    """Rank 2 raises while the others wait in a collective it never joins:
    the launcher names rank 2 and returns within its grace, not at the
    collective's timeout."""
    t0 = time.monotonic()
    with pytest.raises(launch.RankFailed) as exc:
        launch.spawn(torch_rank_cases.fail_on_rank, 4, args=(2,),
                     device="cpu", timeout_s=100)
    assert exc.value.rank == 2
    assert "planted failure on rank 2" in str(exc.value)
    assert time.monotonic() - t0 < 60


def test_failed_rank_makes_the_cli_exit_non_zero(tmp_path):
    rc, err, _ = _cli(str(tmp_path / "missing.nt"), tmp_path / "out.txt",
                      "--dop", "2")
    assert rc == 1
    assert "failed (exit 1)" in err and "no input files match" in err


def test_nccl_needs_one_gpu_per_local_rank(monkeypatch):
    """No silent fallback: NCCL ranks beyond the visible GPUs raise, naming
    both counts."""
    monkeypatch.delenv(mesh.BACKEND_ENV, raising=False)
    import torch
    n_gpu = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"{n_gpu + 2} local ranks asked "
                                           f"for, {n_gpu} GPU"):
        launch.local_capacity("cuda", n_gpu + 2)


def test_fault_keys_rank_and_hard(monkeypatch):
    """rank=R fires only on global rank R; hard marks a wedge that only the
    hard exit ends, and applies to wedge sites alone."""
    from rdfind_tpu_torch.runtime import faults
    monkeypatch.setattr(faults, "_RANK", 0)
    plan = faults.FaultPlan("host_pull:rank=1:times=-1;wedge@pairs:hard")
    assert not plan.fires("host_pull")
    monkeypatch.setattr(faults, "_RANK", 1)
    assert plan.fires("host_pull") and plan.fires("host_pull")
    (spec,) = plan.fire("wedge@pairs")
    assert spec.hard and not plan.specs[0].hard
    with pytest.raises(ValueError, match="wedge@"):
        faults.FaultPlan("host_pull:hard")


@pytest.mark.parametrize("device,env,want", [
    ("cpu", None, ("gloo", False)),
    ("cuda", None, ("nccl", False)),
    ("cuda", "gloo", ("gloo", True)),
    ("cpu", "nccl", ValueError),
])
def test_transport_is_explicit(monkeypatch, device, env, want):
    if env is None:
        monkeypatch.delenv(mesh.BACKEND_ENV, raising=False)
    else:
        monkeypatch.setenv(mesh.BACKEND_ENV, env)
    if want is ValueError:
        with pytest.raises(ValueError):
            mesh.resolve_backend(device)
    else:
        assert mesh.resolve_backend(device) == want
