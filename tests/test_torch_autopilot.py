"""The port's elastic autopilot (``kmeans_tpu_torch/orchestrator``) on the
CPU, case by case the JAX package's ``tests/test_autopilot.py``: the policy
units (the committed constants, the backoff schedule, the exit-code
classes, ``select_resume`` over real rotated and torn checkpoint files),
the fault hooks, the launcher's backoff, and the supervising loop driven
against real ``kmeans_tpu_torch.orchestrator.worker`` subprocesses
(``"device": "cpu"``): a host killed mid-fit and resumed, bit-equal to the
uninterrupted float64 fit; a silent host evicted and the fleet shrunk; a
torn primary and both rotations torn; launch flakes and an exhausted
launch budget; growth back to the target world; and the CLI's exit codes
0, 1 and 2.  The committed constants and ``select_resume`` are held
against the JAX package's.  Every supervised run has a deadline
(``max_run_s``) past which the autopilot kills its workers.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import torch

torch.set_num_threads(1)

from kmeans_tpu.orchestrator import policy as jax_policy  # noqa: E402
from kmeans_tpu.parallel.multihost import (  # noqa: E402
    simulated_world_env as jax_world_env)
from kmeans_tpu_torch import KMeans  # noqa: E402
from kmeans_tpu_torch.cli import autopilot_main  # noqa: E402
from kmeans_tpu_torch.obs import REGISTRY  # noqa: E402
from kmeans_tpu_torch.orchestrator import (  # noqa: E402
    AutopilotGaveUpError, launcher, policy, run_autopilot)
from kmeans_tpu_torch.orchestrator.worker import _load_data  # noqa: E402
from kmeans_tpu_torch.parallel.multihost import (  # noqa: E402
    simulated_world_env)
from kmeans_tpu_torch.utils import faults  # noqa: E402
from kmeans_tpu_torch.utils.checkpoint import (  # noqa: E402
    save_state_rotating)

BASE_SPEC = {
    "k": 3, "max_iter": 6, "tolerance": 1e-30, "seed": 7,
    "dtype": "float64", "checkpoint_every": 1,
    "synthetic": {"n": 600, "d": 4, "kind": "blobs", "seed": 3},
    "devices_per_host": 1, "empty_cluster": "keep", "device": "cpu",
}

#: The deadline of every supervised run here, seconds (the committed
#: ``policy.MAX_RUN_S`` is 600).
MAX_RUN_S = 120.0


def write_spec(dirpath, **overrides):
    spec = dict(BASE_SPEC)
    spec.update(overrides)
    p = Path(dirpath) / "spec.json"
    p.write_text(json.dumps(spec))
    return p, spec


def actions(decisions):
    return [d["action"] for d in decisions]


def oracle_centroids(spec):
    """The uninterrupted float64 fit of the spec in this process, which the
    supervised runs must match bit for bit."""
    X = _load_data(spec, np)
    km = KMeans(k=spec["k"], max_iter=spec["max_iter"],
                tolerance=spec["tolerance"], seed=spec["seed"],
                compute_sse=True, empty_cluster=spec["empty_cluster"],
                dtype=np.float64, host_loop=True, compute_labels=False,
                verbose=False, device="cpu").fit(X)
    return np.asarray(km.centroids)


def _run(spec_path, out, world, **kw):
    """``run_autopilot`` with this file's deadline."""
    kw.setdefault("max_run_s", MAX_RUN_S)
    return run_autopilot(spec_path, out, world, **kw)


# ---------------------------------------------------------------------------
# Policy units
# ---------------------------------------------------------------------------

def test_backoff_schedule_deterministic_and_capped():
    delays = [policy.backoff_delay_s(a) for a in range(8)]
    assert delays[:3] == [0.05, 0.1, 0.2]
    assert delays == sorted(delays)
    assert max(delays) == policy.LAUNCH_BACKOFF_MAX_S
    # Deterministic: same attempt, same delay — no jitter.
    assert policy.backoff_delay_s(2) == policy.backoff_delay_s(2)


def test_backoff_negative_attempt_raises():
    with pytest.raises(ValueError):
        policy.backoff_delay_s(-1)


def test_classify_exit_contract():
    assert policy.classify_exit(policy.EXIT_DONE) == "done"
    assert policy.classify_exit(policy.EXIT_PREEMPTED) == "preempted"
    assert policy.classify_exit(policy.EXIT_CKPT_CORRUPT) \
        == "checkpoint-corrupt"
    assert policy.classify_exit(1) == "crashed"
    assert policy.classify_exit(-9) == "crashed"


def test_evict_and_grow_thresholds():
    assert not policy.should_evict(policy.STALL_CONSECUTIVE_POLLS - 1)
    assert policy.should_evict(policy.STALL_CONSECUTIVE_POLLS)
    assert not policy.should_grow(2, 2, policy.GROW_HOLDOFF_POLLS)
    assert not policy.should_grow(1, 2, policy.GROW_HOLDOFF_POLLS - 1)
    assert policy.should_grow(1, 2, policy.GROW_HOLDOFF_POLLS)


def test_decision_as_dict_merges_detail():
    d = policy.Decision(seq=3, t_s=1.23456, action="evict",
                        reason="r", world_before=2, world_after=1,
                        detail={"index": 1})
    got = d.as_dict()
    assert got["seq"] == 3 and got["action"] == "evict"
    assert got["world_before"] == 2 and got["world_after"] == 1
    assert got["index"] == 1
    assert got["t_s"] == 1.235


def test_gave_up_error_carries_full_decision_log():
    ds = [policy.Decision(seq=i, t_s=float(i), action=a, reason="r",
                          world_before=1, world_after=1, detail={})
          for i, a in enumerate(["launch", "relaunch", "give-up"])]
    err = policy.AutopilotGaveUpError("budget exhausted", ds)
    assert err.decisions == ds
    rep = err.report()
    for a in ("launch", "relaunch", "give-up"):
        assert a in rep
    assert "budget exhausted" in str(err)


def test_committed_constants_are_the_jax_packages():
    names = [n for n in jax_policy.__all__ if n.isupper()]
    assert names == [n for n in policy.__all__ if n.isupper()]
    for name in names:
        assert getattr(policy, name) == getattr(jax_policy, name), name
    for attempt in range(8):
        assert policy.backoff_delay_s(attempt) == \
            jax_policy.backoff_delay_s(attempt)
    for rc in (0, 1, -9, 75, 77):
        assert policy.classify_exit(rc) == jax_policy.classify_exit(rc)


def _state(iteration):
    return {"model_class": "KMeans", "k": 3,
            "iterations_run": iteration,
            "centroids": np.zeros((3, 2))}


def test_select_resume_picks_newest_over_the_fleet(tmp_path):
    for idx, iters in [(0, 3), (1, 5), (2, 4)]:
        save_state_rotating(policy.checkpoint_path(tmp_path, idx),
                            _state(iters))
    path, info = policy.select_resume(tmp_path, [0, 1, 2])
    assert path == policy.checkpoint_path(tmp_path, 1)
    assert info["iteration"] == 5 and info["source"] == "primary"
    assert info["torn"] == []


def test_select_resume_prev_fallback_on_torn_primary(tmp_path):
    ck = policy.checkpoint_path(tmp_path, 0)
    save_state_rotating(ck, _state(2))
    save_state_rotating(ck, _state(3))        # iter 2 rotates to .prev
    ck.write_bytes(b"torn")                   # tear the primary
    path, info = policy.select_resume(tmp_path, [0])
    assert path == ck                          # fallback loader route
    assert info["source"] == "prev" and info["iteration"] == 2


def test_select_resume_all_torn_reports_torn(tmp_path):
    ck = policy.checkpoint_path(tmp_path, 0)
    save_state_rotating(ck, _state(1))
    save_state_rotating(ck, _state(2))
    ck.write_bytes(b"torn")
    (tmp_path / f"{ck.name}.prev").write_bytes(b"torn too")
    path, info = policy.select_resume(tmp_path, [0])
    assert path is None
    assert info["torn"] == [str(ck)]


def test_select_resume_nothing_yet(tmp_path):
    path, info = policy.select_resume(tmp_path, [0, 1])
    assert path is None and info["torn"] == []


@pytest.mark.parametrize("scenario", ["newest", "prev", "all_torn"])
def test_select_resume_matches_the_jax_package(tmp_path, scenario):
    """The same checkpoint files (the port writes the JAX package's
    format) give the same resume source in both packages."""
    if scenario == "newest":
        for idx, iters in [(0, 3), (1, 5), (2, 4)]:
            save_state_rotating(policy.checkpoint_path(tmp_path, idx),
                                _state(iters))
    else:
        ck = policy.checkpoint_path(tmp_path, 0)
        save_state_rotating(ck, _state(2))
        save_state_rotating(ck, _state(3))
        ck.write_bytes(b"torn")
        if scenario == "all_torn":
            (tmp_path / f"{ck.name}.prev").write_bytes(b"torn too")
    got = policy.select_resume(tmp_path, [0, 1, 2])
    want = jax_policy.select_resume(tmp_path, [0, 1, 2])
    assert got == want


def test_spec_with_several_devices_per_host_is_refused(tmp_path, capsys):
    """One process per rank in the port: ``devices_per_host`` other than 1
    is refused before anything launches (exit 2 from the CLI)."""
    spec_path, _ = write_spec(tmp_path, devices_per_host=2)
    rc = autopilot_main(["--spec", str(spec_path),
                         "--out", str(tmp_path / "run"), "--world", "1"])
    assert rc == 2
    assert "devices_per_host=2" in capsys.readouterr().err
    assert not (tmp_path / "run").exists()


# ---------------------------------------------------------------------------
# Fault hooks
# ---------------------------------------------------------------------------

def test_inject_host_kill_targets_one_index(monkeypatch):
    monkeypatch.setattr(faults, "identity",
                        lambda: {"process_index": 1, "process_count": 2,
                                 "host": "h"})
    with faults.inject_host_kill(0, after_iteration=2) as rec:
        faults.on_checkpoint(5, "ckpt")      # wrong index: no fire
        assert rec["fired_at"] is None
    with faults.inject_host_kill(1, after_iteration=3) as rec:
        faults.on_checkpoint(2, "ckpt")      # too early: no fire
        assert rec["fired_at"] is None
        with pytest.raises(faults.SimulatedPreemption):
            faults.on_checkpoint(3, "ckpt")
        assert rec["fired_at"] == 3
        faults.on_checkpoint(4, "ckpt")      # one-shot: no refire
    faults.on_checkpoint(9, "ckpt")          # removed on exit


def test_inject_launch_failures_counts_then_releases():
    with faults.inject_launch_failures(2) as rec:
        for attempt in range(2):
            with pytest.raises(faults.SimulatedLaunchFailure):
                faults.on_launch(0, attempt)
        faults.on_launch(0, 2)               # budget spent: clean
        assert rec["fired"] == 2
        assert rec["attempts"] == [(0, 0), (0, 1), (0, 2)]
    faults.on_launch(0, 0)                   # removed on exit


def test_simulated_world_env_contract():
    env = simulated_world_env(1, 4)
    assert env == {"KMEANS_TPU_PROCESS_INDEX": "1",
                   "KMEANS_TPU_PROCESS_COUNT": "4",
                   "KMEANS_TPU_HOST": "sim1"}
    assert simulated_world_env(0, 2, host="h")["KMEANS_TPU_HOST"] == "h"
    assert simulated_world_env(1, 4) == jax_world_env(1, 4)
    with pytest.raises(ValueError):
        simulated_world_env(4, 4)
    with pytest.raises(ValueError):
        simulated_world_env(-1, 2)


# ---------------------------------------------------------------------------
# Launcher backoff (no real worker ever spawns: every attempt flakes)
# ---------------------------------------------------------------------------

def test_launch_backoff_exhausts_budget_deterministically(tmp_path):
    spec, _ = write_spec(tmp_path)
    slept = []
    with faults.inject_launch_failures(99) as rec:
        with pytest.raises(launcher.LaunchError):
            launcher.launch_with_backoff(spec, 0, 1, tmp_path,
                                         sleep=slept.append)
    assert len(rec["attempts"]) == policy.LAUNCH_RETRY_BUDGET
    assert slept == [policy.backoff_delay_s(a)
                     for a in range(policy.LAUNCH_RETRY_BUDGET - 1)]


def test_launch_backoff_recovers_after_flakes(tmp_path):
    spec, _ = write_spec(tmp_path)
    slept = []
    with faults.inject_launch_failures(2):
        h = launcher.launch_with_backoff(spec, 0, 1, tmp_path,
                                         sleep=slept.append)
    try:
        assert h.index == 0 and h.launch_attempts == 3
        assert slept == [0.05, 0.1]
    finally:
        h.terminate()


# ---------------------------------------------------------------------------
# Chaos matrix: real subprocess workers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kill_resume_run(tmp_path_factory):
    """World=2, host 1 preempted mid-fit (after iteration 2), with the
    supervised resume — plus the uninterrupted oracle."""
    root = tmp_path_factory.mktemp("ap_kill")
    spec_path, spec = write_spec(
        root, faults={"kill": {"process_index": 1, "after_iteration": 2,
                               "tear": "none"}})
    result = _run(spec_path, root / "run", 2,
                           poll_period_s=0.1)
    return result, root / "run", spec


def test_kill_resume_converges_with_relaunch(kill_resume_run):
    result, out, _ = kill_resume_run
    assert result.outcome == "converged" and result.exit_code == 0
    assert result.final_world == 2
    acts = actions(result.decisions)
    assert acts.count("launch") == 2
    assert "relaunch" in acts and acts[-1] == "done"
    relaunch = [d for d in result.decisions
                if d["action"] == "relaunch"][0]
    assert relaunch["kind"] == "preempted"
    assert relaunch["exit_code"] == policy.EXIT_PREEMPTED
    assert relaunch["resume"]                 # resumed, not restarted
    # The preemption really happened: the latch is on disk.
    assert (out / "fault.kill.p1.latch").exists()


def test_kill_resume_centroids_bitexact_vs_oracle(kill_resume_run):
    result, out, spec = kill_resume_run
    assert result.centroids_agree
    oracle = oracle_centroids(spec)
    for i in range(2):
        got = np.load(out / f"centroids.p{i}.npy")
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, oracle)


def test_kill_resume_decision_log_is_complete_jsonl(kill_resume_run):
    result, out, _ = kill_resume_run
    logged = [json.loads(l) for l in
              (out / "autopilot.decisions.jsonl").read_text()
              .splitlines()]
    assert logged == result.decisions
    assert [d["seq"] for d in logged] == list(range(len(logged)))
    # Every decision also landed in the metrics registry.
    for a in set(actions(logged)):
        assert REGISTRY.counter(f"autopilot.{a}").value >= 1


def test_kill_resume_emits_decision_trace_events(kill_resume_run):
    _, out, _ = kill_resume_run
    recs = [json.loads(l) for l in
            (out / "autopilot.trace.jsonl").read_text().splitlines()]
    decisions = [r for r in recs if r.get("kind") == "event"
                 and r.get("name") == "autopilot.decision"]
    assert decisions                    # every decision is an r15 event
    spans = {r["name"] for r in recs if r.get("kind") == "span"}
    assert any(n.startswith("autopilot.") for n in spans), spans


@pytest.fixture(scope="module")
def evict_shrink_run(tmp_path_factory):
    """World=2, host 1 goes silent mid-fit (600 s checkpoint stall):
    the loop must evict it and finish degraded on the shrunk fleet."""
    root = tmp_path_factory.mktemp("ap_slow")
    spec_path, spec = write_spec(
        root, faults={"slow": {"process_index": 1, "after_iteration": 2,
                               "seconds": 600.0}})
    result = _run(spec_path, root / "run", 2, grow=False)
    return result, root / "run", spec


def test_straggler_evicted_fleet_shrinks_and_finishes(evict_shrink_run):
    result, out, _ = evict_shrink_run
    assert result.outcome == "degraded" and result.exit_code == 1
    assert result.final_world == 1
    acts = actions(result.decisions)
    assert "evict" in acts and "shrink" in acts
    evict = [d for d in result.decisions if d["action"] == "evict"][0]
    assert evict["index"] == 1
    assert evict["streak"] >= policy.STALL_CONSECUTIVE_POLLS
    shrink = [d for d in result.decisions if d["action"] == "shrink"][0]
    assert (shrink["world_before"], shrink["world_after"]) == (2, 1)


def test_evict_overhead_is_bounded(evict_shrink_run):
    """Wall-clock bound: the evict fires within the stall window plus
    a handful of polls, and the shrunk relaunch follows immediately —
    the loop never sits on a stalled fleet."""
    result, _, _ = evict_shrink_run
    by_action = {d["action"]: d for d in result.decisions}
    evict_t = by_action["evict"]["t_s"]
    # worker warmup (jax import) + stall window (>= 1 s) + 2 polls
    # + slack; a loop that waited for MAX_RUN_S would blow this.
    assert evict_t < 60.0
    relaunch_after = [d for d in result.decisions
                      if d["action"] == "relaunch"
                      and d["t_s"] >= evict_t]
    assert relaunch_after
    assert relaunch_after[0]["t_s"] - evict_t < 10.0


def test_shrunk_fleet_result_matches_oracle(evict_shrink_run):
    result, out, spec = evict_shrink_run
    assert result.centroids_agree
    np.testing.assert_array_equal(np.load(out / "centroids.p0.npy"),
                                  oracle_centroids(spec))


def test_torn_primary_resumes_from_prev(tmp_path):
    """Preemption that also tore the primary checkpoint: the relaunch
    classifies the tear and resumes from the .prev last-good rotation
    (decision ``resume-fallback-prev``), still bit-exact."""
    spec_path, spec = write_spec(
        tmp_path, faults={"kill": {"process_index": 0,
                                   "after_iteration": 2,
                                   "tear": "primary"}})
    result = _run(spec_path, tmp_path / "run", 1,
                           poll_period_s=0.1)
    acts = actions(result.decisions)
    assert result.exit_code == 0
    assert "resume-fallback-prev" in acts
    np.testing.assert_array_equal(
        np.load(tmp_path / "run" / "centroids.p0.npy"),
        oracle_centroids(spec))


def test_torn_both_rotations_gives_up_typed(tmp_path):
    """BOTH rotations torn: no silent fresh restart — the worker exits
    checkpoint-corrupt, the loop retries under RELAUNCH_BUDGET, then
    raises the typed give-up carrying the complete decision log."""
    spec_path, _ = write_spec(
        tmp_path, faults={"kill": {"process_index": 0,
                                   "after_iteration": 2,
                                   "tear": "both"}})
    with pytest.raises(AutopilotGaveUpError) as exc:
        _run(spec_path, tmp_path / "run", 1,
                      poll_period_s=0.1)
    err = exc.value
    acts = [d.action for d in err.decisions]
    assert acts[-1] == "give-up"
    assert "resume-torn" in acts
    assert acts.count("relaunch") == policy.RELAUNCH_BUDGET
    assert "budget" in err.reason
    # The flushed JSONL log survives the raise, complete.
    logged = [json.loads(l) for l in
              (tmp_path / "run" / "autopilot.decisions.jsonl")
              .read_text().splitlines()]
    assert [d["action"] for d in logged] == acts


def test_launch_flake_backoff_decisions(tmp_path):
    """Two injected launch flakes: the supervised launch retries under
    the deterministic schedule and records each backoff as a typed
    decision before converging."""
    spec_path, _ = write_spec(tmp_path)
    with faults.inject_launch_failures(2):
        result = _run(spec_path, tmp_path / "run", 1,
                               poll_period_s=0.1)
    assert result.exit_code == 0
    backoffs = [d for d in result.decisions
                if d["action"] == "launch-backoff"]
    assert [(b["attempt"], b["delay_s"]) for b in backoffs] \
        == [(0, 0.05), (1, 0.1)]


def test_launch_budget_exhaustion_gives_up(tmp_path):
    spec_path, _ = write_spec(tmp_path)
    with faults.inject_launch_failures(99):
        with pytest.raises(AutopilotGaveUpError) as exc:
            _run(spec_path, tmp_path / "run", 1)
    acts = [d.action for d in exc.value.decisions]
    assert acts == ["launch-backoff"] * (policy.LAUNCH_RETRY_BUDGET - 1) \
        + ["give-up"]


def test_grow_back_to_target_world(tmp_path):
    """Capacity-return path: a fleet started below its target world
    grows back after GROW_HOLDOFF_POLLS healthy polls and converges at
    the target."""
    spec_path, _ = write_spec(tmp_path, max_iter=8)
    result = _run(spec_path, tmp_path / "run", 1,
                           target_world=2, poll_period_s=0.05)
    assert result.outcome == "converged" and result.final_world == 2
    acts = actions(result.decisions)
    assert "grow" in acts
    grow = [d for d in result.decisions if d["action"] == "grow"][0]
    assert (grow["world_before"], grow["world_after"]) == (1, 2)
    assert result.centroids_agree


def test_capacity_fn_gates_growth(tmp_path):
    """``capacity_fn`` returning False pins a short fleet short: no
    grow decision, degraded outcome."""
    spec_path, _ = write_spec(tmp_path)
    result = _run(spec_path, tmp_path / "run", 1,
                           target_world=2, poll_period_s=0.05,
                           capacity_fn=lambda: False)
    assert result.outcome == "degraded" and result.exit_code == 1
    assert "grow" not in actions(result.decisions)


# ---------------------------------------------------------------------------
# CLI contract
# ---------------------------------------------------------------------------

def test_cli_json_converged_run(tmp_path, capsys):
    spec_path, _ = write_spec(tmp_path)
    rc = autopilot_main(["--spec", str(spec_path),
                         "--out", str(tmp_path / "run"),
                         "--world", "1", "--poll-period", "0.1",
                         "--max-run-s", str(MAX_RUN_S), "--json"])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["outcome"] == "converged"
    assert payload["exit_code"] == 0
    assert payload["final_world"] == 1
    assert payload["centroids_agree"] is True
    assert payload["decisions"][-1]["action"] == "done"


def test_cli_degraded_exits_one(tmp_path, capsys):
    """A fleet that finishes below its target world (growth off) is done
    but degraded: exit 1."""
    spec_path, spec = write_spec(tmp_path)
    rc = autopilot_main(["--spec", str(spec_path),
                         "--out", str(tmp_path / "run"),
                         "--world", "1", "--target-world", "2",
                         "--no-grow", "--poll-period", "0.1",
                         "--max-run-s", str(MAX_RUN_S), "--json"])
    assert rc == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["outcome"] == "degraded" and payload["exit_code"] == 1
    assert payload["final_world"] == 1
    np.testing.assert_array_equal(
        np.load(tmp_path / "run" / "centroids.p0.npy"),
        oracle_centroids(spec))


def test_cli_gave_up_exits_two_with_report(tmp_path, capsys):
    spec_path, _ = write_spec(tmp_path)
    with faults.inject_launch_failures(99):
        rc = autopilot_main(["--spec", str(spec_path),
                             "--out", str(tmp_path / "run"),
                             "--world", "1", "--max-run-s", str(MAX_RUN_S),
                             "--json"])
    assert rc == 2
    captured = capsys.readouterr()
    payload = json.loads(captured.out)
    assert payload["outcome"] == "gave-up" and payload["exit_code"] == 2
    assert payload["decisions"][-1]["action"] == "give-up"
    assert "give-up" in captured.err          # human report on stderr


def test_cli_bad_spec_exits_two(tmp_path, capsys):
    rc = autopilot_main(["--spec", str(tmp_path / "missing.json"),
                         "--out", str(tmp_path / "run"),
                         "--world", "1"])
    assert rc == 2
    assert "error:" in capsys.readouterr().err


def test_main_module_routes_autopilot(tmp_path, monkeypatch, capsys):
    import kmeans_tpu_torch.__main__ as main_mod
    monkeypatch.setattr("sys.argv",
                        ["kmeans_tpu_torch", "autopilot", "--spec",
                         str(tmp_path / "missing.json"), "--out",
                         str(tmp_path / "o"), "--world", "1"])
    assert main_mod.main() == 2
