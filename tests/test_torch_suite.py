"""The port's suite, ``python -m kmeans_tpu_torch.suite``: the original
project's tests A to E over a mesh of gloo ranks on the CPU, its real exit
code, and test A's float64 NumPy oracle against scikit-learn (which the
suite itself never imports)."""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from kmeans_tpu_torch import suite  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The suite on two gloo ranks, in a session of its own: on expiry the
    whole session (the suite and its spawned ranks) is killed."""
    out = tmp_path_factory.mktemp("suite")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kmeans_tpu_torch.suite", "--device", "cpu",
         "--world", "2", "--out-dir", str(out)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("the suite on two ranks did not end within 300 s")
    return subprocess.CompletedProcess(proc.args, proc.returncode, stdout,
                                       stderr), out


def test_two_gloo_ranks_exit_0(two_ranks):
    proc, _ = two_ranks
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "ranks: 2, backend: gloo" in proc.stdout


@pytest.mark.parametrize("name", list("ABCDE"))
def test_every_test_passes(two_ranks, name):
    out = two_ranks[0].stdout
    assert f"TEST {name}: PASSED" in out and f"✓ TEST {name} PASSED" in out


def test_only_rank_0_prints(two_ranks):
    out = two_ranks[0].stdout
    assert out.count("ALL TESTS COMPLETED") == 1
    assert out.count("TEST A: CORRECTNESS") == 1


def test_e_sweeps_the_ranks_and_writes_the_svg(two_ranks):
    proc, out = two_ranks
    assert "shard counts: [1, 2]" in proc.stdout
    svg = (out / "speedup_graph.svg").read_text()
    assert svg.startswith("<svg") and svg.rstrip().endswith("</svg>")
    for text in ("Speedup vs Number of Shards", "Number of Shards",
                 "Speedup", "Ideal", "Actual"):
        assert text in svg
    assert svg.count("<circle") == 2 and svg.count('fill="orange"') == 2


@pytest.mark.parametrize("n,centers,d,seed", [(1000, 3, 2, 42),
                                              (600, 5, 4, 3),
                                              (2000, 8, 6, 11)])
def test_a_oracle_equals_sklearn_with_the_shared_init(n, centers, d, seed):
    from sklearn.cluster import KMeans as SklearnKMeans
    from kmeans_tpu_torch.data.synthetic import make_blobs
    X, _ = make_blobs(n, centers, d, random_state=seed, dtype=np.float64)
    init = X[np.random.RandomState(seed).choice(n, centers, replace=False)]
    ref = SklearnKMeans(n_clusters=centers, init=init, n_init=1,
                        max_iter=300, tol=0.0, algorithm="lloyd").fit(X)
    np.testing.assert_allclose(suite.lloyd_oracle(X, init),
                               ref.cluster_centers_, rtol=0, atol=1e-10)


def test_a_failing_test_exits_1(monkeypatch, tmp_path):
    monkeypatch.setattr(suite, "test_c_convergence",
                        lambda mesh, device: suite._result("TEST C", False))
    assert suite.main(["--device", "cpu", "--world", "1", "--only", "c,d",
                       "--out-dir", str(tmp_path)]) == 1
    assert not torch.distributed.is_initialized()


def test_one_rank_in_this_process_exits_0(tmp_path, capsys):
    assert suite.main(["--device", "cpu", "--only", "a,e",
                       "--out-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "one card" in out and "TEST E: PASSED" in out
    assert (tmp_path / "speedup_graph.svg").is_file()
    assert not torch.distributed.is_initialized()


def test_without_a_card_the_device_must_be_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(SystemExit) as e:
        suite.main([])
    assert e.value.code == 2


def test_make_gaussian_is_the_reference_one():
    from kmeans_tpu.data.synthetic import make_gaussian as jx_gaussian
    from kmeans_tpu_torch.data.synthetic import make_gaussian
    np.testing.assert_array_equal(make_gaussian(500, 7, random_state=4),
                                  jx_gaussian(500, 7, random_state=4))
