"""The port's serving fleet (``kmeans_tpu_torch.serving.fleet``) against the
JAX package's ``serving/fleet.py`` on the CPU.

* Labels bit-equal to the model's own ``predict`` and to a single engine
  on every path (direct, queued, packed, the guarded bf16 route), equal to
  the JAX fleet's for the same (converted) model; ``score`` bit-equal to a
  single engine's.
* Routing: both fleets on injected clocks of their own, advanced by a
  per-replica service time inside each dispatch, choose the same replica
  for every request, cold (power-of-two choices) and warm (least expected
  latency), for direct calls and for queued requests in flight.
* Admission: the same sheds and the same ``FleetOverloadError`` messages
  (in-flight limit, p99 bound); nothing vanishes.
* Lifecycle: a killed replica fails no request; ``reap`` of a stalled
  replica; no traffic before ``warmup``; ``add_replica`` prewarms.
* Placement: pack-group co-residency under partial replication and the
  fallback of ``predict_multi``, as the JAX fleet places them.
* Constructor messages are the JAX package's.

Fleets run with ``start=False`` except the kill case, which needs the
queue workers and joins every result with a timeout.
"""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs

torch.set_num_threads(1)

import kmeans_tpu  # noqa: E402
from kmeans_tpu.obs import metrics_registry as jax_metrics  # noqa: E402
from kmeans_tpu.serving import FleetOverloadError as JaxOverload  # noqa: E402
from kmeans_tpu.serving import ReplicaDeadError as JaxDead  # noqa: E402
from kmeans_tpu.serving import ServingEngine as JaxEngine  # noqa: E402
from kmeans_tpu.serving import ServingFleet as JaxFleet  # noqa: E402
from kmeans_tpu.serving import fleet as jax_fleet  # noqa: E402
import kmeans_tpu_torch as kt  # noqa: E402
from kmeans_tpu_torch import convert  # noqa: E402
from kmeans_tpu_torch.obs import metrics_registry as pt_metrics  # noqa: E402
from kmeans_tpu_torch.serving import (FleetOverloadError,  # noqa: E402
                                      ReplicaDeadError, ServingEngine,
                                      ServingFleet)
from kmeans_tpu_torch.serving import fleet as pt_fleet  # noqa: E402
from kmeans_tpu_torch.serving.batching import bucket_for  # noqa: E402
from kmeans_tpu_torch.utils.faults import inject_replica_kill  # noqa: E402

TIMEOUT = 60.0
#: Per-replica service time (ms) that a dispatch adds to its fleet's
#: injected clock: the latencies the router learns.
SERVICE_MS = {"r0": 3.0, "r1": 1.0, "r2": 2.0}


@pytest.fixture(autouse=True)
def _fresh_metrics():
    """Histograms and counters are process-wide and replica names repeat
    across fleets: a stale registry would warm a new fleet's router."""
    pt_metrics.REGISTRY.reset()
    jax_metrics.REGISTRY.reset()
    yield
    pt_metrics.REGISTRY.reset()
    jax_metrics.REGISTRY.reset()


@pytest.fixture(scope="module")
def data():
    X, _ = make_blobs(n_samples=3000, centers=6, n_features=8,
                      random_state=3)
    return X.astype(np.float32)


def _pair(data, mesh1, seed=0, k=5, dtype=np.float32, rows=3000):
    """A JAX KMeans and its conversion into the port."""
    jm = kmeans_tpu.KMeans(k=k, seed=seed, max_iter=25, dtype=dtype,
                           verbose=False, mesh=mesh1).fit(
                               data[:rows].astype(dtype))
    pm = convert.from_jax_state(jm._state_dict(), device="cpu")
    jm.mesh = None
    return jm, pm


@pytest.fixture(scope="module")
def models(data, mesh1):
    return _pair(data, mesh1), _pair(data, mesh1, seed=11)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _fleet(n=2, **kw):
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("quality", False)
    return ServingFleet(n, device="cpu", **kw)


def _jax_fleet(mesh1, n=2, **kw):
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("quality", False)
    return JaxFleet(n, mesh=mesh1, **kw)


def _flush(fleet):
    for rep in fleet._replicas:
        rep.engine.queue.service(now=float("inf"))


# ----------------------------------------------------------- parity


def test_fleet_labels_bitequal_every_path(data, models, mesh1):
    """Direct, queued and packed dispatches: labels bit-equal to the
    model's own predict and to the JAX fleet's; the mixed batch of two
    same-shape models is one packed dispatch; routes counted."""
    (jm, pm), (jm2, pm2) = models
    with _fleet(3, start=False) as fleet, \
            _jax_fleet(mesh1, 3, start=False) as jfleet:
        assert sorted(fleet.add_model("a", pm)) == ["r0", "r1", "r2"]
        fleet.add_model("b", pm2)
        jfleet.add_model("a", jm)
        jfleet.add_model("b", jm2)
        fleet.warmup()
        jfleet.warmup()
        for m_rows in (1, 7, 64, 300):
            probe = data[:m_rows]
            want = pm.predict(probe)
            np.testing.assert_array_equal(fleet.call("a", probe), want)
            np.testing.assert_array_equal(jfleet.call("a", probe), want)
            fut = fleet.submit("a", probe)
            _flush(fleet)
            np.testing.assert_array_equal(fut.result(timeout=TIMEOUT), want)
        reqs = [("a", data[:50]), ("b", data[50:90])]
        outs, jouts = fleet.predict_multi(reqs), jfleet.predict_multi(reqs)
        np.testing.assert_array_equal(outs[0], pm.predict(data[:50]))
        np.testing.assert_array_equal(outs[1], pm2.predict(data[50:90]))
        for a, b in zip(outs, jouts):
            np.testing.assert_array_equal(a, b)
        assert sum(r.engine.packed_dispatches
                   for r in fleet._replicas) == 1
        st, jst = fleet.stats(), jfleet.stats()
        assert set(st) == set(jst)
        assert set(st["replicas"]["r0"]) == set(jst["replicas"]["r0"])
        for key in ("sheds", "redispatches", "n_replicas", "n_serving",
                    "placement", "pack_groups", "buckets"):
            assert st[key] == jst[key], key
        # Four direct calls, four queued requests, one routed pair.
        assert st["routes"] == 8 + 2
        assert st["models"]["a"]["requests"] == 8 + 1
        assert pt_metrics.REGISTRY.counter("fleet.route").value \
            == st["routes"]


def test_fleet_bf16_guarded_path_matches_engine(data, models, mesh1):
    """The guarded bf16 route through the fleet: labels bit-equal to a
    single bf16 engine's, to the float32 predict and to the JAX fleet's."""
    (jm, pm), _ = models
    probe = data[:200]
    with ServingEngine(device="cpu", start=False, quality=False) as eng:
        eng.add_model("m", pm, quantize="bf16")
        want = eng.predict("m", probe)
    with _fleet(2, start=False) as fleet, \
            _jax_fleet(mesh1, 2, start=False) as jfleet:
        fleet.add_model("m", pm, quantize="bf16")
        jfleet.add_model("m", jm, quantize="bf16")
        fleet.warmup()
        jfleet.warmup()
        np.testing.assert_array_equal(fleet.call("m", probe), want)
        np.testing.assert_array_equal(jfleet.call("m", probe), want)
        np.testing.assert_array_equal(want, pm.predict(probe))


def test_score_routes_and_matches(data, mesh1):
    """Fleet score is a single engine's, bit for bit (the same padded
    bucket), and the JAX fleet's to the float64 parity class."""
    jm, pm = _pair(data, mesh1, dtype=np.float64)
    with ServingEngine(device="cpu", start=False, quality=False) as eng:
        eng.add_model("m", pm)
        want = eng.score("m", data[:100])
    with _fleet(2, start=False) as fleet, \
            _jax_fleet(mesh1, 2, start=False) as jfleet:
        fleet.add_model("m", pm)
        jfleet.add_model("m", jm)
        fleet.warmup()
        jfleet.warmup()
        assert fleet.score("m", data[:100]) == want
        np.testing.assert_allclose(jfleet.score("m", data[:100]), want,
                                   rtol=1e-12)
        assert fleet.stats()["routes"] == 1


# ------------------------------------------------------------ routing


def _traced(fleet, clock):
    """Arm every replica to record the replica of each dispatch and to
    advance the fleet's clock by its service time."""
    route = []

    def hook(rep, model_id, op):
        route.append(rep.name)
        clock.advance(SERVICE_MS[rep.name] / 1e3)

    for rep in fleet._replicas:
        rep.fault_hook = hook
    return route


def _drive_routes(fleet, clock, data):
    """Cold then warm direct calls, then queued requests in flight; the
    replica of every request."""
    route = _traced(fleet, clock)
    for i in range(40):
        fleet.call("m", data[i:i + 1])
    futs = [fleet.submit("m", data[i:i + 1]) for i in range(12)]
    queued = [f._rep.name for f in futs]
    _flush(fleet)
    for f in futs:
        f.result(timeout=TIMEOUT)
    after = [f._rep.name for f in futs]
    return route[:40], queued, after


def test_routing_chooses_the_jax_fleets_replicas(data, models, mesh1):
    """Both fleets on their own injected clocks, each dispatch advancing
    the clock by its replica's service time: the same replica for every
    request while the histograms are cold (power-of-two choices off the
    rotating counter), once they are warm (least expected latency, the
    fast replica), and for queued requests whose in-flight counts grow
    ((inflight + 1) * p50 spreads them)."""
    (jm, pm), _ = models
    clock, jclock = FakeClock(), FakeClock()
    with _fleet(3, start=False, clock=clock) as fleet, \
            _jax_fleet(mesh1, 3, start=False, clock=jclock) as jfleet:
        fleet.add_model("m", pm)
        jfleet.add_model("m", jm)
        fleet.warmup(prewarm=False)
        jfleet.warmup(prewarm=False)
        got = _drive_routes(fleet, clock, data)
        want = _drive_routes(jfleet, jclock, data)
    assert got == want
    direct, queued, _ = got
    n = pt_fleet.MIN_ROUTE_SAMPLES
    assert direct[:3] == ["r0", "r1", "r2"]              # cold rotation
    assert set(direct[:3 * n]) == {"r0", "r1", "r2"}
    assert direct[-5:] == ["r1"] * 5                     # warm: fastest
    assert len(set(queued)) > 1                          # load spreads
    assert pt_fleet.MIN_ROUTE_SAMPLES == jax_fleet.MIN_ROUTE_SAMPLES
    assert pt_fleet.ROUTE_REFRESH == jax_fleet.ROUTE_REFRESH
    assert pt_fleet.DEAD_AFTER_FACTOR == jax_fleet.DEAD_AFTER_FACTOR
    assert pt_fleet.DEAD_MIN_S == jax_fleet.DEAD_MIN_S


# -------------------------------------------- admission & shedding


def test_max_inflight_burst_sheds_as_the_jax_fleet(data, models, mesh1):
    """A burst past capacity sheds exactly offered - capacity requests in
    both fleets, with the same message; sheds are counted; every admitted
    request completes bit-exact."""
    (jm, pm), _ = models
    offered, per_rep = 9, 2

    def burst(fleet, overload):
        futs, shed, msgs = [], 0, set()
        for i in range(offered):
            try:
                futs.append(fleet.submit("m", data[i:i + 1]))
            except overload as e:
                shed += 1
                msgs.add(str(e))
        return futs, shed, msgs

    with _fleet(2, start=False, max_inflight=per_rep) as fleet, \
            _jax_fleet(mesh1, 2, start=False,
                       max_inflight=per_rep) as jfleet:
        for f, mdl in ((fleet, pm), (jfleet, jm)):
            f.add_model("m", mdl)
            f.warmup(prewarm=False)
        futs, shed, msgs = burst(fleet, FleetOverloadError)
        jfuts, jshed, jmsgs = burst(jfleet, JaxOverload)
        assert len(futs) == len(jfuts) == 2 * per_rep
        assert shed == jshed == offered - 2 * per_rep
        assert msgs == jmsgs and len(msgs) == 1
        assert [f._rep.name for f in futs] == [f._rep.name for f in jfuts]
        st = fleet.stats()
        assert st["sheds"] == shed
        assert pt_metrics.REGISTRY.counter("fleet.shed").value == shed
        assert pt_metrics.REGISTRY.counter("fleet.shed.m").value == shed
        fleet.close()
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=TIMEOUT),
                                          pm.predict(data[i:i + 1]))


def test_slo_bound_sheds_when_every_replica_breaches(data, models, mesh1):
    """Cold candidates admit; once every candidate's histogram is warm
    and the expected completion breaches the bound, the request sheds
    with the JAX fleet's message."""
    (jm, pm), _ = models
    errors = []
    for make, mdl, overload in ((lambda: _fleet(2, slo_p99_ms=1.0,
                                                start=False), pm,
                                 FleetOverloadError),
                                (lambda: _jax_fleet(mesh1, 2,
                                                    slo_p99_ms=1.0,
                                                    start=False), jm,
                                 JaxOverload)):
        with make() as fleet:
            fleet.add_model("m", mdl)
            fleet.warmup()
            np.testing.assert_array_equal(fleet.call("m", data[:1]),
                                          pm.predict(data[:1]))
            b = bucket_for(1, fleet.buckets)
            for rep in fleet._replicas:
                h = fleet._hist(rep, "m", b)
                for _ in range(pt_fleet.MIN_ROUTE_SAMPLES):
                    h.observe(50.0)
            with pytest.raises(overload, match="p99 bound") as e:
                fleet.call("m", data[:1])
            errors.append(str(e.value))
            assert fleet.stats()["sheds"] == 1
    assert errors[0] == errors[1]
    assert pt_metrics.REGISTRY.counter("fleet.shed").value == 1


# ------------------------------------------------- chaos / lifecycle


def test_kill_a_replica_zero_failed_requests(data, models):
    """Kill the replica of the first dispatch with queued work in flight:
    every request completes bit-exact, the dead replica's requests
    re-dispatch on the survivor, routing never touches it again."""
    (_, pm), _ = models
    with _fleet(2) as fleet:
        fleet.add_model("m", pm)
        fleet.warmup()
        with inject_replica_kill(fleet, after_dispatches=0) as rec:
            futs = [fleet.submit("m", data[i:i + 1]) for i in range(24)]
            outs = [f.result(timeout=TIMEOUT) for f in futs]
        assert rec["killed"] and rec["replica"] in ("r0", "r1")
        for i, out in enumerate(outs):
            np.testing.assert_array_equal(out, pm.predict(data[i:i + 1]))
        st = fleet.stats()
        assert st["n_serving"] == 1
        assert st["replicas"][rec["replica"]]["state"] == "dead"
        assert st["redispatches"] >= 1
        assert pt_metrics.REGISTRY.counter("fleet.redispatch").value \
            == st["redispatches"]
        np.testing.assert_array_equal(fleet.call("m", data[:3]),
                                      pm.predict(data[:3]))


def test_all_replicas_dead_is_loud(data, models, mesh1):
    (jm, pm), _ = models
    msgs = []
    for fleet, mdl, dead in ((_fleet(1, start=False), pm, ReplicaDeadError),
                             (_jax_fleet(mesh1, 1, start=False), jm,
                              JaxDead)):
        with fleet:
            fleet.add_model("m", mdl)
            fleet.warmup()
            fleet.kill_replica("r0")
            with pytest.raises(dead, match="no serving replica") as e:
                fleet.call("m", data[:2])
            msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_no_traffic_before_warmup(data, models, mesh1):
    """A replica takes traffic only once serving: a call before
    ``warmup()`` fails naming the fix, as in the JAX fleet."""
    (jm, pm), _ = models
    msgs = []
    for fleet, mdl, dead in ((_fleet(2, start=False), pm, ReplicaDeadError),
                             (_jax_fleet(mesh1, 2, start=False), jm,
                              JaxDead)):
        with fleet:
            fleet.add_model("m", mdl)
            with pytest.raises(dead, match="warmup") as e:
                fleet.call("m", data[:2])
            msgs.append(str(e.value))
            fleet.warmup()
            np.testing.assert_array_equal(fleet.call("m", data[:2]),
                                          pm.predict(data[:2]))
    assert msgs[0] == msgs[1]


def test_add_replica_prewarms_before_serving(data, models):
    (_, pm), _ = models
    with _fleet(1, start=False) as fleet:
        fleet.add_model("m", pm)
        fleet.warmup()
        name = fleet.add_replica()
        st = fleet.stats()
        assert st["replicas"][name]["state"] == "serving"
        assert st["replicas"][name]["prewarm_s"] is not None
        assert st["placement"]["m"] == ["r0", name]
        assert fleet._replica(name).engine.stats()["dispatches"] == 0
        np.testing.assert_array_equal(fleet.call("m", data[:5]),
                                      pm.predict(data[:5]))


def test_reap_stalled_replica_with_inflight_work(data, models):
    """In-flight work and no completed dispatch past the stall window:
    dead; an idle replica never reaps."""
    (_, pm), _ = models
    clock = FakeClock()
    with _fleet(2, heartbeat_interval_s=0.1, clock=clock,
                start=False) as fleet:
        fleet.add_model("m", pm)
        fleet.warmup()
        rep = fleet._replicas[0]
        assert fleet.reap(now=clock() + 1e4) == []
        rep.inflight = 1
        rep.last_beat = clock()
        assert fleet.reap(now=rep.last_beat + 0.5) == []
        clock.advance(1e4)
        assert fleet.reap() == ["r0"]
        assert rep.state == "dead"
        assert fleet.stats()["n_serving"] == 1


# -------------------------------------------------------- placement


def test_pack_group_coresidency_under_partial_replication(data, models,
                                                          mesh1):
    """``replication=1`` on three replicas: same-(k, D, dtype) models
    co-reside, an unrelated model lands on the least-loaded replica, as
    the JAX fleet places them; ``predict_multi`` stays one packed
    dispatch."""
    (jm, pm), (jm2, pm2) = models
    jo, po = _pair(data, mesh1, seed=2, k=3, rows=500)
    with _fleet(3, replication=1, start=False) as fleet, \
            _jax_fleet(mesh1, 3, replication=1, start=False) as jfleet:
        for f, (a, b, c) in ((fleet, (pm, pm2, po)),
                             (jfleet, (jm, jm2, jo))):
            f.add_model("a", a)
            f.add_model("b", b)
            f.add_model("c", c)
        st, jst = fleet.stats(), jfleet.stats()
        assert st["placement"] == jst["placement"]
        assert st["pack_groups"] == jst["pack_groups"]
        assert st["placement"]["a"] == st["placement"]["b"]
        assert len(st["placement"]["a"]) == 1
        assert st["placement"]["c"] != st["placement"]["a"]
        fleet.warmup()
        outs = fleet.predict_multi([("a", data[:40]), ("b", data[40:70])])
        np.testing.assert_array_equal(outs[0], pm.predict(data[:40]))
        np.testing.assert_array_equal(outs[1], pm2.predict(data[40:70]))
        assert sum(r.engine.packed_dispatches
                   for r in fleet._replicas) == 1


def test_predict_multi_falls_back_when_no_coresident_replica(data, models,
                                                             mesh1):
    """Models sharing no replica answer through per-request routed calls
    (correct, unpacked)."""
    (_, pm), _ = models
    _, po = _pair(data, mesh1, seed=2, k=3, rows=500)
    with _fleet(2, replication=1, start=False) as fleet:
        fleet.add_model("a", pm)
        fleet.add_model("c", po)
        st = fleet.stats()
        assert st["placement"]["a"] != st["placement"]["c"]
        fleet.warmup()
        outs = fleet.predict_multi([("a", data[:30]), ("c", data[30:60])])
        np.testing.assert_array_equal(outs[0], pm.predict(data[:30]))
        np.testing.assert_array_equal(outs[1], po.predict(data[30:60]))
        assert sum(r.engine.packed_dispatches
                   for r in fleet._replicas) == 0
        assert fleet.stats()["routes"] == 2


def test_fleet_dir_holds_quality_and_heartbeat_sinks(data, models,
                                                     tmp_path):
    """One ``fleet_dir`` holds each replica's quality sink and heartbeat
    sink; ``quality_status`` has every replica of every model."""
    (_, pm), _ = models
    fdir = tmp_path / "fleet"
    with _fleet(2, quality=True, fleet_dir=str(fdir),
                start=False) as fleet:
        fleet.add_model("m", pm)
        fleet.warmup()
        fleet.call("m", data[:64])
        assert set(fleet.quality_status()["m"]) == {"r0", "r1"}
        assert fleet.update_status() == {"m": {"r0": None, "r1": None}}
    names = sorted(p.name for p in fdir.iterdir())
    assert "hb.r0.jsonl" in names and "hb.r1.jsonl" in names
    assert any(n.startswith("quality.m.r") for n in names)


@pytest.mark.parametrize("kw", [dict(n_replicas=0),
                                dict(n_replicas=2, replication=0)],
                         ids=["n_replicas", "replication"])
def test_fleet_ctor_validation(mesh1, kw):
    n = kw.pop("n_replicas")
    with pytest.raises(ValueError) as want:
        JaxFleet(n, mesh=mesh1, **kw)
    with pytest.raises(ValueError) as got:
        ServingFleet(n, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_default_device_is_the_card(data):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingFleet(1)
