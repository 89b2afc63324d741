"""The rules of the port's linter rewritten for torch idioms: a firing and
a silent fixture for each, mirroring the reference's cases
(``tests/test_lint.py``) one for one in the port's idioms, and each rule
shown to bite on the port itself: a copy of a real port file, with the
line the invariant rests on removed, fires exactly that rule, and the
unmodified copy does not.  Pure AST work: nothing here touches a device.
"""

from pathlib import Path

import pytest
import torch

import kmeans_tpu_torch
from kmeans_tpu_torch.analysis import lint_paths

torch.set_num_threads(1)

PKG_DIR = Path(kmeans_tpu_torch.__file__).parent


def run_on(tmp_path, source, subdir="parallel", name="mod.py", rules=None):
    """Lint one snippet placed under ``tmp_path/<subdir>/`` (the scoped
    rules key on the ``parallel``/``ops``/``serving``/... segments)."""
    d = tmp_path / subdir
    d.mkdir(parents=True, exist_ok=True)
    f = d / name
    f.write_text(source)
    return lint_paths([f], rules=rules).findings


def fired(findings, rule):
    return [f for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# trace-hazard: the bodies a CUDA graph captures
# ---------------------------------------------------------------------------

_TRACE_BAD = """
import torch
from kmeans_tpu_torch.parallel.distributed import _Replay


class Loop(_Replay):
    def iterate(self):
        v = float(self.carry)         # host cast of a device tensor
        if self.chunk.sum() > 0:      # Python branch on a tensor
            v = v + 1
        import numpy as np
        a = np.asarray(self.carry)    # host materialization
        b = self.carry.item()         # host sync
        while v > 0:                  # Python loop in a captured body
            v -= 1
        self.carry.add_(v)

    def __init__(self, points):
        self.points = points
        self.carry = torch.zeros(())
        self.chunk = torch.ones(4)
"""

_TRACE_OK = """
import torch
from kmeans_tpu_torch.parallel.distributed import _Replay


class Loop(_Replay):
    def iterate(self):
        if self.mode == "fast":       # branch on a STATIC knob
            step = self.carry + 2.0
        else:
            step = self.carry + 1.0
        n = int(self.chunk.shape[0])  # shape cast: static at capture
        m = int(self.chunk.numel())   # element count: static too
        if self.hook is not None:     # identity test: reads no element
            step = step * 1.0
        self.carry.copy_(torch.where(self.chunk.sum() > 0, step,
                                     self.carry))

    def __init__(self, mode: str, every: int, hook=None):
        self.mode, self.every = mode, int(every)
        self.hook = hook
        self.carry = torch.zeros(())
        self.chunk = torch.ones(4)
"""


def test_trace_hazard_fires(tmp_path):
    findings = fired(run_on(tmp_path, _TRACE_BAD), "trace-hazard")
    messages = " | ".join(f.message for f in findings)
    assert "float()" in messages
    assert "branch on tensor self.chunk" in messages
    assert "np.asarray" in messages
    assert ".item()" in messages
    assert "while-loop" in messages
    assert [f.line for f in findings] == [8, 9, 12, 13, 14]


def test_trace_hazard_silent_on_static_knobs_and_shape_casts(tmp_path):
    assert fired(run_on(tmp_path, _TRACE_OK), "trace-hazard") == []


def test_trace_hazard_scoped_to_compiled_layers(tmp_path):
    """The same hazard outside parallel//ops/ is not this rule's business
    (the models' host loops read device scalars on purpose)."""
    assert fired(run_on(tmp_path, _TRACE_BAD, subdir="models"),
                 "trace-hazard") == []


def test_trace_hazard_sibling_scope_does_not_leak_params(tmp_path):
    """A nested def's params are tensors only in ITS OWN subtree: a later
    branch on a same-named static local of the outer body is silent."""
    src = """
import torch
from kmeans_tpu_torch.parallel.distributed import _Replay


class Loop(_Replay):
    def iterate(self):
        def inner(c, x):              # nested captured fn, param 'c'
            return c + x
        out = inner(self.carry, self.chunk)
        c = self.mode                 # outer 'c': a static knob
        if c == "fast":
            out = out * 2
        self.carry.copy_(out.sum())

    def __init__(self, mode: str):
        self.mode = mode
        self.carry = torch.zeros(())
        self.chunk = torch.ones(4)
"""
    assert fired(run_on(tmp_path, src), "trace-hazard") == []


def test_trace_hazard_graph_block_helpers_and_lambda(tmp_path):
    """Functions called inside ``with torch.cuda.graph(...)``, and a lambda
    written there, are captured bodies too."""
    src = """
import torch


def run(g, x0):
    def cond(state):
        return bool(state[0])         # host cast in a captured helper

    def body(state):
        return (state[0] - 1, state[1])

    with torch.cuda.graph(g):
        body(x0), cond(x0)

def run2(g, x0):
    with torch.cuda.graph(g): x0.add_((lambda c: c + float(c))(x0))
"""
    findings = fired(run_on(tmp_path, src), "trace-hazard")
    assert [f.line for f in findings] == [7, 16]


@pytest.mark.parametrize("expr,what", [
    ("self.carry.cpu()", ".cpu()"), ("self.carry.tolist()", ".tolist()"),
    ("self.carry.numpy()", ".numpy()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize()"),
    ("self.carry.nonzero()", "nonzero()"),
    ("torch.nonzero(self.carry)", "nonzero()"),
    ("np.array(self.carry)", "np.array()"),
    ("int(self.carry)", "host cast int()"),
])
def test_trace_hazard_flags_each_host_read(tmp_path, expr, what):
    src = f"""
import numpy as np
import torch
from kmeans_tpu_torch.parallel.distributed import _Replay


class Loop(_Replay):
    def iterate(self):
        x = {expr}
        self.carry.add_(1)

    def __init__(self):
        self.carry = torch.zeros(3)
"""
    findings = fired(run_on(tmp_path, src), "trace-hazard")
    assert len(findings) == 1 and findings[0].line == 9
    assert what in findings[0].message


def test_trace_hazard_follows_subclasses_helpers_and_members(tmp_path):
    """A subclass of a ``_Replay`` subclass is a device loop too; its
    ``iterate`` reaches ``self._helper()`` and a member's ``iterate``
    (the ``_EmLoop`` / ``_EmMember`` shape), which are captured with it.
    A class outside the hierarchy with an ``iterate`` is not."""
    src = """
import torch
from kmeans_tpu_torch.parallel.distributed import _Replay


class _Base(_Replay):
    pass
class _Member:
    def iterate(self, loop):
        return loop.flag.item()            # reached from the loop


class Loop(_Base):
    def iterate(self):
        for m in self.members:
            m.iterate(self)
        self._helper()

    def _helper(self):
        return self.carry.tolist()         # reached through self

    def __init__(self):
        self.carry = torch.zeros(3)
        self.members = [_Member()]


class Plain:
    def iterate(self):
        return torch.zeros(3).item()       # never captured
"""
    d = run_on(tmp_path, src)
    assert sorted(f.line for f in fired(d, "trace-hazard")) == [10, 20]


def test_trace_hazard_static_knob_versus_tensor_attribute(tmp_path):
    """How a tensor is told from a static knob: an attribute assigned from
    an unannotated parameter may be a tensor (the branch fires), one from
    a ``bool``-annotated parameter or from a host cast is a knob."""
    src = """
import torch
from kmeans_tpu_torch.parallel.distributed import _Replay


class Loop(_Replay):
    def iterate(self):
        if self.audit:
            self.carry.add_(1)
        if self.ratio > 0:
            self.carry.add_(2)
        if self.flag:
            self.carry.add_(3)

    def __init__(self, audit: bool, ratio, flag):
        self.audit, self.ratio = audit, float(ratio)
        self.flag = flag
        self.carry = torch.zeros(())
"""
    findings = fired(run_on(tmp_path, src), "trace-hazard")
    assert [f.line for f in findings] == [12]
    assert "self.flag" in findings[0].message


def test_trace_hazard_suppression_honored(tmp_path):
    src = _TRACE_BAD.replace(
        "        b = self.carry.item()         # host sync",
        "        b = self.carry.item()  # lint: ok(trace-hazard) — fixture")
    assert [f.line for f in fired(run_on(tmp_path, src), "trace-hazard")] \
        == [8, 9, 12, 14]


# ---------------------------------------------------------------------------
# cache-key: the port's keyed factories
# ---------------------------------------------------------------------------

_MEMO_BAD = """
from kmeans_tpu_torch.parallel import distributed as dist


def fit(ds, mode, step, k):
    key = ("device_loop", mode)
    return ds.memo(key, lambda: dist._DeviceLoop(ds.points, ds.weights,
                                                 step, None, k=k))
"""

_MEMO_OK = """
from kmeans_tpu_torch.parallel import distributed as dist


def fit(ds, mode, step, k):
    key = ("device_loop", mode, step, k)
    return ds.memo(key, lambda: dist._DeviceLoop(ds.points, ds.weights,
                                                 step, None, k=k))
"""


def test_cache_key_memo_fires_on_missing_knob(tmp_path):
    findings = fired(run_on(tmp_path, _MEMO_BAD), "cache-key")
    assert len(findings) == 1 and findings[0].line == 7
    assert "k, step" in findings[0].message


def test_cache_key_memo_silent_when_key_spans_knobs(tmp_path):
    """The key variable is chased to its tuple; ``ds.points`` is the
    memo owner's own state, covered by the owner's identity."""
    assert fired(run_on(tmp_path, _MEMO_OK), "cache-key") == []


def test_cache_key_engine_fn_owner_state_is_covered(tmp_path):
    """``self._fn(key, make)`` lives on the engine: ``self.mesh`` is its
    own state, but the mode it closes over must be keyed."""
    bad = """
from kmeans_tpu_torch.models.kmeans import _cached
from kmeans_tpu_torch.parallel import distributed as dist


class Engine:
    def _predict_fn(self, chunk, mode):
        return self._fn(("predict", chunk),
                        lambda: _cached(dist.make_predict_fn, self.mesh,
                                        chunk_size=chunk, mode=mode))
"""
    findings = fired(run_on(tmp_path, bad, subdir="serving"), "cache-key")
    assert len(findings) == 1 and "mode" in findings[0].message
    assert "self.mesh" not in findings[0].message
    ok = bad.replace('("predict", chunk)', '("predict", chunk, mode)')
    assert fired(run_on(tmp_path, ok, subdir="serving"), "cache-key") == []


def test_cache_key_module_cache_does_not_cover_self(tmp_path):
    """A module-level cache outlives any one object: ``self.mesh`` read by
    its factory must be in the key (the reference's rule)."""
    src = """
from kmeans_tpu_torch.utils.cache import LRUCache

_C_CACHE = LRUCache(8, name="m._C_CACHE")


class M:
    def fn(self, chunk, build):
        return _C_CACHE.get_or_create(
            (chunk, build), lambda: build(self.mesh, chunk))
"""
    findings = fired(run_on(tmp_path, src, subdir="models"), "cache-key")
    assert len(findings) == 1 and "self.mesh" in findings[0].message


@pytest.mark.parametrize("arg", ["hook=lambda c: c * 2", "hook=_local"])
def test_cache_key_builder_arguments_keyed_by_identity(tmp_path, arg):
    """``builder_key`` keys a lambda or a local function by identity: such
    an argument to ``_cached``/``cached_build`` is a finding."""
    src = f"""
from kmeans_tpu_torch.models.kmeans import _cached
from kmeans_tpu_torch.parallel import distributed as dist


def build(mesh, chunk):
    def _local(c):
        return c
    return _cached(dist.make_step_fn, mesh, chunk_size=chunk, {arg})
"""
    findings = fired(run_on(tmp_path, src, subdir="models"), "cache-key")
    assert len(findings) == 1 and "by identity" in findings[0].message
    plain = src.replace(f", {arg})", ")")
    assert fired(run_on(tmp_path, plain, subdir="models"),
                 "cache-key") == []


def test_cache_key_cached_build_is_covered_by_construction(tmp_path):
    """The blessed ``utils.cache.cached_build``: a key of
    ``builder_key(f, *a, **kw)`` with the factory ``lambda: f(*a, **kw)``
    spans the whole call; a key of part of it does not."""
    ok = """
def cached_build(cache, builder, *args, **kwargs):
    return cache.get_or_create(builder_key(builder, *args, **kwargs),
                               lambda: builder(*args, **kwargs))
"""
    assert fired(run_on(tmp_path, ok, subdir="utils"), "cache-key") == []
    bad = ok.replace("builder_key(builder, *args, **kwargs)",
                     "builder_key(builder, *args)")
    findings = fired(run_on(tmp_path, bad, subdir="utils"), "cache-key")
    assert len(findings) == 1 and "kwargs" in findings[0].message


def test_cache_key_local_def_factory_audited_through_its_body(tmp_path):
    """A factory named by a local def (the ``measure_step`` shape) is
    audited through that def's free variables."""
    src = """
def probe(ds, step_fn, k):
    def measure():
        return step_fn(ds.points, k)
    return ds.memo(("seconds", k), measure)
"""
    findings = fired(run_on(tmp_path, src, subdir="models"), "cache-key")
    assert len(findings) == 1 and "step_fn" in findings[0].message
    ok = src.replace('("seconds", k)', '("seconds", k, step_fn)')
    assert fired(run_on(tmp_path, ok, subdir="models"), "cache-key") == []


def test_cache_key_ignores_function_local_imports(tmp_path):
    src = """
def fn(ds, chunk):
    from kmeans_tpu_torch.parallel import distributed as dist
    return ds.memo(("step", chunk),
                   lambda: dist.make_step_fn(None, chunk_size=chunk))
"""
    assert fired(run_on(tmp_path, src, subdir="models"), "cache-key") == []


def test_cache_key_flags_unresolvable_key(tmp_path):
    src = """
def fn(ds, key, build):
    return ds.memo(key, lambda: build())
"""
    findings = fired(run_on(tmp_path, src, subdir="models"), "cache-key")
    assert len(findings) == 1 and "not a tuple literal" in \
        findings[0].message


# ---------------------------------------------------------------------------
# dispatch / obs-span: compiled call sites of the port
# ---------------------------------------------------------------------------

_DISPATCH_BAD = """
from kmeans_tpu_torch.models.kmeans import _cached
from kmeans_tpu_torch.parallel import distributed as dist


class Engine:
    def serve(self, ds, chunk, mode):
        fn = self._fn(("predict", chunk, mode),
                      lambda: _cached(dist.make_predict_fn, self.mesh,
                                      chunk_size=chunk, mode=mode))
        return fn(ds.points, ds.weights)
"""


def test_dispatch_fires_on_untagged_compiled_call(tmp_path):
    findings = fired(run_on(tmp_path, _DISPATCH_BAD, subdir="serving"),
                     "dispatch")
    assert len(findings) == 1 and findings[0].line == 11
    assert "serve()" in findings[0].message


@pytest.mark.parametrize("tag", ['note_dispatch("serve/predict")',
                                 '_build.count_launch("assign")',
                                 "self.dispatches += 1",
                                 "self._record(rm, 8, 1)"])
def test_dispatch_silent_when_tagged(tmp_path, tag):
    src = _DISPATCH_BAD.replace(
        "        return fn(ds.points, ds.weights)",
        f"        {tag}\n        return fn(ds.points, ds.weights)")
    assert fired(run_on(tmp_path, src, subdir="serving"), "dispatch") == []


def test_dispatch_direct_invoke_of_predict_fn(tmp_path):
    src = """
class Engine:
    def serve(self, ds, chunk, mode):
        return self._predict_fn(chunk, mode)(ds.points, ds.weights)
"""
    findings = fired(run_on(tmp_path, src, subdir="serving"), "dispatch")
    assert len(findings) == 1 and findings[0].line == 4


def test_dispatch_builders_that_only_return_are_exempt(tmp_path):
    src = """
from kmeans_tpu_torch.models.kmeans import _cached
from kmeans_tpu_torch.parallel import distributed as dist


def get_fn(mesh, chunk):
    return _cached(dist.make_predict_fn, mesh, chunk_size=chunk)
"""
    assert fired(run_on(tmp_path, src, subdir="serving"), "dispatch") == []


def test_obs_span_fires_on_unspanned_compiled_call(tmp_path):
    src = _DISPATCH_BAD.replace(
        "        return fn(ds.points, ds.weights)",
        "        note_dispatch('serve/predict')\n"
        "        return fn(ds.points, ds.weights)")
    findings = run_on(tmp_path, src, subdir="serving")
    assert [f.rule for f in findings
            if f.rule in ("dispatch", "obs-span")] == ["obs-span"]
    assert "serve()" in fired(findings, "obs-span")[0].message


def test_obs_span_silent_with_enclosing_span(tmp_path):
    src = _DISPATCH_BAD.replace(
        "        return fn(ds.points, ds.weights)",
        "        note_dispatch('serve/predict')\n"
        "        with obs_trace.span('serve.request'):\n"
        "            return fn(ds.points, ds.weights)")
    assert fired(run_on(tmp_path, src, subdir="serving"), "obs-span") == []


def test_obs_span_scoped_to_serving_and_parallel(tmp_path):
    src = _DISPATCH_BAD.replace(
        "        return fn(ds.points, ds.weights)",
        "        note_dispatch('serve/predict')\n"
        "        return fn(ds.points, ds.weights)")
    assert fired(run_on(tmp_path, src, subdir="models"), "obs-span") == []
    assert fired(run_on(tmp_path, src, subdir="parallel"), "obs-span")


def test_obs_span_nested_closure_covered_by_driver_span(tmp_path):
    """A nested helper's compiled call counts against the driver, whose
    span covers the subtree (``verify_quantized``'s ``_distances``)."""
    src = """
from kmeans_tpu_torch.models.kmeans import _cached
from kmeans_tpu_torch.obs import trace as obs_trace
from kmeans_tpu_torch.parallel import distributed as dist
from kmeans_tpu_torch.utils.profiling import note_dispatch


class Engine:
    def verify(self, ds, chunk):
        def _distances(tmode):
            fn = self._fn(("transform", chunk, tmode),
                          lambda: _cached(dist.make_transform_fn, self.mesh,
                                          chunk_size=chunk, mode=tmode))
            note_dispatch("verify/transform")
            return fn(ds.points)
        with obs_trace.span("dispatch", tag="verify"):
            return _distances("matmul") - _distances("matmul_bf16")
"""
    findings = run_on(tmp_path, src, subdir="serving")
    assert fired(findings, "obs-span") == []
    assert fired(findings, "dispatch") == []


# ---------------------------------------------------------------------------
# collective-span: host-side collectives of the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", [
    "tdist.barrier()",
    "mesh_mod.barrier(mesh)",
    "multihost.fleet_barrier('fit-start', mesh)",
    "tdist.all_gather_object(out, n_local)",
    "tdist.broadcast_object_list(out, src=0)",
    "tdist.all_reduce(host, group=_host_model_group(mesh))",
])
def test_collective_span_fires_on_uncovered_host_collective(tmp_path, call):
    src = f"""
import torch.distributed as tdist


def gather_counts(host, out, n_local, mesh):
    {call}
    return out
"""
    findings = fired(run_on(tmp_path, src), "collective-span")
    assert len(findings) == 1 and findings[0].line == 6
    assert "gather_counts()" in findings[0].message
    assert "merged timeline" in findings[0].message


def test_collective_span_silent_with_span_or_tag(tmp_path):
    spanned = """
import torch.distributed as tdist
from kmeans_tpu_torch.obs import trace as obs_trace


def gather_counts(out, n_local):
    with obs_trace.span("collective", op="all_gather_object"):
        tdist.all_gather_object(out, n_local)
    return out
"""
    assert fired(run_on(tmp_path, spanned), "collective-span") == []
    tagged = """
from kmeans_tpu_torch.parallel import mesh as mesh_mod
from kmeans_tpu_torch.utils.profiling import note_dispatch


def sync(mesh):
    note_dispatch("fleet/barrier")
    mesh_mod.barrier(mesh)
"""
    assert fired(run_on(tmp_path, tagged), "collective-span") == []


def test_collective_span_in_graph_reductions_and_the_primitive_are_out(
        tmp_path):
    """A step's ``all_reduce`` over the mesh's device group is in-graph
    work, not a host wait; and the barrier primitive itself is spanned at
    its callers (``fleet_barrier``)."""
    src = """
import torch.distributed as tdist


def all_reduce(t, mesh, axis):
    tdist.all_reduce(t, group=mesh.get_group(axis))
    return t


def barrier(mesh):
    if mesh is None:
        tdist.barrier()
"""
    assert fired(run_on(tmp_path, src), "collective-span") == []


def test_collective_span_scoped_to_parallel(tmp_path):
    src = """
import torch.distributed as tdist


def save_barrier():
    tdist.barrier()
"""
    assert fired(run_on(tmp_path, src, subdir="utils"),
                 "collective-span") == []
    assert fired(run_on(tmp_path, src, subdir="parallel"),
                 "collective-span")


# ---------------------------------------------------------------------------
# ingest-span: the port's placements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("place", [
    "torch.from_numpy(x).to(device)",
    "torch.from_numpy(x).to(device=self.device, dtype=torch.float32)",
    "torch.from_numpy(x).to('cuda:0')",
    "torch.from_numpy(x).cuda()",
    "torch.as_tensor(x, device=dev)",
    "out.copy_(pinned, non_blocking=True)",
    "out.copy_(torch.from_numpy(x))",
])
def test_ingest_span_fires_on_unspanned_placement(tmp_path, place):
    src = f"""
import torch


def place_rows(self, x, out, pinned, device, dev):
    return {place}
"""
    findings = fired(run_on(tmp_path, src, subdir="data"), "ingest-span")
    assert len(findings) == 1 and findings[0].line == 6
    assert "place_rows()" in findings[0].message
    assert "stage" in findings[0].message


@pytest.mark.parametrize("not_placed", [
    "x.to(torch.float32)", "x.to(tdtype)", "out.copy_(src)",
    "torch.as_tensor(x)", "torch.zeros(4, device=device)",
])
def test_ingest_span_ignores_what_places_no_host_bytes(tmp_path,
                                                       not_placed):
    src = f"""
import torch


def convert(x, out, src, tdtype, device):
    return {not_placed}
"""
    assert fired(run_on(tmp_path, src, subdir="data"), "ingest-span") == []


@pytest.mark.parametrize("name,ok", [("stage", True), ("place", True),
                                     ("compile", False)])
def test_ingest_span_wants_a_stage_or_place_span(tmp_path, name, ok):
    src = f"""
import torch
from kmeans_tpu_torch.obs import trace as obs_trace


def place_rows(x, device):
    with obs_trace.span("{name}", rows=x.shape[0], bytes=x.nbytes):
        return torch.from_numpy(x).to(device)
"""
    findings = fired(run_on(tmp_path, src, subdir="data"), "ingest-span")
    assert (findings == []) == ok


def test_ingest_span_scoped_to_data_and_sharding(tmp_path):
    src = """
import torch


def place_rows(x, device):
    return torch.from_numpy(x).to(device)
"""
    assert fired(run_on(tmp_path, src, subdir="models"), "ingest-span") == []
    assert fired(run_on(tmp_path, src, subdir="parallel"),
                 "ingest-span") == []
    assert fired(run_on(tmp_path, src, subdir="parallel",
                        name="sharding.py"), "ingest-span")


def test_ingest_span_nested_producer_covered_by_driver(tmp_path):
    """A producer closure's copy counts against the enclosing driver,
    whose stage span covers the subtree (``place_slabs``' ``stage``)."""
    src = """
import torch
from kmeans_tpu_torch.obs import trace as obs_trace


def stream_place(read_rows, spans, device):
    def producer(a, b):
        return torch.from_numpy(read_rows(a, b)).to(device)
    with obs_trace.span("stage", rows=len(spans), bytes=0):
        return [producer(a, b) for a, b in spans]
"""
    assert fired(run_on(tmp_path, src, subdir="data"), "ingest-span") == []


def test_ingest_span_suppression_honored(tmp_path):
    src = """
import torch


def place_rows(x, device):
    # lint: ok(ingest-span) — fixture path, spanned at the caller
    return torch.from_numpy(x).to(device)
"""
    assert fired(run_on(tmp_path, src, subdir="data"), "ingest-span") == []


# ---------------------------------------------------------------------------
# aot-key: the store of built kernel libraries
# ---------------------------------------------------------------------------

_STORE_BAD = """
from kmeans_tpu_torch.utils.aot import artifact_key


class AOTStore:
    def store(self, name, defines, library):
        return self.put({"library": name, "defines": defines}, library)

    def fetch(self, name, defines, dest):
        fields = artifact_key(name, defines)
        return self.put(fields, dest, missing_only=True)
"""


def test_aot_key_fires_on_the_stores_own_hand_rolled_write(tmp_path):
    findings = fired(run_on(tmp_path, _STORE_BAD, subdir="utils"),
                     "aot-key")
    assert [f.line for f in findings] == [7]
    assert "artifact_key" in findings[0].message


def test_aot_key_silent_on_blessed_constructor(tmp_path):
    ok = _STORE_BAD.replace('{"library": name, "defines": defines}',
                            "artifact_key(name, defines)")
    assert fired(run_on(tmp_path, ok, subdir="utils"), "aot-key") == []
    chased = """
from kmeans_tpu_torch.utils.aot import artifact_key, active_store


def persist(library, name, defines):
    store = active_store()
    fields = artifact_key(name, defines)
    store.put(fields, library)
"""
    assert fired(run_on(tmp_path, chased, subdir="utils"), "aot-key") == []


def test_aot_key_ignores_non_store_puts(tmp_path):
    src = """
import queue


class Prefetcher:
    def push(self, q: queue.Queue, item):
        q.put({"raw": item})
        self.put(item)

    def put(self, item):
        return item
"""
    assert fired(run_on(tmp_path, src, subdir="utils"), "aot-key") == []


# ---------------------------------------------------------------------------
# large-k: builders passed through the port's caches
# ---------------------------------------------------------------------------

_LARGE_K_BAD = """
from kmeans_tpu_torch.models.kmeans import _cached
from kmeans_tpu_torch.parallel import distributed as dist


class Estimator:
    def fit(self, ds, chunk):
        step = _cached(dist.make_step_fn, ds.mesh, chunk_size=chunk)
        return step(ds.points, ds.weights)
"""


def test_large_k_fires_on_builder_passed_to_the_cache(tmp_path):
    findings = fired(run_on(tmp_path, _LARGE_K_BAD, subdir="models"),
                     "large-k")
    assert len(findings) == 1 and findings[0].line == 8
    assert "Estimator" in findings[0].message
    assert "make_step_fn" in findings[0].message


@pytest.mark.parametrize("builder", ["make_predict_fn", "make_fit_fn",
                                     "make_transform_fn",
                                     "make_score_rows_fn"])
def test_large_k_fires_on_direct_builder_calls(tmp_path, builder):
    src = f"""
from kmeans_tpu_torch.parallel import distributed as dist


class Server:
    def predict(self, mesh, chunk):
        return dist.{builder}(mesh, chunk_size=chunk)
"""
    assert len(fired(run_on(tmp_path, src, subdir="serving"),
                     "large-k")) == 1


@pytest.mark.parametrize("guard", [
    "self.plan_ = plan_fit('kmeans', ds.n, ds.d, self.k, chunk=chunk)",
    "room = dense_room(ds.n, ds.d, self.k)",
    "assert self.assign != 'two_level'",
    "assert self.k_shard == 1",
])
def test_large_k_silent_on_planner_or_dispatch_guard(tmp_path, guard):
    src = _LARGE_K_BAD.replace(
        "        step = _cached(",
        f"        {guard}\n        step = _cached(")
    assert fired(run_on(tmp_path, src, subdir="models"), "large-k") == []


def test_large_k_exempts_module_level_builders(tmp_path):
    src = """
from kmeans_tpu_torch.models.kmeans import _cached
from kmeans_tpu_torch.parallel import distributed as dist


def bench_fit(mesh, chunk):
    return _cached(dist.make_fit_fn, mesh, chunk_size=chunk, max_iter=3,
                   tolerance=0.0)
"""
    assert fired(run_on(tmp_path, src, subdir="models"), "large-k") == []


# ---------------------------------------------------------------------------
# fault-path: the port's fault types
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exc", [
    "torch.cuda.OutOfMemoryError", "torch.OutOfMemoryError",
    "subprocess.TimeoutExpired", "faults.SimulatedUpdateFailure",
    "CheckpointCorruptError", "LaunchError", "(ValueError, OSError)",
])
def test_fault_path_fires_on_swallowed_port_fault(tmp_path, exc):
    src = f"""
def supervise(worker):
    try:
        worker.step()
    except {exc}:
        pass                       # swallowed fault: never routed
"""
    findings = fired(run_on(tmp_path, src, subdir="orchestrator"),
                     "fault-path")
    assert len(findings) == 1 and findings[0].line == 5


@pytest.mark.parametrize("body", [
    "raise",
    "return policy.EXIT_PREEMPTED",
    "policy.record_retry(e)",
    "delay = policy.backoff_delay_s(attempt)",
])
def test_fault_path_silent_when_routed(tmp_path, body):
    src = f"""
import torch


def supervise(worker, policy, attempt):
    try:
        worker.step()
    except torch.cuda.OutOfMemoryError as e:
        {body}
"""
    assert fired(run_on(tmp_path, src, subdir="parallel"),
                 "fault-path") == []


def test_fault_path_ignores_types_the_port_does_not_raise(tmp_path):
    """``XlaRuntimeError`` is the JAX runtime's: no fault of the port."""
    src = """
def supervise(worker):
    try:
        worker.step()
    except XlaRuntimeError:
        pass
"""
    assert fired(run_on(tmp_path, src, subdir="orchestrator"),
                 "fault-path") == []


def test_fault_path_scoped_to_supervised_tree(tmp_path):
    src = """
import torch


def probe(worker):
    try:
        worker.step()
    except torch.cuda.OutOfMemoryError:
        pass
"""
    for scope, n in (("serving", 0), ("models", 0), ("parallel", 1),
                     ("orchestrator", 1)):
        assert len(fired(run_on(tmp_path, src, subdir=scope),
                         "fault-path")) == n, scope


# ---------------------------------------------------------------------------
# each rule bites on the port itself
# ---------------------------------------------------------------------------

#: (rule, the port file, text to replace, its replacement): each mutation
#: removes the line the rule's invariant rests on at a real site.
MUTATIONS = [
    ("cache-name", "models/kmeans.py",
     '_STEP_CACHE = LRUCache(64, name="kmeans._STEP_CACHE")',
     "_STEP_CACHE = LRUCache(64)"),
    ("ingest-span", "parallel/sharding.py",
     'with _obs_trace.span("stage", **attrs):',
     'with _obs_trace.span("copy", **attrs):'),
    ("ingest-span", "data/io.py",
     'with _obs_trace.span("stage", rows=block, bytes=int(rows.nbytes),',
     'with _obs_trace.span("io", rows=block, bytes=int(rows.nbytes),'),
    ("trace-hazard", "parallel/distributed.py",
     "        active = self.running.clone()\n"
     "        st = self.step(self.points, self.weights, self.cents, "
     "self.x2w)\n",
     "        active = self.running.clone()\n"
     "        st = self.step(self.points, self.weights, self.cents, "
     "self.x2w); self.it.item()\n"),
    ("trace-hazard", "parallel/gmm_step.py",
     "        self.running.copy_((self.it < self.stop) & ~self.conv & "
     "self.ok)\n",
     "        self.running.copy_((self.it < self.stop) & ~self.conv & "
     "self.ok)\n        if self.ok:\n            pass\n"),
    ("cache-key", "serving/engine.py",
     'return self._fn(("predict", chunk, mode),',
     'return self._fn(("predict", chunk),'),
    ("dispatch", "serving/engine.py",
     'note_dispatch("bf16-guard-fix")', 'pass'),
    ("obs-span", "serving/engine.py",
     'with obs_trace.span("dispatch", tag="serve/bf16-',
     'with obs_trace.event("dispatch", tag="serve/bf16-'),
    ("collective-span", "parallel/distributed.py",
     'with _obs_trace.span("collective", op="all_reduce",',
     'with _obs_trace.event("collective", op="all_reduce",'),
    ("aot-key", "utils/aot.py",
     "return self.put(artifact_key(name, defines), library,",
     "return self.put({'library': name}, library,"),
    ("large-k", "models/bisecting.py",
     "step_fn = self._step_fn(ds.mesh, chunk, need_sse=False,",
     "step_fn = _cached(dist.make_step_fn, ds.mesh, chunk, need_sse=False,"),
    ("fault-path", "orchestrator/launcher.py",
     '        raise LaunchError(\n'
     '            f"launch of worker {index}/{world} failed on attempt "\n'
     '            f"{attempt}: {e}") from e\n',
     '        print(\n'
     '            f"launch of worker {index}/{world} failed on attempt "\n'
     '            f"{attempt}: {e}")\n'),
    ("atomic-swap", "serving/learn.py",
     "    def poke(self) -> None:\n",
     "    def swap_inline(self, cents) -> None:\n"
     "        self.model.centroids = cents\n\n"
     "    def poke(self) -> None:\n"),
    ("thread", "serving/learn.py",
     "            # lint: ok(thread) — joined at close(): the handle "
     "is kept\n",
     "            # joined at close(): the handle is kept\n"),
]


def _copy_of(tmp_path, rel, text):
    f = tmp_path / "kmeans_tpu_torch" / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(text)
    return f


@pytest.mark.parametrize("rule,rel,old,new", MUTATIONS,
                         ids=[f"{m[0]}:{m[1]}" for m in MUTATIONS])
def test_rule_bites_on_a_mutated_port_file(tmp_path, rule, rel, old, new):
    text = (PKG_DIR / rel).read_text()
    assert text.count(old) >= 1, (rel, old)
    clean = lint_paths([_copy_of(tmp_path / "a", rel, text)]).findings
    dirty = lint_paths([_copy_of(tmp_path / "b", rel,
                                 text.replace(old, new))]).findings
    assert [f for f in clean if f.rule == rule] == []
    before = {(f.rule, f.message) for f in clean}
    added = [f for f in dirty if (f.rule, f.message) not in before]
    assert [f.rule for f in added] == [rule], [f.format() for f in added]
