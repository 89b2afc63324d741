"""Deterministic fault injection for the fault-tolerance layer.

Counterpart of ``kmeans_tpu/utils/faults.py`` (stdlib and NumPy only, so the
port keeps its own copy): the same registries, error classes and messages,
so that an armed sequence raises at the same calls in both packages.  The
fits of this package call :func:`on_checkpoint` after each rotating
checkpoint write and :func:`on_segment_dispatch` before each device-loop
segment; the serve-and-learn learner (``serving.learn``) calls
:func:`on_update_step` and :func:`on_update_eval`, and a fleet replica's
``dispatch_guard`` calls the hook :func:`inject_replica_kill` arms
(``serving.fleet._Replica.fault_hook``), and the orchestrator's launcher
(``orchestrator.launcher.launch_worker``) calls :func:`on_launch` before
every worker spawn.

Every recovery claim in this repo is *proved* by re-running the real code
path under an injected, seeded failure — never by mocking the code under
test.  This module is the one place those injections live:

* :class:`TransientIOError` — the canonical retryable error.  The retry
  machinery (``data.io.retry_call`` and ``data.io.resilient_blocks``)
  treats any ``OSError`` as transient; tests raise this subclass so a retried
  failure is distinguishable from a real environment error.
* :class:`SimulatedPreemption` — what an injected "kill" raises.  It
  deliberately does NOT subclass ``OSError``: a preemption must never be
  swallowed by an IO retry loop.
* ``fail_first_attempts(fn, k)`` — wrap any callable (a shard
  ``read_rows``, a segment dispatch) so its first ``k`` invocations
  raise; deterministic, counted.
* ``flaky_blocks(make_blocks, ...)`` — a block stream whose Nth block
  read fails the first K times it is attempted (across epochs AND
  across retry replays), then succeeds forever.
* ``poison_blocks(make_blocks, ...)`` — NaN-poison one block of every
  epoch, exercising the ``on_nonfinite`` quarantine policy.
* ``inject_kill_after_iteration(j)`` — arm the checkpoint-boundary
  hook: the fit engines call :func:`on_checkpoint` immediately AFTER
  each rotating checkpoint write, and the armed hook raises
  :class:`SimulatedPreemption` once the boundary iteration reaches
  ``j`` — the deterministic stand-in for a preemption landing
  between segments.
* ``inject_oom_on_segment(j)`` — arm the segment-dispatch hook: the
  device-loop fit engines call :func:`on_segment_dispatch` immediately
  before dispatching each segment, and the armed hook raises
  :class:`SimulatedOOM` (message-compatible with the reference's
  ``RESOURCE_EXHAUSTED`` classification) the first ``times`` times
  segment ``j`` is attempted — proving the OOM chunk-backoff recovery
  through the real dispatch loop, not a mock.
* ``inject_replica_kill(fleet, replica)`` — arm a serving-fleet chaos
  kill: the replica's pre-dispatch fault hook counts
  dispatches and kills the replica after ``after_dispatches`` — the
  in-flight request fails through the engine's dispatch guard and the
  micro-batch queue's per-member isolation, and the fleet router must
  re-dispatch it on a survivor with ZERO failed requests.
* ``inject_host_kill(process_index, after_iteration=)`` — the fleet
  variant of ``inject_kill_after_iteration``: same
  checkpoint-boundary registry, but the armed hook fires ONLY on the
  process whose ``obs.identity`` index (the ``torch.distributed``
  rank, 0 without a process group) matches ``process_index`` — so every worker of an autopilot fleet can arm the
  same shared fault spec and exactly one host dies.
* ``inject_launch_failures(n)`` — arm the launch-attempt hook: the
  orchestrator's launcher calls :func:`on_launch` immediately before
  every worker spawn, and the armed hook raises
  :class:`SimulatedLaunchFailure` for the first ``n`` attempts — the
  deterministic stand-in for a flaky scheduler/allocator, driving the
  autopilot's bounded exponential launch backoff through the real
  spawn path.
* ``inject_update_failure(...)`` — arm the serve-and-learn update-step
  hook: the learner calls :func:`on_update_step` right
  before each ``partial_fit`` batch of an in-place online update, and
  the armed hook raises :class:`SimulatedUpdateFailure` — proving
  through the real update path that a failed update NEVER touches the
  serving model (the clone dies, the engine keeps serving last-good).
* ``inject_quality_regression(...)`` — arm the post-update evaluation
  hook: the learner calls :func:`on_update_eval` with the
  measured post/pre score ratio when it judges an applied update, and
  the armed hook overrides the ratio past the committed regression
  threshold — driving the snapshot-restore rollback through the real
  evaluation/restore/swap path, no mocks.

All state is explicit (closures / context managers); nothing here is
active unless a test arms it, and the hooks cost one empty-list check
per checkpoint in production.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterable, List, Optional

import numpy as np

from kmeans_tpu_torch.obs.identity import identity

__all__ = [
    "TransientIOError", "SimulatedPreemption", "SimulatedOOM",
    "SimulatedLaunchFailure", "SimulatedUpdateFailure",
    "on_checkpoint", "on_segment_dispatch", "on_launch",
    "on_update_step", "on_update_eval",
    "inject_kill_after_iteration", "inject_oom_on_segment",
    "inject_checkpoint_delay", "inject_replica_kill",
    "inject_host_kill", "inject_launch_failures",
    "inject_update_failure", "inject_quality_regression",
    "fail_first_attempts", "flaky_blocks", "poison_blocks",
]


class TransientIOError(IOError):
    """A retryable (injected) IO failure — an ``OSError`` subclass, so
    the production retry machinery handles it exactly like a real flaky
    read."""


class SimulatedPreemption(RuntimeError):
    """Injected kill at a checkpoint boundary.  NOT an ``OSError``:
    preemptions must propagate out of the fit, never be retried."""


class SimulatedLaunchFailure(RuntimeError):
    """Injected worker-launch failure.  NOT an ``OSError``
    either: the launcher classifies it through its own typed retry
    policy (bounded deterministic exponential backoff), never through
    an IO retry loop."""


class SimulatedUpdateFailure(RuntimeError):
    """Injected failure inside a serve-and-learn in-place update
   .  NOT an ``OSError``: an update failure is classified by
    the learner's own typed policy (record the failed attempt, keep the
    serving model on last-good), never by an IO retry loop."""


class SimulatedOOM(RuntimeError):
    """Injected device out-of-memory at a segment dispatch.  A
    ``RuntimeError`` whose message carries the ``RESOURCE_EXHAUSTED`` tag
    — the classification surface the backoff
    (``models.fault_tolerance.is_oom_error``) matches, in this package and
    in the JAX package alike, so the injected failure takes the detection
    path of a real one (``torch.cuda.OutOfMemoryError`` here)."""

    def __init__(self, segment: int, chunk: int):
        self.segment = segment
        self.chunk = chunk
        super().__init__(
            f"RESOURCE_EXHAUSTED: injected device OOM dispatching "
            f"segment {segment} at chunk {chunk}")


# --------------------------------------------------------------- hooks

# Checkpoint-boundary hook registry.  The fit engines call
# ``on_checkpoint(iteration, path)`` right after every successful
# rotating checkpoint write (segment boundary on the device loops,
# every-N iteration on the host loops, epoch boundary on the streamed
# fits).  Hooks are (callable, lock-free append/remove) — production
# pays one truthiness check.
_CHECKPOINT_HOOKS: List[Callable[[int, object], None]] = []
_HOOK_LOCK = threading.Lock()


def on_checkpoint(iteration: int, path) -> None:
    """Fire the checkpoint-boundary hooks (called by the fit engines
    AFTER the checkpoint for ``iteration`` completed iterations is
    durably on disk — so a hook that kills the process models a
    preemption whose last checkpoint is valid)."""
    if _CHECKPOINT_HOOKS:
        for hook in list(_CHECKPOINT_HOOKS):
            hook(iteration, path)


@contextlib.contextmanager
def inject_kill_after_iteration(j: int):
    """Arm a one-shot kill: the FIRST checkpoint boundary whose
    completed-iteration count is >= ``j`` raises
    :class:`SimulatedPreemption`.  One-shot so the resumed fit (same
    process, hook still armed would otherwise re-kill) runs to
    completion; re-enter the context to kill again.  Yields a dict with
    the observed kill iteration (``fired_at``, None if never fired)."""
    record = {"fired_at": None}

    def hook(iteration: int, path) -> None:
        if record["fired_at"] is None and iteration >= j:
            record["fired_at"] = iteration
            raise SimulatedPreemption(
                f"injected preemption after iteration {iteration} "
                f"(armed at {j}); last checkpoint: {path}")

    with _HOOK_LOCK:
        _CHECKPOINT_HOOKS.append(hook)
    try:
        yield record
    finally:
        with _HOOK_LOCK:
            if hook in _CHECKPOINT_HOOKS:
                _CHECKPOINT_HOOKS.remove(hook)


@contextlib.contextmanager
def inject_checkpoint_delay(seconds: float, *, after_iteration: int = 0):
    """Arm a deterministic SLOW-HOST injection: every
    checkpoint boundary whose completed-iteration count is
    >= ``after_iteration`` sleeps ``seconds`` before returning to the
    fit loop — the stand-in for a host whose per-iteration work is
    slower than the fleet's (page-cache misses, a noisy neighbor, a
    failing NIC).  Run a fit with ``checkpoint_every=1`` and the delay
    stretches every iteration on THIS process only, so merged
    heartbeats show the lagging boundary cadence and rows/s skew the
    straggler report must flag.  Yields a record dict with ``fired``
    (boundary count delayed)."""
    import time

    record = {"fired": 0}

    def hook(iteration: int, path) -> None:
        if iteration >= after_iteration:
            record["fired"] += 1
            time.sleep(seconds)

    with _HOOK_LOCK:
        _CHECKPOINT_HOOKS.append(hook)
    try:
        yield record
    finally:
        with _HOOK_LOCK:
            if hook in _CHECKPOINT_HOOKS:
                _CHECKPOINT_HOOKS.remove(hook)


@contextlib.contextmanager
def inject_host_kill(process_index: int, *, after_iteration: int = 0):
    """Arm a one-shot, HOST-TARGETED kill: the first
    checkpoint boundary whose completed-iteration count is
    >= ``after_iteration`` raises :class:`SimulatedPreemption` — but
    only on the process whose ``obs.identity`` index (its environment
    override, else the ``torch.distributed`` rank, 0 without a process
    group) equals ``process_index``.  Every worker
    of a fleet can therefore arm the SAME shared fault spec and exactly
    one host dies, mid-segment, with
    its last rotating checkpoint durably on disk (the hook registry
    fires after the write).  Yields a record dict with ``fired_at``
    (the kill iteration on the targeted host; None elsewhere/never)."""
    record = {"fired_at": None}

    def hook(iteration: int, path) -> None:
        if record["fired_at"] is None and iteration >= after_iteration \
                and identity()["process_index"] == process_index:
            record["fired_at"] = iteration
            raise SimulatedPreemption(
                f"injected host kill on process {process_index} after "
                f"iteration {iteration} (armed at {after_iteration}); "
                f"last checkpoint: {path}")

    with _HOOK_LOCK:
        _CHECKPOINT_HOOKS.append(hook)
    try:
        yield record
    finally:
        with _HOOK_LOCK:
            if hook in _CHECKPOINT_HOOKS:
                _CHECKPOINT_HOOKS.remove(hook)


# Launch-attempt hook registry: the orchestrator's launcher
# calls ``on_launch(process_index, attempt)`` immediately BEFORE every
# worker spawn (inside its typed backoff try block, so an injected
# failure takes exactly the retry path a real scheduler flake would).
_LAUNCH_HOOKS: List[Callable[[int, int], None]] = []


def on_launch(process_index: int, attempt: int) -> None:
    """Fire the launch-attempt hooks (called by the orchestrator's
    launcher right before spawning worker ``process_index``, on its
    ``attempt``-th try).  Production cost: one truthiness check."""
    if _LAUNCH_HOOKS:
        for hook in list(_LAUNCH_HOOKS):
            hook(process_index, attempt)


@contextlib.contextmanager
def inject_launch_failures(n: int):
    """Arm a deterministic launch flake: the first ``n`` launch
    attempts (counted fleet-wide, across workers and retries) raise
    :class:`SimulatedLaunchFailure`, then every later attempt passes.
    With ``n < launch retry budget`` the autopilot's bounded
    exponential backoff recovers; with ``n >=`` budget it must raise
    its typed give-up error.  Yields a record dict with ``fired``
    (failures raised) and ``attempts`` ((process_index, attempt) pairs
    seen)."""
    record = {"fired": 0, "attempts": []}

    def hook(process_index: int, attempt: int) -> None:
        record["attempts"].append((process_index, attempt))
        if record["fired"] < n:
            record["fired"] += 1
            raise SimulatedLaunchFailure(
                f"injected launch failure {record['fired']}/{n} "
                f"(worker {process_index}, attempt {attempt})")

    with _HOOK_LOCK:
        _LAUNCH_HOOKS.append(hook)
    try:
        yield record
    finally:
        with _HOOK_LOCK:
            if hook in _LAUNCH_HOOKS:
                _LAUNCH_HOOKS.remove(hook)


# Segment-dispatch hook registry: the device-loop fit engines
# call ``on_segment_dispatch(segment, chunk)`` immediately BEFORE each
# segment dispatch (inside the OOM-backoff try block, so an injected
# RESOURCE_EXHAUSTED takes exactly the recovery path a real one would).
_SEGMENT_HOOKS: List[Callable[[int, int], None]] = []


def on_segment_dispatch(segment: int, chunk: int) -> None:
    """Fire the segment-dispatch hooks (called by the device-loop fit
    engines right before dispatching segment ``segment`` with scan
    chunk ``chunk``).  Production cost: one truthiness check."""
    if _SEGMENT_HOOKS:
        for hook in list(_SEGMENT_HOOKS):
            hook(segment, chunk)


@contextlib.contextmanager
def inject_oom_on_segment(j: int, times: int = 1):
    """Arm a deterministic device-OOM injection: the first ``times``
    dispatch attempts of segment ``j`` raise :class:`SimulatedOOM`
    (counted across backoff retries, so ``times=1`` proves one halving
    recovers and ``times > max backoffs`` proves the bounded-attempts
    re-raise).  Yields a record dict with ``fired`` (count) and
    ``chunks`` (the chunk size each attempt was about to dispatch
    with)."""
    record = {"fired": 0, "chunks": []}

    def hook(segment: int, chunk: int) -> None:
        if segment == j and record["fired"] < times:
            record["fired"] += 1
            record["chunks"].append(chunk)
            raise SimulatedOOM(segment, chunk)

    with _HOOK_LOCK:
        _SEGMENT_HOOKS.append(hook)
    try:
        yield record
    finally:
        with _HOOK_LOCK:
            if hook in _SEGMENT_HOOKS:
                _SEGMENT_HOOKS.remove(hook)


# Serve-and-learn hook registries (caller: serving.learn).  The learner calls
# ``on_update_step(model_id, batch_index)`` right before feeding each
# reservoir batch to the working clone's ``partial_fit`` (inside the
# learner's try block, so an injected failure takes exactly the
# record-and-keep-serving path a real one would), and
# ``on_update_eval(model_id, ratio)`` when judging an applied update
# against the committed regression threshold — armed hooks may OVERRIDE
# the measured post/pre score ratio, forcing the rollback branch
# through the real restore + atomic-swap code.
_UPDATE_HOOKS: List[Callable[[str, int], None]] = []
_UPDATE_EVAL_HOOKS: List[Callable[[str, Optional[float]],
                                  Optional[float]]] = []


def on_update_step(model_id: str, batch_index: int) -> None:
    """Fire the update-step hooks (called by the serve-and-learn
    actuator right before batch ``batch_index`` of an in-place update
    for ``model_id``).  Production cost: one truthiness check."""
    if _UPDATE_HOOKS:
        for hook in list(_UPDATE_HOOKS):
            hook(model_id, batch_index)


def on_update_eval(model_id: str, ratio):
    """Fire the post-update evaluation hooks: each armed hook receives
    (and may override) the post/pre score ratio the learner measured;
    the last hook's return value is what the committed regression rule
    judges.  Production cost: one truthiness check."""
    if _UPDATE_EVAL_HOOKS:
        for hook in list(_UPDATE_EVAL_HOOKS):
            ratio = hook(model_id, ratio)
    return ratio


@contextlib.contextmanager
def inject_update_failure(model_id: Optional[str] = None, *,
                          on_batch: int = 0, times: int = 1):
    """Arm a deterministic in-place-update failure: the first ``times``
    times the serve-and-learn actuator reaches ``partial_fit`` batch
    ``on_batch`` of an update for ``model_id`` (any model when None),
    :class:`SimulatedUpdateFailure` is raised from the real update
    path.  The learner must record the failed attempt and leave the
    serving model bit-identical on last-good — the chaos tests pin
    zero failed serving requests while this is armed.  Yields a record
    dict with ``fired`` (count) and ``models`` (the model ids hit)."""
    record = {"fired": 0, "models": []}

    def hook(mid: str, batch_index: int) -> None:
        if model_id is not None and mid != model_id:
            return
        if batch_index == on_batch and record["fired"] < times:
            record["fired"] += 1
            record["models"].append(mid)
            raise SimulatedUpdateFailure(
                f"injected update failure for model {mid!r} at batch "
                f"{batch_index} (failure {record['fired']}/{times})")

    with _HOOK_LOCK:
        _UPDATE_HOOKS.append(hook)
    try:
        yield record
    finally:
        with _HOOK_LOCK:
            if hook in _UPDATE_HOOKS:
                _UPDATE_HOOKS.remove(hook)


@contextlib.contextmanager
def inject_quality_regression(model_id: Optional[str] = None, *,
                              ratio: float = 10.0, times: int = 1):
    """Arm a deterministic post-update quality regression: the first
    ``times`` evaluations of an applied update for ``model_id`` (any
    model when None) report ``ratio`` as the post/pre score ratio —
    far past the committed :data:`~kmeans_tpu.serving.learn
    .REGRESSION_RATIO` by default — regardless of what the traffic
    measured, so the learner's rollback-to-last-good runs through the
    real snapshot-restore + atomic-swap path.  Yields a record dict
    with ``fired`` (count) and ``measured`` (the ratios that were
    overridden, None entries for updates whose traffic gave no score
    reading)."""
    record = {"fired": 0, "measured": []}

    def hook(mid: str, measured):
        if model_id is not None and mid != model_id:
            return measured
        if record["fired"] < times:
            record["fired"] += 1
            record["measured"].append(measured)
            return float(ratio)
        return measured

    with _HOOK_LOCK:
        _UPDATE_EVAL_HOOKS.append(hook)
    try:
        yield record
    finally:
        with _HOOK_LOCK:
            if hook in _UPDATE_EVAL_HOOKS:
                _UPDATE_EVAL_HOOKS.remove(hook)


@contextlib.contextmanager
def inject_replica_kill(fleet, replica=None, *, after_dispatches: int = 0):
    """Arm a deterministic serving-replica kill:
    the armed ``fault_hook`` — called by the engine's pre-dispatch
    guard on EVERY dispatch path (direct, queued batch, packed) —
    counts dispatch attempts, and once ``after_dispatches`` have been
    allowed through it calls ``fleet.kill_replica`` on the replica
    performing the NEXT one, so that dispatch (and every later one on
    the victim) is refused with ``ReplicaDeadError``.  A queued batch
    in flight at that moment fails through the micro-batch queue's
    per-member isolation, and the fleet router re-dispatches each
    member on a surviving replica — the chaos test pins zero failed
    requests.  ``replica`` names a specific victim; the default arms
    EVERY serving replica and kills whichever one crosses the
    threshold first (robust to the router concentrating traffic — the
    kill lands on a replica that actually holds work).  Yields a
    record dict with ``dispatches`` (attempts seen fleet-wide),
    ``killed`` (bool) and ``replica`` (the victim's name; the armed
    target's when a specific one was named)."""
    if replica is None:
        targets = [r for r in fleet._replicas if r.state == "serving"] \
            or list(fleet._replicas)
    else:
        targets = [fleet._replica(replica)]
    record = {"dispatches": 0, "killed": False,
              "replica": targets[0].name if len(targets) == 1 else None}

    def hook(rep, model_id, op) -> None:
        record["dispatches"] += 1
        if not record["killed"] \
                and record["dispatches"] > after_dispatches:
            record["killed"] = True
            record["replica"] = rep.name
            fleet.kill_replica(rep.name)

    for t in targets:
        t.fault_hook = hook
    try:
        yield record
    finally:
        for t in targets:
            t.fault_hook = None


# ------------------------------------------------------------ callables

def fail_first_attempts(fn: Callable, k: int,
                        exc_factory: Callable[[int], BaseException]
                        = None) -> Callable:
    """Wrap ``fn`` so its first ``k`` invocations raise (then it passes
    through forever).  The wrapper carries a ``.state`` dict with
    ``'calls'`` (total invocations) and ``'failures'`` (raised so far)
    counters — the "fail-first-K-dispatch-attempts" injection point.
    Deterministic: no randomness, the attempt counter is the only
    state."""
    if exc_factory is None:
        exc_factory = lambda i: TransientIOError(  # noqa: E731
            f"injected transient failure (attempt {i + 1}/{k})")
    state = {"calls": 0, "failures": 0}

    def wrapped(*args, **kwargs):
        i = state["calls"]
        state["calls"] += 1
        if i < k:
            state["failures"] += 1
            raise exc_factory(i)
        return fn(*args, **kwargs)

    wrapped.state = state
    return wrapped


# -------------------------------------------------------- block streams

def flaky_blocks(make_blocks: Callable[[], Iterable], *,
                 fail_block: int, fail_times: int,
                 exc_factory: Optional[Callable[[int], BaseException]]
                 = None) -> Callable[[], Iterable]:
    """A ``make_blocks`` whose block ``fail_block`` (0-based position
    within each epoch) raises the first ``fail_times`` times that
    position is READ — counted across epochs and across retry replays,
    so with ``io_retries >= fail_times`` the fit recovers and with
    fewer it must surface the error.  The wrapper carries
    ``.state['failures']`` for assertions."""
    if exc_factory is None:
        exc_factory = lambda i: TransientIOError(  # noqa: E731
            f"injected flaky read of block {fail_block} "
            f"(failure {i + 1}/{fail_times})")
    state = {"failures": 0}

    def make():
        def gen():
            for pos, item in enumerate(make_blocks()):
                if pos == fail_block and state["failures"] < fail_times:
                    i = state["failures"]
                    state["failures"] += 1
                    raise exc_factory(i)
                yield item
        return gen()

    make.state = state
    return make


def poison_blocks(make_blocks: Callable[[], Iterable], *,
                  block: int, value: float = np.nan,
                  row: int = 0, col: Optional[int] = 0, rows: int = 1,
                  from_epoch: int = 0) -> Callable[[], Iterable]:
    """A ``make_blocks`` that poisons block ``block`` (0-based position)
    with ``value`` — the deterministic stand-in for a corrupted
    streamed block.  Two injection shapes:

    * ``col=<int>`` (default): a ``rows``-high column slab
      ``b[row:row+rows, col] = value`` — with the NaN default this
      proves the ``on_nonfinite='error'|'skip'`` quarantine policy.
    * ``col=None``: a full-width slab ``b[row:row+rows, :] = value`` —
      with a huge FINITE value (e.g. ``2e38``) the block passes the IO
      finite check but the identically-poisoned rows land in one
      cluster and overflow the f32 device accumulator, driving the
      FIT's trajectory non-finite: the deterministic trigger for the
      divergence-rollback path, which the IO quarantine must
      NOT intercept.

    ``from_epoch=N`` delays the poison until the (0-based) Nth
    invocation of ``make_blocks`` — a fit healthy for several epochs
    (accumulating checkpoints) then hit mid-fit, so the rollback has a
    last-good state to restore.  The source items are never mutated
    (each poisoned block is a copy); the wrapper carries
    ``.state['epochs']`` for assertions."""
    state = {"epochs": 0}

    def make():
        epoch = state["epochs"]
        state["epochs"] += 1

        def gen():
            for pos, item in enumerate(make_blocks()):
                if pos != block or epoch < from_epoch:
                    yield item
                    continue
                if isinstance(item, tuple):
                    b, w = item
                else:
                    b, w = item, None
                b = np.array(b, copy=True)
                if col is None:
                    b[row: row + rows, :] = value
                else:
                    b[row: row + rows, col] = value
                yield b if w is None else (b, w)
        return gen()

    make.state = state
    return make
