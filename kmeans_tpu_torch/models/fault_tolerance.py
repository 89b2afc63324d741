"""Auto-checkpoints and recovery, shared by every model family.

Counterpart of ``kmeans_tpu/models/fault_tolerance.py``:

* ``_check_ckpt``: the knobs (``checkpoint_every`` and ``checkpoint_path``
  go together, ``n_init == 1``), the checkpoint this fit owns (what a
  divergence rolls back to) and the per-fit recovery attributes
  ``oom_backoffs_`` and ``effective_chunk_``;
* ``_write_autockpt``: one rotating atomic write
  (``utils.checkpoint.save_state_primary(rotate=True)``: one writer, then
  the mesh's barrier), then the injection hook ``faults.on_checkpoint``, so
  that an injected kill always leaves a valid file behind;
* ``_resolve_resume``: ``resume`` may be a path: the state is loaded (from
  the ``.prev`` rotation, with a warning, when the file is torn), its model
  class and cluster count checked, restored, and the fit continues as with
  ``resume=True``.  The state is the whole table, so the resuming model may
  run on another mesh than the writer;
* ``_dispatch_oom_safe``: a device-loop segment that runs out of device
  memory (:func:`is_oom_error`) is replayed from its boundary at the next
  smaller chunk (``parallel.sharding.backoff_chunk``), at most
  :data:`MAX_OOM_BACKOFFS` times per fit, on the same device and in the same
  mode: the backoff changes the chunk and nothing else.  The injection hook
  ``faults.on_segment_dispatch`` fires inside the retried block;
* ``_raise_divergence``: on a non-finite trajectory the fitted state rolls
  back to the last checkpoint this fit wrote or resumed from, then
  :class:`NumericalDivergenceError` names the quantity and the iteration.

A model class has ``n_init``, ``mesh``, ``dtype`` and ``device``, provides
``_state_dict()`` and ``_restore_fitted(state)`` (the whole fitted state:
``_restore_state`` is the families' hook for their own extras) and names
its cluster-count attribute in ``_ckpt_k_attr``.
"""

from __future__ import annotations

import gc
import os
import warnings

import torch

from kmeans_tpu_torch.obs import memory as obs_memory
from kmeans_tpu_torch.obs import trace as obs_trace
from kmeans_tpu_torch.obs.heartbeat import note_progress as obs_note_progress
from kmeans_tpu_torch.obs.metrics_registry import REGISTRY as obs_registry
from kmeans_tpu_torch.parallel.sharding import backoff_chunk
from kmeans_tpu_torch.utils import checkpoint as ckpt
from kmeans_tpu_torch.utils import faults


class NumericalDivergenceError(ValueError):
    """The fit's trajectory went non-finite.  Carries ``quantity``
    ('centroids' | 'log-likelihood' | 'covariance', or any other name),
    ``iteration`` (the first diverged iteration), ``rolled_back_to`` (the
    iteration of the checkpoint the model was restored to, None without
    one) and ``checkpoint_path``.  The JAX package's signature, fields and
    messages."""

    _PHRASE = {
        "centroids": "NaN or Inf detected in centroids at iteration {i}",
        "log-likelihood": "non-finite log-likelihood at EM iteration {i}",
        "covariance": "ill-defined empirical covariance at EM "
                      "iteration {i}",
    }

    def __init__(self, quantity: str, iteration: int, *,
                 rolled_back_to=None, checkpoint_path=None, detail=""):
        self.quantity = quantity
        self.iteration = int(iteration)
        self.rolled_back_to = rolled_back_to
        self.checkpoint_path = checkpoint_path
        msg = self._PHRASE.get(quantity,
                               f"non-finite {quantity} at iteration "
                               "{i}").format(i=iteration)
        if detail:
            msg += f" ({detail})"
        if rolled_back_to is not None:
            msg += (f"; fitted state rolled back to the last-good "
                    f"checkpoint (iteration {rolled_back_to}, "
                    f"{checkpoint_path}) — inspect, adjust, and continue "
                    f"with fit(resume=<path>)")
        elif checkpoint_path is not None:
            msg += (f"; the last-good checkpoint at {checkpoint_path} "
                    f"could not be restored")
        super().__init__(msg)


#: Message tags of a device out-of-memory error: the JAX package's
#: (``RESOURCE_EXHAUSTED``, which ``faults.SimulatedOOM`` carries, and the
#: allocator's phrase, which PyTorch's "CUDA out of memory" also carries).
#: No bare "OOM": an unrelated error that mentions it must not be retried.
_OOM_TAGS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")

#: Halvings per fit before the original error is raised.
MAX_OOM_BACKOFFS = 12


def is_oom_error(e: BaseException) -> bool:
    """True for a device memory exhaustion worth a replay at a smaller
    chunk: ``torch.cuda.OutOfMemoryError``, or a ``RuntimeError`` or
    ``MemoryError`` whose message carries one of :data:`_OOM_TAGS` (the
    injected ``faults.SimulatedOOM`` too).  A preemption
    (``faults.SimulatedPreemption``) never is: it must propagate."""
    if isinstance(e, faults.SimulatedPreemption):
        return False
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    if not isinstance(e, (RuntimeError, MemoryError)):
        return False
    return any(tag in str(e) for tag in _OOM_TAGS)


class AutoCheckpointMixin:

    _ckpt_k_attr = "k"

    def _check_ckpt(self, checkpoint_every, checkpoint_path) -> int:
        """Validate the checkpoint knobs (the JAX package's messages) and
        reset the per-fit recovery state: the active path, whether this
        fit wrote it, ``oom_backoffs_`` and ``effective_chunk_``."""
        n = int(checkpoint_every)
        if n < 0 or n != checkpoint_every:
            raise ValueError(f"checkpoint_every must be an int >= 0, got "
                             f"{checkpoint_every!r}")
        if n > 0 and checkpoint_path is None:
            raise ValueError("checkpoint_every > 0 requires "
                             "checkpoint_path")
        if n == 0 and checkpoint_path is not None:
            raise ValueError("checkpoint_path requires "
                             "checkpoint_every >= 1")
        if n > 0 and self.n_init != 1:
            raise ValueError(
                "auto-checkpointing (checkpoint_every > 0) requires "
                "n_init == 1: a restart sweep re-initializes, so a "
                "partially-swept fit has no well-defined resume point")
        self._active_ckpt_path = checkpoint_path if n > 0 else None
        if n > 0:
            # With a store of built kernel libraries active, the libraries
            # this fit uses go into the checkpoint's sibling <path>.aot
            # directory, so a restart on a fresh host loads them with the
            # state; one None check without a store.
            from kmeans_tpu_torch.utils import aot as _aot
            _aot.on_checkpoint_path(checkpoint_path)
        # A rollback needs a stake in the file: one this fit wrote, or the
        # state it resumed from.  A stale file of another fit at the same
        # path is never restored.
        self._ckpt_written_this_fit = False
        self.oom_backoffs_ = 0
        self.effective_chunk_ = None
        return n

    def _ckpt_meta(self) -> dict:
        """The topology block stamped into every checkpoint."""
        return ckpt.topology_meta(self.mesh, self.dtype)

    def _dispatch_oom_safe(self, dispatch, chunk: int, segment: int):
        """``dispatch(chunk)`` with the out-of-memory backoff: on a device
        OOM the chunk goes to ``backoff_chunk(chunk)`` and the segment is
        replayed from its boundary state (the last checkpoint), on the same
        device and in the same mode.  The device is synchronised inside the
        retried block, so an OOM raised by a launch is caught here too.
        Before a replay the failed attempt's memory is returned to the
        device (``torch.cuda.empty_cache``).  Returns ``(result, chunk)``,
        the chunk that succeeded; later segments keep it.

        Under a tracer (the reference's spans): one ``segment`` span wraps
        the retry loop, each attempt a nested ``dispatch`` span
        (``tag='fit/segment'``, its chunk and attempt index), so a replayed
        segment adds attempts inside the same segment span; the segment
        opens with the advisory ``obs.memory.advise_dispatch``.  A backoff
        also counts ``fit.oom_backoffs`` in the registry."""
        cuda = self.device.type == "cuda"
        attempt = 0
        with obs_trace.span("segment", index=segment):
            obs_memory.advise_dispatch(self, chunk, segment=segment)
            while True:
                try:
                    with obs_trace.span("dispatch", tag="fit/segment",
                                        chunk=chunk, attempt=attempt):
                        faults.on_segment_dispatch(segment, chunk)
                        result = dispatch(chunk)
                        if cuda:
                            torch.cuda.synchronize(self.device)
                    return result, chunk
                except Exception as e:      # noqa: BLE001 — reclassified
                    if not is_oom_error(e):
                        raise
                    smaller = backoff_chunk(chunk)
                    if smaller is None or \
                            self.oom_backoffs_ >= MAX_OOM_BACKOFFS:
                        raise RuntimeError(
                            f"{e}; chunk backoff exhausted at {chunk} "
                            f"rows after {self.oom_backoffs_} "
                            f"halving(s) — this working set does not "
                            f"fit at the minimum scan chunk; shrink "
                            f"k/D, add devices, or resume the "
                            f"checkpoint on a larger mesh") from e
                    attempt += 1
                    self.oom_backoffs_ += 1
                    self.effective_chunk_ = smaller
                    obs_registry.counter("fit.oom_backoffs").inc()
                    warnings.warn(
                        f"device OOM dispatching segment {segment} at "
                        f"chunk {chunk}; retrying at chunk {smaller} "
                        f"(backoff {self.oom_backoffs_}/"
                        f"{MAX_OOM_BACKOFFS}; the segment replays from "
                        f"the last checkpoint boundary, trajectory "
                        f"unchanged)", UserWarning, stacklevel=3)
                    chunk = smaller
                if cuda:
                    # Only a backed-off attempt gets here; its error and
                    # frames are gone, so what it allocated goes back to
                    # the device.
                    gc.collect()
                    torch.cuda.empty_cache()

    def _raise_divergence(self, quantity: str, iteration: int,
                          detail: str = ""):
        """Roll the fitted state back to the last checkpoint this fit has a
        stake in (when it still loads), then raise
        :class:`NumericalDivergenceError`."""
        path = getattr(self, "_active_ckpt_path", None)
        own = getattr(self, "_ckpt_written_this_fit", False) or (
            path is not None
            and getattr(self, "_resumed_from", None) == os.fspath(path))
        rolled = None
        if path is not None and own:
            try:
                state, _ = ckpt.load_state_with_fallback(path)
            except (OSError, ValueError):       # missing, torn, or newer
                state = None
            k_attr = self._ckpt_k_attr
            if state is not None and \
                    state.get("model_class", type(self).__name__) \
                    == type(self).__name__ and \
                    int(state.get(k_attr, getattr(self, k_attr))) \
                    == getattr(self, k_attr):
                self._restore_fitted(state)
                rolled = int(state.get("iterations_run",
                                       state.get("n_iter_", 0)))
        raise NumericalDivergenceError(
            quantity, iteration, rolled_back_to=rolled,
            checkpoint_path=path if own else None, detail=detail)

    def _write_autockpt(self, path, iteration: int) -> None:
        """One rotating atomic checkpoint (one writer, then the mesh's
        barrier), the heartbeat of the boundary (every family's segments
        pass here, their state already on the host), then the
        checkpoint-boundary injection hook."""
        ckpt.save_state_primary(path, self._state_dict(), self.mesh,
                                rotate=True)
        self._ckpt_written_this_fit = True
        obs_note_progress(self, phase="checkpoint", iteration=int(iteration))
        faults.on_checkpoint(iteration, path)

    def _resolve_resume(self, resume) -> bool:
        """``resume`` as a bool; a path loads its checkpoint (``.prev``
        when the file is torn) into this model first."""
        if not isinstance(resume, (str, os.PathLike)):
            self._resumed_from = None
            return bool(resume)
        self._resumed_from = os.fspath(resume)
        # The libraries shipped beside the checkpoint (<path>.aot) join the
        # active store's read path: the resume loads them instead of
        # building.  One None check without a store.
        from kmeans_tpu_torch.utils import aot as _aot
        _aot.on_resume_path(resume)
        state, used_prev = ckpt.load_state_with_fallback(resume)
        if used_prev:
            warnings.warn(
                f"checkpoint {resume} is unreadable; resuming from the "
                f"last-good rotation {ckpt.prev_path(resume)} (one "
                f"checkpoint interval older, same trajectory)",
                UserWarning, stacklevel=3)
        cls_name = state.get("model_class", type(self).__name__)
        if cls_name != type(self).__name__:
            raise ValueError(
                f"checkpoint {resume} was written by {cls_name}, not "
                f"{type(self).__name__}; load it with {cls_name}.load "
                f"or resume with the matching model class")
        k_attr = self._ckpt_k_attr
        if k_attr in state and int(state[k_attr]) != getattr(self, k_attr):
            raise ValueError(
                f"checkpoint {resume} holds a {k_attr}="
                f"{int(state[k_attr])} model; this model has "
                f"{k_attr}={getattr(self, k_attr)}")
        self._restore_fitted(state)
        return True
