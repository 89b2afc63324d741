"""Online serving: resident models, micro-batching, packed routing, and
the guarded bf16 and PQ paths (the port of the JAX package's
``serving``).

* :class:`ServingEngine` — hold fitted models resident on the card and
  serve ``predict`` / ``transform`` / ``score`` / ``predict_proba``
  through the assignment kernels, padded to bucket shapes
  (``serving.engine``).
* :class:`MicroBatchQueue` / :class:`ServingFuture` — micro-batching of
  concurrent small requests (``serving.batching``).
* :class:`ModelRegistry` / :func:`load_fitted` — multi-model residency,
  checkpoint loading and same-shape pack groups (``serving.registry``).

The JAX package's fleet (``serving/fleet.py``) and serve-and-learn
(``serving/learn.py``) are ROADMAP.md, A.12.
"""

from kmeans_tpu_torch.serving.batching import (MicroBatchQueue,
                                               ServingClosedError,
                                               ServingFuture)
from kmeans_tpu_torch.serving.engine import ResidentModel, ServingEngine
from kmeans_tpu_torch.serving.registry import ModelRegistry, load_fitted

__all__ = ["ServingEngine", "ResidentModel", "MicroBatchQueue",
           "ServingFuture", "ServingClosedError", "ModelRegistry",
           "load_fitted"]
