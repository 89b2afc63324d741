"""Online serving: resident models, micro-batching, packed routing, the
guarded bf16 and PQ paths, the serving fleet and serve-and-learn (the port
of the JAX package's ``serving``).

* :class:`ServingEngine` — hold fitted models resident on the card and
  serve ``predict`` / ``transform`` / ``score`` / ``predict_proba``
  through the assignment kernels, padded to bucket shapes
  (``serving.engine``).
* :class:`MicroBatchQueue` / :class:`ServingFuture` — micro-batching of
  concurrent small requests (``serving.batching``).
* :class:`ModelRegistry` / :func:`load_fitted` — multi-model residency,
  checkpoint loading and same-shape pack groups (``serving.registry``).
* :class:`ServingFleet` / :class:`FleetFuture` — engine replicas behind an
  SLO-aware router, with explicit sheds (:class:`FleetOverloadError`) and
  fail-over of a dead replica's requests (:class:`ReplicaDeadError`)
  (``serving.fleet``).
* :class:`ModelLearner` / :func:`publish_tables` /
  :class:`UpdateRolledBack` — serve-and-learn: in-place updates from live
  traffic, one atomic swap, rollback on regression (``serving.learn``).
"""

from kmeans_tpu_torch.serving.batching import (MicroBatchQueue,
                                               ServingClosedError,
                                               ServingFuture)
from kmeans_tpu_torch.serving.engine import ResidentModel, ServingEngine
from kmeans_tpu_torch.serving.fleet import (FleetFuture, FleetOverloadError,
                                            ReplicaDeadError, ServingFleet)
from kmeans_tpu_torch.serving.learn import (ModelLearner, UpdateRolledBack,
                                            publish_tables)
from kmeans_tpu_torch.serving.registry import ModelRegistry, load_fitted

__all__ = ["ServingEngine", "ResidentModel", "MicroBatchQueue",
           "ServingFuture", "ServingClosedError", "ModelRegistry",
           "load_fitted", "ServingFleet", "FleetFuture",
           "FleetOverloadError", "ReplicaDeadError", "ModelLearner",
           "UpdateRolledBack", "publish_tables"]
