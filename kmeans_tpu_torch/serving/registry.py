"""Multi-model residency registry for the serving engine.

The port's copy of the JAX package's ``serving/registry.py``: fitted
models keyed by model id, loaded from checkpoints of either package
(``utils.checkpoint`` — the ``model_class`` field names the family, so a
checkpoint written on any mesh loads here model-free), and **pack
groups**: sets of same-shape K-Means-family models whose centroid tables
stack on a batched model axis, so a routed mixed-model request batch is
one dispatch (``ServingEngine.predict_multi``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from kmeans_tpu_torch.utils import checkpoint as ckpt

__all__ = ["ModelRegistry", "model_classes", "load_fitted"]


def model_classes() -> dict:
    """Name -> class map over every servable family (lazy import — the
    registry must not force the whole model zoo at module import)."""
    from kmeans_tpu_torch import (BisectingKMeans, GaussianMixture,
                                  KMeans, MiniBatchKMeans, SphericalKMeans)
    return {c.__name__: c for c in (KMeans, MiniBatchKMeans,
                                    BisectingKMeans, SphericalKMeans,
                                    GaussianMixture)}


def load_fitted(path, *, device=None, mesh=None):
    """Load a fitted model from a checkpoint, dispatching on the
    ``model_class`` recorded in its metadata (``describe_checkpoint``
    reads only the JSON record to pick the class).  Raises ``ValueError``
    naming the class when the checkpoint's family is unknown, and the
    usual ``CheckpointCorruptError`` family on torn files.  ``device`` and
    ``mesh`` as in the estimators (``None`` is the card)."""
    info = ckpt.describe_checkpoint(path)
    if info.get("source") is None:
        # No readable metadata: surface the loader's own corruption
        # error (it names the file and cause).
        ckpt.load_state(path)
        raise ckpt.CheckpointCorruptError(path, "unreadable metadata")
    name = info.get("model_class")
    classes = model_classes()
    if name not in classes:
        raise ValueError(
            f"checkpoint {path} was written by model class {name!r}, "
            f"which this serving build cannot host; known: "
            f"{sorted(classes)}")
    return classes[name].load(path, device=device, mesh=mesh)


class ModelRegistry:
    """Model-id -> fitted-model store with shape-group bookkeeping.

    The registry is pure host-side bookkeeping (ids, specs, pack
    groups); device placement and compiled functions live in the
    engine's ResidentModel wrappers.
    """

    def __init__(self):
        self._models: Dict[str, object] = {}
        self._specs: Dict[str, dict] = {}

    # ------------------------------------------------------------- CRUD

    def register(self, model_id: str, model) -> dict:
        """Add a FITTED model under ``model_id``; returns its serving
        spec (``model.fitted_state()``).  Ids are unique — re-register
        under a new id or ``remove`` first."""
        model_id = str(model_id)
        if model_id in self._models:
            raise ValueError(f"model id {model_id!r} already resident; "
                             f"remove() it first or pick another id")
        spec = model.fitted_state()      # raises if not fitted
        # Serve-and-learn eligibility is a registry-level
        # fact of the model CLASS, recorded once at registration so the
        # engine's learner attach and ``update_status()`` agree on it:
        # in-place online updates require a real incremental path (the
        # MiniBatch Sculley carry), and only the K-Means family has
        # the atomic-swap publication contract.
        spec.setdefault(
            "updatable",
            spec.get("family") == "kmeans"
            and callable(getattr(model, "partial_fit", None)))
        self._models[model_id] = model
        self._specs[model_id] = spec
        return spec

    def load(self, path, model_id: Optional[str] = None, *, device=None,
             mesh=None) -> Tuple[str, object]:
        """Load a checkpoint into the registry.  ``model_id`` defaults
        to the checkpoint's file stem, suffixed ``-2``, ``-3``, ... on
        collision."""
        model = load_fitted(path, device=device, mesh=mesh)
        if model_id is None:
            from pathlib import Path
            stem = Path(str(path)).stem
            model_id, i = stem, 1
            while model_id in self._models:
                i += 1
                model_id = f"{stem}-{i}"
        self.register(model_id, model)
        return model_id, model

    def get(self, model_id: str):
        try:
            return self._models[model_id]
        except KeyError:
            raise KeyError(
                f"no resident model {model_id!r}; resident: "
                f"{sorted(self._models)}") from None

    def spec(self, model_id: str) -> dict:
        self.get(model_id)
        return self._specs[model_id]

    def remove(self, model_id: str) -> None:
        self.get(model_id)
        del self._models[model_id]
        del self._specs[model_id]

    def ids(self) -> List[str]:
        return sorted(self._models)

    def __contains__(self, model_id) -> bool:
        return model_id in self._models

    def __len__(self) -> int:
        return len(self._models)

    # ------------------------------------------------------ pack groups

    @staticmethod
    def group_key(spec: dict) -> Optional[tuple]:
        """Stacking key: same-(k, D, dtype) K-Means-family models share
        one batched centroid tensor; None for unstackable families
        (GMM: per-component covariance structure has no shared-table
        form)."""
        if not spec.get("stackable"):
            return None
        return (spec["k"], spec["d"], spec["dtype"])

    def pack_groups(self) -> Dict[tuple, List[str]]:
        """All stacking groups with >= 2 members (id order = insertion
        order, which fixes each model's slot on the packed axis)."""
        groups: Dict[tuple, List[str]] = {}
        for model_id, spec in self._specs.items():
            key = self.group_key(spec)
            if key is not None:
                groups.setdefault(key, []).append(model_id)
        return {k: v for k, v in groups.items() if len(v) >= 2}

    def group_ids(self, key: Optional[tuple]) -> List[str]:
        """Resident ids stacking under ``key`` (insertion order — the
        packed-axis slot order); empty for ``key=None``."""
        if key is None:
            return []
        return [mid for mid, spec in self._specs.items()
                if self.group_key(spec) == key]
