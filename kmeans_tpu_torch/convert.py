"""State carried between the JAX package and this port.

``from_jax_state`` takes the dictionary that a model of the JAX package
returns from ``_state_dict()`` (NumPy arrays and plain values only: nothing
of the JAX package is imported here) and builds the fitted port model of the
same class (``KMeans``, ``MiniBatchKMeans``, ``BisectingKMeans``,
``SphericalKMeans``, ``GaussianMixture`` or ``ProductQuantizer``) by its
``model_class``; ``to_jax_state`` goes the other way.  The JAX package's
``ProductQuantizer`` has no checkpoint: :func:`pq_state` (``models.pq``)
reads its fitted attributes into such a dictionary.  The same dictionaries are what the
``.npz`` checkpoints of both packages hold, so a model saved by either one
loads in the other; so do the rotating checkpoints of a checkpointed fit,
with what a resume reads from them (the mixture's device tables
``dev_*``, the bisecting tree ``tree_*``, the mini-batch counts).
"""

from __future__ import annotations

from typing import Union

from kmeans_tpu_torch.models.bisecting import BisectingKMeans
from kmeans_tpu_torch.models.gmm import GaussianMixture
from kmeans_tpu_torch.models.kmeans import KMeans
from kmeans_tpu_torch.models.minibatch import MiniBatchKMeans
from kmeans_tpu_torch.models.pq import ProductQuantizer, pq_state
from kmeans_tpu_torch.models.spherical import SphericalKMeans

_CLASSES = {"KMeans": KMeans, "MiniBatchKMeans": MiniBatchKMeans,
            "BisectingKMeans": BisectingKMeans,
            "SphericalKMeans": SphericalKMeans,
            "GaussianMixture": GaussianMixture,
            "ProductQuantizer": ProductQuantizer}

__all__ = ["from_jax_state", "to_jax_state", "pq_state"]


def from_jax_state(state: dict, device=None
                   ) -> Union[KMeans, GaussianMixture, ProductQuantizer]:
    """A fitted port model from a JAX-package state dictionary.

    The class follows ``state['model_class']`` (``KMeans`` when absent).
    Constructor arguments that the port does not have are dropped, with one
    warning that lists those set to something the port cannot honour;
    ``distance_mode='pallas'`` becomes ``'kernel'``, and ``'pallas_bf16'``
    ``'kernel_bf16'``.  ``device`` as in the
    constructors: ``None`` is the card."""
    name = str(state.get("model_class", "KMeans"))
    if name not in _CLASSES:
        raise ValueError(f"unknown model_class {name!r}; known: "
                         f"{sorted(_CLASSES)}")
    return _CLASSES[name]._from_state(state, device=device)


def to_jax_state(model: Union[KMeans, GaussianMixture,
                                ProductQuantizer]) -> dict:
    """The state dictionary of a port model in the JAX package's
    vocabulary: pass it to ``kmeans_tpu.utils.checkpoint.save_state``, or
    save with ``model.save(path)`` and load with the JAX class's ``load``."""
    return model._state_dict()
