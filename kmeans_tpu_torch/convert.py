"""State carried between the JAX package and this port.

``from_jax_state`` takes the dictionary that a model of the JAX package
returns from ``_state_dict()`` (NumPy arrays and plain values only: nothing
of the JAX package is imported here) and builds the fitted port model of the
same class, ``KMeans`` or ``GaussianMixture`` by its ``model_class``;
``to_jax_state`` goes the other way.  The same dictionaries are what the
``.npz`` checkpoints of both packages hold, so a model saved by either one
loads in the other.
"""

from __future__ import annotations

from typing import Union

from kmeans_tpu_torch.models.gmm import GaussianMixture
from kmeans_tpu_torch.models.kmeans import KMeans

_CLASSES = {"KMeans": KMeans, "GaussianMixture": GaussianMixture}


def from_jax_state(state: dict, device=None
                   ) -> Union[KMeans, GaussianMixture]:
    """A fitted port model from a JAX-package state dictionary.

    The class follows ``state['model_class']`` (``KMeans`` when absent).
    Constructor arguments that the port does not have are dropped, with one
    warning that lists those set to something the port cannot honour;
    ``distance_mode='pallas'`` becomes ``'kernel'``, and ``'pallas_bf16'``
    ``'kernel_bf16'``.  ``device`` as in the
    constructors: ``None`` is the card."""
    name = str(state.get("model_class", "KMeans"))
    if name not in _CLASSES:
        raise NotImplementedError(
            f"model_class={name!r} is not ported to kmeans_tpu_torch yet: "
            f"ROADMAP.md, A.7 'The other K-Means families'")
    return _CLASSES[name]._from_state(state, device=device)


def to_jax_state(model: Union[KMeans, GaussianMixture]) -> dict:
    """The state dictionary of a port model in the JAX package's
    vocabulary: pass it to ``kmeans_tpu.utils.checkpoint.save_state``, or
    save with ``model.save(path)`` and load with the JAX class's ``load``."""
    return model._state_dict()
