"""State carried between the JAX package and this port.

``from_jax_state`` takes the dictionary that ``kmeans_tpu.KMeans._state_dict()``
returns (NumPy arrays and plain values only: nothing of the JAX package is
imported here) and builds a fitted ``kmeans_tpu_torch.KMeans`` from it;
``to_jax_state`` goes the other way.  The same dictionaries are what the
``.npz`` checkpoints of both packages hold, so a model saved by either one
loads in the other.
"""

from __future__ import annotations

from kmeans_tpu_torch.models.kmeans import KMeans


def from_jax_state(state: dict, device=None) -> KMeans:
    """A fitted port model from a JAX-package state dictionary.

    Constructor arguments that the port does not have are dropped, with one
    warning that lists those set to something the port cannot honour;
    ``distance_mode='pallas'`` becomes ``'kernel'``.  ``device`` as in the
    ``KMeans`` constructor: ``None`` is the card."""
    return KMeans._from_state(state, device=device)


def to_jax_state(model: KMeans) -> dict:
    """The state dictionary of a port model in the JAX package's
    vocabulary: pass it to ``kmeans_tpu.utils.checkpoint.save_state``, or
    save with ``model.save(path)`` and load with ``kmeans_tpu.KMeans.load``."""
    return model._state_dict()
