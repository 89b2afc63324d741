"""Bounded LRU cache of the step functions the program builders make.

Counterpart of ``kmeans_tpu/utils/cache.py``.  The models key the products
of the ``parallel`` builders (``distributed.make_step_fn``,
``make_predict_fn``, ``make_fit_fn``, ``gmm_step.make_gmm_*`` ...) by the
builder and every argument it was called with (:func:`builder_key`), so a
warm path reuses its functions and ``utils.profiling.recompilation_sentinel``
can see a path that builds again.  The bound keeps a long-lived service that
streams many block shapes from pinning a function per shape; a fit holds its
own reference, so an eviction during a fit is harmless.

Only builders' products are cached, never a device loop's state: the
CUDA graph of a loop holds its dataset's addresses and lives in that
dataset's memo (``Dataset.memo``), so dropping the dataset frees it.

A miss is where a program is made, so it carries three hooks, each one
``None`` check when off:

* a ``compile`` span naming the cache and the key, under a tracer;
* ``utils.aot.wrap``: with a store of built kernel libraries active, the
  libraries of the entry's mode are made present (build directory, then
  the store, then ``nvcc``);
* ``obs.cost.instrument``: under a cost collector the entry is wrapped for
  one measured call, its record named by the cache.
"""

from __future__ import annotations

import os
import sys
from collections import OrderedDict

from kmeans_tpu_torch.obs import cost as _obs_cost
from kmeans_tpu_torch.obs import trace as _obs_trace

#: The environment knob that activates the store of built libraries
#: (``utils.aot``) without code changes.
AOT_ENV = "KMEANS_TPU_TORCH_AOT_CACHE"


def _aot_wrap(name, key, value):
    """Hand a fresh entry to ``utils.aot.wrap``, touching that module only
    where it was imported already or its environment knob is set: without
    either a miss costs one ``sys.modules`` lookup and one environment
    read."""
    mod = sys.modules.get("kmeans_tpu_torch.utils.aot")
    if mod is None:
        if not os.environ.get(AOT_ENV):
            return value
        from kmeans_tpu_torch.utils import aot as mod
    return mod.wrap(name, key, value)


class _MeshKey:
    """A mesh in a key, equal only to itself: a builder's product closes
    over the mesh's process groups, so a new mesh of the same shape (a
    group destroyed and made again) must not be served the old one's."""

    __slots__ = ("mesh",)

    def __init__(self, mesh):
        self.mesh = mesh

    def __eq__(self, other):
        return isinstance(other, _MeshKey) and other.mesh is self.mesh

    def __hash__(self):
        return id(self.mesh)

    def __repr__(self):
        return f"mesh{tuple(self.mesh.mesh.shape)}"


def _hashable(v):
    """A hashable stand-in of a builder argument: a mesh by identity, lists
    and tuples by their items, NumPy arrays by dtype, shape and bytes, the
    rest as it is."""
    if hasattr(v, "mesh_dim_names"):
        return _MeshKey(v)
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if hasattr(v, "tobytes") and hasattr(v, "dtype"):
        return ("array", str(v.dtype), tuple(v.shape), v.tobytes())
    return v


def builder_key(builder, *args, **kwargs) -> tuple:
    """The cache key of ``builder(*args, **kwargs)``: the builder's name,
    its positional arguments and its keyword arguments sorted by name."""
    return (builder.__name__, tuple(_hashable(a) for a in args),
            tuple(sorted((k, _hashable(v)) for k, v in kwargs.items())))


def _is_loop(value) -> bool:
    members = value if isinstance(value, tuple) else (value,)
    return any(getattr(v, "_cost_loop", False) for v in members)


class LRUCache:
    """An ordered-dict LRU with the mapping surface the models use (``in``,
    ``[]``, assignment, ``len``, ``keys``).

    ``name`` labels the cache in telemetry: a :meth:`get_or_create` miss is
    a ``compile`` span naming it and the key, and a cost record's
    ``cache``.  ``compile_spans=False`` takes a cache whose factory builds
    no program out of all three miss hooks."""

    def __init__(self, maxsize: int = 64, name: str = None,
                 compile_spans: bool = True):
        if int(maxsize) < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self.name = name
        self.compile_spans = bool(compile_spans)
        self._d: OrderedDict = OrderedDict()

    def get_or_create(self, key, factory):
        """The cached value, made by ``factory()`` on a miss.  One read of
        the dict, so an eviction by another thread between a check and the
        read can never raise: the worst outcome of a race is a duplicate
        build."""
        try:
            value = self._d[key]
        except KeyError:
            name = self.name or "cache"
            if self.compile_spans and _obs_trace.active():
                with _obs_trace.span("compile", cache=name,
                                     key=repr(key)[:160]):
                    value = factory()
                    value = self._hooks(name, key, value)
            else:
                value = factory()
                if self.compile_spans:
                    value = self._hooks(name, key, value)
            self[key] = value
            return value
        try:
            self._d.move_to_end(key)
        except KeyError:
            pass            # evicted concurrently; the value is still good
        return value

    @staticmethod
    def _hooks(name, key, value):
        # The store first (it loads libraries, it wraps nothing), then the
        # cost proxy outermost, so its one measured call sees the entry.
        value = _aot_wrap(name, key, value)
        return _obs_cost.instrument(name, key, value, loop=_is_loop(value))

    def __contains__(self, key) -> bool:
        return key in self._d

    def __getitem__(self, key):
        self._d.move_to_end(key)
        return self._d[key]

    def __setitem__(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def keys(self):
        """A snapshot of the keys, oldest first: what
        ``recompilation_sentinel`` compares."""
        return list(self._d.keys())

    def clear(self) -> None:
        self._d.clear()


def cached_build(cache: LRUCache, builder, *args, **kwargs):
    """``builder(*args, **kwargs)`` through ``cache`` under
    :func:`builder_key`."""
    return cache.get_or_create(builder_key(builder, *args, **kwargs),
                               lambda: builder(*args, **kwargs))
