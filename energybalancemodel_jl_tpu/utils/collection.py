"""Dot-access keyed collections (rebuild of the reference's
``Collection{V}``, /root/reference/src/infrastructure.jl:39-68).

The reference wraps ``Dict{Symbol,V}`` to give dot-syntax access; here a
``dict`` subclass provides the same ergonomics and is registered as a JAX
pytree node so parameter/state collections flow through ``jit``/``vmap``/
``lax.scan`` directly.
"""
from __future__ import annotations

import jax


class Collection(dict):
    """A ``dict`` with attribute-style access to its keys.

    Examples
    --------
    >>> parameters = Collection(D=0.6, A=193.0, B=2.1)
    >>> parameters.D
    0.6
    >>> parameters.F = 0.0
    >>> parameters["F"]
    0.0
    """

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(
                f"Collection has no entry {key!r} (keys: {sorted(self.keys())})"
            ) from None

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError:
            raise AttributeError(key) from None

    def copy(self) -> "Collection":
        return Collection(self)

    def __repr__(self):  # pragma: no cover - cosmetic
        inner = ", ".join(f"{k}={v!r}" for k, v in sorted(self.items()))
        return f"Collection({inner})"


def _collection_flatten(coll: Collection):
    keys = tuple(sorted(coll.keys()))
    return tuple(coll[k] for k in keys), keys


def _collection_unflatten(keys, children) -> Collection:
    return Collection(zip(keys, children))


jax.tree_util.register_pytree_node(
    Collection, _collection_flatten, _collection_unflatten
)
