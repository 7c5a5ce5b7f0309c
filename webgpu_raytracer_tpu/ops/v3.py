"""Component-SoA 3-vectors: (R,) lanes per component.

The dense path keeps each vector as three independent (R,) arrays, so every
elementwise op runs over contiguous lanes and no (R, 3) minor-dim slice is
needed.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length(a: V3):
    return jnp.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    inv = 1.0 / jnp.maximum(length(a), 1e-20)
    return a * inv


def where(mask, a: V3, b: V3) -> V3:
    return V3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y),
              jnp.where(mask, a.z, b.z))


def select3(m1, v1: V3, m2, v2: V3, v0: V3) -> V3:
    """v1 where m1, else v2 where m2, else v0."""
    return where(m1, v1, where(m2, v2, v0))


def max_component(a: V3):
    return jnp.maximum(a.x, jnp.maximum(a.y, a.z))


def splat(v, like) -> V3:
    """Broadcast a python/1x3 constant against a (R,) template array."""
    ones = jnp.ones_like(like)
    return V3(ones * v[0], ones * v[1], ones * v[2])


def from_rows(arr) -> V3:
    """(R, 3) -> V3 of (R,). One relayout; use only at boundaries."""
    return V3(arr[:, 0], arr[:, 1], arr[:, 2])


def reflect(i: V3, n: V3) -> V3:
    return i - n * (2.0 * dot(n, i))
