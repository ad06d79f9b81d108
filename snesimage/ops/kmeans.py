"""Deterministic Lloyd's k-means as a jitted, fixed-shape JAX op.

Batched replacement for the reference's `cogset::Kmeans` calls
(reference: src/lib.rs:130 for tile-mean clustering, src/lib.rs:366 for
per-subpalette pixel clustering). Design notes:

- Fixed shapes: data is a padded ``(N, D)`` array with a validity mask, so
  the same compiled kernel serves any number of real points (no dynamic
  shapes under jit).
- Deterministic init: centers start at the first ``k`` valid points in a
  caller-supplied priority order (``init_order``), mirroring deterministic
  seeding (cogset 0.2.0 has no `rand` dependency per the reference's
  Cargo.lock; its exact seeding could not be verified offline, so the
  deterministic first-k rule is our documented contract).
- Assignment ties resolve to the lowest cluster index (``jnp.argmin``
  returns the first minimum), matching strict-less-than scans.
- Empty clusters keep their previous center.
- The assignment step is a single matmul: ``argmin_k ||x - c||^2`` via
  ``x @ c.T``; the update step is a one-hot matmul.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class KmeansResult(NamedTuple):
    centers: jax.Array  # (k, D) float32
    assignments: jax.Array  # (N,) int32; arbitrary for invalid points
    iterations: jax.Array  # () int32
    converged: jax.Array  # () bool


def _assign(data: jax.Array, centers: jax.Array) -> jax.Array:
    """Nearest-center index per point, first-minimum wins. (N,) int32."""
    # ||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2 ; ||x||^2 constant over c.
    # precision=HIGHEST: a reduced-precision f32 matmul (TF32 or one bf16
    # pass, ~1e-3 relative) flips assignments near decision boundaries vs
    # the f64 oracle this module is validated against
    # (tests/test_kmeans.py) — with coordinates up to 255 the dot terms
    # are ~2e5, so the error is O(100) squared-distance units. Same rule
    # as every other f32 matmul in the package.
    dots = jnp.matmul(
        data, centers.T, precision=jax.lax.Precision.HIGHEST
    )  # (N, k)
    c2 = jnp.sum(centers * centers, axis=-1)  # (k,)
    return jnp.argmin(c2[None, :] - 2.0 * dots, axis=-1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("k", "max_iter"))
def lloyd_kmeans(
    data: jax.Array,
    mask: jax.Array,
    k: int,
    *,
    init_order: jax.Array | None = None,
    max_iter: int = 100,
    tol: float = 1e-6,
) -> KmeansResult:
    """Run Lloyd's k-means on masked points.

    Args:
      data: (N, D) float array of points (padded).
      mask: (N,) bool; False entries are padding and ignored.
      k: number of clusters (static).
      init_order: optional (N,) int32 permutation giving the priority order
        for initial-center selection (reference pushes points in a specific
        traversal order; see core/init.py). Defaults to 0..N-1.
      max_iter: iteration cap (static).
      tol: convergence threshold on the max squared center movement.
    """
    data = data.astype(jnp.float32)
    mask = mask.astype(bool)
    n = data.shape[0]

    if init_order is None:
        order = jnp.arange(n, dtype=jnp.int32)
    else:
        order = init_order.astype(jnp.int32)

    # First k valid points in priority order: stable-sort priority-ordered
    # validity so valid points come first, preserving order among them.
    # When fewer than k valid points exist (e.g. a subpalette with no
    # assigned opaque pixels — the reference's cogset would see an empty
    # input), the surplus centers are zeroed: they come out as black
    # entries, matching the reference's all-black initial palette
    # (src/lib.rs:756).
    ordered_mask = mask[order]
    ranks = jnp.argsort(~ordered_mask, stable=True)
    init_idx = order[ranks[:k]]
    rank_valid = jnp.arange(k) < jnp.sum(mask)
    centers0 = jnp.where(rank_valid[:, None], data[init_idx], 0.0)

    maskf = mask.astype(jnp.float32)[:, None]  # (N, 1)

    def update(centers: jax.Array) -> jax.Array:
        assign = _assign(data, centers)
        onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32) * maskf  # (N, k)
        sums = jnp.matmul(
            onehot.T, data, precision=jax.lax.Precision.HIGHEST
        )  # (k, D) — HIGHEST: see _assign
        counts = jnp.sum(onehot, axis=0)[:, None]  # (k, 1)
        means = sums / jnp.maximum(counts, 1.0)
        return jnp.where(counts > 0.0, means, centers)

    def cond(state):
        _, it, shift = state
        return (it < max_iter) & (shift > tol)

    def body(state):
        centers, it, _ = state
        new_centers = update(centers)
        shift = jnp.max(jnp.sum((new_centers - centers) ** 2, axis=-1))
        return new_centers, it + 1, shift

    centers, iters, shift = jax.lax.while_loop(
        cond, body, (centers0, jnp.int32(0), jnp.float32(jnp.inf))
    )
    return KmeansResult(
        centers=centers,
        assignments=_assign(data, centers),
        iterations=iters,
        converged=shift <= tol,
    )
