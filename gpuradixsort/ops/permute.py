"""Applying permutations — the stable-scatter / payload-gather layer.

The reference scatters each element to a computed destination with a plain
indexed store (``SortIntermediateData.comp:63-66``) and gathers payload rows
with an indexed load (``SortOriginalData.comp:33-50``).  Both map directly to
XLA: ``scatter_by_destination`` is a unique-index scatter and
``gather_rows`` a gather.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp


def scatter_by_destination(
    dest: jax.Array, values: Sequence[jax.Array]
) -> list[jax.Array]:
    """Realize out[dest[i]] = values[i] for each array in ``values``.

    ``dest`` must be a permutation of 0..N-1 (guaranteed by construction in
    the radix pass: offsets partition the index space and ranks are unique
    within a bucket).
    """
    return [
        jnp.zeros_like(v)
        .at[dest]
        .set(v, unique_indices=True, mode="promise_in_bounds")
        for v in values
    ]


def gather_rows(values: jax.Array, src: jax.Array) -> jax.Array:
    """out[i] = values[src[i]] — payload permutation by gather.

    The ``SortOriginalData.comp:33-50`` analog: after sorting (key, index)
    pairs, payload rows are pulled through the sorted index column.
    """
    return jnp.take(values, src, axis=0, mode="clip")
