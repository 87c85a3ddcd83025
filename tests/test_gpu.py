"""Checks that only mean something on an NVIDIA GPU (marked ``gpu``).

They skip elsewhere; on a GPU host run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from gpuradixsort.ops.sort import sort_pairs

from test_chip_smoke import ONE_CARD_SIZES

pytestmark = pytest.mark.gpu


def test_pair_sort_lowers_to_cub(gpu):
    # method="xla" (what "auto" picks) rests on XLA handing the (key, index)
    # sort to CUB's device radix sort.
    keys = jnp.zeros((1 << 20,), jnp.uint32)
    hlo = (
        jax.jit(lambda k: sort_pairs(k, method="xla")[1].data)
        .lower(keys)
        .compile()
        .as_text()
    )
    targets = re.findall(r'custom_call_target="([^"]+)"', hlo)
    assert any("cub" in t.lower() for t in targets), targets


@pytest.mark.parametrize("name", sorted(ONE_CARD_SIZES))
def test_one_card_phase_on_gpu(gpu, name):
    with jax.default_device(gpu):
        chip_smoke.ONE_CARD_PHASES[name](
            np.random.default_rng(5), **ONE_CARD_SIZES[name]
        )
