"""Port's filtered ranking vs the JAX package's, with deliberate ties."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from redgnn_tpu.ops import ranking as jr
from redgnn_tpu_torch.ops import ranking as tr


def make_case(rng, b=6, n=40):
    scores = rng.normal(size=(b, n)).astype(np.float32)
    # unreached entities share score 0, plus ties among reached ones
    scores = np.where(rng.random((b, n)) < 0.4, 0.0, scores)
    scores = np.where(rng.random((b, n)) < 0.15, 0.5, scores)
    scores = scores.astype(np.float32)
    labels = (rng.random((b, n)) < 0.1).astype(np.float32)
    labels[:, 0] = 1.0
    filters = np.clip(labels + (rng.random((b, n)) < 0.15), 0, 1)
    return scores, labels, filters.astype(np.float32)


def test_row_ranks_equal(rng):
    s = make_case(rng, b=1, n=50)[0][0]
    for jf, tf in ((jr._avg_rank_desc, tr._avg_rank_desc),
                   (jr._min_rank_desc, tr._min_rank_desc)):
        np.testing.assert_array_equal(tf(torch.from_numpy(s)).numpy(),
                                      np.asarray(jf(jnp.asarray(s))))


@pytest.mark.parametrize("b,n", [(6, 40), (3, 17), (8, 64)])
def test_filtered_rank_all_equal(rng, b, n):
    scores, _, filters = make_case(rng, b, n)
    want = jr.filtered_rank_all(jnp.asarray(scores), jnp.asarray(filters))
    got = tr.filtered_rank_all(torch.from_numpy(scores),
                               torch.from_numpy(filters))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rank_metric_sums_equal(rng):
    scores, labels, filters = make_case(rng, b=10, n=60)
    labels[7:] = 0.0  # padded queries contribute nothing
    want = jax.device_get(jr.rank_metric_sums(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(filters)))
    got = tr.rank_metric_sums(torch.from_numpy(scores),
                              torch.from_numpy(labels),
                              torch.from_numpy(filters))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
