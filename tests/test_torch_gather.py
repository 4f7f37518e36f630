"""K5a/K5b's plain versions and the take_rows autograd Function against the
reference's one-hot Pallas gather in interpret mode (tests/test_gather.py's
cases).

Forward rows are copies, so bit-equal.  The backward is a sum of
cotangent rows; the reference contracts a one-hot on the MXU block by
block, the port adds rows with index_add_, so the order of the sums
differs: rtol/atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.ops.gather import take_rows as j_take_rows
from physically_based_renderer_tpu_torch.ops import gather

torch.set_num_threads(1)


def _table_idx(t, w, n=1000, lo=0, seed=0):
    rng = np.random.default_rng(seed)
    table = (rng.normal(size=(t, w)) * 1e3).astype(np.float32)
    idx = rng.integers(lo, t, n).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("t,w", [(36, 8), (64, 52), (513, 16)])
def test_forward_bit_equal_to_reference_kernel(t, w):
    table, idx = _table_idx(t, w)
    want = np.asarray(j_take_rows(jnp.asarray(table), jnp.asarray(idx),
                                  force="interpret"))
    got = gather.take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        gather.take_rows_plain(torch.from_numpy(table),
                               torch.from_numpy(idx)).numpy(), want)


def test_out_of_range_rows_are_zero():
    table = np.arange(12.0, dtype=np.float32).reshape(4, 3)
    idx = np.array([-1, 0, 3, 4, 100, -7], np.int32)
    want = np.asarray(j_take_rows(jnp.asarray(table), jnp.asarray(idx),
                                  force="interpret"))
    got = gather.take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0] == 0).all() and (got[3] == 0).all()


@pytest.mark.parametrize("t,w,n", [(40, 8, 300), (36, 8, 1000),
                                   (64, 52, 1000), (513, 16, 1000)])
def test_gradient_matches_reference_kernel(t, w, n):
    """jax.grad through the reference's custom_vjp (its K5b in interpret
    mode) against the port's autograd Function (K5b's plain version),
    with indices outside [0, T) on both sides."""
    table, _ = _table_idx(t, w, seed=1)
    rng = np.random.default_rng(2)
    idx = rng.integers(-2, t + 2, n).astype(np.int32)
    wgt = rng.normal(size=(n, w)).astype(np.float32)

    def loss(tab):
        return jnp.sum(j_take_rows(tab, jnp.asarray(idx), force="interpret")
                       * wgt)

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    tab = torch.from_numpy(table).requires_grad_(True)
    (gather.take_rows(tab, torch.from_numpy(idx))
     * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(tab.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    plain = gather.take_rows_bwd_plain(torch.from_numpy(idx),
                                       torch.from_numpy(wgt), t)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-6, atol=1e-6)


def test_native_route_has_the_same_gradient():
    """take_rows (K5b's plain version in the backward) against the plain
    torch gather under torch's own autograd."""
    table, _ = _table_idx(40, 8, seed=3)
    idx = torch.from_numpy(np.random.default_rng(4).integers(
        -3, 43, 500).astype(np.int32))
    wgt = torch.from_numpy(np.random.default_rng(5).normal(
        size=(500, 8)).astype(np.float32))
    grads = []
    for fn in (gather.take_rows, gather.take_rows_plain):
        tab = torch.from_numpy(table).requires_grad_(True)
        (fn(tab, idx) * wgt).sum().backward()
        grads.append(tab.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6, atol=1e-6)


def test_take_values_ragged_and_int64():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(17,)).astype(np.float32)
    for dtype in (np.int32, np.int64):
        idx = rng.integers(-2, 20, 1_003).astype(dtype)
        got = gather.take_values(torch.from_numpy(table),
                                 torch.from_numpy(idx))
        want = np.where((idx >= 0) & (idx < 17), table[np.clip(idx, 0, 16)],
                        0.0)
        np.testing.assert_array_equal(got.numpy(), want)
    tab = torch.from_numpy(table).requires_grad_(True)
    idx = torch.from_numpy(rng.integers(0, 17, 1_003))      # int64
    gather.take_values(tab, idx).sum().backward()
    np.testing.assert_array_equal(
        tab.grad.numpy(), np.bincount(idx.numpy(), minlength=17))


def test_cpu_tensors_run_the_plain_versions():
    before = (gather.LAUNCHES_FWD, gather.LAUNCHES_BWD)
    tab = torch.ones((5, 3), requires_grad=True)
    gather.take_rows(tab, torch.tensor([0, 4, 9])).sum().backward()
    assert (gather.LAUNCHES_FWD, gather.LAUNCHES_BWD) == before
    np.testing.assert_array_equal(tab.grad.numpy()[:, 0], [1, 0, 0, 0, 1])


def test_take_rows_rejects_bad_shapes_and_devices():
    table, idx = torch.ones((3, 2)), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather.take_rows(table, idx[:, None])
    with pytest.raises(ValueError):
        gather.take_rows(table[:, 0], idx)
    with pytest.raises(ValueError):
        gather.take_rows(table.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError):
        gather.take_rows(table, idx.to("meta"))
