"""The port's threefry RNG against jax.random, bit for bit."""

import ctypes
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core import rng as jrng
from physically_based_renderer_tpu_torch.core import rng

torch.set_num_threads(1)


def _data(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys))


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def test_threefry_known_answer():
    """Threefry-2x32 (20 rounds) test vector of Salmon et al. (Random123)."""
    w0, w1 = rng.threefry2x32(torch.tensor(0x13198A2E),
                              torch.tensor(0x03707344),
                              torch.tensor(0x243F6A88),
                              torch.tensor(0x85A308D3))
    assert (int(w0), int(w1)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, -123456])
def test_key_matches_jax(seed):
    np.testing.assert_array_equal(rng.key(seed).numpy(),
                                  _data(jax.random.key(seed)))


def test_key_rejects_wide_seed():
    with pytest.raises(ValueError):
        rng.key(2**31)


@pytest.mark.parametrize("seed", [0, 7])
def test_split_matches_jax(seed):
    ref = _data(jax.random.split(jax.random.key(seed), 1000))
    np.testing.assert_array_equal(rng.split(rng.key(seed), 1000).numpy(), ref)


def test_fold_in_matches_jax_on_many_keys():
    keys = jax.random.split(jax.random.key(3), 1000)
    data = np.random.default_rng(0).integers(0, 2**31 - 1, 1000)
    ref = _data(jax.vmap(jax.random.fold_in)(keys, jnp.asarray(data)))
    got = rng.fold_in(torch.from_numpy(_data(keys).astype(np.int64)),
                      torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("data", [0, 1, 5, 2**31 - 1])
def test_fold_in_scalar_matches_jax(data):
    ref = _data(jax.random.fold_in(jax.random.key(11), data))
    np.testing.assert_array_equal(rng.fold_in(rng.key(11), data).numpy(), ref)


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4)])
def test_uniform_matches_jax(shape):
    ref = jax.random.uniform(jax.random.key(5), shape, jnp.float32)
    got = rng.uniform(rng.key(5), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


def test_ray_keys_match_jax():
    sample_key = jax.random.split(jax.random.key(9), 4)[2]
    pix = np.arange(0, 4096, 3)
    ref = _data(jrng.ray_keys(sample_key, jnp.asarray(pix)))
    got = rng.ray_keys(torch.from_numpy(_data(sample_key).astype(np.int64)),
                       torch.from_numpy(pix))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("stream,m", [
    (rng.STREAM_PIXEL_JITTER, 2), (rng.STREAM_BSDF, 3),
    (rng.STREAM_LIGHT, 5), (rng.STREAM_RR, 1)])
@pytest.mark.parametrize("bounce", [0, 3])
def test_ray_uniform_matches_jax(stream, m, bounce):
    keys = jrng.ray_keys(jax.random.key(2), jnp.arange(1000))
    ref = jrng.ray_uniform(keys, bounce, stream, m)
    got = rng.ray_uniform(torch.from_numpy(_data(keys).astype(np.int64)),
                          bounce, stream, m)
    assert tuple(got.shape) == (1000, m)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


def test_stream_ids_match_reference():
    for name in ("STREAM_PIXEL_JITTER", "STREAM_BSDF", "STREAM_LIGHT",
                 "STREAM_RR"):
        assert getattr(rng, name) == getattr(jrng, name)


# --- the kernel's wrappers, on the CPU ---------------------------------------

def test_cpu_calls_take_the_plain_version(monkeypatch):
    """On CPU tensors nothing launches and the kernel library is never
    loaded."""
    from physically_based_renderer_tpu_torch.ops import cuda_lib

    def refuse():
        raise AssertionError("the kernel library was loaded for a CPU call")

    monkeypatch.setattr(cuda_lib, "library", refuse)
    assert rng.LAUNCHES == 0
    k = rng.key(5)
    keys = rng.ray_keys(rng.split(k, 3)[1], torch.arange(40))
    rng.fold_in(keys, 3)
    rng.ray_uniform(keys, 1, rng.STREAM_LIGHT, 5)
    rng.random_bits(keys, 2)
    rng.uniform(k, (4, 2))
    rng.threefry2x32(k[0], k[1], torch.tensor(0), torch.tensor(1))
    assert rng.LAUNCHES == 0


def test_other_devices_raise():
    keys = torch.zeros(4, 2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rng.fold_in(keys, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        rng.ray_uniform(keys, 0, rng.STREAM_BSDF, 3)


def _mem(ptr, n, ctype=ctypes.c_longlong):
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * n).from_address(ptr)))


class _StandIn:
    """csrc/threefry.cu's C entries as the plain version, on the memory the
    wrappers hand them: what each entry reads (steps, values, iota) and
    where it writes, so that the wrappers' layouts are tested here."""

    def pbr_threefry_words(self, keys, key_step, x0s, x0_step, x0_value, x1s,
                           x1_step, x1_value, x1_iota, n, out, stream):
        i = torch.arange(n)

        def word(ptr, step, value, iota=0):
            if ptr:
                return _mem(ptr, n if step else 1)[i if step else 0] & rng.MASK
            return (value + iota * i) & rng.MASK

        k = _mem(keys, 2 * (n if key_step else 1)).view(-1, 2)[
            i * key_step]
        w0, w1 = rng.threefry2x32_plain(k[:, 0], k[:, 1],
                                         word(x0s, x0_step, x0_value),
                                         word(x1s, x1_step, x1_value, x1_iota))
        _mem(out, 2 * n).view(n, 2).copy_(torch.stack([w0, w1], -1))
        return 0

    @staticmethod
    def _bits(k, m):
        w0, w1 = rng.threefry2x32_plain(k[:, :1], k[:, 1:], 0,
                                         torch.arange(m))
        return w0 ^ w1

    def pbr_threefry_ray_uniform(self, keys, n, bounce, stream_id, m, out,
                                 stream):
        k = _mem(keys, 2 * n).view(n, 2)
        for x in (bounce, stream_id):
            k = torch.stack(rng.threefry2x32_plain(
                k[:, 0], k[:, 1], 0, torch.tensor(x)), -1)
        _mem(out, n * m, ctypes.c_float).view(n, m).copy_(
            rng.bits_to_uniform(self._bits(k, m)))
        return 0

    def pbr_threefry_bits(self, keys, n_keys, m, uniform, out, stream):
        bits = self._bits(_mem(keys, 2 * n_keys).view(n_keys, 2), m)
        if uniform:
            _mem(out, n_keys * m, ctypes.c_float).copy_(
                rng.bits_to_uniform(bits).reshape(-1))
        else:
            _mem(out, n_keys * m).copy_(bits.reshape(-1))
        return 0


_KEYS = rng.split(rng.key(3), 1000)
_DATA = torch.from_numpy(
    np.random.default_rng(1).integers(-2**40, 2**40, 1000))
_LAYOUTS = {
    "fold_in one key, scalar": (rng.fold_in, rng.key(11), 0x5EED),
    "fold_in keys, scalar": (rng.fold_in, _KEYS, 7),
    "fold_in keys, per-key data": (rng.fold_in, _KEYS, _DATA),
    "fold_in keys, one-element data": (rng.fold_in, _KEYS, _DATA[:1]),
    "fold_in one key, int32 data": (rng.fold_in, rng.key(11),
                                    torch.arange(300, dtype=torch.int32)),
    "fold_in broadcast [10, 1] x [7]": (
        rng.fold_in, _KEYS[:10].reshape(10, 1, 2), torch.arange(7)),
    "split one key": (rng.split, rng.key(11), 777),
    "split one key [1, 1, 2]": (rng.split, rng.key(11).reshape(1, 1, 2), 9),
    "split 5 keys into 5": (rng.split, _KEYS[:5], 5),
    "ray_keys N=1": (rng.ray_keys, rng.key(11), torch.tensor([123_457])),
    "ray_keys N=1000": (rng.ray_keys, rng.key(11), torch.arange(0, 3000, 3)),
    "ray_uniform m=5": (rng.ray_uniform, _KEYS, 3, rng.STREAM_LIGHT, 5),
    "ray_uniform m=1": (rng.ray_uniform, _KEYS, 0, rng.STREAM_RR, 1),
    "random_bits keys": (rng.random_bits, _KEYS[:30], 7),
    "uniform one key": (rng.uniform, rng.key(11), (3, 5, 2)),
    "threefry2x32 known answer": (
        rng.threefry2x32, torch.tensor(0x13198A2E), torch.tensor(0x03707344),
        torch.tensor(0x243F6A88), torch.tensor(0x85A308D3)),
}


@pytest.mark.parametrize("case", list(_LAYOUTS))
def test_kernel_wrappers_hand_the_kernel_what_the_plain_version_computes(
        monkeypatch, case):
    """Each wrapper on a tensor taken as the card's, with the library
    replaced by `_StandIn`: one launch, the plain version's result."""
    from physically_based_renderer_tpu_torch.ops import cuda_lib
    fn, *args = _LAYOUTS[case]
    plain = fn(*args)
    monkeypatch.setattr(rng, "_on_card", lambda t: True)
    monkeypatch.setattr(cuda_lib, "library", _StandIn)
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(rng, "LAUNCHES", 0)
    got = fn(*args)
    assert rng.LAUNCHES == 1
    for g, p in zip(*((got, plain) if isinstance(got, tuple)
                      else ((got,), (plain,)))):
        assert g.dtype == p.dtype and g.shape == p.shape
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.float32
                           else g, p.view(torch.int32)
                           if p.dtype == torch.float32 else p)


@pytest.mark.parametrize("shapes", [[(3, 1), (7,), ()], [(0,), (1,)], [()],
                                    [(1000,), (1000,)], [(10, 1), (1, 7)],
                                    [(2, 1, 4), (5, 1)]])
def test_kernel_broadcast_matches_torch(shapes):
    assert rng._broadcast(shapes) == tuple(torch.broadcast_shapes(*shapes))


def test_kernel_broadcast_refuses_what_torch_refuses():
    with pytest.raises(ValueError, match="do not broadcast"):
        rng._broadcast([(3,), (4,)])


def test_kernel_wrappers_import_nothing_heavy():
    """The wrappers' first call imports no sympy (torch.broadcast_shapes
    does, seconds of a process's first frame)."""
    code = (
        "import sys, torch\n"
        "from physically_based_renderer_tpu_torch.core import rng\n"
        "rng._broadcast([(3, 1), (7,)])\n"
        "print('sympy' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
