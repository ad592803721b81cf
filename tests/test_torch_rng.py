"""gfxexp_torch.core.rng against gfxexp_tpu.core.rng: bit-exact on 1e5 random
uint32 inputs (including values >= 2**31) and on a SampleStream draw
sequence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfxexp_torch.core import rng as trng
from gfxexp_tpu.core import rng as jrng

torch.set_num_threads(1)
N = 100_000


def _u32(seed, k):
    r = np.random.default_rng(seed)
    v = [r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
         for _ in range(k)]
    v[0][:4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]  # the edges
    return v


def _t(x):
    return torch.from_numpy(x.view(np.int32))


def _bits(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("name,k", [("pcg4d", 4), ("pcg3d", 3)])
def test_hash_bit_exact(name, k):
    v = _u32(11 + k, k)
    ref = getattr(jrng, name)(*[jnp.asarray(x) for x in v])
    got = getattr(trng, name)(*[_t(x) for x in v])
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_bits(g), np.asarray(r))


def test_bits_to_unit_float_bit_exact():
    (v,) = _u32(5, 1)
    ref = np.asarray(jrng.bits_to_unit_float(jnp.asarray(v)))
    got = trng.bits_to_unit_float(_t(v)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


def test_sample_stream_sequence_bit_exact():
    """Eleven draws cross three pcg4d evaluations (four draws buffered per
    hash); lanes include values >= 2**31 and the camera stream 0xFFFF."""
    lane = _u32(3, 1)[0][:4096]
    for stream in (1, 0xFFFF):
        js = jrng.SampleStream(jnp.asarray(lane), jnp.uint32(77), stream)
        ts = trng.SampleStream(_t(lane), 77, stream)
        for _ in range(5):
            np.testing.assert_array_equal(ts.next().numpy(),
                                          np.asarray(js.next()))
            a, b = ts.next2()
            ja, jb = js.next2()
            np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(_bits(ts.next_bits()),
                                      np.asarray(js.next_bits()))


def test_int64_inputs_match_int32_bits():
    """Pixel indices arrive as int64 tensors; they hash like their uint32
    bits."""
    v = _u32(9, 4)
    a = trng.pcg4d(*[torch.from_numpy(x.astype(np.int64)) for x in v])
    b = trng.pcg4d(*[_t(x) for x in v])
    for x, y in zip(a, b):
        assert torch.equal(x, y)
