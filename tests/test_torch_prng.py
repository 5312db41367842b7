"""The port's counter-based generator (``repro_torch.kernels.prng``)
against ``jax.random``, on the CPU, and the SC draws it gives the port.

Contract: bitwise.  threefry2x32 is integer arithmetic, and the uniform's
float is built from its bits by one exact subtraction, so the port's keys
and draws are JAX's bit for bit (JAX 0.9 with ``jax_default_prng_impl =
threefry2x32`` and ``jax_threefry_partitionable``, 64-bit types off).
Then the port's own SC draws are the reference's for every key path, so
an SC projection needs no fed draws to match the reference, and 512-bit
streams (beyond the kernels' old 256-bit cap) go through the plain path.
"""
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import Backend as JBackend
from repro.configs.base import SCParams as JSCParams
from repro.configs.base import TrainMode as JMode
from repro.core import backends as jbe
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro.kernels import ref as jref
from repro.kernels.sc_matmul import sc_matmul_packed as j_sc
from repro_torch.configs.base import ApproxConfig as TApprox
from repro_torch.configs.base import Backend as TBackend
from repro_torch.configs.base import SCParams
from repro_torch.configs.base import TrainMode as TMode
from repro_torch.core import backends as tbe
from repro_torch.core.approx_linear import ApproxCtx as TCtx
from repro_torch.core.approx_linear import dense as t_dense
from repro_torch.kernels import ops, prng
from test_torch_sc_analog import jax_draws

SEEDS = [0, 7, 12345, 2**31 - 1, 2**32 + 5, -1]
# engine-like key paths: (seed, tick[, layer], crc32(site) & 0x7FFFFFFF),
# with site values near 2**31 and the LM head's 2**20 fold
SITES = ("attn_q", "mlp_down", "lm_head")
PATHS = [(0, 1, zlib.crc32(s.encode()) & 0x7FFFFFFF) for s in SITES] + [
    (3, 17, 5, zlib.crc32(b"mlp_up") & 0x7FFFFFFF),
    (0, 2, 2**20, zlib.crc32(b"lm_head") & 0x7FFFFFFF),
    (9, 0, 2**31 - 1),
    (1, 2**31 - 2, 35, 2**31 - 3),
    (2**31 - 1, 2**32 - 1),
]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.numpy().view(np.uint32)
    return np.asarray(a).view(np.uint32)


def _jax_key(path):
    key = jax.random.PRNGKey(path[0])
    for d in path[1:]:
        key = jax.random.fold_in(key, d)
    return key


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_split_bitwise(seed):
    """PRNGKey, fold_in (small, 2**20, near and at 2**32 - 1) and split
    (2 and 5 ways) equal JAX's; the two documented values hold."""
    assert prng.prng_key(7) == (0, 7)
    assert prng.fold_in(prng.prng_key(7), 3) == (276534068, 1641862660)
    key = prng.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(key, np.uint32), _bits(jax.random.PRNGKey(seed)))
    for d in (0, 3, 2**20, 2**31 - 1, 2**31 + 5, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(prng.fold_in(key, d), np.uint32),
                                      _bits(jax.random.fold_in(jax.random.PRNGKey(seed), d)))
    for num in (2, 5):
        want = _bits(jax.random.split(jax.random.PRNGKey(seed), num))
        np.testing.assert_array_equal(np.asarray(prng.split(key, num), np.uint32), want)
    with pytest.raises(ValueError):
        prng.fold_in(key, -3)


@pytest.mark.parametrize("n_bits", [32, 64, 256, 512])
@pytest.mark.parametrize("n_ports", [1, 7, 129])
def test_uniform_bitwise(n_bits, n_ports):
    """float32 uniform on the partitionable counter layout, at SC stream
    lengths and odd port counts, equals jax.random.uniform bit for bit."""
    key = (0, 7)
    jkey = jax.random.PRNGKey(7)
    for shape in ((1, n_bits), (n_ports, n_bits)):
        got = prng.uniform(key, shape)
        want = jax.random.uniform(jkey, shape, dtype=jnp.float32)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


@pytest.mark.parametrize("path", PATHS, ids=[str(i) for i in range(len(PATHS))])
@pytest.mark.parametrize("n_bits,n_ports", [(32, 8), (64, 13), (256, 4), (512, 9)])
def test_sc_draws_are_the_reference_draws(path, n_bits, n_ports):
    """``ops.sc_draws`` on the CPU equals the JAX draws the parity tests
    feed (``test_torch_sc_analog.jax_draws``): the path's key split into
    (kx, kw), uniform of each."""
    key = _jax_key(path)
    np.testing.assert_array_equal(np.asarray(prng.key_of_path(path), np.uint32), _bits(key))
    ux, uw = ops.sc_draws(path, n_ports, n_bits, "cpu")
    jx, jw = jax_draws(path, n_ports, n_bits, "cpu")
    assert tuple(ux.shape) == (1, n_bits) and tuple(uw.shape) == (n_ports, n_bits)
    np.testing.assert_array_equal(_bits(ux), _bits(jx))
    np.testing.assert_array_equal(_bits(uw), _bits(jw))


def test_path_words_are_what_the_kernel_reads():
    """The kernel's int32 words: the seed mod 2**32, then each folded
    uint32, two's complement; a value outside uint32 raises."""
    assert prng.path_words((5, 2**31 + 1, 3)) == [5, 2**31 + 1 - 2**32, 3]
    assert prng.path_words((-1, 0)) == [-1, 0]
    assert prng.path_words((2**32 + 5,)) == [5]
    with pytest.raises(ValueError):
        prng.path_words((0, 2**32))
    with pytest.raises(ValueError):
        ops.sc_draws((0, 1), 4, 32, "meta")


def _operands(seed, K=24, N=40):
    rnd = np.random.default_rng(seed)
    x = rnd.standard_normal((2, 3, K)).astype(np.float32)
    w = (rnd.standard_normal((K, N)) * 0.2).astype(np.float32)
    return (jnp.asarray(x), torch.from_numpy(x)), (jnp.asarray(w), torch.from_numpy(w))


@pytest.mark.parametrize("fused", [False, True])
def test_sc_dense_own_draws_equal_fed_draws_and_reference(fused):
    """An SC dense() projection with the port's own draws (no ``draws=``
    override) equals the same projection fed the JAX draws, and the
    reference's, bit for bit."""
    (jx, tx), (jw, tw) = _operands(3, K=32, N=48)
    ta = TApprox(backend=TBackend("sc"), mode=TMode.MODEL)
    own = t_dense(tx, tw, site="mlp_up", ctx=TCtx(cfg=ta, fused=fused, rng=(9, 4)))
    fed = t_dense(tx, tw, site="mlp_up", ctx=TCtx(cfg=ta, fused=fused, rng=(9, 4),
                                                  draws=jax_draws))
    np.testing.assert_array_equal(_bits(own), _bits(fed))
    ja = JApprox(backend=JBackend("sc"), mode=JMode.MODEL)
    with jax.disable_jit():
        want = j_dense(jx, jw, site="mlp_up",
                       ctx=JCtx(cfg=ja, rng=jax.random.fold_in(jax.random.PRNGKey(9), 4),
                                fused=fused))
    np.testing.assert_array_equal(_bits(own), _bits(want))


@pytest.mark.parametrize("M,K,N", [(3, 12, 17), (9, 40, 8)])
def test_sc_512_bit_streams_plain_path_matches_reference(M, K, N):
    """C2 on the CPU: the plain K4 at 512 bits (16 words, twice the old
    cap) against the Pallas kernel in interpret mode on the reference's
    own packing, with the port's draws for one path."""
    L = 512
    rnd = np.random.default_rng(M * K + N)
    x = rnd.random((M, 2 * K)).astype(np.float32)
    x[rnd.random(x.shape) < 0.3] = 0.0
    wa, wb = (rnd.random((K, N)).astype(np.float32) for _ in range(2))
    ux, uw = ops.sc_draws((4, M, K), 2 * K, L, "cpu")
    xbits = jref.sc_pack_streams(jnp.asarray(x), jnp.asarray(ux.numpy()))
    wbits = jref.sc_pack_streams(jnp.concatenate([wa, wb]), jnp.asarray(uw.numpy())[:, None, :])
    want = np.asarray(j_sc(xbits, wbits, L, interpret=True, block_m=8, block_n=16, block_k=16))
    t = torch.from_numpy
    got = ops.sc_matmul(t(x), (t(wa), t(wb)), L, (ux, uw)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fused", [False, True])
def test_sc_512_bit_emulator_matches_reference(fused):
    """The SC emulators at 512-bit streams, with the port's own draws for
    the key, against the reference's emulators run eagerly on the same
    key: bitwise."""
    (jx, tx), (jw, tw) = _operands(8, K=8, N=16)
    jfn = jbe._fused_emulate_sc if fused else jbe._emulate_sc
    tfn = tbe._fused_emulate_sc if fused else tbe._emulate_sc
    extra = ({},) if fused else ()
    with jax.disable_jit():
        want = jfn(jx, jw, JSCParams(bits=512), jax.random.PRNGKey(6), *extra)
    got = tfn(tx, tw, SCParams(bits=512), functools.partial(ops.sc_draws, (6,)), *extra)
    np.testing.assert_array_equal(_bits(got), _bits(want))
