"""K4 as the SC prefill projection (``sc_matmul_quantized``), on the CPU:
the arithmetic of ``csrc/sc_matmul.cu``'s prefill route rendered in plain
torch and numpy, held against the plain version it must equal bit for bit,
and the route's CPU path against the JAX reference's ``_emulate_sc``.

* The in-load planes: the kernel forms v = rnd(w q), q = rnd(g / s), and
  takes the plane that holds v as min(|v|, 1), the other as 0.  For every
  finite bf16 pattern, at several scales and gains, those are
  ``_stream_planes``'s planes.
* The schedule: the kernel builds one word pair a weight (the non-zero
  plane's, the zero plane's being the table row's words of 0), four words
  for the two polarities, activation words likewise, one stream word at a
  time, K split into ranges ORed together.  Rendered here, it is the plain
  version bit for bit, with draws that tie with the values and thresholds
  below 0 (where the zero plane's words are not empty).
* The route's CPU path is the reference's ``_emulate_sc`` bit for bit, the
  reference's draws fed in.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SCParams as JSCParams
from repro.core import backends as jbe
from repro_torch.configs.base import SCParams
from repro_torch.convert import _tensor
from repro_torch.core import backends as tbe
from repro_torch.core.proxy import OPERAND_EPS
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sc_matmul as _sc


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rnd(a: np.ndarray, dtype) -> np.ndarray:
    """float32 values rounded to ``dtype`` (to nearest, ties to even), as
    float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).to(torch.float32).numpy()


def _in_load_planes(v_in: np.ndarray, s: float, gain: float, dtype):
    """The kernel's planes of one operand: q = rnd(rnd(g) / s) (a float32
    quotient, rounded), v = rnd(v_in q), the plane that holds v min(|v|,
    1) (NaN kept) and the other 0, in numpy."""
    g = _rnd(np.float32(gain), dtype)
    q = _rnd(np.float32(g) / np.float32(s), dtype)
    v = _rnd(v_in.astype(np.float32) * q, dtype)
    with np.errstate(invalid="ignore"):
        a = np.where(np.abs(v) > 1, np.float32(1), np.abs(v))
        return np.where(v > 0, a, np.float32(0)), np.where(v < 0, a, np.float32(0))


def _finite_bf16_patterns() -> torch.Tensor:
    """Every finite bfloat16 value, as float32."""
    b = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    b = b.to(torch.float32)
    return b[torch.isfinite(b)]


@pytest.mark.parametrize("gain", [0.25, 3.0])
@pytest.mark.parametrize("top", [1.0, 0.0371, 2.0 ** -30, 3.3895313892515355e38, 0.0])
def test_in_load_planes_for_every_finite_bf16(top, gain):
    """For the bf16 patterns of magnitude at most ``top`` (so max|w| =
    top; 2^-30: below the eps floor, which is then the scale; 0: an
    all-zero weight, whose scale is the eps floor too), as weight
    and as activation: the kernel's in-load planes are ``_stream_planes``'s
    wp, wn (and xp, xn) bit for bit as values.  A gain above 1 drives
    values past 1, where the clamp bites."""
    pats = _finite_bf16_patterns()
    vals = pats[pats.abs() <= torch.tensor(top).to(torch.bfloat16).float()]
    w = vals.to(torch.bfloat16)[:, None]
    x = vals.to(torch.bfloat16)[None, :]
    xp, xn, wp, wn, rescale = tbe._stream_planes(x, w, SCParams(gain=gain))
    eps = float(torch.tensor(OPERAND_EPS, dtype=torch.bfloat16))
    s = max(float(vals.abs().max()), eps)
    assert s == float(torch.tensor(max(top, eps), dtype=torch.bfloat16))
    for got_p, got_n, v_in in ((wp[:, 0], wn[:, 0], w[:, 0]), (xp[0], xn[0], x[0])):
        want_p, want_n = _in_load_planes(v_in.float().numpy(), s, gain, torch.bfloat16)
        np.testing.assert_array_equal(got_p.float().numpy(), want_p)
        np.testing.assert_array_equal(got_n.float().numpy(), want_n)
    if gain * float(vals.abs().max()) / s > 1.5:  # not where the eps floor is the scale
        assert float(wp.float().max()) == 1.0  # the clamp bit
    gg = _rnd(np.float32(gain * gain), torch.bfloat16)  # sx = sw = s here
    with np.errstate(over="ignore"):  # s * s passes float32 at the largest scale: inf both ways
        want = _rnd(_rnd(np.float32(s) * np.float32(s), torch.bfloat16) / gg, torch.bfloat16)
    assert float(rescale) == want


def test_in_load_planes_float32():
    """The same formula in float32 (one rounding per op, none to bf16), on
    random values, zeros, the extremes and values whose v passes 1."""
    rnd = np.random.default_rng(3)
    w = (rnd.standard_normal((300, 40)) * 0.07).astype(np.float32)
    w[0, :4] = [0.0, -0.0, np.abs(w).max(), -np.abs(w).max()]
    x = rnd.standard_normal((5, 300)).astype(np.float32)
    for gain in (0.25, 2.5):
        xp, xn, wp, wn, _ = tbe._stream_planes(torch.from_numpy(x), torch.from_numpy(w),
                                               SCParams(gain=gain))
        for got_p, got_n, v in ((wp, wn, w), (xp, xn, x)):
            s = max(float(np.abs(v).max()), np.float32(OPERAND_EPS))
            want_p, want_n = _in_load_planes(v, s, gain, torch.float32)
            np.testing.assert_array_equal(got_p.numpy(), want_p)
            np.testing.assert_array_equal(got_n.numpy(), want_n)


def _words(rows, p):
    """sc_matmul.cu's row_words in plain torch: for table rows [..., ROW]
    (int32) and probabilities ``p`` [...], p's bucket entry [start, end),
    c = start plus the bucket's thresholds below p (a prefix of them), then
    the mask pair at c: (word against the row's top sequence, word against
    its bottom one)."""
    keys = rows[..., :_sc.KEYS].contiguous().view(torch.float32)
    p = p.to(torch.float32)[..., None]
    half = _sc.bucket_of(p)
    entry = torch.gather(rows[..., _sc.BUCKETS_AT:_sc.BUCKETS_AT + _sc.BUCKETS // 2], -1,
                         half // 2).to(torch.int64) & 0xFFFFFFFF
    e = (entry >> (16 * (half % 2))) & 0xFFFF
    c, end = e & 0xFF, e >> 8
    while True:
        more = (c < end) & (torch.gather(keys, -1, c.clamp(max=_sc.KEYS - 1)) < p)
        if not bool(more.any()):
            break
        c = c + more.to(torch.int64)
    masks = rows[..., _sc.MASKS_AT:_sc.BUCKETS_AT]
    return torch.gather(masks, -1, 2 * c)[..., 0], torch.gather(masks, -1, 2 * c + 1)[..., 0]


def _unit(v):
    """min(|v|, 1), NaN kept (the kernel's unit())."""
    a = v.abs()
    return torch.where(a > 1, torch.ones_like(a), a)


def _k4_render(x, w, gain, ux, uw, n_bits, splits):
    """The prefill route as csrc/sc_matmul.cu runs it: the scale pass
    (maxima floored at eps, q = rnd(g / s), the rescale), then per stream
    word and split of K, one lookup per weight and activation giving the
    words of both polarities, ORed; then PrefillDifference's arithmetic."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).to(torch.float32)
    eps = float(torch.tensor(OPERAND_EPS, dtype=dt))
    sx = max(float(x.float().abs().max()), eps)
    sw = max(float(w.float().abs().max()), eps)
    g, gg = float(torch.tensor(gain, dtype=dt)), float(torch.tensor(gain * gain, dtype=dt))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)
    qx, qw = rnd(f32(g) / f32(sx)), rnd(f32(g) / f32(sw))
    rescale = rnd(rnd(f32(sx) * f32(sw)) / f32(gg))
    K, N = w.shape
    M, W = x.shape[0], n_bits // 32
    tab = _sc.sc_tables_ref(ux, uw).reshape(W, K + 1, _sc.ROW)
    v = rnd(w.float() * qw)            # [K, N]
    xv = rnd(x.float() * qx)           # [M, K]
    cuts = np.linspace(0, K, splits + 1).astype(int)
    cp = torch.zeros((M, N), dtype=torch.int64)
    cn = torch.zeros_like(cp)
    for word in range(W):
        zx = _words(tab[word, K], torch.zeros(()))[0]
        a = _words(tab[word, K].expand(M, K, -1), _unit(xv))[0]
        xt = torch.where(xv < 0, zx, a)
        xb = torch.where(xv > 0, zx, a)
        acc_p = torch.zeros((M, N), dtype=torch.int32)
        acc_n = torch.zeros_like(acc_p)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            part_p, part_n = torch.zeros_like(acc_p), torch.zeros_like(acc_n)
            for k in range(lo, hi):
                zt, zb = _words(tab[word, k], torch.zeros(()))
                at, ab = _words(tab[word, k].expand(N, -1), _unit(v[k]))
                posx = torch.where(v[k] < 0, zt, at)   # wp against port k
                posy = torch.where(v[k] > 0, zb, ab)   # wn against port k + K
                negx = torch.where(v[k] > 0, zt, at)   # wn against port k
                negy = torch.where(v[k] < 0, zb, ab)   # wp against port k + K
                t, b = xt[:, k, None], xb[:, k, None]
                part_p |= (t & posx) | (b & posy)
                part_n |= (t & negx) | (b & negy)
            acc_p |= part_p
            acc_n |= part_n
        cp += ref._popcount(acc_p)
        cn += ref._popcount(acc_n)
    r = ref._div(cp.to(torch.float32), n_bits) - ref._div(cn.to(torch.float32), n_bits)
    return (r * rescale).to(dt)


def _draws_with_ties(rnd, K, n_bits, below_zero: bool):
    """Draws with ties: half the thresholds on a grid of sixteenths (0 and 1
    included), the rest bf16 values; with ``below_zero``, a few thresholds
    below 0, so a zero probability sets bits there."""
    u = rnd.random((2 * K + 1, n_bits)).astype(np.float32)
    u = np.where(rnd.random(u.shape) < 0.5, np.round(u * 16) / 16,
                 _rnd(u, torch.bfloat16)).astype(np.float32)
    u[0, :4] = [0.0, -0.0, 1.0, 0.5]
    if below_zero:
        u[1, :3] = [-0.25, -1.0, -0.0625]
        u[K + 2, 5] = -0.5
        u[-1, 7] = -0.125  # the activation sequence
    return torch.from_numpy(u[-1:]), torch.from_numpy(u[:-1])


@pytest.mark.parametrize("n_bits,splits,dtype,below_zero", [
    (32, 1, torch.bfloat16, False), (32, 3, torch.bfloat16, True),
    (64, 2, torch.float32, True), (96, 4, torch.bfloat16, False), (64, 1, torch.float32, False)])
def test_k4_schedule_matches_plain_version(n_bits, splits, dtype, below_zero):
    """The prefill route's arithmetic (one lookup per weight and
    activation for the words of both polarities, the zero plane's words
    from the row, split K ORed, stream words one at a time) is bitwise the
    plain version, on operands with zeros, +-max|w|, -0.0, values whose
    plane passes 1 (gain 3) or equals a threshold, and draws with ties
    (and thresholds below 0)."""
    rnd = np.random.default_rng(n_bits + splits)
    M, K, N = 5, 9, 24
    x = rnd.standard_normal((M, K)).astype(np.float32)
    w = (rnd.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    w[0, :3] = 0.0
    w[1, 0], w[2, 1] = np.abs(w).max(), -np.abs(w).max()
    w[3, :2] = -0.0
    x[0, :2] = [0.0, -0.0]
    ux, uw = _draws_with_ties(rnd, K, n_bits, below_zero)
    for gain in (0.25, 3.0):
        xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
        got = _k4_render(xt, wt, gain, ux, uw, n_bits, splits)
        want = _sc.sc_matmul_quantized_ref(xt, wt, gain, n_bits, (ux, uw))
        assert float(want.float().abs().max()) > 0
        assert torch.equal(got, want)


def test_k4_schedule_all_zero_weight():
    """An all-zero weight (its scale the eps floor): every plane is 0 and
    every output 0, in the render and the plain version alike."""
    rnd = np.random.default_rng(5)
    x = torch.from_numpy(rnd.standard_normal((4, 6)).astype(np.float32)).to(torch.bfloat16)
    w = torch.zeros((6, 10), dtype=torch.bfloat16)
    ux, uw = _draws_with_ties(rnd, 6, 32, False)
    got = _k4_render(x, w, 0.25, ux, uw, 32, 2)
    want = _sc.sc_matmul_quantized_ref(x, w, 0.25, 32, (ux, uw))
    assert torch.equal(got, want) and not bool(want.float().abs().max() > 0)


def _jax_draws(path, n_ports, n_bits, device):
    """The reference's SC draws for a key path (``PRNGKey(path[0])``, the
    rest folded in, split into (kx, kw), uniforms)."""
    key = jax.random.PRNGKey(path[0])
    for d in path[1:]:
        key = jax.random.fold_in(key, d)
    kx, kw = jax.random.split(key)
    ux = jax.random.uniform(kx, (1, n_bits), dtype=jnp.float32)
    uw = jax.random.uniform(kw, (n_ports, n_bits), dtype=jnp.float32)
    return _tensor(np.asarray(ux), device), _tensor(np.asarray(uw), device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,gain,bits", [(6, 24, 40, 0.25, 32), (3, 16, 9, 2.0, 64)])
def test_prefill_route_cpu_matches_reference_emulator(dtype, M, K, N, gain, bits):
    """``ops.sc_matmul_quantized`` on CPU tensors (and ``_emulate_sc``,
    which calls it) against the reference's ``_emulate_sc`` run eagerly
    with the same key, its draws fed in: bitwise, float32 and bf16."""
    rnd = np.random.default_rng(M + K + N + bits)
    x = rnd.standard_normal((M, K)).astype(np.float32) * 1.5
    w = (rnd.standard_normal((K, N)) * 0.2).astype(np.float32)
    w[0, 0] = 0.0
    jx, jw = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (x, w))
    tx, tw = (_tensor(np.asarray(a), "cpu") for a in (jx, jw))
    with jax.disable_jit():
        want = jbe._emulate_sc(jx, jw, JSCParams(bits=bits, gain=gain), jax.random.PRNGKey(7))
    want = np.asarray(want.astype(jnp.float32))
    draws = _jax_draws((7,), 2 * K, bits, "cpu")
    got = ops.sc_matmul_quantized(tx, tw, gain, bits, draws)
    assert got.dtype == getattr(torch, dtype) and got.shape == (M, N)
    np.testing.assert_array_equal(got.float().numpy(), want)
    rng = functools.partial(_jax_draws, (7,))
    emulated = tbe._emulate_sc(tx.reshape(1, M, K), tw, SCParams(bits=bits, gain=gain), rng)
    np.testing.assert_array_equal(emulated.reshape(M, N).float().numpy(), want)
    assert float(np.abs(want).max()) > 0
