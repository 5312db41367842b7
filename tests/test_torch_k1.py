"""K1 (the multiplier-error prefill matmul) and the prefill projection of
approx_mult and log_mult, on the CPU.

The CUDA kernels cannot run here; they are held against their plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).  Here:

* the identity the tensor-core route sums truncated products by (16 int8
  slots a k: the exact product, then 15 corrections), in plain PyTorch
  (``vpu_matmul.truncated_slots``) against ``approx_mul`` over the full
  8-bit grid at 0, 2, 4 and 6 dropped bits, and which operands keep every
  slot within int8;
* the mma fragment layout of ``csrc/vpu_matmul.cu``'s ``mma_contract``,
  rendered in numpy: every (weight row, slot) of a k-step and every
  output column is taken exactly once;
* the Mitchell product as an add of float32 bit patterns (the CUDA-core
  contraction's ``mitchell_f``), rendered in numpy, against
  ``mitchell_mul`` over the full 8-bit grid, and its float32 sums exact
  for 256 products;
* the port's prefill emulators against the JAX reference's
  ``_emulate_approx_mult`` and ``_emulate_log_mult`` run eagerly, on
  numpy-seeded inputs: bitwise for approx_mult, and for log_mult within
  2^-20 of sum |products| (the reference's exp2 is inexact at some
  integers; ROADMAP C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ApproxMultParams as JAMP
from repro.configs.base import LogMultParams as JLMP
from repro.core import backends as jbe
from repro_torch.configs.base import ApproxMultParams, LogMultParams
from repro_torch.core import backends as tbe
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.vpu_matmul import int_operand_quantize, truncated_slots

GRID = np.arange(-255, 256, dtype=np.int64)
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
REL_EXP2 = 2.0 ** -20  # the reference's Mitchell products: up to 2^-21 relative off


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("drop", [0, 2, 4, 6])
def test_slot_identity_full_grid(drop):
    """sum_j A'_j(a) B'_j(b) is the truncated product, for every a, b in
    [-255, 255]."""
    a = torch.from_numpy(GRID)[:, None].expand(511, 511)
    b = torch.from_numpy(GRID)[None, :].expand(511, 511)
    ap, bp = truncated_slots(a, b, drop)
    got = (ap * bp).sum(-1)
    want = ref.approx_mul(a.to(torch.float32), b.to(torch.float32), drop).to(torch.int64)
    assert torch.equal(got, want)
    # and over a contraction: the sums of products equal the sums of slots
    rnd = np.random.default_rng(drop)
    x = torch.from_numpy(rnd.integers(-255, 256, (3, 40)))
    w = torch.from_numpy(rnd.integers(-255, 256, (40, 5)))
    xs, ws = truncated_slots(x[:, :, None], w[None, :, :], drop)
    want = ref.elementwise_matmul_ref(x, w, lambda u, v: ref.approx_mul(u, v, drop))
    assert torch.equal((xs * ws).sum((1, 3)).to(torch.float32), want)


@pytest.mark.parametrize("hi,drop,fits", [(127, 4, True), (127, 2, True), (127, 0, True),
                                          (255, 4, False), (127, 6, False)])
def test_slots_fit_int8_only_on_the_tensor_core_route(hi, drop, fits):
    """Operands of at most 7 bits with at most 4 dropped bits give 16 slots
    within int8 (the tensor-core route); 8-bit operands, or 6 dropped bits
    (64 slots), do not, and take the CUDA cores."""
    v = torch.arange(-hi, hi + 1)
    ap, bp = truncated_slots(v[:, None], v[None, :], drop)
    in_s8 = bool(ap.abs().max() <= 127 and bp.abs().max() <= 127) and ap.shape[-1] == 16
    assert in_s8 == fits


def test_fragment_layout_takes_every_slot_and_column_once():
    """mma.m16n8k32.s8 puts k positions 4t..4t+3 (A reg 0, B reg 0) and
    4t+16..4t+19 (A reg 2, B reg 1) in lane t of a group; mma_contract
    fills them from the lane's 8 bytes, slots 8 (t & 1) .. + 7 of weight
    row t / 2 (low word, then high word), in both operands alike.  The
    output: n8 tile j's column q is the warp's column 8 q + j, and a lane's
    accumulators (2 t + h) are columns 16 t + 8 h + j."""
    seen = {}
    for t in range(4):
        for i in range(4):
            for pos, word in ((4 * t + i, 0), (4 * t + 16 + i, 1)):
                seen[pos] = (t >> 1, 8 * (t & 1) + 4 * word + i)
    assert sorted(seen) == list(range(32))
    assert sorted(seen.values()) == [(k, s) for k in range(2) for s in range(16)]
    # the k-step's dot product through the layout equals the logical one
    rnd = np.random.default_rng(0)
    A, B = rnd.integers(-127, 128, (2, 16)), rnd.integers(-127, 128, (2, 16))
    assert sum(A[seen[p]] * B[seen[p]] for p in range(32)) == int((A * B).sum())
    cols = sorted(16 * t + 8 * h + j for t in range(4) for h in range(2) for j in range(8))
    assert cols == list(range(64))
    assert sorted(8 * q + j for q in range(8) for j in range(8)) == list(range(64))


def _mitchell_f(a, b):
    """csrc/vpu_matmul.cu mitchell_op and mitchell_f, in numpy."""
    fa = a.astype(np.float32).view(np.int32).astype(np.int64)
    fb = b.astype(np.float32).view(np.int32).astype(np.int64) - 0x3F800000
    mask = np.where((a != 0) & (b != 0), -1, 0)
    bits = ((fa + fb) & mask) & 0xFFFFFFFF
    return bits.astype(np.uint32).view(np.float32)


def test_mitchell_float_add_full_grid():
    """The Mitchell product as an add of float32 bit patterns, zero
    operands masked, equals mitchell_mul for every a, b in [-255, 255]; 256
    of them sum exactly in float32."""
    a, b = GRID[:, None], GRID[None, :]
    got = _mitchell_f(np.broadcast_to(a, (511, 511)), np.broadcast_to(b, (511, 511)))
    want = ref.mitchell_mul(torch.from_numpy(a.astype(np.float32)),
                            torch.from_numpy(b.astype(np.float32))).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() * 256 < 2 ** 24
    # a chunk of 256 products of the largest magnitudes, summed in float32
    # in order, is the exact integer sum
    rnd = np.random.default_rng(1)
    x, w = rnd.integers(200, 256, 256), rnd.integers(200, 256, 256)
    prods = _mitchell_f(x, w)
    acc = np.float32(0)
    for v in prods:
        acc = np.float32(acc + v)
    assert int(acc) == int(prods.astype(np.int64).sum())


def _inputs(seed, shape, K, N):
    rnd = np.random.default_rng(seed)
    x = (rnd.standard_normal(shape + (K,)) * 1.5).astype(np.float32)
    w = (rnd.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    x[0, 0] = 0.0  # a zero row: its scale is eps
    return x, w


@pytest.mark.parametrize("mul", ["approx_mult", "log_mult"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,K,N", [((2, 9), 70, 45), ((1, 17), 130, 33)])
def test_prefill_emulators_match_reference(mul, dtype, shape, K, N):
    """The port's prefill emulators (on the CPU the plain
    int_operand_matmul_fused_ref, on the card the quantising kernels)
    against the reference's _emulate_approx_mult and _emulate_log_mult run
    eagerly: bitwise for approx_mult; log_mult within the reference's exp2
    error scaled back (2^-20 of sum |xi wi| times the prescale) plus one
    ulp of the output dtype."""
    tdt, jdt = DTYPES[dtype]
    x, w = _inputs(len(shape) * K + N, shape, K, N)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    build.reset_launches()
    if mul == "approx_mult":
        got = tbe._emulate_approx_mult(tx, tw, ApproxMultParams(), None)
        with jax.disable_jit():
            want = jbe._emulate_approx_mult(jx, jw, JAMP(), None)
    else:
        got = tbe._emulate_log_mult(tx, tw, LogMultParams(), None)
        with jax.disable_jit():
            want = jbe._emulate_log_mult(jx, jw, JLMP(), None)
    assert sum(build.LAUNCHES.values()) == 0
    assert got.dtype == tdt and tuple(got.shape) == shape + (N,)
    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if mul == "approx_mult":
        np.testing.assert_array_equal(got, want)
        return
    bits = LogMultParams().bits
    xi, wi, pre = int_operand_quantize(tx, tw, bits)
    bound = REL_EXP2 * (np.abs(xi.double().numpy()) @ np.abs(wi.double().numpy())) \
        * pre.double().numpy()
    ulp = 2.0 ** (-23 if dtype == "float32" else -7) * np.abs(want)
    assert np.all(np.abs(got - want) <= bound + ulp)


@pytest.mark.parametrize("mul", ["approx_mult", "log_mult"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_emulator_is_the_composed_path(mul, dtype):
    """The prefill emulator on the operands themselves is bitwise the path
    it replaces: int_operand_quantize in plain torch, K1's plain version on
    the integers, then (acc * prescale).to(x.dtype)."""
    tdt, _ = DTYPES[dtype]
    x, w = _inputs(3, (2, 5), 64, 24)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    if mul == "approx_mult":
        p = ApproxMultParams()
        got = tbe._emulate_approx_mult(tx, tw, p, None)
        matmul = lambda a, b: ops.approx_mult_matmul(a, b, p.bits, p.perforate)
    else:
        p = LogMultParams()
        got = tbe._emulate_log_mult(tx, tw, p, None)
        matmul = ops.log_matmul
    xi, wi, pre = int_operand_quantize(tx, tw, p.bits)
    acc = matmul(xi.reshape(-1, x.shape[-1]), wi)
    want = (acc.reshape(x.shape[:-1] + (w.shape[-1],)) * pre).to(tdt)
    assert torch.equal(got, want)
