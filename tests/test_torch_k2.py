"""K2 on the operands themselves (the multiplier-error decode matmul with
the operand quantisation taken in), on the CPU.

The CUDA kernel cannot run here; it is held against its plain version on
the card (tests/test_torch_gpu.py, chip_smoke.py).  Here:

* the plain version, :func:`repro_torch.kernels.vpu_matmul.
  int_operand_matmul_fused_ref`, against the composed path it replaces
  (``_int_operand_quantize``, then K2's plain version on the integers)
  and against the JAX reference's fused emulator run eagerly;
* the kernel's own arithmetic, rendered in numpy: its quantisation
  (correctly rounded float32 division, bf16 rounding, the 1.5 * 2^23 add
  that rounds half to even) over every bf16 value, and its product
  formulas over the full 8-bit grids;
* ``dense()`` in bf16 through the fused and composed paths against the
  reference's eager ``dense()``.

Edge operands: all-zero rows (the scale floors at eps), values that land
exactly on k + 0.5 after scaling, +-0.0, ragged K and N.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ApproxConfig as JApprox
from repro.configs.base import ApproxMultParams as JAMP
from repro.configs.base import Backend as JBackend
from repro.configs.base import LogMultParams as JLMP
from repro.configs.base import TrainMode as JMode
from repro.core import backends as jbe
from repro.core.approx_linear import ApproxCtx as JCtx
from repro.core.approx_linear import dense as j_dense
from repro_torch.configs.base import ApproxConfig, ApproxMultParams, Backend, LogMultParams
from repro_torch.configs.base import TrainMode
from repro_torch.core import backends as tbe
from repro_torch.core.approx_linear import ApproxCtx, dense
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.vpu_matmul import (
    int_operand_matmul_fused_ref,
    int_operand_quantize,
    plain_multiplier,
)

# (multiplier, bits, perforate): the backends' defaults
MULS = {"approx_mult": (7, 2), "log_mult": (8, 0)}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
EPI_CASES = ["none", "gain_add", "add_only", "correction", "all"]
# the reference's Mitchell products are off by up to 2^-21 relative where
# its exp2 is inexact (tests/test_torch_kernels.py)
REL_EXP2 = 2.0 ** -20


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("REPRO_KERNELS", "ref")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _edge_operands(rnd, M, K, N):
    """Activations and weights with the edge cases: row 0 of x all zero
    (its scale is eps), row 1 and some weights at sx / sw times 1/2, 1/4,
    3/4 (k + 0.5 after scaling), +-0.0 entries."""
    x = rnd.standard_normal((M, K)).astype(np.float32) * 1.5
    w = (rnd.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    x[0] = 0.0
    x[1, :8] = np.float32(2.0) * np.asarray([1, 0.5, -0.5, 0.25, -0.75, 0.75, -0.25, 0.125],
                                            np.float32)
    x[1, 8:] = np.clip(x[1, 8:], -1.9, 1.9)
    x[2, :3] = [0.0, -0.0, 0.0]
    x[2, 3] = -0.0
    sw = np.abs(w).max()
    w[0, :6] = sw * np.asarray([0.5, -0.5, 0.25, -0.75, 0.0, -0.0], np.float32)
    w[:, N - 1] = -0.0
    return x, w


def _epi(case, rnd, N):
    gain = (1.0 + 0.05 * rnd.standard_normal(N)).astype(np.float32)
    add = (0.02 * rnd.standard_normal(N)).astype(np.float32)
    coeffs = np.asarray([0.01, -0.02, 0.003, -0.0004], np.float32)
    return {
        "none": {},
        "gain_add": {"colgain": gain, "coladd": add},
        "add_only": {"coladd": add},
        "correction": {"mean_coeffs": coeffs, "mean_scale": np.float32(1.7)},
        "all": {"colgain": gain, "coladd": add, "mean_coeffs": coeffs,
                "mean_scale": np.float32(1.7)},
    }[case]


def _to(epi, tdt, jdt):
    """The epilogue in each framework: vectors in the operand dtype, the
    correction in float32."""
    t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.float32 if k.startswith("mean") else tdt) for k, v in epi.items()}
    j = {k: jnp.asarray(v).astype(jnp.float32 if k.startswith("mean") else jdt)
         for k, v in epi.items()}
    return t, j


@pytest.mark.parametrize("case", EPI_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mul", list(MULS))
def test_plain_version_matches_composed_path_and_reference(mul, dtype, case):
    """The new plain version is bitwise the composed path it replaces (the
    operand quantisation, then K2's plain version on the integers), and
    matches the reference's fused emulator run eagerly: bitwise for
    approx_mult; log_mult within the reference's exp2 error scaled back
    (2^-20 of sum |xi wi| times the prescale) plus one ulp of the output
    dtype."""
    M, K, N = 5, 70, 45
    tdt, jdt = DTYPES[dtype]
    bits, perforate = MULS[mul]
    rnd = np.random.default_rng(EPI_CASES.index(case) + 10 * list(DTYPES).index(dtype))
    x, w = _edge_operands(rnd, M, K, N)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    tepi, jepi = _to(_epi(case, rnd, N), tdt, jdt)

    got = int_operand_matmul_fused_ref(tx, tw, bits, plain_multiplier(mul, 2 * perforate),
                                       tepi, tdt)
    if mul == "approx_mult":
        via_ops = ops.approx_mult_matmul_quantized(tx, tw, bits, perforate, tepi, tdt)
        xi, wi, pre = int_operand_quantize(tx, tw, bits)
        composed = ops.approx_mult_matmul_fused(xi, wi, bits, perforate, pre, tepi, tdt)
        fused_emulate = tbe._fused_emulate_approx_mult(tx, tw, ApproxMultParams(), None, tepi)
        with jax.disable_jit():
            want = jbe._fused_emulate_approx_mult(jx, jw, JAMP(), None, jepi)
    else:
        via_ops = ops.log_matmul_quantized(tx, tw, bits, tepi, tdt)
        xi, wi, pre = int_operand_quantize(tx, tw, bits)
        composed = ops.log_matmul_fused(xi, wi, pre, tepi, tdt)
        fused_emulate = tbe._fused_emulate_log_mult(tx, tw, LogMultParams(), None, tepi)
        with jax.disable_jit():
            want = jbe._fused_emulate_log_mult(jx, jw, JLMP(), None, jepi)
    assert got.dtype == tdt
    for other in (via_ops, composed, fused_emulate):
        torch.testing.assert_close(other, got, rtol=0, atol=0)
    # the edge cases are there: a zero row, and x[1, 1] = sx / 2 on a tie
    # (63.5 or 127.5) rounded to even
    levels = (1 << bits) - 1
    assert float(xi[0].abs().max()) == 0.0
    assert float(xi[1, 1]) == (levels + 1) // 2 and float(xi[1, 2]) == -((levels + 1) // 2)

    got = got.to(torch.float32).numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if mul == "approx_mult":
        np.testing.assert_array_equal(got, want)
    else:
        # the reference's exp2 error, scaled back, carried through the chip
        # term (the gain, and the row scale times the offset) and the
        # correction (a slope below 0.05 here); an ulp of the output for
        # each rounded op that the difference can tip
        xi64, wi64 = xi.double().numpy(), wi.double().numpy()
        bound = REL_EXP2 * (np.abs(xi64) @ np.abs(wi64)) * pre.double().numpy()
        epi = {k: np.asarray(v.float().numpy(), np.float64) for k, v in tepi.items()}
        ops_rounded = 1
        if "coladd" in epi:
            gain = np.abs(epi.get("colgain", 1.0))
            bound = gain * bound + np.abs(epi["coladd"]) * bound.max(-1, keepdims=True)
            ops_rounded += 3
        if "mean_coeffs" in epi:
            bound = 1.05 * bound
            ops_rounded += 2
        ulp = ops_rounded * 2.0 ** (-23 if dtype == "float32" else -7) * np.abs(want)
        assert np.all(np.abs(got - want) <= bound + ulp)


def _bf16_round(v):
    """float32 -> bf16 -> float32, round to nearest even (finite values),
    as the kernel's __float2bfloat16_rn."""
    b = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _kernel_quantize(v, s, lev, bf16: bool):
    """csrc/vpu_matmul.cu quantize(), in numpy float32."""
    rnd = _bf16_round if bf16 else (lambda a: np.asarray(a, np.float32))
    q = rnd(np.asarray(v, np.float32) / np.float32(s))  # IEEE: correctly rounded
    q = np.minimum(np.maximum(q, np.float32(-1)), np.float32(1))
    q = rnd(q * np.float32(lev))
    t = (q + np.float32(12582912.0)).astype(np.float32)
    return t.view(np.int32).astype(np.int64) - 0x4B400000


@pytest.mark.parametrize("bits", [7, 8])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_quantisation_matches_plain_version(bits, dtype):
    """The kernel's quantisation of one operand, rendered in numpy, equals
    int_operand_quantize's for every bf16 value of magnitude at most the
    scale (and for float32 values around them), for scales that are and
    are not powers of two."""
    tdt, _ = DTYPES[dtype]
    lev = (1 << bits) - 1
    pats = np.arange(0, 1 << 16, dtype=np.uint32) << 16
    allv = pats.view(np.float32)
    allv = allv[np.isfinite(allv)]
    if dtype == "float32":
        rnd = np.random.default_rng(bits)
        allv = np.concatenate([allv, allv * np.float32(1 + 2 ** -20),
                               rnd.standard_normal(1 << 16).astype(np.float32)])
    for s in (1.0, 0.0478515625, 3.140625, 2.0 ** -10, 1e-6):
        s = float(torch.tensor(s, dtype=tdt))
        v = allv[np.abs(allv) <= s]
        # w = v with a weight of magnitude s in it: the per-tensor scale is s
        w = torch.from_numpy(np.concatenate([v, [s]]).astype(np.float32)).to(tdt)[:, None]
        x = torch.zeros((1, 1), dtype=tdt)
        _, wi, _ = int_operand_quantize(x, w, bits)
        sw = float(w.abs().max())
        want = wi[:-1, 0].to(torch.float64).numpy().astype(np.int64)
        got = _kernel_quantize(w[:-1, 0].float().numpy(), sw, lev, dtype == "bfloat16")
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [7, 8])
def test_kernel_level_table_matches_plain_version(bits):
    """The level table through which the kernel quantises bf16 weights,
    rendered in numpy: built by the kernel's quantisation of each bit
    pattern of the 11 binades up to the scale's, and looked up by |w|'s
    pattern minus the first (patterns below it: entry 0).  Over every bf16
    weight of magnitude at most the scale, its level and sign equal
    int_operand_quantize's, for scales of every size the kernel takes
    (down to eps, where the table starts at pattern 0 only below 2^-117)."""
    lev = (1 << bits) - 1
    TAB = 11 * 128
    pats = np.arange(0, 1 << 16, dtype=np.uint32)
    vals = (pats << 16).view(np.float32)
    for s in (1.0, 0.0478515625, 3.140625, 2.0 ** -10, 1e-6, 6e37):
        s = float(torch.tensor(s, dtype=torch.bfloat16))
        sbits = int(np.float32(s).view(np.uint32))
        base = max((sbits >> 23) - 10, 0) << 7
        tab = _kernel_quantize(((base + np.arange(TAB, dtype=np.uint32)) << 16).view(np.float32),
                               s, lev, True)
        assert tab[0] == 0 and np.all(np.diff(tab) >= 0)
        keep = np.isfinite(vals) & (np.abs(vals) <= s)
        v, p = vals[keep], pats[keep]
        level = tab[np.maximum((p & 0x7FFF).astype(np.int64) - base, 0)]
        got = np.where(p >> 15, -level, level)
        w = torch.from_numpy(np.concatenate([v, [s]])).to(torch.bfloat16)[:, None]
        _, wi, _ = int_operand_quantize(torch.zeros((1, 1), dtype=torch.bfloat16), w, bits)
        np.testing.assert_array_equal(got, wi[:-1, 0].double().numpy().astype(np.int64))


def test_kernel_product_formulas_match_plain_multipliers():
    """The per-product formulas of csrc/vpu_matmul.cu's decode contraction,
    rendered in int64 numpy, over the full grid of operands in [-255, 255]:
    the truncated product for 0, 2 and 4 dropped bits, and Mitchell's."""
    a = np.arange(-255, 256, dtype=np.int64)[:, None]
    b = np.arange(-255, 256, dtype=np.int64)[None, :]
    fa, fb = (torch.from_numpy(v.astype(np.float32)) for v in (a, b))
    for drop in (0, 2, 4):
        low = (1 << drop) - 1
        # sign(b) * trunc(a |b|), trunc by adding low & sign(a), then
        # clearing the low bits
        sb = -(b < 0).astype(np.int64)
        t = (a * np.abs(b) + (low & (a >> 63))) & ~low
        got = (t ^ sb) - sb
        want = ref.approx_mul(fa, fb, drop).numpy().astype(np.int64)
        np.testing.assert_array_equal(got, want)

    def signed_pow2(v):
        m = np.abs(v)
        p = np.where(m > 0, 1 << np.floor(np.log2(np.maximum(m, 1))).astype(np.int64), 0)
        return np.where(v < 0, -p, p)

    # b as the kernel rebuilds it from magnitude, sign and 2^floor(log2 |b|)
    sb = -(b < 0).astype(np.int64)
    b = (np.abs(b) ^ sb) - sb
    pa, pb = signed_pow2(a), (signed_pow2(np.abs(b)) ^ sb) - sb
    ab = a * pb
    u = pa * (b - pb) + ab
    d = pa * (b - 3 * pb) + ab
    got = u + np.where((d ^ pa ^ pb) >= 0, d, 0)
    want = ref.mitchell_mul(fa, fb).numpy().astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    """No launch is counted for CPU tensors; another device raises."""
    build.reset_launches()
    x, w = torch.ones((2, 3)), torch.ones((3, 4))
    assert ops.log_matmul_quantized(x, w, 8, {}, torch.float32).shape == (2, 4)
    assert ops.approx_mult_matmul_quantized(x, w, 7, 2, {}, torch.float32).shape == (2, 4)
    assert sum(build.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        ops.log_matmul_quantized(x.to("meta"), w.to("meta"), 8, {}, torch.float32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("be", list(MULS))
@pytest.mark.parametrize("site,bias", [("mlp_gate", False), ("attn_q", True)])
def test_dense_bf16_matches_reference(be, fused, site, bias):
    """dense() in bf16 against the reference's dense() run eagerly, with
    the contract of tests/test_torch_model.py::test_dense_matches_reference:
    bitwise for approx_mult; log_mult within the reference's exp2 error
    (2^-20 * K * max|x_row| * max|w|) plus one ulp of the output (bf16
    here)."""
    rnd = np.random.default_rng(len(site) + 3 * list(MULS).index(be) + fused)
    x = (rnd.standard_normal((2, 5, 64)) * 1.5).astype(np.float32)
    w = (rnd.standard_normal((64, 96)) * 0.125).astype(np.float32)
    b = rnd.standard_normal(96).astype(np.float32) if bias else None
    x[0, 0] = 0.0  # a zero token: its scale is eps
    tb = lambda a: None if a is None else torch.from_numpy(a).to(torch.bfloat16)
    jb = lambda a: None if a is None else jnp.asarray(a).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = j_dense(jb(x), jb(w), jb(b), site=site,
                       ctx=JCtx(cfg=JApprox(backend=JBackend(be), mode=JMode.MODEL),
                                rng=jax.random.PRNGKey(0), fused=fused))
    got = dense(tb(x), tb(w), tb(b), site=site,
                ctx=ApproxCtx(cfg=ApproxConfig(backend=Backend(be), mode=TrainMode.MODEL),
                              fused=fused))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if be == "approx_mult":
        np.testing.assert_array_equal(got, want)
    else:
        xf = tb(x).float().numpy()
        bound = REL_EXP2 * 64 * np.abs(xf).max(-1, keepdims=True) * float(tb(w).abs().max())
        assert np.all(np.abs(got - want) <= bound + 2.0 ** -7 * np.abs(want))
