"""The port's kernel modules against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
The JAX side runs the Pallas kernels in interpret mode (as
tests/test_kernels.py does) or the jnp oracles; the port's side runs the
plain versions, which CPU tensors take.  The CUDA kernels are held
against the plain versions in tests/test_torch_gpu.py.

Known reference fact that shapes two contracts here: ``jnp.exp2`` on
XLA:CPU is inexact at some integer arguments (2^13 -> 8192.0039,
2^15 -> 32767.984), so the reference's ``mitchell_mul`` returns
non-integer products where floor(log2|a|) + floor(log2|b|) is 13 or 15,
off by at most 2^-21 relative.  The port returns the exact product.
Mitchell results are therefore held bitwise to an exact integer oracle
and to the reference wherever its exp2 is exact, and to the reference
elsewhere within 2^-20 of the sum of |products|.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.epilogue import apply_epilogue as j_apply_epilogue
from repro.kernels.approx_mult import approx_mult_matmul as j_amult
from repro.kernels.approx_mult import approx_mult_matmul_fused as j_amult_fused
from repro.kernels.flash_decode import flash_decode as j_flash
from repro.kernels.flash_decode import flash_decode_ref as j_flash_ref
from repro.kernels.log_matmul import log_matmul as j_log
from repro.kernels.log_matmul import log_matmul_fused as j_log_fused
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.epilogue import apply_epilogue, ipow
from repro_torch.kernels.vpu_matmul import elementwise_matmul_cuda

REL_EXP2 = 2.0 ** -20  # bound on the reference's Mitchell error (see module doc)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _exact_mitchell(a, b):
    """Exact integer Mitchell product (int64 numpy): the independent oracle."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    ia, ib = np.abs(a), np.abs(b)

    def pow2(v):
        out = np.zeros_like(v)
        nz = v > 0
        out[nz] = 1 << np.floor(np.log2(v[nz])).astype(np.int64)
        return out

    pa, pb = pow2(ia), pow2(ib)
    s, t = ia * pb + ib * pa, pa * pb
    return np.sign(a) * np.sign(b) * ((s - t) + np.maximum(s - 3 * t, 0))


def _xla_exp2_exact_mask(a, b):
    """True where the reference's exp2(ka + kb) is exact on XLA:CPU."""
    k = np.arange(0, 20, dtype=np.float32)
    exact = np.asarray(jnp.exp2(jnp.asarray(k))) == 2.0 ** k
    lg = lambda v: np.floor(np.log2(np.maximum(np.abs(v), 1))).astype(np.int64)
    return exact[lg(a) + lg(b)]


def _int_operands(rnd, shape, hi):
    return rnd.integers(-hi, hi + 1, size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Scalar multipliers over their full integer grids
# ---------------------------------------------------------------------------


def test_mitchell_mul_full_grid():
    """Bitwise to the exact oracle over [-255, 255]^2; bitwise to the
    reference where its exp2 is exact, within 2^-20 relative elsewhere."""
    a = np.arange(-255, 256, dtype=np.float32)
    A, B = np.meshgrid(a, a, indexing="ij")
    got = ref.mitchell_mul(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    np.testing.assert_array_equal(got, _exact_mitchell(A, B).astype(np.float32))
    want = np.asarray(jref.mitchell_mul(jnp.asarray(A), jnp.asarray(B)))
    mask = _xla_exp2_exact_mask(A, B)
    assert mask.mean() > 0.5
    np.testing.assert_array_equal(got[mask], want[mask])
    np.testing.assert_allclose(got, want, rtol=REL_EXP2, atol=0)


@pytest.mark.parametrize("perforate", [1, 2])
def test_approx_mul_full_grid(perforate):
    """Bitwise over [-127, 127]^2."""
    a = np.arange(-127, 128, dtype=np.float32)
    A, B = np.meshgrid(a, a, indexing="ij")
    got = ref.approx_mul(torch.from_numpy(A), torch.from_numpy(B), 2 * perforate).numpy()
    want = np.asarray(jref.approx_mul(jnp.asarray(A), jnp.asarray(B), 2 * perforate))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("i", [1, 2, 3, 4, 5, 7])
def test_ipow_matches_integer_pow(i):
    """t**i in jax.lax.integer_pow's multiplication order: bitwise."""
    t = np.random.default_rng(i).standard_normal(4096).astype(np.float32) * 3
    got = ipow(torch.from_numpy(t), i).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray(t) ** i))


# ---------------------------------------------------------------------------
# K1: elementwise_matmul (plain version on CPU tensors)
# ---------------------------------------------------------------------------

SHAPES = [(5, 40, 33), (16, 130, 129)]


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("perforate", [1, 2])
def test_k1_approx_mult_bitwise(M, K, N, perforate):
    rnd = np.random.default_rng(M * K + N + perforate)
    x, w = _int_operands(rnd, (M, K), 127), _int_operands(rnd, (K, N), 127)
    got = ops.approx_mult_matmul(torch.from_numpy(x), torch.from_numpy(w), 7, perforate).numpy()
    interp = j_amult(jnp.asarray(x), jnp.asarray(w), 7, perforate, interpret=True,
                     block_m=16, block_n=16, block_k=16)
    oracle = jref.approx_mult_matmul_ref(jnp.asarray(x), jnp.asarray(w), 7, perforate)
    np.testing.assert_array_equal(got, np.asarray(interp))
    np.testing.assert_array_equal(got, np.asarray(oracle))


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_k1_log_mult(M, K, N):
    """Full 8-bit range: bitwise to the exact integer sum, and to the
    reference within its exp2 error.  Operands within |63| (where the
    reference's products are exact): bitwise to the reference."""
    rnd = np.random.default_rng(M * K + N)
    x, w = _int_operands(rnd, (M, K), 255), _int_operands(rnd, (K, N), 255)
    got = ops.log_matmul(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    exact = _exact_mitchell(x[:, :, None], w[None, :, :]).sum(1)
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    bound = REL_EXP2 * (np.abs(x).astype(np.float64) @ np.abs(w))
    for want in (
        j_log(jnp.asarray(x), jnp.asarray(w), interpret=True,
              block_m=16, block_n=16, block_k=16),
        jref.log_matmul_ref(jnp.asarray(x), jnp.asarray(w)),
    ):
        assert np.all(np.abs(got - np.asarray(want)) <= bound)

    x6, w6 = _int_operands(rnd, (M, K), 63), _int_operands(rnd, (K, N), 63)
    got6 = ops.log_matmul(torch.from_numpy(x6), torch.from_numpy(w6)).numpy()
    want6 = j_log(jnp.asarray(x6), jnp.asarray(w6), interpret=True,
                  block_m=16, block_n=16, block_k=16)
    np.testing.assert_array_equal(got6, np.asarray(want6))
    np.testing.assert_array_equal(got6, np.asarray(jref.log_matmul_ref(jnp.asarray(x6), jnp.asarray(w6))))


# ---------------------------------------------------------------------------
# K2: elementwise_matmul_fused (plain version on CPU tensors)
# ---------------------------------------------------------------------------

EPI_CASES = ["none", "gain_add", "add_only", "correction", "all"]


def _epi(case, rnd, N, np_dtype):
    gain = (1.0 + 0.05 * rnd.standard_normal(N)).astype(np_dtype)
    add = (0.02 * rnd.standard_normal(N)).astype(np_dtype)
    coeffs = np.asarray([0.01, -0.02, 0.003, -0.0004], np.float32)
    scale = np.float32(1.7)
    return {
        "none": {},
        "gain_add": {"colgain": gain, "coladd": add},
        "add_only": {"coladd": add},
        "correction": {"mean_coeffs": coeffs, "mean_scale": scale},
        "all": {"colgain": gain, "coladd": add, "mean_coeffs": coeffs, "mean_scale": scale},
    }[case]


def _fused_pair(mul, x, w, pre, epi, jdt, tdt):
    """(port, Pallas fused kernel, reference composed op by op): the last
    is the Pallas unfused contraction followed by the reference's
    apply_epilogue run eagerly, one rounded op at a time."""
    tepi = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.float32 if k.startswith("mean") else tdt) for k, v in epi.items()}
    jepi = {k: jnp.asarray(v).astype(jnp.float32 if k.startswith("mean") else jdt)
            for k, v in epi.items()}
    tx, tw, tpre = (torch.from_numpy(a) for a in (x, w, pre))
    jx, jw, jpre = (jnp.asarray(a) for a in (x, w, pre))
    kw = dict(interpret=True, block_m=16, block_k=16)
    if mul == "approx_mult":
        got = ops.approx_mult_matmul_fused(tx, tw, 7, 2, tpre, tepi, tdt)
        fused = j_amult_fused(jx, jw, 7, 2, jpre, jepi, jdt, **kw)
        acc = j_amult(jx, jw, 7, 2, block_n=16, **kw)
    else:
        got = ops.log_matmul_fused(tx, tw, tpre, tepi, tdt)
        fused = j_log_fused(jx, jw, jpre, jepi, jdt, **kw)
        acc = j_log(jx, jw, block_n=16, **kw)
    with jax.disable_jit():
        composed = j_apply_epilogue((acc * jpre).astype(jdt), **jepi)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return got.to(torch.float32).numpy(), f32(fused), f32(composed)


@pytest.mark.parametrize("case", EPI_CASES)
@pytest.mark.parametrize("mul", ["approx_mult", "log_mult"])
def test_k2_fused_f32(mul, case):
    """float32 (log_mult operands in |63|, where the reference's products
    are exact; the full range is covered by test_k1_log_mult):

    * bitwise to the reference composed op by op;
    * bitwise to the Pallas fused kernel without epilogue operands, and
      within 2^-20 of the row's largest output with them: under jit,
      XLA:CPU contracts the epilogue's a*b + c into fused multiply-adds,
      which skip one rounding each (the port and the CUDA kernel round
      every op, as the reference's code reads and as eager JAX does).
    """
    M, K, N = 6, 70, 45
    rnd = np.random.default_rng(EPI_CASES.index(case))
    hi = 127 if mul == "approx_mult" else 63
    x, w = _int_operands(rnd, (M, K), hi), _int_operands(rnd, (K, N), hi)
    pre = (rnd.uniform(0.5, 2.0, (M, 1)) * 1e-4).astype(np.float32)
    got, fused, composed = _fused_pair(mul, x, w, pre, _epi(case, rnd, N, np.float32),
                                       jnp.float32, torch.float32)
    np.testing.assert_array_equal(got, composed)
    if case == "none":
        np.testing.assert_array_equal(got, fused)
    tol = 2.0 ** -20 * np.abs(fused).max(-1, keepdims=True)
    assert np.all(np.abs(got - fused) <= tol)


@pytest.mark.parametrize("case", EPI_CASES)
def test_k2_fused_bf16(case):
    """bfloat16 output: within 1 bf16 ulp (2^-7 relative, atol 1e-6 for
    values near zero) of the Pallas fused kernel and of the reference
    composed op by op.  The port rounds to bf16 after every epilogue op;
    XLA on the CPU may keep float32 between fused elementwise ops (and
    eager JAX may compute a bf16 op in float32 before one final
    rounding), so the last bit can differ."""
    M, K, N = 4, 64, 40
    rnd = np.random.default_rng(10 + EPI_CASES.index(case))
    x, w = _int_operands(rnd, (M, K), 127), _int_operands(rnd, (K, N), 127)
    pre = (rnd.uniform(0.5, 2.0, (M, 1)) * 1e-4).astype(np.float32)
    got, fused, composed = _fused_pair("approx_mult", x, w, pre,
                                       _epi(case, rnd, N, np.float32),
                                       jnp.bfloat16, torch.bfloat16)
    np.testing.assert_allclose(got, fused, rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(got, composed, rtol=2.0 ** -7, atol=1e-6)


def test_epilogue_scalar_coladd_broadcasts():
    y = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    a = apply_epilogue(y, coladd=torch.tensor(0.5))
    b = apply_epilogue(y, coladd=torch.full((4,), 0.5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K3: flash decode attention (plain version on CPU tensors)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,B,S", [(0, 1, 16), (1, 4, 48), (2, 3, 33)])
def test_k3_flash_decode(seed, B, S):
    """allclose atol=rtol=1e-5 to the Pallas kernel (online softmax
    reassociates) and to the jnp oracle."""
    KV, G, dh = 2, 2, 16
    rnd = np.random.default_rng(seed)
    q = rnd.standard_normal((B, KV, G, dh)).astype(np.float32)
    ck = rnd.standard_normal((B, S, KV, dh)).astype(np.float32)
    cv = rnd.standard_normal((B, S, KV, dh)).astype(np.float32)
    pos = rnd.integers(0, S, size=B).astype(np.int32)
    pos[0] = 0
    got = ops.flash_decode_attention(*(torch.from_numpy(a) for a in (q, ck, cv, pos))).numpy()
    for want in (
        j_flash(*(jnp.asarray(a) for a in (q, ck, cv, pos)), interpret=True),
        j_flash_ref(*(jnp.asarray(a) for a in (q, ck, cv, pos))),
    ):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Dispatch, build and import hygiene
# ---------------------------------------------------------------------------


def test_dispatch_by_device_never_falls_back():
    """CPU tensors take the plain version (no launch counted); a device
    that is neither CPU nor CUDA raises instead of falling back."""
    build.reset_launches()
    x = torch.ones((2, 3))
    w = torch.ones((3, 4))
    assert ops.log_matmul(x, w).shape == (2, 4)
    assert sum(build.LAUNCHES.values()) == 0
    with pytest.raises(ValueError):
        ops.log_matmul(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError):
        ops.log_matmul(x, w.to("meta"))
    with pytest.raises(ValueError):  # the CUDA wrapper takes no CPU tensor
        elementwise_matmul_cuda(x, w, "log_mult")


def test_build_targets_are_content_addressed():
    """Library names hash the sources and flags, and live in build/."""
    for name in build.SIGNATURES:
        target = build._target(name)
        assert target.parent == build.BUILD_DIR
        assert target.parent.parent.name == "build"
        assert (build.CSRC / f"{name}.cu").exists()


def test_import_hygiene():
    """The port and all its submodules import without jax or repro."""
    code = (
        "import pkgutil, importlib, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
