"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``gpu`` and skips without a CUDA device.

This file imports neither jax nor the JAX package, so it runs on a
machine that has only PyTorch:

  PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py imports jax.)
"""
import pytest
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.vpu_matmul import (
    elementwise_matmul_cuda,
    elementwise_matmul_fused_cuda,
    elementwise_matmul_fused_ref,
)

MULS = {
    "approx_mult": (127, 4, lambda a, b: ref.approx_mul(a, b, 4)),
    "log_mult": (255, 0, ref.mitchell_mul),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(cuda, mul, M, K, N, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    hi = MULS[mul][0]
    x = torch.randint(-hi, hi + 1, (M, K), generator=g, device=cuda).to(dtype)
    w = torch.randint(-hi, hi + 1, (K, N), generator=g, device=cuda).to(dtype)
    return g, x, w


@pytest.mark.gpu
@pytest.mark.parametrize("mul", list(MULS))
@pytest.mark.parametrize("M,K,N", [(4, 2048, 256), (1, 7, 5), (9, 130, 129), (33, 300, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_bitwise(cuda, mul, M, K, N, dtype):
    """K1 against its plain version: bitwise (both sums are exact)."""
    _, x, w = _operands(cuda, mul, M, K, N, dtype, M + K + N)
    _, drop, mulf = MULS[mul]
    before = build.LAUNCHES[f"elementwise_matmul[{mul}]"]
    got = elementwise_matmul_cuda(x, w, mul, drop)
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"elementwise_matmul[{mul}]"] == before + 1
    torch.testing.assert_close(got, ref.elementwise_matmul_ref(x, w, mulf), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mul", list(MULS))
@pytest.mark.parametrize("M,K,N", [(4, 2048, 256), (9, 130, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["none", "gain_add", "add_only", "correction", "all"])
def test_k2_bitwise(cuda, mul, M, K, N, dtype, case):
    """K2 against its plain version, for every epilogue combination:
    bitwise (the kernel rounds every epilogue op to the output dtype, as
    the plain version does)."""
    g, x, w = _operands(cuda, mul, M, K, N, dtype, 7 * M + N)
    _, drop, mulf = MULS[mul]
    pre = torch.rand((M, 1), generator=g, device=cuda) * 1e-4
    gain = (1 + 0.05 * torch.randn(N, generator=g, device=cuda)).to(dtype)
    add = (0.02 * torch.randn(N, generator=g, device=cuda)).to(dtype)
    corr = {"mean_coeffs": torch.tensor([0.01, -0.02, 0.003, -0.0004], device=cuda),
            "mean_scale": torch.tensor(1.7, device=cuda)}
    epi = {
        "none": {},
        "gain_add": {"colgain": gain, "coladd": add},
        "add_only": {"coladd": add},
        "correction": corr,
        "all": {"colgain": gain, "coladd": add, **corr},
    }[case]
    got = elementwise_matmul_fused_cuda(x, w, mul, pre, epi, dtype, drop)
    want = elementwise_matmul_fused_ref(x, w, mulf, pre, epi, dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,G,dh", [(4, 96, 8, 128), (3, 33, 2, 16), (1, 200, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_allclose(cuda, B, S, G, dh, dtype):
    """K3 against its plain version: within 1e-4 (online softmax
    reassociates the normaliser sum)."""
    g = torch.Generator(device=cuda).manual_seed(S + G)
    q = torch.randn((B, 2, G, dh), generator=g, device=cuda).to(dtype)
    ck = torch.randn((B, S, 2, dh), generator=g, device=cuda).to(dtype)
    cv = torch.randn((B, S, 2, dh), generator=g, device=cuda).to(dtype)
    pos = torch.randint(0, S, (B,), generator=g, device=cuda).to(torch.int32)
    pos[0] = 0
    got = flash_decode(q, ck, cv, pos)
    torch.testing.assert_close(got, flash_decode_ref(q, ck, cv, pos), rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.ones((4, 8), device=cuda)
    with pytest.raises(ValueError):  # mixed dtypes
        elementwise_matmul_cuda(x, torch.ones((8, 4), device=cuda, dtype=torch.bfloat16), "log_mult")
    with pytest.raises(ValueError):  # not contiguous
        elementwise_matmul_cuda(x, torch.ones((4, 8), device=cuda).T, "log_mult")
    with pytest.raises(ValueError):  # a CPU operand
        elementwise_matmul_cuda(x, torch.ones((8, 4)), "log_mult")
    w = torch.ones((8, 4), device=cuda)
    with pytest.raises(ValueError):  # an epilogue vector of the wrong length
        elementwise_matmul_fused_cuda(x, w, "log_mult", torch.ones(4, device=cuda),
                                      {"coladd": torch.ones(3, device=cuda)}, torch.float32)
