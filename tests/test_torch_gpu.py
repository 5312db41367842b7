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
from repro_torch.kernels.analog_matmul import (
    analog_matmul_cuda,
    analog_matmul_fused_cuda,
    analog_matmul_fused_ref,
)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.sc_matmul import (
    SCDraws,
    sc_matmul_cuda,
    sc_matmul_fused_cuda,
    sc_matmul_fused_ref,
    sc_matmul_quantized_cuda,
    sc_matmul_quantized_ref,
    sc_matmul_words_cuda,
    sc_tables_ref,
    stream_planes,
)
from repro_torch.kernels.vpu_matmul import (
    elementwise_matmul_cuda,
    elementwise_matmul_fused_cuda,
    elementwise_matmul_fused_ref,
    int_operand_matmul_fused_cuda,
    int_operand_matmul_fused_ref,
    plain_multiplier,
)
from repro_torch.launch.measure import traced

MULS = {
    "approx_mult": (127, 4, lambda a, b: ref.approx_mul(a, b, 4)),
    "log_mult": (255, 0, ref.mitchell_mul),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


PROFILE_TRIES = 3  # traces of one call, of which the fullest is kept


def _device_kernels(fn):
    """The device kernels of one call of ``fn``, and how many calls that
    took: the fullest of ``PROFILE_TRIES`` traces of one call, each after
    a warm-up call (``measure.traced``; the card's tracer can drop kernel
    records and never adds any)."""
    best = max((traced(fn, 1) for _ in range(PROFILE_TRIES)), key=len)
    return [name for name, _ in best], 2 * PROFILE_TRIES


def _operands(cuda, mul, M, K, N, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    hi = MULS[mul][0]
    x = torch.randint(-hi, hi + 1, (M, K), generator=g, device=cuda).to(dtype)
    w = torch.randint(-hi, hi + 1, (K, N), generator=g, device=cuda).to(dtype)
    return g, x, w


# K1's routes: (multiplier, operand bits, dropped bits).  At M > 4 the
# truncated product of at most 7-bit operands with at most 4 dropped bits
# runs on the int8 tensor cores, the rest on the CUDA cores; M <= 4 takes
# K2's decode contraction.
K1_ROUTES = [("approx_mult", 7, 4), ("approx_mult", 7, 2), ("approx_mult", 7, 0),
             ("approx_mult", 8, 4), ("approx_mult", 7, 6), ("log_mult", 8, 0)]


def _k1_operands(cuda, bits, M, K, N, dtype, seed):
    """Integer operands of at most ``bits`` bits, with both extremes: the
    first entries of x's row 0 and w's column 0 are +-(2^bits - 1)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    hi = (1 << bits) - 1
    x = torch.randint(-hi, hi + 1, (M, K), generator=g, device=cuda)
    w = torch.randint(-hi, hi + 1, (K, N), generator=g, device=cuda)
    ext = torch.tensor([hi, -hi, hi, -hi], device=cuda)[: min(K, 4)]
    x[0, : ext.numel()] = ext
    w[: ext.numel(), 0] = ext
    return x.to(dtype), w.to(dtype)


def _k1_check(cuda, mul, bits, drop, M, K, N, dtype, seed):
    x, w = _k1_operands(cuda, bits, M, K, N, dtype, seed)
    mulf = plain_multiplier(mul, drop)
    before = build.LAUNCHES[f"elementwise_matmul[{mul}]"]
    got = elementwise_matmul_cuda(x, w, mul, drop, bits)
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"elementwise_matmul[{mul}]"] == before + 1
    want = ref.elementwise_matmul_ref(x, w, mulf)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mul,bits,drop", K1_ROUTES)
@pytest.mark.parametrize("M,K,N", [(4, 2048, 256), (1, 7, 5), (9, 130, 129), (33, 300, 1000),
                                   (5, 70, 45), (16, 2048, 2048), (65, 1000, 520), (64, 37, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_bitwise(cuda, mul, bits, drop, M, K, N, dtype):
    """K1 on integer operands, every route, against its plain version:
    bitwise (both sums are exact), with K not a multiple of the tiles and N
    not a multiple of the copies, called twice (the accumulators come back
    clear)."""
    for _ in range(2):
        _k1_check(cuda, mul, bits, drop, M, K, N, dtype, M + K + N)


@pytest.mark.gpu
@pytest.mark.parametrize("mul,bits,drop", K1_ROUTES)
@pytest.mark.parametrize("big", [200.0, -128.0, 127.5, 256.0])
def test_k1_refuses_operands_past_its_bits(cuda, mul, bits, drop, big):
    """K1's integer entry refuses an operand past 2^bits - 1 (after the
    kernel's rounding, half to even: 127.5 is 128) in x or in w, on every
    route, at M = 64 (the tensor-core route at 7 bits) and M = 4, and takes
    the extremes +-(2^bits - 1) (test_k1_bitwise)."""
    x, w = _k1_operands(cuda, bits, 64, 96, 40, torch.float32, 3)
    past = abs(big) >= (1 << bits) - 0.5
    for M in (64, 4):
        for which in ("x", "w"):
            a, b = x[:M].clone(), w.clone()
            (a if which == "x" else b)[1, 2] = big
            if past:
                with pytest.raises(ValueError, match="operands of"):
                    elementwise_matmul_cuda(a, b, mul, drop, bits)
            else:  # taken; the plain version multiplies 127.5 as a float, not as 128
                got = elementwise_matmul_cuda(a, b, mul, drop, bits)
                a, b = torch.round(a), torch.round(b)
                want = ref.elementwise_matmul_ref(a, b, plain_multiplier(mul, drop))
                torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048),
                                 (2048, 151936)])
@pytest.mark.parametrize("mul,bits,drop", [("approx_mult", 7, 4), ("log_mult", 8, 0)])
def test_k1_serving_shapes(cuda, K, N, mul, bits, drop):
    """K1 at the five qwen2.5-3b sites, bf16, M = 1, 5, 64, 65 and 512:
    bitwise to its plain version."""
    for M in (1, 5, 64, 65, 512):
        _k1_check(cuda, mul, bits, drop, M, K, N, torch.bfloat16, M + K)
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048),
                                 (2048, 151936)])
@pytest.mark.parametrize("mul", ["approx_mult", "log_mult"])
def test_k1_quantized_prefill_route(cuda, K, N, mul):
    """The prefill projection on the operands themselves (M > 4: the scale
    pass, the tensor-core or CUDA-core contraction, the finishing pass) at
    the five sites, M = 5, 16, 64, 65 and 512, bf16, on edge operands:
    bitwise to int_operand_matmul_fused_ref with the empty epilogue, one
    launch counted on the prefill route's counter."""
    bits, perforate = QUANT_MULS[mul]
    mulf = plain_multiplier(mul, 2 * perforate)
    key = f"elementwise_matmul[{mul},quantized]"
    for M in (5, 16, 64, 65, 512):
        _, x, w = _edge_operands(cuda, M, K, N, torch.bfloat16, M + K + N)
        before = build.LAUNCHES[key]
        got = int_operand_matmul_fused_cuda(x, w, bits, mul, {}, torch.bfloat16, 2 * perforate)
        torch.cuda.synchronize()
        assert build.LAUNCHES[key] == before + 1
        want = int_operand_matmul_fused_ref(x, w, bits, mulf, {}, torch.bfloat16)
        assert float(want.float().abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        del x, w, got, want
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("mul,bits,perforate", [("approx_mult", 7, 2), ("approx_mult", 7, 0),
                                                ("approx_mult", 6, 1), ("approx_mult", 8, 2),
                                                ("approx_mult", 7, 3), ("log_mult", 8, 0),
                                                ("log_mult", 5, 0)])
@pytest.mark.parametrize("M,K,N", [(5, 70, 45), (65, 1000, 520), (64, 2048, 1003), (130, 37, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_quantized_route_ragged(cuda, mul, bits, perforate, M, K, N, dtype):
    """The prefill projection on the operands themselves off the serving
    shapes, every route (tensor cores for approx_mult of at most 7 bits and
    perforate at most 2), float32 and bf16, with chip and correction terms,
    called twice: bitwise to its plain version."""
    g, x, w = _edge_operands(cuda, M, K, N, dtype, M + K + N)
    mulf = plain_multiplier(mul, 2 * perforate)
    for epi in ({}, _epilogue("all", g, cuda, N, dtype)):
        want = int_operand_matmul_fused_ref(x, w, bits, mulf, epi, dtype)
        for _ in range(2):
            got = int_operand_matmul_fused_cuda(x, w, bits, mul, epi, dtype, 2 * perforate)
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mul", ["approx_mult", "log_mult"])
def test_k1_launches_by_route(cuda, mul):
    """The prefill projection is three launches of vpu_matmul.cu (the scale
    pass, the contraction, the finishing pass) and no memset; K1's integer
    entry is three on the tensor-core route (A', the contraction, the
    conversion) and two on the CUDA cores, beside the PyTorch reductions of
    its operand-range check.  The decode projection (M = 4) counts on K2's
    counter."""
    bits, perforate = QUANT_MULS[mul]
    tc = mul == "approx_mult"
    _, x, w = _edge_operands(cuda, 64, 2048, 11008, torch.bfloat16, 3)

    before = dict(build.LAUNCHES)
    names, calls = _device_kernels(
        lambda: int_operand_matmul_fused_cuda(x, w, bits, mul, {}, torch.bfloat16, 2 * perforate))
    assert build.LAUNCHES[f"elementwise_matmul[{mul},quantized]"] == \
        before[f"elementwise_matmul[{mul},quantized]"] + calls
    assert len(names) == 3 and all("repro_vpu::" in n for n in names), names
    assert any(("mma_contract" if tc else "contract") in n for n in names), names
    xi, wi = x.float().round(), w.float().mul(100).round().clamp(-127, 127)
    names, _ = _device_kernels(lambda: elementwise_matmul_cuda(xi, wi, mul, 2 * perforate, bits))
    assert len([n for n in names if "repro_vpu::" in n]) == (3 if tc else 2), names
    before = dict(build.LAUNCHES)
    int_operand_matmul_fused_cuda(x[:4].contiguous(), w, bits, mul, {}, torch.bfloat16,
                                  2 * perforate)
    assert build.LAUNCHES[f"elementwise_matmul_fused[{mul}]"] == \
        before[f"elementwise_matmul_fused[{mul}]"] + 1
    assert build.LAUNCHES[f"elementwise_matmul[{mul},quantized]"] == \
        before[f"elementwise_matmul[{mul},quantized]"]


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


# (multiplier, bits, perforate) of the backends' defaults
QUANT_MULS = {"approx_mult": (7, 2), "log_mult": (8, 0)}
SERVING_SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048), (2048, 151936)]


def _edge_operands(cuda, M, K, N, dtype, seed):
    """bf16 or float32 activations and fan-in-scaled weights as the model
    gives them, with the edge cases: the last row of x all zero when M > 1
    (its scale is eps), entries of row 0 at sx / 2, sx / 4 and 3 sx / 4
    (63.5 or 127.5 and the like after scaling: ties to even), +-0.0, and
    weights at sw / 2."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=cuda) * 1.5
    w = torch.randn((K, N), generator=g, device=cuda) * K ** -0.5
    x[0] = x[0].clamp(-1.9, 1.9)
    x[0, : min(K, 6)] = torch.tensor([2.0, 1.0, -1.0, 0.5, -1.5, -0.0], device=cuda)[: min(K, 6)]
    if M > 1:
        x[M - 1] = 0.0
    sw = float(w.abs().max())
    w[0, : min(N, 5)] = torch.tensor([0.5, -0.5, 0.25, -0.0, 0.0], device=cuda)[: min(N, 5)] * sw
    return g, x.to(dtype), w.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", SERVING_SHAPES)
@pytest.mark.parametrize("mul", list(QUANT_MULS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_quantizing_route_serving_shapes(cuda, K, N, mul, dtype):
    """K2 on the operands themselves at the five qwen2.5-3b sites, M = 1, 4
    and 9, on edge operands: bitwise to its plain version with the empty
    epilogue and with chip and correction terms."""
    bits, perforate = QUANT_MULS[mul]
    mulf = plain_multiplier(mul, 2 * perforate)
    for M in (1, 4, 9):
        g, x, w = _edge_operands(cuda, M, K, N, dtype, M * 7 + K + N)
        for epi in ({}, _epilogue("all", g, cuda, N, dtype)):
            got = int_operand_matmul_fused_cuda(x, w, bits, mul, epi, dtype, 2 * perforate)
            want = int_operand_matmul_fused_ref(x, w, bits, mulf, epi, dtype)
            assert float(want.float().abs().max()) > 0
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        del x, w
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 70, 45), (9, 130, 129), (1, 7, 5), (4, 2048, 1003),
                                   (4, 3, 520), (5, 256, 8)])
@pytest.mark.parametrize("mul", list(QUANT_MULS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["none", "gain_add", "add_only", "correction", "all"])
def test_k2_quantizing_route_ragged(cuda, M, K, N, mul, dtype, case):
    """K2 on the operands themselves off the serving shapes (N and K not
    multiples of the copies: element loads; K below one stage), for every
    epilogue combination, other operand widths, and called twice (the
    accumulators and the scale pass's words come back clear)."""
    g, x, w = _edge_operands(cuda, M, K, N, dtype, M + K + N)
    epi = _epilogue(case, g, cuda, N, dtype)
    for bits, perforate in ((QUANT_MULS[mul]), (4, 1), (8, 3)):
        if mul == "log_mult":
            perforate = 0
        want = int_operand_matmul_fused_ref(x, w, bits, plain_multiplier(mul, 2 * perforate),
                                            epi, dtype)
        for _ in range(2):
            got = int_operand_matmul_fused_cuda(x, w, bits, mul, epi, dtype, 2 * perforate)
            torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("mul", list(QUANT_MULS))
def test_k2_three_launches_and_no_memset(cuda, mul):
    """A call of K2 on the operands makes three launches of vpu_matmul.cu
    (the scale pass, the contraction, the finishing pass) and no memset or
    other kernel, call after call with the same bits; the integer entry
    makes two."""
    bits, perforate = QUANT_MULS[mul]
    _, x, w = _edge_operands(cuda, 4, 2048, 11008, torch.bfloat16, 5)
    first = int_operand_matmul_fused_cuda(x, w, bits, mul, {}, torch.bfloat16, 2 * perforate)
    for _ in range(3):
        again = int_operand_matmul_fused_cuda(x, w, bits, mul, {}, torch.bfloat16, 2 * perforate)
        assert torch.equal(again, first)
    torch.cuda.synchronize()
    before = dict(build.LAUNCHES)
    names, calls = _device_kernels(
        lambda: int_operand_matmul_fused_cuda(x, w, bits, mul, {}, torch.bfloat16, 2 * perforate))
    assert build.LAUNCHES[f"elementwise_matmul_fused[{mul}]"] == \
        before[f"elementwise_matmul_fused[{mul}]"] + calls
    assert len(names) == 3 and all("repro_vpu::" in n for n in names), names
    xi, wi = x.float().round(), w.float().mul(100).round()
    pre = torch.ones((4,), device=cuda)
    names, _ = _device_kernels(
        lambda: elementwise_matmul_fused_cuda(xi, wi, mul, pre, {}, torch.float32, 2 * perforate))
    assert len(names) == 2 and all("repro_vpu::" in n for n in names), names


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
@pytest.mark.parametrize("KV,G,dh", [(1, 48, 128), (2, 32, 128), (1, 40, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_large_groups(cuda, KV, G, dh, dtype):
    """K3 with G * dh above one block's 2048 outputs: 6144 (granite-20b's
    48 query heads of one KV head, dh 128), 4096, and a group that does
    not divide into whole tiles (40 heads of dh 64: tiles of 32 and 8):
    within 1e-4 of its plain version, as at the serving shape."""
    B, S = 4, 96
    g = torch.Generator(device=cuda).manual_seed(G * dh + KV)
    q = torch.randn((B, KV, G, dh), generator=g, device=cuda).to(dtype)
    ck = torch.randn((B, S, KV, dh), generator=g, device=cuda).to(dtype)
    cv = torch.randn((B, S, KV, dh), generator=g, device=cuda).to(dtype)
    pos = torch.randint(0, S, (B,), generator=g, device=cuda).to(torch.int32)
    pos[0] = 0
    got = flash_decode(q, ck, cv, pos)
    torch.testing.assert_close(got, flash_decode_ref(q, ck, cv, pos), rtol=0, atol=1e-4)


# K3 at serving contexts, bf16: (B, S, KV, G, pos range), many splits a row
K3_LONG = {
    "qwen-4k": (4, 4096, 2, 8, (3900, 4096)),
    "batch-32": (32, 2048, 2, 8, (1800, 2048)),
    "granite-group": (4, 96, 1, 48, (16, 96)),
}


def _k3_operands(cuda, name, dh=128):
    B, S, KV, G, (lo, hi) = K3_LONG[name]
    g = torch.Generator(device=cuda).manual_seed(S + B)
    q = torch.randn((B, KV, G, dh), generator=g, device=cuda).to(torch.bfloat16)
    ck = torch.randn((B, S, KV, dh), generator=g, device=cuda).to(torch.bfloat16)
    cv = torch.randn((B, S, KV, dh), generator=g, device=cuda).to(torch.bfloat16)
    pos = torch.randint(lo, hi, (B,), generator=g, device=cuda).to(torch.int32)
    return q, ck, cv, pos


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(K3_LONG))
def test_k3_serving_contexts(cuda, name):
    """K3 with its keys split across many blocks (qwen2.5-3b at a 4k
    context, a batch of 32 at 2k, granite-20b's 48-head group): within
    1e-4 of its plain version, as at the smoke window."""
    q, ck, cv, pos = _k3_operands(cuda, name)
    got = flash_decode(q, ck, cv, pos)
    torch.testing.assert_close(got, flash_decode_ref(q, ck, cv, pos), rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen-4k", "granite-group"])
def test_k3_repeatable_bitwise(cuda, name):
    """The splits combine in split order, so two calls on the same inputs
    give the same output bit for bit."""
    q, ck, cv, pos = _k3_operands(cuda, name)
    first = flash_decode(q, ck, cv, pos)
    for _ in range(3):
        assert torch.equal(flash_decode(q, ck, cv, pos), first)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen-4k", "granite-group"])
def test_k3_one_launch_a_call(cuda, name):
    """A call is one launch of one kernel, splits and combine together:
    one count on the wrapper's counter and one kernel in a trace."""
    q, ck, cv, pos = _k3_operands(cuda, name)
    flash_decode(q, ck, cv, pos)
    torch.cuda.synchronize()
    before = build.LAUNCHES["flash_decode"]
    flash_decode(q, ck, cv, pos)
    assert build.LAUNCHES["flash_decode"] == before + 1
    before = build.LAUNCHES["flash_decode"]
    names, calls = _device_kernels(lambda: flash_decode(q, ck, cv, pos))
    assert build.LAUNCHES["flash_decode"] == before + calls
    assert len(names) == 1 and "flash_decode" in names[0], names


def _epilogue(case, g, cuda, N, dtype):
    gain = (1 + 0.05 * torch.randn(N, generator=g, device=cuda)).to(dtype)
    add = (0.02 * torch.randn(N, generator=g, device=cuda)).to(dtype)
    corr = {"mean_coeffs": torch.tensor([0.01, -0.02, 0.003, -0.0004], device=cuda),
            "mean_scale": torch.tensor(1.7, device=cuda)}
    return {
        "none": {},
        "gain_add": {"colgain": gain, "coladd": add},
        "add_only": {"coladd": add},
        "correction": corr,
        "all": {"colgain": gain, "coladd": add, **corr},
    }[case]


def _sc_operands(cuda, M, K, N, dtype, bits, seed):
    """Probability planes as the SC emulator makes them (clipped, with
    zeros) and the generator draws."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.rand((M, 2 * K), generator=g, device=cuda)
    x = torch.where(torch.rand(x.shape, generator=g, device=cuda) < 0.3, 0.0, x).to(dtype)
    wa = torch.rand((K, N), generator=g, device=cuda).to(dtype)
    wb = torch.rand((K, N), generator=g, device=cuda).to(dtype)
    ux = torch.rand((1, bits), generator=g, device=cuda)
    uw = torch.rand((2 * K, bits), generator=g, device=cuda)
    return g, x, (wa, wb), ux, uw


def _analog_operands(cuda, M, K, N, dtype, seed):
    """Unipolar planes on 8-bit grids, as fake_quant_unipolar makes them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = lambda t: (torch.round(t * 255) / torch.tensor(255.0, device=cuda)).to(dtype)
    x = torch.rand((M, 2 * K), generator=g, device=cuda)
    x = q(torch.where(torch.rand(x.shape, generator=g, device=cuda) < 0.3, 0.0, x))
    # a small scale keeps partial sums inside the ADC range, as the
    # emulator's per-tensor scales do
    wa = q(torch.rand((K, N), generator=g, device=cuda) * 0.1)
    wb = q(torch.rand((K, N), generator=g, device=cuda) * 0.1)
    return g, x, (wa, wb)


SC_SHAPES = [(4, 2048, 256), (64, 300, 129), (1, 7, 5), (9, 130, 1000)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", SC_SHAPES)
@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_bitwise(cuda, M, K, N, bits, dtype):
    """K4 against its plain version, from the planes (tables built for the
    call, and built once for two calls, as a prefill projection does for
    its two polarities) and on pre-packed words: bitwise (AND, OR and
    popcount are order-free)."""
    _, x, w, ux, uw = _sc_operands(cuda, M, K, N, dtype, bits, M + K + N + bits)
    want = ref.sc_matmul_ref(x, w, bits, ux, uw)
    before = dict(build.LAUNCHES)
    got = sc_matmul_cuda(x, w, bits, (ux, uw))
    draws = SCDraws(ux, uw)
    again = sc_matmul_cuda(x, w, bits, draws)
    twice = sc_matmul_cuda(x, w, bits, draws)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sc_matmul_packed"] == before["sc_matmul_packed"] + 3
    assert build.LAUNCHES["sc_tables"] == before["sc_tables"] + 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(again, want, rtol=0, atol=0)
    torch.testing.assert_close(twice, want, rtol=0, atol=0)
    xbits = ref.sc_pack_streams(x, ux)
    wbits = ref.sc_pack_streams(torch.cat(w), uw[:, None, :])
    want = ref.sc_matmul_packed_chunked_ref(xbits, wbits) / bits
    torch.testing.assert_close(sc_matmul_words_cuda(xbits, wbits, bits), want, rtol=0, atol=0)


def _prefill_operands(cuda, M, K, N, dtype, seed):
    """The SC prefill projection's raw operands: activations and
    fan-in-scaled weights, with exact zeros (every seventh weight, x[0, 0])
    and the weight's extremes +-max|w|."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    w = (torch.randn((K, N), generator=g, device=cuda) * K ** -0.5).to(dtype)
    w.view(-1)[::7] = 0.0
    top = w.abs().max()
    w[0, 0], w[-1, -1] = top, -top
    x[0, 0] = 0.0
    return g, x, w


def _check_prefill(x, w, gain, bits, ux, uw, one_polarity=True):
    """The prefill route (twice, the second call on the tables the first
    built, and on the accumulators the first cleared) and K4's own entry on
    the emulator's planes of the same operands (both polarities), each
    bitwise to its plain version."""
    draws = SCDraws(ux, uw)
    before = dict(build.LAUNCHES)
    got = sc_matmul_quantized_cuda(x, w, gain, bits, draws)
    again = sc_matmul_quantized_cuda(x, w, gain, bits, draws)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sc_matmul_packed[quantized]"] == \
        before["sc_matmul_packed[quantized]"] + 2
    assert build.LAUNCHES["sc_tables"] == before["sc_tables"] + 1
    want = sc_matmul_quantized_ref(x, w, gain, bits, (ux, uw))
    assert got.dtype == x.dtype and got.shape == (x.shape[0], w.shape[1])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(again, want, rtol=0, atol=0)
    if one_polarity:
        xp, xn, wp, wn, _ = stream_planes(x, w, gain)
        xcat = torch.cat([xp, xn], dim=-1).contiguous()
        for halves in ((wp, wn), (wn, wp)):
            torch.testing.assert_close(sc_matmul_cuda(xcat, halves, bits, draws),
                                       ref.sc_matmul_ref(xcat, halves, bits, ux, uw),
                                       rtol=0, atol=0)
    return want


# M across the 64-row tile and the 4-row one (1, 4, 5, 64, 65), K not a
# multiple of the 8-row stage (7, 130, 300) and long (2048, 11008), N not
# a multiple of the 128-column tile (5, 129, 1000)
PREFILL_SHAPES = [(1, 7, 5), (4, 130, 129), (5, 300, 1000), (64, 130, 5), (65, 2048, 129),
                  (1, 11008, 1000), (64, 7, 1000), (65, 300, 129)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", PREFILL_SHAPES)
@pytest.mark.parametrize("bits", [32, 64, 288, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_prefill_route_bitwise(cuda, M, K, N, bits, dtype):
    """The SC prefill projection (scale pass, both polarities from one
    lookup a weight, finishing pass) and K4's one-polarity entry against
    their plain versions: bitwise, with exact zeros and +-max|w| in the
    weight, at gain 3 (planes clamped at 1) for 64-bit streams (where the
    OR over many ports saturates both polarities: outputs may all be 0)."""
    g, x, w = _prefill_operands(cuda, M, K, N, dtype, M + K + N + bits)
    ux = torch.rand((1, bits), generator=g, device=cuda)
    uw = torch.rand((2 * K, bits), generator=g, device=cuda)
    _check_prefill(x, w, 3.0 if bits == 64 else 0.25, bits, ux, uw)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,bits", [
    (64, 2048, 2048, 32), (64, 2048, 256, 32), (64, 2048, 11008, 32), (64, 11008, 2048, 32),
    (64, 2048, 151936, 32), (512, 2048, 11008, 32), (4, 2048, 11008, 32), (1, 2048, 151936, 32),
    (64, 2048, 11008, 512), (512, 2048, 2048, 512), (64, 11008, 2048, 288)])
def test_k4_prefill_route_serving_shapes(cuda, M, K, N, bits):
    """The prefill route at the qwen2.5-3b sites (M = 64, the largest
    prompt bucket; 512 tokens; one- and four-token prompts), bf16, with the
    port's own draws: bitwise, and K4's one-polarity entry beside it
    (except at the lm_head, where its plain version alone takes a minute)."""
    from repro_torch.kernels.ops import sc_draws

    _, x, w = _prefill_operands(cuda, M, K, N, torch.bfloat16, K + N + M + bits)
    ux, uw = sc_draws((9, K, N, M), 2 * K, bits, cuda)
    want = _check_prefill(x, w, 0.25, bits, ux, uw, one_polarity=N < 151936)
    assert float(want.float().abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_prefill_route_ties_and_thresholds_below_zero(cuda, dtype):
    """Draws on a grid of sixteenths (0 and 1 included) and a few below 0,
    where a zero plane sets stream bits: the route takes the zero plane's
    words from the table row, and stays bitwise; values equal to a
    threshold, NaN-free weights at gain 3, and the tables bit for bit."""
    M, K, N, bits = 9, 256, 300, 64
    g, x, w = _prefill_operands(cuda, M, K, N, dtype, 41)
    uw = torch.round(torch.rand((2 * K, bits), generator=g, device=cuda) * 16) / 16
    ux = torch.round(torch.rand((1, bits), generator=g, device=cuda) * 16) / 16
    uw[:5, :3] = torch.tensor([-0.25, -1.0, -0.0625], device=cuda)
    uw[K + 7, 4] = -0.5
    ux[0, 6] = -0.125
    assert torch.equal(SCDraws(ux, uw).tables, sc_tables_ref(ux, uw))
    for gain in (0.25, 3.0):
        _check_prefill(x, w, gain, bits, ux, uw)


@pytest.mark.gpu
def test_k4_prefill_route_all_zero_weight_and_three_launches(cuda):
    """An all-zero weight (its scale the eps floor) gives the plain
    version's zeros; a call on built tables is three kernels of
    sc_matmul.cu (scale pass, contraction, finishing pass) and no memset;
    the tables build once per set of draws."""
    g, x, w = _prefill_operands(cuda, 64, 2048, 11008, torch.bfloat16, 3)
    ux = torch.rand((1, 32), generator=g, device=cuda)
    uw = torch.rand((4096, 32), generator=g, device=cuda)
    zero = torch.zeros_like(w)
    got = _check_prefill(x, zero, 0.25, 32, ux, uw, one_polarity=False)
    assert not bool(got.float().abs().max() > 0)
    draws = SCDraws(ux, uw)
    sc_matmul_quantized_cuda(x, w, 0.25, 32, draws)
    torch.cuda.synchronize()
    before = dict(build.LAUNCHES)
    names, calls = _device_kernels(lambda: sc_matmul_quantized_cuda(x, w, 0.25, 32, draws))
    assert build.LAUNCHES["sc_matmul_packed[quantized]"] == \
        before["sc_matmul_packed[quantized]"] + calls
    assert build.LAUNCHES["sc_tables"] == before["sc_tables"]
    assert build.LAUNCHES["sc_matmul_packed"] == before["sc_matmul_packed"]
    assert len([n for n in names if "repro_sc::" in n]) == 3, names
    assert not any("memset" in n.lower() for n in names), names


@pytest.mark.gpu
def test_k4_prefill_route_refuses_what_it_does_not_take(cuda):
    x = torch.ones((4, 8), device=cuda)
    w = torch.ones((8, 6), device=cuda)
    ux, uw = torch.rand((1, 32), device=cuda), torch.rand((16, 32), device=cuda)
    with pytest.raises(ValueError):  # mixed dtypes
        sc_matmul_quantized_cuda(x, w.to(torch.bfloat16), 0.25, 32, (ux, uw))
    with pytest.raises(ValueError):  # x is not [M, K]
        sc_matmul_quantized_cuda(x[:, :7].contiguous(), w, 0.25, 32, (ux, uw))
    with pytest.raises(ValueError):  # a transposed (not contiguous) weight
        sc_matmul_quantized_cuda(x, torch.ones((6, 8), device=cuda).T, 0.25, 32, (ux, uw))
    with pytest.raises(ValueError):  # draws for other ports
        sc_matmul_quantized_cuda(x, w, 0.25, 32, (ux, uw[:8]))
    with pytest.raises(ValueError):  # a CPU operand
        sc_matmul_quantized_cuda(x, w.cpu(), 0.25, 32, (ux, uw))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 2048, 256), (9, 130, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["none", "gain_add", "add_only", "correction", "all"])
def test_k5_bitwise(cuda, M, K, N, dtype, case):
    """K5 against its plain version, for every epilogue combination."""
    g, x, w, ux, uw = _sc_operands(cuda, M, K, N, dtype, 32, 3 * M + N)
    pre = torch.tensor(0.0371, device=cuda).to(torch.bfloat16)
    epi = _epilogue(case, g, cuda, N, dtype)
    got = sc_matmul_fused_cuda(x, w, 32, (ux, uw), pre, epi, dtype)
    want = sc_matmul_fused_ref(x, w, 32, (ux, uw), pre, epi, dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _sc_serving_operands(cuda, M, K, N, seed):
    """K5's operands as the SC emulator makes them at a serving site: bf16
    activations and fan-in-scaled weights through the value-domain code,
    and the port's draws."""
    from repro_torch.configs.base import SCParams
    from repro_torch.core.backends import _stream_planes
    from repro_torch.kernels.ops import sc_draws

    g = torch.Generator(device=cuda).manual_seed(seed)
    w = (torch.randn((K, N), generator=g, device=cuda) * K ** -0.5).to(torch.bfloat16)
    x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
    xp, xn, wp, wn, pre = _stream_planes(x, w, SCParams())
    ux, uw = sc_draws((seed, K, N), 2 * K, 32, cuda)
    return g, torch.cat([xp, xn], dim=-1).contiguous(), (wp, wn), ux, uw, pre


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048),
                                 (2048, 151936)])
def test_k5_serving_shapes(cuda, K, N):
    """K5 at the five qwen2.5-3b sites, M = 4, with tables built once and
    reused: bitwise to its plain version, with the empty epilogue and
    with chip and correction terms."""
    g, x, w, ux, uw, pre = _sc_serving_operands(cuda, 4, K, N, 11)
    draws = SCDraws(ux, uw)
    for epi in ({}, _epilogue("all", g, cuda, N, torch.bfloat16)):
        got = sc_matmul_fused_cuda(x, w, 32, draws, pre, epi, torch.bfloat16)
        want = sc_matmul_fused_ref(x, w, 32, draws, pre, epi, torch.bfloat16)
        assert float(want.float().abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 300, 1000), (4, 2048, 1003), (4, 130, 264),
                                   (4, 3, 520), (1, 7, 5), (9, 64, 2100), (1, 256, 8)])
@pytest.mark.parametrize("bits", [32, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_ragged_shapes_and_stream_lengths(cuda, M, K, N, bits, dtype):
    """K5 bitwise off the serving shapes: N not a multiple of the column
    tile (nor of the 16-byte copy), K not a multiple of the 4-row step and
    below one step, M = 1 and M = 9 (three activation tiles), streams of
    32, 64 and 256 bits, float32 and bf16 planes, chip terms."""
    g, x, w, ux, uw = _sc_operands(cuda, M, K, N, dtype, bits, M * K + N + bits)
    pre = torch.rand((M, 1), generator=g, device=cuda)
    epi = _epilogue("all", g, cuda, N, dtype)
    got = sc_matmul_fused_cuda(x, w, bits, (ux, uw), pre, epi, dtype)
    want = sc_matmul_fused_ref(x, w, bits, (ux, uw), pre, epi, dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["none", "gain_add", "add_only", "correction", "all"])
def test_k5_edge_probabilities_and_tied_draws(cuda, dtype, case):
    """Probabilities 0, -0.0, 1, NaN and values exactly equal to a
    threshold, against draws with repeated thresholds (a grid of
    sixteenths, 0 and 1 included): bitwise, for every epilogue case; the
    tables equal their plain version bit for bit."""
    M, K, N, bits = 4, 256, 512, 64
    g, x, (wa, wb), ux, uw = _sc_operands(cuda, M, K, N, dtype, bits, 77)
    uw = torch.where(torch.rand(uw.shape, generator=g, device=cuda) < 0.5,
                     torch.round(uw * 16) / 16, uw.to(dtype).float())
    ux = torch.round(ux * 16) / 16
    for t in (x, wa, wb):
        pick = torch.rand(t.shape, generator=g, device=cuda)
        t.masked_fill_(pick < 0.05, 0.0)
        t.masked_fill_((pick >= 0.05) & (pick < 0.1), -0.0)
        t.masked_fill_((pick >= 0.1) & (pick < 0.15), 1.0)
        t.masked_fill_((pick >= 0.15) & (pick < 0.16), float("nan"))
    wa[:, :64] = uw[:K, :64].to(dtype)  # equal to the thresholds of their port
    wb[:, 64:128] = uw[K:, :64].to(dtype)
    x[:, :64] = ux[0, :64].to(dtype)
    draws = SCDraws(ux, uw)
    assert torch.equal(draws.tables, sc_tables_ref(ux, uw))
    pre = torch.tensor(0.0371, device=cuda)
    epi = _epilogue(case, g, cuda, N, dtype)
    got = sc_matmul_fused_cuda(x, (wa, wb), bits, draws, pre, epi, dtype)
    want = sc_matmul_fused_ref(x, (wa, wb), bits, draws, pre, epi, dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
def test_k5_reused_tables_and_two_launches_a_call(cuda):
    """Tables built once and reused give the bits of tables built fresh,
    call after call (the accumulators come back clear), and a call with
    the tables launches two kernels of sc_matmul.cu and no memset."""
    g, x, w, ux, uw, pre = _sc_serving_operands(cuda, 4, 2048, 11008, 12)
    draws = SCDraws(ux, uw)
    fresh = sc_matmul_fused_cuda(x, w, 32, (ux, uw), pre, {}, torch.bfloat16)
    for _ in range(3):
        again = sc_matmul_fused_cuda(x, w, 32, draws, pre, {}, torch.bfloat16)
        assert torch.equal(again, fresh)
    torch.cuda.synchronize()
    before = dict(build.LAUNCHES)
    names, calls = _device_kernels(
        lambda: sc_matmul_fused_cuda(x, w, 32, draws, pre, {}, torch.bfloat16))
    assert build.LAUNCHES["sc_matmul_packed_fused"] == before["sc_matmul_packed_fused"] + calls
    assert build.LAUNCHES["sc_tables"] == before["sc_tables"]
    assert len([n for n in names if "repro_sc::" in n]) == 2, names
    assert not any("memset" in n.lower() for n in names), names


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 2048, 256), (64, 300, 129), (1, 7, 5), (9, 200, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_bitwise(cuda, M, K, N, dtype):
    """K6 against its plain version: bitwise (each array's partial sum is
    exact in float64; the ADC rounds every op).  Ragged arrays when 2K is
    not a multiple of 128."""
    _, x, w = _analog_operands(cuda, M, K, N, dtype, 5 * M + K)
    before = build.LAUNCHES["analog_matmul"]
    got = analog_matmul_cuda(x, w, 128, 4, 4.0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["analog_matmul"] == before + 1
    want = ref.analog_matmul_ref(x, w, 128, 4, 4.0)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# M, K, N, array_size.  K7 streams 64-column tiles and, when K is a
# multiple of array_size, splits whole arrays across warps; otherwise one
# array straddles the two halves of the plane and one warp takes all rows.
K7_SHAPES = [
    (4, 2048, 256, 128),
    (9, 130, 129, 128),     # K not a multiple of array_size, N of the tile
    (4, 2048, 11008, 128),  # gate/up at decode
    (4, 11008, 2048, 128),  # down at decode
    (1, 7, 5, 128),         # K < array_size: one array over both halves
    (4, 200, 1000, 128),
    (9, 130, 200, 64),
    (1, 2048, 100, 64),
]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,A", K7_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["none", "gain_add", "add_only", "correction", "all"])
def test_k7_bitwise(cuda, M, K, N, A, dtype, case):
    """K7 against its plain version, for every epilogue combination."""
    g, x, w = _analog_operands(cuda, M, K, N, dtype, 11 * M + N)
    pre = torch.tensor(0.8125, device=cuda).to(torch.bfloat16)
    epi = _epilogue(case, g, cuda, N, dtype)
    before = build.LAUNCHES["analog_matmul_fused"]
    got = analog_matmul_fused_cuda(x, w, A, 4, 4.0, pre, epi, dtype)
    torch.cuda.synchronize()
    assert build.LAUNCHES["analog_matmul_fused"] == before + 1
    want = analog_matmul_fused_ref(x, w, A, 4, 4.0, pre, epi, dtype)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 2048, 256), (9, 130, 129)])
@pytest.mark.parametrize("adc_bits,adc_range", [(4, 3.0), (8, 4.0), (10, 2.5), (2, 0.5)])
def test_k7_adc_settings(cuda, M, K, N, adc_bits, adc_range):
    """K7 against its plain version for other ADC widths and ranges: codes
    wider than a byte, and ranges that are and are not a power of two."""
    _, x, w = _analog_operands(cuda, M, K, N, torch.bfloat16, 7 * M + K)
    pre = torch.tensor(0.8125, device=cuda).to(torch.bfloat16)
    got = analog_matmul_fused_cuda(x, w, 128, adc_bits, adc_range, pre, {}, torch.bfloat16)
    want = analog_matmul_fused_ref(x, w, 128, adc_bits, adc_range, pre, {}, torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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
    with pytest.raises(ValueError):  # operands of more than 8 bits
        elementwise_matmul_cuda(x, w, "approx_mult", 4, 9)
    with pytest.raises(ValueError):  # an epilogue vector of the wrong length
        elementwise_matmul_fused_cuda(x, w, "log_mult", torch.ones(4, device=cuda),
                                      {"coladd": torch.ones(3, device=cuda)}, torch.float32)
    halves = (torch.ones((4, 6), device=cuda), torch.ones((4, 6), device=cuda))
    u = torch.rand((8, 32), device=cuda)
    with pytest.raises(ValueError):  # x is not [M, 2K]
        sc_matmul_cuda(x[:, :7].contiguous(), halves, 32, (u[:1], u))
    with pytest.raises(ValueError):  # stream length not a multiple of 32
        sc_matmul_cuda(x, halves, 48, (torch.rand((1, 48), device=cuda),
                                       torch.rand((8, 48), device=cuda)))
    with pytest.raises(ValueError):  # draws that are not float32
        sc_matmul_fused_cuda(x, halves, 32, (u[:1], u.double()), 1.0, {}, torch.float32)
    with pytest.raises(ValueError):  # halves of different dtypes
        analog_matmul_cuda(x, (halves[0], halves[1].to(torch.bfloat16)), 128, 4, 4.0)


# ---------------------------------------------------------------------------
# The SC draws (threefry, csrc/prng.cu), the weights, 512-bit streams, K6
# ---------------------------------------------------------------------------

DRAW_PATHS = [(0, 1, 1583461021), (3, 17, 5, 2147483647), (0, 2, 2**20, 1999999999),
              (2**31 - 1, 2**32 - 1), (7,)]


@pytest.mark.gpu
@pytest.mark.parametrize("path", DRAW_PATHS, ids=[str(i) for i in range(len(DRAW_PATHS))])
@pytest.mark.parametrize("n_ports,n_bits", [(4096, 32), (22016, 32), (9, 512), (129, 64), (1, 0)])
def test_prng_kernel_bitwise(cuda, path, n_ports, n_bits):
    """The draws kernel against the plain threefry on the CPU: bitwise,
    one launch per key path, through ``ops.sc_draws`` and the wrapper."""
    from repro_torch.kernels import ops, prng

    before = build.LAUNCHES["sc_draws"]
    ux, uw = ops.sc_draws(path, n_ports, n_bits, cuda)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sc_draws"] == before + 1
    wx, ww = prng.sc_draws_ref(path, n_ports, n_bits)
    assert ux.device.type == "cuda" and tuple(uw.shape) == (n_ports, n_bits)
    assert torch.equal(ux.cpu().view(torch.int32), wx.view(torch.int32))
    assert torch.equal(uw.cpu().view(torch.int32), ww.view(torch.int32))


@pytest.mark.gpu
def test_prng_kernel_reads_the_path_from_the_card(cuda):
    """The kernel reads its key path from the int32 tensor at launch: the
    words changed in place give the new path's draws."""
    from repro_torch.kernels import prng

    words = torch.tensor(prng.path_words((0, 1, 77)), dtype=torch.int32, device=cuda)
    a = prng.sc_draws_cuda(words, 64, 32)
    words.copy_(torch.tensor(prng.path_words((0, 2, 77)), dtype=torch.int32))
    b = prng.sc_draws_cuda(words, 64, 32)
    for got, path in ((a, (0, 1, 77)), (b, (0, 2, 77))):
        want = prng.sc_draws_ref(path, 64, 32)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    with pytest.raises(ValueError):  # words on the CPU
        prng.sc_draws_cuda(words.cpu(), 64, 32)


@pytest.mark.gpu
def test_init_params_on_the_card_equal_the_cpu(cuda):
    """One seed gives the same weights on the card as on the CPU, tensor
    by tensor, bit for bit, and they live on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    model = build_model(get_smoke_config("qwen2.5-3b"))
    on_card, on_cpu = model.init(0, device=cuda), model.init(0, device="cpu")
    a, b = dict(on_card.named_parameters()), dict(on_cpu.named_parameters())
    assert sorted(a) == sorted(b) and len(a) > 0
    for name, t in a.items():
        assert t.device.type == "cuda", name
        assert torch.equal(t.cpu(), b[name]), name


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4, 2048, 256), (64, 300, 129), (1, 7, 5), (9, 130, 1000)])
@pytest.mark.parametrize("bits", [288, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k5_and_tables_beyond_256_bits(cuda, M, K, N, bits, dtype):
    """Streams of 288 (9 words: one past a chunk of 8) and 512 bits: the
    tables, K4 (from the planes and on pre-packed words) and K5 with chip
    terms, each bitwise to its plain version."""
    g, x, w, ux, uw = _sc_operands(cuda, M, K, N, dtype, bits, M + K + N + bits)
    draws = SCDraws(ux, uw)
    assert torch.equal(draws.tables, sc_tables_ref(ux, uw))
    torch.testing.assert_close(sc_matmul_cuda(x, w, bits, draws),
                               ref.sc_matmul_ref(x, w, bits, ux, uw), rtol=0, atol=0)
    xbits = ref.sc_pack_streams(x, ux)
    wbits = ref.sc_pack_streams(torch.cat(w), uw[:, None, :])
    # divided by a tensor: a CUDA tensor divided by a Python number is a
    # product with its reciprocal, not the correctly rounded quotient
    torch.testing.assert_close(sc_matmul_words_cuda(xbits, wbits, bits),
                               ref.sc_matmul_packed_chunked_ref(xbits, wbits)
                               / torch.tensor(float(bits), device=cuda), rtol=0, atol=0)
    pre = torch.rand((M, 1), generator=g, device=cuda)
    epi = _epilogue("all", g, cuda, N, dtype)
    got = sc_matmul_fused_cuda(x, w, bits, draws, pre, epi, dtype)
    torch.testing.assert_close(got, sc_matmul_fused_ref(x, w, bits, draws, pre, epi, dtype),
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(2048, 11008), (2048, 151936)])
def test_k4_k5_serving_shapes_at_512_bits(cuda, K, N):
    """K4 (M = 64) and K5 (M = 4) at serving sites with 512-bit streams
    on the emulator's operands and the port's draws: bitwise."""
    from repro_torch.configs.base import SCParams
    from repro_torch.core.backends import _stream_planes
    from repro_torch.kernels.ops import sc_draws

    g = torch.Generator(device=cuda).manual_seed(K + N)
    w = (torch.randn((K, N), generator=g, device=cuda) * K ** -0.5).to(torch.bfloat16)
    p = SCParams(bits=512)
    draws = SCDraws(*sc_draws((5, K, N), 2 * K, 512, cuda))
    for M in (64, 4):
        x = torch.randn((M, K), generator=g, device=cuda).to(torch.bfloat16)
        xp, xn, wp, wn, pre = _stream_planes(x, w, p)
        xcat = torch.cat([xp, xn], dim=-1).contiguous()
        if M == 64:
            got = sc_matmul_cuda(xcat, (wp, wn), 512, draws)
            want = ref.sc_matmul_ref(xcat, (wp, wn), 512, *draws)
        else:
            got = sc_matmul_fused_cuda(xcat, (wp, wn), 512, draws, pre, {}, torch.bfloat16)
            want = sc_matmul_fused_ref(xcat, (wp, wn), 512, draws, pre, {}, torch.bfloat16)
        assert float(want.float().abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# M, K, N, array_size: M across the 64-row tile (1, 9, 64, 65), K not a
# multiple of array_size (an array straddles the halves), arrays that end
# inside a 4-row step, N not a multiple of the 128-column tile
K6_SHAPES = [
    (64, 2048, 256, 128),
    (1, 7, 5, 128),
    (9, 130, 129, 128),
    (64, 300, 1000, 128),
    (65, 200, 1000, 128),
    (64, 130, 200, 64),
    (9, 2048, 100, 64),
    (65, 261, 77, 50),
    (64, 96, 264, 6),
]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,A", K6_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_bitwise_shapes_and_arrays(cuda, M, K, N, A, dtype):
    """K6 (float64 mma, byte codes, levels added in array order) against
    its plain version: bitwise, one wrapper launch a call."""
    _, x, w = _analog_operands(cuda, M, K, N, dtype, 3 * M + K + A)
    before = build.LAUNCHES["analog_matmul"]
    got = analog_matmul_cuda(x, w, A, 4, 4.0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["analog_matmul"] == before + 1
    want = ref.analog_matmul_ref(x, w, A, 4, 4.0)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(64, 2048, 256), (9, 130, 129)])
@pytest.mark.parametrize("adc_bits,adc_range", [(4, 3.0), (8, 4.0), (10, 2.5), (2, 0.5)])
def test_k6_adc_settings(cuda, M, K, N, adc_bits, adc_range):
    """K6 for other ADC widths and ranges: codes wider than a byte, and
    ranges that are and are not a power of two."""
    _, x, w = _analog_operands(cuda, M, K, N, torch.bfloat16, 5 * M + K + adc_bits)
    got = analog_matmul_cuda(x, w, 128, adc_bits, adc_range)
    want = ref.analog_matmul_ref(x, w, 128, adc_bits, adc_range)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048),
                                 (2048, 151936)])
def test_k6_serving_shapes(cuda, K, N):
    """K6 at the five qwen2.5-3b sites, M = 64, on the analog emulator's
    own planes (bf16 activations and fan-in-scaled weights), both
    polarities as split_unipolar_contract calls it: bitwise."""
    from repro_torch.configs.base import AnalogParams
    from repro_torch.core.backends import _array_planes

    p = AnalogParams()
    g = torch.Generator(device=cuda).manual_seed(K + N)
    w = (torch.randn((K, N), generator=g, device=cuda) * K ** -0.5).to(torch.bfloat16)
    x = torch.randn((64, K), generator=g, device=cuda).to(torch.bfloat16)
    xp, xn, wp, wn, _ = _array_planes(x, w, p)
    xcat = torch.cat([xp, xn], dim=-1).contiguous()
    for halves in ((wp, wn), (wn, wp)):
        got = analog_matmul_cuda(xcat, halves, p.array_size, p.adc_bits, p.adc_range)
        want = ref.analog_matmul_ref(xcat, halves, p.array_size, p.adc_bits, p.adc_range)
        assert float(want.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("adc_bits", [4, 10])
def test_k6_many_rows_at_lm_head_width(cuda, adc_bits):
    """K6 at M = 512 against lm_head's N = 151936, where the ADC codes of
    all rows and arrays (C M N, 2.5 GB at byte codes) would pass 2^31 bytes:
    the call runs in passes of 64 rows (and, with 10-bit codes, of at most
    13 arrays, each adding onto the float32 sums of the last), its scratch
    is that of 64 rows, and it is bitwise equal to its plain version."""
    M, K, N, A = 512, 2048, 151936, 128
    lib = build.lib("analog_matmul")
    assert lib.analog_scratch_bytes(M, N, K, A, adc_bits) == \
        lib.analog_scratch_bytes(64, N, K, A, adc_bits) < 2**30
    _, x, w = _analog_operands(cuda, M, K, N, torch.bfloat16, 17 + adc_bits)
    before = build.LAUNCHES["analog_matmul"]
    got = analog_matmul_cuda(x, w, A, adc_bits, 4.0)
    torch.cuda.synchronize()
    assert build.LAUNCHES["analog_matmul"] == before + 1
    want = ref.analog_matmul_ref(x, w, A, adc_bits, 4.0)
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)
