"""Stochastic-computing contractions: the CUDA kernels K4/K5 and their plain
versions (port of ``repro.kernels.sc_matmul``).

``sc_matmul_quantized_cuda`` is the SC prefill projection as the serving
path runs it: K4's function for both polarities from the raw operands
``x`` [M, K] and ``w`` [K, N], with the value-domain code in front of it
(:func:`stream_planes`) taken in: three launches, no plain-torch op over
the weight.  ``sc_matmul_cuda`` (K4 on given planes, one polarity) and
``sc_matmul_fused_cuda`` (K5) launch
``csrc/sc_matmul.cu`` too.  They take the activation probabilities ``x``
[M, 2K], the weight probability plane as its two [K, N] halves
``(top, bottom)`` (read in place: the reference's ``concatenate``s are
never built), and the generator draws ``(ux, uw)``: ``ux`` [1, bits]
(shared by every activation port) and ``uw`` [2K, bits] (one sequence
per weight row).  The kernels compare and pack the streams themselves,
against threshold tables of the draws that :func:`sc_tables_cuda` builds
on the card.  The wrappers take the draws as :class:`SCDraws`, which
builds their tables at first use and keeps them, so every call that
shares the draws shares one build; a plain ``(ux, uw)`` pair is wrapped
for the call.  ``sc_matmul_words_cuda`` is K4's contraction on
pre-packed words, the reference kernel's own interface, for checking the
contraction alone.

The plain versions are :func:`sc_matmul_quantized_ref` (the prefill
projection), :func:`repro_torch.kernels.ref.sc_matmul_ref` (K4),
:func:`sc_matmul_fused_ref` (K5) and :func:`sc_tables_ref` (the tables,
bit for bit as the kernel lays them out).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.proxy import OPERAND_EPS, split_signed, tensor_scale
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import apply_epilogue
from repro_torch.kernels.ref import const, sc_matmul_ref
from repro_torch.kernels.vpu_matmul import _in_dtype, epilogue_operands, weight_layout

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KEYS = 64       # thresholds of one table row: word w of sequences k and k + K
BUCKETS = 256   # value buckets of one table row
MASKS_AT = KEYS                        # word of a row's first mask pair
BUCKETS_AT = MASKS_AT + 2 * (KEYS + 1)  # word of its first 16-bit bucket entry
ROW = BUCKETS_AT + BUCKETS // 2 + 2    # words of one row, 2 of them padding


def table_words(K: int, n_bits: int) -> int:
    """int32 words of the tables of draws for 2K weight ports: rows (k, w)
    for k <= K (row K: the activation sequence), laid out [W][K + 1][ROW]."""
    return (K + 1) * (n_bits // 32) * ROW


class SCDraws(tuple):
    """``(ux, uw)``, one projection's generator draws, with their threshold
    tables on the card (:attr:`tables`), built at first use and kept."""

    def __new__(cls, ux, uw):
        self = super().__new__(cls, (ux, uw))
        self._tables = None
        return self

    @classmethod
    def of(cls, draws) -> "SCDraws":
        """``draws`` itself, or a plain ``(ux, uw)`` pair wrapped."""
        return draws if isinstance(draws, cls) else cls(*draws)

    @property
    def tables(self) -> torch.Tensor:
        """The tables of the draws (:func:`sc_tables_cuda`)."""
        if self._tables is None:
            self._tables = sc_tables_cuda(*self)
        return self._tables


def bucket_of(v):
    """The value bucket of probabilities or thresholds, as the kernels take
    it: floor(256 v) clamped to [0, 255], NaN in bucket 0 (the table puts
    NaN thresholds in bucket 255)."""
    b = torch.floor(v.to(torch.float32) * 256.0)
    b = torch.where(torch.isnan(b), 0.0, b)
    return b.clamp(0, BUCKETS - 1).to(torch.int64)


def _order_key(u):
    """int64 keys of float32 thresholds in a total order that agrees with
    ``<``: -0.0 ties with +0.0, NaN sorts last (as the kernel's order_key)."""
    u = torch.where(u == 0, torch.zeros_like(u), u)
    b = u.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(b >= 2**31, b ^ 0xFFFFFFFF, b | 2**31)
    return torch.where(torch.isnan(u), torch.full_like(key, 0xFFFFFFFF), key)


def sc_tables_ref(ux, uw):
    """The kernel's threshold tables of the draws ``ux`` [1, bits] and ``uw``
    [2K, bits], in plain PyTorch: int32 [(K + 1) * W * ROW], bit for bit.

    Row (k, w) merges threshold word w of sequences k (top) and k + K
    (bottom); row (K, w) holds ux's word twice.  Its first 64 words are the
    64 thresholds sorted by (value, top before bottom, index), as float32
    bits; then 65 mask pairs (top word, bottom word): pair c holds the
    stream bits of the c smallest; then 256 16-bit bucket entries, entry
    b = start | end << 8 where [start, end) are the sorted positions of
    the thresholds in bucket b (:func:`bucket_of`); then 2 words of
    zeros."""
    n_bits = uw.shape[1]
    K, W = uw.shape[0] // 2, n_bits // 32
    ux = ux.reshape(1, n_bits).to(torch.float32)
    uw = uw.to(torch.float32)
    top = torch.cat([uw[:K], ux]).reshape(K + 1, W, 32).transpose(0, 1)  # [W, K + 1, 32]
    bottom = torch.cat([uw[K:], ux]).reshape(K + 1, W, 32).transpose(0, 1)
    u = torch.cat([top, bottom], dim=-1)                                  # [W, K + 1, 64]
    order = torch.argsort(_order_key(u), dim=-1, stable=True)
    keys = torch.gather(u, -1, order)
    # bucket b holds sorted positions [#{buckets < b}, #{buckets < b + 1})
    kb = torch.where(torch.isnan(keys), BUCKETS - 1, bucket_of(keys))
    below = (kb[..., None, :] < torch.arange(BUCKETS + 1, device=u.device)[:, None]).sum(-1)
    entries = below[..., :-1] | below[..., 1:] << 8                      # [W, K + 1, 256]
    entries = (entries[..., 0::2] | entries[..., 1::2] << 16).to(torch.int64)
    entries = torch.where(entries >= 2**31, entries - 2**32, entries).to(torch.int32)
    keys = keys.contiguous().view(torch.int32)
    # each stream bit belongs to one threshold, so an OR of the bits of the
    # c smallest is their sum
    one = torch.ones((), dtype=torch.int64, device=u.device)
    bit = one << (order % 32)
    bits = [torch.where(order // 32 == h, bit, 0) for h in (0, 1)]
    zero = torch.zeros(order.shape[:-1] + (1,), dtype=torch.int64, device=u.device)
    masks = torch.stack([torch.cat([zero, b.cumsum(-1)], dim=-1) for b in bits], dim=-1)
    masks = torch.where(masks >= 2**31, masks - 2**32, masks).to(torch.int32)
    pad = torch.zeros(keys.shape[:-1] + (ROW - BUCKETS_AT - BUCKETS // 2,), dtype=torch.int32,
                      device=u.device)
    return torch.cat([keys, masks.flatten(-2), entries, pad], dim=-1).reshape(-1)


def row_major(op, a, b):
    """``op(a, b)`` (an elementwise torch function with ``out=``), written
    row-major where ``a`` is not: a tied LM head's weight is the view
    ``embed.T``, an elementwise op would keep its transposed strides, and
    the kernels refuse such planes.  One pass, the same values."""
    if a.is_contiguous():
        return op(a, b)
    out = torch.empty(torch.broadcast_shapes(a.shape, b.shape),
                      dtype=torch.result_type(a, b), device=a.device)
    return op(a, b, out=out)


def stream_planes(x, w, gain: float):
    """The SC emulator's value-domain code (``repro.core.backends.
    _emulate_sc``): per-tensor scales, the clipped probability planes of x
    and w at ``gain``, and the rescale ``(sx * sw) / gain^2``, each op
    rounded to the operands' dtype as JAX's weak typing rounds it.  The
    planes are row-major [K, N] even where w is a transposed view."""
    sx = tensor_scale(x)
    sw = tensor_scale(w)
    xp, xn = split_signed(x * (const(gain, sx) / sx))
    wp, wn = split_signed(row_major(torch.mul, w, const(gain, sw) / sw))
    xp, xn, wp, wn = (torch.clamp(t, 0.0, 1.0) for t in (xp, xn, wp, wn))
    rescale = (sx * sw) / const(gain * gain, sx)
    return xp, xn, wp, wn, rescale


def sc_matmul_quantized_ref(x, w, gain: float, n_bits: int, draws):
    """The SC prefill projection's plain version, op for op the
    reference's: :func:`stream_planes`, the stream contraction of each
    polarity, w_pos = [wp; wn] and w_neg = [wn; wp] (``sc_matmul_ref``),
    then ``(r_p - r_n) * rescale`` cast to x's dtype.  x [M, K], w [K, N];
    ``draws`` is ``(ux, uw)``."""
    xp, xn, wp, wn, rescale = stream_planes(x, w, gain)
    xcat = torch.cat([xp, xn], dim=-1)
    ux, uw = draws
    r = (sc_matmul_ref(xcat, (wp, wn), n_bits, ux, uw)
         - sc_matmul_ref(xcat, (wn, wp), n_bits, ux, uw))
    return (r * rescale).to(x.dtype)


def sc_matmul_fused_ref(x, w: Tuple, n_bits: int, draws, prescale, epi: Dict, out_dtype):
    """K5's plain version: both polarities, w_pos = [wp; wn] and w_neg =
    [wn; wp], ``r_p - r_n`` times the prescale, cast to ``out_dtype``,
    then the epilogue; ``draws`` is ``(ux, uw)``."""
    wp, wn = w
    ux, uw = draws
    r = sc_matmul_ref(x, (wp, wn), n_bits, ux, uw) - sc_matmul_ref(x, (wn, wp), n_bits, ux, uw)
    return apply_epilogue((r * prescale).to(out_dtype), **epi)


def _check(x, w: Tuple, n_bits: int, ux, uw):
    """K4's and K5's operands: x [M, 2K] and the plane's two [K, N] halves."""
    top, bottom = w
    K, N = top.shape if top.dim() == 2 else (-1, -1)
    if x.dim() != 2 or tuple(bottom.shape) != (K, N) or x.shape[1] != 2 * K:
        raise ValueError(
            f"need x [M, 2K] and two [K, N] halves; got {tuple(x.shape)}, "
            f"{tuple(top.shape)}, {tuple(bottom.shape)}"
        )
    _check_operands((x, top, bottom), K, n_bits, ux, uw)


def _check_operands(operands, K: int, n_bits: int, ux, uw, w_nk: int = 0):
    """One CUDA device, one dtype (float32 or bfloat16) for the operands,
    float32 draws ux [1, n_bits] and uw [2K, n_bits], all contiguous (but
    the weight where ``w_nk``: the transpose of a row-major [N, K])."""
    tensors = (*operands, ux, uw)
    if tensors[0].device.type != "cuda" or any(t.device != tensors[0].device for t in tensors):
        raise ValueError(
            f"CUDA kernel needs every operand on one CUDA device; got "
            f"{[str(t.device) for t in tensors]}"
        )
    dtypes = {t.dtype for t in operands}
    if len(dtypes) != 1 or not dtypes <= set(_DTYPE_CODE):
        raise ValueError(f"the operands must share float32 or bfloat16; got "
                         f"{[t.dtype for t in operands]}")
    if n_bits % 32 or n_bits <= 0:
        raise ValueError(f"n_bits must be a positive multiple of 32; got {n_bits}")
    if ux.numel() != n_bits or tuple(uw.shape) != (2 * K, n_bits):
        raise ValueError(f"need ux [1, {n_bits}] and uw [{2 * K}, {n_bits}]; got "
                         f"{tuple(ux.shape)}, {tuple(uw.shape)}")
    if ux.dtype != torch.float32 or uw.dtype != torch.float32:
        raise ValueError("the generator draws must be float32")
    if not all(t.is_contiguous() for i, t in enumerate(tensors) if not (w_nk and i == 1)):
        raise ValueError("the operands and the draws must be contiguous (row-major)")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def sc_tables_cuda(ux, uw):
    """The threshold tables of the draws ``ux`` [1, bits] and ``uw`` [2K,
    bits] on the card (one launch): int32 [(K + 1) * W * ROW], the layout
    of :func:`sc_tables_ref`."""
    if ux.device.type != "cuda" or uw.device != ux.device:
        raise ValueError(f"CUDA kernel needs the draws on one CUDA device; got "
                         f"{ux.device}, {uw.device}")
    n_bits = uw.shape[-1] if uw.dim() == 2 else -1
    if n_bits % 32 or n_bits <= 0 or uw.shape[0] % 2 or ux.numel() != n_bits:
        raise ValueError(f"need ux [1, bits] and uw [2K, bits], bits a positive multiple of "
                         f"32; got {tuple(ux.shape)}, {tuple(uw.shape)}")
    if ux.dtype != torch.float32 or uw.dtype != torch.float32:
        raise ValueError("the generator draws must be float32")
    if not (ux.is_contiguous() and uw.is_contiguous()):
        raise ValueError("the draws must be contiguous")
    K = uw.shape[0] // 2
    tab = torch.empty((table_words(K, n_bits),), dtype=torch.int32, device=ux.device)
    build.launch("sc_tables", "sc_matmul", "sc_tables", ux.data_ptr(), uw.data_ptr(),
                 tab.data_ptr(), K, n_bits, _stream(ux.device))
    return tab


# (device, stream) -> the word accumulators of K4, K5 and the prefill
# projection (and the prefill scale pass's 3 words), int32, all zero between
# calls: the contractions OR into them (or store whole words) and the
# finishing passes clear what they have read, as the scale pass's last block
# clears its words, so a call launches no memset.  Zero-filled when first
# made or grown.
_CLEAR: Dict[Tuple[int, int], torch.Tensor] = {}


def _clear_words(dev, stream: int, n: int) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _CLEAR.get(key)
    if buf is None or buf.numel() < n:
        buf = _CLEAR[key] = torch.zeros((n,), dtype=torch.int32, device=dev)
    return buf


def _launch_clearing(dev, stream: int, kernel: str, entry: str, *args) -> None:
    try:
        build.launch(kernel, "sc_matmul", entry, *args)
    except RuntimeError:
        _CLEAR.pop((dev.index, stream), None)  # the finishing pass may not have cleared them
        raise


def sc_matmul_cuda(x, w: Tuple, n_bits: int, draws):
    """K4: x [M, 2K] against the plane [top; bottom] -> [M, N] float32
    stream value (popcount / n_bits), against the streams of ``draws``
    (:class:`SCDraws` or a plain ``(ux, uw)`` pair): two launches, and one
    more where the draws' tables are not built yet."""
    draws = SCDraws.of(draws)
    _check(x, w, n_bits, *draws)
    top, bottom = w
    K, N = top.shape
    M, dev = x.shape[0], x.device
    tab = draws.tables
    stream = _stream(dev)
    acc = _clear_words(dev, stream, M * N * (n_bits // 32))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    _launch_clearing(
        dev, stream, "sc_matmul_packed", "sc_matmul",
        _DTYPE_CODE[x.dtype], x.data_ptr(), top.data_ptr(), bottom.data_ptr(), tab.data_ptr(),
        acc.data_ptr(), out.data_ptr(), M, N, K, n_bits, stream,
    )
    return out


def sc_matmul_words_cuda(xbits, wbits, n_bits: int):
    """K4's contraction on pre-packed int32 words: xbits [M, K, W], wbits
    [K, N, W] -> [M, N] float32 (popcount / n_bits)."""
    if xbits.device.type != "cuda" or wbits.device != xbits.device:
        raise ValueError("CUDA kernel needs xbits and wbits on one CUDA device")
    if xbits.dtype != torch.int32 or wbits.dtype != torch.int32:
        raise ValueError("packed words must be int32")
    M, K, W = xbits.shape
    if wbits.dim() != 3 or wbits.shape[0] != K or wbits.shape[2] != W or n_bits != 32 * W:
        raise ValueError(f"need xbits [M,K,W], wbits [K,N,W], n_bits = 32 W; got "
                         f"{tuple(xbits.shape)}, {tuple(wbits.shape)}, {n_bits}")
    if not (xbits.is_contiguous() and wbits.is_contiguous()):
        raise ValueError("packed words must be contiguous")
    N, dev = wbits.shape[1], xbits.device
    stream = _stream(dev)
    acc = _clear_words(dev, stream, M * N * W)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    _launch_clearing(
        dev, stream, "sc_matmul_packed[words]", "sc_matmul_words",
        xbits.data_ptr(), wbits.data_ptr(), acc.data_ptr(), out.data_ptr(), M, N, K, n_bits,
        stream,
    )
    return out


def sc_matmul_quantized_cuda(x, w, gain: float, n_bits: int, draws):
    """The SC prefill projection on the card: x [M, K] and w [K, N]
    (float32 or bfloat16, one dtype; w row-major, or the transpose of a
    row-major [N, K] tensor, read in place: a tied LM head's ``embed.T``)
    -> [M, N] in x's dtype, bitwise
    :func:`sc_matmul_quantized_ref`, against the streams of ``draws``
    (:class:`SCDraws` or a plain ``(ux, uw)`` pair).  Three launches (the
    scale pass, the contraction of both polarities, the finishing pass),
    and one more where the draws' tables are not built yet.  A transposed
    weight counts as the ``[N, K]`` entry, ``sc_matmul_packed[quantized,
    nk]``."""
    draws = SCDraws.of(draws)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need x [M, K] and w [K, N]; got {tuple(x.shape)}, {tuple(w.shape)}")
    K, N = w.shape
    w_nk = weight_layout(w)
    _check_operands((x, w), K, n_bits, *draws, w_nk=w_nk)
    M, dev = x.shape[0], x.device
    tab = draws.tables
    stream = _stream(dev)
    words = M * N * (n_bits // 32)
    acc = _clear_words(dev, stream, 2 * words + 3)  # both polarities, then the scale pass's 3
    scales = torch.empty((3,), dtype=torch.float32, device=dev)
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    _launch_clearing(
        dev, stream, "sc_matmul_packed[quantized,nk]" if w_nk else "sc_matmul_packed[quantized]",
        "sc_matmul_quantized",
        _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), tab.data_ptr(),
        acc[2 * words:].data_ptr(), scales.data_ptr(), acc.data_ptr(), acc[words:].data_ptr(),
        out.data_ptr(), M, N, K, n_bits, _in_dtype(OPERAND_EPS, x.dtype),
        _in_dtype(gain, x.dtype), _in_dtype(gain * gain, x.dtype), w_nk, stream,
    )
    return out


def sc_matmul_fused_cuda(x, w: Tuple, n_bits: int, draws, prescale, epi: Dict, out_dtype):
    """K5: both polarities of the plane halves ``w = (wp, wn)`` against the
    streams of ``draws`` (:class:`SCDraws` or a plain ``(ux, uw)`` pair),
    ``r_p - r_n``, the prescale, the cast to ``out_dtype`` and the epilogue
    ``epi``: two launches, and one more where the draws' tables are not
    built yet."""
    draws = SCDraws.of(draws)
    _check(x, w, n_bits, *draws)
    wp, wn = w
    K, N = wp.shape
    M, dev = x.shape[0], x.device
    ops = epilogue_operands(M, N, prescale, epi, out_dtype, dev)
    tab = draws.tables
    stream = _stream(dev)
    words = M * N * (n_bits // 32)
    acc = _clear_words(dev, stream, 2 * words)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    _launch_clearing(
        dev, stream, "sc_matmul_packed_fused", "sc_matmul_fused",
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], x.data_ptr(), wp.data_ptr(),
        wn.data_ptr(), tab.data_ptr(), acc.data_ptr(), acc[words:].data_ptr(),
        *ops.pointers(), out.data_ptr(), M, N, K, n_bits, stream,
    )
    return out
