"""Single-token decode attention (port of ``repro.kernels.flash_decode``):
kernel K3 (``csrc/flash_decode.cu``) and its plain version.

The kernel splits each row's key range across blocks and combines the
splits in the same launch, in split order; :func:`geometry` chooses the
splits and the G tiles.  Equivalence of kernel and plain version is
allclose, not bitwise: the online softmax reassociates the normaliser sum.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_DH = 2048  # the largest head the kernel takes
# as csrc/flash_decode.cu: warps a block; a lane holds at most this many
# (query head, 16-byte chunk of a row) pairs of q, and as many of the
# accumulator, in registers
WARPS = 4
LANE_CHUNKS = 8
TILE_CHUNKS = 4  # 16-byte chunks of K (and of V) a lane loads for a warp tile
BLOCKS_PER_SM = 2  # blocks the split length aims at, at long S


class Geometry(NamedTuple):
    """How one call of the kernel cuts its work.

    A row of the kernel is a (batch row, KV head, G tile); its keys are
    split into ``n_splits`` splits of ``split_len`` keys, a block each.
    ``gt`` query heads a G tile (``maxg``: the kernel instance's register
    room, a power of two); ``lpr`` lanes cover a row of dh, ``nv`` 16-byte
    chunks a lane; a warp tile is ``steps`` steps of ``32 // lpr`` keys.
    A split's partial (acc [gt][dh], m [gt], l [gt]) takes ``pstride``
    floats, a multiple of 4 (16-byte aligned).
    """

    gt: int
    n_gt: int
    maxg: int
    lpr: int
    nv: int
    steps: int
    split_len: int
    n_splits: int
    rows: int
    pstride: int

    @property
    def blocks(self) -> int:
        return self.rows * self.n_splits

    @property
    def scratch_floats(self) -> int:
        """The partials' scratch (none with one split: a block then writes
        the output itself)."""
        return self.rows * self.n_splits * self.pstride if self.n_splits > 1 else 0


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=256)
def geometry(B: int, S: int, KV: int, G: int, dh: int, itemsize: int, sms: int = 132) -> Geometry:
    """The kernel's cut of a call on a card of ``sms`` SMs, from the shapes
    the host knows (``pos`` stays on the device).

    Lanes cover a row with 16-byte loads (8 bf16 or 4 float32 values), at
    most 32 lanes a row, more chunks a lane past that.  A G tile holds as
    many query heads as a lane's registers take (8 at dh <= 256 in bf16),
    and no more than a row has lanes.
    The split length is a whole number of block passes (4 warps of one
    tile each), the fewest that keep the blocks at or under
    ``BLOCKS_PER_SM`` a SM, so short windows get a split a pass and long
    ones fill the card."""
    vec = 16 // itemsize
    if dh % vec or not 0 < dh <= MAX_DH:
        raise ValueError(f"flash_decode kernel takes dh a multiple of {vec} up to {MAX_DH} "
                         f"for {itemsize}-byte inputs (16-byte rows); got {dh}")
    nvec = dh // vec
    lpr = min(32, _pow2_ceil(nvec))
    nv = _pow2_ceil(-(-nvec // 32))
    # the heads a lane holds q and acc for, and no more than a row has lanes
    # (the dot products are reduce-scattered over them)
    cap = max(1, min(LANE_CHUNKS // nv, lpr))
    gt = min(G, cap)
    maxg = cap if nv > 1 else _pow2_ceil(gt)
    n_gt = -(-G // gt)
    steps = max(1, TILE_CHUNKS // nv)
    chunk = WARPS * (32 // lpr) * steps  # keys a block pass
    rows = B * KV * n_gt
    chunks = -(-S // chunk)
    per_split = min(chunks, max(1, -(-chunks * rows // (BLOCKS_PER_SM * sms))))
    split_len = per_split * chunk
    return Geometry(gt, n_gt, maxg, lpr, nv, steps, split_len, -(-S // split_len), rows,
                    -(-(gt * dh + 2 * gt) // 4) * 4)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# device index -> int32 counters of the kernel's rows, 0 between calls (the
# last block of a row resets its own)
_COUNTERS: dict = {}


def _counters(dev: torch.device, rows: int) -> torch.Tensor:
    c = _COUNTERS.get(dev.index)
    if c is None or c.numel() < rows:
        c = torch.zeros(max(rows, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[dev.index] = c
    return c


def flash_decode(q, cache_k, cache_v, pos_vec):
    """q: [B, KV, G, dh]; cache_k/v: [B, S, KV, dh]; pos_vec: [B] int32.

    Returns [B, KV, G, dh] float32: each row attends to cache positions
    0..pos_vec[b] inclusive.  One launch of the kernel.
    """
    B, KV, G, dh = q.shape
    S = cache_k.shape[1]
    dev = q.device
    if dev.type != "cuda" or cache_k.device != dev or cache_v.device != dev:
        raise ValueError("flash_decode kernel needs q and the caches on one CUDA device")
    if not (q.dtype == cache_k.dtype == cache_v.dtype) or q.dtype not in (
        torch.float32, torch.bfloat16
    ):
        raise ValueError(f"q and caches must share float32 or bfloat16; got {q.dtype}")
    if cache_k.shape != (B, S, KV, dh) or cache_v.shape != cache_k.shape:
        raise ValueError(f"caches must be [B,S,KV,dh]={B, S, KV, dh}")
    if not (q.is_contiguous() and cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("q and caches must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, cache_k, cache_v)):
        raise ValueError("flash_decode kernel reads q and the caches in 16-byte loads: "
                         "they must start 16-byte aligned")
    geo = geometry(B, S, KV, G, dh, q.element_size(), _sms(dev.index))
    pos = pos_vec.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, KV, G, dh), dtype=torch.float32, device=dev)
    part = torch.empty(geo.scratch_floats, dtype=torch.float32, device=dev)
    count = _counters(dev, geo.rows)
    build.launch(
        "flash_decode", "flash_decode", "flash_decode",
        int(q.dtype == torch.bfloat16), q.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), pos.data_ptr(), out.data_ptr(), part.data_ptr(), count.data_ptr(),
        B, S, KV, G, dh, geo.gt, geo.maxg, geo.lpr, geo.nv, geo.steps, geo.split_len,
        geo.n_splits, dh ** -0.5, torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


def flash_decode_ref(q, cache_k, cache_v, pos_vec):
    """Plain version: the einsum/mask/softmax block the kernel replaces
    (full-S logits materialised)."""
    dh = q.shape[-1]
    S = cache_k.shape[1]
    logits = torch.einsum(
        "bkgd,btkd->bkgt", q.to(torch.float32), cache_k.to(torch.float32)
    ) * (dh ** -0.5)
    mask = torch.arange(S, device=q.device)[None, :] <= pos_vec[:, None]  # [B, S]
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", probs, cache_v.to(torch.float32))
