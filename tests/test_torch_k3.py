"""K3 (``flash_decode``) as split across the card, on the CPU: the split
schedule of ``csrc/flash_decode.cu`` rendered in plain torch, with the
geometry the wrapper passes the kernel (``flash_decode.geometry``), held
against the plain version and the JAX reference.

* The schedule: a row's keys 0..min(pos, S-1) are cut into splits of
  ``split_len`` keys; a split wholly past pos does nothing (split 0 always
  runs); each live split forms (m, l, acc) over its keys, and the splits
  combine in split order.  G tiles take ``gt`` query heads each.  Rendered
  here, it is the plain version and the JAX kernel (interpret mode) within
  1e-5, as ``tests/test_torch_kernels.py::test_k3_flash_decode`` holds the
  port's plain version.
* The geometry: the block counts at the serving shapes, and every key
  0..S-1 in exactly one split.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as j_flash
from repro.kernels.flash_decode import flash_decode_ref as j_flash_ref
from repro_torch.kernels import flash_decode as fd

TOL = 1e-5  # online softmax reassociates the normaliser sum


def render_splits(q, ck, cv, pos, geo):
    """The kernel's schedule in plain torch (float32): per (batch row, KV
    head, G tile), each live split's (m, l, acc) over its keys, combined in
    split order."""
    B, KV, G, dh = q.shape
    S = ck.shape[1]
    scale = dh ** -0.5
    out = torch.empty((B, KV, G, dh), dtype=torch.float32)
    for b in range(B):
        n = min(int(pos[b]), S - 1) + 1
        for kv in range(KV):
            for t in range(geo.n_gt):
                heads = slice(t * geo.gt, min((t + 1) * geo.gt, G))
                qs = q[b, kv, heads].float()
                parts = []
                for i in range(geo.n_splits):
                    lo, hi = i * geo.split_len, min((i + 1) * geo.split_len, n)
                    if i > 0 and lo >= n:
                        continue  # wholly past pos: the block exits
                    k = ck[b, lo:hi, kv].float()
                    v = cv[b, lo:hi, kv].float()
                    s = (qs @ k.T) * scale
                    m = s.amax(-1)
                    p = torch.exp(s - m[:, None])
                    parts.append((m, p.sum(-1), p @ v))
                M = torch.stack([m for m, _, _ in parts]).amax(0)
                L = torch.zeros_like(M)
                A = torch.zeros((M.numel(), dh))
                for m, l, acc in parts:  # in split order
                    w = torch.exp(m - M)
                    L = L + w * l
                    A = A + w[:, None] * acc
                out[b, kv, heads] = A / L[:, None]
    return out


# (B, S, KV, G, dh, pos): pos a list, or "random" (seeded)
CASES = {
    "pos-0": (2, 70, 2, 4, 128, [0, 0]),
    "pos-last": (2, 70, 2, 4, 128, [69, 69]),
    "pos-past-S": (2, 70, 2, 4, 128, [70, 77]),
    "ragged-S": (3, 70, 2, 4, 128, "random"),
    "splits-past-pos": (2, 200, 1, 2, 128, [5, 40]),
    "g-tiles": (2, 70, 1, 24, 128, "random"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_schedule_matches_plain_and_reference(case, dtype):
    B, S, KV, G, dh, pos = CASES[case]
    rnd = np.random.default_rng(len(case) * 7 + S)
    arrays = [rnd.standard_normal(shape).astype(np.float32)
              for shape in ((B, KV, G, dh), (B, S, KV, dh), (B, S, KV, dh))]
    if pos == "random":
        pos = rnd.integers(0, S, size=B)
    pos = np.asarray(pos, np.int32)
    tdt = getattr(torch, dtype)
    q, ck, cv = (torch.from_numpy(a).to(tdt) for a in arrays)
    geo = fd.geometry(B, S, KV, G, dh, q.element_size())
    if case in ("ragged-S", "splits-past-pos"):
        assert geo.n_splits > 1 and S % geo.split_len
    if case == "splits-past-pos":
        assert (int(pos.max()) + 1) <= (geo.n_splits - 2) * geo.split_len
    if case == "g-tiles":
        assert G * dh > 2048 and geo.n_gt > 1
    got = render_splits(q, ck, cv, torch.from_numpy(pos), geo).numpy()
    want = fd.flash_decode_ref(q, ck, cv, torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    jargs = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays] + [jnp.asarray(pos)]
    for ref in (j_flash(*jargs, interpret=True), j_flash_ref(*jargs)):
        np.testing.assert_allclose(got, np.asarray(ref), atol=TOL, rtol=TOL)


# (B, S, KV, G, dh) at bf16 -> blocks of one call on a card of 132 SMs: the
# parent kernel took B * KV * ceil(G / 16) (8 at the serving shape)
BLOCKS = {
    "serving": ((4, 96, 2, 8, 128), 24),
    "qwen-4k": ((4, 4096, 2, 8, 128), 256),
    "batch-32": ((32, 2048, 2, 8, 128), 256),
    "granite-group": ((4, 96, 1, 48, 128), 72),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_geometry_block_counts(name):
    shape, blocks = BLOCKS[name]
    geo = fd.geometry(*shape, 2, sms=132)
    assert geo.blocks == blocks
    assert geo.blocks <= fd.BLOCKS_PER_SM * 132


@pytest.mark.parametrize("B,S,KV,G,dh,itemsize", [
    (4, 96, 2, 8, 128, 2), (4, 4096, 2, 8, 128, 2), (32, 2048, 2, 8, 128, 2),
    (1, 1, 1, 1, 16, 4), (3, 33, 2, 2, 16, 4), (1, 32768, 1, 8, 128, 2),
    (2, 1000, 1, 40, 64, 2), (1, 100, 1, 3, 2048, 4), (5, 777, 3, 5, 80, 2),
])
def test_geometry_splits_cover_every_key_once(B, S, KV, G, dh, itemsize):
    geo = fd.geometry(B, S, KV, G, dh, itemsize)
    seen = np.zeros(S, np.int64)
    for i in range(geo.n_splits):
        seen[i * geo.split_len:(i + 1) * geo.split_len] += 1
    assert (seen == 1).all()
    assert (geo.n_splits - 1) * geo.split_len < S <= geo.n_splits * geo.split_len
    # heads: every one in exactly one tile, each tile within the kernel's registers
    assert geo.gt * (geo.n_gt - 1) < G <= geo.gt * geo.n_gt and geo.gt <= geo.maxg <= geo.lpr
    assert geo.maxg * geo.nv <= fd.LANE_CHUNKS or geo.maxg == 1
    # lanes: a row's 16-byte chunks, at most 32 lanes of nv chunks each
    assert geo.lpr * geo.nv * (16 // itemsize) >= dh and (geo.nv == 1 or geo.lpr == 32)


@pytest.mark.parametrize("dh,itemsize", [(12, 2), (6, 4), (4096, 4)])
def test_geometry_refuses_rows_the_kernel_cannot_load(dh, itemsize):
    with pytest.raises(ValueError, match="multiple of"):
        fd.geometry(2, 16, 1, 2, dh, itemsize)
