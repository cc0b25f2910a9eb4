"""The split-KV order of the Hopper decode kernels (``csrc/flash_decode.cuh``)
held to the JAX package on the CPU, where the kernels cannot run.

A plain-torch model of the kernels' chunk-and-merge order lives here: the
slots of one (row, kv head) split into chunks of ``n`` consecutive logical
slots; rank r of a cluster of ``cl`` takes the chunks r, r + cl, ... that
meet the row's visible slots [s_lo, s_hi) (every slot of a ring), in
ascending order, with an online softmax (chunk max, probabilities, sum,
P.V); the ranks' partials merge in rank order, a rank that saw nothing
contributing m = -inf, l = 0, acc = 0. On small shapes the model is held to
``repro.kernels.flash_decode.flash_decode_pallas`` in interpret mode and to
``repro_torch.kernels.ref.flash_decode_ref`` at TOL (ring, window, ragged
offsets, per-row positions, chunks that are skipped or wholly masked), its
paged form to ``flash_decode_paged_pallas`` and ``flash_decode_paged_ref``
(int8 pools too). The merge algebra is checked bit for bit: empty partials
change nothing, slots past pos change nothing, a row equals its solo run.
A row that sees no slot (no rank saw one) takes instead the mean of V over
every slot, summed in logical slot order (the Pallas kernel leaves a
block-dependent mean of V there, so such rows are held to the plain
versions only)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import cpu_share  # noqa: F401 (autouse)
from repro.kernels.flash_decode import (flash_decode_paged_pallas,
                                        flash_decode_pallas)
from repro_torch.kernels import ref as tref

TOL = 1e-5      # f32 sums in another order than the Pallas kernel's
NEG = -math.inf


def _range(pos, off, window, ring, S):
    """[s_lo, s_hi): the slots the kernels visit (a ring: all of them)."""
    if ring:
        return 0, S
    lo = max(0, off)
    if window is not None:
        lo = max(lo, pos - window + 1)
    return lo, min(S, pos + 1)


def _partials(qf, k, v, vis, lo, hi, n, cl, log=None):
    """Per-rank (m, l, acc) of one (row, kv head) in rank order: qf (G, hd)
    the scaled (rotated) query rows, k, v (S, hd) f32, vis (S,) bool. A
    chunk always holds n slots: those past S are zero and hidden, as the
    kernels zero-fill them."""
    G, hd = qf.shape
    pad = -k.shape[0] % n
    k = torch.cat([k, k.new_zeros(pad, hd)])
    v = torch.cat([v, v.new_zeros(pad, hd)])
    vis = torch.cat([vis, vis.new_zeros(pad)])
    parts = []
    for r in range(cl):
        m = torch.full((G,), NEG)
        l = torch.zeros(G)
        acc = torch.zeros(G, hd)
        if hi > lo:
            c_lo, c_hi = lo // n, (hi - 1) // n + 1
            for c in range(c_lo + (r - c_lo) % cl, c_hi, cl):
                s = torch.arange(c * n, (c + 1) * n)
                lg = torch.where(vis[s], qf @ k[s].T, NEG)
                m_new = torch.maximum(m, lg.max(-1).values)
                seen = m_new > NEG
                p = torch.where(seen[:, None], torch.exp(lg - m_new[:, None]),
                                0.0)
                alpha = torch.where(seen, torch.exp(m - m_new), 1.0)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + p @ v[s]
                m = m_new
                if log is not None:
                    log.append((r, c, bool(vis[s].any())))
        parts.append((m, l, acc))
    return parts


def _merge(parts):
    """Rank 0's merge: rank order, every product and sum spelled out."""
    M = torch.stack([p[0] for p in parts])
    mx = M.max(0).values
    lsum = torch.zeros_like(mx)
    a = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        f = torch.where(mx > NEG, torch.exp(m - mx), 0.0)
        lsum = lsum + l * f
        a = a + acc * f[:, None]
    return torch.where(lsum[:, None] > 0, a / lsum[:, None], 0.0)


def chunked_decode(q, k, v, pos, *, n, cl, window=None, ring=False,
                   offsets=None, rope_theta=None, log=None):
    """The kernels' order on a contiguous cache: q (B, H, hd), k, v (B, KV,
    S, hd) f32 -> (B, H, hd)."""
    B, H, hd = q.shape
    KV, S = k.shape[1], k.shape[2]
    G = H // KV
    posb = torch.as_tensor(pos).reshape(-1).expand(B).long()
    off = torch.zeros(B, dtype=torch.long) if offsets is None \
        else offsets.long()
    qf = q.float()
    if rope_theta is not None:
        qf = tref.rope_rotate(qf, (posb - off)[:, None].expand(B, H),
                              rope_theta)
    qf = qf * (1.0 / math.sqrt(hd))
    out = torch.zeros(B, H, hd)
    slots = torch.arange(S)
    for b in range(B):
        p, o = int(posb[b]), int(off[b])
        vis = tref.slot_visibility(slots, p, seq_k=S, window=window,
                                   ring=ring, offset=o)
        lo, hi = _range(p, o, window, ring, S)
        for h in range(KV):
            parts = _partials(qf[b, h * G:(h + 1) * G], k[b, h].float(),
                              v[b, h].float(), vis, lo, hi, n, cl, log)
            if all(bool((m == NEG).all()) for m, _, _ in parts):
                out[b, h * G:(h + 1) * G] = v[b, h].float().sum(0) / S
            else:
                out[b, h * G:(h + 1) * G] = _merge(parts)
    return out


def chunked_decode_paged(q, kp, vp, pt, pos, *, n, cl, window=None,
                         offsets=None, k_scale=None, v_scale=None,
                         rope_theta=None):
    """The same order on a page pool: only the visible slots' rows are
    gathered (dequantized in f32 for an int8 pool); the rest are zero, but
    for a row that sees no slot, which reads every logical slot."""
    B = q.shape[0]
    KV, ps, hd = kp.shape[1], kp.shape[2], kp.shape[3]
    S = pt.shape[1] * ps
    posb = torch.as_tensor(pos).reshape(-1).expand(B).long()
    off = torch.zeros(B, dtype=torch.long) if offsets is None \
        else offsets.long()
    k = torch.zeros(B, KV, S, hd)
    v = torch.zeros(B, KV, S, hd)
    for b in range(B):
        lo, hi = _range(int(posb[b]), int(off[b]), window, False, S)
        for s in range(lo, hi) if hi > lo else range(S):
            page, at = int(pt[b, s // ps]), s % ps
            k[b, :, s] = kp[page, :, at].float()
            v[b, :, s] = vp[page, :, at].float()
            if k_scale is not None:
                k[b, :, s] *= k_scale[page, :, at][:, None]
                v[b, :, s] *= v_scale[page, :, at][:, None]
    return chunked_decode(q, k, v, pos, n=n, cl=cl, window=window,
                          offsets=offsets, rope_theta=rope_theta)


def _inputs(B, H, KV, S, hd, seed):
    r = np.random.RandomState(seed)
    return tuple(r.randn(*s).astype(np.float32)
                 for s in ((B, H, hd), (B, KV, S, hd), (B, KV, S, hd)))


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=msg)


CASES = [   # B, H, KV, S, hd, window, ring, offsets, rope_theta
    (2, 4, 4, 70, 32, None, False, None, None),         # MHA
    (3, 8, 2, 70, 64, 24, False, (0, 5, 40), 1e4),      # GQA, window, pad
    (2, 4, 2, 16, 64, 16, True, (0, 3), 1e6),           # ring, ragged
    (2, 4, 2, 40, 32, 9, True, None, None),             # ring, masked chunks
    (3, 4, 1, 64, 32, None, False, (0, 5, 63), 1e4),    # pads, skipped chunks
]


@pytest.mark.parametrize("n,cl", [(16, 8), (8, 3)])
@pytest.mark.parametrize("B,H,KV,S,hd,window,ring,offs,theta", CASES)
def test_chunk_model_matches_reference(B, H, KV, S, hd, window, ring, offs,
                                       theta, n, cl):
    q, k, v = _inputs(B, H, KV, S, hd, S + hd + n)
    off = None if offs is None else np.array(offs, np.int32)
    lo = 0 if offs is None else max(offs)
    per_row = np.array([min(S - 1, lo + 11 * i) for i in range(B)],
                       np.int32)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    toff = None if off is None else torch.tensor(off)
    joff = None if off is None else jnp.asarray(off)
    for pos in (lo, S - 1, (S + 7) if ring else n - 1, per_row):
        tpos = torch.tensor(pos) if isinstance(pos, np.ndarray) else pos
        got = chunked_decode(tq, tk, tv, tpos, n=n, cl=cl, window=window,
                             ring=ring, offsets=toff, rope_theta=theta)
        _close(got, tref.flash_decode_ref(tq, tk, tv, tpos, window=window,
                                          ring=ring, offsets=toff,
                                          rope_theta=theta), f"ref {pos}")
        want = flash_decode_pallas(q, k, v, jnp.asarray(pos, jnp.int32),
                                   window=window, ring=ring, offsets=joff,
                                   rope_theta=theta, interpret=True)
        seen = tref.slot_visibility(
            torch.arange(S)[None], torch.as_tensor(pos).reshape(-1, 1),
            seq_k=S, window=window, ring=ring,
            offset=None if toff is None else toff[:, None].long()).any(-1)
        seen = seen.expand(B).numpy()
        _close(got.numpy()[seen], np.asarray(want)[seen], f"pallas {pos}")


def test_chunk_model_row_that_sees_no_slot_is_zero():
    """No rank sees a slot of row 0: it is the mean of V over the S slots,
    as the plain version's softmax of equal masked logits, its paged form
    too (every logical slot read through the block table)."""
    q, k, v = map(torch.tensor, _inputs(2, 4, 2, 40, 32, 3))
    pos, off = torch.tensor([10, 20]), torch.tensor([11, 0])
    got = chunked_decode(q, k, v, pos, n=8, cl=8, offsets=off)
    torch.testing.assert_close(got[0], v[0].mean(1).repeat_interleave(2, 0),
                               rtol=TOL, atol=TOL)
    assert got[1].abs().sum() > 0
    torch.testing.assert_close(got, tref.flash_decode_ref(q, k, v, pos,
                                                          offsets=off),
                               rtol=TOL, atol=TOL)
    kp, vp, pt = map(torch.tensor, _pool(k.numpy(), v.numpy(), 8))
    paged = chunked_decode_paged(q, kp, vp, pt, pos, n=8, cl=8, offsets=off)
    assert torch.equal(paged, got)
    torch.testing.assert_close(paged, tref.flash_decode_paged_ref(
        q, kp, vp, pt, pos, offsets=off), rtol=TOL, atol=TOL)


def test_chunk_model_skips_outside_chunks_and_masks_ring_chunks():
    """Chunks wholly outside [s_lo, s_hi) are never visited; a ring visits
    every chunk, and one whose slots are all hidden leaves the partial as
    it was (p = 0, alpha = 1)."""
    q, k, v = map(torch.tensor, _inputs(1, 2, 1, 64, 32, 5))
    log = []
    chunked_decode(q, k, v, 40, n=8, cl=3, offsets=torch.tensor([20]),
                   log=log)
    assert sorted(c for _, c, _ in log) == [2, 3, 4, 5]
    assert all(r == c % 3 for r, c, _ in log)
    log = []
    got = chunked_decode(q, k, v, 70, n=8, cl=3, window=5, ring=True,
                         log=log)
    assert sorted(c for _, c, _ in log) == list(range(8))
    assert any(not any_seen for _, _, any_seen in log)
    torch.testing.assert_close(got, tref.flash_decode_ref(
        q, k, v, 70, window=5, ring=True), rtol=TOL, atol=TOL)


def test_empty_partials_leave_the_merge_bit_identical():
    """m = -inf, l = 0, acc = 0 from a rank that saw no slot changes no bit
    of the merge, wherever it stands in rank order."""
    g = torch.Generator().manual_seed(0)
    parts = [(torch.randn(3, generator=g), torch.rand(3, generator=g) + 0.5,
              torch.randn(3, 16, generator=g)) for _ in range(3)]
    empty = (torch.full((3,), NEG), torch.zeros(3), torch.zeros(3, 16))
    want = _merge(parts)
    for at in range(4):
        assert torch.equal(_merge(parts[:at] + [empty] + parts[at:]), want)
    assert torch.equal(_merge(parts + [empty] * 5), want)
    assert not _merge([empty] * 8).any()


def test_chunk_model_slots_past_pos_and_batch_change_no_bit():
    """A cache of 70 slots and the same contents padded to 128, and each row
    alone: equal bits (chunks depend on logical slot indices only)."""
    q, k, v = map(torch.tensor, _inputs(3, 8, 2, 70, 64, 9))
    pad = torch.tensor(np.random.RandomState(1).randn(3, 2, 58, 64)
                       .astype(np.float32))
    pos, off = torch.tensor([69, 20, 45]), torch.tensor([0, 3, 30])
    kw = dict(n=16, cl=8, offsets=off, rope_theta=1e4)
    got = chunked_decode(q, k, v, pos, **kw)
    assert torch.equal(got, chunked_decode(q, torch.cat([k, pad], 2),
                                           torch.cat([v, pad], 2), pos, **kw))
    for r in range(3):
        one = slice(r, r + 1)
        solo = chunked_decode(q[one], k[one], v[one], pos[one], n=16, cl=8,
                              offsets=off[one], rope_theta=1e4)
        assert torch.equal(solo[0], got[r])


def _pool(k, v, ps, seed=0):
    B, KV, S, hd = k.shape
    NB = S // ps
    pt = np.random.RandomState(seed).permutation(
        np.arange(1, 1 + B * NB)).astype(np.int32).reshape(B, NB)

    def pool(x):
        blocks = x.reshape(B, KV, NB, ps, hd).transpose(0, 2, 1, 3, 4)
        p = np.zeros((1 + B * NB, KV, ps, hd), x.dtype)
        p[pt.reshape(-1)] = blocks.reshape(B * NB, KV, ps, hd)
        return p

    return pool(k), pool(v), pt


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("window,offs,theta", [(None, None, None),
                                               (24, (0, 9, 40), 1e4)])
def test_paged_chunk_model_matches_reference(window, offs, theta, int8):
    B, H, KV, ps, NB, hd = 3, 8, 2, 7, 10, 32
    q, k, v = _inputs(B, H, KV, NB * ps, hd, 21)
    kp, vp, pt = _pool(k, v, ps)
    sc = {}
    if int8:
        (kq, ks), (vq, vs) = (tref.quantize_slots(torch.tensor(kp)),
                              tref.quantize_slots(torch.tensor(vp)))
        kp, vp = kq.numpy(), vq.numpy()
        sc = dict(k_scale=ks.numpy(), v_scale=vs.numpy())
    off = None if offs is None else np.array(offs, np.int32)
    pos = np.array([69, 33, 47], np.int32)
    t = {key: torch.tensor(a) for key, a in sc.items()}
    toff = None if off is None else torch.tensor(off)
    got = chunked_decode_paged(torch.tensor(q), torch.tensor(kp),
                               torch.tensor(vp), torch.tensor(pt),
                               torch.tensor(pos), n=16, cl=8, window=window,
                               offsets=toff, rope_theta=theta, **t)
    _close(got, tref.flash_decode_paged_ref(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(pt), torch.tensor(pos), window=window, offsets=toff,
        rope_theta=theta, **t), "ref")
    _close(got, flash_decode_paged_pallas(
        q, kp, vp, jnp.asarray(pt), jnp.asarray(pos), window=window,
        offsets=None if off is None else jnp.asarray(off), rope_theta=theta,
        interpret=True, **{key: jnp.asarray(a) for key, a in sc.items()}),
        "pallas")
    if not int8:   # the paged order is the contiguous order, bit for bit
        assert torch.equal(got, chunked_decode(
            *map(torch.tensor, (q, k, v)), torch.tensor(pos), n=16, cl=8,
            window=window, offsets=toff, rope_theta=theta))


def test_paged_chunk_model_reads_nothing_past_pos():
    """Block-table entries past pos may hold anything: equal bits."""
    q, k, v = _inputs(2, 4, 2, 64, 32, 4)
    kp, vp, pt = _pool(k, v, 16)
    pos = torch.tensor([19, 31])
    garbage = pt.copy()
    garbage[:, 2:] = 10 ** 6
    kw = dict(n=8, cl=8)
    args = (torch.tensor(q), torch.tensor(kp), torch.tensor(vp))
    assert torch.equal(
        chunked_decode_paged(*args, torch.tensor(garbage), pos, **kw),
        chunked_decode_paged(*args, torch.tensor(pt), pos, **kw))

