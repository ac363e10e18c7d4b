"""Window gather + score paths against numpy: the forest's lane-packed
coarse tier (`_coarse_block_scores`, G = 1 and 4 tables per row, block and
window mode, windows clamped at the table end) and the IVF / flat window
scorer (`_window_scores`, `ivf_topk`'s tail-window clip)."""

import numpy as np
import pytest

import jax.numpy as jnp

from similaritysearchbyrdf_tpu.index import forest as FO
from similaritysearchbyrdf_tpu.ops import flat as F
from similaritysearchbyrdf_tpu.ops import ivf as IV


def _q_low(q, proj):
    return np.asarray(FO._coarse_query(jnp.asarray(q), jnp.asarray(proj))
                      .astype(jnp.bfloat16).astype(jnp.float32))


def _ref_block_scores(cbt, proj, q, base, tab, end, bs, start, abs_starts):
    lg_n, caprows, lanes = cbt.shape
    cs = proj.shape[1]
    g = lanes // cs
    ql = _q_low(q, proj)
    b, mb = base.shape
    scores = np.full((b, mb * bs), -np.inf, np.float32)
    pos = np.zeros((b, mb * bs), np.int64)
    for i in range(b):
        for m in range(mb):
            blk = base[i, m] if abs_starts else base[i, m] + m * bs
            if start is not None:
                blk = min(blk, caprows - bs)
            t = tab[i, m]
            lg, seg = t // g, t % g
            for j in range(bs):
                p = blk + j
                pos[i, m * bs + j] = p
                ok = p < end[i, m] and (start is None or p >= start[i, m])
                if ok:
                    row = cbt[lg, p, seg * cs:(seg + 1) * cs]
                    scores[i, m * bs + j] = row.astype(np.float32) @ ql[i]
    return scores, pos


@pytest.mark.parametrize("g,mode", [
    (1, "block"), (4, "block"), (1, "window"), (4, "window"),
    (1, "window_clamped"), (4, "window_clamped"), (1, "abs"), (4, "abs"),
])
def test_coarse_block_scores_match_numpy(g, mode):
    rng = np.random.default_rng(g * 10 + len(mode))
    d, b, mb = 80, 5, 4
    cs = 128 // g if g > 1 else 64
    lanes = cs * g
    l_n = 3 * g                       # tables
    lg_n = l_n // g
    caprows = 1024
    bs = 8 if mode == "block" else 64
    cbt = rng.integers(-127, 128, (lg_n, caprows, lanes)).astype(np.int8)
    proj = np.linalg.qr(rng.normal(size=(d, d)))[0][:, :cs].astype(
        np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    tab = rng.integers(0, l_n, (b, mb)).astype(np.int32)
    start = None
    abs_starts = mode == "abs"
    mo = np.arange(mb) * bs
    if mode == "block":
        base = rng.integers(0, caprows - mb * bs - 8, (b, mb)).astype(
            np.int32)
        end = (base + mo + rng.integers(1, bs + 1, (b, mb))).astype(np.int32)
    else:
        if mode == "abs":
            blk = rng.integers(0, (caprows - bs) // 8, (b, mb)) * 8
            base = blk
        elif mode == "window":
            base = rng.integers(0, (caprows - mb * bs) // 8, (b, mb)) * 8
            blk = base + mo
        else:
            # the last windows run past the table end: they are read
            # clamped to [caprows - bs, caprows) and keep their live rows
            base = np.full((b, mb), caprows - mb * bs + 24)
            blk = base + mo
            assert (blk > caprows - bs).any()
        start = (blk + rng.integers(0, 5, (b, mb))).astype(np.int32)
        end = np.minimum(blk + rng.integers(bs // 2, bs + 1, (b, mb)),
                         caprows).astype(np.int32)
        base = base.astype(np.int32)
    got_s, got_p, got_t = FO._coarse_block_scores(
        jnp.asarray(cbt), jnp.asarray(proj), jnp.asarray(q),
        jnp.asarray(base), jnp.asarray(tab), jnp.asarray(end), bs,
        start_b=None if start is None else jnp.asarray(start),
        abs_starts=abs_starts,
    )
    ref_s, ref_p = _ref_block_scores(cbt, proj, q, base, tab, end, bs,
                                     start, abs_starts)
    got_s = np.asarray(got_s)
    np.testing.assert_array_equal(np.isfinite(got_s), np.isfinite(ref_s))
    live = np.isfinite(ref_s)
    np.testing.assert_allclose(got_s[live], ref_s[live], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(np.asarray(got_p)[live], ref_p[live])
    np.testing.assert_array_equal(np.asarray(got_t),
                                  np.repeat(tab, bs, axis=1))


@pytest.mark.parametrize("win,dtype", [(8, "int8"), (64, "int8"),
                                       (8, "bfloat16"), (64, "bfloat16")])
def test_window_scores_match_numpy(win, dtype):
    """Contiguous rows from each start (clipped to the table), scored in
    bf16 with f32 accumulation."""
    rng = np.random.default_rng(win)
    npad, d, b, w = 700, 128, 4, 5
    x = rng.normal(size=(npad, 100)).astype(np.float32)
    sk, _ = F.build_flat_sketch(jnp.asarray(x), dtype)
    q = rng.normal(size=(b, 100)).astype(np.float32)
    starts = rng.integers(0, npad, (b, w)).astype(np.int32)
    starts[:, -1] = npad - win // 2          # runs past the table end
    got = np.asarray(F._window_scores(sk, jnp.asarray(q),
                                      jnp.asarray(starts), win))
    skf = np.asarray(sk.astype(jnp.bfloat16).astype(jnp.float32))
    qb = np.zeros((b, d), np.float32)
    qb[:, :100] = np.asarray(jnp.asarray(q).astype(jnp.bfloat16)
                             .astype(jnp.float32))
    rows = np.clip(starts[:, :, None] + np.arange(win), 0, npad - 1)
    ref = np.einsum("bwjd,bd->bwj", skf[rows], qb)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("win", [8, 64, 128])
def test_ivf_full_probe_exhaustive_matches_exact(win):
    """Probing every cluster with refine >= rows is exhaustive, so the
    result is exact top-k — including windows that start past
    `npad - win` and are read shifted left (the tail-window clip): a
    mislabeled shift would score rows under the wrong ids."""
    rng = np.random.default_rng(win)
    n, d, k = 600, 32, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = rng.normal(size=(16, d)).astype(np.float32)
    st = IV.build_ivf(jnp.asarray(x), np.arange(n, dtype=np.int32),
                      target_cluster=48, iters=2, seed=1)
    starts, ends = np.asarray(st.starts), np.asarray(st.ends)
    npad = st.sketch.shape[0]
    kc = len(ends)
    wins = [s + j * win for s, e in zip(starts[:-1], ends)
            for j in range(-(-(e - s) // win))]
    if win > 8:
        assert max(wins) > npad - win, "no window reaches the clip"
    wb = IV.ivf_window_budget(st.starts, st.ends, kc, win)
    ids, sc = IV.ivf_topk(
        st.sketch, st.corpus, st.row_ids, st.centroids, st.starts, st.ends,
        jnp.asarray(q), jnp.full((16,), -1, jnp.int32), k, nprobe=kc,
        win=win, wb=wb, refine=1024, exclude_self=False)
    gt = np.argsort(-(q.astype(np.float64) @ x.T.astype(np.float64)),
                    axis=1)[:, :k]
    np.testing.assert_array_equal(np.asarray(ids), gt)
