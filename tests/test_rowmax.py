"""`forest.rowmax_packed` (the folded coarse tier's packed row max) against
a numpy oracle: per-window and adjacent-run window patterns, windows
clamped at the table end, dead windows, and the emit2 second-best output,
at two selection-group widths."""

import numpy as np
import pytest

import jax.numpy as jnp

from similaritysearchbyrdf_tpu.index.forest import I32_DEAD, rowmax_packed


def _oracle(folded, qi8, table, rs, wpr, rpg, fold, cs, mshift):
    """Best and second-best packed (score << mshift | member) per row."""
    l_n, capf, _ = folded.shape
    b, mb = table.shape
    best = np.full((b, mb, wpr), I32_DEAD, np.int64)
    second = np.full((b, mb, wpr), I32_DEAD, np.int64)
    for i in range(b):
        for m in range(mb):
            if rs[i, m] < 0:
                continue
            r0 = min(rs[i, m], capf - wpr)
            rows = folded[table[i, m], r0:r0 + wpr]
            for r in range(wpr):
                pks = []
                for s in range(fold):
                    seg = rows[r, s * cs:(s + 1) * cs].astype(np.int64)
                    sc = int(seg @ qi8[i].astype(np.int64))
                    pks.append((sc << mshift) | ((r % rpg) * fold + s))
                pks.sort(reverse=True)
                best[i, m, r], second[i, m, r] = pks[0], pks[1]
    return best, second


def _starts(pattern, rng, b, mb, capf, wpr, l_n):
    table = rng.integers(0, l_n, (b, mb)).astype(np.int32)
    rs = np.zeros((b, mb), np.int32)
    for i in range(b):
        for m in range(mb):
            if pattern == "adjacent" and m and rng.random() < 0.6:
                # consecutive windows of one probed range: same table,
                # physical rows back to back
                table[i, m] = table[i, m - 1]
                rs[i, m] = rs[i, m - 1] + wpr
            else:
                rs[i, m] = int(rng.integers(0, (capf - 4 * wpr) // 8)) * 8
    if pattern == "clamped":
        rs[:, -1] = capf - wpr // 2 // 8 * 8    # past capf - wpr: clipped
    if pattern in ("adjacent", "dead"):
        dead = rng.random((b, mb)) < (0.25 if pattern == "adjacent" else 1.0)
        dead[:, 0] = pattern == "dead"
        rs = np.where(dead, -1, rs).astype(np.int32)
    return table, rs


# emit2 is defined at rpg == 1 (a selection group of gsl == fold slots)
@pytest.mark.parametrize("pattern,gsl,emit2", [
    ("random", 64, False), ("adjacent", 64, False), ("clamped", 64, False),
    ("dead", 64, False), ("random", 8, False), ("adjacent", 8, True),
    ("random", 8, True), ("clamped", 8, True), ("dead", 8, True),
])
def test_rowmax_packed_matches_oracle(pattern, gsl, emit2):
    rng = np.random.default_rng(len(pattern) * gsl + emit2)
    l_n, capf, lanes = 3, 512, 128
    cs, fold = 16, 8
    rpg = gsl // fold
    b, mb, wpr = 3, 10, 16
    mshift = gsl.bit_length() - 1
    folded = rng.integers(-127, 128, (l_n, capf, lanes)).astype(np.int8)
    qi8 = rng.integers(-127, 128, (b, cs)).astype(np.int8)
    qmat = np.zeros((b, fold, lanes), np.int8)
    for s in range(fold):
        qmat[:, s, s * cs:(s + 1) * cs] = qi8
    table, rs = _starts(pattern, rng, b, mb, capf, wpr, l_n)
    out = rowmax_packed(jnp.asarray(folded), jnp.asarray(qmat),
                        jnp.asarray(table), jnp.asarray(rs), wpr=wpr,
                        rpg=rpg, mshift=mshift, emit2=emit2)
    best, second = _oracle(folded, qi8, table, rs, wpr, rpg, fold, cs,
                           mshift)
    got1 = np.asarray(out[0] if emit2 else out).reshape(b, mb, wpr)
    np.testing.assert_array_equal(got1.astype(np.int64), best)
    if emit2:
        got2 = np.asarray(out[1]).reshape(b, mb, wpr)
        np.testing.assert_array_equal(got2.astype(np.int64), second)
