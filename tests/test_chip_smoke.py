"""`chip_smoke.py` at tiny sizes on the CPU: its phase functions with the
device check injected (platform "cpu"), its metrics, and its refusal to
run — or to print a result — without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CARD = "cpu (test)"
TINY_FOREST = dict(query_batch=32, max_candidates=32768, coarse_refine=1024)


@pytest.fixture(scope="module")
def dense():
    x, q = cs.make_dense(6000, 96, 100, 0, n_centers=60)
    gt = cs.phase_gt(x, q, CARD, n_check=32)
    return x, q, gt


def test_phase_device_checks_platform():
    with pytest.raises(RuntimeError, match="expected a gpu device"):
        cs.phase_device("gpu")
    dev = cs.phase_device("cpu")
    assert dev["platform"] == "cpu" and dev["count"] == len(jax.devices())
    with pytest.raises(cs.SmokeFailure):
        cs.phase_device("cpu", count=len(jax.devices()) + 1)


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(RuntimeError):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails_and_prints_no_result(tmp_path):
    """Copied into a directory with nothing else of the repo, the script
    cannot import the package: non-zero exit, no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_hash_tiny():
    out = cs.phase_hash(128, 100, 0, CARD)
    assert out["bits_differ"] == out["bits_near_zero"]


def test_phase_gt_matches_numpy(dense):
    x, q, gt = dense
    ids, _ = cs.numpy_topk(x, q, 10)
    assert cs.recall(gt, ids) > 0.99


def test_phase_forest_tiny(dense):
    x, q, gt = dense
    out = cs.phase_forest(x, q, gt, cs.glove_forest_conf(100, **TINY_FOREST),
                          CARD, n_parity=16)
    assert out[1][2] >= cs.FLOORS["forest_steps1"]


def test_phase_flat_and_kernel_tiny(dense):
    x, q, gt = dense
    out = cs.phase_flat(x, q, gt, CARD, n_parity=16)
    assert out["recall"] >= cs.FLOORS["flat"]
    cs.phase_kernel(out["index"].sketch, q[:24], CARD, wide_d=256,
                    wide_rows=600, wide_b=20, interpret=True)


def test_phase_ivf_tiny(dense):
    x, q, gt = dense
    out = cs.phase_ivf(x, q, gt, CARD, n_parity=16, n_tune=32)
    assert out["recall"] >= cs.FLOORS["ivf"]


def test_phase_memory_tiny(dense, capsys):
    from similaritysearchbyrdf_tpu.index.forest import RDFForest
    from similaritysearchbyrdf_tpu.ops.flat import FlatIndex
    from similaritysearchbyrdf_tpu.vectors import DenseBatch

    x, q, _ = dense
    batch = DenseBatch(np.arange(len(x), dtype=np.int32), x)
    forest = RDFForest(cs.glove_forest_conf(100, **TINY_FOREST)).fit(batch)
    fi = FlatIndex().fit(batch)
    cs.phase_memory(forest, fi, q, CARD)
    out = capsys.readouterr().out
    assert out.count("memory_analysis") == 2 and "temp_size" in out


def test_phase_sparse_tiny():
    out = cs.phase_sparse(3000, 1024, 64, 64, 0, CARD, n_clusters=100,
                          coarse_refine=1024,
                          flat_kw=dict(refine=128, r_groups=32,
                                       query_batch=32))
    assert out["forest"] >= 0.9 and out["flat"] >= 0.9


def test_phase_four_cards_on_virtual_devices():
    """The sharded phase on four virtual CPU devices: placement checks pass
    and recall floors hold."""
    assert len(jax.devices()) >= 4
    cs.phase_four_cards(1500, 64, 100, 0, CARD, n_centers=60,
                        query_batch=32, forest_kw=dict(max_candidates=32768,
                                                       coarse_refine=1024))


@pytest.mark.parametrize("case,want", [
    ("same", (0, 0)), ("near_tie", (0, 1)), ("far", (1, 0)),
    ("short", (1, 0)),
])
def test_parity(case, want):
    a_ids = np.arange(10)[None].repeat(2, 0)
    a_sc = np.linspace(1.0, 0.5, 10)[None].repeat(2, 0)
    b_ids, b_sc = a_ids.copy(), a_sc.copy()
    if case == "near_tie":
        b_ids[0, 9], b_sc[0, 9] = 99, a_sc[0, 9] - 1e-7
    elif case == "far":
        b_ids[1, 9], b_sc[1, 9] = 99, a_sc[1, 9] - 1e-2
    elif case == "short":
        b_ids[0, 9], b_sc[0, 9] = -1, -np.inf
    assert cs.parity(a_ids, a_sc, b_ids, b_sc) == want


@pytest.mark.parametrize("gap,want", [(1e-3, 1), (1e-8, 0)])
def test_gt_mismatches(gap, want):
    ref_ids = np.arange(11)[None]
    ref_sc = np.concatenate([np.linspace(1.0, 0.5, 10), [0.5 - gap]])[None]
    got = ref_ids[:, :10].copy()
    got[0, 9] = 10                       # the 11th row swapped in
    assert cs.gt_mismatches(got, ref_ids, ref_sc) == want
