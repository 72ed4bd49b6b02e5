"""The correctness check on the CPU at a small size: sound runs come out
correct, and the control and each fault a cell can have come out not
correct.

Each test drives a whole run (set-up, window, check) through
``run.run_cell`` on the CPU, skipping only the harness's look for a card;
the port takes its kernels' plain versions there.
"""

import time

import pytest
import torch

from perfbench import control, run, spec

BENCH = spec.load_benchmark()
SEED = 2 ** 31 + 4321


def tiny_cell(name: str, seed: int = SEED):
    cell = run.make_cell(BENCH, name, seed, "cpu", False)
    cfg, tr = cell.cfg, cell.traffic
    # Somewhat more lists than blobs, as at the configuration's size, so
    # that trained lists find every blob.
    cfg.update(n_rows=6000, n_lists=32, n_probes=8)
    cfg["dataset"]["n_blobs"] = 16
    if cfg["system"] == "ivf_pq":
        # Rows enough that the program's codebooks (256 codewords a
        # subspace) train on some tens of residuals a codeword.
        cfg.update(n_rows=12000, n_lists=16, n_probes=4)
        cfg["dataset"]["n_blobs"] = 8
    if tr["loop"] == "batch":
        tr.update(batch=256, pool_batches=2, check_rows=64)
    else:
        tr.update(check_rows=64)
    return cell


def run_tiny(cell, seconds=1.0):
    return run.run_cell(BENCH, cell, seconds, time.perf_counter())


def failed_checks(out):
    return sorted(k for k, c in out["checks"].items() if not c["ok"])


def compressed_on_cpu(monkeypatch, cell):
    """IVF-PQ's compressed tier (B4's plain version) on the CPU, where
    "auto" would take the LUT scan."""
    sysm = cell.system
    params = sysm.search_params

    def forced(cfg, int8_lut=False):
        p = params(cfg, int8_lut)
        p.engine = "bucketed"
        return p

    monkeypatch.setattr(sysm, "search_params", forced)


@pytest.mark.parametrize("name", ["flat-batch", "flat-build", "pq-batch"])
def test_sound_run_is_correct(name, monkeypatch):
    cell = tiny_cell(name)
    if cell.cfg["system"] == "ivf_pq":
        compressed_on_cpu(monkeypatch, cell)
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert "recall" in out["checks"] and "gap" in out["checks"]
    assert list(out)[-1] == "checks"


def run_variant(cell, variant, monkeypatch):
    if cell.cfg["system"] == "ivf_pq":
        compressed_on_cpu(monkeypatch, cell)
    return control.run_variant(BENCH, cell, variant, 1.0)


@pytest.mark.parametrize("name", ["flat-batch", "pq-batch"])
def test_search_control_is_not_correct(name, monkeypatch):
    """The reference in TF32 (IVF-Flat) or the port's int8 tables
    (IVF-PQ) in the program's place."""
    out = run_variant(tiny_cell(name), "search", monkeypatch)
    assert not out["correct"]
    assert set(failed_checks(out)) & {"gap", "dist_err"}


@pytest.mark.parametrize("name", ["flat-build", "pq-batch"])
def test_build_control_is_not_correct(name, monkeypatch):
    """The build's assignment (and IVF-PQ's encoding) in TF32: eight
    blobs split over the lists put many rows near the border of two."""
    cell = tiny_cell(name)
    cell.cfg["dataset"]["n_blobs"] = 8
    out = run_variant(cell, "build", monkeypatch)
    assert not out["correct"]
    assert set(failed_checks(out)) & {"assign_gap", "code_gap"}


@pytest.mark.parametrize("name,variant,number", [
    ("flat-build", "unchanged", "inertia_excess"),
    ("flat-batch", "unchanged", "inertia_excess"),
    ("pq-batch", "unchanged", "inertia_excess"),
    ("pq-batch", "books_unchanged", "book_excess")])
def test_untrained_index_is_not_correct(name, variant, number, monkeypatch):
    """A build whose k-means (or codebook training) returns its state
    unchanged."""
    out = run_variant(tiny_cell(name), variant, monkeypatch)
    assert not out["correct"]
    assert number in failed_checks(out)


def test_the_variants_leave_the_port_as_it_was(monkeypatch):
    from raft_tpu_torch.cluster import kmeans_balanced
    from raft_tpu_torch.neighbors import ivf_pq

    before = (kmeans_balanced._fit, kmeans_balanced._predict,
              ivf_pq._nearest_code, ivf_pq._vq_train_batched)
    cell = tiny_cell("pq-batch")
    sysm = cell.system
    for variant in control.VARIANTS:
        if variant != "program":
            control.VARIANTS[variant](cell)
            control.restore(cell)
    assert before == (kmeans_balanced._fit, kmeans_balanced._predict,
                      ivf_pq._nearest_code, ivf_pq._vq_train_batched)
    assert sysm.build is spec.module("systems", "ivf_pq").build


def _altered(search, how):
    def wrapped(index, cfg, Q, k):
        d, i = search(index, cfg, Q, k)
        i = i.clone()
        if how == "answer":
            # One answer altered where it is produced: the first query's
            # best id replaced by a row far from it.
            i[0, 0] = (int(i[0, -1]) + i.new_tensor(1)) % 100
        else:
            # Half of the batch left out: its rows answered with the
            # other half's answers.
            h = i.shape[0] // 2
            i[h:2 * h] = i[:h]
            d = d.clone()
            d[h:2 * h] = d[:h]
        return d, i
    return wrapped


@pytest.mark.parametrize("how", ["answer", "half"])
@pytest.mark.parametrize("name", ["flat-batch", "flat-build"])
def test_fault_is_not_correct(name, how, monkeypatch):
    cell = tiny_cell(name)
    monkeypatch.setattr(cell.system, "search",
                        _altered(cell.system.search, how))
    out = run_tiny(cell)
    assert not out["correct"], out["checks"]


def test_misplaced_row_is_not_correct(monkeypatch):
    """A build that loses a row from its lists."""
    cell = tiny_cell("flat-build")
    build = cell.system.build

    def lossy(cfg, X):
        index = build(cfg, X)
        index.list_sizes[0] -= 1
        return index

    monkeypatch.setattr(cell.system, "build", lossy)
    out = run_tiny(cell)
    assert "misplaced" in failed_checks(out)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_cell_runs_on_the_card(card):
    import json
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "flat-batch",
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        cwd=spec.REPO, capture_output=True, text=True, timeout=900,
        check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
