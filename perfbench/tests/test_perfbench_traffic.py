"""The inputs repeat exactly from a seed, and every seed gets the same
blobs in another order."""

import torch

from perfbench import data, spec

BIG = 2 ** 31 + 987_654_321


def small_cfg():
    cfg = spec.config("sift1m-ivf-flat")
    cfg.update(n_rows=3000, dim=16)
    cfg["dataset"]["n_blobs"] = 30
    return cfg


def test_rows_and_queries_repeat_from_a_seed():
    cfg = small_cfg()
    X1 = data.rows(cfg, BIG, "cpu")
    X2 = data.rows(cfg, BIG, "cpu")
    assert torch.equal(X1, X2)
    assert torch.equal(data.queries(cfg, X1, 50, BIG),
                       data.queries(cfg, X2, 50, BIG))
    assert not torch.equal(X1, data.rows(cfg, BIG + 1, "cpu"))
    assert X1.shape == (3000, 16) and X1.dtype == torch.float32


def test_every_seed_gets_the_same_blobs_in_another_order():
    """With a mix's ``center_seed`` the blob centres are the same for
    every seed; each blob holds the same number of rows."""
    cfg = small_cfg()
    mixes = [spec.traffic(name) for name in ("batch-10k", "rebuild")]
    assert {m["center_seed"] for m in mixes} == {mixes[0]["center_seed"]}
    cs = mixes[0]["center_seed"]
    (Xa, la), (Xb, lb) = (data.blobs(cfg, s, "cpu", cs) for s in (BIG, 7))
    assert not torch.equal(la, lb)
    assert torch.equal(torch.bincount(la), torch.bincount(lb))
    assert torch.bincount(la).unique().numel() == 1

    def means(X, lab):
        return torch.stack([X[lab == b].mean(0) for b in range(30)])

    # The blob means agree to the noise of 100 rows at sigma 5.
    assert float((means(Xa, la) - means(Xb, lb)).abs().max()) < 3.0
    assert torch.equal(data.rows(cfg, BIG, "cpu", cs), Xa)
