"""The rating-table generator at reduced sizes."""

import json
import os

import numpy as np
import torch

from benchmark.data import ratings
from benchmark.tests.conftest import REPO, TINY

CPU = torch.device("cpu")


def test_same_seed_same_table_other_seed_other_table():
    a = ratings.generate(TINY, 2**40 + 3, CPU)
    b = ratings.generate(TINY, 2**40 + 3, CPU)
    c = ratings.generate(TINY, 2**40 + 4, CPU)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[1], c[1])


def test_published_counts_unique_pairs_and_sorted_rows():
    pid, item, value = ratings.generate(TINY, 11, CPU)
    s = ratings.summary(TINY, pid, item, value)
    assert s["ratings"] == TINY["ratings"]
    assert s["users"] == TINY["users"]
    assert s["items_rated"] == TINY["items"]
    assert s["top_item_ratings"] == TINY["top_item_ratings"]
    assert s["unique_pairs"]
    key = pid * TINY["items"] + item
    assert np.all(np.diff(key) > 0)
    assert set(np.unique(value).tolist()) <= set(TINY["rating_levels"])


def test_every_user_is_topped_up_to_the_minimum():
    # 25 ratings a user on average: uniform raters leave some under 20.
    cfg = dict(TINY, ratings=75000)
    pid, item, _ = ratings.generate(cfg, 5, CPU)
    per_user = np.bincount(pid, minlength=cfg["users"])
    assert per_user.min() >= 20
    assert len(pid) == cfg["ratings"]
    assert np.array_equal(np.sort(np.bincount(item))[::-1],
                          ratings.item_counts(cfg))
    assert len(np.unique(pid * cfg["items"] + item)) == len(pid)


def test_fitted_head_holds_the_published_top_count():
    for name in ("movielens25m", "movielens1m"):
        with open(os.path.join(REPO, "benchmark", "configs",
                               name + ".json")) as f:
            cfg = json.load(f)
        counts = ratings.item_counts(cfg)
        assert counts[0] == cfg["top_item_ratings"]
        assert counts.sum() == cfg["ratings"]
        assert len(counts) == cfg["items"] and counts.min() >= 1
        q = ratings.fit_offset(cfg["ratings"], cfg["items"],
                               cfg["top_item_ratings"],
                               cfg["popularity_exponent"])
        r = np.arange(1, cfg["items"] + 1)
        w = (r + q) ** -cfg["popularity_exponent"]
        assert abs(cfg["ratings"] * w[0] / w.sum() -
                   cfg["top_item_ratings"]) < 1e-6 * cfg["ratings"]


def test_rating_shares_are_drawn_as_stated():
    cfg = dict(TINY, ratings=170000, users=6000, items=80,
               top_item_ratings=5000)
    _, _, value = ratings.generate(cfg, 9, CPU)
    got = np.asarray([(value == v).mean() for v in cfg["rating_levels"]])
    assert np.abs(got - np.asarray(cfg["rating_shares"])).max() < 0.006
