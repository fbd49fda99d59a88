"""The rating-table generator: one general generator that every rating
configuration (``configs/<name>.json`` with ``"generator": "ratings"``)
feeds with its published counts and assumed laws.

The table reproduces the published counts exactly: ``ratings`` rows,
``users`` users, ``items`` items each with at least one rating, each
(user, item) pair once, the most-rated item at ``top_item_ratings``, and
every user at ``min_ratings_per_user`` or more. Item popularity follows
``p(r) ~ (r + q) ** -popularity_exponent`` over the ranks ``r = 1..items``
with ``q`` fitted so that rank 1 holds ``top_item_ratings``; each item's
raters are drawn uniformly without replacement; rating values are drawn
from ``rating_levels`` with ``rating_shares``, independently of user and
item. Rows come out sorted by (user, item), as the published files are.

Everything random is drawn from ``--seed`` with one ``torch.Generator`` on
the given device, in a few large calls; the per-item counts depend on the
configuration alone.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

# Items with more raters than users // _DENSE_DIV draw their raters as the
# first of a random permutation; the rest by rejection of repeats.
_DENSE_DIV = 16
# Elements of random keys sorted at once for the dense items.
_DENSE_BLOCK = 1 << 25


def fit_offset(ratings: int, items: int, top: int, exponent: float) -> float:
    """The offset ``q`` at which rank 1's share of ``ratings`` is ``top``:
    the share falls as ``q`` grows, so a bisection on ``log q`` finds it."""
    r = np.arange(1, items + 1, dtype=np.float64)

    def top_share(q):
        w = (r + q) ** -exponent
        return ratings * w[0] / w.sum()

    lo, hi = 1e-9, 1e9
    if not top_share(hi) <= top <= top_share(lo):
        raise ValueError(f"no offset gives rank 1 {top} of {ratings} "
                         f"ratings over {items} items")
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if top_share(mid) > top:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def item_counts(cfg: Dict) -> np.ndarray:
    """int64 [items]: the ratings of each popularity rank, summing to
    ``ratings`` exactly, rank 1 at ``top_item_ratings``, each at least 1
    and at most ``users``."""
    n, m, top = cfg["ratings"], cfg["items"], cfg["top_item_ratings"]
    q = fit_offset(n, m, top, cfg["popularity_exponent"])
    w = (np.arange(1, m + 1, dtype=np.float64) + q) ** -cfg[
        "popularity_exponent"]
    exact = n * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    left = n - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:left]] += 1
    # Rank 1 holds the published count; what it gives or takes comes
    # from the next ranks, one rating each.
    diff = int(counts[0] - top)
    counts[0] = top
    step = 1 if diff > 0 else -1
    for i in range(abs(diff)):
        counts[1 + i] += step
    if counts.min() < 1 or counts.max() > cfg["users"]:
        raise ValueError("an item's count falls outside [1, users]")
    if int(counts.sum()) != n:
        raise ValueError("the item counts do not sum to the ratings")
    return counts


def _dense_pairs(counts: torch.Tensor, ranks: torch.Tensor, users: int,
                 gen: torch.Generator) -> torch.Tensor:
    """rank * users + user keys: for each of ``ranks``, ``counts[rank]``
    users, the first of a random permutation of all users."""
    device = counts.device
    out = []
    per = max(1, _DENSE_BLOCK // users)
    for s in range(0, len(ranks), per):
        block = ranks[s:s + per]
        keys = torch.rand((len(block), users), generator=gen, device=device)
        order = torch.argsort(keys, dim=1, stable=True)
        take = (torch.arange(users, device=device)[None, :] <
                counts[block][:, None])
        out.append(block[:, None].expand_as(order)[take] * users +
                   order[take])
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                  device=device)


def _sparse_pairs(counts: torch.Tensor, ranks: torch.Tensor, users: int,
                  gen: torch.Generator) -> torch.Tensor:
    """The same keys for items with few raters: uniform draws, repeats
    dropped and drawn again until every item has its count."""
    device = counts.device
    m = counts.shape[0]
    have = torch.zeros(0, dtype=torch.int64, device=device)
    need = torch.zeros(m, dtype=torch.int64, device=device)
    need[ranks] = counts[ranks]
    while True:
        total = int(need.sum())
        if total == 0:
            return have
        r = torch.repeat_interleave(torch.arange(m, device=device), need)
        u = torch.randint(0, users, (total,), generator=gen, device=device)
        have = torch.unique(torch.cat([have, r * users + u]))
        need = torch.zeros(m, dtype=torch.int64, device=device)
        need[ranks] = counts[ranks] - torch.bincount(
            have // users, minlength=m)[ranks]


def _top_up(pid: np.ndarray, item: np.ndarray, users: int, minimum: int,
            rng: np.random.Generator) -> None:
    """The inclusion rule: a user under ``minimum`` ratings takes rows,
    one at a time, from users above it, for items the user lacks, so the
    items' counts and the total stay as published. In place."""
    n_u = np.bincount(pid, minlength=users)
    for u in np.flatnonzero(n_u < minimum):
        has = set(item[pid == u].tolist())
        while n_u[u] < minimum:
            j = int(rng.integers(len(pid)))
            if n_u[pid[j]] > minimum and int(item[j]) not in has:
                n_u[pid[j]] -= 1
                pid[j] = u
                n_u[u] += 1
                has.add(int(item[j]))


def generate(cfg: Dict, seed: int, device: torch.device
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(user ids int64, item ids int64, ratings float32) NumPy columns of
    the configuration's table, sorted by (user, item), from ``seed``."""
    users, m = cfg["users"], cfg["items"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    counts_np = item_counts(cfg)
    counts = torch.from_numpy(counts_np).to(device)
    dense = counts_np > users // _DENSE_DIV
    ranks_d = torch.from_numpy(np.flatnonzero(dense)).to(device)
    ranks_s = torch.from_numpy(np.flatnonzero(~dense)).to(device)
    keys = torch.cat([_dense_pairs(counts, ranks_d, users, gen),
                      _sparse_pairs(counts, ranks_s, users, gen)])
    # Item ids: a random permutation of the ranks, so popularity does
    # not follow the id.
    item_of_rank = torch.randperm(m, generator=gen, device=device)
    pid = (keys % users).cpu().numpy()
    item = item_of_rank[keys // users].cpu().numpy()
    n_u = np.bincount(pid, minlength=users)
    if n_u.min() < cfg["min_ratings_per_user"]:
        _top_up(pid, item, users, cfg["min_ratings_per_user"],
                np.random.default_rng([int(seed) % (1 << 63), 1]))
    order = torch.argsort(torch.from_numpy(pid * m + item).to(device))
    levels = torch.tensor(cfg["rating_levels"], dtype=torch.float32,
                          device=device)
    cdf = torch.cumsum(torch.tensor(cfg["rating_shares"],
                                    dtype=torch.float64, device=device), 0)
    cdf = cdf / cdf[-1]
    draw = torch.rand(len(pid), generator=gen, device=device,
                      dtype=torch.float64)
    level = torch.clamp(torch.searchsorted(cdf, draw, right=True), max=len(
        cfg["rating_levels"]) - 1)
    order_np = order.cpu().numpy()
    return (pid[order_np], item[order_np],
            levels[level].cpu().numpy())


def summary(cfg: Dict, pid: np.ndarray, item: np.ndarray,
            value: np.ndarray) -> Dict:
    """The published counts as the table holds them, and the shares the
    assumed laws give (the top 1% of items' share of ratings, the items
    under 20 ratings)."""
    per_item = np.bincount(item)
    per_item = np.sort(per_item[per_item > 0])[::-1]
    per_user = np.bincount(pid, minlength=cfg["users"])
    pairs = pid.astype(np.int64) * (int(item.max()) + 1) + item
    top1 = max(1, len(per_item) // 100)
    return {
        "ratings": int(len(pid)),
        "users": int((per_user > 0).sum()),
        "items_rated": int(len(per_item)),
        "top_item_ratings": int(per_item[0]),
        "min_ratings_per_user": int(per_user.min()),
        "mean_ratings_per_user": float(per_user.mean()),
        "unique_pairs": bool(len(np.unique(pairs)) == len(pairs)),
        "rating_mean": float(value.astype(np.float64).mean()),
        "top_1pct_item_share": float(per_item[:top1].sum() / len(pid)),
        "items_under_20": int((per_item < 20).sum()),
        "popularity_offset": fit_offset(
            cfg["ratings"], cfg["items"], cfg["top_item_ratings"],
            cfg["popularity_exponent"]),
    }


if __name__ == "__main__":
    # The card-free check at full size: python benchmark/data/ratings.py
    # benchmark/configs/movielens25m.json [seed]
    import json
    import sys
    with open(sys.argv[1]) as f:
        config = json.load(f)
    cols = generate(config, int(sys.argv[2]) if len(sys.argv) > 2 else 0,
                    torch.device("cpu"))
    print(json.dumps(summary(config, *cols), indent=1))
