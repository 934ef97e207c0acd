"""Synthetic and public-dataset interaction streams (copy of
``tpu_cooccurrence/io/synthetic.py``): the Zipfian basket generator of
the bench workload and config 4, the calibrated MovieLens-25M,
MovieLens-100K and Instacart stand-ins of benchmark configs 3, 2 and 5,
the word stream of config 1, the MovieLens and Instacart file readers and
the ``user,item,ts`` CSV writer. Every function returns (or writes) the
same arrays (bytes) as the reference package's for the same arguments,
and draws from its generator in the same order."""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np


def zipfian_interactions(
    n_events: int,
    n_items: int = 1_000_000,
    n_users: int = 100_000,
    alpha: float = 1.1,
    seed: int = 0,
    events_per_ms: int = 100,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Zipfian basket stream: item popularity ~ Zipf(alpha), users uniform,
    timestamps ascending at ``events_per_ms`` events per millisecond.

    Returns (users, items, timestamps) int64 arrays, identical to the
    reference package's for the same arguments.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    weights = ranks ** (-alpha)
    items = sample_items(weights / weights.sum(), n_events, rng)
    users = rng.integers(0, n_users, n_events, dtype=np.int64)
    timestamps = (np.arange(n_events, dtype=np.int64) // events_per_ms)
    return users, items, timestamps


def sample_items(weights: np.ndarray, n: int,
                 rng: np.random.Generator) -> np.ndarray:
    """``n`` iid draws from a normalized weight vector via inverse-CDF."""
    cdf = np.cumsum(weights)
    cdf[-1] = 1.0
    return np.searchsorted(cdf, rng.random(n)).astype(np.int64)


def zipf_mandelbrot_weights(n_items: int, s: float, q: float) -> np.ndarray:
    """Normalized Zipf-Mandelbrot law ``w(r) ∝ (r + q)^-s`` over ranks
    1..n_items. Unlike pure Zipf, the offset ``q`` flattens the head —
    real popularity spectra (MovieLens, Instacart) have near-tied top
    items (e.g. ML-25M's top-2 movies within 0.01% of each other),
    which no pure power law reproduces."""
    r = np.arange(1, n_items + 1, dtype=np.float64)
    w = (r + q) ** (-s)
    return w / w.sum()


def truncated_lognormal_activity(n: int, mu: float, sigma: float,
                                 lo: float, hi: float,
                                 rng: np.random.Generator) -> np.ndarray:
    """Per-entity activity weights ~ LogNormal(mu, sigma) clipped to
    [lo, hi] — the user-activity model for the calibrated stand-ins
    (e.g. ML-25M: every user has >= 20 ratings by construction of the
    dataset, median ~71, mean 153.8; a clipped log-normal hits all
    three where a power law cannot)."""
    a = np.exp(rng.normal(mu, sigma, n))
    return np.clip(a, lo, hi)


def _exact_multiplicities(weights: np.ndarray, total: int) -> np.ndarray:
    """Integer counts summing to ``total``, proportional to ``weights``
    (largest-remainder rounding): the generated stream then carries the
    target per-entity marginal EXACTLY, not merely in expectation."""
    expected = total * (weights / weights.sum())
    base = np.floor(expected).astype(np.int64)
    rem = total - int(base.sum())
    if rem > 0:
        frac = expected - base
        base[np.argsort(-frac)[:rem]] += 1
    return base


def calibrated_interactions(
    n_events: int,
    *,
    n_users: int,
    n_items: int,
    item_s: float,
    item_q: float,
    user_mu: float,
    user_sigma: float,
    user_lo: float,
    user_hi: float,
    seed: int = 0,
    events_per_ms: int = 50,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Interaction stream with marginals calibrated to a real dataset.

    Item popularity follows a Zipf-Mandelbrot law fitted to published
    head anchors; per-user activity follows a clipped log-normal fitted
    to the dataset's documented minimum/median/mean. User ids are
    assigned by exact multiplicity (largest remainder) and shuffled
    uniformly over the stream; items are drawn iid from the item law.

    Deliberate simplifications vs real data (docs/calibrated_standins.md
    quantifies them): user/item independence (no taste structure),
    sessionless user activity (a user's events spread uniformly over
    the stream instead of bursting), synthetic ascending timestamps at
    ``events_per_ms`` (window cadence comparable across benchmark
    rounds), and ``n_events`` below the dataset's full size behaves as
    uniform thinning, not a time-prefix.
    """
    rng = np.random.default_rng(seed)
    items = sample_items(zipf_mandelbrot_weights(n_items, item_s, item_q),
                         n_events, rng)
    activity = truncated_lognormal_activity(n_users, user_mu, user_sigma,
                                            user_lo, user_hi, rng)
    counts = _exact_multiplicities(activity, n_events)
    users = np.repeat(np.arange(n_users, dtype=np.int64), counts)
    rng.shuffle(users)
    timestamps = np.arange(n_events, dtype=np.int64) // events_per_ms
    return users, items, timestamps


#: Calibration constants. Hard anchors come from the datasets' own
#: documentation (total ratings/users/movies; the >=20-ratings-per-user
#: floor); head anchors (top-3 item counts) and medians are the widely
#: reported empirical values. Parameters (s, q, sigma) were fitted by
#: bisection so the generated law reproduces the anchors exactly; the
#: fit script and the residual deltas vs the real spectra are in
#: docs/calibrated_standins.md.
ML25M_CALIBRATION = dict(
    # 25,000,095 ratings, 162,541 users, 59,047 movies (README);
    # top-3 ≈ 81,491 / 80,573(fit) / 79,672; user median ≈ 71.
    n_users=162_541, n_items=59_047,
    item_s=1.335659, item_q=116.337,
    user_mu=4.2627, user_sigma=1.1346, user_lo=20.0, user_hi=32_202.0,
)
ML25M_EVENTS = 25_000_095

ML100K_CALIBRATION = dict(
    # 100,000 ratings, 943 users, 1,682 movies; top-3 = 583/509/508
    # (Star Wars / Contact / Fargo); >=20 ratings per user.
    n_users=943, n_items=1_682,
    item_s=0.5444, item_q=5.949,
    user_mu=4.1744, user_sigma=0.9373, user_lo=20.0, user_hi=737.0,
)
ML100K_EVENTS = 100_000


def ml25m_calibrated(n_events: int = ML25M_EVENTS, seed: int = 25,
                     events_per_ms: int = 50):
    """ML-25M-shaped stream (see ML25M_CALIBRATION)."""
    return calibrated_interactions(n_events, seed=seed,
                                   events_per_ms=events_per_ms,
                                   **ML25M_CALIBRATION)


def ml100k_calibrated(n_events: int = ML100K_EVENTS, seed: int = 100,
                      events_per_ms: int = 5):
    """ML-100K-shaped stream (see ML100K_CALIBRATION)."""
    return calibrated_interactions(n_events, seed=seed,
                                   events_per_ms=events_per_ms,
                                   **ML100K_CALIBRATION)


#: Instacart: 3,421,083 orders, 206,209 users (4..100 orders each,
#: mean 16.6), 49,688 products over 33,819,106 order-products
#: (prior+train); top-3 products Banana 491,291 / Bag of Organic
#: Bananas 394,930 / Organic Strawberries 275,577; basket mean ~10.1,
#: median ~8.
INSTACART_CALIBRATION = dict(
    n_orders=3_421_083,
    n_products=49_688, item_s=0.7845, item_q=0.836,
    orders_mu=2.3026, orders_sigma=0.9079, orders_lo=4.0, orders_hi=100.0,
    basket_mu=2.0794, basket_sigma=0.6822, basket_lo=1.0, basket_hi=145.0,
    n_users=206_209,
)


def instacart_calibrated(n_baskets: int, seed: int = 55,
                         ms_per_basket: int = 10):
    """Instacart-shaped basket stream: per-user order counts and basket
    sizes from clipped log-normals, product popularity Zipf-Mandelbrot
    (all fitted to the published marginals above). Each basket is one
    (user, timestamp) group, like the real order->products join."""
    c = INSTACART_CALIBRATION
    rng = np.random.default_rng(seed)
    # Scale the user population with the basket budget so orders/user
    # keeps its real mean at any size; full size = exactly all users.
    n_users = max(1, min(c["n_users"], int(round(
        n_baskets * c["n_users"] / c["n_orders"]))))
    orders = truncated_lognormal_activity(
        n_users, c["orders_mu"], c["orders_sigma"],
        c["orders_lo"], c["orders_hi"], rng)
    basket_users = np.repeat(
        np.arange(n_users, dtype=np.int64),
        _exact_multiplicities(orders, n_baskets))
    rng.shuffle(basket_users)
    sizes = np.rint(truncated_lognormal_activity(
        n_baskets, c["basket_mu"], c["basket_sigma"],
        c["basket_lo"], c["basket_hi"], rng)).astype(np.int64)
    users = np.repeat(basket_users, sizes)
    ts = np.repeat(np.arange(n_baskets, dtype=np.int64) * ms_per_basket,
                   sizes)
    items = sample_items(
        zipf_mandelbrot_weights(c["n_products"], c["item_s"], c["item_q"]),
        int(sizes.sum()), rng)
    return users, items, ts


def word_cooccurrence_stream(
    text: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batch word co-occurrence on a text: each line is a 'user' (basket),
    each token an 'item', timestamps = line index (benchmark config 1)."""
    vocab = {}
    users, items, tss = [], [], []
    for line_no, line in enumerate(text.splitlines()):
        for tok in line.split():
            idx = vocab.setdefault(tok, len(vocab))
            users.append(line_no)
            items.append(idx)
            tss.append(line_no)
    return (
        np.asarray(users, dtype=np.int64),
        np.asarray(items, dtype=np.int64),
        np.asarray(tss, dtype=np.int64),
    )


def movielens_interactions(
    ratings_csv: str,
    min_rating: float = 0.0,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Adapter for MovieLens ``ratings.csv`` (userId,movieId,rating,timestamp).

    Yields sorted-by-timestamp chunks as interaction batches (benchmark
    configs 2 and 3). Handles both the 100K tab format (u.data) and the
    25M CSV format.
    """
    is_udata = ratings_csv.endswith(".data")
    delim = "\t" if is_udata else ","
    skip = 0 if is_udata else 1
    data = np.loadtxt(ratings_csv, delimiter=delim, skiprows=skip,
                      dtype=np.float64)
    users = data[:, 0].astype(np.int64)
    items = data[:, 1].astype(np.int64)
    ratings = data[:, 2]
    ts = data[:, 3].astype(np.int64) * 1000  # seconds -> ms
    keep = ratings >= min_rating
    users, items, ts = users[keep], items[keep], ts[keep]
    order = np.argsort(ts, kind="stable")
    yield users[order], items[order], ts[order]


def instacart_interactions(
    orders_csv: str,
    order_products_csv: str,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Adapter for Instacart order-product baskets (benchmark config 5):
    user = order's user_id, item = product_id, ts = order_number ordering."""
    orders = np.loadtxt(orders_csv, delimiter=",", skiprows=1,
                        usecols=(0, 1, 3), dtype=np.int64)  # order_id,user_id,order_number
    order_user = {int(o): int(u) for o, u, _n in orders}
    order_ts = {int(o): int(n) for o, _u, n in orders}
    op = np.loadtxt(order_products_csv, delimiter=",", skiprows=1,
                    usecols=(0, 1), dtype=np.int64)  # order_id,product_id
    users = np.asarray([order_user[int(o)] for o in op[:, 0]], dtype=np.int64)
    ts = np.asarray([order_ts[int(o)] for o in op[:, 0]], dtype=np.int64)
    items = op[:, 1]
    order = np.argsort(ts, kind="stable")
    yield users[order], items[order], ts[order]


def write_interactions_csv(path: str, users, items, timestamps) -> None:
    """Write interactions in the reference's input format ``user,item,ts``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.stack([users, items, timestamps], axis=1)
    np.savetxt(path, arr, fmt="%d", delimiter=",")
