"""MovieLens-1M reader (counterpart of ``paddle_tpu/dataset/movielens.py``; upstream python/paddle/dataset/movielens.py — yields
[user_id, gender_id, age_id, job_id, movie_id, category_ids, title_ids,
score]; max_user_id :154, max_movie_id :149, max_job_id :159).

Synthetic fallback: deterministic preference structure (users like genres
by id parity) so recommender models actually fit."""

from __future__ import annotations

import numpy as np

# the REAL ml-1m cardinalities (ref movielens meta), so scripts that
# hardcode demo ids (book recommender infer: movie 783, titles ~4k)
# stay in range of the synthetic tables; row COUNTS remain synthetic
N_USERS = 6040
N_MOVIES = 3952
N_JOBS = 20
N_AGES = 7
N_CATEGORIES = 18
TITLE_VOCAB = 5177
N_TRAIN = 6000
N_TEST = 600


def max_user_id():
    return N_USERS


def max_movie_id():
    return N_MOVIES


def max_job_id():
    return N_JOBS


# module-level LIST like the reference (movielens.py:42) — scripts do
# len(paddle.dataset.movielens.age_table)
age_table = [1, 18, 25, 35, 45, 50, 56]


def categories():
    return ["c%d" % i for i in range(N_CATEGORIES)]


def movie_categories():
    """ref movielens.py:225 — the category vocabulary."""
    return categories()


def get_movie_title_dict():
    """ref movielens.py:178 — word -> id over the title vocabulary."""
    return {("w%d" % i): i for i in range(TITLE_VOCAB)}


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    user_genre = rng.randint(0, N_CATEGORIES, size=N_USERS + 1)
    movie_genre = rng.randint(0, N_CATEGORIES, size=N_MOVIES + 1)
    for _ in range(n):
        u = int(rng.randint(1, N_USERS + 1))
        m = int(rng.randint(1, N_MOVIES + 1))
        gender = int(u % 2)
        age = int(u % N_AGES)
        job = int(u % N_JOBS)
        cats = [int(movie_genre[m]),
                int((movie_genre[m] + 1) % N_CATEGORIES)]
        title = [int(x) for x in
                 rng.randint(0, TITLE_VOCAB, size=int(rng.randint(1, 5)))]
        # structured score: genre match -> high rating (+noise)
        base = 4.5 if user_genre[u] == movie_genre[m] else 2.5
        score = float(np.clip(base + rng.normal(0, 0.5), 1.0, 5.0))
        yield [u, gender, age, job, m, cats, title, score]


def train():
    def reader():
        yield from _rows(N_TRAIN, 7)

    return reader


def test():
    def reader():
        yield from _rows(N_TEST, 8)

    return reader
