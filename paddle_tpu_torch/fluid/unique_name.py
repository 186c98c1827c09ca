"""Unique name generator (counterpart of ``paddle_tpu/fluid/unique_name.py``;
the same counters, so the same builder calls name vars alike)."""

from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.ids = defaultdict(int)
        self.prefix = prefix

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        gen = UniqueNameGenerator(new_generator)
    else:
        gen = new_generator
    old = switch(gen)
    try:
        yield
    finally:
        switch(old)
