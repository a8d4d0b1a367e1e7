"""Toy datasets for the port's loader tests. They live in a module of
their own so that the loader's spawned workers can import them without
importing JAX or torch."""

import numpy as np


class IndexItems:
    """Item i: its index as an array, and one draw of ``np.random``
    (which depends on the worker's seeding)."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"index": np.full((2, 3), i, np.int64),
                "draw": np.random.uniform(size=(1,))}


class FailingItems(IndexItems):
    """Raises on item ``bad``."""

    def __init__(self, n: int, bad: int):
        super().__init__(n)
        self.bad = bad

    def __getitem__(self, i):
        if i == self.bad:
            raise RuntimeError(f"item {i} cannot be loaded")
        return super().__getitem__(i)
