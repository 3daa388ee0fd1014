"""The seeded traffic: the same seed gives the same pool, and the frozen
generator equals the program's own."""

import numpy as np
import pytest

from harness import events
from uresnet_tpu_torch.data import pipeline, synthetic


def _pool(seed, shape=(64, 64)):
    return events.make_pool(seed, batches=2, batch_size=3, shape=shape,
                            max_points=512)


def test_same_seed_same_pool():
    a, b = _pool(2 ** 31 + 7), _pool(2 ** 31 + 7)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    c = _pool(2 ** 31 + 8)
    assert any(not np.array_equal(x["coords"], y["coords"])
               for x, y in zip(a, c))


@pytest.mark.parametrize("shape", [(64, 64), (512, 512), (24, 24, 24)])
def test_generator_equals_the_programs(shape):
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    ours = [events.generate_event(r1, shape) for _ in range(4)]
    theirs = [synthetic.generate_event(r2, shape=shape, planes=(0,))
              for _ in range(4)]
    for (c, v, lab), ev in zip(ours, theirs):
        pl = ev.planes[0]
        np.testing.assert_array_equal(c, pl.coords)
        np.testing.assert_array_equal(v, pl.values)
        np.testing.assert_array_equal(lab, pl.labels)
    batch = events.sparse_batch(ours, shape, 700)
    want = pipeline.sparse_batch(theirs, planes=(0,), max_points=700,
                                 ndims=len(shape))
    assert batch.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k])
        assert batch[k].dtype == want[k].dtype
