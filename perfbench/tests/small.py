"""Small copies of the benchmark's cells, for the tests on the CPU: the
same configuration files, traffic mixes and limits at a size a test run
holds (2D 32^2, depth 2, batch 4; 3D 16^3, depth 2, base 4, batch 1)."""

import copy

from harness import spec


def cell(name: str, **model) -> spec.Cell:
    c = spec.cell(name)
    c.config = copy.deepcopy(c.config)
    m, d = c.config["model"], c.config["data"]
    if m["dims"] == 2:
        m.update(depth=2)
        d.update(image_size=32, batch_size=4, max_points=256)
    else:
        m.update(depth=2, base_filters=4)
        d.update(image_size=16, batch_size=1, max_points=512)
    m.update(model)
    c.mix = dict(c.mix, pool_batches=4, trace_steps=2, check_batches=2,
                 warmup_batches=1)
    return c
