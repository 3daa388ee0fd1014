"""The roundings that a plain reference is computed in besides float32,
shared by every architecture's reference (archs/<arch>.py, the ``quant``
of its hooks): ``bf16``, the configuration's own precision, the yardstick
of ``checks.logit_error`` (loops.train_reference); ``fp8``, the precision
below it, the lower-precision control (readings.py --control). Written
beside the dense reference, where they are defined."""

from harness.reference import bf16, fp8  # noqa: F401
