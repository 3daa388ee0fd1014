"""Typed configuration for uresnet_tpu_torch.

The port's own copy of ``uresnet_tpu/config.py`` (imports rewritten to
this package); tests/test_torch_data.py holds the two equal.

Capability parity (SURVEY.md §2.1 "Config system", reference `lib/config.py`
[K:med]): the reference parses uppercase `KEY value` text files plus argv
overrides into a flat flag object (NUM_CLASS, BASE_NUM_FILTERS, BATCH_SIZE,
ITERATIONS, LEARNING_RATE, CHECKPOINT_DIR, ...). We keep a typed, nested
dataclass config as the primary representation and provide:

  * ``load_config(path)``   — YAML (if available) or JSON or reference-style
                              KEY-value files, auto-detected.
  * ``parse_kv_text(text)`` — the reference-compat parser, so reference-era
                              configs drive this framework unchanged.
  * dotted-path overrides   — ``apply_overrides(cfg, ["optim.lr=1e-3"])`` and
                              uppercase reference keys (``LEARNING_RATE=1e-3``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Dataclasses
# ---------------------------------------------------------------------------


@dataclass
class ModelConfig:
    """Architecture knobs mirroring the reference's (depth, base filters, 2D/3D
    mode) surface (BASELINE.json north_star; SURVEY.md §3.3)."""

    dims: int = 2                    # 2 or 3 (2D wire-plane / 3D voxel volume)
    num_class: int = 3               # track / shower / background
    in_channels: int = 1             # charge image
    base_filters: int = 16           # filters at full resolution; x2 per level
    depth: int = 5                   # number of downsample levels
    blocks_per_level: int = 2        # residual blocks per level (SURVEY §3.3)
    bn_momentum: float = 0.99        # TF1 tf.layers.batch_normalization default
    bn_eps: float = 1e-3             # TF1 default
    compute_dtype: str = "bfloat16"  # MXU-friendly; params stay float32
    param_dtype: str = "float32"
    head_dtype: str = ""             # logits-conv compute dtype ("" = follow
                                     # compute_dtype). float32 removes the
                                     # bf16 LOGITS quantization: at near-
                                     # saturated, heavily class-balance-
                                     # weighted pixels the (softmax - onehot)
                                     # residual is ulp-sensitive, which makes
                                     # late-training bf16 gradients chaotic
                                     # (measured: benchmarks/RESULTS.md
                                     # round 4 "3D bf16"). The head is ~1%
                                     # of model FLOPs, so this is ~free.
    final_kernel: int = 3            # kernel of the logits conv
    remat: Any = False               # rematerialization (3D memory,
                                     # SURVEY.md §7 hard part #5):
                                     # False | True/"level" (checkpoint each
                                     # U-Net level) | "block" (checkpoint
                                     # each resblock/downsample/upsample —
                                     # lower peak during the backward of the
                                     # high-resolution levels)
    kernel_backend: str = "auto"     # "xla" | "pallas" | "auto" (bench-gated)
    pack: bool = False               # space-to-depth packed low-channel levels
    pack_threshold: int = 64         # pack levels with channels < threshold
    pack_extra_h: bool = False       # extra H-phase for <=64-ch block runs
                                     # (bench-gated: measured neutral at 512^2
                                     # base16 — relayouts+bwd eat the conv
                                     # gain; may win at smaller base_filters)
    # the architecture, ``arch``: "uresnet" (the dense U-ResNet,
    # models/uresnet.py) or "sparse_uresnet" (the submanifold sparse
    # U-ResNet of arXiv:1903.05663, models/sparse_uresnet.py: depth + 1
    # levels of base_filters * (level + 1) channels). A keyword of
    # __init__ kept as an attribute, not a field (`_with_arch`), so that
    # the fields stay the JAX package's one for one
    # (tests/test_torch_data.py), which has one architecture.
    arch = "uresnet"


def _with_arch(init):
    """ModelConfig's __init__ with the ``arch`` keyword. It is not a field:
    asdict and dataclasses.replace see the fields alone, so a replace
    gives the dense net unless ``arch`` is passed again; `Config.to_dict`
    writes it."""
    @functools.wraps(init)
    def __init__(self, *args, arch: str = "uresnet", **kwargs):
        init(self, *args, **kwargs)
        self.arch = arch
    return __init__


ModelConfig.__init__ = _with_arch(ModelConfig.__init__)


def is_sparse(model) -> bool:
    """Whether a model config selects the sparse U-ResNet. A config without
    ``arch`` (the JAX package's, which the tests hand to the port) is the
    dense net's."""
    return getattr(model, "arch", "uresnet") == "sparse_uresnet"


@dataclass
class DataConfig:
    """Data-plane knobs (SURVEY.md §2.1 "larcv IO configs", §2.2 decoder)."""

    image_size: int = 512            # square crop/pad target (power of two)
    batch_size: int = 16
    planes: Tuple[int, ...] = (2,)   # wire-plane channels to read (larcv 'Channels')
    normalize_scale: float = 1.0 / 100.0  # pixel value scale (ADC -> O(1))
    normalize_clip: float = 10.0     # clip normalized values
    weight_mode: str = "class_balance"  # 'ones'|'class_balance'|'nonzero'
                                        # |'file' (USEF v2 stored weights —
                                        # the reference's weight product)
    weight_nonzero_boost: float = 1.0
    num_threads: int = 4             # decoder worker threads
    num_batch_storage: int = 4       # rotating host-side batch buffers
    random_access: bool = True       # shuffle (train) vs sequential (ana)
    input_files: Tuple[str, ...] = ()
    synthetic: bool = True           # synthetic LArTPC-like generator fallback
    synthetic_events: int = 512
    seed: int = 0
    prefetch_depth: int = 2          # device-side double buffering
    augment: bool = False            # device-side random flips/rot90 (train)
    backend: str = "auto"            # host decoder: 'python'|'cxx'|'auto'
    transfer: str = "sparse"         # 'sparse' (densify on device — ~50x
                                     # less host->device traffic) | 'dense'
    max_points: int = 4096           # sparse-mode pad length per image


@dataclass
class OptimConfig:
    optimizer: str = "adam"
    lr: float = 1e-3
    schedule: str = "constant"       # 'constant'|'cosine'|'exponential'
    warmup_steps: int = 0
    decay_steps: int = 0             # for cosine/exponential
    decay_rate: float = 0.1          # for exponential
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0      # 0 = off
    freeze: Tuple[str, ...] = ()     # regex patterns over param leaf paths
                                     # (checkpoint naming, e.g. 'head',
                                     # 'enc0_block1', 'bn/scale$' — see
                                     # tools/ckpt_info.py for the names).
                                     # Matched leaves receive NO update
                                     # (params AND Adam moments untouched;
                                     # frozen grads excluded from
                                     # grad_clip_norm) — the reference's
                                     # `trainable` knob (SURVEY.md §2.1
                                     # model assembly) for fine-tuning.
                                     # A pattern matching nothing is an
                                     # error. BN running stats still update
                                     # (TF1 semantics: update-ops run
                                     # whenever training=True).


@dataclass
class TrainConfig:
    iterations: int = 1000
    summary_iter: int = 20
    checkpoint_iter: int = 200
    val_iter: int = 100
    val_batches: int = 8             # batches per in-loop validation pass
    val_exact: bool = False          # in-loop validation runs the
                                     # exactly-once full-dataset pass
                                     # (dataset-global confusion mIoU,
                                     # engine/evaluator.evaluate_dataset)
                                     # instead of sampling val_batches
    checkpoint_dir: str = "ckpt"
    log_dir: str = "log"
    load_file: str = ""              # checkpoint path to restore
    load_params_only: bool = False   # fine-tune semantics for load_file:
                                     # restore params + BN stats only, with
                                     # a FRESH optimizer/PRNG at step 0
                                     # (reference workflow: restore a
                                     # pretrained net, re-train — pair with
                                     # optim.freeze to emulate
                                     # trainable=False subgraphs). Applies
                                     # ONLY when the restored path IS
                                     # load_file; the run's own checkpoints
                                     # (--resume) always restore fully.
    preempt_save: bool = True        # on SIGTERM during fit (preemptible
                                     # TPU VMs send it before reclaim):
                                     # finish the in-flight step, write a
                                     # checkpoint, exit the loop cleanly —
                                     # `--resume` continues bit-exactly
    seed: int = 123
    loss_normalize: str = "mean"     # 'mean' (reference: mean(w*xent)) | 'weight_sum'
    steps_per_dispatch: int = 1      # fuse K train steps into ONE device
                                     # dispatch (lax.scan over K stacked
                                     # batches, one host->device transfer).
                                     # Amortizes per-step dispatch/transfer
                                     # latency — the e2e bottleneck on
                                     # remote-relay hosts (benchmarks/
                                     # RESULTS.md round 2). summary/val/
                                     # checkpoint iters and iterations must
                                     # be multiples of K.
    packed_loss: bool = False        # train loss/metrics on the packed-head
                                     # logits (skips the full-res d2s
                                     # relayouts; per-pixel math is
                                     # layout-invariant — models/packed.py
                                     # loss_layout_phases). BENCH-GATED OFF:
                                     # packing label/weight targets in-jit
                                     # (C=1 transposes) costs more than the
                                     # saved head d2s (-1.5% at 512^2/b32,
                                     # benchmarks/RESULTS.md round 2); flip
                                     # on if the data plane ever ships
                                     # packed targets directly


@dataclass
class ParallelConfig:
    """Mesh extents (SURVEY.md §2.3/§2.4). data = DP allreduce over ICI;
    spatial = spatial partitioning of H (conv-net CP analog — GSPMD inserts
    the halo exchanges); model = channel-sharded TP hook (parallel/tp.py).
    data=0 means "all remaining devices".

    BN under DP is ALWAYS global-batch: the pjit step computes batch stats
    as plain means over the batch-sharded arrays, so GSPMD compiles the
    cross-replica reduction automatically (tests pin DP == single-device on
    the concatenated batch). There is deliberately no per-replica-BN knob —
    it would be a different numerical model, not a parallelism option."""

    data: int = 0
    spatial: int = 1
    model: int = 1


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        """The fields as nested dicts, with ``model.arch`` where it is not
        the dense net's (an attribute, not a field: `_with_arch`), so that
        `load_config` of the dict's JSON gives the same architecture."""
        d = dataclasses.asdict(self)
        arch = getattr(self.model, "arch", "uresnet")
        if arch != "uresnet":
            d["model"]["arch"] = arch
        return d


# ---------------------------------------------------------------------------
# Reference-style KEY-value compat layer
# ---------------------------------------------------------------------------

# Uppercase reference flag -> dotted path in Config. Anchors: SURVEY.md §2.1
# config row (lib/config.py flags [K:med]).
_REFERENCE_KEYS: Dict[str, str] = {
    "NUM_CLASS": "model.num_class",
    "BASE_NUM_FILTERS": "model.base_filters",
    "URESNET_FILTERS": "model.base_filters",
    "URESNET_NUM_STRIDES": "model.depth",
    "DEPTH": "model.depth",
    "BATCH_SIZE": "data.batch_size",
    "IMAGE_SIZE": "data.image_size",
    "ITERATIONS": "train.iterations",
    "TRAIN_ITERATIONS": "train.iterations",
    "LEARNING_RATE": "optim.lr",
    "CHECKPOINT_DIR": "train.checkpoint_dir",
    "LOG_DIR": "train.log_dir",
    "LOAD_FILE": "train.load_file",
    "SUMMARY_ITERATION": "train.summary_iter",
    "CHECKPOINT_ITERATION": "train.checkpoint_iter",
    "VAL_ITERATION": "train.val_iter",
    "VAL_BATCHES": "train.val_batches",
    "SEED": "train.seed",
    "NUM_THREADS": "data.num_threads",
    "NUM_BATCH_STORAGE": "data.num_batch_storage",
    "RANDOM_ACCESS": "data.random_access",
    "INPUT_FILES": "data.input_files",
    "PLANES": "data.planes",
    "CHANNELS": "data.planes",
    "MODEL_DIMS": "model.dims",
    "COMPUTE_DTYPE": "model.compute_dtype",
    "KERNEL_BACKEND": "model.kernel_backend",
    "WEIGHT_MODE": "data.weight_mode",
}


def _coerce(value: str) -> Any:
    v = value.strip()
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    if "," in v:
        return tuple(_coerce(p) for p in v.split(",") if p.strip())
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v.strip("'\"")


def _set_dotted(obj: Any, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"unknown config field: {dotted}")
        obj = getattr(obj, p)
    name = parts[-1]
    if not hasattr(obj, name):
        raise KeyError(f"unknown config field: {dotted}")
    current = getattr(obj, name)
    if isinstance(current, tuple) and not isinstance(value, tuple):
        value = (value,)
    if isinstance(current, bool):
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "1", "yes", "on"):
                value = True
            elif low in ("false", "0", "no", "off"):
                value = False
            elif name == "remat":
                pass  # the one tri-state field: model.remat=block|level
            else:
                # never assign a raw (always-truthy) string to a bool field
                raise ValueError(
                    f"invalid boolean for {dotted}: {value!r} "
                    f"(use true/false)")
        else:
            value = bool(value)
    elif isinstance(current, int) and not isinstance(value, bool) and isinstance(value, float):
        value = int(value)
    elif isinstance(current, float) and isinstance(value, int):
        value = float(value)
    setattr(obj, name, value)


# Reference keys that point at larcv PSet IO config files rather than plain
# values (SURVEY.md §2.1 larcv IO configs; lib/config.py *_IO_CONFIG [K:med]).
_PSET_KEYS = ("IO_CONFIG", "FILLER_CONFIG", "TRAIN_IO_CONFIG",
              "TEST_IO_CONFIG", "ANA_IO_CONFIG")


def _apply_kv(cfg: Config, key: str, raw: str) -> None:
    key = key.strip()
    if key.upper() in _PSET_KEYS:
        from uresnet_tpu_torch.data.pset_compat import apply_pset_io_config

        apply_pset_io_config(raw.strip().strip("'\""), cfg.data)
        return
    dotted = _REFERENCE_KEYS.get(key.upper()) if key.isupper() else key
    if dotted is None:
        dotted = key
    _set_dotted(cfg, dotted, _coerce(raw))


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``a.b=c`` (dotted) or ``UPPER_KEY=value`` (reference style)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be KEY=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        _apply_kv(cfg, key, raw)
    return cfg


def parse_kv_text(text: str, cfg: Optional[Config] = None) -> Config:
    """Parse a reference-style ``KEY value`` text config (SURVEY.md §2.1)."""
    cfg = cfg or Config()
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" in line and " " not in line.split("=", 1)[0]:
            key, _, raw = line.partition("=")
        else:
            parts = line.split(None, 1)
            if len(parts) != 2:
                raise ValueError(f"line {lineno}: expected 'KEY value', got {line!r}")
            key, raw = parts
        if key.upper() in _PSET_KEYS:
            from uresnet_tpu_torch.data.pset_compat import apply_pset_io_config

            apply_pset_io_config(raw.strip().strip("'\""), cfg.data)
            continue
        dotted = _REFERENCE_KEYS.get(key.upper())
        if dotted is None and "." in key:
            dotted = key
        if dotted is None:
            raise KeyError(f"line {lineno}: unknown reference key {key!r}")
        _set_dotted(cfg, dotted, _coerce(raw))
    return cfg


def _from_nested_dict(d: Dict[str, Any]) -> Config:
    cfg = Config()
    for section, sub in d.items():
        if not hasattr(cfg, section):
            raise KeyError(f"unknown config section: {section}")
        if not isinstance(sub, dict):
            raise ValueError(f"section {section} must be a mapping")
        for k, v in sub.items():
            if isinstance(v, list):
                v = tuple(v)
            _set_dotted(cfg, f"{section}.{k}", v)
    return cfg


def load_config(path: str, overrides: Sequence[str] = ()) -> Config:
    """Load YAML / JSON / reference KEY-value config, then apply overrides."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml  # baked into the image

        cfg = _from_nested_dict(yaml.safe_load(text) or {})
    elif path.endswith(".json"):
        cfg = _from_nested_dict(json.loads(text))
    else:
        cfg = parse_kv_text(text)
    return apply_overrides(cfg, overrides)
