#!/usr/bin/env python
"""Migrate a reference TF1 U-ResNet checkpoint into uresnet_tpu_torch
(port of tools/import_tf_ckpt.py).

Two stages, so TensorFlow is only needed where the checkpoint lives
(capability parity: SURVEY.md §5 checkpoint row — the reference saves
`tf.train.Saver` .ckpt files; this brings a *trained* reference network
across, same pattern as tools/convert_larcv.py for data):

  # 1. inside any TF1/TF2 environment (reads .ckpt, writes plain npz):
  python -m uresnet_tpu_torch.tools.import_tf_ckpt dump \
      /path/model.ckpt-12000 vars.npz

  # 2. inside this repo's environment (no TF needed):
  python -m uresnet_tpu_torch.tools.import_tf_ckpt convert vars.npz \
      ckpt_imported/ \
      --config configs/train_2d_512.yaml --report

  # 3. fine-tune or infer from it:
  python -m uresnet_tpu_torch.cli.train configs/train_2d_512.yaml \
      train.load_file=ckpt_imported/step_00000000.npz \
      train.load_params_only=true
  python -m uresnet_tpu_torch.cli.infer configs/train_2d_512.yaml \
      train.checkpoint_dir=ckpt_imported --input held_out.usef --metrics-only

Name mapping, layout transforms (TF transpose-conv kernels, conv-bias
folds) and the shape-validated unit matcher live in
uresnet_tpu_torch/models/import_tf.py (see its docstring for the exact
semantics); `--mode numbered|natural` picks the TF scope ordering,
`--spec map.yaml` pins any unit explicitly, `--report` prints the full
unit <- scope table for review.
"""

from __future__ import annotations

import argparse
import sys


def cmd_dump(args) -> int:
    try:
        import tensorflow as tf  # noqa: F401  (any TF1/TF2 works)
    except ImportError:
        print("error: `dump` must run inside a TensorFlow environment "
              "(the reference's); `convert` is the TF-free half.",
              file=sys.stderr)
        return 2
    import numpy as np

    try:
        reader = tf.train.load_checkpoint(args.checkpoint)
        shapes = reader.get_variable_to_shape_map()
        arrays = {name: np.asarray(reader.get_tensor(name))
                  for name in shapes}
    except Exception as e:  # noqa: BLE001 — surface TF's message verbatim
        print(f"error reading checkpoint {args.checkpoint!r}: {e}",
              file=sys.stderr)
        return 1
    np.savez_compressed(args.output, **arrays)
    print(f"dumped {len(arrays)} variables -> {args.output}")
    return 0


def cmd_convert(args) -> int:
    import numpy as np

    from uresnet_tpu_torch.config import load_config
    from uresnet_tpu_torch.models.import_tf import (
        TFImportError,
        format_report,
        load_spec,
        map_tf_dump,
        write_import_checkpoint,
    )

    cfg = load_config(args.config, args.override)
    with np.load(args.dump) as z:
        dump = {k: z[k] for k in z.files}
    spec = load_spec(args.spec) if args.spec else None
    try:
        params, state, report = map_tf_dump(dump, cfg.model,
                                            mode=args.mode, spec=spec)
    except TFImportError as e:
        print(f"import failed: {e}", file=sys.stderr)
        return 1
    if args.report:
        print(format_report(report))
    if args.dry_run:
        print(f"dry run: {len(report)} units mapped, nothing written")
        return 0
    path = write_import_checkpoint(args.out_dir, params, state, cfg.model,
                                   seed=cfg.train.seed)
    print(f"wrote {path}  (restore with train.load_file={path} "
          f"train.load_params_only=true, or point train.checkpoint_dir "
          f"at {args.out_dir})")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("dump", help="TF env: .ckpt -> flat npz")
    d.add_argument("checkpoint", help="TF checkpoint prefix (e.g. model.ckpt-12000)")
    d.add_argument("output", help="output .npz path")
    d.set_defaults(fn=cmd_dump)

    c = sub.add_parser("convert",
                       help="npz dump -> checkpoint in the JAX npz layout")
    c.add_argument("dump", help="npz from the dump stage")
    c.add_argument("out_dir", help="checkpoint directory to write")
    c.add_argument("--config", required=True,
                   help="config describing the architecture (YAML/JSON/KEY-value)")
    c.add_argument("--mode", default="auto",
                   choices=("auto", "numbered", "natural"),
                   help="TF scope ordering (see models/import_tf.py)")
    c.add_argument("--spec", default=None,
                   help="YAML/JSON {our_unit_path: tf_scope} explicit pins")
    c.add_argument("--report", action="store_true",
                   help="print the unit <- tf-scope mapping table")
    c.add_argument("--dry-run", action="store_true",
                   help="map + validate only, write nothing")
    c.add_argument("override", nargs="*", default=[],
                   help="config overrides (a.b=c or KEY=value)")
    c.set_defaults(fn=cmd_convert)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
