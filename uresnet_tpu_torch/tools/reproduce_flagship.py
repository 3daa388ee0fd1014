"""Reproduce a flagship quality headline + release artifact from scratch
(port of tools/reproduce_flagship.py).

One command per flagship: it sequences the exact train run, the
exactly-once held-out evaluation, the params-only release artifact, and the
artifact-equality check. The four stages are sequential subprocesses of
the port's CLIs, the commands a user would run by hand:

  1. cli.train  <config> --iterations N optim.decay_steps=N
                data.augment=true data.synthetic_events=E
                train.checkpoint_dir=ckpt/<name> train.log_dir=log/<name>
  2. cli.infer --metrics-only --checkpoint ckpt/<name>/step_N.npz
                --input <held-out cache>   (synthetic seed offset +10007 —
                disjoint from every training event; evaluated exactly once)
  3. tools.make_release_ckpt -> artifacts/<name>_bf16.npz
                (params + BN stats only, conv kernels as bf16 bit patterns
                — bit-exact for these compute_dtype=bfloat16 configs)
  4. cli.infer --metrics-only ... train.load_file=artifacts/<name>_bf16.npz
                train.load_params_only=true — must report the IDENTICAL
                metrics dict as stage 2, or this script exits nonzero.

Usage:
    python -m uresnet_tpu_torch.tools.reproduce_flagship 2d
    python -m uresnet_tpu_torch.tools.reproduce_flagship 3d
    python -m uresnet_tpu_torch.tools.reproduce_flagship 2d --dry-run
    python -m uresnet_tpu_torch.tools.reproduce_flagship 2d --device cuda:1

``--device`` is passed to both CLIs (their default is cuda). The port's
``cli.infer`` prints the ``metrics:`` dict unrounded, so stages 2 and 4
must agree to the last bit. Training is seeded but crosses
non-deterministic reduction orders on the card, so a reproduced mIoU
matches a recorded one only to ~1e-3.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FLAGSHIPS = {
    "2d": dict(
        config="configs/train_2d_512.yaml",
        iterations=20000,
        train_events=32768,
        heldout_events=512,
        name="q20k",
    ),
    "3d": dict(
        config="configs/train_3d_192.yaml",
        iterations=24000,
        train_events=16384,
        heldout_events=256,
        name="q3d24k",
    ),
}


def heldout_cache(config_path: str, heldout_events: int) -> str:
    """Materialize (or reuse) the held-out synthetic cache for a config.

    Reuses the loader's own cache-naming/materialization logic with the
    trainer's val convention (engine/trainer.py: seed offset +10007) so
    the evaluated file is byte-identical to what in-loop `train.val_exact`
    would see."""
    from uresnet_tpu_torch.config import load_config
    from uresnet_tpu_torch.data.loader import resolve_input_files

    cfg = load_config(os.path.join(REPO, config_path), [])
    dcfg = dataclasses.replace(cfg.data, seed=cfg.data.seed + 10007,
                               synthetic_events=heldout_events)
    (path,) = resolve_input_files(dcfg, ndims=cfg.model.dims)
    return path


def run(cmd: list, *, dry: bool, capture: bool = False) -> str:
    print("+", " ".join(cmd), flush=True)
    if dry:
        return ""
    if capture:
        out = []
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            print(line, end="", flush=True)
            out.append(line)
        if proc.wait() != 0:
            sys.exit(f"FAILED ({proc.returncode}): {' '.join(cmd)}")
        return "".join(out)
    subprocess.run(cmd, cwd=REPO, check=True)
    return ""


def metrics_line(output: str) -> str:
    m = re.search(r"^metrics: (.*)$", output, re.MULTILINE)
    if not m:
        sys.exit("no 'metrics:' line in infer output")
    return m.group(1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("flagship", choices=sorted(FLAGSHIPS))
    p.add_argument("--dry-run", action="store_true",
                   help="print the stage commands without running them")
    p.add_argument("--skip-train", action="store_true",
                   help="reuse an existing ckpt/<name> (eval + artifact "
                        "stages only)")
    p.add_argument("--device", default=None,
                   help="torch device passed to cli.train and cli.infer "
                        "(default: theirs, cuda)")
    args = p.parse_args(argv)
    f = FLAGSHIPS[args.flagship]
    py = [sys.executable, "-m"]
    dev = ["--device", args.device] if args.device else []
    final = f"ckpt/{f['name']}/step_{f['iterations']:08d}.npz"
    artifact = f"artifacts/{f['name']}_bf16.npz"

    if not args.skip_train:
        run(py + ["uresnet_tpu_torch.cli.train", f["config"],
                  "--iterations", str(f["iterations"]),
                  f"optim.decay_steps={f['iterations']}",
                  f"data.synthetic_events={f['train_events']}",
                  "data.augment=true",
                  f"train.checkpoint_dir=ckpt/{f['name']}",
                  f"train.log_dir=log/{f['name']}"] + dev, dry=args.dry_run)

    if args.dry_run:
        heldout = f"<loader cache for seed+10007, {f['heldout_events']} events>"
    else:
        heldout = heldout_cache(f["config"], f["heldout_events"])
    eval_cmd = py + ["uresnet_tpu_torch.cli.infer", f["config"],
                     "--metrics-only", "--input", heldout]
    full = run(eval_cmd + ["--checkpoint", final] + dev,
               dry=args.dry_run, capture=True)

    run(py + ["uresnet_tpu_torch.tools.make_release_ckpt", final, artifact,
              "--kernels-dtype", "bfloat16", "--force"], dry=args.dry_run)

    art = run(eval_cmd + [f"train.load_file={artifact}",
                          "train.load_params_only=true"] + dev,
              dry=args.dry_run, capture=True)
    if args.dry_run:
        return 0
    if metrics_line(full) != metrics_line(art):
        sys.exit(f"ARTIFACT MISMATCH:\n  full ckpt: {metrics_line(full)}\n"
                 f"  artifact:  {metrics_line(art)}")
    print(f"OK: {artifact} reproduces the full-checkpoint metrics exactly:")
    print(" ", metrics_line(full))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
