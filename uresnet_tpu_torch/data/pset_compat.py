"""larcv PSet IO-config compat shim.

The port's own copy of ``uresnet_tpu/data/pset_compat.py`` (imports rewritten to
this package); tests/test_torch_data.py holds the two equal.

Capability parity (SURVEY.md §2.1 "larcv IO configs" [K:high for schema]):
the reference points its flag `*_IO_CONFIG` at larcv PSet text files that
configure the C++ ThreadProcessor:

    ThreadProcessor: {
      Verbosity:       2
      NumThreads:      4
      NumBatchStorage: 4
      RandomAccess:    true
      InputFiles:      ["train0.root","train1.root"]
      ProcessName:     ["train_image","train_label","train_weight"]
      ProcessType:     ["BatchFillerImage2D","BatchFillerImage2D","BatchFillerImage2D"]
      ProcessList: {
        train_image:  { ImageProducer: "wire",    Channels: [2] }
        train_label:  { ImageProducer: "segment", Channels: [2] }
        train_weight: { ImageProducer: "weight",  Channels: [2] }
      }
    }

`parse_pset` parses that grammar (nested braces, `Key: value`, arrays,
strings, bools, numbers, comments with # or //) into nested dicts, and
`apply_pset_io_config` maps the ThreadProcessor knobs onto our DataConfig —
so reference-era IO configs drive the rebuilt data plane. InputFiles are
reinterpreted as USEF paths (.root replaced if a matching .usef exists;
ROOT itself is an explicit non-goal, SURVEY.md §7).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Tuple

from uresnet_tpu_torch.config import DataConfig


class PSetError(ValueError):
    pass


def _tokenize(text: str) -> List[str]:
    text = re.sub(r"(#|//).*", "", text)
    # quote-aware splitting: strings, braces, brackets, commas, colons
    tokens = re.findall(r'"[^"]*"|\{|\}|\[|\]|,|:|[^\s{}\[\],:]+', text)
    return tokens


def _parse_value(tokens: List[str], i: int) -> Tuple[Any, int]:
    t = tokens[i]
    if t == "{":
        return _parse_block(tokens, i + 1)
    if t == "[":
        out = []
        i += 1
        while tokens[i] != "]":
            if tokens[i] == ",":
                i += 1
                continue
            v, i = _parse_value(tokens, i)
            out.append(v)
        return out, i + 1
    if t.startswith('"'):
        return t[1:-1], i + 1
    if t.lower() in ("true", "false"):
        return t.lower() == "true", i + 1
    try:
        return int(t), i + 1
    except ValueError:
        pass
    try:
        return float(t), i + 1
    except ValueError:
        pass
    return t, i + 1


def _parse_block(tokens: List[str], i: int) -> Tuple[Dict[str, Any], int]:
    out: Dict[str, Any] = {}
    while i < len(tokens):
        if tokens[i] == "}":
            return out, i + 1
        if tokens[i] == ",":  # optional separators between entries
            i += 1
            continue
        key = tokens[i]
        if key.startswith('"'):
            key = key[1:-1]
        if i + 1 >= len(tokens) or tokens[i + 1] != ":":
            raise PSetError(f"expected ':' after key {key!r}")
        val, i = _parse_value(tokens, i + 2)
        out[key] = val
    return out, i


def parse_pset(text: str) -> Dict[str, Any]:
    tokens = _tokenize(text)
    block, i = _parse_block(tokens, 0)
    if i < len(tokens):
        raise PSetError(f"trailing tokens at {i}: {tokens[i:i+5]}")
    return block


def apply_pset_io_config(path: str, cfg: DataConfig) -> DataConfig:
    """Map a ThreadProcessor PSet file onto DataConfig (in place; returned)."""
    with open(path) as f:
        pset = parse_pset(f.read())
    tp = pset.get("ThreadProcessor", pset)  # allow bare inner block
    if "NumThreads" in tp:
        cfg.num_threads = int(tp["NumThreads"])
    if "NumBatchStorage" in tp:
        cfg.num_batch_storage = int(tp["NumBatchStorage"])
    if "RandomAccess" in tp:
        cfg.random_access = bool(tp["RandomAccess"])
    if "InputFiles" in tp:
        files = []
        for fpath in tp["InputFiles"]:
            if fpath.endswith(".root"):
                usef = fpath[:-5] + ".usef"
                fpath = usef if os.path.exists(usef) else fpath
            files.append(fpath)
        cfg.input_files = tuple(files)
        cfg.synthetic = False
    # plane selection: union of Channels across BatchFiller processes
    planes: List[int] = []
    for proc in (tp.get("ProcessList") or {}).values():
        for ch in proc.get("Channels", []):
            if int(ch) not in planes:
                planes.append(int(ch))
    if planes:
        cfg.planes = tuple(sorted(planes))
    return cfg
