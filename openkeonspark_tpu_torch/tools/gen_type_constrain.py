"""Generate ``type_constrain.txt`` for a dataset dir (upstream OpenKE's
``n-n.py`` equivalent).

Counterpart of ``tools/gen_type_constrain.py`` (``:27-44``), over the
port's ``data/type_constrain.py``; both write the same file.

Usage:
    python -m openkeonspark_tpu_torch.tools.gen_type_constrain \\
        --input data/KG [--splits all|train]
"""

from __future__ import annotations

import argparse
import os

from openkeonspark_tpu_torch.data.dataset import load_dataset
from openkeonspark_tpu_torch.data.type_constrain import (
    build_type_constraints, save_type_constraints)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--splits", default="all", choices=["all", "train"])
    args = p.parse_args(argv)

    ds = load_dataset(args.input)
    tc = build_type_constraints(ds, splits=args.splits)
    out = os.path.join(args.input, "type_constrain.txt")
    save_type_constraints(tc, out)
    n_h = sum(len(v) for v in tc.heads.values())
    n_t = sum(len(v) for v in tc.tails.values())
    print(f"wrote {out}: {ds.n_rel} relations, {n_h} head / {n_t} tail "
          f"constraint entries")
    return out


if __name__ == "__main__":
    main()
